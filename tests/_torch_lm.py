"""Helpers shared by the port's whole-model parity tests of the MoE, RWKV
and Whisper families: one ``smoke()`` model run through ``repro``
(forward, prefill, decode steps, one train step) from weights that cross
to the port name for name, and the port's side of each comparison.

Tolerances: logits, caches and decode steps 2e-3 absolute, the bar of
tests/test_models.py's prefill/decode consistency test; a train step's
metrics rtol 1e-5; its gradients within 1e-4 of each leaf's max |g|
(read from AdamW's first moment, m = 0.1 g after one step) and its
stepped parameters atol 1e-6 where the reference's |g| is 0 or above
1e-3 of its leaf's max, the elements left out bounded at 5% of the
parameters (AdamW's first step is about lr·sign(g), so a near-zero
gradient may flip sign), the rule of tests/test_torch_train.py; here
the elements left out are also held within 2 lr, and a test may state a
larger share for a model whose gradients are heavy-tailed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as J
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.train import make_eval_step, make_train_step, opt_init

B = 2
TRAIN_KW = dict(base_lr=1e-2, warmup=1, total_steps=40, microbatch=1)


def np_(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def flat(tree) -> dict:
    return {p: np_(v) for p, v in common.leaves(tree)}


def jflat(tree) -> dict:
    """A repro tree as {path: array}, the port's paths."""
    return flat(jax.tree.map(np.asarray, tree))


def _batches(cfg, prompt: int, gen: int, frames: int, seed: int):
    """(the full batch, the prompt's batch) as numpy: tokens for prompt +
    gen positions; an enc_dec model's are "dec_tokens" beside "frames"."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, prompt + gen)).astype(np.int32)
    if not cfg.enc_dec:
        return {"tokens": tokens}, {"tokens": tokens[:, :prompt]}
    fr = (rng.standard_normal((B, frames, cfg.d_model)) * 0.1
          ).astype(np.float32)
    return ({"frames": fr, "dec_tokens": tokens},
            {"frames": fr, "dec_tokens": tokens[:, :prompt]})


def token_key(cfg) -> str:
    return "dec_tokens" if cfg.enc_dec else "tokens"


def reference_run(arch: str, *, prompt: int, gen: int, frames: int = 0,
                  seed: int = 1) -> dict:
    """``repro``'s forward, prefill (cache included), ``gen`` decode steps
    and one train step (lr 1e-2, no warmup) of ``arch``'s smoke() config,
    with the port's config, the crossed weights and the batches."""
    jcfg, cfg = J.get_config(arch, smoke=True), get_config(arch, smoke=True)
    specs = JT.param_specs(jcfg)
    pj = jax.jit(lambda key: jcommon.build_params(specs, key))(
        jax.random.PRNGKey(0))
    full_b, pre_b = _batches(cfg, prompt, gen, frames, seed)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    full, _ = jax.jit(lambda p, b: JT.forward(p, b, jcfg))(pj, jb(full_b))
    cache = JT.init_cache(jcfg, B, frames if cfg.enc_dec else prompt + gen,
                          dtype=jnp.float32)
    pre, cache = jax.jit(lambda p, b, c: JT.prefill(p, b, c, jcfg))(
        pj, jb(pre_b), cache)
    pre_cache = jax.tree.map(np.asarray, cache)
    step = jax.jit(lambda p, t, pos, c: JT.decode_step(p, t, pos, c, jcfg))
    toks = full_b[token_key(cfg)]
    steps = []
    for t in range(prompt, prompt + gen):
        lg, cache = step(pj, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t),
                         cache)
        steps.append(np.asarray(lg[:, 0]))
    jstep = jax.jit(jmake_train_step(jcfg, **TRAIN_KW))
    jp, js, jm = jstep(pj, jopt.opt_init(jcfg.optimizer, pj), jb(full_b))
    return dict(cfg=cfg, pj=jax.tree.map(np.asarray, pj),
                params=interop.params_from_arrays(
                    jax.tree.map(np.asarray, pj), device="cpu"),
                full_batch=full_b, prompt_batch=pre_b, prompt=prompt,
                gen=gen, frames=frames, full=np.asarray(full),
                prefill=np.asarray(pre), prefill_cache=pre_cache,
                steps=np.stack(steps, 1),
                cache=jax.tree.map(np.asarray, cache),
                train=(jflat(jp), jflat(js.m),
                       {k: float(v) for k, v in jm.items()}))


def reference_train(arch: str, *, seq: int, seed: int = 1) -> dict:
    """``repro``'s one jitted train step (lr 1e-2, no warmup) of
    ``arch``'s smoke() config on B x ``seq`` tokens, with the port's
    config, the crossed weights and the batch: what ``port_train_step``
    and the train checks read of ``reference_run``."""
    jcfg, cfg = J.get_config(arch, smoke=True), get_config(arch, smoke=True)
    specs = JT.param_specs(jcfg)
    pj = jax.jit(lambda key: jcommon.build_params(specs, key))(
        jax.random.PRNGKey(0))
    full_b, _ = _batches(cfg, seq, 0, 0, seed)
    jstep = jax.jit(jmake_train_step(jcfg, **TRAIN_KW))
    jp, js, jm = jstep(pj, jopt.opt_init(jcfg.optimizer, pj),
                       {k: jnp.asarray(v) for k, v in full_b.items()})
    return dict(cfg=cfg, pj=jax.tree.map(np.asarray, pj),
                full_batch=full_b,
                train=(jflat(jp), jflat(js.m),
                       {k: float(v) for k, v in jm.items()}))


def port_prefill(m: dict):
    cfg = m["cfg"]
    cache = T.init_cache(cfg, B, m["frames"] if cfg.enc_dec
                         else m["prompt"] + m["gen"], dtype=torch.float32,
                         device="cpu")
    return T.prefill(m["params"], m["prompt_batch"], cache, cfg,
                     device="cpu")


def close_caches(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(interop.cache_to_arrays(got), want):
        assert set(g) == set(w)
        for name in g:
            assert g[name].shape == w[name].shape, name
            np.testing.assert_allclose(g[name], w[name], rtol=0, atol=2e-3,
                                       err_msg=name)


def check_forward(m: dict) -> None:
    cfg = m["cfg"]
    got = T.forward(m["params"], m["full_batch"], cfg, device="cpu")
    assert got.shape == (B, m["prompt"] + m["gen"], cfg.vocab)
    np.testing.assert_allclose(np_(got), m["full"], rtol=0, atol=2e-3)


def check_prefill(m: dict) -> None:
    logits, cache = port_prefill(m)
    np.testing.assert_allclose(np_(logits), m["prefill"], rtol=0, atol=2e-3)
    close_caches(cache, m["prefill_cache"])


def check_decode(m: dict) -> None:
    cfg = m["cfg"]
    _, cache = port_prefill(m)
    toks = m["full_batch"][token_key(cfg)]
    steps = []
    for t in range(m["prompt"], m["prompt"] + m["gen"]):
        lg, cache = T.decode_step(m["params"], toks[:, t:t + 1], t, cache,
                                  cfg, device="cpu")
        steps.append(np_(lg[:, 0]))
    np.testing.assert_allclose(np.stack(steps, 1), m["steps"], rtol=0,
                               atol=2e-3)
    close_caches(cache, m["cache"])


def port_train_step(m: dict) -> dict:
    """The port's train step from the crossed weights on the full batch,
    and ``make_eval_step``'s metrics at those weights."""
    cfg = m["cfg"]
    pt = interop.params_from_arrays(m["pj"], device="cpu")
    first = make_eval_step(cfg, device="cpu")(pt, m["full_batch"])
    tp, ts, tm = make_train_step(cfg, device="cpu", **TRAIN_KW)(
        pt, opt_init(cfg.optimizer, pt), m["full_batch"])
    return dict(got=(flat(tp), flat(ts.m),
                     {k: float(v) for k, v in tm.items()}),
                eval=first, step=int(ts.step))


def check_train_metrics(m: dict, stepped: dict) -> None:
    want, got = m["train"][2], stepped["got"][2]
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                   err_msg=k)
    assert got["skipped"] == 0 and stepped["step"] == 1
    np.testing.assert_allclose(float(stepped["eval"]["loss"]), got["loss"],
                               rtol=1e-6)


def check_train_gradients(m: dict, stepped: dict,
                          left_out_cap: float = 0.05) -> None:
    """Gradients within 1e-4 of each leaf's max |g|; stepped parameters
    within 1e-6 where the reference's |g| is 0 or above 1e-3 of its
    leaf's max, and within 2 lr elsewhere (AdamW's first step moves an
    element by at most lr in each package); the elements left out of the
    1e-6 comparison at most ``left_out_cap`` of the parameters."""
    (wp, wm, _), (gp, gm, _) = m["train"], stepped["got"]
    assert wm.keys() == gm.keys()
    left_out = total = 0
    for path, mom in wm.items():
        g_want, g_got = mom / 0.1, gm[path] / 0.1
        top = np.abs(g_want).max()
        if top == 0:             # a leaf the loss does not reach
            assert np.abs(g_got).max() == 0, path
            np.testing.assert_array_equal(gp[path], wp[path])
            continue
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=1e-4 * top,
                                   err_msg=str(path))
        keep = (np.abs(g_want) > 1e-3 * top) | (g_want == 0)
        np.testing.assert_allclose(gp[path][keep], wp[path][keep], rtol=0,
                                   atol=1e-6, err_msg=str(path))
        np.testing.assert_allclose(gp[path][~keep], wp[path][~keep], rtol=0,
                                   atol=2 * TRAIN_KW["base_lr"] + 1e-6,
                                   err_msg=str(path))
        left_out += int((~keep).sum())
        total += keep.size
    assert left_out <= left_out_cap * total, (left_out, total)


def check_serving_consistency(m: dict, **overrides) -> None:
    """Greedy serving of the prompt against the port's own teacher-forced
    forward over the prompt and the generated tokens (``overrides`` on
    the config, e.g. a MoE capacity with headroom): the logits agree at
    2e-3 and each token is the forward's argmax."""
    cfg = dataclasses.replace(m["cfg"], **overrides)
    p, key = m["params"], token_key(cfg)
    prompt, gen = m["prompt"], m["gen"]
    pre = m["prompt_batch"][key]
    out = serve.greedy_generate(p, cfg, pre, gen,
                                frames=m["prompt_batch"].get("frames"),
                                device="cpu")
    assert out.tokens.shape == (B, gen)
    assert out.logits.shape == (B, gen, cfg.vocab)
    seq = np.concatenate([pre, np_(out.tokens)], axis=1)
    full = T.forward(p, {**m["prompt_batch"], key: seq}, cfg, device="cpu")
    ref = full[:, prompt - 1:prompt + gen - 1]
    np.testing.assert_allclose(np_(out.logits), np_(ref), rtol=0, atol=2e-3)
    assert torch.equal(out.tokens, torch.argmax(ref, dim=-1))
