"""The port's LM wing (configs, common, attention, transformer, serving)
against repro's, on the CPU.

Weights are ``repro``'s ``build_params`` carried across name for name by
``interop.params_from_arrays``; inputs are numpy arrays from a seed.
Tolerances: norms and RoPE rtol / atol 1e-6 (elementwise float32 with a
reduction of d terms); attention rtol / atol 2e-4, the bar of
tests/test_models.py's attention tests (online softmax merged in another
order); Hymba ``smoke()`` logits, caches and decode steps 2e-3 absolute,
the bar of tests/test_models.py's prefill/decode consistency test.

The reference's ``decode_attend`` reads only whole chunks of the cache,
so it is compared with the port only at cache lengths that are at most
one chunk; at a ragged length the port must equal a plain masked softmax
and the reference must not (the fault is the reference's, recorded in
ROADMAP.md Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro.configs import count_params as jcount_params
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import count_params, get_config
from repro_torch.launch import serve
from repro_torch.models import attention, common
from repro_torch.models import transformer as T
from repro_torch.train import make_eval_step, make_train_step

ARCH = "hymba-1.5b"
B, PROMPT, GEN = 2, 32, 8


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rand(rng, *shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert count_params(cfg) == jcount_params(jcfg)
    assert (cfg.vocab_padded, cfg.q_dim, cfg.kv_dim) == \
        (jcfg.vocab_padded, jcfg.q_dim, jcfg.kv_dim)
    assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == \
        [jcfg.layer_kind(i) for i in range(jcfg.n_layers)]
    assert [dataclasses.astuple(s) for s in T.segments(cfg)] == \
        [(s.kind, s.start, s.end) for s in JT.segments(jcfg)]


def test_other_architectures_name_their_roadmap_item():
    """Every architecture resolves; the families the port does not run
    yet raise in ``param_specs`` and in every entry point, naming their
    item, and so does training Hymba."""
    for arch, item in (("rwkv6-7b", "item 18c"),
                       ("granite-moe-1b-a400m", "item 18c"),
                       ("whisper-medium", "item 18d")):
        cfg = get_config(arch, smoke=True)
        calls = (lambda: T.param_specs(cfg),
                 lambda: T.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: T.forward({}, {"tokens": np.zeros((1, 8))}, cfg,
                                   device="cpu"),
                 lambda: T.loss_fn({}, {"tokens": np.zeros((1, 8))}, cfg,
                                   device="cpu"))
        for call in calls:
            with pytest.raises(NotImplementedError, match=item):
                call()
    cfg = get_config(ARCH, smoke=True)
    params = serve.build_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        T.loss_fn(params, {"tokens": np.zeros((1, 8), np.int64)}, cfg,
                  device="cpu")
    with pytest.raises(SystemExit):   # argparse: --arch is required here
        serve.main(["--smoke", "--device", "cpu"])


@pytest.mark.parametrize("smoke", [False, True])
def test_param_specs_match_reference(smoke):
    cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    leaf = lambda s: (tuple(s.shape), tuple(s.axes), s.init, s.scale,
                      s.value)
    got = common.tree_map(leaf, T.param_specs(cfg))
    want = jax.tree.map(leaf, JT.param_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    assert got == want


def test_build_params_follows_the_init_rules():
    cfg = get_config(ARCH, smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = common.build_params(T.param_specs(cfg), gen, "cpu")
    assert torch.equal(p["layers"]["ln1"], torch.zeros(4, 64))
    assert torch.equal(p["layers"]["mamba"]["d_skip"], torch.ones(4, 64))
    assert torch.equal(p["layers"]["mamba"]["a_log"], torch.zeros(4, 64, 8))
    w = p["layers"]["ffn"]["wd"]                     # fan_in 128
    assert abs(float(w.std()) - 128 ** -0.5) < 0.05 * 128 ** -0.5
    again = common.build_params(T.param_specs(cfg),
                                torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], p["embed"])


def test_params_and_cache_cross_name_for_name():
    cfg = get_config(ARCH, smoke=True)
    p = serve.build_params(cfg, 3, "cpu")
    arrays = interop.params_to_arrays(p)
    back = interop.params_from_arrays(arrays, device="cpu")
    flat = lambda t: dict(common.leaves(t))
    assert flat(back).keys() == flat(p).keys()
    assert all(torch.equal(flat(back)[k], v) for k, v in flat(p).items())
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for seg in interop.cache_from_arrays(interop.cache_to_arrays(cache),
                                         device="cpu"):
        assert set(seg) == {"k", "v", "m_h", "m_conv"}


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def test_rmsnorm_rope_softcap():
    rng = np.random.default_rng(0)
    x, gamma = _rand(rng, 2, 5, 3, 16), _rand(rng, 16, scale=0.1)
    np.testing.assert_allclose(
        _np(common.rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma))),
        _np(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(gamma))),
        rtol=1e-6, atol=1e-6)
    pos = np.array([[0, 1, 7, 100, 2047]] * 2)
    np.testing.assert_allclose(
        _np(common.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)),
        _np(jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        _np(common.softcap(torch.from_numpy(x), 3.0)),
        _np(jcommon.softcap(jnp.asarray(x), 3.0)), rtol=1e-6, atol=1e-6)
    for kind in ("silu", "gelu", "squared_relu"):
        np.testing.assert_allclose(
            _np(common.activation(kind)(torch.from_numpy(x))),
            _np(jcommon.activation(kind)(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6)


def _qkv(seed, s=64, sk=None, h=4, kvh=2, hd=16, b=2):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (_rand(rng, b, s, h, hd), _rand(rng, b, sk, kvh, hd),
            _rand(rng, b, sk, kvh, hd))


def _naive_masked(q, k, v, valid):
    """Plain softmax attention of q (B, Sq, H, hd) over k, v (B, Sk, KVH,
    hd) with a (B, Sq, Sk) mask, GQA by repeating KV heads."""
    q, k, v = (torch.as_tensor(a).double() for a in (q, k, v))
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bchd->bhqc", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~torch.from_numpy(np.array(valid))[:, None],
                      float("-inf"))
    return torch.einsum("bhqc,bchd->bqhd", torch.softmax(s, -1), v).float()


@pytest.mark.parametrize("window,chunk", [(0, 16), (0, 24), (0, 64),
                                          (8, 16), (24, 16), (48, 16)])
def test_attend_matches_reference(window, chunk):
    q, k, v = _qkv(window + chunk)
    got = attention.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                           window=window, chunk=chunk)
    want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v)), window=window,
                        chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    qp, kp = np.arange(64)[:, None], np.arange(64)[None, :]
    valid = (qp >= kp) & ((qp - kp < window) if window else True)
    np.testing.assert_allclose(
        _np(got), _np(_naive_masked(q, k, v, np.broadcast_to(valid,
                                                             (2, 64, 64)))),
        rtol=2e-4, atol=2e-4)


def test_attend_noncausal_with_offset():
    q, k, v = _qkv(3, s=24, sk=56)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = attention.attend(*args, causal=False, chunk=16)
    want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                        chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    got = attention.attend(*args, chunk=8, q_offset=32)
    want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v)), chunk=8,
                        q_offset=32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_cache_update_ring_matches_reference():
    window = 16
    _, k, v = _qkv(4, s=40)
    rk = jnp.zeros((2, window, 2, 16))
    rv = jnp.zeros((2, window, 2, 16))
    tk, tv = torch.zeros((2, window, 2, 16)), torch.zeros((2, window, 2, 16))
    for t in range(40):
        rk, rv = jattn.cache_update(rk, rv, k[:, t:t + 1], v[:, t:t + 1],
                                    jnp.asarray(t), window=window)
        tk, tv = attention.cache_update(
            tk, tv, torch.from_numpy(k[:, t:t + 1]),
            torch.from_numpy(v[:, t:t + 1]), t, window=window)
    assert np.array_equal(_np(tk), _np(rk)) and np.array_equal(_np(tv), _np(rv))
    # per-row positions
    pos = torch.tensor([3, 9])
    attention.cache_update(tk, tv, torch.ones((2, 1, 2, 16)),
                           torch.ones((2, 1, 2, 16)), pos)
    assert float(tk[0, 3].min()) == 1.0 and float(tk[1, 9].min()) == 1.0


@pytest.mark.parametrize("sk,pos,window", [(64, 63, 0), (64, 20, 0),
                                           (1024, 900, 0), (1024, 1023, 0),
                                           (16, 39, 16)])
def test_decode_attend_matches_reference(sk, pos, window):
    q, k, v = _qkv(sk + pos, s=1, sk=sk)
    got = attention.decode_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                                  pos, window=window)
    want = jattn.decode_attend(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.asarray(pos), window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_decode_attend_over_a_ragged_cache():
    """1,500 slots, pos 1,400, chunk 1,024: the port attends slots
    1,024..1,400 too and equals the plain masked softmax; the reference
    drops them."""
    q, k, v = _qkv(1500, s=1, sk=1500, b=1)
    got = attention.decode_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                                  1400)
    valid = (np.arange(1500) <= 1400)[None, None, :]
    want = _naive_masked(q, k, v, valid)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    ref = jattn.decode_attend(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(1400))
    assert np.abs(_np(ref) - _np(want)).max() > 1e-2


# ---------------------------------------------------------------------------
# Hymba smoke(): the whole model against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hymba():
    """Shared weights and tokens, the reference's forward, prefill (cache
    included) and GEN decode steps."""
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    pj = jcommon.build_params(JT.param_specs(jcfg), jax.random.PRNGKey(0))
    pt = interop.params_from_arrays(jax.tree.map(np.asarray, pj),
                                    device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, PROMPT + GEN)).astype(np.int32)
    full, _ = JT.forward(pj, {"tokens": jnp.asarray(tokens)}, jcfg)
    cache = JT.init_cache(jcfg, B, PROMPT + GEN, dtype=jnp.float32)
    pre, cache = JT.prefill(pj, {"tokens": jnp.asarray(tokens[:, :PROMPT])},
                            cache, jcfg)
    pre_cache = jax.tree.map(np.asarray, cache)
    step = jax.jit(lambda p, t, pos, c: JT.decode_step(p, t, pos, c, jcfg))
    steps = []
    for t in range(PROMPT, PROMPT + GEN):
        lg, cache = step(pj, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(t),
                         cache)
        steps.append(np.asarray(lg[:, 0]))
    _, loss = JT.loss_fn(pj, {"tokens": jnp.asarray(tokens)}, jcfg)
    return dict(cfg=cfg, params=pt, tokens=tokens, full=np.asarray(full),
                prefill=np.asarray(pre), prefill_cache=pre_cache,
                steps=np.stack(steps, 1),
                cache=jax.tree.map(np.asarray, cache),
                loss={k: float(loss[k]) for k in ("ce", "loss")})


def _port_prefill(h):
    cfg = h["cfg"]
    cache = T.init_cache(cfg, B, PROMPT + GEN, dtype=torch.float32,
                         device="cpu")
    return T.prefill(h["params"], {"tokens": h["tokens"][:, :PROMPT]}, cache,
                     cfg, device="cpu")


def _close_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(interop.cache_to_arrays(got), want):
        assert set(g) == set(w)
        for name in g:
            np.testing.assert_allclose(g[name], w[name], rtol=0, atol=2e-3,
                                       err_msg=name)


def test_hymba_forward_matches_reference(hymba):
    got = T.forward(hymba["params"], {"tokens": hymba["tokens"]},
                    hymba["cfg"], device="cpu")
    assert got.shape == (B, PROMPT + GEN, hymba["cfg"].vocab)
    np.testing.assert_allclose(_np(got), hymba["full"], rtol=0, atol=2e-3)


def test_hymba_prefill_matches_reference(hymba):
    logits, cache = _port_prefill(hymba)
    np.testing.assert_allclose(_np(logits), hymba["prefill"], rtol=0,
                               atol=2e-3)
    _close_caches(cache, hymba["prefill_cache"])


def test_hymba_decode_matches_reference(hymba):
    cfg = hymba["cfg"]
    _, cache = _port_prefill(hymba)
    steps = []
    for t in range(PROMPT, PROMPT + GEN):
        lg, cache = T.decode_step(hymba["params"],
                                  hymba["tokens"][:, t:t + 1], t, cache, cfg,
                                  device="cpu")
        steps.append(_np(lg[:, 0]))
    np.testing.assert_allclose(np.stack(steps, 1), hymba["steps"], rtol=0,
                               atol=2e-3)
    _close_caches(cache, hymba["cache"])


def test_hymba_serving_is_consistent_with_forward(hymba):
    """Greedy serving (prefill, then GEN - 1 decode steps) against the
    port's own teacher-forced forward over the prompt and the generated
    tokens: the logits agree, and each token is the forward's argmax."""
    cfg, p = hymba["cfg"], hymba["params"]
    prompt = hymba["tokens"][:, :PROMPT]
    out = serve.greedy_generate(p, cfg, prompt, GEN, device="cpu")
    assert out.tokens.shape == (B, GEN) and out.logits.shape == (B, GEN,
                                                                 cfg.vocab)
    seq = np.concatenate([prompt, _np(out.tokens)], axis=1)
    full = T.forward(p, {"tokens": seq}, cfg, device="cpu")
    ref = full[:, PROMPT - 1:PROMPT + GEN - 1]
    np.testing.assert_allclose(_np(out.logits), _np(ref), rtol=0, atol=2e-3)
    assert torch.equal(out.tokens, torch.argmax(ref, dim=-1))


def test_hymba_eval_loss_matches_reference(hymba):
    """Hymba's loss without autograd (``make_eval_step`` and a no-grad
    ``loss_fn``) runs and matches the reference's at 1e-5 relative, the
    bar of the dense archs' train steps; under autograd it is refused."""
    cfg, p = hymba["cfg"], hymba["params"]
    batch = {"tokens": hymba["tokens"]}
    got = make_eval_step(cfg, device="cpu")(p, batch)
    with torch.no_grad():
        loss, _ = T.loss_fn(p, batch, cfg, device="cpu")
    for k, want in hymba["loss"].items():
        np.testing.assert_allclose(float(got[k]), want, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), hymba["loss"]["loss"], rtol=1e-5)
    with pytest.raises(NotImplementedError, match="item 20"):
        make_train_step(cfg, device="cpu")


def test_serve_cli_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen",
                       "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/token" in out and "device=cpu" in out
