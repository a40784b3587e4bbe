"""The port's dense and vlm families and the ten configs against repro's,
on the CPU.

Configs, counts, layer kinds, segments and shape cells are compared
exactly for all ten architectures; parameter specs for the five the port
runs (command-r, gemma3, h2o-danube, nemotron, pixtral).  Weights are
``repro``'s ``build_params`` carried across name for name by
``interop.params_from_arrays``; inputs are numpy arrays from a seed.
Tolerances: the causal attention schedule rtol / atol 2e-4, the bar
of tests/test_models.py's attention tests; each smoke model's forward,
prefill (cache included) and 8 decode steps 2e-3 absolute, the bar of
tests/test_models.py's prefill/decode consistency test.  Cache lengths
stay below one decode chunk (1,024 slots): the reference's
``decode_attend`` reads only whole chunks (ROADMAP.md Queue 3).  The
reference's dense stack reaches no Pallas kernel.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch", exc_type=ImportError)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as J  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ALL = J.list_archs()
RUNS = ("command-r-35b", "gemma3-27b", "h2o-danube-1.8b",
        "nemotron-4-340b", "pixtral-12b")
B, PROMPT, GEN = 2, 32, 8


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# configs and counts, all ten architectures
# ---------------------------------------------------------------------------


def test_registry_and_shapes_match_reference():
    assert configs.list_archs() == ALL and len(ALL) == 10
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}
    assert serve.RUNS == tuple(sorted(RUNS + ("hymba-1.5b",)))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ALL)
def test_config_and_counts_match_reference(arch, smoke):
    cfg, jcfg = (configs.get_config(arch, smoke=smoke),
                 J.get_config(arch, smoke=smoke))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert configs.count_params(cfg) == J.count_params(jcfg)
    assert configs.active_params(cfg) == J.active_params(jcfg)
    for name in ("vocab_padded", "q_dim", "kv_dim", "attn_free",
                 "sub_quadratic", "global_positions"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == \
        [jcfg.layer_kind(i) for i in range(jcfg.n_layers)]
    assert [cfg.runs_shape(s) for s in (*J.SHAPES, "other")] == \
        [jcfg.runs_shape(s) for s in (*J.SHAPES, "other")]
    for n in (None, 1, 7, cfg.n_layers):
        assert [dataclasses.astuple(s) for s in T.segments(cfg, n)] == \
            [(s.kind, s.start, s.end) for s in JT.segments(jcfg, n)]


@pytest.mark.parametrize("arch", ALL)
def test_full_config_matches_assignment(arch):
    """The counterpart of tests/test_models.py's: the full configs carry
    the assigned numbers."""
    cfg = configs.get_config(arch)
    expect = {
        "pixtral-12b": (40, 5120, 32, 8, 14336, 131072),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
        "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155),
        "command-r-35b": (40, 8192, 64, 8, 22528, 256000),
        "h2o-danube-1.8b": (24, 2560, 32, 8, 6912, 32000),
        "gemma3-27b": (62, 5376, 32, 16, 21504, 262144),
        "nemotron-4-340b": (96, 18432, 96, 8, 73728, 256000),
        "whisper-medium": (24, 1024, 16, 16, 4096, 51865),
        "hymba-1.5b": (32, 1600, 25, 5, 5504, 32001),
        "rwkv6-7b": (32, 4096, 0, 0, 14336, 65536),
    }[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == expect


def test_param_counts_in_expected_range():
    for arch, lo, hi in [("granite-moe-1b-a400m", 0.9e9, 1.6e9),
                         ("h2o-danube-1.8b", 1.4e9, 2.2e9),
                         ("rwkv6-7b", 5e9, 9e9),
                         ("gemma3-27b", 2.2e10, 3.3e10),
                         ("command-r-35b", 2.8e10, 4.2e10),
                         ("nemotron-4-340b", 2.8e11, 4.0e11)]:
        assert lo <= configs.count_params(configs.get_config(arch)) <= hi
    moe = configs.get_config("moonshot-v1-16b-a3b")
    assert configs.active_params(moe) < configs.count_params(moe) / 3


def test_gemma3_local_global_pattern():
    cfg = configs.get_config("gemma3-27b")
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    assert kinds.count("full") == 10          # every 6th of 62
    assert all(kinds[i] == "full" for i in range(5, 62, 6))
    assert cfg.global_positions == tuple(range(5, 62, 6))
    six = dataclasses.replace(cfg, n_layers=6)   # chip_smoke's depth cut
    assert [dataclasses.astuple(s) for s in T.segments(six)] == \
        [("swa", 0, 5), ("full", 5, 6)]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", RUNS)
def test_param_specs_match_reference(arch, smoke):
    cfg, jcfg = (configs.get_config(arch, smoke=smoke),
                 J.get_config(arch, smoke=smoke))
    leaf = lambda s: (tuple(s.shape), tuple(s.axes), s.init, s.scale,
                      s.value)
    got = common.tree_map(leaf, T.param_specs(cfg))
    want = jax.tree.map(leaf, JT.param_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    assert got == want


# ---------------------------------------------------------------------------
# the triangular schedule
# ---------------------------------------------------------------------------


def _naive(q, k, v, q_offset=0):
    """Plain causal softmax attention in float64, GQA by repeating."""
    q, k, v = (torch.as_tensor(a).double() for a in (q, k, v))
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bchd->bhqc", q, k) * q.shape[-1] ** -0.5
    qp = q_offset + torch.arange(q.shape[1])[:, None]
    s = s.masked_fill(~(qp >= torch.arange(k.shape[1])[None, :]),
                      float("-inf"))
    return torch.einsum("bhqc,bchd->bqhd", torch.softmax(s, -1), v).float()


@pytest.mark.parametrize("s,sk,chunk,q_offset", [(64, 64, 16, 0),
                                                 (64, 64, 24, 0),
                                                 (32, 64, 16, 32)])
def test_attend_triangular_equals_full(s, sk, chunk, q_offset):
    """The port's one causal schedule, which skips the fully masked KV
    chunks, against the reference's rectangle and its triangular
    schedule, and a float64 softmax."""
    rng = np.random.default_rng(s + chunk + q_offset)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = _np(attention.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                               chunk=chunk, q_offset=q_offset))
    for tri in (False, True):
        want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v)),
                            chunk=chunk, q_offset=q_offset, triangular=tri)
        np.testing.assert_allclose(got, _np(want), rtol=2e-4, atol=2e-4,
                                   err_msg=f"triangular={tri}")
    np.testing.assert_allclose(got, _np(_naive(q, k, v, q_offset)),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# each smoke() model against the reference
# ---------------------------------------------------------------------------


def _batch(cfg, rng) -> dict:
    """Tokens for PROMPT + GEN positions; a vlm batch adds its patches."""
    out = {"tokens": rng.integers(0, cfg.vocab,
                                  (B, PROMPT + GEN)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _prompt(batch: dict) -> dict:
    return {**batch, "tokens": batch["tokens"][:, :PROMPT]}


def _offset(cfg) -> int:
    """Positions before the first token in the cache (a vlm's patches)."""
    return cfg.n_patches if cfg.family == "vlm" else 0


@pytest.fixture(scope="module", params=RUNS)
def model(request):
    """One arch's shared weights and batch, and the reference's forward,
    prefill (cache included) and GEN decode steps, each run once."""
    arch = request.param
    jcfg, cfg = J.get_config(arch, smoke=True), \
        configs.get_config(arch, smoke=True)
    pj = jcommon.build_params(JT.param_specs(jcfg), jax.random.PRNGKey(0))
    pt = interop.params_from_arrays(jax.tree.map(np.asarray, pj),
                                    device="cpu")
    batch = _batch(cfg, np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    full, _ = JT.forward(pj, jb, jcfg)
    off = _offset(cfg)
    cache = JT.init_cache(jcfg, B, off + PROMPT + GEN, dtype=jnp.float32)
    pre, cache = JT.prefill(pj, {k: jnp.asarray(v)
                                 for k, v in _prompt(batch).items()},
                            cache, jcfg)
    pre_cache = jax.tree.map(np.asarray, cache)
    step = jax.jit(lambda p, t, pos, c: JT.decode_step(p, t, pos, c, jcfg))
    steps = []
    for t in range(PROMPT, PROMPT + GEN):
        lg, cache = step(pj, jb["tokens"][:, t:t + 1], jnp.asarray(off + t),
                         cache)
        steps.append(np.asarray(lg[:, 0]))
    return dict(cfg=cfg, params=pt, batch=batch, off=off,
                full=np.asarray(full), prefill=np.asarray(pre),
                prefill_cache=pre_cache, steps=np.stack(steps, 1),
                cache=jax.tree.map(np.asarray, cache))


def _port_prefill(m):
    cfg = m["cfg"]
    cache = T.init_cache(cfg, B, m["off"] + PROMPT + GEN,
                         dtype=torch.float32, device="cpu")
    return T.prefill(m["params"], _prompt(m["batch"]), cache, cfg,
                     device="cpu")


def _close_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(interop.cache_to_arrays(got), want):
        assert set(g) == set(w) == {"k", "v"}
        for name in g:
            np.testing.assert_allclose(g[name], w[name], rtol=0, atol=2e-3,
                                       err_msg=name)


def test_forward_matches_reference(model):
    cfg = model["cfg"]
    got = T.forward(model["params"], model["batch"], cfg, device="cpu")
    assert got.shape == (B, PROMPT + GEN, cfg.vocab)
    np.testing.assert_allclose(_np(got), model["full"], rtol=0, atol=2e-3)


def test_prefill_matches_reference(model):
    logits, cache = _port_prefill(model)
    np.testing.assert_allclose(_np(logits), model["prefill"], rtol=0,
                               atol=2e-3)
    _close_caches(cache, model["prefill_cache"])


def test_decode_matches_reference(model):
    cfg, off = model["cfg"], model["off"]
    _, cache = _port_prefill(model)
    steps = []
    for t in range(PROMPT, PROMPT + GEN):
        lg, cache = T.decode_step(model["params"],
                                  model["batch"]["tokens"][:, t:t + 1],
                                  off + t, cache, cfg, device="cpu")
        steps.append(_np(lg[:, 0]))
    np.testing.assert_allclose(np.stack(steps, 1), model["steps"], rtol=0,
                               atol=2e-3)
    _close_caches(cache, model["cache"])


def test_serving_is_consistent_with_forward(model):
    """Greedy serving of the text-only prompt against the port's own
    teacher-forced forward over prompt and generated tokens."""
    cfg, p = model["cfg"], model["params"]
    prompt = model["batch"]["tokens"][:, :PROMPT]
    out = serve.greedy_generate(p, cfg, prompt, GEN, device="cpu")
    seq = np.concatenate([prompt, _np(out.tokens)], axis=1)
    full = T.forward(p, {"tokens": seq}, cfg, device="cpu")
    ref = full[:, PROMPT - 1:PROMPT + GEN - 1]
    np.testing.assert_allclose(_np(out.logits), _np(ref), rtol=0, atol=2e-3)
    assert torch.equal(out.tokens, torch.argmax(ref, dim=-1))
