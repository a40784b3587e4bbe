"""The port's trainer alone, on the CPU: counterparts of the ten tests of
tests/test_train.py (loss falling, a non-finite step skipped, microbatch
accumulation, remat, the optimizers' math, int8 compression, the
checkpointer, the learning rate's shape, what is refused), and the
training CLI's resume and final checkpoint on SIGTERM.  The port against
repro's trainer is tests/test_torch_train.py.

Tolerances: microbatch accumulation 5e-3 absolute on the stepped
parameters and 1e-5 relative on the loss (fp32 sums in another order);
AdamW's first step 1e-5 relative to its closed form; remat bitwise.
"""
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch", exc_type=ImportError)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import (Checkpointer, compression,  # noqa: E402
                               make_train_step, opt_init)
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.step import lr_schedule  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _clone(tree):
    return common.tree_map(torch.clone, tree)


def _params(arch="h2o-danube-1.8b", seed=0):
    cfg = get_config(arch, smoke=True)
    return cfg, serve.build_params(cfg, seed, "cpu")


# ---------------------------------------------------------------------------
# the port's trainer: counterparts of tests/test_train.py
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(0)


def patterned_batch(cfg, b=8, s=64):
    start = RNG.integers(0, cfg.vocab, (b, 1))
    return {"tokens": ((start + 7 * np.arange(s)[None, :]) % cfg.vocab
                       ).astype(np.int32)}


def test_loss_decreases():
    cfg, params = _params()
    opt = opt_init(cfg.optimizer, params)
    step = make_train_step(cfg, base_lr=1e-3, warmup=5, total_steps=100,
                           microbatch=1, device="cpu")
    losses = []
    for _ in range(40):
        params, opt, m = step(params, opt, patterned_batch(cfg))
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.6 * losses[0], losses[::10]


def test_nan_step_skipped_params_intact():
    cfg, params = _params()
    params["embed"][0, 0] = float("nan")
    before = _clone(params)
    opt = opt_init(cfg.optimizer, params)
    batch = patterned_batch(cfg)
    batch["tokens"][:, 0] = 0                 # hit the NaN row
    p2, o2, m = make_train_step(cfg, microbatch=1, device="cpu")(
        params, opt, batch)
    assert int(m["skipped"]) == 1
    for (_, a), (_, b) in zip(common.leaves(p2), common.leaves(before)):
        assert torch.equal(a, b) or torch.equal(torch.isnan(a),
                                                torch.isnan(b))
    assert torch.equal(p2["final_norm"], before["final_norm"])
    assert all(float(v.abs().max()) == 0 for _, v in common.leaves(o2.m))
    # the step counter still advances (no livelock on a bad batch)
    assert int(o2.step) == 1


def test_microbatch_equivalence():
    cfg, params = _params()
    batch = patterned_batch(cfg)
    p1, _, m1 = make_train_step(cfg, microbatch=1, device="cpu")(
        _clone(params), opt_init(cfg.optimizer, params), batch)
    p4, _, m4 = make_train_step(cfg, microbatch=4, device="cpu")(
        _clone(params), opt_init(cfg.optimizer, params), batch)
    for (_, a), (_, b) in zip(common.leaves(p1), common.leaves(p4)):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-3)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("b,mb", [(6, 4), (2, 4)])
def test_microbatch_must_divide_the_batch(b, mb):
    """A batch that does not divide into the microbatches (a remainder,
    or fewer rows than microbatches) is refused, as the reference's
    reshape refuses it, and nothing is updated."""
    cfg, params = _params()
    before = _clone(params)
    with pytest.raises(ValueError, match=f"{b} rows .* {mb} microbatches"):
        make_train_step(cfg, microbatch=mb, device="cpu")(
            params, opt_init(cfg.optimizer, params),
            {"tokens": np.zeros((b, 64), np.int32)})
    for (_, a), (_, w) in zip(common.leaves(params), common.leaves(before)):
        assert torch.equal(a, w)


def test_remat_changes_no_value():
    """Per-layer checkpointing ("full", "dots") recomputes the same
    values: loss, metrics and parameters equal to "none", bitwise."""
    import dataclasses
    cfg, params = _params("gemma3-27b")
    batch = patterned_batch(cfg, b=2)
    outs = []
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        p, _, m = make_train_step(c, microbatch=1, device="cpu")(
            _clone(params), opt_init(c.optimizer, params), batch)
        outs.append((p, m))
    for p, m in outs[1:]:
        assert all(torch.equal(m[k], outs[0][1][k]) for k in m)
        for (_, a), (_, b) in zip(common.leaves(p),
                                  common.leaves(outs[0][0])):
            assert torch.equal(a, b)


def test_adamw_matches_reference_math():
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, 0.1], [-0.2, 0.3]])}
    st = opt_lib.adamw_init(p)
    p2, st2 = opt_lib.opt_update("adamw", g, st, p, lr=0.1, b1=0.9,
                                 b2=0.95, eps=1e-8, wd=0.0)
    m = 0.1 * g["w"].numpy()
    v = 0.05 * g["w"].numpy() ** 2
    want = p["w"].numpy() - 0.1 * (m / 0.1) / (np.sqrt(v / 0.05) + 1e-8)
    np.testing.assert_allclose(_np(p2["w"]), want, rtol=1e-5)
    assert int(st2.step) == 1


def test_adafactor_memory_is_factored():
    p = {"w": torch.zeros((128, 256)), "b": torch.zeros((64,))}
    st = opt_lib.adafactor_init(p)
    assert st.vr["w"].shape == (128,)
    assert st.vc["w"].shape == (256,)
    assert st.v["w"].shape == (0,)          # sentinel
    assert st.v["b"].shape == (64,)
    g = common.tree_map(torch.ones_like, p)
    p2, _ = opt_lib.opt_update("adafactor", g, st, p, lr=1e-2)
    assert all(bool(torch.isfinite(v).all()) for _, v in common.leaves(p2))


def test_quadratic_converges_with_int8_compression():
    """Error feedback keeps a quadratic converging despite 8-bit grads."""
    w = torch.tensor([3.0, -2.0, 1.5, 8.0])
    err = torch.zeros_like(w)
    for _ in range(300):
        q, s, err = compression.compress_with_feedback(2 * w, err)
        w = w - 0.05 * compression.dequant8(q, s)
    assert float(w.abs().max()) < 1e-2, w


def test_quantize_roundtrip_error_bounded():
    g = torch.from_numpy(RNG.standard_normal(1000).astype(np.float32)) * 5
    q, s = compression.quantize8(g)
    assert q.dtype == torch.int8
    back = compression.dequant8(q, s)
    assert float((back - g).abs().max()) <= float(s) * 0.5 + 1e-6


def test_checkpointer_atomic_keep_and_resume():
    cfg, params = _params("nemotron-4-340b")
    opt = opt_lib.adafactor_init(params)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for s in (1, 5, 9):
            ck.save(s, {"params": params, "opt": opt})
        ck.wait()
        assert ck.all_steps() == [5, 9]             # keep-last-2
        back = ck.restore({"params": params, "opt": opt})
        assert isinstance(back["opt"], opt_lib.AdafactorState)
        for (pa, a), (pb, b) in zip(common.leaves(back["params"]),
                                    common.leaves(params)):
            assert pa == pb and torch.equal(a, b)
        assert not [f for f in os.listdir(d) if f.startswith(".tmp")]


def test_checkpointer_rejects_shape_mismatch():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_writes=False)
        ck.save(0, {"w": torch.zeros((4, 4))})
        with pytest.raises(ValueError, match="shape"):
            ck.restore({"w": torch.zeros((8, 8))})
        with pytest.raises(ValueError, match="leaves"):
            ck.restore({"w": torch.zeros((4, 4)), "b": torch.zeros(2)})


def test_lr_schedule_shape():
    lrs = [float(lr_schedule(torch.tensor(s), base_lr=1e-3, warmup=10,
                             total=100)) for s in range(100)]
    assert abs(lrs[0] - 1e-4) < 1e-9           # first update is nonzero
    assert abs(lrs[9] - 1e-3) < 1e-9           # end of warmup
    assert lrs[99] < lrs[50] < lrs[9]
    assert lrs[99] >= 1e-4 - 1e-9              # min_frac floor


def test_hybrid_training_names_its_roadmap_item():
    cfg = get_config("hymba-1.5b", smoke=True)
    with pytest.raises(NotImplementedError, match="item 20"):
        make_train_step(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        T.loss_fn({}, {"tokens": np.zeros((1, 4), np.int64)}, cfg,
                  device="cpu")


# ---------------------------------------------------------------------------
# the CLI: resume, and the final checkpoint on SIGTERM
# ---------------------------------------------------------------------------


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--arch", "pixtral-12b", "--smoke", "--batch", "2", "--seq",
            "32", "--lr", "1e-3", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "4", "--device", "cpu", "--log-every", "1"]
    assert launch_train.main(argv + ["--steps", "6"]) == 0
    assert Checkpointer(str(tmp_path)).all_steps() == [0, 4, 5]
    assert launch_train.main(argv + ["--steps", "8"]) == 0
    out = capsys.readouterr().out
    assert "[resume] from step 5 -> starting at 6" in out
    assert "step     6 loss" in out and "step     5 loss" in out


def test_train_cli_checkpoints_on_sigterm(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "h2o-danube-1.8b", "--smoke", "--steps", "100000", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every",
         "100000", "--log-every", "1", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("step     2"):
                break
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert "[sigterm]" in out and "done." in out
    steps = Checkpointer(str(tmp_path)).all_steps()
    assert steps[0] == 0 and steps[-1] >= 2
