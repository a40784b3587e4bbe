"""Where the port runs, and what it may import.

* Entry points default to the CUDA card: without one they raise and do
  not carry on on the CPU (the card's absence is simulated, so the test
  means the same on any machine).
* ``ops`` dispatches on the tensor's device alone: a CPU tensor takes
  the plain version and counts no launch; a kernel wrapper refuses a
  CPU tensor instead of falling back.
* No module of ``src/repro_torch`` and neither chip script imports
  ``jax`` or anything of ``repro`` (an AST scan).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro_torch import interop, resolve_device
from repro_torch.core import engine
from repro_torch.core.index import build
from repro_torch.core.search import search_block_major
from repro_torch.data import random_walk
from repro_torch.kernels import ops, ref
from repro_torch.kernels.batch_l2 import batch_l2
from repro_torch.kernels.block_topk import block_topk
from repro_torch.kernels.dtw_band import dtw_band_panel
from repro_torch.kernels.fused_refine import fused_panel_topk
from repro_torch.kernels.isax_summarize import isax_summarize
from repro_torch.kernels.lb_scan import lb_scan
from repro_torch.kernels.ssm_scan import ssm_scan
from _torch_parity import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def cpu_index():
    return build(random_walk(200, 64, seed=1), capacity=32, device="cpu")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(no_card, cpu_index):
    raw = random_walk(50, 64, seed=2)
    q = torch.from_numpy(raw[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(raw, capacity=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        search_block_major(cpu_index, q, k=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.run(cpu_index, q, engine.QueryPlan(k=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.block_index_from_arrays(
            interop.block_index_to_arrays(cpu_index), n=64, w=16, card=256,
            capacity=32, n_real=200)
    # the same calls run when the CPU is asked for
    assert search_block_major(cpu_index, q, k=3, device="cpu").idx.shape == (2, 3)


@pytest.mark.parametrize("entry", ["search", "search_paris", "search_scan",
                                   "search_dtw", "search_vectors",
                                   "build_flat"])
def test_slice2_entry_points_default_to_the_card(no_card, cpu_index, entry):
    from repro_torch import core
    from repro_torch.core import dtw, vector
    raw = random_walk(50, 64, seed=2)
    q = raw[:2]
    call = {"search": lambda **kw: core.search(cpu_index, q, k=3, **kw),
            "search_paris": lambda **kw: core.search_paris(cpu_index, q, k=3,
                                                           **kw),
            "search_scan": lambda **kw: core.search_scan(raw, q, k=3, **kw),
            "search_dtw": lambda **kw: dtw.search_dtw(cpu_index, q, r=3, k=3,
                                                      **kw),
            "search_vectors": lambda **kw: vector.search_vectors(
                cpu_index, q, k=3, **kw),
            "build_flat": lambda **kw: core.build_flat(raw, **kw)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    call(device="cpu")               # the same call runs on the CPU


@pytest.mark.parametrize("entry", ["serve_main", "build_params",
                                   "init_cache", "forward", "prefill",
                                   "decode_step", "greedy_generate",
                                   "params_from_arrays"])
def test_serve_entry_points_default_to_the_card(no_card, entry):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_config("hymba-1.5b", smoke=True)
    params = serve.build_params(cfg, 0, "cpu")
    tokens = np.zeros((1, 4), dtype=np.int64)

    def cache(**kw):
        return T.init_cache(cfg, 1, 8, dtype=torch.float32, **kw)

    call = {
        "serve_main": lambda **kw: serve.main(
            ["--arch", "hymba-1.5b", "--smoke", "--batch", "1",
             "--prompt-len", "4", "--gen", "2"]
            + (["--device", kw["device"]] if kw else [])),
        "build_params": lambda **kw: serve.build_params(cfg, 0, **kw),
        "init_cache": cache,
        "forward": lambda **kw: T.forward(params, {"tokens": tokens}, cfg,
                                          **kw),
        "prefill": lambda **kw: T.prefill(params, {"tokens": tokens},
                                          cache(device="cpu"), cfg, **kw),
        "decode_step": lambda **kw: T.decode_step(
            params, tokens[:, :1], 0, cache(device="cpu"), cfg, **kw),
        "greedy_generate": lambda **kw: serve.greedy_generate(
            params, cfg, tokens, 2, **kw),
        "params_from_arrays": lambda **kw: interop.params_from_arrays(
            {"w": np.zeros(3, np.float32)}, **kw)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    call(device="cpu")               # the same call runs on the CPU


def test_model_entry_points_refuse_parameters_elsewhere():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_config("hymba-1.5b", smoke=True)
    params = serve.build_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="parameters are on cpu"):
        T.forward(params, {"tokens": np.zeros((1, 4), np.int64)}, cfg,
                  device="meta")


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_trace.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_ops_on_cpu_take_the_plain_versions():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    p, s = ops.summarize(x, w=16, card=256)
    pr, sr = ref.isax_summarize_ref(x, w=16, card=256)
    assert torch.equal(p, pr) and torch.equal(s, sr)
    lo = torch.from_numpy(rng.standard_normal((16, 30)).astype(np.float32))
    hi = lo + 1
    assert torch.equal(ops.lb_scan_planar(p[:3], lo, hi, n=64),
                       ref.lb_scan_ref(p[:3], lo, hi, n=64))
    d = torch.from_numpy(rng.random((3, 30)).astype(np.float32))
    ids = torch.arange(90, dtype=torch.int32).reshape(3, 30)
    for got, want in zip(ops.block_topk(d, ids, 40), ref.block_topk_ref(d, ids, 40)):
        assert torch.equal(got, want)
    thr = torch.tensor([float("-inf"), 1e9, 0.0])
    args = (x[:3], p[:3], x[3:33], lo, hi, ids[0], thr)
    for got, want in zip(ops.fused_panel_topk(*args, k=5, n=64),
                         ref.fused_panel_topk_ref(*args, k=5, n=64)):
        assert torch.equal(got, want)
    assert torch.equal(ops.batch_l2(x[:3], x[3:]), ref.batch_l2_ref(x[:3], x[3:]))
    gathered = x[3:33].reshape(3, 10, 64)
    for panel in (x[3:13], gathered):
        assert torch.equal(ops.dtw_panel(x[:3], panel, r=4),
                           ref.dtw_band_panel_ref(x[:3], panel, r=4))
    xc = x[:6].reshape(2, 3, 64)
    bm = xc[..., :4].contiguous()
    a = -x[6:22].reshape(64, 16)[:, :4].abs()
    for got, want in zip(ops.ssm_scan(xc, xc.abs(), bm, bm, a),
                         ref.ssm_scan_ref(xc, xc.abs(), bm, bm, a)):
        assert torch.equal(got, want)
    assert ops.launch_counts() == {"isax_summarize": 0, "lb_scan": 0,
                                   "block_topk": 0, "fused_panel_topk": 0,
                                   "batch_l2": 0, "dtw_band_panel": 0,
                                   "ssm_scan": 0, "ssm_scan_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 64))
    q = torch.zeros((2, 16))
    lo = torch.zeros((16, 8))
    ids = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        isax_summarize(x, w=16, card=256)
    with pytest.raises(ValueError, match="CUDA"):
        lb_scan(q, lo, lo, n=64)
    with pytest.raises(ValueError, match="CUDA"):
        block_topk(torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32), k=3)
    with pytest.raises(ValueError, match="CUDA"):
        fused_panel_topk(torch.zeros((2, 64)), q, torch.zeros((8, 64)), lo, lo,
                         ids, torch.zeros(2), k=3, n=64)
    with pytest.raises(ValueError, match="CUDA"):
        batch_l2(q, torch.zeros((8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        dtw_band_panel(q, torch.zeros((2, 8, 16)), r=2)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan(torch.zeros((1, 3, 8)), torch.zeros((1, 3, 8)),
                 torch.zeros((1, 3, 4)), torch.zeros((1, 3, 4)),
                 torch.zeros((8, 4)))
    assert ops.launch_counts()["block_topk"] == 0
    assert ops.launch_counts()["ssm_scan"] == 0
