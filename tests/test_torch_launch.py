"""The port's launch layer, on the CPU: ``launch.specs`` (meta-device
stand-ins of every cell and each rank's shard shapes) and ``launch.mesh``
against repro's ``launch.specs`` and ``launch.mesh``.

Counterparts of tests/test_launch.py's spec and mesh tests: batch shapes,
nemotron-4-340b's parameter count with nothing allocated, gemma3's SWA
ring against full caches, the long-context rule, 34 cells in all, and
the production meshes' shapes and data axes.  Then every one of the 34
cells: the port's batch, parameter, optimizer and cache stand-ins equal
the reference's ``ShapeDtypeStruct`` leaves in shape and dtype; each
rank's shard shapes on the one- and two-pod production meshes equal what
the reference's ``PartitionSpec``s cut (on a ``jax.sharding.AbstractMesh``
of the same layout, no devices), and ``cache_pspecs`` equals the
reference's spec tree; a rank's cache blocks rebuild the whole cache and
its prefill blocks re-cut to the decode layout are its decode blocks;
``build_cell`` gives a step function and meta arguments.  Exact equality throughout: these are shapes.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.configs as J  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import segments  # noqa: E402
from _torch_parity import abstract_mesh  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

CELLS = [(a, s) for a in list_archs()
         for s in S.runnable_shapes(get_config(a))]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


def _leaves(tree) -> list:
    """The leaves of a port tree in jax's flatten order (dicts by sorted
    key, tuples and lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _same_leaves(got, want, what):
    g, w = _leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.device.type == "meta", (what, i)
        assert tuple(a.shape) == tuple(b.shape), (what, i)
        assert a.dtype == DTYPES[str(b.dtype)], (what, i, a.dtype, b.dtype)


def test_batch_specs_shapes():
    cfg = get_config("h2o-danube-1.8b")
    b = S.batch_specs(cfg, SHAPES["train_4k"])
    assert b["tokens"].shape == (256, 4096)
    cfg = get_config("whisper-medium")
    b = S.batch_specs(cfg, SHAPES["prefill_32k"])
    assert b["frames"].shape == (32, 32768, 1024)
    assert b["dec_tokens"].shape == (32, 448)
    cfg = get_config("pixtral-12b")
    b = S.batch_specs(cfg, SHAPES["train_4k"])
    assert b["patches"].shape == (256, 1024, 5120)
    assert b["tokens"].shape == (256, 4096 - 1024)


def test_param_shapes_no_allocation():
    shapes = S.param_shapes(get_config("nemotron-4-340b"))
    leaves = [t for _, t in common.leaves(shapes)]
    assert all(t.device.type == "meta" for t in leaves)
    total = sum(t.numel() for t in leaves)
    assert 2.8e11 < total < 4.0e11          # ~340B without allocating


def test_cache_shapes_swa_ring_vs_full():
    cfg = get_config("gemma3-27b")
    cs = S.cache_shapes(cfg, 4, 32768)
    for seg, c in zip(segments(cfg), cs):
        want_s = 1024 if seg.kind == "swa" else 32768
        assert c["k"].shape == (seg.size, 4, want_s, 16, 128), seg


def test_runnable_shapes_long_rule():
    runs_long = {a for a in list_archs()
                 if "long_500k" in S.runnable_shapes(get_config(a))}
    assert runs_long == {"h2o-danube-1.8b", "gemma3-27b", "hymba-1.5b",
                         "rwkv6-7b"}
    for a in list_archs():
        rs = S.runnable_shapes(get_config(a))
        assert {"train_4k", "prefill_32k", "decode_32k"} <= set(rs)


def test_total_cell_count_is_34():
    assert len(CELLS) == 34
    assert sorted(CELLS) == sorted(
        (a, s) for a in J.list_archs()
        for s in JS.runnable_shapes(J.get_config(a)))


def test_mesh_function_shapes():
    m1 = M.production_mesh()
    assert m1.shape == (16, 16) and m1.axis_names == ("data", "model")
    assert m1.size == 256 and M.data_axes_of(m1) == ("data",)
    m2 = M.production_mesh(multi_pod=True)
    assert m2.shape == (2, 16, 16)
    assert m2.axis_names == ("pod", "data", "model")
    assert M.data_axes_of(m2) == ("pod", "data")
    assert M.axis_sizes(m2) == {"pod": 2, "data": 16, "model": 16}
    assert M.data_axes_of(M.MeshSpec((2, 1), ("data", "model"))) == \
        ("data",)
    with pytest.raises(ValueError, match="rank"):
        M.MeshSpec((2, 2), ("data",))
    with pytest.raises(RuntimeError, match="initialized"):
        M.make_mesh((2, 1), ("data", "model"), "cpu")


@pytest.mark.parametrize("arch", list_archs())
def test_stand_ins_equal_the_reference_leaves(arch):
    """Every cell of ``arch``: batch, parameters, optimizer state and
    caches, leaf for leaf, in shape and dtype."""
    cfg, jcfg = get_config(arch), J.get_config(arch)
    _same_leaves(S.param_shapes(cfg), JS.param_shapes(jcfg), "params")
    _same_leaves(S.opt_shapes(cfg),
                 jopt.opt_state_shapes(jcfg.optimizer,
                                       JS.param_shapes(jcfg)), "opt")
    for shape in S.runnable_shapes(cfg):
        cell, jcell = SHAPES[shape], J.SHAPES[shape]
        _same_leaves(S.batch_specs(cfg, cell), JS.batch_specs(jcfg, jcell),
                     (shape, "batch"))
        _same_leaves(S.cache_shapes(cfg, cell.global_batch, cell.seq_len),
                     JS.cache_shapes(jcfg, jcell.global_batch,
                                     jcell.seq_len), (shape, "cache"))


def _cut(shape, spec, sizes) -> tuple:
    """What a PartitionSpec leaves of ``shape`` on a rank."""
    out = []
    for i, n in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(n // math.prod(sizes[a] for a in axes))
    return tuple(out)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_shard_shapes_equal_the_reference_partition_specs(multi_pod):
    ms = M.production_mesh(multi_pod=multi_pod)
    am = abstract_mesh(ms.shape, ms.axis_names)
    sizes, data = dict(am.shape), M.data_axes_of(ms)
    for arch, shape in CELLS:
        cfg, jcfg = get_config(arch), J.get_config(arch)
        cell, jcell = SHAPES[shape], J.SHAPES[shape]
        got = S.shard_shapes(cfg, shape, ms)
        if cell.kind != "decode":
            jb = JS.batch_specs(jcfg, jcell)
            jp = JS.batch_pspecs(jcfg, jcell, am, data)
            assert got["batch"] == {k: _cut(jb[k].shape, jp[k], sizes)
                                    for k in jb}, (arch, shape)
        if cell.kind == "train":
            assert "cache" not in got
            continue
        kvs = JS.kv_shard_axes(jcfg, jcell, am, data)
        assert S.kv_shard_axes(cfg, cell, ms, data) == kvs, (arch, shape)
        jc = JS.cache_shapes(jcfg, jcell.global_batch, jcell.seq_len)
        jps = JS.cache_pspecs(jcfg, jcell, am, data, kv_shard=kvs)
        assert got["cache"] == [{k: _cut(seg[k].shape, sp[k], sizes)
                                 for k in seg}
                                for seg, sp in zip(jc, jps)], (arch, shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cache_pspecs_equal_the_reference(multi_pod):
    """``cache_pspecs`` is the reference's spec tree entry by entry, with
    and without ``kv_shard``, for every serving cell; on the small
    meshes the serving tests run too."""
    meshes = [M.production_mesh(multi_pod=multi_pod),
              M.MeshSpec((2, 2), ("data", "model")),
              M.MeshSpec((1, 4), ("data", "model"))]
    for ms in meshes:
        am = abstract_mesh(ms.shape, ms.axis_names)
        data = M.data_axes_of(ms)
        for arch, shape in CELLS:
            cell, jcell = SHAPES[shape], J.SHAPES[shape]
            if cell.kind == "train":
                continue
            cfg, jcfg = get_config(arch), J.get_config(arch)
            kvs = S.kv_shard_axes(cfg, cell, ms, data)
            for kv in {None, kvs}:
                got = S.cache_pspecs(cfg, cell, ms, data, kv_shard=kv)
                want = JS.cache_pspecs(jcfg, jcell, am, data, kv_shard=kv)
                assert [{k: tuple(sp[k]) for k in sp} for sp in got] == [
                    {k: tuple(sp[k]) for k in sp} for sp in want], (
                        arch, shape, ms.shape, kv)


def test_cache_blocks_and_the_decode_recut():
    """A rank's blocks of a whole cache rebuild it (``common.unshard``),
    and its prefill blocks re-cut to the decode layout on the rank are
    its decode blocks of the same cache, where the decode splits the
    full-attention positions over "model" (Hymba smoke() with one KV
    head) or over the data axis (a batch of 1)."""
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              n_kv_heads=1)
    for shape, batch in (((2, 2), 2), ((1, 4), 2), ((2, 2), 1)):
        ms = M.MeshSpec(shape, ("data", "model"))
        sizes = dict(zip(ms.axis_names, ms.shape))
        lay = S.serving_specs(cfg, ms, batch, 24)
        whole = [{k: torch.randn(tuple(t.shape), generator=gen)
                  for k, t in seg.items()}
                 for seg in S.cache_shapes(cfg, batch, 24, torch.float32)]
        blocks = {tag: [] for tag in ("prefill", "decode")}
        for r in range(ms.size):
            coords = dict(zip(ms.axis_names, divmod(r, shape[1])))
            for tag in blocks:
                blocks[tag].append(S.cache_blocks(whole, lay[tag], coords,
                                                  sizes))
            recut = S.recut_cache(blocks["prefill"][-1], lay["prefill"],
                                  lay["decode"], coords, sizes)
            for a, b in zip(recut, blocks["decode"][-1]):
                assert all(torch.equal(a[k], b[k]) for k in a)
        for tag, specs in (("prefill", lay["prefill"]),
                           ("decode", lay["decode"])):
            for i, seg in enumerate(whole):
                for k, t in seg.items():
                    back = common.unshard([b[i][k] for b in blocks[tag]],
                                          specs[i][k], ms.shape,
                                          ms.axis_names)
                    assert torch.equal(back, t), (shape, batch, tag, i, k)
        assert lay["kv_shard"] == (("data",) if batch == 1 else ("model",))
    with pytest.raises(ValueError, match="refine"):
        S.recut_cache([{"k": torch.zeros(2, 4)}], [{"k": ("model",)}],
                      [{"k": (None, "model")}], {"model": 0}, {"model": 2})


def test_build_cell_resolves_all_34_cells():
    ms = M.production_mesh()
    kinds = {"train": 3, "prefill": 3, "decode": 4}
    for arch, shape in CELLS:
        c = S.build_cell(get_config(arch), shape, ms)
        assert (c.arch, c.shape, c.kind) == (arch, shape, SHAPES[shape].kind)
        assert callable(c.fn) and len(c.args) == kinds[c.kind]
        assert all(t.device.type == "meta" for t in _leaves(c.args)
                   if isinstance(t, torch.Tensor))
        assert c.shards == S.shard_shapes(get_config(arch), shape, ms)
    long = S.build_cell(get_config("hymba-1.5b"), "long_500k", ms)
    assert long.kv_shard_axes == ("data",)
    assert S.build_cell(get_config("rwkv6-7b"), "decode_32k").shards is None
