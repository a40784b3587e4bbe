"""The port's roofline tooling, on the CPU: ``launch.op_analysis`` (the
loop-aware count of a call's dispatched operations), ``launch.roofline``
and ``launch.dryrun``, held against ``repro.launch.hlo_analysis`` /
``roofline`` where a reference exists and against the port's own code
where none does.

Against the reference's analysis of the same function: a matmul, a
batched einsum, a loop of 7 matmuls, the bytes of an elementwise
function at two sizes, an all-reduce on a fake process group of 8 (the
figure tests/test_roofline.py holds the reference to on 8 fake
devices), and the dense and
Hymba ``smoke()`` forwards' matmul FLOPs against the reference's jitted
``loss_fn``: exactly, less the terms the reference computes by design
(the causal chunks its rectangle schedule computes and masks, the Mamba
mixer's ``bsdn,bsn->bsd`` contraction, which the port's scan kernel
does), and within 2% of its triangular schedule.  Against the
reference's figures: ``model_flops_for`` and ``active_params`` over the
34 cells.  Against the port's own code: the loop-aware count equal to
the count of every loop body, FLOPs, bytes and kernel calls, on
``smoke()`` train (per-layer checkpointing, two microbatches), prefill
and decode cells of each family and on h2o-danube-1.8b's decode_32k in
full; the count on meta tensors (each signature's meta kernel run
once) equal to the count on real CPU tensors, peak memory included, on
dense and Hymba ``smoke()`` train, prefill and decode steps;
``ssm_scan``'s calls a Hymba prefill and train step; ``run_cell``
on 16x1 and 32x1, and three serving cells on 16x16 (Mamba by channel,
RWKV by head, long_500k's positions over the data axis); at 16x16 the
decode of nemotron-4-340b and of hymba-1.5b gathering no attention leaf,
their all-gather column against the same count with those leaves
gathered whole; the roofline terms against the H100 peaks.  Exact
throughout except the 2% band: these are integer counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.configs as J  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import (SHAPES, ShapeCell,  # noqa: E402
                                 active_params, get_config, list_archs)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import parallel  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

META = torch.device("meta")
CELLS = [(a, s) for a in list_archs()
         for s in S.runnable_shapes(get_config(a))]
# one smoke() config of each family
FAMILIES = ["h2o-danube-1.8b", "granite-moe-1b-a400m", "rwkv6-7b",
            "whisper-medium", "hymba-1.5b", "pixtral-12b"]


@pytest.fixture(scope="module", autouse=True)
def no_fake_group_left():
    """The fake default group some tests make, destroyed afterwards: the
    next test module in this process may start a real one."""
    yield
    OA.close_fake_groups()


def _hlo(f, *shapes):
    return H.analyze_text(jax.jit(f).lower(*shapes).compile().as_text())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Against the reference's analysis of the same function
# ---------------------------------------------------------------------------


def test_matmul_flops_equal_reference():
    want = _hlo(lambda a, b: a @ b,
                jax.ShapeDtypeStruct((256, 512), jnp.float32),
                jax.ShapeDtypeStruct((512, 128), jnp.float32)).dot_flops
    got = OA.count(lambda a, b: a @ b, _meta(256, 512), _meta(512, 128))
    assert got.dot_flops == 2 * 256 * 512 * 128 == want
    assert got.dot_by_dtype == {"fp32": got.dot_flops}


def test_batched_einsum_flops_equal_reference():
    f = lambda a, b: jnp.einsum("bij,bjk->bik", a, b)
    want = _hlo(f, jax.ShapeDtypeStruct((4, 32, 64), jnp.float32),
                jax.ShapeDtypeStruct((4, 64, 16), jnp.float32)).dot_flops
    got = OA.count(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                   _meta(4, 32, 64, dtype=torch.bfloat16),
                   _meta(4, 64, 16, dtype=torch.bfloat16))
    assert got.dot_flops == 2 * 4 * 32 * 64 * 16 == want
    assert got.dot_by_dtype == {"bf16": got.dot_flops}


def test_loop_of_seven_matmuls_counts_seven_times():
    def jf(ws, x):
        y, _ = jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)
        return jnp.sum(y)

    def f(ws, x):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x.sum()
    want = _hlo(jf, jax.ShapeDtypeStruct((7, 64, 64), jnp.float32),
                jax.ShapeDtypeStruct((8, 64), jnp.float32))
    got = OA.count(f, _meta(7, 64, 64), _meta(8, 64))
    assert got.dot_flops == 7 * 2 * 8 * 64 * 64 == want.dot_flops
    assert not got.warnings and not want.warnings


def test_bytes_scale_with_tensor_size():
    f = lambda a: torch.tanh(a) * 2 + 1
    small, big = (OA.count(f, _meta(n, n)).bytes for n in (256, 1024))
    assert 10 <= big / small <= 22          # the reference's band
    # each of three ops writes its (n, n) f32 output once; the input and
    # the two intermediates are each read once
    assert small == 6 * 256 * 256 * 4


def test_all_reduce_counts_twice_its_tensor():
    group = OA.fake_group(8)
    got = OA.count(lambda x: torch.distributed.all_reduce(x, group=group),
                   _meta(1, 1024))
    # the figure tests/test_roofline.py holds the reference to: psum of a
    # (1, 1024) f32 shard on 8 fake devices, 2 x 4096 B
    assert got.coll_by_op == {"all-reduce": 2 * 4096}
    assert got.coll_bytes == 2 * 4096


def _ref_loss_dots(arch: str, b: int, s: int, triangular: bool,
                   **cut) -> float:
    jcfg = dataclasses.replace(J.get_config(arch, smoke=True), **cut)
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    with jops.kernel_mode("ref"):
        return _hlo(lambda p, x: JT.loss_fn(p, x, jcfg,
                                            triangular=triangular),
                    JS.param_shapes(jcfg), batch).dot_flops


def _port_loss_dots(cfg, b: int, s: int) -> int:
    def f(params, batch):
        with torch.no_grad():
            T.loss_fn(params, batch, cfg, device=META)
    return OA.count(f, S.param_shapes(cfg),
                    {"tokens": _meta(b, s, dtype=torch.int32)}).dot_flops


def _masked_pairs_flops(cfg, b: int, s: int) -> int:
    """The matmul FLOPs of the causal chunk pairs the reference's default
    (rectangle) schedule computes and masks in every full-attention
    layer, which the port's schedule skips: two einsums a pair."""
    total = s + cfg.meta_tokens
    c = T.attention.div_chunk(total, cfg.scan_chunk)
    n = total // c
    full = sum(seg.size for seg in T.segments(cfg) if seg.kind == "full")
    pair = 2 * (2 * b * cfg.n_heads * c * c * cfg.head_dim)
    return full * (n * n - n * (n + 1) // 2) * pair


@pytest.mark.parametrize("arch", ["gemma3-27b", "hymba-1.5b"])
def test_forward_dot_flops_against_reference(arch):
    """The smoke() loss forward's matmul FLOPs (gemma3: SWA and full
    layers; Hymba: with Mamba mixers) against the reference's jitted
    ``loss_fn``: less, by exactly the masked chunk pairs and Hymba's Mamba
    contraction ``bsdn,bsn->bsd`` (the port's scan kernel does it); within
    2% of the reference's count less the masked pairs."""
    b, s = 2, 64
    # Hymba cut to a full layer and a SWA one (compile time)
    cut = dict(n_layers=2, global_layers=(0,)) if arch == "hymba-1.5b" \
        else {}
    cfg = dataclasses.replace(get_config(arch, smoke=True), **cut)
    got = _port_loss_dots(cfg, b, s)
    ref = _ref_loss_dots(arch, b, s, False, **cut)
    masked = _masked_pairs_flops(cfg, b, s)
    mamba_y = (2 * b * (s + cfg.meta_tokens) * cfg.q_dim * cfg.ssm_state
               * cfg.n_layers if cfg.family == "hybrid" else 0)
    assert masked > 0
    assert ref - got == masked + mamba_y
    assert abs(got - (ref - masked)) <= 0.02 * (ref - masked)


# ---------------------------------------------------------------------------
# Against the reference's own figures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), J.get_config(arch)
    assert active_params(cfg) == J.active_params(jcfg)
    assert R.model_flops_for(cfg, shape) == JR.model_flops_for(jcfg, shape)


# ---------------------------------------------------------------------------
# Against the port's own code
# ---------------------------------------------------------------------------


def _small_cell(cfg, kind: str, b: int, s: int):
    """A step of ``kind`` and its meta arguments at (b, s), as
    ``specs.build_cell`` builds a cell's."""
    params = S.param_shapes(cfg)
    cell = ShapeCell("small", s, b, kind)
    if kind == "train":
        return (step_lib.make_train_step(cfg, device=META),
                (params, S.opt_shapes(cfg), S.batch_specs(cfg, cell)))
    cache = S.cache_shapes(cfg, b, s)
    if kind == "prefill":
        return (step_lib.make_prefill_step(cfg, device=META),
                (params, S.batch_specs(cfg, cell), cache))
    last = (cfg.decoder_len if cfg.enc_dec else s) - 1
    return (step_lib.make_serve_step(cfg, device=META),
            (params, _meta(b, 1, dtype=torch.int32), last, cache))


def _both(cfg, kind, b, s):
    counts = []
    for loop_aware in (True, False):
        fn, args = _small_cell(cfg, kind, b, s)
        counts.append(OA.count(fn, *args, loop_aware=loop_aware))
    return counts


def _same(a, b):
    for key in ("flops", "dot_flops", "dot_by_dtype", "bytes", "coll_bytes",
                "kernels", "n_ops"):
        assert getattr(a, key) == getattr(b, key), key


@pytest.mark.parametrize("arch", FAMILIES)
def test_loop_aware_count_equals_unrolled(arch):
    """Train under per-layer checkpointing (the backward's recompute and
    the gradient sums between bodies; h2o-danube in two microbatches and
    a run of 4 layers; Hymba with 3 KV chunks a query chunk), prefill and
    decode: the count that runs three bodies a loop (one without
    autograd) equals the count of every body."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat="full")
    if arch == "h2o-danube-1.8b":   # a run of 4 layers, two microbatches
        cfg = dataclasses.replace(cfg, n_layers=4, microbatch=2)
    # Hymba: 3 KV chunks of 16 (8 meta tokens ahead), a middle body
    s = 40 if cfg.family == "hybrid" else 32
    for kind in ("train", "prefill", "decode"):
        fast, slow = _both(cfg, kind, 2, s)
        _same(fast, slow)
        assert fast.flops_once <= slow.flops_once
        if cfg.family == "hybrid":
            layers = cfg.n_layers
            want = {"train": {"ssm_scan": 2 * layers,
                              "ssm_scan_bwd": layers}}.get(
                kind, {"ssm_scan": layers})
            assert fast.kernel_calls == want


def _on_cpu(tree, gen):
    """Real CPU tensors like the meta ones in ``tree``: floats normal,
    integers (tokens, positions) zero."""
    def real(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            return torch.randn(tuple(t.shape), generator=gen).to(t.dtype)
        return torch.zeros(tuple(t.shape), dtype=t.dtype)
    return torch.utils._pytree.tree_map(real, tree)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "hymba-1.5b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_count_equals_count_on_real_tensors(arch, kind):
    """On meta tensors the counter runs an operation's meta kernel once a
    signature and reuses its output layout; on real CPU tensors it runs
    every operation.  Both counts of one smoke() step are equal, peak
    memory included."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat="full")
    meta_fn, args = _small_cell(cfg, kind, 2, 24)
    on_meta = OA.count(meta_fn, *args)
    make = {"train": step_lib.make_train_step,
            "prefill": step_lib.make_prefill_step,
            "decode": step_lib.make_serve_step}[kind]
    gen = torch.Generator().manual_seed(0)
    on_cpu = OA.count(make(cfg, device="cpu"), *_on_cpu(args, gen))
    _same(on_meta, on_cpu)
    assert on_meta.peak_bytes == on_cpu.peak_bytes
    assert on_meta.kernel_calls == on_cpu.kernel_calls


def test_ssm_scan_calls_a_layer():
    """One ``ssm_scan`` a Mamba mixer in a Hymba smoke prefill; in a train
    step two a layer (the forward and the checkpointed layer's
    recompute) and one ``ssm_scan_bwd``, each recorded with its work."""
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              remat="full")
    fn, args = _small_cell(cfg, "prefill", 2, 24)
    pre = OA.count(fn, *args)
    assert pre.kernel_calls == {"ssm_scan": cfg.n_layers}
    work = R.ssm_scan_work(2, 24 + cfg.meta_tokens, cfg.q_dim,
                           cfg.ssm_state, False)
    assert pre.kernels["ssm_scan"]["bytes"] == cfg.n_layers * work.nbytes
    fn, args = _small_cell(cfg, "train", 2, 24)
    tr = OA.count(fn, *args)
    assert tr.kernel_calls == {"ssm_scan": 2 * cfg.n_layers,
                               "ssm_scan_bwd": cfg.n_layers}


def test_full_decode_cell_loop_aware_equals_unrolled():
    """h2o-danube-1.8b's decode_32k at full width, per rank of 16x1: its
    24 layers and 32 cache chunks each run, against one body each."""
    rc = dryrun.rank_cell("h2o-danube-1.8b", "decode_32k", "16x1")
    fast = OA.count(rc.fn, *rc.args)
    rc = dryrun.rank_cell("h2o-danube-1.8b", "decode_32k", "16x1")
    slow = OA.count(rc.fn, *rc.args, loop_aware=False)
    _same(fast, slow)


@pytest.mark.parametrize("mesh", ["16x1", "32x1"])
def test_run_cell_each_kind(mesh):
    d = int(mesh.split("x")[0])
    for arch, shape in (("h2o-danube-1.8b", "train_4k"),
                        ("h2o-danube-1.8b", "prefill_32k"),
                        ("h2o-danube-1.8b", "decode_32k"),
                        ("gemma3-27b", "long_500k")):
        rec = dryrun.run_cell(arch, shape, mesh, verbose=False)
        cell = SHAPES[shape]
        assert rec["status"] == "ok" and rec["chips"] == d
        for key in ("flops_per_dev", "dot_flops_per_dev", "bytes_per_dev",
                    "compute_s", "memory_s", "model_flops", "useful_ratio"):
            assert rec[key] > 0, key
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        assert rec["bytes_per_device"]["peak"] \
            >= rec["bytes_per_device"]["argument"] > 0
        if cell.kind == "train":            # the gradients' all-reduce
            assert set(rec["coll_by_op"]) == {"all-reduce"}
            assert rec["collective_s"] > 0
            assert rec["shards"]["batch"]["tokens"] == (
                cell.global_batch // d, cell.seq_len)
        elif shape == "long_500k":   # full-attention caches split by position
            assert set(rec["coll_by_op"]) == {"all-reduce"}
            kinds = [seg.kind for seg in T.segments(get_config(arch))]
            k = rec["shards"]["cache"][kinds.index("full")]["k"]
            assert k[2] == cell.seq_len // d
        else:
            assert rec["coll_by_op"] == {}


SERVING_16X16 = (("hymba-1.5b", "decode_32k"), ("rwkv6-7b", "prefill_32k"),
                 ("gemma3-27b", "long_500k"))


@pytest.mark.parametrize("arch,shape", SERVING_16X16,
                         ids=[f"{a}-{s}" for a, s in SERVING_16X16])
def test_serving_cells_counted_over_the_model_axis(arch, shape):
    """A serving cell of the production 16 x 16 mesh counts as one rank
    of ``greedy_generate(plan=)``: the reference's shards, its cache
    blocks, and collectives over the fake model and data groups."""
    rec = dryrun.run_cell(arch, shape, "16x16", verbose=False)
    cfg, cell = get_config(arch), SHAPES[shape]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["collective_s"] > 0 and rec["coll_by_op"], rec["coll_by_op"]
    assert rec["params_per_rank"] == S.held_elements(
        S.state_shard_shapes(cfg, dryrun.parse_mesh("16x16"))["params"])
    cache = rec["shards"]["cache"]
    if arch == "hymba-1.5b":        # Mamba by channel, positions over model
        assert rec["mamba_leaves"] == 9
        assert rec["kernel_calls"] == {"ssm_scan": cfg.n_layers}
        kinds = [seg.kind for seg in T.segments(cfg)]
        full = cache[kinds.index("full")]
        assert full["k"][1:4] == (cell.global_batch // 16,
                                  (cell.seq_len + cfg.meta_tokens) // 16,
                                  cfg.n_kv_heads)
        assert full["m_h"][2] == cfg.q_dim // 16
    elif arch == "rwkv6-7b":        # the time mix by head
        assert rec["rwkv_leaves"] == 9
        assert cache[0]["s"][1:3] == (cell.global_batch // 16,
                                      cfg.d_model // cfg.rwkv_head_dim // 16)
    else:                           # long_500k: positions over the data axis
        kinds = [seg.kind for seg in T.segments(cfg)]
        full = cache[kinds.index("full")]
        assert full["k"][1:4] == (1, cell.seq_len // 16,
                                  cfg.n_kv_heads // 16)


RECURRENT_16X16 = (("hymba-1.5b", "train_4k"), ("rwkv6-7b", "train_4k"),
                   ("rwkv6-7b", "decode_32k"))


@pytest.mark.parametrize("arch,shape", RECURRENT_16X16,
                         ids=[f"{a}-{s}" for a, s in RECURRENT_16X16])
def test_recurrent_blocks_gather_nothing_over_the_model_axis(arch, shape):
    """16x16: a Hymba training rank gathers over "model" only its two
    gammas, its Mamba by channel; an RWKV rank, training or decoding,
    gathers nothing over "model": its time mix by head, its channel mix
    by ``ff`` with ``w_cr`` by column.  RWKV's train_4k rank then fits
    an H100's 80 GB (189.7 GiB of predicted peak when it gathered its
    9 leaves), and its decode no longer gathers ``w_cr``: the
    all-gather column stays below one layer's whole ``w_cr``."""
    cell = dryrun.rank_cell(arch, shape, "16x16")
    plan = cell.plan
    over = sorted("/".join(p) for p in plan.gathered()
                  if "model" in plan.axes_of(p))
    rec = dryrun.run_cell(arch, shape, "16x16", verbose=False)
    cfg = get_config(arch)
    assert rec["status"] == "ok"
    if arch == "hymba-1.5b":
        assert over == ["layers/attn_gamma", "layers/mamba_gamma"]
        assert rec["mamba_leaves"] == 9
        assert rec["kernel_calls"]["ssm_scan_bwd"] > 0
        return
    assert over == [] and rec["rwkv_leaves"] == 9
    if shape == "train_4k":
        assert rec["bytes_per_device"]["peak"] < 80e9
    else:
        w_cr = cfg.d_model * cfg.d_model * cell.dtype.itemsize
        assert rec["coll_by_op"]["all-gather"] < w_cr


def _gathering_the_attention(plan) -> None:
    """``plan`` with its attention blocks gathered whole over "model"
    where they are used, as they were wherever the column blocks cut a
    head before those blocks ran where they lie."""
    attn = {p for b in parallel.ATTN_BLOCKS for p in plan.keep
            if p[:len(b)] == b}
    plan.tp_blocks = plan.tp_blocks - set(parallel.ATTN_BLOCKS)
    plan.keep, plan.local = plan.keep - attn, plan.local - attn


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "hymba-1.5b"])
def test_ragged_attention_leaves_the_all_gather_column(arch):
    """16x16 decode_32k, where the KV heads do not divide 16 (nemotron's
    8, Hymba's 5): no attention leaf is gathered, and the all-gather
    column falls by the four leaves' whole bytes a layer, less the one
    (q|k|v) message of the token's projections a layer gathered in their
    place."""
    new = dryrun.rank_cell(arch, "decode_32k", "16x16")
    old = dryrun.rank_cell(arch, "decode_32k", "16x16")
    _gathering_the_attention(old.plan)
    assert not [p for p in new.plan.gathered() if "attn" in p]
    assert len(old.plan.gathered()) == len(new.plan.gathered()) + 4
    assert new.plan.counts()["ragged_attn"] == 1
    got, was = OA.count(new.fn, *new.args), OA.count(old.fn, *old.args)
    cfg = get_config(arch)
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    b = new.shards["tokens"][0]
    leaves = (2 * d * q + 2 * d * kv) * new.dtype.itemsize
    message = b * (q + 2 * kv) * new.dtype.itemsize
    assert was.coll_by_op["all-gather"] - got.coll_by_op["all-gather"] \
        == cfg.n_layers * (leaves - message)


def test_roofline_terms_against_peaks():
    got = OA.count(lambda a, b: (a @ b).exp(),
                   _meta(512, 256, dtype=torch.bfloat16),
                   _meta(256, 128, dtype=torch.bfloat16))
    r = R.analyze(got, n_ranks=1, model_flops=2 * 512 * 256 * 128)
    dots = 2 * 512 * 256 * 128
    assert r.dot_flops == dots and r.flops == dots + 512 * 128
    assert r.compute_s == dots / 989.4e12 + 512 * 128 / 67e12
    assert r.memory_s == got.bytes / 3.35e12
    assert r.collective_s == 0 and r.useful_ratio == dots / r.flops
    assert r.bottleneck == max(("compute", r.compute_s),
                               ("memory", r.memory_s), key=lambda x: x[1])[0]
    # a kernel call: its bytes in memory, its slowest unit in compute
    k = {"ssm_scan": {"calls": 1, "bytes": 0,
                      "ops": {"fp32": 67e9, "sfu": R.SFU[0] * 2e-3}}}
    t = OA.CostTotals(flops=int(67e9 + R.SFU[0] * 2e-3),
                      kernel_flops=int(67e9 + R.SFU[0] * 2e-3), kernels=k)
    assert R.compute_seconds(t) == pytest.approx(2e-3, rel=1e-12)
    assert R.link_bytes_per_s(8) == 450e9 and R.link_bytes_per_s(16) == 50e9
    assert R.ssm_bound(4, 2176, 1600, 16, False)[0] == pytest.approx(
        0.053284, abs=5e-7)
    assert R.ssm_bwd_bound(2, 1152, 1600, 16, False)[0] == pytest.approx(
        0.024508, abs=5e-7)


# one rank's parameter elements on the reference's 16 x 16 mesh, by the
# reference's own param_pspecs on AbstractMesh((16, 16), ("data", "model"))
PER_RANK_16X16 = {"nemotron-4-340b": 10_887_488_640,
                  "command-r-35b": 708_157_952, "gemma3-27b": 605_524_496,
                  "h2o-danube-1.8b": 114_567_680}


def test_mesh_with_a_model_axis_is_refused():
    """The model axis is taken now: ``parse_mesh`` reads the production
    meshes and refuses only a malformed one, and each rank of 16 x 16
    holds the reference's shards (from the shard shapes: no 96-layer
    count runs here)."""
    assert dryrun.parse_mesh("16x16") == M.MeshSpec((16, 16),
                                                    ("data", "model"))
    assert dryrun.parse_mesh("2x16x16") == M.MeshSpec(
        (2, 16, 16), ("pod", "data", "model"))
    assert dryrun.parse_mesh("16x1") == M.MeshSpec((16,), ("data",))
    for bad in ("16x0", "ax16", "16", "1x2x3x4"):
        with pytest.raises(ValueError, match="DxM"):
            dryrun.parse_mesh(bad)
    spec = dryrun.parse_mesh("16x16")
    for arch, want in PER_RANK_16X16.items():
        st = S.state_shard_shapes(get_config(arch), spec)
        assert S.held_elements(st["params"]) == want, arch
