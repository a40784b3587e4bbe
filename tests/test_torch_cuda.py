"""The eight CUDA kernels against their plain versions, on the card.

Marked ``gpu``; run on a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Without a card every test skips (decided in the ``cuda`` fixture, never
at import).  Shapes are small and ragged, including k > C, inactive
(thr = -inf) and all-dead rows and pad lanes.  Tolerances: block_topk
bitwise; lb_scan rtol 1e-5 (16 non-negative terms summed in another
order); isax_summarize bitwise (PAA and symbols: both evaluate the same
float64 operations in the same order); fused_panel_topk live counts exact and
squared distances within 1e-5 * (|q|^2 + max |x|^2), the cancellation
error of the expanded form summed in another order; batch_l2 within
1e-5 * (|q|^2 + |x|^2) per pair; dtw_band_panel bitwise; ssm_scan
rtol / atol 1e-4, the bar of tests/test_kernels.py's scan test (the
kernel may contract a * h + b into an FMA, and its expf and the plain
exp differ by an ulp or two); ssm_scan's training launch bitwise the
plain launch in y and h_last, its checkpoints 1e-4, and ssm_scan_bwd
1e-4 of each gradient's largest magnitude against the float64 plain
reverse scan, two launches bitwise; the Mamba mixer and Hymba serving on the
card against the plain oracle and the CPU 1e-3 and 2e-3, the bars of
tests/test_kernels.py's mixer test and tests/test_models.py's
prefill/decode test; a dense, a MoE, the RWKV and the Whisper smoke()
forward and train step on the card against the CPU 2e-3 (logits) and
1e-4 relative (loss, gradient norm, fp32 sums in another order).  The on-disk index on the card: the block cache
with a reader slowed on purpose and a block evicted under a queued read
(bitwise), the loader's pinned staging (bitwise), the pipeline's file
against save_index(core.build(...)) (sha256), z-norm's independence of
the call (bitwise) and the cached walk against the CPU's (ids equal,
squared distances rtol 1e-5 / atol 1e-4).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro_torch import interop
from repro_torch.core import dtw, isax, paris
from repro_torch.core.index import build
from repro_torch.core.search import search_block_major
from repro_torch.kernels.batch_l2 import batch_l2
from repro_torch.data import random_walk
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_topk import block_topk
from repro_torch.kernels.dtw_band import dtw_band_panel
from repro_torch.kernels.fused_refine import fused_panel_topk
from repro_torch.kernels.isax_summarize import isax_summarize
from repro_torch.kernels.lb_scan import lb_scan
from repro_torch.kernels.ssm_scan import (ssm_scan,
                                          ssm_scan_with_checkpoints)
from repro_torch.kernels.ssm_scan_bwd import ssm_scan_bwd

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shape", [(1, 64), (77, 128), (1000, 256)])
def test_isax_summarize(cuda, normalize, shape):
    x = torch.from_numpy(random_walk(*shape, seed=3)).to(cuda)
    if not normalize:
        x = isax.znorm(x)
    pk, sk = isax_summarize(x, w=16, card=256, normalize=normalize)
    pr, sr = ref.isax_summarize_ref(x, w=16, card=256, normalize=normalize)
    assert torch.equal(pk, pr) and torch.equal(sk, sr)
    # and the plain version on the CPU gives the same bits
    pc, sc = ref.isax_summarize_ref(x.cpu(), w=16, card=256,
                                    normalize=normalize)
    assert torch.equal(pc, pr.cpu()) and torch.equal(sc, sr.cpu())


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shape,w", [((77, 48), 16), ((33, 40), 8),
                                     ((31, 256), 16), ((13, 60), 4),
                                     ((7, 50), 10), ((5, 128), 64),
                                     ((3, 64), 1)])
def test_isax_summarize_ragged_windows(cuda, normalize, shape, w):
    """Windows of 1-64 points (4-byte loads where n / w is not a multiple
    of 4), w not a power of two, w > 32 and odd series counts, bitwise in
    both modes."""
    x = torch.from_numpy(random_walk(*shape, seed=w)).to(cuda)
    if not normalize:
        x = isax.znorm(x)
    pk, sk = isax_summarize(x, w=w, card=256, normalize=normalize)
    pr, sr = ref.isax_summarize_ref(x, w=w, card=256, normalize=normalize)
    assert torch.equal(pk, pr) and torch.equal(sk, sr)
    # a start 4 bytes past 16-byte alignment takes the 4-byte loads
    xu = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    xu.copy_(x)
    pk, sk = isax_summarize(xu, w=w, card=256, normalize=normalize)
    assert torch.equal(pk, pr) and torch.equal(sk, sr)


def _lb_planes(w, n_items, seed, device):
    """Random (w, N) region bounds lo <= hi with +-SENTINEL edges in them
    (the extreme symbols' regions), float32 on ``device``."""
    rng = np.random.default_rng(seed)
    lo = rng.standard_normal((w, n_items)).astype(np.float32)
    hi = lo + rng.random((w, n_items)).astype(np.float32)
    lo[rng.random((w, n_items)) < 0.1] = -isax.SENTINEL
    hi[rng.random((w, n_items)) < 0.1] = isax.SENTINEL
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device))


def _lb_close(q, lo, hi, n=256, chunk=8192):
    """The kernel against ref.lb_scan_ref within relative 1e-5, over every
    column, the plain version taken a column chunk at a time."""
    got = lb_scan(q, lo, hi, n=n)
    assert got.shape == (q.shape[0], lo.shape[1])
    for s in range(0, lo.shape[1], chunk):
        want = ref.lb_scan_ref(q, lo[:, s:s + chunk], hi[:, s:s + chunk], n=n)
        assert bool(((got[:, s:s + chunk] - want).abs()
                     <= 1e-5 * want.abs()).all()), (tuple(q.shape), s)


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    u = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    u = u.view(t.shape)
    u.copy_(t)
    assert u.data_ptr() % 16 == 4
    return u


@pytest.mark.parametrize("w", [1, 3, 8, 16, 32])
@pytest.mark.parametrize("qn", [1, 6, 13, 100, 1000])
@pytest.mark.parametrize("n_items", [1, 77, 1000, 4096, 4097])
def test_lb_scan(cuda, w, qn, n_items):
    """Every segment count the kernel takes, Q up to 1,000, ragged and
    16-byte-aligned N, region bounds holding +-SENTINEL, and the same
    inputs from a start 4 bytes past 16-byte alignment (4-byte loads)."""
    g = torch.Generator(device=cuda).manual_seed(w * 7919 + qn * 31 + n_items)
    q = torch.randn((qn, w), generator=g, device=cuda) * 2
    lo, hi = _lb_planes(w, n_items, seed=w + qn + n_items, device=cuda)
    _lb_close(q, lo, hi)
    _lb_close(_unaligned(q), _unaligned(lo), _unaligned(hi))


@pytest.mark.parametrize("qn", [10, 100])
@pytest.mark.parametrize("n_items", [1, 77, 9766])
def test_lb_scan_on_dtw_sentinel_planes(cuda, qn, n_items):
    """DTW's two passes as engine.interval_planar_lb builds them: u against
    (lo, +SENTINEL plane) and l against (-SENTINEL plane, hi)."""
    lo, hi = _lb_planes(16, n_items, seed=qn + n_items, device=cuda)
    plane = torch.full(lo.shape, isax.SENTINEL, dtype=torch.float32,
                       device=cuda)
    g = torch.Generator(device=cuda).manual_seed(qn + n_items)
    l_paa = torch.randn((qn, 16), generator=g, device=cuda)
    u_paa = l_paa + torch.rand((qn, 16), generator=g, device=cuda)
    _lb_close(u_paa, lo, plane)
    _lb_close(l_paa, -plane, hi)


@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("qn", [13, 100])
@pytest.mark.parametrize("side", [0, 1])
def test_lb_scan_either_side_of_the_layout_threshold(cuda, w, qn, side):
    """The launcher takes 256-column slices once N spans more than 8 of
    them an SM, and 128-column slices with the queries split over blocks
    below: N at and just above that threshold."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_items = 2048 * sms + side
    g = torch.Generator(device=cuda).manual_seed(n_items + qn)
    q = torch.randn((qn, w), generator=g, device=cuda)
    lo, hi = _lb_planes(w, n_items, seed=qn + side, device=cuda)
    _lb_close(q, lo, hi, chunk=1 << 15)


@pytest.mark.parametrize("w", [3, 16])
@pytest.mark.parametrize("qn", [13, 100])
@pytest.mark.parametrize("n_items", [77, 4097])
@pytest.mark.parametrize("where", ["everywhere", "one_column"])
def test_lb_scan_inverted_intervals(cuda, w, qn, n_items, where):
    """Bounds with lo > hi (no region of the index has them, but the
    function is defined there): independent lo and hi everywhere, or one
    inverted column among ordered ones, so one slice of the kernel takes
    the literal form of the term and the others the clamp form."""
    g = torch.Generator(device=cuda).manual_seed(w + qn + n_items)
    q = torch.randn((qn, w), generator=g, device=cuda)
    lo, hi = _lb_planes(w, n_items, seed=w * qn + n_items, device=cuda)
    if where == "everywhere":
        hi = torch.randn((w, n_items), generator=g, device=cuda)
    else:
        j = n_items // 2
        lo[:, j], hi[:, j] = hi[:, j] + 0.5, lo[:, j] - 0.5
    assert bool((lo > hi).any())
    _lb_close(q, lo, hi)


def test_lb_scan_refuses_more_than_32_segments(cuda):
    q = torch.zeros((2, 33), device=cuda)
    lo = torch.zeros((33, 8), device=cuda)
    with pytest.raises(RuntimeError, match="lb_scan: CUDA error"):
        lb_scan(q, lo, lo, n=66)


@pytest.mark.parametrize("qn", [1, 6, 13])
@pytest.mark.parametrize("c", [20, 37, 300, 1024])
@pytest.mark.parametrize("k", [1, 5, 32, 1030])
def test_block_topk_bitwise(cuda, qn, c, k):
    rng = np.random.default_rng(qn * 97 + c + k)
    d = rng.integers(0, 6, (qn, c)).astype(np.float32)          # many ties
    ids = np.stack([rng.permutation(10 * c)[:c] for _ in range(qn)]
                   ).astype(np.int32)
    pad = rng.random((qn, c)) < 0.2
    ids[pad], d[pad] = -1, ref.INF
    if qn > 1:
        ids[1], d[1] = -1, ref.INF
    d, ids = torch.from_numpy(d).to(cuda), torch.from_numpy(ids).to(cuda)
    gd, gi = block_topk(d, ids, k=k)
    wd, wi = ref.block_topk_ref(d, ids, k)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)


def _same_bits(got, want):
    (gd, gi), (wd, wi) = got, want
    return (torch.equal(gd.view(torch.int32), wd.view(torch.int32))
            and torch.equal(gi, wi))


@pytest.mark.parametrize("qn,c", [(100, 1024), (100, 4096), (10, 2048)])
@pytest.mark.parametrize("k", [1, 10])
def test_block_topk_at_the_walk_shapes(cuda, qn, c, k):
    """The stage-A seed (100, 1024), the flat and query-major panels
    (100, 4096) and DTW's (10, 2048), with real-looking distances (sums
    of squares, so few exact ties) and the walks' masked lanes."""
    g = torch.Generator(device=cuda).manual_seed(qn + c + k)
    d = torch.randn((qn, c), generator=g, device=cuda).square() * 40.0
    ids = torch.argsort(torch.rand((qn, c), generator=g, device=cuda),
                        dim=1).to(torch.int32)
    dead = torch.rand((qn, c), generator=g, device=cuda) < 0.3
    d = torch.where(dead, ref.INF, d)
    ids = torch.where(dead, -1, ids)
    assert _same_bits(block_topk(d, ids, k=k), ref.block_topk_ref(d, ids, k))


@pytest.mark.parametrize("qn", [1, 10, 100])
@pytest.mark.parametrize("c", [37, 4096])
@pytest.mark.parametrize("k", [1, 2, 10, 16, 17, 32, 33, 1030])
def test_block_topk_signed_zero_and_negative_ties(cuda, qn, c, k):
    """-0.0 and +0.0 tie and go by id with their own sign bits; negative
    distances; k at the k = 1 and k <= 32 kernels' largest k and one above
    each, and past C."""
    d, ids = ref.signed_panel(qn, c, seed=qn * 7 + c + k, device=cuda)
    assert _same_bits(block_topk(d, ids, k=k), ref.block_topk_ref(d, ids, k))


@pytest.mark.parametrize("c", [4097, 9000])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_block_topk_rows_longer_than_a_block(cuda, c, k):
    """Rows past 4,096 lanes take the round kernel at every k."""
    d, ids = ref.signed_panel(10, c, seed=c + k, device=cuda)
    assert _same_bits(block_topk(d, ids, k=k), ref.block_topk_ref(d, ids, k))


@pytest.mark.parametrize("c", [300, 1024, 4096])
@pytest.mark.parametrize("k", [1, 10, 32, 33])
def test_block_topk_ids_up_to_int32_max(cuda, c, k):
    """Ids at and above 2^30, up to INT32_MAX - 1: the order keys hold
    the whole id."""
    top = int(torch.iinfo(torch.int32).max)
    d, ids = ref.signed_panel(10, c, seed=c * 3 + k, device=cuda,
                              id_offset=top - 4 * c)
    assert int(ids.max()) >= 2 ** 30
    assert _same_bits(block_topk(d, ids, k=k), ref.block_topk_ref(d, ids, k))


def test_block_topk_all_pad_rows_and_k_past_c(cuda):
    d = torch.full((10, 300), ref.INF, device=cuda)
    ids = torch.full((10, 300), -1, dtype=torch.int32, device=cuda)
    for k in (1, 10, 32, 305):
        got = block_topk(d, ids, k=k)
        assert _same_bits(got, ref.block_topk_ref(d, ids, k))
        assert bool((got[1] == -1).all())


@pytest.mark.parametrize("qn", [1, 6, 13])
@pytest.mark.parametrize("c", [37, 300, 1024])
@pytest.mark.parametrize("k", [1, 5, 32, 1030])
def test_fused_panel_topk(cuda, qn, c, k):
    _check_fused(cuda, qn, c, k, n=128, seed=qn * 13 + c + k)


@pytest.mark.parametrize("qn", [1, 6, 13, 100])
@pytest.mark.parametrize("c", [37, 300, 1000, 1024])
@pytest.mark.parametrize("k", [1, 5, 32, 1030])
def test_fused_panel_topk_query_tiles_and_slices(cuda, qn, c, k):
    """Across the kernel's tiling: Q = 100 and Q not a multiple of the
    8-query tile, C not a multiple of the 64-lane slice, at the main
    path's length; inactive, all-dead and all-live rows and pad lanes."""
    _check_fused(cuda, qn, c, k, n=256)


@pytest.mark.parametrize("n", [1, 130, 300])
def test_fused_panel_topk_ragged_lengths(cuda, n):
    """Lengths that are no multiple of a float4, and one longer than a
    staged chunk of 256 points."""
    _check_fused(cuda, 13, 300, 10, n=n, w=1 if n == 1 else 10)


@pytest.mark.parametrize("c,k", [(2100, 10), (4096, 100)])
def test_fused_panel_topk_many_slices(cuda, c, k):
    """More than 32 slices of C (lanes hold several lists in the merge),
    and merge lists too large for all 8 warps' shared memory at once."""
    _check_fused(cuda, 13, c, k, n=128)


def test_fused_panel_topk_all_dead(cuda):
    """A block with no live pair: every row (INF, -1), every count 0,
    and the next launch unaffected."""
    for thr_val in (0.0, float("-inf")):
        _check_fused(cuda, 13, 300, 5, n=128, thr_all=thr_val)
    _check_fused(cuda, 13, 300, 5, n=128)


@pytest.mark.parametrize("c,k", [(1000, 5), (1024, 32)])
def test_fused_panel_topk_live_counts_over_query_noise(cuda, c, k):
    """Live counts exact over 300 draws of the query noise at Q = 100,
    where now and then a bound lands within a rounding of the threshold:
    the kernel and the plain version add the w MINDIST terms in one
    order."""
    for noise_seed in range(300):
        _check_fused(cuda, 100, c, k, n=256, noise_seed=noise_seed)


def _check_fused(cuda, qn, c, k, *, n, w=16, thr_all=None, seed=None,
                 noise_seed=None):
    rng = np.random.default_rng(qn * 13 + c + k + n if seed is None else seed)
    block = isax.znorm(torch.from_numpy(random_walk(c, n, seed=c)).to(cuda))
    ids = torch.from_numpy(rng.permutation(5 * c)[:c].astype(np.int32)).to(cuda)
    ids[-3:] = -1
    block[-3:] = 1.0e4
    _, _, bounds = isax.summarize(block, w=w, normalize=False)
    lo = bounds[..., 0].T.contiguous()
    hi = bounds[..., 1].T.contiguous()
    pick = torch.from_numpy(rng.integers(0, c - 3, qn)).to(cuda)
    g = (None if noise_seed is None
         else torch.Generator(device=cuda).manual_seed(noise_seed))
    q = block[pick] + 0.3 * torch.randn((qn, n), device=cuda, generator=g)
    q_paa = isax.paa(q, w)
    full = ref.batch_l2_ref(q, block)
    thr = torch.quantile(full[:, :-3], 0.3, dim=1)
    thr[0] = float("-inf")
    if qn > 2:
        thr[2] = 0.0
    if qn > 3:
        thr[3] = ref.INF
    if thr_all is not None:
        thr[:] = thr_all
    gd, gi, gn = fused_panel_topk(q, q_paa, block, lo, hi, ids, thr, k=k, n=n)
    wd, wi, wn = ref.fused_panel_topk_ref(q, q_paa, block, lo, hi, ids, thr,
                                          k=k, n=n)
    assert torch.equal(gn, wn)
    assert gn[0] == 0 and bool((gi[0] == -1).all())
    if thr_all is not None:
        assert bool((gn == 0).all()) and bool((gi == -1).all())
    xx = torch.where(ids >= 0, (block * block).sum(1), 0.0).amax()
    tol = 1e-5 * ((q * q).sum(1) + xx)[:, None]
    assert torch.equal(gi >= 0, wi >= 0)
    live = wi >= 0
    assert bool(((gd - wd).abs() <= tol)[live].all())
    assert bool((gd[~live] == ref.INF).all())
    # ids differ only at near ties of the plain distances
    diff = (gi != wi) & live
    if bool(diff.any()):
        qi, ri = torch.nonzero(diff, as_tuple=True)
        lane = {int(v): j for j, v in enumerate(ids.tolist()) if v >= 0}
        lanes = torch.tensor([lane[int(v)] for v in gi[qi, ri].tolist()],
                             device=cuda)
        assert bool(((full[qi, lanes] - wd[qi, ri]).abs() <= tol[qi, 0]).all())


@pytest.mark.parametrize("qn", [1, 6, 13, 100])
@pytest.mark.parametrize("n_items", [1, 77, 1000, 4096])
def test_batch_l2(cuda, qn, n_items):
    q = isax.znorm(torch.from_numpy(random_walk(qn, 256, seed=qn)).to(cuda))
    x = isax.znorm(torch.from_numpy(random_walk(n_items, 256,
                                                seed=n_items)).to(cuda))
    x[-1] = 1.0e4                                  # a RAW_PAD row
    got = batch_l2(q, x)
    want = ref.batch_l2_ref(q, x)
    tol = 1e-5 * ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :])
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("qn", [1, 13, 100, 129])
@pytest.mark.parametrize("n", [100, 129, 256])
def test_batch_l2_split_tf32_across_the_tiles(cuda, qn, n):
    """Q past one 128-row tile, lengths that leave a ragged 32-coordinate
    slice (and n % 4 != 0: 4-byte staging), N not a multiple of the
    32-series slice; a RAW_PAD row and queries equal to indexed rows
    (distance ~ 0, where the tolerance rests on |q|^2 + |x|^2 alone)."""
    q = isax.znorm(torch.from_numpy(random_walk(qn, n, seed=qn + n)).to(cuda))
    x = isax.znorm(torch.from_numpy(random_walk(1000, n, seed=n)).to(cuda))
    x[-1] = 1.0e4                                  # a RAW_PAD row
    x[: min(qn, 5)] = q[:5]                        # zero distances
    got = batch_l2(q, x)
    want = ref.batch_l2_ref(q, x)
    tol = 1e-5 * ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :])
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("r", [0, 3, 127])
@pytest.mark.parametrize("qn,m", [(1, 1), (3, 37), (7, 300)])
def test_dtw_band_panel_bitwise(cuda, gathered, r, qn, m):
    n = 128
    q = isax.znorm(torch.from_numpy(random_walk(qn, n, seed=m)).to(cuda))
    x = torch.from_numpy(random_walk(qn * m if gathered else m, n,
                                     seed=r + 7)).to(cuda)
    x = isax.znorm(x).reshape((qn, m, n) if gathered else (m, n))
    x[..., -1, :] = 1.0e4                          # a RAW_PAD row
    got = dtw_band_panel(q, x.contiguous(), r=r)
    want = ref.dtw_band_panel_ref(q, x, r=r)
    assert torch.equal(got, want)


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("r", [0, 12, 16, 17, 127])
@pytest.mark.parametrize("m", [1, 37, 300, 2049])
@pytest.mark.parametrize("n", [77, 256])
def test_dtw_band_panel_bitwise_across_the_variants(cuda, gathered, r, m, n):
    """Both sides of the register/shared-memory switch (r <= 16 in
    registers, r = 17 and 127 in shared memory), panels that are no
    multiple of the 128-pair block, and lengths that are (256) and are
    not (77) a multiple of the 32-point staged tile."""
    qn = 3
    q = isax.znorm(torch.from_numpy(random_walk(qn, n, seed=m + r)).to(cuda))
    x = torch.from_numpy(random_walk(qn * m if gathered else m, n,
                                     seed=m + 1)).to(cuda)
    x = isax.znorm(x).reshape((qn, m, n) if gathered else (m, n))
    x[..., -1, :] = 1.0e4                          # a RAW_PAD row
    got = dtw_band_panel(q, x.contiguous(), r=r)
    want = ref.dtw_band_panel_ref(q, x, r=r)
    assert torch.equal(got, want)


def test_search_on_the_card_matches_the_cpu(cuda):
    """The card's answers equal the CPU's.  Index arrays may differ where
    a PAA lies within float noise of a breakpoint (see test_isax_summarize),
    and lower bounds differ in the last bits, which can reorder tied
    blocks, so ids and distances are compared, not work counters."""
    raw = random_walk(5000, 256, seed=21)
    qs = random_walk(7, 256, seed=22)
    ops.reset_launch_counts()
    cpu_idx = build(raw, capacity=256, device="cpu")
    on_card = build(raw, capacity=256, device=cuda)
    carried = interop.block_index_from_arrays(
        interop.block_index_to_arrays(cpu_idx), n=256, w=16, card=256,
        capacity=256, n_real=5000, device=cuda)
    for k in (1, 10):
        want = search_block_major(cpu_idx, qs, k=k, device="cpu")
        for idx in (on_card, carried):
            got = search_block_major(idx, qs, k=k)
            assert torch.equal(got.idx.cpu(), want.idx)
            gs, ws = got.dist.cpu().double() ** 2, want.dist.double() ** 2
            assert bool(((gs - ws).abs() <= 1e-5 * 2 * 256).all())
    counts = ops.launch_counts()
    assert all(counts[name] > 0 for name in ("isax_summarize", "lb_scan",
                                             "block_topk", "fused_panel_topk")
               ), counts


def test_paris_and_dtw_on_the_card_match_the_cpu(cuda):
    """search_paris and search_dtw on the card against the same searches
    on the CPU, over one index carried to both: ids equal, squared
    distances within 1e-5 * 2n (ED; z-normed |x|^2 = n) and bitwise-DP
    DTW distances within 1e-5 relative (the queries are z-normed in
    another summation order)."""
    raw = random_walk(3000, 128, seed=23)
    qs = random_walk(5, 128, seed=24)
    cpu_idx = build(raw, capacity=128, device="cpu")
    on_card = interop.block_index_from_arrays(
        interop.block_index_to_arrays(cpu_idx), n=128, w=16, card=256,
        capacity=128, n_real=3000, device=cuda)
    ops.reset_launch_counts()
    for k in (1, 10):
        want = paris.search_paris(cpu_idx, qs, k=k, chunk=512, device="cpu")
        got = paris.search_paris(on_card, qs, k=k, chunk=512)
        assert torch.equal(got.idx.cpu(), want.idx)
        gs, ws = got.dist.cpu().double() ** 2, want.dist.double() ** 2
        assert bool(((gs - ws).abs() <= 1e-5 * 2 * 128).all())
        want = dtw.search_dtw(cpu_idx, qs, r=6, k=k, device="cpu")
        got = dtw.search_dtw(on_card, qs, r=6, k=k)
        assert torch.equal(got.idx.cpu(), want.idx)
        gs, ws = got.dist.cpu().double() ** 2, want.dist.double() ** 2
        assert bool(((gs - ws).abs() <= 1e-5 * ws + 1e-6).all())
    counts = ops.launch_counts()
    assert counts["batch_l2"] > 0 and counts["dtw_band_panel"] > 0, counts


def _ssm_inputs(cuda, b, s, d, n, seed, with_h0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *sh: torch.randn(sh, generator=g, device=cuda) * 0.5
    xc, dt = mk(b, s, d), mk(b, s, d).abs() * 0.4
    bm, cm = mk(b, s, n), mk(b, s, n)
    a = -mk(d, n).abs() - 0.1
    return xc, dt, bm, cm, a, (mk(b, d, n) if with_h0 else None)


@pytest.mark.parametrize("b,s,d,n", [(1, 16, 8, 4), (2, 32, 100, 16),
                                     (1, 64, 128, 8), (3, 45, 77, 32),
                                     (4, 300, 1600, 16), (4, 1, 1600, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan(cuda, b, s, d, n, with_h0):
    args = _ssm_inputs(cuda, b, s, d, n, seed=b * s + d + n,
                       with_h0=with_h0)
    ops.reset_launch_counts()
    y, h_last = ssm_scan(*args)
    assert ops.launch_counts()["ssm_scan"] == 1
    yr, hr = ref.ssm_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_last, hr, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 12, 33, 64])
@pytest.mark.parametrize("b,s,d", [(2, 45, 77), (1, 70, 128), (3, 1, 100),
                                   (4, 1, 1600)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_any_state_size(cuda, n, b, s, d, with_h0):
    """N padded to a power of two (1, 2, 3, 12), N > 32 in passes (33, 64),
    a ragged D (77) and S = 1 (decode)."""
    args = _ssm_inputs(cuda, b, s, d, n, seed=b * s + d + n,
                       with_h0=with_h0)
    ops.reset_launch_counts()
    y, h_last = ssm_scan(*args)
    assert ops.launch_counts()["ssm_scan"] == 1
    yr, hr = ref.ssm_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_last, hr, rtol=1e-4, atol=1e-4)


def test_ssm_scan_refuses_what_it_does_not_take(cuda):
    xc, dt, bm, cm, a, _ = _ssm_inputs(cuda, 1, 4, 8, 4, 0, False)
    # a state size outside {4, 8, 16, 32} runs (it was refused before)
    three = [t[..., :3].contiguous() for t in (bm, cm, a)]
    y, h_last = ssm_scan(xc, dt, *three)
    yr, hr = ref.ssm_scan_ref(xc, dt, *three)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_last, hr, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(xc.transpose(1, 2).contiguous().transpose(1, 2), dt, bm, cm,
                 a)


@pytest.mark.parametrize("n", [1, 3, 8, 12, 16, 33, 64])
@pytest.mark.parametrize("b,s,d", [(2, 45, 77), (1, 70, 128), (2, 1, 100),
                                   (2, 1152, 1600)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_bwd(cuda, n, b, s, d, with_h0):
    """The training launch and the reverse scan: N padded (1, 3, 12), in
    passes (33, 64), a ragged D (77), S = 1, Hymba's training shape."""
    xc, dt, bm, cm, a, h0 = _ssm_inputs(cuda, b, s, d, n, seed=b + s + d + n,
                                        with_h0=with_h0)
    g = torch.Generator(device=cuda).manual_seed(n)
    dy = torch.randn((b, s, d), generator=g, device=cuda)
    dh = torch.randn((b, d, n), generator=g, device=cuda) if with_h0 \
        else None
    ops.reset_launch_counts()
    y, h_last, ckpt = ssm_scan_with_checkpoints(xc, dt, bm, cm, a, h0)
    y1, h1 = ssm_scan(xc, dt, bm, cm, a, h0)
    got = ssm_scan_bwd(xc, dt, bm, cm, a, ckpt, dy, dh)
    again = ssm_scan_bwd(xc, dt, bm, cm, a, ckpt, dy, dh)
    assert ops.launch_counts()["ssm_scan"] == 2
    assert ops.launch_counts()["ssm_scan_bwd"] == 2
    assert torch.equal(y, y1) and torch.equal(h_last, h1)
    f64 = lambda t: None if t is None else t.double()
    _, _, ck = ref.ssm_scan_with_checkpoints_ref(
        *map(f64, (xc, dt, bm, cm, a, h0)))
    want = ref.ssm_scan_bwd_ref(*map(f64, (xc, dt, bm, cm, a)), ck, f64(dy),
                                f64(dh))
    torch.cuda.synchronize()
    torch.testing.assert_close(ckpt.double(), ck, rtol=1e-4, atol=1e-4)
    for gt, gt2, w in zip(got, again, want):
        assert torch.equal(gt, gt2)
        assert float((gt.double() - w).abs().max()) <= \
            1e-4 * float(w.abs().max())


@pytest.mark.parametrize("b,s,d", [(1, 32, 200), (2, 33, 200),
                                   (1, 4101, 96), (1, 4224, 1600)])
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssm_scan_bwd_span_carry(cuda, b, s, d, with_dh):
    """The adjoint carried from span to span at N = 16: one whole span (S
    = 32), a one-step last span (33), 129 spans with a ragged last one
    (4,101) and train_4k's per-rank shape (1, 4,224, 1,600), against the
    float64 plain version, two launches bitwise."""
    n = 16
    xc, dt, bm, cm, a, _ = _ssm_inputs(cuda, b, s, d, n, seed=s + d,
                                       with_h0=False)
    g = torch.Generator(device=cuda).manual_seed(s)
    dy = torch.randn((b, s, d), generator=g, device=cuda)
    dh = torch.randn((b, d, n), generator=g, device=cuda) if with_dh \
        else None
    _, _, ckpt = ssm_scan_with_checkpoints(xc, dt, bm, cm, a)
    ops.reset_launch_counts()
    got = ssm_scan_bwd(xc, dt, bm, cm, a, ckpt, dy, dh)
    again = ssm_scan_bwd(xc, dt, bm, cm, a, ckpt, dy, dh)
    assert ops.launch_counts()["ssm_scan_bwd"] == 2
    f64 = lambda t: None if t is None else t.double()
    _, _, ck = ref.ssm_scan_with_checkpoints_ref(
        *map(f64, (xc, dt, bm, cm, a)))
    want = ref.ssm_scan_bwd_ref(*map(f64, (xc, dt, bm, cm, a)), ck, f64(dy),
                                f64(dh))
    torch.cuda.synchronize()
    for gt, gt2, w in zip(got, again, want):
        assert torch.equal(gt, gt2)
        assert bool(torch.isfinite(gt).all())
        assert float((gt.double() - w).abs().max()) <= \
            1e-4 * float(w.abs().max())


def test_ssm_scan_autograd_on_the_card_matches_the_cpu(cuda):
    xc, dt, bm, cm, a, h0 = _ssm_inputs(cuda, 2, 75, 64, 8, 5, True)

    def grads(dev):
        ins = [t.to(dev).clone().requires_grad_(True)
               for t in (xc, dt, bm, cm, a, h0)]
        y, h_last = ops.ssm_scan(*ins)
        loss = torch.sum(y * y) + torch.sum(h_last)
        return torch.autograd.grad(loss, ins)
    ops.reset_launch_counts()
    on_card = grads(cuda)
    assert ops.launch_counts()["ssm_scan_bwd"] == 1
    for g, w in zip(on_card, grads("cpu")):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


def test_hymba_train_step_on_the_card_matches_the_cpu(cuda):
    """One smoke() train step, card against CPU, from the same weights:
    loss and gradient norm 1e-4 relative; the scan's two kernels ran."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import common
    from repro_torch.train import make_train_step, opt_init
    cfg = get_config("hymba-1.5b", smoke=True)
    host = serve.build_params(cfg, 0, "cpu")
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab,
                                                         (2, 40))}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = common.tree_map(lambda t: t.to(dev, copy=True), host)
        ops.reset_launch_counts()
        _, _, m = make_train_step(cfg, device=dev)(
            p, opt_init(cfg.optimizer, p), batch)
        out[dev.type] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        if dev.type == "cuda":
            assert ops.launch_counts()["ssm_scan_bwd"] == cfg.n_layers
    for k, want in out["cpu"].items():
        assert abs(out["cuda"][k] - want) <= 1e-4 * abs(want), k


def test_mamba_mix_on_the_card_matches_the_naive_oracle(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import common, mamba
    cfg = get_config("hymba-1.5b", smoke=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = common.tree_map(lambda t: t[0].contiguous(), common.build_params(
        mamba.param_specs(cfg, cfg.q_dim), gen, cuda))
    p["a_log"] = torch.rand(p["a_log"].shape, generator=gen, device=cuda) - .5
    x = torch.randn((2, 37, cfg.d_model), generator=gen, device=cuda)
    ops.reset_launch_counts()
    got, gst = mamba.mamba_mix(x, p, d_inner=cfg.q_dim)
    step, sst = mamba.mamba_mix(x[:, :1], p, d_inner=cfg.q_dim, state=gst)
    assert ops.launch_counts()["ssm_scan"] == 2
    want, wst = mamba.mamba_naive(x, p, d_inner=cfg.q_dim)
    wstep, wsst = mamba.mamba_naive(x[:, :1], p, d_inner=cfg.q_dim, state=wst)
    for g, w in ((got, want), (gst.h, wst.h), (step, wstep),
                 (sst.h, wsst.h)):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


def test_mamba_mix_with_state_size_12_matches_the_naive_oracle(cuda):
    """A mixer whose ssm_state is no power of two, on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import common, mamba
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              ssm_state=12)
    gen = torch.Generator(device=cuda).manual_seed(1)
    p = common.tree_map(lambda t: t[0].contiguous(), common.build_params(
        mamba.param_specs(cfg, cfg.q_dim), gen, cuda))
    p["a_log"] = torch.rand(p["a_log"].shape, generator=gen, device=cuda) - .5
    assert p["a_log"].shape[-1] == 12
    x = torch.randn((2, 37, cfg.d_model), generator=gen, device=cuda)
    ops.reset_launch_counts()
    got, gst = mamba.mamba_mix(x, p, d_inner=cfg.q_dim)
    step, sst = mamba.mamba_mix(x[:, :1], p, d_inner=cfg.q_dim, state=gst)
    assert ops.launch_counts()["ssm_scan"] == 2
    want, wst = mamba.mamba_naive(x, p, d_inner=cfg.q_dim)
    wstep, wsst = mamba.mamba_naive(x[:, :1], p, d_inner=cfg.q_dim, state=wst)
    for g, w in ((got, want), (gst.h, wst.h), (step, wstep),
                 (sst.h, wsst.h)):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


def test_hymba_serving_on_the_card_matches_the_cpu(cuda):
    """Hymba smoke() served on the card against the CPU's teacher-forced
    forward over the same tokens, from the same weights: logits within
    2e-3, each token the CPU's argmax where its top-2 gap exceeds twice
    that, one ssm_scan launch per layer per call."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    cfg = get_config("hymba-1.5b", smoke=True)
    p_cpu = serve.build_params(cfg, 0, "cpu")
    p_card = common.tree_map(lambda t: t.to(cuda), p_cpu)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))
    ops.reset_launch_counts()
    got = serve.greedy_generate(p_card, cfg, prompt, 6, device=cuda)
    assert ops.launch_counts()["ssm_scan"] == cfg.n_layers * 6
    seq = np.concatenate([prompt, got.tokens.cpu().numpy()], axis=1)
    full = transformer.forward(p_cpu, {"tokens": seq}, cfg, device="cpu")
    want = full[:, 39:45]
    torch.testing.assert_close(got.logits.cpu(), want, rtol=0, atol=2e-3)
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 4e-3
    assert torch.equal(got.tokens.cpu()[clear],
                       torch.argmax(want, dim=-1)[clear])


def test_dense_forward_and_train_step_on_the_card_match_the_cpu(cuda):
    """gemma3 smoke() (qk-norm, local:global, tied embeddings) on the
    card against the CPU from the same weights and batch: the forward's
    logits within 2e-3; one train step's loss and gradient norm within
    1e-4 relative; no custom kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.train import make_train_step, opt_init
    cfg = get_config("gemma3-27b", smoke=True)
    p_cpu = serve.build_params(cfg, 0, "cpu")
    p_card = common.tree_map(lambda t: t.to(cuda), p_cpu)
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab,
                                                         (2, 64))}
    ops.reset_launch_counts()
    got = transformer.forward(p_card, batch, cfg, device=cuda)
    want = transformer.forward(p_cpu, batch, cfg, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-3)
    outs = []
    for p, dev in ((p_card, cuda), (p_cpu, "cpu")):
        step = make_train_step(cfg, base_lr=1e-2, warmup=1, microbatch=1,
                               device=dev)
        outs.append(step(p, opt_init(cfg.optimizer, p), batch))
    assert not any(ops.launch_counts().values())
    (_, _, mc), (_, _, mp) = outs
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mc[k].cpu(), mp[k], rtol=1e-4, atol=0)
    assert int(mc["skipped"]) == 0 and int(mp["skipped"]) == 0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-7b",
                                  "whisper-medium"])
def test_moe_rwkv_whisper_forward_and_train_step_on_the_card_match_the_cpu(
        cuda, arch):
    """The MoE (at capacity factor 16, no drops), RWKV and Whisper smoke()
    models on the card against the CPU from the same weights and batch:
    the forward's logits within 2e-3; one train step's loss and gradient
    norm within 1e-4 relative; no custom kernel."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.train import make_train_step, opt_init
    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    p_cpu = serve.build_params(cfg, 0, "cpu")
    p_card = common.tree_map(lambda t: t.to(cuda), p_cpu)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 64))}
    if cfg.enc_dec:
        batch = {"frames": (rng.standard_normal((2, 64, cfg.d_model)) * 0.1
                            ).astype(np.float32),
                 "dec_tokens": rng.integers(0, cfg.vocab,
                                            (2, cfg.decoder_len))}
    ops.reset_launch_counts()
    got = transformer.forward(p_card, batch, cfg, device=cuda)
    want = transformer.forward(p_cpu, batch, cfg, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-3)
    outs = []
    for p, dev in ((p_card, cuda), (p_cpu, "cpu")):
        step = make_train_step(cfg, base_lr=1e-2, warmup=1, microbatch=1,
                               device=dev)
        outs.append(step(p, opt_init(cfg.optimizer, p), batch))
    assert not any(ops.launch_counts().values())
    (_, _, mc), (_, _, mp) = outs
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mc[k].cpu(), mp[k], rtol=1e-4, atol=0)
    assert int(mc["skipped"]) == 0 and int(mp["skipped"]) == 0


# ---------------------------------------------------------------------------
# the on-disk index on the card: block transport, staging, the pipeline
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 20_000_000      # ~10 ms of a spinning kernel at ~2 GHz


@pytest.fixture(scope="module")
def disk_index(cuda, tmp_path_factory):
    """4,000 x 128 random walks, built and saved on the card, reopened
    out-of-core there, with queries near the series."""
    from repro_torch import storage
    raw = random_walk(4000, 128, seed=23)
    rng = np.random.default_rng(11)
    qs = torch.from_numpy(raw[rng.choice(4000, 6, replace=False)]
                          + 0.05 * rng.standard_normal((6, 128))
                          .astype(np.float32)).to(cuda)
    path = tmp_path_factory.mktemp("disk") / "rw.dsix"
    storage.save_index(build(raw, capacity=64, device=cuda), path)
    return path, qs


class _SlowCopyCache:
    """Made on first use: a BlockCache whose reader's side stream spins
    before each copy, so the copy lands long after ``get`` returns."""

    @staticmethod
    def make(*args, **kw):
        from repro_torch import storage

        class SlowCopy(storage.BlockCache):
            def _to_device(self, block):
                with torch.cuda.stream(self._side().stream):
                    torch.cuda._sleep(SLEEP_CYCLES)
                return super()._to_device(block)
        return SlowCopy(*args, **kw)


@pytest.mark.parametrize("how", ["fetch", "copy"])
def test_block_cache_with_slowed_reader_is_exact(cuda, disk_index, how):
    """A reader slowed on purpose (a sleeping ``HostRawBlocks.fetch``, or a
    side stream that spins before each copy) changes no bit of the
    answer: a missing stream wait would read unwritten memory."""
    import time
    from repro_torch import storage
    path, qs = disk_index
    opened = storage.open_index(path, device=cuda)
    want = search_block_major(storage.load_index(path, device=cuda), qs, k=5)
    base = storage.ooc_search(opened, qs, k=5, pipeline_depth=2,
                              group_blocks=4)
    orig = opened.host_raw.fetch
    with storage.SearchSession(opened, cache_blocks=16, pipeline_depth=2,
                               group_blocks=4) as sess:
        if how == "fetch":
            opened.host_raw.fetch = lambda b: (time.sleep(0.002), orig(b))[1]
        else:
            sess.cache.close()
            sess.cache = _SlowCopyCache.make(opened.host_raw, 16, readers=2,
                                             max_inflight=6, device=cuda)
        try:
            got = sess.search(qs, k=5)
        finally:
            if how == "fetch":
                del opened.host_raw.fetch
    assert torch.equal(got.idx, base.idx) and torch.equal(got.dist, base.dist)
    for a, b in zip(got.stats, base.stats):
        assert torch.equal(a, b)
    assert torch.equal(got.idx, want.idx)


def test_evicted_block_is_not_overwritten_under_a_queued_read(cuda,
                                                              disk_index):
    """A block evicted while a queued kernel still reads it keeps its
    bytes: ``get`` records it on the consumer's stream, so the allocator
    does not hand its memory to the next read on the reader's stream."""
    from repro_torch import storage
    path, _ = disk_index
    host = storage.open_index(path, device=cuda).host_raw
    cache = storage.BlockCache(host, 2, readers=1, device=cuda)
    try:
        a = cache.get(0)
        torch.cuda._sleep(20 * SLEEP_CYCLES)     # hold the consumer stream
        out = a * 1.0                            # queued behind the sleep
        del a
        for b in range(1, 8):                    # evicts block 0 at once
            cache.prefetch(b)
        cache.drain()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), torch.from_numpy(host.fetch(0)))
    finally:
        cache.close()


def test_chunked_loader_staging_gives_the_same_chunks(cuda):
    """Overlapped staging through two pinned buffers: each chunk arrives
    intact although the consumer's stream lags behind the staging."""
    from repro_torch.data import ChunkedLoader
    raw = random_walk(1000, 64, seed=4)
    chunks = []
    for c in ChunkedLoader(raw, chunk=96, device=cuda):
        torch.cuda._sleep(SLEEP_CYCLES)          # the consumer is slow
        chunks.append(c * 1.0)
    torch.cuda.synchronize()
    assert all(c.is_cuda for c in chunks)
    assert torch.equal(torch.cat(chunks).cpu(), torch.from_numpy(raw))


@pytest.mark.parametrize("shards,workers", [(1, 1), (3, 2)])
def test_pipeline_on_the_card_equals_save_index_of_build(cuda, tmp_path,
                                                         shards, workers):
    """The pipeline's file is byte-identical to save_index(core.build(...))
    on the card: z-norm and summarize are per row on the card too."""
    import hashlib
    from repro_torch import storage
    raw = random_walk(3000, 128, seed=8)
    store = storage.SeriesStore.write(tmp_path / "s.f32", raw)
    storage.save_index(build(raw, capacity=64, device=cuda),
                       tmp_path / "golden.dsix")
    ops.reset_launch_counts()
    opened = storage.pipeline_build(store, tmp_path / "p.dsix", capacity=64,
                                    chunk=500, shards=shards,
                                    workers=workers, device=cuda)
    assert ops.launch_counts()["isax_summarize"] > 0
    assert opened.host_raw is not None and opened.elo.is_cuda
    sha = [hashlib.sha256((tmp_path / f).read_bytes()).hexdigest()
           for f in ("golden.dsix", "p.dsix")]
    assert sha[0] == sha[1]


def test_ooc_search_on_the_card_matches_the_cpu(cuda, disk_index):
    """The cached walk on the card (the fused kernel, lb_scan) against the
    same walk on the CPU (the plain versions) over the same file."""
    from repro_torch import storage
    path, qs = disk_index
    ops.reset_launch_counts()
    got = storage.ooc_search(storage.open_index(path, device=cuda), qs, k=5,
                             pipeline_depth=4, group_blocks=8)
    counts = ops.launch_counts()
    assert counts["lb_scan"] > 0 and counts["fused_panel_topk"] > 0
    want = storage.ooc_search(storage.open_index(path, device="cpu"),
                              qs.cpu(), k=5, device="cpu")
    assert torch.equal(got.idx.cpu(), want.idx)
    torch.testing.assert_close(got.dist.cpu() ** 2, want.dist ** 2,
                               rtol=1e-5, atol=1e-4)
    assert tuple(got.io)[1:2] == tuple(want.io)[1:2]


def test_znorm_on_the_card_is_independent_of_the_call(cuda):
    """The fixed-order z-norm: a call of a few gathered rows gives the bits
    of one call over every row (a library reduction on the card does not:
    calls of 1 to 7 rows rounded differently at 10M series), and the
    result is within an ulp or two of the CPU's."""
    x = torch.from_numpy(random_walk(20_000, 256, seed=2))
    whole = isax.znorm(x.to(cuda))
    torch.testing.assert_close(whole.cpu(), isax.znorm(x), rtol=1e-6,
                               atol=1e-6)
    g = torch.Generator(device=cuda).manual_seed(0)
    for m in (1, 2, 7, 100, 16384):
        rows = torch.randint(0, 20_000, (m,), generator=g, device=cuda)
        assert torch.equal(isax.znorm(x.to(cuda)[rows]), whole[rows]), m
