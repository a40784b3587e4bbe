"""Roofline terms of a counted step against one NVIDIA H100 SXM, and the
work and least time of each hand-written kernel.

The counterpart of ``repro.launch.roofline``:

    compute    = each FLOP class over its unit's peak, summed     [s]
    memory     = HBM bytes / 3.35 TB/s                             [s]
    collective = per-rank collective bytes / the link's rate       [s]

The FLOPs, bytes and collective bytes come from ``launch.op_analysis``'s
count of the dispatched operations of one rank's step (the reference
reads them from the partitioned HLO, per chip, against a TPU v5e's 197
TFLOP/s, 819 GB/s and 50 GB/s links; nothing of that model is kept).
Eager PyTorch runs one kernel after another, so the compute term sums
the classes: matmuls in bf16 / fp16 on the tensor cores, fp32 matmuls
outside them (the port leaves TF32 off), every other operation at one
fp32 operation an output element, and each hand-written kernel at the
larger of its units' times.  ``max(compute, memory)`` is then a least
time for the step: each kernel takes at least the larger of its own two.

The H100 SXM's peaks (NVIDIA H100 Tensor Core GPU datasheet, SXM5, dense
rates without sparsity, at the 700 W limit): 989.4 TFLOP/s bf16 and
fp16, 494.7 TFLOP/s TF32, 67 TFLOP/s fp32 and 34 TFLOP/s fp64 outside
the tensor cores, 3.35 TB/s of HBM3; NVLink 4 at 900 GB/s both ways,
450 GB/s a direction, between the 8 cards of one HGX / DGX H100 board;
beyond 8 cards one 400 Gb/s NDR InfiniBand link a card (the DGX H100's
eight ConnectX-7 ports), 50 GB/s.  The special-function units' exp rate
(16 a clock on each of the 132 SMs) is taken at the 1.98 GHz maximum SM
clock.

``bound`` and the ``*_work`` functions are the one definition of each
kernel's least time: ``chip_smoke.py`` prints them beside the measured
times, and ``kernels/ops.py``'s calls are recorded in a count with them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

from repro_torch.configs.base import SHAPES, active_params
from repro_torch.kernels._build import SSM_CKPT_STEPS

# (operations a second, the unit a bound names)
BF16 = (989.4e12, "dense bf16 tensor-core operations at 989.4 TFLOP/s")
TF32 = (494.7e12, "dense TF32 tensor-core operations at 494.7 TFLOP/s")
FP32 = (67e12, "fp32 operations at 67 TFLOP/s")   # outside the tensor cores
FP64 = (34e12, "fp64 operations at 34 TFLOP/s")   # outside the tensor cores
SM_CLOCK_HZ = 1.98e9           # assumed for the SFU rate: the maximum SM clock
SFU = (16 * 132 * SM_CLOCK_HZ,  # 16 exps a clock on each of 132 SMs
       "exps on the special-function units, 16 a clock an SM at 1.98 GHz")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
NVLINK_BYTES_PER_S = 450e9     # a direction, within the 8 cards of a board
NETWORK_BYTES_PER_S = 50e9     # a card, beyond 8: one 400 Gb/s NDR link
CARDS_PER_BOARD = 8

# a kernel's operation classes and the rate each runs at
RATES = {"fp32": FP32, "tf32": TF32, "fp64": FP64, "sfu": SFU}
# a matmul's FLOPs by operand type: bf16 and fp16 on the tensor cores,
# fp32 outside them (TF32 off), fp64 on the fp64 units
DOT_RATES = {"bf16": BF16, "fp32": FP32, "fp64": FP64}


def bound(nbytes: float, ops: float, rate: tuple = FP32, *more
          ) -> tuple[float, str, str]:
    """The least time for the work: ``nbytes`` at the memory rate against
    ``ops`` at ``rate`` (fp32 outside the tensor cores by default) and any
    further (ops, rate) pairs, each on its own unit.  -> (ms, "bytes" or
    "operations", the unit that bounds it)."""
    best = (nbytes / HBM_BYTES_PER_S * 1e3, "bytes", "bytes at 3.35 TB/s")
    for n_ops, (per_s, unit) in ((ops, rate), *more):
        t = n_ops / per_s * 1e3
        if t > best[0]:
            best = (t, "operations", unit)
    return best


class Work(NamedTuple):
    """One kernel call's work: bytes moved (each input read once, each
    output written once) and operations by class (keys of ``RATES``)."""
    nbytes: float
    ops: dict

    def bound(self) -> tuple[float, str, str]:
        (k0, n0), *rest = self.ops.items()
        return bound(self.nbytes, n0, RATES[k0],
                     *((n, RATES[k]) for k, n in rest))


# ---------------------------------------------------------------------------
# Each kernel's work, from its operands' shapes
# ---------------------------------------------------------------------------


def ssm_scan_work(b: int, s: int, d: int, n: int, with_h0: bool,
                  with_ckpt: bool = False) -> Work:
    """Bytes: xc, dt, y (B, S, D), B, C (B, S, N), A (D, N), h_last and h0
    (B, D, N), and the training launch's states (B, ceil(S/32), D, N).
    fp32 operations: per (b, t, d, n) dt*A, (dt*x)*B, a*h + b (two), h*C
    and one reduction add; per (b, t, d) dt*x.  Exps: one per (b, t, d,
    n), on the special-function units."""
    nbytes = 4 * (3 * b * s * d + 2 * b * s * n + d * n
                  + (2 if with_h0 else 1) * b * d * n)
    if with_ckpt:
        nbytes += 4 * b * -(-s // SSM_CKPT_STEPS) * d * n
    return Work(nbytes, {"fp32": 6 * b * s * d * n + b * s * d,
                         "sfu": b * s * d * n})


def ssm_scan_bwd_work(b: int, s: int, d: int, n: int, with_dh: bool
                      ) -> Work:
    """Bytes: xc, dt, dy in and dxc, ddt out (B, S, D); B, C in and dB, dC
    out (B, S, N); A in, dA out (D, N); the checkpoints (B, ceil(S/32),
    D, N) and dh_last in, dh0 out (B, D, N).  Per (b, t, d, n): one exp,
    a_t = exp(dt_t A), which the recomputed state and the adjoint share,
    on the special-function units, and 17 other fp32 operations."""
    spans = -(-s // SSM_CKPT_STEPS)
    nbytes = 4 * (5 * b * s * d + 4 * b * s * n + 2 * d * n
                  + b * spans * d * n + (2 if with_dh else 1) * b * d * n)
    e = b * s * d * n
    return Work(nbytes, {"fp32": 17 * e, "sfu": e})


def ssm_bound(b, s, d, n, with_h0: bool) -> tuple[float, str, str]:
    """``ssm_scan``'s least time at (B, S, D, N)."""
    return ssm_scan_work(b, s, d, n, with_h0).bound()


def ssm_bwd_bound(b, s, d, n, with_dh: bool) -> tuple[float, str, str]:
    """``ssm_scan_bwd``'s least time at (B, S, D, N)."""
    return ssm_scan_bwd_work(b, s, d, n, with_dh).bound()


def isax_summarize_work(n_series: int, n: int, w: int, card: int,
                        normalize: bool) -> Work:
    """Bytes: the series (N, n) in, PAA f32 and symbols i32 (N, w) out,
    the card - 1 breakpoints.  float64: a point's add, and with the
    z-norm five more; a window's divide; the symbol search a binary
    search over the breakpoints in fp32."""
    nbytes = n_series * n * 4 + n_series * w * 8 + (card - 1) * 4
    f64 = n_series * (n * (6 if normalize else 1) + w)
    return Work(nbytes, {"fp64": f64,
                         "fp32": n_series * w * math.ceil(math.log2(card))})


def lb_scan_work(q: int, w: int, n_cols: int) -> Work:
    """Bytes: q_paa (Q, w), lo and hi (w, N) in, (Q, N) out.  fp32: six a
    (q, segment, column) term and the scale a (q, column)."""
    return Work(q * w * 4 + 2 * w * n_cols * 4 + q * n_cols * 4,
                {"fp32": q * n_cols * (6 * w + 1)})


def block_topk_work(q: int, c: int, k: int) -> Work:
    """Bytes: (dist, id) (Q, C) in, (Q, k) out; one comparison a lane."""
    return Work(q * c * 8 + q * k * 8, {"fp32": q * c})


def batch_l2_work(q: int, m: int, n: int) -> Work:
    """Bytes: q (Q, n), x (M, n) in, (Q, M) out; three TF32 products on
    the tensor cores (the split-TF32 design)."""
    return Work(4 * (q * n + m * n + q * m), {"tf32": 3 * 2 * q * m * n})


def fused_panel_topk_work(q: int, c: int, n: int, w: int, k: int) -> Work:
    """Every lane live (the most the data could need; ``chip_smoke.py``
    counts a block's live lanes): the queries, their PAA and bound in,
    the block's bounds, ids and rows read, (Q, k) out, ``n_live``.  fp32:
    the filter's 6w a (q, lane), the distance's 2n + 3 a live pair, the
    rows' norms."""
    nbytes = (q * (n + w + 1) * 4 + 2 * w * c * 4 + c * 4 + c * n * 4
              + q * k * 8 + q * 4)
    return Work(nbytes, {"fp32": q * c * 6 * w + q * c * (2 * n + 3)
                         + c * 2 * n})


def band_cells(n: int, r: int) -> int:
    """Cells of an n x n DTW matrix within the Sakoe-Chiba band r."""
    r = min(r, n - 1)
    return n * (2 * r + 1) - r * (r + 1)


def dtw_band_panel_work(q: int, m: int, n: int, r: int) -> Work:
    """Gathered (Q, M, n) or shared (M, n) rows against (Q, n) queries ->
    (Q, M): the rows read once a query, six fp32 operations a band
    cell."""
    cells = q * m * band_cells(n, r)
    return Work(4 * (q * n + q * m * n + q * m), {"fp32": 6 * cells})


def kernel_work(name: str, ops: dict) -> Work:
    """The work of one call of ``kernels/ops.py``'s kernel ``name``, from
    its operands (tensors or None) and options, as ``ops`` records them."""
    if name == "ssm_scan":
        b, s, d = ops["xc"].shape
        return ssm_scan_work(b, s, d, ops["bm"].shape[-1],
                             ops["h0"] is not None, ops.get("ckpt", False))
    if name == "ssm_scan_bwd":
        b, s, d = ops["xc"].shape
        return ssm_scan_bwd_work(b, s, d, ops["bm"].shape[-1],
                                 ops["dh_last"] is not None)
    if name == "isax_summarize":
        n_series, n = ops["x"].shape
        return isax_summarize_work(n_series, n, ops["w"], ops["card"],
                                   ops["normalize"])
    if name == "lb_scan":
        q, w = ops["q_paa"].shape
        return lb_scan_work(q, w, ops["lo"].shape[1])
    if name == "block_topk":
        q, c = ops["d"].shape
        return block_topk_work(q, c, ops["k"])
    if name == "batch_l2":
        return batch_l2_work(ops["q"].shape[0], ops["x"].shape[0],
                             ops["q"].shape[1])
    if name == "fused_panel_topk":
        q, n = ops["q"].shape
        return fused_panel_topk_work(q, ops["block"].shape[0], n,
                                     ops["q_paa"].shape[1], ops["k"])
    if name == "dtw_band_panel":
        q, n = ops["q"].shape
        x = ops["x"]
        m = x.shape[0] if x.dim() == 2 else x.shape[1]
        return dtw_band_panel_work(q, m, n, ops["r"])
    raise KeyError(f"no work formula for kernel {name!r}")


# ---------------------------------------------------------------------------
# A step's roofline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    flops: float                 # per rank, loops multiplied out
    dot_flops: float             # the matmul part
    flops_once: float            # every counted loop body once (where the
    #                              reference keeps XLA's undercount)
    bytes_hbm: float             # per rank
    bytes_coll: float            # per rank
    coll_by_op: dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # 6ND (train) / 2ND (prefill) / 2NB, global
    useful_ratio: float          # model_flops / (flops * ranks)
    warnings: list[str]

    def table_row(self) -> dict[str, Any]:
        return {
            "flops_per_dev": self.flops, "dot_flops_per_dev": self.dot_flops,
            "flops_once": self.flops_once,
            "bytes_per_dev": self.bytes_hbm,
            "coll_bytes_per_dev": self.bytes_coll,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "coll_by_op": self.coll_by_op,
            "warnings": self.warnings,
        }


def link_bytes_per_s(n_ranks: int) -> float:
    """The per-card collective rate: NVLink within a board, the network
    beyond it."""
    return NVLINK_BYTES_PER_S if n_ranks <= CARDS_PER_BOARD \
        else NETWORK_BYTES_PER_S


def compute_seconds(totals) -> float:
    """The compute term of an ``op_analysis.CostTotals``: each matmul
    class, the other operations and each kernel, at their units' peaks."""
    t = sum(f / DOT_RATES[k][0] for k, f in totals.dot_by_dtype.items())
    t += (totals.flops - totals.dot_flops - totals.kernel_flops) / FP32[0]
    for kern in totals.kernels.values():
        t += max((n / RATES[k][0] for k, n in kern["ops"].items()),
                 default=0.0)
    return t


def analyze(totals, *, n_ranks: int, model_flops: float) -> Roofline:
    """The roofline of one rank's count on an H100 SXM, ``n_ranks``
    ranks in all.  Kernel calls add their bytes to the memory term and
    their operations (each kernel at its slowest unit) to compute."""
    compute_s = compute_seconds(totals)
    memory_s = totals.bytes / HBM_BYTES_PER_S
    collective_s = totals.coll_bytes / link_bytes_per_s(n_ranks)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    flops = float(totals.flops)
    useful = model_flops / (flops * n_ranks) if flops else 0.0
    return Roofline(flops=flops, dot_flops=float(totals.dot_flops),
                    flops_once=float(totals.flops_once),
                    bytes_hbm=float(totals.bytes),
                    bytes_coll=float(totals.coll_bytes),
                    coll_by_op=dict(totals.coll_by_op),
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s, bottleneck=bottleneck,
                    model_flops=model_flops, useful_ratio=useful,
                    warnings=list(totals.warnings))


def model_flops_for(cfg, shape_name: str) -> float:
    """6·N·D for training, 2·N·D for prefill, 2·N·B per decoded token
    (N = active params for MoE)."""
    cell = SHAPES[shape_name]
    n = active_params(cfg)
    if cell.kind == "train":
        return 6.0 * n * cell.seq_len * cell.global_batch
    if cell.kind == "prefill":
        return 2.0 * n * cell.seq_len * cell.global_batch
    return 2.0 * n * cell.global_batch            # one token per sequence
