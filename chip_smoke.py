#!/usr/bin/env python3
"""Drive and check the port's search paths, its distributed protocol,
search serving, LM serving (every family) and training (the dense, MoE
and hybrid families at full width, and data-parallel over ranks) on one
card.

    python3 chip_smoke.py [--seed 0] [--n-series 10000000] [--queries 100]
                          [--dtw-queries 10] [--lm-batch 4]
                          [--lm-prompt 2048] [--lm-gen 32] [--lm-smoke]
                          [--ooc-series N]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each printing one JSON line:

  1. device    — the card's name and count, and nvidia-smi's name and
                 power limit; fails without a card;
  2. build     — builds the eight CUDA kernels (the seven TPU kernels'
                 ports and the scan's backward) from
                 ``src/repro_torch/kernels/csrc`` (build seconds, ptxas
                 registers / shared memory / spills);
  3. main      — the main path through the user's entry points:
                 ``core.build`` over random-walk series generated on the
                 card from ``--seed`` (the paper's Synthetic recipe), then
                 ``core.search_block_major`` for k=1 and k=10 on
                 ``--queries`` random-walk queries from ``--seed + 1``;
  4. schedules — the same index and queries through ``core.search``
                 (query-major) and ``core.search_paris`` (the flat ParIS
                 scan, chunk 4096), k=1 and k=10;
  5. ucr       — ``core.search_scan`` (the brute-force UCR scan) over the
                 raw array, k=10;
  6. dtw       — ``dtw.search_dtw`` (r=12, about 5% of the length) on the
                 first ``--dtw-queries`` queries, k=1 and k=10, checked
                 against a banded-DTW scan of every series (the
                 ``dtw_band_panel`` kernel on shared chunks, merged with
                 the plain ``topk_by_dist_id``);
  7. lm        — Hymba serving (``hymba-1.5b``, full width and depth,
                 fp32 weights from ``--seed``): ``--lm-batch`` requests of
                 ``--lm-prompt`` random tokens (from ``--seed + 2``) through
                 ``launch.serve.greedy_generate`` (prefill, then greedy
                 decode to ``--lm-gen`` tokens), checked against the
                 teacher-forced ``forward`` over prompt and generated
                 tokens, and layer 0's Mamba mixer (the ``ssm_scan``
                 kernel) against the plain ``mamba_naive`` on its real
                 input;
  8. dense     — dense serving at full width through the same entry points,
                 fp32 weights from ``--seed``: ``h2o-danube-1.8b`` (24
                 layers, SWA 4,096), 4 requests x 4,608 tokens (the
                 prefill rolls the ring, decode wraps it) + 32 greedy;
                 then ``gemma3-27b``'s widths cut to 6 layers (one 5:1
                 local:global period: qk-norm, sqrt(d) embedding scale,
                 tied embeddings, a global layer's full cache beside SWA
                 rings), 2 x 1,536 + 16; each checked against the
                 teacher-forced ``forward`` under ``lm``'s rule; no
                 custom kernel is on this path (0 launches, checked);
  9. train     — the serving weights freed, ``h2o-danube-1.8b`` ``full()``
                 trained with fp32 AdamW (``train.make_train_step``), 4
                 steps of B = 2 x S = 1,024 on one batch of
                 ``data.tokens`` from ``--seed``: every loss and gradient
                 norm finite, no step skipped, the last loss below the
                 first, step 1's loss ``make_eval_step``'s at the initial
                 parameters within 1e-5 relative; the step's median
                 seconds over steps 2-4, tokens/s, 6·N·tokens beside the
                 fp32 peak; one ``smoke()`` step on the card against the
                 CPU from the same parameters and batch (loss and gradient
                 norm within 1e-4 relative); and ``python -m
                 repro_torch.examples.train_lm --steps 40`` as a
                 subprocess (exit 0, a ``[resume]`` line, the resumed
                 run's last loss below the first run's first);
 10. families  — the MoE, RWKV and Whisper families through the same
                 entry points as ``dense``, fp32 weights from ``--seed``:
                 ``granite-moe-1b-a400m`` in full (24 layers, 32 experts,
                 top-8), 4 x 2,048 + 32 greedy at capacity factor 16
                 (no drops, so serving can match the forward), then a
                 ``make_eval_step`` pass over the same tokens at the
                 config's 1.25 (``dropped_frac``, ``moe_lb``);
                 ``moonshot-v1-16b-a3b`` at its widths (64 experts,
                 top-6, vocab 163,840) cut to 4 layers, 2 x 1,024 + 16
                 at capacity factor 16; ``rwkv6-7b`` at full width (all
                 32 layers where the card's free memory holds them beside
                 16 GiB, else cut), 2 x 2,048 + 32; ``whisper-medium`` in
                 full (24 + 24 layers), 4 x 1,500 frames (N(0, 0.1) from
                 ``--seed + 3``), a 224-token decoder prompt, 32 greedy;
                 each against its teacher-forced forward under ``lm``'s
                 rule, a depth cut printed with its reason; then
                 granite-moe ``full()`` trained with AdamW under
                 ``train``'s checks (4 steps of 2 x 1,024, one
                 microbatch; ``moe_lb`` and ``moe_drop`` each step) and
                 one ``smoke()`` step of granite-moe (capacity factor
                 16), rwkv6 and whisper on the card against the CPU
                 (1e-4 relative); no custom kernel (0 launches, checked);
 11. hybrid_train — ``hymba-1.5b`` ``full()`` trained as ``train`` trains
                 h2o-danube (fp32 AdamW, per-layer checkpointing, 4 steps
                 of 2 x 1,024 tokens on one batch, 128 meta tokens ahead
                 of them) under ``train``'s checks, its Mamba recurrence
                 through ``ssm_scan`` (the training launch keeps the
                 state every 32 steps) and ``ssm_scan_bwd``: a step
                 launches ``ssm_scan`` twice a layer (the forward and the
                 checkpointed layer's recompute) and ``ssm_scan_bwd``
                 once a layer, and nothing else (checked); a ``smoke()``
                 step on the card against the CPU (1e-4 relative);
 12. mesh      — on the one card: ``python -m repro_torch.launch.train
                 --mesh 2x1`` (hymba smoke(), 2 steps of 4 x 64 tokens;
                 gloo, as two ranks share the card) as a subprocess, its checkpoint against
                 one process's steps over the whole batch in two
                 microbatches (1e-5); the model axis, ``launch.train
                 --mesh 2x2`` (4 gloo ranks; MODEL_AXIS_RUNS:
                 h2o-danube-1.8b smoke() with tensor-parallel attention
                 and FFN, granite-moe-1b-a400m smoke() with
                 expert-parallel MoE, rwkv6-7b smoke() with its time mix
                 by head and its channel mix by ``ff``, hymba-1.5b at
                 full width and 4 layers, 2 x 1,024 tokens, its Mamba by
                 channel: ``ssm_scan`` and ``ssm_scan_bwd`` on 800 of
                 its 1,600 channels on every rank), 2 steps and a
                 checkpoint each, each step against one process's same
                 step (2 microbatches) from the mesh's checkpoint before
                 it: each rank's parameter elements the specs', the last
                 step's loss and gradient norm (1e-5 relative), each
                 checkpoint's moments (1e-5 relative, absolute near 0)
                 and its parameters against AdamW applied to those
                 moments (1e-5), the scan kernels'
                 launches a step (2 and 1 a layer), every rank's
                 embedding and head used by vocabulary block
                 (``vocab_leaves`` > 0, neither among its gathered
                 leaves), no attention leaf, ``w_in`` or ``w_cr``
                 gathered (Hymba's 25 heads cut over 2:
                 ``ragged_attn``), Hymba gathering only its two gammas
                 and RWKV nothing; a line a rank with
                 its peak memory, step seconds and tensor-parallel,
                 vocabulary, ragged-attention and gathered leaves;
                 ``attention.decode_attend_seqsharded`` on 2 spawned
                 gloo ranks at one of ``gemma3-27b``'s global layers
                 (32 query and 16 KV heads of 128) over the
                 ``long_500k`` cache of 524,288 slots (8.6 GB of fp32
                 K/V, from ``--seed``), B = 1, at a position inside rank
                 1's half and off a chunk edge, against one-process
                 ``decode_attend`` over the whole cache (1e-5 x its
                 largest magnitude), the new
                 K/V written by its owner; ms a call of both; then
                 serving over the model axis on 4 spawned gloo ranks at
                 MODEL_AXIS_MESH: ``launch.serve.greedy_generate(...,
                 plan=)`` on hymba-1.5b at full width and MESH_SERVE_LAYERS
                 layers (fp32, batch 4, a 1,024-token prompt that with
                 the 128 meta tokens wraps the 1,024-slot SWA ring, 16
                 greedy tokens; the 25-head attention on its column
                 blocks, which cut a head (q and KV projected there,
                 the projections gathered), the full-attention layer's
                 decode positions over "model", ``w_in`` by block,
                 ``m_h`` / ``m_conv`` and the scan on 800 channels a
                 rank, the FFN tensor-parallel; a rank gathers only
                 ``attn_gamma`` and ``mamba_gamma``), then every arch's
                 ``smoke()`` config (MoE at capacity factor 16); each
                 rank's logits at the prefill and every step within
                 MESH_SERVE_REL x max|logit| of one process's
                 ``greedy_generate`` on the card on the same weights, the
                 tokens equal wherever one process's top-2 gap exceeds
                 that bound, each rank's parameter and cache elements
                 the specs', ``ssm_scan`` launched once a layer a call
                 on every rank, the embedding and head used by
                 vocabulary block on every rank (the greedy pick over
                 the blocks); prefill seconds, ms a token and peak
                 memory a rank;
 13. roofline  — ``python -m repro_torch.launch.dryrun --mesh 16x1`` as a
                 subprocess (its fake process group kept away from
                 ``dist1``'s NCCL one): every (arch x shape) cell, 34,
                 counted per rank on the meta device in one process,
                 each status ok, in under ROOFLINE_COUNT_S seconds; then
                 ``--measure`` in a second subprocess on ROOFLINE_CELLS
                 (hymba-1.5b decode_32k at 16x1 and train_4k at 256x1,
                 h2o-danube-1.8b's two for comparison, bf16 weights as
                 counted): one rank's step, median seconds of 3 after a
                 warm-up, the peak memory beside the predicted,
                 ``ssm_scan`` / ``ssm_scan_bwd`` launches of a step equal
                 to the counted calls, the roofline share (max(compute,
                 memory) over the measured seconds) at most
                 ROOFLINE_SHARE_MAX; a cell whose predicted peak exceeds
                 0.8 of the free memory is printed as skipped, with the
                 free memory, and fails the phase if its count calls a
                 kernel (hymba-1.5b prefill_32k, one step of ~50 s, is
                 measured apart: ``launch.dryrun --cells
                 hymba-1.5b:prefill_32k:16x1 --measure``);
 14. kernels   — each kernel against its plain PyTorch version on the
                 card, at its paths' shapes and on their data, with the
                 stated tolerance, and timed beside its plain version, a
                 library call where one exists, and its bound (the larger
                 of bytes at the memory rate and operations at the rate of
                 the unit that does them, named in ``bound_unit``: fp32,
                 fp64, TF32 tensor cores, or the exps' special-function
                 units at an assumed 1.98 GHz): ``ms`` is
                 CUDA events around back-to-back calls (the wrapper's host
                 time included where it is the longer), ``device_ms`` the
                 kernel's own device time from the profiler over the same
                 calls; ``fused_panel_topk`` is timed at the walk's first
                 block and at a late block with few live lanes;
                 ``block_topk`` bitwise and timed on the panels the walks
                 hand it (stage A (100, 1024), the first flat chunk and
                 query-major trip (100, 4096), the first DTW trip
                 (10, 2048)) at k = 1 and 10, and bitwise on +-0 ties and
                 all-pad rows; ``batch_l2`` at the first flat chunk,
                 Q = 1 and 13; both beside their library call's own
                 device time (``library_device_ms``); ``isax_summarize``
                 bitwise in both normalize modes on 1M series;
                 ``lb_scan`` at every shape the paths give it (``cases``:
                 the flat scan over every series, the block envelopes,
                 DTW's two passes against +-SENTINEL planes), each checked
                 over every column (the plain version in column chunks),
                 and untimed at the serving walks' envelope shapes
                 (``envelope_slices``: Q = 1, 4, 16, 25 over the 10M
                 index's blocks, Q = 4, 16 over the sanitize index's,
                 Q = 100 over a dist4 shard's);
                 ``fused_panel_topk`` also checked, untimed, at those
                 batch sizes (first and late block, k = 1 and 10);
                 its phase line gives each case an issue floor
                 (``issue_floor_ms``, worked out, not measured) beside its
                 byte bound;
                 ``ssm_scan`` at layer 0's prefill, one decode step from
                 its state, and a state size that is no power of two
                 (N = 12 over 512 steps); ``ssm_scan_bwd`` against the
                 plain reverse scan in float64 (1e-4 of each gradient's
                 largest magnitude) at Hymba's training shape (2, 1,152,
                 1,600) on layer 0's coefficients of ``hybrid_train``'s
                 batch (N = 16, with and without dh_last), on random
                 ones at N = 1, 3, 12, 33 and 64, and at train_4k's
                 per-rank shape (1, 4,224, 1,600, 16), two launches
                 bitwise equal; timed at the training shape and at
                 train_4k's (``timed``: device time by each kernel a
                 call launches, the issue floor, the bytes beyond the
                 work's own);
 15. exact     — every Euclidean path's answers (block-major, query-major,
                 flat, UCR) against a brute-force scan of every series with
                 the plain ``batch_l2_ref`` + ``topk_by_dist_id``;
 16. ooc       — the on-disk index over the same series (``--ooc-series``,
                 all by default, cut in whole millions until the files fit
                 in half the free disk, under the git-ignored
                 ``build/ooc/``, removed at the end): the series written as
                 a headerless f32 ``storage.SeriesStore``; the staged build
                 (``storage.run_pipeline``, capacity 1024, 4 shards, 2
                 workers: seconds and units by stage, file bytes, digest
                 seconds); the file's ids/slo/shi/elo/ehi and raw bitwise
                 equal to ``core.build``'s index; ``storage.ooc_search``
                 with k=1 and 10 from the disk (the index file's page
                 cache dropped before each batch) at (pipeline_depth,
                 group_blocks) = (1, 1) and (4, 8): ids against
                 block-major's and UCR's under ``exact``'s rule, squared
                 distances within 1e-5 of block-major's, the two settings
                 bitwise equal, with ``IOStats`` and the walk's telemetry;
                 a warm repeat through a ``storage.SearchSession`` holding
                 every block (bitwise equal, 0 bytes read); DTW (r=12,
                 k=10) on the ``--dtw-queries`` through that session, ids
                 against ``dtw``'s;
 17. dist1     — ``distributed.search_sharded`` (k=10) over the main index
                 on a world-size-1 NCCL group: bitwise ``main``'s
                 block-major answer and counters;
 18. serve     — on the ooc phase's index file: 4 tenant threads x 25
                 queries (members of one random block plus 0.05 noise,
                 from ``--seed``), k=10, through one coalesced
                 ``SearchSession`` drain, each tenant bitwise its isolated
                 ``search``, the drain's disk blocks beside the isolated
                 runs'; ``search(deadline_blocks=8)``, its certificate
                 bracketing the exact k-th distance, ``refine_to_exact``
                 bitwise the exact answer; and ``python -m
                 repro_torch.launch.serve --search-index`` once, as a
                 subprocess (4 queries a tenant, k=1);
 19. analysis  — the port's static checkers (``repro_torch.analysis``:
                 lock discipline, host syncs, kernel/oracle contracts) over
                 ``src/repro_torch``, in process: any finding fails; the
                 annotated ``# sync`` sites of ``core/engine.py`` grouped by
                 the frequency their comments state;
 20. sanitize  — the first 1M series of the ooc phase's file built here by
                 ``storage.run_pipeline``; then a subprocess with
                 ``REPRO_SANITIZE=1``: the session's and cache's locks
                 instrumented, an off-lock write to a guarded field raising
                 ``SanitizeError``, the same build bitwise the unsanitized
                 file, 4 tenants x 4 near-data queries at k=10 on the
                 phase's 1M-series index isolated and through one drain
                 from 4 threads (bitwise, no ``SanitizeError``); the
                 drained ids against the brute-force scan of those
                 series.  The script refuses to run at all
                 with ``REPRO_SANITIZE`` set in its own environment: its
                 timed phases would measure the instrumented locks;
 21. dist4     — the main process frees its tensors, then 4 ranks spawned
                 on the card over gloo (a ``file://`` store under
                 ``build/``): each reads its quarter of the series file,
                 ``distributed.build_sharded`` with global ids,
                 ``search_sharded`` block-major k=1 and 10, query-major
                 k=10, ``search_sharded_scan`` k=10 (each between
                 barriers), saves its shard; ids against the brute-force
                 scan, every rank the same answer, per-rank build seconds
                 and peak device memory, launches summed over ranks; a
                 rank that fails or a collective past its timeout fails
                 the run;
 22. dist_ooc  — ``distributed.search_sharded_ooc`` over 4 sessions on
                 dist4's shard files from a cold disk, k=10: ids against
                 the brute-force scan, the summed ``IOStats``.

Each path runs with the kernels' launch counts set to 0 just before it
and read just after, and fails if a kernel of that path was not
launched.  Then the run's seconds, nvidia-smi's line, the
``{"kernels": [...]}`` line and, if every check passed,
``{"ok": true, "device": {...}}`` as the last line.  Any failed check
exits non-zero.  TF32 is off for every fp32 product.
"""
from __future__ import annotations

import argparse
import dataclasses
import filecmp
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import core, storage  # noqa: E402
from repro_torch.core import (distributed, dtw, engine, frontier,  # noqa: E402
                              isax)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.batch_l2 import batch_l2  # noqa: E402
from repro_torch.kernels.block_topk import block_topk  # noqa: E402
from repro_torch.kernels.dtw_band import dtw_band_panel  # noqa: E402
from repro_torch.kernels.fused_refine import fused_panel_topk  # noqa: E402
from repro_torch.kernels.isax_summarize import isax_summarize  # noqa: E402
from repro_torch.kernels.lb_scan import lb_scan  # noqa: E402
from repro_torch.kernels.ssm_scan import (ssm_scan,  # noqa: E402
                                          ssm_scan_with_checkpoints)
from repro_torch.kernels.ssm_scan_bwd import ssm_scan_bwd  # noqa: E402
from repro_torch.configs import count_params, get_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.data.tokens import synthetic_token_batches  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
# the H100 SXM's rates and each kernel's work and least time
from repro_torch.launch.roofline import (FP32, SM_CLOCK_HZ,  # noqa: E402
                                         band_cells, bound)
from repro_torch.launch import specs as launch_specs  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.models import (attention, common, mamba,  # noqa: E402
                                transformer)
from repro_torch.train import (Checkpointer, make_eval_step,  # noqa: E402
                               make_train_step, opt_init)
from repro_torch.train.step import lr_schedule  # noqa: E402

LB_RTOL = 1e-5                 # 16 non-negative terms summed in another order
LB_PLAIN_CHUNK = 131_072       # columns of a chunk of the plain lb_scan
# lb_scan's issue floor: the fp32 arithmetic a (q, j, s) term of the
# kernel (two FMNMX, one FADD, one FFMA; loads and the loop not counted),
# at one warp instruction a clock on each of the 528 schedulers (132 SMs x
# 4) at the assumed clock
LB_INSTR_PER_TERM = 4
INSTR_RATE = 132 * 4 * 32 * SM_CLOCK_HZ   # thread instructions a second
DIST_REL = 1e-5                # squared-L2 tolerance: DIST_REL * (||q||^2 + ||x||^2)
LENGTH = 256                   # points per series (the paper's Synthetic)
CAPACITY = 1024                # series per block
SUMMARIZE_SLICE = 1_000_000    # series the summarize kernel is checked on
FLAT_CHUNK = 4096              # the flat scan's refinement chunk
DTW_R = 12                     # Sakoe-Chiba band, ~5% of the length
QUERY_MAJOR_BLOCKS = 4         # blocks a query a query-major trip (core.search)
DTW_BLOCKS = 2                 # blocks a query a DTW trip (dtw.search_dtw)
SCAN_CHUNK = 1 << 20           # series per step of the brute-force scans
LM_ARCH = "hymba-1.5b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32   # requests, tokens each, generated
LOGIT_REL = 1e-3               # serving vs forward: |dlogit| <= LOGIT_REL * max |logit|
MIX_TOL = 1e-3                 # mixer vs mamba_naive, rtol and atol
SSM_REL = 1e-4                 # ssm_scan vs ssm_scan_ref: SSM_REL * (|ref| + max |ref|)
SSM_ODD_N, SSM_ODD_STEPS = 12, 512   # the scan's case at a state size no power of two
# dense serving: (arch, layers or None for all, requests, prompt, generated)
DENSE_RUNS = (("h2o-danube-1.8b", None, 4, 4608, 32),
              ("gemma3-27b", 6, 2, 1536, 16))   # depth cut: one 5:1 period
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 4
# the rate from step 1 on (no warmup): AdamW's first steps move every
# weight by about lr, and at 1e-4 the loss of this one batch rose again
# at step 3
TRAIN_LR, TRAIN_WARMUP = 1e-5, 1
EVAL_REL = 1e-5                # step 1's loss vs make_eval_step's, relative
CARD_CPU_REL = 1e-4            # a smoke() step, card vs CPU: loss, grad norm
EXAMPLE_TIMEOUT_S = 600        # the train_lm example's subprocess
# the MoE, RWKV and Whisper families served: (arch, layers or None for
# all, requests, prompt, generated); Whisper's prompt is its decoder
# prompt beside WHISPER_FRAMES frame embeddings (30 s of audio)
FAMILY_RUNS = (("granite-moe-1b-a400m", None, 4, 2048, 32),
               ("moonshot-v1-16b-a3b", 4, 2, 1024, 16),
               ("rwkv6-7b", None, 2, 2048, 32),
               ("whisper-medium", None, 4, 224, 32))
WHISPER_FRAMES = 1500
MOE_SERVE_CF = 16.0            # serving vs forward with no drops at any T
FAMILY_TRAIN_ARCH = "granite-moe-1b-a400m"
FAMILY_CARD_CPU = ("granite-moe-1b-a400m", "rwkv6-7b", "whisper-medium")
# device memory kept free beside a run's parameters (activations, the
# forward's logits); a model that does not fit is cut in depth
FAMILY_HEADROOM_BYTES = 16 << 30
HYBRID_ARCH = "hymba-1.5b"     # hybrid_train: trained through ssm_scan_bwd
BWD_REL = 1e-4                 # ssm_scan_bwd vs the float64 plain version, x max |ref|
BWD_STATE_SIZES = (1, 3, 12, 33, 64)
BWD_TRAIN_4K = (1, 4224, 1600, 16)   # train_4k's per-rank scan (roofline's cell)
# ssm_scan_bwd's issue floor: the instructions a (b, t, d, n) of the
# kernel at N = 16 (csrc/ssm_scan_bwd.cu): the recompute's 7 fp32 and one
# MUFU.EX2, the adjoint's 7 fp32, the reduce-scatters of dx and ddt over
# 16 lanes (3.75 each: shuffle, add and two selects a pair) and of dB and
# dC over a warp's 2 channels (2 each), and 2.5 float4 shared loads
BWD_INSTR_PER_ELEMENT = 29
# mesh: launch.train --mesh on gloo ranks sharing the card, and the
# sequence-sharded decode at one of gemma3-27b's global layers over the
# long_500k cell's cache
MESH_TRAIN_ARCH = "hymba-1.5b"
MESH_BATCH, MESH_SEQ, MESH_STEPS = 4, 64, 2
MESH_TRAIN_REL = 1e-5          # the mesh's checkpoint vs one process's steps
MESH_WORLD = 2
# the model axis: launch.train --mesh 2x2 (4 gloo ranks on the card):
# (arch, smoke, layers, batch, seq); Hymba at full width and a cut depth
# (two checkpoints of the whole tree go through gloo and the disk)
MODEL_AXIS_MESH = (2, 2)
MODEL_AXIS_RUNS = (("h2o-danube-1.8b", True, None, 4, 64),
                   ("granite-moe-1b-a400m", True, None, 4, 64),
                   ("rwkv6-7b", True, None, 4, 64),
                   ("hymba-1.5b", False, 4, 2, 1024))
MODEL_AXIS_STEPS = 2
# the runs whose moments are held to one process's float32 step beyond
# what float32 resolves: RWKV smoke()'s bonus_u gradient at init (|g| ~
# 75, through the group norm of a small WKV output) moves by ~1.5e-5
# relative between one process's float32 and float64 steps, past
# MESH_TRAIN_REL, so any other summation order (a rank's column blocks)
# moves it as far; there the mesh may differ from one process's float32
# moments by that process's own distance from its float64 step, besides
# MESH_TRAIN_REL
MODEL_AXIS_FP32_ANCHORED = ("rwkv6-7b",)
MODEL_AXIS_TIMEOUT_S = 600
SEQ_ARCH, SEQ_SLOTS = "gemma3-27b", 524_288
SEQ_POS = 300_007              # in rank 1's half, off a 1,024-slot chunk edge
SEQ_REL = 1e-5                 # the sharded merge vs one process's decode, x max |want|
# serving over the model axis: 4 gloo ranks on the card at MODEL_AXIS_MESH,
# Hymba at full width and a cut depth, then every arch's smoke() config
MESH_SERVE_ARCH, MESH_SERVE_LAYERS = "hymba-1.5b", 4
# batch, prompt, generated tokens: with 128 meta tokens, 1,168 cache slots
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_GEN = 4, 1024, 16
MESH_SERVE_SMOKE_PROMPT, MESH_SERVE_SMOKE_GEN = 36, 4
MESH_SERVE_FRAMES = 8          # Whisper smoke()'s frames (decoder_len 16)
MESH_SERVE_REL = 1e-5          # a rank's logits vs one process's, x max|logit|
MESH_SERVE_TIMEOUT_S = 420
SEQ_CALLS = 10
MESH_DIR = ROOT / "build" / "mesh"   # git-ignored; removed at the phase's end
ROOFLINE_DIR = ROOT / "build" / "roofline"   # git-ignored; the records
ROOFLINE_COUNT_S = 120         # all 34 cells must be counted within this
ROOFLINE_SHARE_MAX = 1.05      # a larger share: the count or the peaks wrong
ROOFLINE_STEPS = 3             # timed steps after the warm-up (dryrun's)
# (arch, shape, mesh) measured on the card against their counts, in one
# process
ROOFLINE_CELLS = (("hymba-1.5b", "decode_32k", "16x1"),
                  ("hymba-1.5b", "train_4k", "256x1"),
                  ("h2o-danube-1.8b", "decode_32k", "16x1"),
                  ("h2o-danube-1.8b", "train_4k", "256x1"))
ROOFLINE_TIMEOUT_S = 900

OOC_DIR = ROOT / "build" / "ooc"   # git-ignored; removed at the phase's end
# bytes on disk a series of 256 points: the series file (1,024), the index
# file (1,024 raw + 128 bounds + 4 id), the runs (56), the merge (40) and
# dist4's shard files (1,156, as the index file)
OOC_BYTES_PER_SERIES = 1024 + 1156 + 56 + 40 + 1156
OOC_SHARDS, OOC_WORKERS = 4, 2     # the build's pass-1 shards, its threads
OOC_CACHE_BLOCKS = 64              # the one-shot walk's block cache
OOC_SETTINGS = ((1, 1), (4, 8))    # (pipeline_depth, group_blocks)
OOC_COMPARE_BLOCKS = 256           # blocks a step of the raw comparison
DIST_WORLD = 4                     # dist4's ranks, all on the one card
DIST1_BACKEND = "nccl"             # dist1's world-size-1 group
DIST_TIMEOUT_S = 300               # a collective's (or a tenant's) limit
DIST_RANKS_TIMEOUT_S = 600         # dist4's ranks, spawn to exit
SERVE_TENANTS, SERVE_BATCH, SERVE_K = 4, 25, 10   # launch.serve's traffic
SANITIZE_ROWS = 1_000_000          # the sanitize phase's build and walks
SANITIZE_TENANTS, SANITIZE_BATCH = 4, 4
SERVE_DEADLINE = 8                 # the anytime answer's refine budget
SERVE_CLI_K = 1                    # the CLI's k: its near-data queries prune
WALK_PIPELINE = OOC_SETTINGS[1]    # serve's and dist_ooc's (depth, group)

# the kernels each search path must launch (the build's isax_summarize
# is checked on its own)
PATH_KERNELS = {
    "block_major": ("lb_scan", "block_topk", "fused_panel_topk"),
    "query_major": ("lb_scan", "block_topk"),
    "flat": ("lb_scan", "block_topk", "batch_l2"),
    "ucr": ("batch_l2",),
    "dtw": ("lb_scan", "block_topk", "dtw_band_panel"),
    "lm": ("ssm_scan",),
    "hybrid_train": ("ssm_scan", "ssm_scan_bwd"),
}

# the substring of each kernel's symbol the profiler's device events carry
SYMBOL = {"isax_summarize": "isax_summarize", "lb_scan": "lb_scan",
          "block_topk": "block_topk", "fused_panel_topk": "fused_panel_topk",
          "batch_l2": "batch_l2", "dtw_band_panel": "dtw_band",
          "ssm_scan": "ssm_scan", "ssm_scan_bwd": "ssm_scan_bwd"}

FAILURES: list[str] = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> bool:
    if not ok:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
    return ok


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn``, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled(fn, reps: int, warmup: int) -> list:
    """The device events of ``reps`` back-to-back calls of ``fn`` under
    ``torch.profiler`` (CUDA activity only).  The profiler now and then
    records no device event at all in a window; such a window is taken
    again, up to three times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    return events


def device_ms(fn, symbol: str, reps: int = 20, warmup: int = 3) -> float:
    """The kernel's own device milliseconds per launch: ``torch.profiler``
    over the same back-to-back calls ``time_cuda`` runs, summed over the
    device events whose name holds ``symbol``, over their count.  Host time
    between launches is not in it."""
    hits = [e for e in _profiled(fn, reps, warmup) if symbol in e.key]
    count = sum(e.count for e in hits)
    # the profiler may drop a launch at the start of its window: the mean
    # is over the launches it saw
    if not check(0 < count <= reps, f"profiler saw {count} launches of "
                                    f"{symbol} in {reps} calls"):
        return float("nan")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def device_ms_all(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``, summed over every device
    event it launches (a library call may launch several kernels), over
    the same back-to-back calls."""
    total = sum(e.self_device_time_total
                for e in _profiled(fn, reps, warmup))
    check(total > 0, "the profiler saw device time of a library call")
    return total / reps / 1e3


def random_walk_cuda(n_series: int, length: int, seed: int,
                     chunk: int = 1 << 20) -> torch.Tensor:
    """The paper's Synthetic generator on the card: cumsum of N(0,1) steps."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = torch.empty((n_series, length), dtype=torch.float32, device="cuda")
    for i in range(0, n_series, chunk):
        j = min(i + chunk, n_series)
        steps = torch.randn((j - i, length), generator=g, device="cuda")
        torch.cumsum(steps, dim=1, out=out[i:j])
    return out


def stats_line(res, secs: float) -> dict:
    st = res.stats
    return {"query_seconds": secs,
            "blocks_visited_mean": st.blocks_visited.float().mean().item(),
            "blocks_visited_max": int(st.blocks_visited.max()),
            "series_refined_mean": st.series_refined.float().mean().item(),
            "lb_series_mean": st.lb_series.float().mean().item(),
            "iters": int(st.iters)}


def run_path(name: str, fn, ks=(1, 10)) -> tuple[dict, dict, dict]:
    """Run one search path for each k with the launch counts set to 0
    just before and read just after.  -> ({k: (result, seconds)},
    {k: stats line}, launches)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    results = {}
    for k in ks:
        t0 = time.perf_counter()
        res = fn(k)
        torch.cuda.synchronize()
        results[k] = (res, time.perf_counter() - t0)
    launches = ops.launch_counts()
    lines = {}
    for k, (res, secs) in results.items():
        lines[f"k{k}"] = stats_line(res, secs)
        check(bool(torch.isfinite(res.dist).all())
              and tuple(res.idx.shape) == (res.dist.shape[0], k)
              and bool((res.idx >= 0).all()),
              f"{name} k={k}: finite distances of shape (Q, k) with real ids")
    for kernel in PATH_KERNELS[name]:
        check(launches[kernel] > 0, f"kernel {kernel} launched on the "
                                    f"{name} path")
    return results, lines, launches


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = nvidia_smi_line()
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", **dev, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    kern = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": kern.build_seconds, "library": str(kern.path),
          "ptxas": {stem: _build.ptxas_summary(log)
                    for stem, log in sorted(kern.ptxas_log.items())}})


def phase_main(args, raw: torch.Tensor, queries: torch.Tensor):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    t0 = time.perf_counter()
    index = core.build(raw, capacity=CAPACITY)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    results, lines, launches = run_path(
        "block_major", lambda k: core.search_block_major(index, queries, k=k))
    launches["isax_summarize"] = build_launches["isax_summarize"]
    check(launches["isax_summarize"] > 0,
          "kernel isax_summarize launched on the block_major path")

    resident = sum(t.numel() * t.element_size() for t in
                   (index.raw, index.slo, index.shi, index.elo, index.ehi,
                    index.ids))
    emit({"phase": "main", "n_series": args.n_series, "length": LENGTH,
          "capacity": CAPACITY, "n_blocks": index.n_blocks,
          "queries": args.queries, "build_seconds": build_s,
          "index_bytes": resident,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, **lines})
    return index, results, launches


def phase_schedules(index, queries) -> tuple[dict, dict]:
    """Query-major and flat ED on the main path's index and queries."""
    torch.cuda.reset_peak_memory_stats()
    out, launches = {}, {}
    paths = {"query_major": lambda k: core.search(index, queries, k=k),
             "flat": lambda k: core.search_paris(index, queries, k=k,
                                                 chunk=FLAT_CHUNK)}
    line = {"phase": "schedules", "queries": queries.shape[0],
            "flat_chunk": FLAT_CHUNK}
    for name, fn in paths.items():
        out[name], lines, launches[name] = run_path(name, fn)
        line[name] = {"launches": launches[name], **lines}
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(line)
    return out, launches


def phase_ucr(raw, queries) -> tuple[dict, dict]:
    results, lines, launches = run_path(
        "ucr", lambda k: core.search_scan(raw, queries, k=k), ks=(10,))
    emit({"phase": "ucr", "queries": queries.shape[0],
          "chunk": 4096, "launches": launches, **lines})
    return results, launches


def _dtw_scan(raw, q, kmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded DTW of the z-normed queries against every series: the
    kernel on shared chunks of z-normed series, merged with the plain
    (dist, id)-lex top-k."""
    qn = q.shape[0]
    best_d = torch.full((qn, kmax), ref.INF, device=q.device)
    best_i = torch.full((qn, kmax), -1, dtype=torch.int32, device=q.device)
    for i in range(0, raw.shape[0], SCAN_CHUNK):
        j = min(i + SCAN_CHUNK, raw.shape[0])
        d = dtw_band_panel(q, isax.znorm(raw[i:j]), r=DTW_R)
        ids = torch.arange(i, j, dtype=torch.int32,
                           device=q.device).expand(qn, -1)
        cd, ci = ref.topk_by_dist_id(d, ids, kmax)
        best_d, best_i = ref.topk_by_dist_id(torch.cat([best_d, cd], 1),
                                             torch.cat([best_i, ci], 1), kmax)
    return best_d, best_i


def phase_dtw(index, raw, queries, n_main: int) -> tuple[dict, dict]:
    """search_dtw on the same index, checked against a full DTW scan."""
    results, lines, launches = run_path(
        "dtw", lambda k: dtw.search_dtw(index, queries, r=DTW_R, k=k))
    q = isax.znorm(queries)
    t0 = time.perf_counter()
    want_d, want_i = _dtw_scan(raw, q, max(results))
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    line = {"phase": "dtw", "r": DTW_R, "queries": q.shape[0],
            "cut": f"queries cut from {n_main} to {q.shape[0]} for the "
                   "time limit",
            "launches": launches, "scan_seconds": scan_s,
            "tolerance": f"squared DTW within {DIST_REL} relative; ids "
                         "equal but at near ties", **lines}
    for k, (res, _) in results.items():
        got_i = res.idx
        got_d = res.dist.double() ** 2
        wd = want_d[:, :k].double()
        tol = DIST_REL * wd + 1e-6
        dist_ok = bool(((got_d - wd).abs() <= tol).all())
        diff = got_i != want_i[:, :k]
        ties_ok = True
        if bool(diff.any()):
            # the plain banded DTW of every id the walk returned
            x = isax.znorm(raw[got_i.long().flatten()]).reshape(
                got_i.shape + (raw.shape[1],))
            dk = ref.dtw_band_panel_ref(q, x, r=DTW_R).double()
            ties_ok = bool(((dk - wd).abs() <= tol)[diff].all())
        line[f"k{k}"]["ids_equal"] = int((~diff).sum())
        line[f"k{k}"]["near_ties"] = int(diff.sum())
        check(dist_ok and ties_ok, f"dtw k={k}: search_dtw equals the full "
                                   "DTW scan (ids, but near ties)")
    emit(line)
    return results, launches


def lm_setup(seed: int, batch: int, prompt_len: int, smoke: bool = False):
    """Hymba's config, its parameters on the card from ``seed``, and
    ``batch`` prompts of ``prompt_len`` random tokens from ``seed + 2``."""
    cfg = get_config(LM_ARCH, smoke=smoke)
    params = serve.build_params(cfg, seed)
    dev = params["embed"].device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=dev)
    return cfg, params, prompt


def serving_consistency(label: str, out, full, s_p: int, gen: int, b: int,
                        vocab: int) -> dict:
    """Served logits (prefill, then each decode step) against the
    teacher-forced forward ``full`` over prompt and generated tokens:
    within LOGIT_REL of the logits' scale, and every greedy token with a
    top-2 gap above that tolerance the forward's argmax."""
    want = full[:, s_p - 1:s_p + gen - 1]
    scale = float(want.abs().max())
    tol = LOGIT_REL * scale
    err = float((out.logits - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    greedy = torch.argmax(want, dim=-1)
    tok_ok = torch.equal(out.tokens[clear], greedy[clear])
    check(err <= tol, f"{label}: serving logits within {LOGIT_REL} x "
                      f"max|logit| ({tol:.3g}) of the forward's, got "
                      f"{err:.3g}")
    check(tok_ok, f"{label}: every greedy token with a top-2 gap above the "
                  "tolerance is the forward's argmax")
    finite = bool(torch.isfinite(out.logits).all()) and bool(
        torch.isfinite(full).all())
    check(finite, f"{label}: every logit finite")
    check(tuple(out.tokens.shape) == (b, gen)
          and tuple(out.logits.shape) == (b, gen, vocab),
          f"{label}: tokens (B, gen) and logits (B, gen, V)")
    return {"max_abs_err": err, "logit_scale": scale, "tolerance": tol,
            "clear_tokens": int(clear.sum()),
            "tokens_equal": int((out.tokens == greedy).sum()),
            "compared_positions": [s_p - 1, s_p + gen - 2]}


def phase_lm(args) -> tuple[dict, dict]:
    """Hymba serving through the user's entry points, its consistency with
    the teacher-forced forward, and layer 0's mixer against its oracle.
    -> (launches, layer 0's scan inputs for the kernels phase)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b, s_p, gen = args.lm_batch, args.lm_prompt, args.lm_gen
    cfg, params, prompt = lm_setup(args.seed, b, s_p, args.lm_smoke)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tensors = [t for _, t in common.leaves(params)]
    n_params = sum(t.numel() for t in tensors)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = serve.greedy_generate(params, cfg, prompt, gen)
    launches = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    mixer_calls = cfg.n_layers * gen        # one per layer: the prefill, then
    check(launches["ssm_scan"] == mixer_calls,   # each of the gen-1 steps
          f"lm: ssm_scan launched {launches['ssm_scan']} times, once per "
          f"mamba_mix call ({mixer_calls})")

    # 1. serving against the teacher-forced forward over the same tokens
    t0 = time.perf_counter()
    seq = torch.cat([prompt, out.tokens], dim=1)
    full = transformer.forward(params, {"tokens": seq}, cfg)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    consistency = serving_consistency("lm", out, full, s_p, gen, b,
                                      cfg.vocab)

    # 2. layer 0's mixer on its real input: kernel against the plain oracle
    p0 = transformer._layer(params["layers"], 0)
    x = transformer.embed_inputs(params, prompt, cfg)
    h = common.rmsnorm(x, p0["ln1"])
    with torch.no_grad():
        got, gst = mamba.mamba_mix(h, p0["mamba"], d_inner=cfg.q_dim)
        t0 = time.perf_counter()
        ref_out, rst = mamba.mamba_naive(h, p0["mamba"], d_inner=cfg.q_dim)
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t0
        xc, _, _ = mamba._mixer_in(h @ p0["mamba"]["w_in"], p0["mamba"],
                                   cfg.q_dim, None)
        dt, bt, ct, a_mat = mamba._dt_bc(xc, p0["mamba"])
    mix_err = max(float((got - ref_out).abs().max()),
                  float((gst.h - rst.h).abs().max()))
    mix_ok = (torch.allclose(got, ref_out, rtol=MIX_TOL, atol=MIX_TOL)
              and torch.allclose(gst.h, rst.h, rtol=MIX_TOL, atol=MIX_TOL))
    check(mix_ok, f"lm: layer 0 mamba_mix (ssm_scan kernel) within "
                  f"{MIX_TOL} of mamba_naive")
    n_dec = max(gen - 1, 1)
    emit({"phase": "lm", "arch": cfg.name, "smoke_config": args.lm_smoke,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": n_params, "count_params": count_params(cfg),
          "param_bytes": sum(t.numel() * t.element_size() for t in tensors),
          "param_build_seconds": build_s, "batch": b, "prompt": s_p,
          "gen": gen, "positions_with_meta": cfg.meta_tokens + s_p + gen,
          "prefill_seconds": out.prefill_s,
          "decode_ms_per_token": out.decode_s * 1e3 / n_dec,
          "launches": launches, "ssm_scan_per_call": cfg.n_layers,
          "max_memory_allocated_serving": serve_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "forward_seconds": forward_s,
          "consistency": consistency,
          "mixer_vs_naive": {"max_abs_err": mix_err, "match": mix_ok,
                             "naive_seconds": naive_s,
                             "tolerance": f"rtol and atol {MIX_TOL}"},
          "sample_tokens": out.tokens[0, :16].tolist()})
    scan_in = {"xc": xc.contiguous(), "dt": dt.contiguous(),
               "bm": bt.contiguous(), "cm": ct.contiguous(),
               "a": a_mat.contiguous(), "h_last": gst.h}
    return launches, scan_in


def _serve_model(label: str, cfg, seed: int, b: int, s_p: int, gen: int,
                 frames: int = 0) -> dict:
    """One model served through ``greedy_generate`` from fp32 weights built
    from ``seed`` (prompts from ``seed + 2``; an enc_dec model's ``frames``
    frame embeddings N(0, 0.1) from ``seed + 3``), checked against the
    teacher-forced forward; no custom kernel may launch.  -> its entry."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serve.build_params(cfg, seed)
    dev = params["embed"].device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab, (b, s_p), generator=g, device=dev)
    fr = None
    if cfg.enc_dec:
        g.manual_seed(seed + 3)
        fr = 0.1 * torch.randn((b, frames, cfg.d_model), generator=g,
                               device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tensors = [t for _, t in common.leaves(params)]

    ops.reset_launch_counts()
    out = serve.greedy_generate(params, cfg, prompt, gen, frames=fr)
    launches = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    check(not any(launches.values()),
          f"{label}: no custom kernel on this path, got {launches}")
    seq = torch.cat([prompt, out.tokens], dim=1)
    batch = {"frames": fr, "dec_tokens": seq} if cfg.enc_dec \
        else {"tokens": seq}
    t0 = time.perf_counter()
    full = transformer.forward(params, batch, cfg)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    consistency = serving_consistency(label, out, full, s_p, gen, b,
                                      cfg.vocab)
    entry = {"arch": cfg.name, "family": cfg.family,
             "layers": cfg.n_layers, "d_model": cfg.d_model,
             "params": sum(t.numel() for t in tensors),
             "count_params": count_params(cfg),
             "param_bytes": sum(t.numel() * t.element_size()
                                for t in tensors),
             "param_build_seconds": build_s, "batch": b, "prompt": s_p,
             "gen": gen, "prefill_seconds": out.prefill_s,
             "decode_ms_per_token": out.decode_s * 1e3 / max(gen - 1, 1),
             "forward_seconds": forward_s, "launches": launches,
             "max_memory_allocated_serving": serve_peak,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "consistency": consistency,
             "sample_tokens": out.tokens[0, :16].tolist()}
    if cfg.enc_dec:
        entry["frames"] = frames
    elif cfg.family != "ssm":
        entry["segments"] = [[sg.kind, sg.start, sg.end]
                             for sg in transformer.segments(cfg)]
    return entry, params, batch


def phase_dense(args) -> dict:
    """The dense family served at full width (gemma3 at a cut depth).
    -> launches over both runs (all zero)."""
    t0 = time.perf_counter()
    runs = []
    for arch, layers, b, s_p, gen in DENSE_RUNS:
        cfg = get_config(arch, smoke=args.lm_smoke)
        if args.lm_smoke:
            b, s_p, gen = b // 2 or 1, args.lm_prompt, args.lm_gen
        elif layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        runs.append(_serve_model(f"dense {cfg.name}", cfg, args.seed, b,
                                 s_p, gen)[0])
        torch.cuda.empty_cache()
    emit({"phase": "dense", "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0,
          "smoke_config": args.lm_smoke, "runs": runs,
          "custom_kernel_launches": sum(sum(r["launches"].values())
                                        for r in runs)})
    return {k: sum(r["launches"][k] for r in runs)
            for k in runs[0]["launches"]}


def _last_loss_lines(text: str) -> list[float]:
    return [float(line.split()[3]) for line in text.splitlines()
            if line.startswith("step ") and " loss " in line]


def _train_example(args) -> dict:
    """``python -m repro_torch.examples.train_lm --steps 40`` on the card,
    as a user runs it: exit 0, a resume, and a falling loss."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.examples.train_lm",
                        "--steps", "40"], cwd=ROOT, env=env,
                       capture_output=True, text=True,
                       timeout=EXAMPLE_TIMEOUT_S)
    secs = time.perf_counter() - t0
    first, _, resumed = r.stdout.partition("[resume]")
    a, b = _last_loss_lines(first), _last_loss_lines(resumed)
    ok = (r.returncode == 0 and bool(resumed) and bool(a) and bool(b)
          and b[-1] < a[0])
    check(ok, f"train: the train_lm example exits 0, resumes and ends "
              f"below its first loss (rc {r.returncode}, losses {a} / {b}; "
              f"stderr {r.stderr[-2000:]!r})")
    return {"seconds": secs, "returncode": r.returncode,
            "resumed": bool(resumed), "first_loss": a[0] if a else None,
            "resumed_last_loss": b[-1] if b else None}


def _card_vs_cpu_step(seed: int, card: str = "cuda",
                      arch: str = TRAIN_ARCH, **overrides) -> dict:
    """One smoke() train step (``overrides`` on the config) on the card and
    one on the CPU from the same parameters and batch (the training CLI's
    batch of 8 x 256 from ``seed``)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    host = serve.build_params(cfg, seed, "cpu")
    batch = launch_train.make_batch_fn(cfg, 8, 256, seed)(0)
    out = {}
    for where, params in (("card", common.tree_map(
            lambda t: t.to(card, copy=True), host)), ("cpu", host)):
        step = make_train_step(cfg, microbatch=1,
                               device=card if where == "card" else "cpu")
        _, _, m = step(params, opt_init(cfg.optimizer, params), batch)
        out[where] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in out["cpu"]}
    check(max(rel.values()) <= CARD_CPU_REL,
          f"{arch}: a smoke() step on the card within {CARD_CPU_REL} of the "
          f"CPU's (loss, grad norm), got {rel}")
    return {**out, "rel_err": rel}


def phase_train(args) -> dict:
    """Dense training at full width: fp32 AdamW steps of h2o-danube-1.8b
    on one batch, their checks and times; the smoke config's step on the
    card against the CPU; the train_lm example.  -> launches (all zero)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH, smoke=args.lm_smoke)
    b, s = (TRAIN_BATCH, 64) if args.lm_smoke else (TRAIN_BATCH, TRAIN_SEQ)
    t0 = time.perf_counter()
    params = serve.build_params(cfg, args.seed)
    opt = opt_init(cfg.optimizer, params)
    batch = next(synthetic_token_batches(batch=b, seq_len=s, vocab=cfg.vocab,
                                         seed=args.seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in common.leaves(params))

    ops.reset_launch_counts()
    eval_loss = float(make_eval_step(cfg)(params, batch)["loss"])
    step = make_train_step(cfg, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=100)
    secs, mets = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in mets]
    finite = all(np.isfinite([m["loss"], m["grad_norm"]]).all()
                 for m in mets)
    check(finite, f"train: every loss and gradient norm finite ({mets})")
    check(all(m["skipped"] == 0 for m in mets), "train: no step skipped")
    check(losses[-1] < losses[0], f"train: the last loss below the first "
                                  f"({losses})")
    eval_rel = abs(losses[0] - eval_loss) / abs(eval_loss)
    check(eval_rel <= EVAL_REL, f"train: step 1's loss within {EVAL_REL} "
                                f"of make_eval_step's, got {eval_rel:.3g}")
    check(not any(launches.values()),
          f"train: no custom kernel on the training path, got {launches}")
    del params, opt
    torch.cuda.empty_cache()

    step_s = float(np.median(secs[1:]))
    flops = 6.0 * n_params * b * s
    card_vs_cpu = _card_vs_cpu_step(args.seed)
    example = _train_example(args)
    emit({"phase": "train", "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t_phase,
          "arch": cfg.name, "smoke_config": args.lm_smoke,
          "optimizer": cfg.optimizer, "remat": cfg.remat, "batch": b,
          "seq": s, "steps": TRAIN_STEPS, "params": n_params,
          "param_build_seconds": build_s, "step_seconds": secs,
          "step_seconds_median_2_to_last": step_s,
          "tokens_per_second": b * s / step_s,
          "model_flops_per_step_6ND": flops,
          "fp32_peak_flops": FP32[0],
          "fp32_peak_share": flops / step_s / FP32[0],
          "max_memory_allocated": peak, "losses": losses,
          "grad_norms": [m["grad_norm"] for m in mets],
          "lr": [m["lr"] for m in mets],
          "eval_loss_initial": eval_loss, "eval_rel_err": eval_rel,
          "launches": launches,
          "custom_kernel_launches": sum(launches.values()),
          "card_vs_cpu_smoke_step": card_vs_cpu,
          "train_lm_example": example})
    return launches


def _param_bytes(cfg) -> int:
    """fp32 bytes of ``cfg``'s parameters, from its specs."""
    return 4 * sum(int(np.prod(sp.shape)) for _, sp in
                   common.leaves(transformer.param_specs(cfg)))


def _fit_depth(cfg, layers):
    """``cfg`` cut to ``layers`` (None: all), then further to what fits in
    the card's free memory beside FAMILY_HEADROOM_BYTES of activations.
    -> (cfg, the reason of a cut or None)."""
    full = cfg.n_layers
    free, _ = torch.cuda.mem_get_info()
    fixed = _param_bytes(dataclasses.replace(cfg, n_layers=0))
    per_layer = _param_bytes(dataclasses.replace(cfg, n_layers=1)) - fixed
    fit = max(1, int((free - FAMILY_HEADROOM_BYTES - fixed) // per_layer))
    want = layers or full
    if fit < want:
        return dataclasses.replace(cfg, n_layers=fit), (
            f"{full} -> {fit} layers: {free / 2**30:.1f} GiB free beside the "
            f"search data, {per_layer / 2**30:.2f} GiB of fp32 weights a "
            "layer")
    if want < full:
        return dataclasses.replace(cfg, n_layers=want), (
            f"{full} -> {want} layers: all {full} are "
            f"{(fixed + full * per_layer) / 2**30:.1f} GiB of fp32 weights, "
            "more than the card holds beside the search data")
    return cfg, None


def _family_train(args) -> dict:
    """granite-moe-1b-a400m full(): fp32 steps with its optimizer on one
    batch, under ``train``'s checks; moe_lb and moe_drop of each step."""
    cfg = get_config(FAMILY_TRAIN_ARCH, smoke=args.lm_smoke)
    b, s = (TRAIN_BATCH, 64) if args.lm_smoke else (TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = serve.build_params(cfg, args.seed)
    opt = opt_init(cfg.optimizer, params)
    batch = next(synthetic_token_batches(batch=b, seq_len=s, vocab=cfg.vocab,
                                         seed=args.seed))
    n_params = sum(t.numel() for _, t in common.leaves(params))
    eval_loss = float(make_eval_step(cfg)(params, batch)["loss"])
    # one microbatch: capacity is computed per call, so step 1's loss is
    # make_eval_step's on the same 2 x S tokens only without a split
    step = make_train_step(cfg, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=100, microbatch=1)
    secs, mets = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
    losses = [m["loss"] for m in mets]
    label = f"families train {cfg.name}"
    check(all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in mets),
          f"{label}: every loss and gradient norm finite ({mets})")
    check(all(m["skipped"] == 0 for m in mets), f"{label}: no step skipped")
    check(losses[-1] < losses[0], f"{label}: the last loss below the first "
                                  f"({losses})")
    eval_rel = abs(losses[0] - eval_loss) / abs(eval_loss)
    check(eval_rel <= EVAL_REL, f"{label}: step 1's loss within {EVAL_REL} "
                                f"of make_eval_step's, got {eval_rel:.3g}")
    step_s = float(np.median(secs[1:]))
    out = {"arch": cfg.name, "optimizer": cfg.optimizer, "remat": cfg.remat,
           "capacity_factor": cfg.capacity_factor, "microbatch": 1,
           "batch": b, "seq": s, "steps": TRAIN_STEPS, "params": n_params,
           "step_seconds": secs, "step_seconds_median_2_to_last": step_s,
           "tokens_per_second": b * s / step_s, "losses": losses,
           "grad_norms": [m["grad_norm"] for m in mets],
           "moe_lb": [m["moe_lb"] for m in mets],
           "moe_drop": [m["moe_drop"] for m in mets],
           "eval_loss_initial": eval_loss, "eval_rel_err": eval_rel,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del params, opt
    torch.cuda.empty_cache()
    return out


def phase_families(args) -> dict:
    """The MoE, RWKV and Whisper families served (granite-moe and whisper
    in full, moonshot at its widths cut in depth, rwkv6 in full where it
    fits) and trained (granite-moe in full; a smoke() step of each family
    on the card against the CPU).  -> launches (all zero, checked)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    runs = []
    for arch, layers, b, s_p, gen in FAMILY_RUNS:
        cfg, cut = get_config(arch, smoke=args.lm_smoke), None
        frames = WHISPER_FRAMES
        if args.lm_smoke:
            b, s_p, gen, frames = 2, args.lm_prompt, args.lm_gen, \
                args.lm_prompt
            if cfg.enc_dec:
                s_p = min(s_p, cfg.decoder_len // 2)
                gen = min(gen, cfg.decoder_len - s_p)
        else:
            cfg, cut = _fit_depth(cfg, layers)
        label = f"families {cfg.name}"
        serve_cfg = cfg
        if cfg.n_experts:
            serve_cfg = dataclasses.replace(cfg,
                                            capacity_factor=MOE_SERVE_CF)
        entry, params, batch = _serve_model(label, serve_cfg, args.seed, b,
                                            s_p, gen, frames)
        entry["depth_cut"] = cut
        if cfg.n_experts:
            # the config's capacity over the same prompt + generated tokens
            m = make_eval_step(cfg)(params, batch)
            entry["serve_capacity_factor"] = MOE_SERVE_CF
            entry["config_capacity_factor"] = {
                "capacity_factor": cfg.capacity_factor,
                "tokens": int(batch["tokens"].numel()),
                "moe_lb_sum": float(m["moe_lb"]),
                "dropped_frac_sum": float(m["moe_drop"]),
                "dropped_frac": float(m["moe_drop"]) / cfg.n_layers,
                "ce": float(m["ce"])}
            check(0.0 <= entry["config_capacity_factor"]["dropped_frac"]
                  < 1.0, f"{label}: dropped_frac at the config's capacity "
                         "in [0, 1)")
        runs.append(entry)
        del params, batch
        torch.cuda.empty_cache()
    train = _family_train(args)
    card_vs_cpu = {arch: _card_vs_cpu_step(
        args.seed, arch=arch,
        **({"capacity_factor": MOE_SERVE_CF}
           if get_config(arch, smoke=True).n_experts else {}))
        for arch in FAMILY_CARD_CPU}
    launches = ops.launch_counts()
    check(not any(launches.values()),
          f"families: no custom kernel on these paths, got {launches}")
    emit({"phase": "families", "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t_phase,
          "smoke_config": args.lm_smoke, "runs": runs, "train": train,
          "card_vs_cpu_smoke_step": card_vs_cpu, "launches": launches,
          "custom_kernel_launches": sum(launches.values())})
    return launches


def _layer0_scan_inputs(params, tokens, cfg) -> dict:
    """Layer 0's scan operands on ``tokens`` (the meta prefix included),
    as ``mamba_mix`` forms them, without autograd."""
    with torch.no_grad():
        p0 = transformer._layer(params["layers"], 0)
        x = transformer.embed_inputs(params, tokens, cfg)
        h = common.rmsnorm(x, p0["ln1"])
        xc, _, _ = mamba._mixer_in(h @ p0["mamba"]["w_in"], p0["mamba"],
                                   cfg.q_dim, None)
        dt, bt, ct, a_mat = mamba._dt_bc(xc, p0["mamba"])
    return {"xc": xc.contiguous(), "dt": dt.contiguous(),
            "bm": bt.contiguous(), "cm": ct.contiguous(),
            "a": a_mat.contiguous()}


def phase_hybrid_train(args) -> tuple[dict, dict]:
    """Hymba trained at full width through the scan's two kernels, under
    ``train``'s checks, each step's launches counted.  -> (launches over
    the steps, layer 0's scan operands at the training shape for the
    kernels phase)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(HYBRID_ARCH, smoke=args.lm_smoke)
    b, s = (TRAIN_BATCH, 64) if args.lm_smoke else (TRAIN_BATCH, TRAIN_SEQ)
    t0 = time.perf_counter()
    params = serve.build_params(cfg, args.seed)
    opt = opt_init(cfg.optimizer, params)
    batch = next(synthetic_token_batches(batch=b, seq_len=s, vocab=cfg.vocab,
                                         seed=args.seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in common.leaves(params))
    eval_loss = float(make_eval_step(cfg)(params, batch)["loss"])
    step = make_train_step(cfg, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=100)
    secs, mets, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(ops.launch_counts())
        mets.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    launches = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    label = f"hybrid_train {cfg.name}"
    losses = [m["loss"] for m in mets]
    check(all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in mets),
          f"{label}: every loss and gradient norm finite ({mets})")
    check(all(m["skipped"] == 0 for m in mets), f"{label}: no step skipped")
    check(losses[-1] < losses[0], f"{label}: the last loss below the first "
                                  f"({losses})")
    eval_rel = abs(losses[0] - eval_loss) / abs(eval_loss)
    check(eval_rel <= EVAL_REL, f"{label}: step 1's loss within {EVAL_REL} "
                                f"of make_eval_step's, got {eval_rel:.3g}")
    # a checkpointed layer runs its forward again in the backward
    fwd = 2 if cfg.remat != "none" else 1
    want = {k: 0 for k in per_step[0]}
    want.update(ssm_scan=fwd * cfg.n_layers, ssm_scan_bwd=cfg.n_layers)
    check(all(c == want for c in per_step),
          f"{label}: each step launched ssm_scan {fwd} time(s) a layer and "
          f"ssm_scan_bwd once a layer, nothing else ({per_step})")
    scan_in = _layer0_scan_inputs(params, torch.as_tensor(
        batch["tokens"], device=params["embed"].device), cfg)
    del params, opt
    torch.cuda.empty_cache()
    step_s = float(np.median(secs[1:]))
    flops = 6.0 * n_params * b * s
    card_vs_cpu = _card_vs_cpu_step(args.seed, arch=HYBRID_ARCH)
    emit({"phase": "hybrid_train", "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t_phase,
          "arch": cfg.name, "smoke_config": args.lm_smoke,
          "optimizer": cfg.optimizer, "remat": cfg.remat, "batch": b,
          "seq": s, "positions_with_meta": cfg.meta_tokens + s,
          "steps": TRAIN_STEPS, "params": n_params,
          "param_build_seconds": build_s, "step_seconds": secs,
          "step_seconds_median_2_to_last": step_s,
          "tokens_per_second": b * s / step_s,
          "model_flops_per_step_6ND": flops,
          "fp32_peak_flops": FP32[0],
          "fp32_peak_share": flops / step_s / FP32[0],
          "max_memory_allocated": peak, "losses": losses,
          "grad_norms": [m["grad_norm"] for m in mets],
          "lr": [m["lr"] for m in mets],
          "eval_loss_initial": eval_loss, "eval_rel_err": eval_rel,
          "launches": launches, "launches_per_step": per_step,
          "card_vs_cpu_smoke_step": card_vs_cpu})
    return launches, scan_in


def _mesh_train(args) -> dict:
    """``launch.train --mesh 2x1`` on gloo ranks sharing the card, as a
    subprocess; its checkpoint after the last step against one process's
    steps over the whole batch in two microbatches (the ranks' per-call
    token counts)."""
    ck = MESH_DIR / "ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", MESH_TRAIN_ARCH, "--smoke", "--batch",
                        str(MESH_BATCH), "--seq", str(MESH_SEQ), "--steps",
                        str(MESH_STEPS), "--lr", "1e-2", "--ckpt-dir",
                        str(ck), "--log-every", "1", "--mesh",
                        f"{MESH_WORLD}x1"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=EXAMPLE_TIMEOUT_S)
    secs = time.perf_counter() - t0
    label = "mesh: launch.train --mesh 2x1"
    if not check(r.returncode == 0, f"{label} exits 0 (rc {r.returncode}; "
                                    f"{r.stderr[-2000:]!r})"):
        return {"seconds": secs, "returncode": r.returncode}
    cfg = get_config(MESH_TRAIN_ARCH, smoke=True)
    # the weights built on the host, as the CLI builds them
    params = common.tree_map(lambda t: t.to(_card()),
                             serve.build_params(cfg, 0, "cpu"))
    opt = opt_init(cfg.optimizer, params)
    one = make_train_step(cfg, base_lr=1e-2, total_steps=MESH_STEPS,
                          warmup=min(100, MESH_STEPS // 10 + 1),
                          microbatch=MESH_WORLD, device=_card())
    next_batch = launch_train.make_batch_fn(cfg, MESH_BATCH, MESH_SEQ, 0)
    for i in range(MESH_STEPS):
        params, opt, m = one(params, opt, next_batch(i))
    back = Checkpointer(str(ck), async_writes=False).restore(
        {"params": params, "opt": opt, "meta": {"step": 0}})
    err = max(float((g - w).abs().max())
              for want, got in ((params, back["params"]),
                                (opt.m, back["opt"].m))
              for (_, w), (_, g) in zip(common.leaves(want),
                                        common.leaves(got)))
    check(err <= MESH_TRAIN_REL and back["meta"]["step"] == MESH_STEPS - 1,
          f"{label}: its parameters and first moments within "
          f"{MESH_TRAIN_REL} of one process's two-microbatch steps, got "
          f"{err:.3g}")
    return {"seconds": secs, "returncode": r.returncode,
            "steps": MESH_STEPS, "batch": MESH_BATCH, "seq": MESH_SEQ,
            "arch": cfg.name,
            "losses_logged": _last_loss_lines(r.stdout),
            "max_abs_err_vs_one_process": err,
            "tolerance": MESH_TRAIN_REL}


def _card() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device())


def _adamw_replay(prev: dict, opt, base_lr: float, steps: int) -> dict:
    """AdamW's update of ``prev`` by the moments in ``opt`` (the state
    after the step), in ``train.optimizer``'s arithmetic: a mesh's
    parameters are held to the update of its own moments, since with eps
    1e-8 an element whose gradient lies within a few eps of 0 moves its
    update by O(1) under any other summation order."""
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.01
    t = opt.step.to(torch.float32)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    lr = lr_schedule(opt.step - 1, base_lr=base_lr,
                     warmup=min(100, steps // 10 + 1), total=steps)
    m, v = dict(common.leaves(opt.m)), dict(common.leaves(opt.v))
    out = {}
    for path, p in common.leaves(prev):
        u = (m[path] / bc1) / (torch.sqrt(v[path] / bc2) + eps)
        if p.ndim >= 2:
            u = u + wd * p.to(torch.float32)
        out[path] = (p.to(torch.float32) - lr * u).to(p.dtype)
    return common.with_leaves(prev, out)


def _within(got: dict, want: dict, tol: float, exact: dict | None = None
            ) -> tuple[float, float]:
    """(the largest |got - want| over the leaves, the largest of
    |got - want| / (tol (1 + |want|))): within ``tol`` relative, and
    absolute near 0, where the second is at most 1.  ``exact`` (the same
    step in float64): |got - want| less |want - exact|, what float32
    does not resolve, in the second."""
    worst, ratio = 0.0, 0.0
    ex = dict(common.leaves(exact)) if exact is not None else {}
    for (path, w), (_, g) in zip(common.leaves(want), common.leaves(got)):
        if w.numel():
            d = (g - w).abs()
            worst = max(worst, float(d.max()))
            if path in ex:
                d = d - (w.double() - ex[path]).abs()
            ratio = max(ratio, float((d / (tol * (1 + w.abs()))).max()))
    return worst, ratio


def _model_axis_start(arch, smoke, layers, batch, seq) -> dict:
    """``launch.train --mesh 2x2`` started as a subprocess, a checkpoint
    every step, its output to files."""
    d, m = MODEL_AXIS_MESH
    cfg = get_config(arch, smoke=smoke)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    label = f"mesh: launch.train --mesh {d}x{m} {arch}" + (
        " smoke" if smoke else f" full width, {cfg.n_layers} layers")
    steps, lr = MODEL_AXIS_STEPS, 1e-2
    ck = MESH_DIR / f"ckpt_{arch}"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", arch, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--lr", str(lr), "--ckpt-dir", str(ck),
            "--ckpt-every", "1", "--log-every", "1", "--mesh", f"{d}x{m}"]
    argv += ["--smoke"] if smoke else []
    argv += ["--layers", str(layers)] if layers else []
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out, err = (open(MESH_DIR / f"{arch}.{k}", "w+") for k in ("out", "err"))
    proc = subprocess.Popen([sys.executable, "-m",
                             "repro_torch.launch.train", *argv], cwd=ROOT,
                            env=env, stdout=out, stderr=err, text=True)
    return {"cfg": cfg, "label": label, "ck": ck, "proc": proc, "out": out,
            "err": err, "lr": lr, "steps": steps, "smoke": smoke,
            "batch": batch, "seq": seq, "t0": time.perf_counter(),
            "line": {"arch": arch, "smoke": smoke, "layers": cfg.n_layers,
                     "batch": batch, "seq": seq, "steps": steps}}


def _one_process_step(run: dict, params, opt, i: int,
                      dtype: torch.dtype | None = None):
    """Step ``i`` of one process from ``params`` and ``opt`` (host
    trees), over the whole batch in 2 microbatches, on the card (its
    floating leaves in ``dtype``, else their own) -> (params, state,
    metrics) on the host."""
    cfg, card = run["cfg"], _card()
    to = lambda tree: common.tree_map(
        lambda t: t.to(card, dtype=dtype if dtype and t.is_floating_point()
                       else t.dtype, copy=True), tree)
    params = to(params)
    opt = type(opt)(opt.step.to(card, copy=True), *map(to, opt[1:]))
    step = make_train_step(
        cfg, base_lr=run["lr"], total_steps=run["steps"],
        warmup=min(100, run["steps"] // 10 + 1),
        microbatch=MODEL_AXIS_MESH[0] * (1 if run["smoke"]
                                         else cfg.microbatch), device=card)
    next_batch = launch_train.make_batch_fn(cfg, run["batch"], run["seq"], 0)
    for _ in range(i):                # the stream up to step i's batch
        next_batch(0)
    params, opt, mets = step(params, opt, next_batch(i))
    host = lambda tree: common.tree_map(lambda t: t.cpu(), tree)
    out = (host(params), type(opt)(opt.step.cpu(), *map(host, opt[1:])),
           {k: float(v) for k, v in mets.items()})
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def _check_vocab_blocks(tag: str, rep: dict) -> bool:
    """A rank of the model axis uses its blocks of the vocabulary: its
    plan keeps ``embed`` (and ``lm_head``) local, gathering neither."""
    return check(rep["vocab_leaves"] > 0 and not {"embed", "lm_head"}
                 & set(rep["gathered"]),
                 f"{tag}: uses its vocabulary blocks ({rep['vocab_leaves']} "
                 f"leaves), gathers neither embed nor lm_head "
                 f"({rep['gathered']})")


def _check_model_blocks(tag: str, rep: dict, cfg) -> bool:
    """A rank of the model axis, training or serving, runs every
    attention block on its column blocks, whatever its head counts
    (``ragged_attn`` of them cut a head), Mamba by channel on its
    ``w_in`` block, RWKV by head and by ``ff`` on its ``w_cr`` block:
    none of those leaves is gathered.  A Hymba rank gathers its two
    gammas and nothing else, with its 9 Mamba leaves local; an RWKV rank
    gathers nothing, with its 9 tensor-parallel leaves local."""
    bad = [p for p in rep["gathered"] if "/attn/" in p or "/xattn/" in p
           or p.endswith("/w_in") or p.endswith("/w_cr")]
    ok = check(not bad, f"{tag}: gathers no attention leaf, no w_in and no "
               f"w_cr ({rep['ragged_attn']} ragged attention blocks; "
               f"gathered {rep['gathered']})")
    if cfg.family == "hybrid":
        ok &= check(sorted(rep["gathered"]) == ["layers/attn_gamma",
                                                "layers/mamba_gamma"]
                    and rep["mamba_leaves"] == 9
                    and rep["gathered_leaves"] == 2,
                    f"{tag}: gathers attn_gamma and mamba_gamma only, its 9 "
                    f"Mamba leaves by channel, got {rep['gathered']} and "
                    f"{rep['mamba_leaves']} Mamba leaves")
    if cfg.family == "ssm":
        ok &= check(not rep["gathered"] and rep["rwkv_leaves"] == 9,
                    f"{tag}: gathers nothing, its 9 RWKV leaves by head and "
                    f"by ff, got {rep['gathered']} and {rep['rwkv_leaves']}")
    return ok


def _model_axis_finish(run: dict) -> tuple[dict, dict]:
    """The started run held to one process: each rank's parameter
    elements against the port's specs (held equal to the reference's by
    tests/test_torch_model_axis.py) and, for Hymba, the scan kernels'
    launches a step; then each step against one process's same step
    from the mesh's checkpoint of the step before (step 0: from the
    weights both build on the host): the checkpoint's moments against
    one process's, its parameters against AdamW applied to those moments
    from the step before's, the ranks' loss and gradient norm against
    one process's at the last step.  One process's whole trajectory is
    not the reference: at full width the first update of random weights
    at lr 1e-2 leaves a model whose next gradients move by ~1e-5 under
    the last bits of the first (one process against itself on 1 and 4
    CPU threads).  -> (its line, the kernel launches summed over the
    ranks)."""
    cfg, label, steps, line = run["cfg"], run["label"], run["steps"], \
        run["line"]
    proc = run["proc"]
    try:
        rc = proc.wait(timeout=MODEL_AXIS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    for f in (run["out"], run["err"]):
        f.seek(0)
    stdout, stderr = run["out"].read(), run["err"].read()
    line.update(seconds=time.perf_counter() - run["t0"], returncode=rc)
    if not check(rc == 0, f"{label} exits 0 (rc {rc}; {stderr[-2000:]!r})"):
        return line, {}
    d, m = MODEL_AXIS_MESH
    reps = sorted((json.loads(x[len("[rank] "):]) for x in
                   stdout.splitlines() if x.startswith("[rank] ")),
                  key=lambda x: x["rank"])
    held = launch_specs.held_elements(launch_specs.state_shard_shapes(
        cfg, MeshSpec(MODEL_AXIS_MESH, ("data", "model")))["params"])
    p0 = serve.build_params(cfg, 0, "cpu")
    whole = sum(t.numel() for _, t in common.leaves(p0))
    check(len(reps) == d * m, f"{label}: {d * m} rank reports, got "
                              f"{len(reps)}")
    launches: dict = {}
    for rep in reps:
        tag = f"{label} rank {rep['rank']}"
        check(rep["params_held"] == held,
              f"{tag}: holds {rep['params_held']} parameter elements, the "
              f"specs' {held} of {whole}")
        _check_vocab_blocks(tag, rep)
        _check_model_blocks(tag, rep, cfg)
        per_step = {k: v / steps for k, v in rep["launches"].items() if v}
        if cfg.family == "hybrid":     # a checkpointed layer scans twice
            fwd = 2 if cfg.remat != "none" else 1
            for name, n in (("ssm_scan", fwd * cfg.n_layers),
                            ("ssm_scan_bwd", cfg.n_layers)):
                check(per_step.get(name) == n,
                      f"{tag}: {name} launched {per_step.get(name)} times "
                      f"a step, {n} expected")
        for k, v in rep["launches"].items():
            launches[k] = launches.get(k, 0) + v
        print(json.dumps({"model_axis_rank": {
            "arch": cfg.name, "rank": rep["rank"], "coords": rep["coords"],
            "params_held": rep["params_held"], "params_whole": whole,
            "opt_held": rep["opt_held"],
            "peak_bytes": rep["peak_bytes"], "step_s": rep["step_s"],
            "tp_leaves": rep["tp_leaves"],
            "vocab_leaves": rep["vocab_leaves"],
            "ragged_attn": rep["ragged_attn"],
            "mamba_leaves": rep["mamba_leaves"],
            "rwkv_leaves": rep["rwkv_leaves"],
            "gathered_leaves": rep["gathered_leaves"],
            "launches_per_step": per_step}, "nvidia_smi": nvidia_smi_line()}),
            flush=True)
    params, opt = p0, opt_init(cfg.optimizer, p0)
    errs = []
    for i in range(steps):
        want_p, want, mets = _one_process_step(run, params, opt, i)
        exact = (_one_process_step(run, params, opt, i, torch.float64)[1]
                 if cfg.name in MODEL_AXIS_FP32_ANCHORED else None)
        tree = Checkpointer(str(run["ck"]), async_writes=False).restore(
            {"params": p0, "opt": opt_init(cfg.optimizer, p0),
             "meta": {"step": 0}}, step=i)
        got = tree["opt"]
        m_abs, m_ratio = max(
            *(_within(getattr(got, f), getattr(want, f), MESH_TRAIN_REL,
                      exact and getattr(exact, f)) for f in ("m", "v")),
            key=lambda x: x[1])
        p_abs, _ = _within(tree["params"],
                           _adamw_replay(params, got, run["lr"], steps),
                           MESH_TRAIN_REL)
        check(m_ratio <= 1 and p_abs <= MESH_TRAIN_REL,
              f"{label}: step {i}'s checkpoint: moments within "
              f"{MESH_TRAIN_REL} relative (absolute near 0) of one "
              f"process's step from the step before's"
              + (", beyond its distance from its float64 step"
                 if exact else "") + f", got {m_ratio:.3g} "
              f"of it ({m_abs:.3g} at most); parameters within "
              f"{MESH_TRAIN_REL} of AdamW from its moments, got {p_abs:.3g}")
        errs.append({"moments_abs": m_abs, "moments_of_tolerance": m_ratio,
                     "float64_anchored": exact is not None,
                     "params_abs": p_abs,
                     "params_abs_vs_one_process": _within(
                         tree["params"], want_p, MESH_TRAIN_REL)[0]})
        params, opt = tree["params"], got
    for rep in reps:
        for key in ("loss", "grad_norm"):
            rel = abs(rep[key] / mets[key] - 1)
            check(rel <= MESH_TRAIN_REL,
                  f"{label} rank {rep['rank']}: last step's {key} "
                  f"{rep[key]!r} within {MESH_TRAIN_REL} of one process's "
                  f"{mets[key]!r} (rel {rel:.3g})")
    shutil.rmtree(run["ck"], ignore_errors=True)
    line.update(
        params_whole=whole, params_held_per_rank=held,
        tp_leaves=reps[0]["tp_leaves"],
        vocab_leaves=reps[0]["vocab_leaves"],
        ragged_attn=reps[0]["ragged_attn"],
        mamba_leaves=reps[0]["mamba_leaves"],
        rwkv_leaves=reps[0]["rwkv_leaves"],
        gathered_leaves=reps[0]["gathered_leaves"],
        peak_bytes=[x["peak_bytes"] for x in reps],
        step_s=[x["step_s"] for x in reps],
        loss=[x["loss"] for x in reps], one_process_loss=mets["loss"],
        grad_norm=[x["grad_norm"] for x in reps],
        one_process_grad_norm=mets["grad_norm"], checkpoints=errs,
        tolerance=MESH_TRAIN_REL, launches=launches)
    return line, launches


def _seq_cache_half(cfg, rank: int, slots: int, seed: int, dev):
    """Rank ``rank``'s half of the decode cache (K and V, (1, slots, KVH,
    hd) fp32), from its own seed so one process can rebuild the whole."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed * 1000 + 17 + rank)
    shape = (1, slots, cfg.n_kv_heads, cfg.head_dim)
    return (torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev))


def _seq_query(cfg, seed: int, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed * 1000 + 5)
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    return (torch.randn((1, 1, cfg.n_heads, hd), generator=g, device=dev),
            torch.randn((1, 1, kvh, hd), generator=g, device=dev),
            torch.randn((1, 1, kvh, hd), generator=g, device=dev))


def _seq_rank(rank: int, cfg_d: dict) -> None:
    """One rank of the mesh phase's sequence-sharded decode (a spawned
    process): its half of the cache, a warm-up call, SEQ_CALLS timed
    calls between barriers; the answer and the written slot to
    ``cfg_d["out"]``."""
    import torch.distributed as tdist
    from datetime import timedelta
    dev = torch.device(cfg_d["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group("gloo", init_method=cfg_d["init"],
                             world_size=cfg_d["world"], rank=rank,
                             timeout=timedelta(seconds=DIST_TIMEOUT_S))
    try:
        cfg = get_config(SEQ_ARCH)
        sloc = cfg_d["slots"] // cfg_d["world"]
        k, v = _seq_cache_half(cfg, rank, sloc, cfg_d["seed"], dev)
        q, kn, vn = _seq_query(cfg, cfg_d["seed"], dev)
        pos = cfg_d["pos"]
        call = lambda: attention.decode_attend_seqsharded(q, kn, vn, k, v,
                                                          pos)
        out = call()[0]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        for _ in range(cfg_d["calls"]):
            out = call()[0]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / cfg_d["calls"]
        tdist.barrier()
        lo = rank * sloc
        owner = lo <= pos < lo + sloc
        wrote = bool(torch.equal(k[:, pos - lo], kn[:, 0])
                     and torch.equal(v[:, pos - lo], vn[:, 0])) \
            if owner else None
        np.save(Path(cfg_d["out"]) / f"seq_out{rank}.npy", out.cpu().numpy())
        (Path(cfg_d["out"]) / f"seq_rank{rank}.json").write_text(json.dumps(
            {"rank": rank, "slots": [lo, lo + sloc], "ms_per_call":
             secs * 1e3, "owner": owner, "wrote_new_kv": wrote}))
    finally:
        tdist.destroy_process_group()


def _mesh_seqsharded(args) -> dict:
    """The sequence-sharded decode over the long_500k cache on 2 gloo
    ranks against one process's decode_attend over the whole cache."""
    cfg = get_config(SEQ_ARCH)
    dev = _card()
    cfg_d = {"world": MESH_WORLD, "slots": SEQ_SLOTS, "pos": SEQ_POS,
             "seed": args.seed, "calls": SEQ_CALLS, "out": str(MESH_DIR),
             "init": _group_init("mesh_seq"), "device": str(dev)}
    t0 = time.perf_counter()
    ok = _spawn_ranks(_seq_rank, MESH_WORLD, cfg_d, DIST_RANKS_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    if not ok:
        return {"ranks_seconds": ranks_s}
    infos = [json.loads((MESH_DIR / f"seq_rank{r}.json").read_text())
             for r in range(MESH_WORLD)]
    outs = [torch.from_numpy(np.load(MESH_DIR / f"seq_out{r}.npy"))
            for r in range(MESH_WORLD)]
    sloc = SEQ_SLOTS // MESH_WORLD
    halves = [_seq_cache_half(cfg, r, sloc, args.seed, dev)
              for r in range(MESH_WORLD)]
    k = torch.cat([h[0] for h in halves], dim=1)
    v = torch.cat([h[1] for h in halves], dim=1)
    del halves
    q, kn, vn = _seq_query(cfg, args.seed, dev)
    attention.cache_update(k, v, kn, vn, SEQ_POS)
    want = attention.decode_attend(q, k, v, SEQ_POS)
    one_ms = time_cuda(lambda: attention.decode_attend(q, k, v, SEQ_POS),
                       reps=SEQ_CALLS, warmup=1)
    kv_bytes = 2 * k.numel() * k.element_size()
    del k, v
    torch.cuda.empty_cache()
    errs = [float((o.to(dev) - want).abs().max()) for o in outs]
    tol = SEQ_REL * float(want.abs().max())
    check(max(errs) <= tol, f"mesh: decode_attend_seqsharded on "
                            f"{MESH_WORLD} ranks within {SEQ_REL} x max|want| "
                            f"= {tol:.3g} of one process's decode_attend, "
                            f"got {errs}")
    owners = [i for i in infos if i["owner"]]
    check(len(owners) == 1 and owners[0]["wrote_new_kv"],
          f"mesh: exactly one rank owns slot {SEQ_POS} and wrote the new "
          f"K/V there ({infos})")
    return {"arch": cfg.name, "slots": SEQ_SLOTS, "kv_bytes": kv_bytes,
            "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "pos": SEQ_POS, "world": MESH_WORLD,
            "ranks": infos, "max_abs_err": max(errs), "tolerance": tol,
            "ms_per_call": max(i["ms_per_call"] for i in infos),
            "one_process_ms_per_call": one_ms, "ranks_seconds": ranks_s}


def _serve_runs(seed: int) -> list[dict]:
    """The serving runs of the mesh phase, the same in every rank and in
    the main process: Hymba at full width, then every arch's smoke()."""
    cfg = dataclasses.replace(get_config(MESH_SERVE_ARCH),
                              n_layers=MESH_SERVE_LAYERS)
    runs = [(f"{MESH_SERVE_ARCH} full width, {MESH_SERVE_LAYERS} layers",
             cfg, MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_GEN)]
    for arch in list_archs():
        c = get_config(arch, smoke=True)
        if c.n_experts:
            c = dataclasses.replace(c, capacity_factor=MOE_SERVE_CF)
        runs.append((f"{arch} smoke", c, MODEL_AXIS_MESH[0],
                     MESH_SERVE_SMOKE_PROMPT, MESH_SERVE_SMOKE_GEN))
    out = []
    for i, (label, c, b, prompt, gen) in enumerate(runs):
        rng = np.random.default_rng(seed * 1000 + 31 + i)
        req = {"label": label, "cfg": c, "gen": gen, "frames": None,
               "prompt": rng.integers(0, c.vocab, (b, prompt))}
        if c.enc_dec:
            req["prompt"] = req["prompt"][:, :c.decoder_len - gen]
            req["frames"] = (rng.standard_normal(
                (b, MESH_SERVE_FRAMES, c.d_model)) * 0.1).astype(np.float32)
        out.append(req)
    return out


def _serve_rank(rank: int, cfg_d: dict) -> None:
    """One rank of the serving mesh (a spawned process on the card): the
    (data, model) groups over gloo, then each run of ``_serve_runs``
    through ``greedy_generate(plan=)`` from its shards of the weights
    (built on the host from the seed, as one process builds them), the
    launch counts set to 0 just before and read just after; its logits,
    tokens and a JSON line a run to ``cfg_d["out"]``."""
    import torch.distributed as tdist
    from datetime import timedelta
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import parallel
    dev = torch.device(cfg_d["device"])
    card = dev.type == "cuda"          # the host only in a CPU rehearsal
    if card:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d, m = MODEL_AXIS_MESH
    tdist.init_process_group("gloo", init_method=cfg_d["init"],
                             world_size=d * m, rank=rank,
                             timeout=timedelta(seconds=DIST_TIMEOUT_S))
    try:
        groups = make_mesh((d, m), ("data", "model"), "cpu")
        ms = MeshSpec((d, m), ("data", "model"))
        coords = dict(zip(ms.axis_names, divmod(rank, m)))
        sizes = dict(zip(ms.axis_names, ms.shape))
        reports = []
        for i, req in enumerate(_serve_runs(cfg_d["seed"])):
            cfg = req["cfg"]
            pspecs = launch_specs.param_pspecs(cfg, ms)
            sp = dict(common.leaves(pspecs))
            whole = serve.build_params(cfg, cfg_d["seed"], "cpu")
            params = common.with_leaves(whole, {
                p: common.shard(t, sp[p], coords, sizes).to(dev)
                for p, t in common.leaves(whole)})
            del whole
            plan = parallel.Plan(cfg, pspecs, model=groups.get_group("model"),
                                 data=groups.get_group("data"), mesh=ms,
                                 coords=coords)
            if card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            tdist.barrier()
            ops.reset_launch_counts()
            g = serve.greedy_generate(params, cfg, req["prompt"], req["gen"],
                                      frames=req["frames"], plan=plan,
                                      device=dev)
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            np.save(Path(cfg_d["out"]) / f"serve{i}_r{rank}.npy",
                    g.logits.cpu().numpy())
            reports.append({
                "rank": rank, "coords": coords, "run": i,
                "prefill_s": g.prefill_s, "decode_s": g.decode_s,
                "ms_per_token": g.decode_s / max(req["gen"] - 1, 1) * 1e3,
                "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                               if card else None),
                "launches": launches, "tokens": g.tokens.cpu().tolist(),
                "params_held": sum(t.numel() for _, t in
                                   common.leaves(params)),
                "cache_shapes": [{k: list(t.shape) for k, t in seg.items()}
                                 for seg in g.cache], **plan.counts(),
                "gathered": ["/".join(p) for p in plan.gathered()]})
            del params, g, plan
            if card:
                torch.cuda.empty_cache()
        (Path(cfg_d["out"]) / f"serve_r{rank}.json").write_text(
            json.dumps(reports))
    finally:
        tdist.destroy_process_group()


def _mesh_serve(args) -> tuple[dict, dict]:
    """Serving over the model axis on 4 gloo ranks sharing the card,
    against one process's ``greedy_generate`` on the card.  -> (its line,
    the ranks' kernel launches summed)."""
    d, m = MODEL_AXIS_MESH
    ms = MeshSpec(MODEL_AXIS_MESH, ("data", "model"))
    sizes = dict(zip(ms.axis_names, ms.shape))
    cfg_d = {"seed": args.seed, "out": str(MESH_DIR),
             "init": _group_init("mesh_serve"), "device": str(_card())}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ok = _spawn_ranks(_serve_rank, d * m, cfg_d, MESH_SERVE_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    if not ok:
        return {"ranks_seconds": ranks_s}, {}
    reps = [json.loads((MESH_DIR / f"serve_r{r}.json").read_text())
            for r in range(d * m)]
    launches: dict = {}
    runs = []
    for i, req in enumerate(_serve_runs(args.seed)):
        cfg, label = req["cfg"], f"mesh: serving {req['label']} on {d}x{m}"
        b, gen = req["prompt"].shape[0], req["gen"]
        params = common.tree_map(lambda t: t.to(_card()),
                                 serve.build_params(cfg, args.seed, "cpu"))
        one = serve.greedy_generate(params, cfg, req["prompt"], gen,
                                    frames=req["frames"], device=_card())
        want = one.logits.cpu()
        del params
        max_len = (req["frames"].shape[1] if cfg.enc_dec
                   else req["prompt"].shape[1] + gen)
        lay = launch_specs.serving_specs(cfg, ms, b, max_len)
        held = launch_specs.held_elements(
            launch_specs.state_shard_shapes(cfg, ms)["params"])
        cache = [{k: list(v) for k, v in seg.items()} for seg in
                 launch_specs.cut_cache_shapes(launch_specs.cache_shapes(
                     cfg, b, max_len, torch.float32), lay["decode"], sizes)]
        tol = MESH_SERVE_REL * float(want.abs().max())
        top2 = torch.topk(want, 2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > tol     # (B, gen)
        rows_n = b // d if lay["batch"] else b
        errs, ranks = [], []
        for rep in reps:
            rr = rep[i]
            r = rr["rank"]
            lo = rr["coords"]["data"] * rows_n if lay["batch"] else 0
            got = torch.from_numpy(np.load(MESH_DIR / f"serve{i}_r{r}.npy"))
            w = want[lo:lo + rows_n]
            err = float((got - w).abs().max())
            errs.append(err)
            toks = torch.as_tensor(rr["tokens"])
            same = (toks == one.tokens.cpu()[lo:lo + rows_n]) \
                | ~sure[lo:lo + rows_n]
            check(err <= tol and bool(same.all()),
                  f"{label} rank {r}: logits within {MESH_SERVE_REL} x "
                  f"max|logit| = {tol:.3g} of one process's, got {err:.3g}; "
                  f"tokens equal where the top-2 gap exceeds it")
            check(rr["params_held"] == held and rr["cache_shapes"] == cache,
                  f"{label} rank {r}: holds {rr['params_held']} parameter "
                  f"elements (the specs' {held}) and the decode "
                  f"cache_pspecs blocks")
            _check_vocab_blocks(f"{label} rank {r}", rr)
            _check_model_blocks(f"{label} rank {r}", rr, cfg)
            if cfg.family == "hybrid":     # one scan a layer a call
                n = cfg.n_layers * gen
                check(rr["launches"].get("ssm_scan") == n,
                      f"{label} rank {r}: ssm_scan launched "
                      f"{rr['launches'].get('ssm_scan')} times, {n} "
                      f"expected ({cfg.n_layers} a call)")
            for k, v in rr["launches"].items():
                launches[k] = launches.get(k, 0) + v
            ranks.append({k: rr[k] for k in (
                "rank", "coords", "prefill_s", "ms_per_token", "peak_bytes",
                "launches", "tp_leaves", "vocab_leaves", "ragged_attn",
                "gathered_leaves", "mamba_leaves", "rwkv_leaves")})
        runs.append({"label": req["label"], "batch": b,
                     "prompt": req["prompt"].shape[1], "gen": gen,
                     "kv_shard": lay["kv_shard"], "params_held": held,
                     "max_abs_err": max(errs), "tolerance": tol,
                     "one_process_prefill_s": one.prefill_s,
                     "one_process_ms_per_token":
                         one.decode_s / max(gen - 1, 1) * 1e3,
                     "ranks": ranks})
        del one
        torch.cuda.empty_cache()
    return {"ranks_seconds": ranks_s, "mesh": list(MODEL_AXIS_MESH),
            "runs": runs}, launches


def phase_mesh(args) -> dict:
    """launch.train --mesh Dx1 and 2x2, the sequence-sharded decode and
    serving over the model axis, on the card.  -> the kernel launches of
    the 2x2 runs, summed over their ranks."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    launches: dict = {}
    model_axis = []
    try:
        # the smoke() runs' ranks start while the 2x1 run goes on
        started = [_model_axis_start(*r) for r in MODEL_AXIS_RUNS if r[1]]
        train = _mesh_train(args)
        done = [_model_axis_finish(r) for r in started]
        done += [_model_axis_finish(_model_axis_start(*r))
                 for r in MODEL_AXIS_RUNS if not r[1]]
        for line, counts in done:
            model_axis.append(line)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        seq = _mesh_seqsharded(args)
        serving, counts = _mesh_serve(args)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    emit({"phase": "mesh", "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t_phase, "train_mesh": train,
          "model_axis": model_axis, "decode_seqsharded": seq,
          "serving": serving})
    return launches


def _dryrun(args: list[str], out: Path) -> tuple[list, float, object]:
    """``python -m repro_torch.launch.dryrun ARGS --out OUT`` as a
    subprocess -> (its records, seconds, the completed process)."""
    out.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--out", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True,
                       timeout=ROOFLINE_TIMEOUT_S)
    secs = time.perf_counter() - t0
    recs = ([json.loads(line) for line in out.read_text().splitlines()]
            if out.exists() else [])
    return recs, secs, r


def _measured_line(m: dict, counted: dict) -> dict:
    """One measured cell held to its count; a skipped cell passes only
    if its count (``counted``: kernel calls by name) calls no kernel."""
    label = f"roofline: {m['arch']} {m['shape']} {m['mesh']} {m['dtype']}"
    line = {k: m.get(k) for k in (
        "arch", "shape", "mesh", "dtype", "status", "seconds", "steps_s",
        "first_step_s", "compute_s", "memory_s", "roofline_s", "bottleneck",
        "roofline_share", "predicted_peak_bytes", "measured_peak_bytes",
        "free_bytes", "launches", "counted_calls", "count_s")}
    if not m["status"].startswith("ok"):
        print(f"{label}: {m['status']} ({m['free_bytes'] / 2**30:.2f} GiB "
              f"free)", flush=True)
        check(not counted, f"{label}: measured, since its count calls "
                           f"{sorted(counted)} ({m['status']})")
        return line
    for name in ("ssm_scan", "ssm_scan_bwd"):
        check(m["launches"].get(name, 0) == m["counted_calls"].get(name, 0),
              f"{label}: {name} launches of a step "
              f"{m['launches'].get(name, 0)} equal the counted calls "
              f"{m['counted_calls'].get(name, 0)}")
    check(len(m["steps_s"]) == ROOFLINE_STEPS,
          f"{label}: {ROOFLINE_STEPS} steps timed after the warm-up, got "
          f"{m['steps_s']} (first {m['first_step_s']:.4g} s)")
    check(0 < m["roofline_share"] <= ROOFLINE_SHARE_MAX,
          f"{label}: roofline share {m['roofline_share']:.4g} within "
          f"(0, {ROOFLINE_SHARE_MAX}]")
    return line


def phase_roofline(args) -> dict:
    """Every cell counted per rank of 16x1; ROOFLINE_CELLS measured on
    the card against their counts."""
    t_phase = time.perf_counter()
    ROOFLINE_DIR.mkdir(parents=True, exist_ok=True)
    recs, count_s, r = _dryrun(["--mesh", "16x1"],
                               ROOFLINE_DIR / "roofline.jsonl")
    ok = [x for x in recs if x.get("status") == "ok"]
    check(r.returncode == 0 and len(recs) == 34 and len(ok) == 34,
          f"roofline: dryrun counts 34 cells, status ok (rc {r.returncode}, "
          f"{len(ok)}/{len(recs)} ok; {r.stdout[-1500:]!r} "
          f"{r.stderr[-1500:]!r})")
    check(count_s < ROOFLINE_COUNT_S,
          f"roofline: 34 cells counted in {count_s:.1f} s, under "
          f"{ROOFLINE_COUNT_S}")
    top = lambda key: [[x["arch"], x["shape"], x[key]] for x in sorted(
        ok, key=lambda x: -x[key])[:3]]
    count_line = {"cells": len(recs), "ok": len(ok), "seconds": count_s,
                  "top_compute_s": top("compute_s"),
                  "top_memory_s": top("memory_s")}
    print(json.dumps({"roofline_count": count_line}), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spec = ",".join(":".join(c) for c in ROOFLINE_CELLS)
    mrecs, measure_s, r = _dryrun(["--cells", spec, "--measure", "--seed",
                                   str(args.seed)],
                                  ROOFLINE_DIR / "measured.jsonl")
    cells = []
    for (arch, shape, mesh), rec in zip(ROOFLINE_CELLS, mrecs):
        if check(rec.get("status") == "ok" and "measured" in rec,
                 f"roofline: {arch} {shape} {mesh} measured "
                 f"({rec.get('status')!r}; {r.stdout[-1500:]!r})"):
            cells.append(_measured_line(rec["measured"],
                                        rec["kernel_calls"]))
    check(len(mrecs) == len(ROOFLINE_CELLS),
          f"roofline: {len(ROOFLINE_CELLS)} cells measured, got "
          f"{len(mrecs)} records (rc {r.returncode})")
    line = {"phase": "roofline", "nvidia_smi": nvidia_smi_line(),
            "seconds": time.perf_counter() - t_phase, "count": count_line,
            "measure_seconds": measure_s, "cells": cells}
    emit(line)
    return line


def _compare_summarize(raw: torch.Tensor, n_slice: int) -> dict:
    """Bitwise: the kernel and the plain version evaluate the same float64
    operations in the same order and round the PAA once."""
    x_raw = raw[:n_slice]
    x_norm = isax.znorm(x_raw)
    bps = isax.breakpoints_on(isax.CARD, raw.device)
    out = {}
    for normalize, x in ((False, x_norm), (True, x_raw)):
        pk, sk = isax_summarize(x, w=isax.W, card=isax.CARD, normalize=normalize)
        pr, sr = ref.isax_summarize_ref(x, w=isax.W, card=isax.CARD,
                                        normalize=normalize)
        err = (pk - pr).abs()
        n_flips = int((sk != sr).sum())
        paa_ok = check(torch.equal(pk, pr), f"isax_summarize normalize="
                                            f"{normalize}: PAA bitwise")
        flips_ok = check(n_flips == 0, f"isax_summarize normalize={normalize}:"
                                       f" {n_flips} symbol flips, want 0")
        run = lambda: isax_summarize(x, w=isax.W, card=isax.CARD,
                                     normalize=normalize)
        ms = time_cuda(run)
        dev_ms = device_ms(run, SYMBOL["isax_summarize"])
        plain_ms = time_cuda(lambda: ref.isax_summarize_ref(
            x, w=isax.W, card=isax.CARD, normalize=normalize), reps=5)
        n, w = x.shape[1], isax.W
        b_ms, b_by, b_unit = roofline.isax_summarize_work(
            n_slice, n, w, bps.numel() + 1, normalize).bound()
        out[normalize] = {"shape": [n_slice, n], "normalize": normalize,
                          "max_abs_err": float(err.max()),
                          "symbol_flips": n_flips, "match": paa_ok and flips_ok,
                          "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bound_unit": b_unit, "library_ms": None,
                          "tolerance": "bitwise: PAA and symbols"}
        emit({"phase": "kernels", "kernel": "isax_summarize", **out[normalize]})
    return out[False]           # the main path's branch


def lb_scan_chunked_ref(q_paa, lo, hi, n: int):
    """The plain ``ref.lb_scan_ref`` over LB_PLAIN_CHUNK columns at a time
    (whole, its (Q, w, N) intermediate would not fit at the flat shape):
    yields (first column, last column + 1, the chunk's (Q, cols) bounds)."""
    for s in range(0, lo.shape[1], LB_PLAIN_CHUNK):
        e = min(s + LB_PLAIN_CHUNK, lo.shape[1])
        yield s, e, ref.lb_scan_ref(q_paa, lo[:, s:e], hi[:, s:e], n=n)


def _lb_check(q_paa, lo, hi, n: int) -> tuple[bool, float, float]:
    """The kernel against the plain version over every column within rtol
    LB_RTOL. -> (ok, max |err|, max relative err)."""
    got = lb_scan(q_paa, lo, hi, n=n)
    ok, max_err, max_rel = True, 0.0, 0.0
    for s, e, want in lb_scan_chunked_ref(q_paa, lo, hi, n):
        err = (got[:, s:e] - want).abs()
        ok &= bool((err <= LB_RTOL * want.abs()).all())
        max_err = max(max_err, float(err.max()))
        max_rel = max(max_rel, float((err / want.abs().clamp(min=1e-30)).max()))
    return ok, max_err, max_rel


def _lb_case(q_paa, lo, hi, n: int) -> dict:
    """One shape: the kernel against the plain version over every column,
    timed beside it, and its byte bound."""
    ok, max_err, max_rel = _lb_check(q_paa, lo, hi, n)
    qn, w = q_paa.shape
    nb = lo.shape[1]
    b_ms, b_by, b_unit = roofline.lb_scan_work(qn, w, nb).bound()
    run = lambda: lb_scan(q_paa, lo, hi, n=n)
    chunked = nb > LB_PLAIN_CHUNK

    def plain():
        for _ in lb_scan_chunked_ref(q_paa, lo, hi, n):
            pass
    return {"shape": [qn, w, nb], "max_abs_err": max_err,
            "max_rel_err": max_rel, "match": ok, "ms": time_cuda(run),
            "device_ms": device_ms(run, SYMBOL["lb_scan"]),
            "plain_ms": time_cuda(plain, reps=3 if chunked else 20),
            "plain": (f"ref.lb_scan_ref over {LB_PLAIN_CHUNK:,}-column chunks"
                      if chunked else "ref.lb_scan_ref, whole"),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            "library_ms": None}


def _compare_lb_scan(q_paa, index, u_paa, l_paa, envelope_blocks) -> dict:
    """At every shape the search paths give the kernel: the flat scan over
    every series (``flat_view``'s (w, Np) bounds), the block envelopes
    (block ranking in ``engine.prepare``), and DTW's two passes against
    planes of +-SENTINEL built as ``engine.interval_planar_lb`` builds
    them.  Each is checked over every column within rtol LB_RTOL.  The
    line's own numbers are the flat case's, where the work is; the phase
    line adds each case's issue floor, worked out from the kernel's
    arithmetic a term (LB_INSTR_PER_TERM), not measured.  The serving
    walks rank the envelopes at other shapes: each (Q, blocks) of
    ``envelope_blocks`` is checked, untimed, on the first Q queries and
    the first blocks of this index's envelopes."""
    n = index.n
    flat = core.flat_view(index)
    plane = torch.full(index.elo.shape, isax.SENTINEL, dtype=torch.float32,
                       device=index.elo.device)
    cases = {"flat": (q_paa, flat.lo, flat.hi),
             "envelope": (q_paa, index.elo, index.ehi),
             "dtw_above": (u_paa, index.elo, plane),
             "dtw_below": (l_paa, -plane, index.ehi)}
    line = {}
    for label, (qq, lo, hi) in cases.items():
        line[label] = _lb_case(qq, lo, hi, n)
        check(line[label]["match"], f"lb_scan {label} "
                                    f"{tuple(line[label]['shape'])}: within "
                                    f"rtol {LB_RTOL} over every column")
    del flat
    sliced = {}
    for qn, nb in envelope_blocks:
        ok, err, rel = _lb_check(q_paa[:qn].contiguous(),
                                 index.elo[:, :nb].contiguous(),
                                 index.ehi[:, :nb].contiguous(), n)
        check(ok, f"lb_scan envelope ({qn}, {q_paa.shape[1]}, {nb}): "
                  f"within rtol {LB_RTOL} over every column")
        sliced[f"{qn}x{nb}"] = {"shape": [qn, q_paa.shape[1], nb],
                                "max_abs_err": err, "max_rel_err": rel,
                                "match": ok}
    out = {**line["flat"], "cases": line, "envelope_slices": sliced,
           "cases_match": all(c["match"] for c in line.values())
           and all(c["match"] for c in sliced.values()),
           "tolerance": f"rtol {LB_RTOL} over every column of every case"}
    floors = {label: c["shape"][0] * c["shape"][1] * c["shape"][2]
              * LB_INSTR_PER_TERM / INSTR_RATE * 1e3
              for label, c in line.items()}
    emit({"phase": "kernels", "kernel": "lb_scan", **out,
          "issue_floor_ms": floors,
          "issue_floor_unit": f"{LB_INSTR_PER_TERM} fp32 instructions a "
                              "(q, j, s) term (the kernel's arithmetic, no "
                              "loads) at one warp instruction a clock on "
                              "each of 528 schedulers at an assumed 1.98 GHz"})
    return out


def walk_topk_panels(index, queries, n_dtw: int, prep) -> dict:
    """The first panel each walk hands to ``block_topk`` at k = 10, built
    from the index with the engine's own steps: stage A's seed panel, the
    flat scan's first chunk with a live lane, the first query-major trip
    (QUERY_MAJOR_BLOCKS blocks a query) and the first DTW trip
    (DTW_BLOCKS blocks a query).  ``prep`` is ``engine.prepare`` of the
    queries under ``engine.ED()``."""
    metric = engine.ED()
    # stage A exactly as engine.prepare hands it to block_topk
    b0 = torch.argmin(prep.block_lb, dim=1)
    ids0 = index.ids[b0]
    d0 = torch.where(ids0 >= 0,
                     frontier.query_block_l2(prep.qs.q, index.raw[b0]), ref.INF)
    panels = {"stage_a": (d0, ids0)}
    thr = frontier.bound(prep.front)
    flat = core.flat_view(index)
    lb = metric.block_lb(prep.qs, flat.lo, flat.hi, n=flat.n)
    for s in range(0, flat.raw.shape[0], FLAT_CHUNK):
        e = min(s + FLAT_CHUNK, flat.raw.shape[0])
        ids_k = flat.ids[s:e]
        act = (lb[:, s:e] < thr[:, None]) & (ids_k[None, :] >= 0)
        if bool(act.any()):                   # the scan skips a dead chunk
            d = torch.where(act, metric.distances(prep.qs, flat.raw[s:e]),
                            ref.INF)
            panels["flat"] = (d, torch.where(act, ids_k[None, :], -1))
            break
    check("flat" in panels, "the flat scan has a chunk with a live lane")
    trips = (("query_major", metric, queries, QUERY_MAJOR_BLOCKS),
             ("dtw", engine.DTW(r=DTW_R), queries[:n_dtw].contiguous(),
              DTW_BLOCKS))
    for label, m, qq, kb in trips:
        p = prep if m is metric else engine.prepare(m, index, qq, 10)
        t = frontier.bound(p.front)
        idxs = torch.argsort(p.block_lb, dim=1, stable=True)[:, :kb]
        active = torch.gather(p.block_lb, 1, idxs) < t[:, None]
        d, ids, _ = engine.trip_panel(m, index, p.qs, idxs, active, t)
        panels[label] = (d, ids)
    return {label: (d.contiguous(), ids.contiguous())
            for label, (d, ids) in panels.items()}


def _compare_block_topk(panels: dict) -> dict:
    """Bitwise (distance bits and ids) on every walk panel, on panels of
    +-0 and negative ties (one with ids up to INT32_MAX - 1, one with rows
    past 4,096 lanes) and on all-pad rows, at k = 1, 2, 10, 16, 17, 32, 33
    (the k = 1 and k <= 32 kernels' largest k and one past each) and
    C + 5; timed on every walk panel at k = 1 and 10.  The line's own
    numbers are the flat scan's panel at k = 10, the shape most launches
    take."""
    dev = panels["stage_a"][0].device
    pad_rows = (torch.full((10, 300), ref.INF, device=dev),
                torch.full((10, 300), -1, dtype=torch.int32, device=dev))
    checked = {**panels,
               "signed_zero_ties": ref.signed_panel(100, 4096, seed=5,
                                                   device=dev),
               "ids_past_2e30": ref.signed_panel(
                   100, 4096, seed=6, device=dev,
                   id_offset=int(torch.iinfo(torch.int32).max) - 4 * 4096),
               "rows_past_a_block": ref.signed_panel(10, 9000, seed=7,
                                                     device=dev),
               "all_pad_rows": pad_rows}
    ok_all, n_cases = True, 0
    for label, (d, ids) in checked.items():
        for k in (1, 2, 10, 16, 17, 32, 33, d.shape[1] + 5):
            gd, gi = block_topk(d, ids, k=k)
            wd, wi = ref.block_topk_ref(d, ids, k)
            ok = (torch.equal(gd.view(torch.int32), wd.view(torch.int32))
                  and torch.equal(gi, wi))
            ok_all &= check(ok, f"block_topk {label} {tuple(d.shape)} k={k}: "
                                "bitwise")
            n_cases += 1
    shapes = {}
    for label, (d, ids) in panels.items():
        qn, c = d.shape
        for k in (1, 10):
            run = lambda d=d, ids=ids, k=k: block_topk(d, ids, k=k)
            lib = lambda d=d, k=k: torch.topk(d, k, dim=1, largest=False)
            b_ms, b_by, b_unit = roofline.block_topk_work(qn, c, k).bound()
            shapes[f"{label}_k{k}"] = {
                "shape": [qn, c], "k": k,
                "live_lanes": int((ids >= 0).sum()),
                "ms": time_cuda(run),
                "device_ms": device_ms(run, SYMBOL["block_topk"]),
                "plain_ms": time_cuda(
                    lambda d=d, ids=ids, k=k: ref.block_topk_ref(d, ids, k)),
                "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
                "library_ms": time_cuda(lib),
                "library_device_ms": device_ms_all(lib)}
    line = {**shapes["flat_k10"], "panel": "flat", "shapes": shapes,
            "cases": n_cases, "max_abs_err": 0.0 if ok_all else None,
            "match": ok_all,
            "library": "torch.topk(largest=False): not id-tie-exact",
            "tolerance": "bitwise (distance bits and ids) on every walk "
                         "panel, +-0 ties, ids up to INT32_MAX - 1, rows "
                         "of 9,000 lanes, all-pad rows; k in {1, 2, 10, "
                         "16, 17, 32, 33, C + 5}"}
    emit({"phase": "kernels", "kernel": "block_topk", **line})
    return line


def _fused_case(q, q_paa, block, lo, hi, ids, thr, k, n, label) -> tuple[bool, float, int]:
    """One kernel-vs-plain comparison. -> (ok, max |d err|, near ties)."""
    gd, gi, gn = fused_panel_topk(q, q_paa, block, lo, hi, ids, thr, k=k, n=n)
    wd, wi, wn = ref.fused_panel_topk_ref(q, q_paa, block, lo, hi, ids, thr,
                                          k=k, n=n)
    full = ref.batch_l2_ref(q, block)                          # (Q, C)
    real = ids >= 0
    xx = torch.where(real, (block * block).sum(1), 0.0).amax()
    tol = DIST_REL * ((q * q).sum(1) + xx)[:, None]            # (Q, 1)
    ok = check(torch.equal(gn, wn), f"fused {label} k={k}: n_live equal")
    both = (wi >= 0) & (gi >= 0)
    err = torch.where(both, (gd - wd).abs(), 0.0)
    ok &= check(bool((err <= tol).all()) and torch.equal(gi >= 0, wi >= 0),
                f"fused {label} k={k}: distances within {DIST_REL}*(|q|^2+|x|^2)")
    ok &= check(bool(torch.where(gi < 0, gd == ref.INF, True).all()),
                f"fused {label} k={k}: empty slots are (INF, -1)")
    # an id may differ only at a near tie: the plain distance of the
    # kernel's pick is within tol of the plain pick's distance
    diff = (gi != wi) & both
    ties = 0
    if bool(diff.any()):
        lane_of = torch.full((int(ids.max()) + 1,), -1, dtype=torch.long,
                             device=ids.device)
        lane_of[ids[real].long()] = torch.nonzero(real).flatten()
        qi, ri = torch.nonzero(diff, as_tuple=True)
        dk = full[qi, lane_of[gi[qi, ri].long()]]
        ok &= check(bool(((dk - wd[qi, ri]).abs() <= tol[qi, 0]).all()),
                    f"fused {label} k={k}: differing ids are near ties")
        ties = int(diff.sum())
    return ok, float(err.max()), ties


def _compare_fused(index, qs, front_thr, final_thr, block_lb, order,
                   batch_slices) -> dict:
    """Every case at k in {1, 10, 32}; timed at the walk's first block
    (stage-A bounds) and at the block 90% along the walk (the main path's
    final k=10 bounds: few live lanes).  The serving walks refine smaller
    batches: the first and the late block are also checked, untimed, on
    the first Q queries for each Q of ``batch_slices`` at k in {1, 10}."""
    q, q_paa = qs.q, qs.aux[0]
    n, qn = index.n, q.shape[0]
    neg = torch.zeros(qn, dtype=torch.bool, device=q.device)
    neg[::7] = True
    minus_inf = torch.tensor(float("-inf"), device=q.device)
    b0 = int(order[0])
    b_last = index.n_blocks - 1
    first_thr = torch.where(block_lb[:, b0] < front_thr, front_thr, minus_inf)
    live_all = torch.where(neg, minus_inf, torch.full_like(front_thr, ref.INF))
    b_late = int(order[(9 * index.n_blocks) // 10])
    late_thr = torch.where(block_lb[:, b_late] < final_thr, final_thr,
                           minus_inf)

    def blk(b, c=None):
        c = index.capacity if c is None else c
        return (index.raw[b][:c], index.slo[b][:, :c].contiguous(),
                index.shi[b][:, :c].contiguous(), index.ids[b][:c])

    cases = {"first_block": (blk(b0), first_thr),
             "late_block": (blk(b_late), late_thr),
             "all_live_some_inactive": (blk(b0), live_all),
             "all_dead": (blk(b0), torch.zeros_like(front_thr)),
             "pad_lanes": (blk(b_last), live_all),
             "ragged_c1000": (blk(b0, 1000), live_all)}
    ok_all, max_err, ties, n_cases = True, 0.0, 0, 0
    for label, ((block, lo, hi, ids), thr) in cases.items():
        for k in (1, 10, 32):
            ok, err, t = _fused_case(q, q_paa, block, lo, hi, ids, thr, k, n,
                                     label)
            ok_all &= ok
            max_err = max(max_err, err)
            ties += t
            n_cases += 1
    for sq in batch_slices:
        for label, b, thr in (("first_block", b0, first_thr),
                              ("late_block", b_late, late_thr)):
            block, lo, hi, ids = blk(b)
            for k in (1, 10):
                ok, err, t = _fused_case(q[:sq], q_paa[:sq], block, lo, hi,
                                         ids, thr[:sq], k, n,
                                         f"{label} Q={sq}")
                ok_all &= ok
                max_err = max(max_err, err)
                ties += t
                n_cases += 1
    pads = int((index.ids[b_last] < 0).sum())

    # time the main path's first refine call (k=10) and a late one, at the
    # walk's final bounds, and count their work
    k = 10
    w = q_paa.shape[1]
    timed = {}
    for label, b, thr in (("first_block", b0, first_thr),
                          ("late_block", b_late, late_thr)):
        block, lo, hi, ids = blk(b)
        c = block.shape[0]
        args = (q, q_paa, block, lo, hi, ids, thr)
        run = lambda: fused_panel_topk(*args, k=k, n=n)
        qe = q_paa[:, :, None]
        dd = torch.clamp(torch.maximum(lo[None] - qe, qe - hi[None]), min=0.0)
        live = ((n / w) * (dd * dd).sum(1) < thr[:, None]) & (ids >= 0)[None]
        n_live = int(live.sum())
        live_rows = int(live.any(0).sum())
        nbytes = (qn * (n + w + 1) * 4 + 2 * w * c * 4 + c * 4
                  + live_rows * n * 4 + qn * k * 8 + qn * 4)
        ops = qn * c * 6 * w + n_live * (2 * n + 3) + live_rows * 2 * n
        b_ms, b_by, b_unit = bound(nbytes, ops)
        timed[label] = {
            "block": b, "walk_position": int((order == b).nonzero()[0, 0]),
            "n_live": n_live, "live_rows": live_rows,
            "ms": time_cuda(run), "device_ms": device_ms(
                run, SYMBOL["fused_panel_topk"]),
            "plain_ms": time_cuda(lambda: ref.fused_panel_topk_ref(
                *args, k=k, n=n)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit}
    first = timed["first_block"]
    line = {"shape": [qn, index.capacity, n], "k": k, "cases": n_cases,
            "batch_slices": list(batch_slices),
            "pad_lanes_in_last_block": pads, "near_ties": ties,
            "timed_call": {"n_live": first["n_live"],
                           "live_rows": first["live_rows"]},
            "late_block": timed["late_block"],
            "max_abs_err": max_err, "match": ok_all, "ms": first["ms"],
            "device_ms": first["device_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "bound_unit": first["bound_unit"],
            "library_ms": None,
            "tolerance": f"n_live equal; squared distances within "
                         f"{DIST_REL}*(|q|^2+max|x|^2); ids equal but at near ties"}
    emit({"phase": "kernels", "kernel": "fused_panel_topk", **line})
    return line


def _compare_batch_l2(q, flat_raw) -> dict:
    """At the flat scan's first chunk, a ragged chunk, Q = 1 and 13 (all
    timed but the ragged one), and a chunk that holds the queries
    themselves (distance ~ 0).  ``max_rel_err`` is the largest error over
    |q|^2 + |x|^2, the scale the tolerance is stated in."""
    x0 = flat_raw[:FLAT_CHUNK]
    twin = x0.clone()
    twin[:q.shape[0]] = q
    cases = {"first_chunk": (q, x0), "ragged_n1000": (q, flat_raw[:1000]),
             "q1": (q[:1], x0), "q13": (q[:13], x0), "zero_distance": (q, twin)}
    ok_all, max_err, max_rel = True, 0.0, 0.0
    for label, (qq, x) in cases.items():
        got = batch_l2(qq, x)
        want = ref.batch_l2_ref(qq, x)
        scale = (qq * qq).sum(1)[:, None] + (x * x).sum(1)[None, :]
        err = (got - want).abs()
        ok_all &= check(bool(torch.isfinite(got).all())
                        and bool((err <= DIST_REL * scale).all()),
                        f"batch_l2 {label} {tuple(qq.shape)} x "
                        f"{tuple(x.shape)}: within {DIST_REL}*(|q|^2+|x|^2)")
        max_err = max(max_err, float(err.max()))
        max_rel = max(max_rel, float((err / scale).max()))
    timed = {}
    for label in ("first_chunk", "q1", "q13"):
        qq, x = cases[label]
        qn, n = qq.shape
        m = x.shape[0]
        nbytes = 4 * (qn * n + m * n + qn * m)
        # the design that runs: three TF32 products on the tensor cores
        b_ms, b_by, b_unit = roofline.batch_l2_work(qn, m, n).bound()
        run = lambda qq=qq, x=x: batch_l2(qq, x)
        lib = lambda qq=qq, x=x: torch.cdist(
            qq, x, compute_mode="use_mm_for_euclid_dist")
        timed[label] = {
            "shape": [qn, m, n], "ms": time_cuda(run),
            "device_ms": device_ms(run, SYMBOL["batch_l2"]),
            "plain_ms": time_cuda(lambda qq=qq, x=x: ref.batch_l2_ref(qq, x)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            # a note: the bound of one product at the fp32 rate
            "fp32_bound_ms": bound(nbytes, 2 * qn * m * n)[0],
            "library_ms": time_cuda(lib),
            "library_device_ms": device_ms_all(lib)}
    line = {**timed["first_chunk"], "cases": list(cases), "timed": timed,
            "max_abs_err": max_err, "max_rel_err": max_rel, "match": ok_all,
            "library": "torch.cdist(use_mm_for_euclid_dist): the expanded "
                       "form plus a sqrt",
            "tolerance": f"within {DIST_REL}*(|q|^2+|x|^2) per pair"}
    emit({"phase": "kernels", "kernel": "batch_l2", **line})
    return line


def _compare_dtw(index, q) -> dict:
    """Shared: the first block (Q, C, n); gathered: each query's first two
    blocks in its own lower-bound order, as the query-major walk hands
    them over (Q, 2C, n); bitwise at r in {0, DTW_R, n - 1}."""
    qs = engine.DTW(r=DTW_R).prep_queries(q, w=index.w)
    block_lb = engine.DTW(r=DTW_R).block_lb(qs, index.elo, index.ehi,
                                            n=index.n)
    order = torch.argsort(block_lb, dim=1, stable=True)[:, :2]
    qn, n = qs.q.shape
    shared = index.raw[0]
    gathered = index.raw[order].reshape(qn, -1, n)
    ok_all = True
    for r in (0, DTW_R, n - 1):
        for label, x in (("shared", shared), ("gathered", gathered)):
            got = dtw_band_panel(qs.q, x, r=r)
            want = ref.dtw_band_panel_ref(qs.q, x, r=r)
            ok_all &= check(torch.equal(got, want),
                            f"dtw_band_panel {label} {tuple(x.shape)} "
                            f"r={r}: bitwise")
    m = gathered.shape[1]
    cells = qn * m * band_cells(n, DTW_R)
    b_ms, b_by, b_unit = roofline.dtw_band_panel_work(qn, m, n, DTW_R).bound()
    line = {"shape": [qn, m, n], "r": DTW_R, "form": "gathered",
            "band_cells": cells,
            "max_abs_err": 0.0 if ok_all else None, "match": ok_all,
            "ms": time_cuda(lambda: dtw_band_panel(qs.q, gathered, r=DTW_R)),
            "device_ms": device_ms(lambda: dtw_band_panel(
                qs.q, gathered, r=DTW_R), SYMBOL["dtw_band_panel"]),
            "plain_ms": time_cuda(lambda: ref.dtw_band_panel_ref(
                qs.q, gathered, r=DTW_R), reps=3, warmup=1),
            "shared_ms": time_cuda(lambda: dtw_band_panel(qs.q, shared,
                                                          r=DTW_R)),
            "shared_device_ms": device_ms(lambda: dtw_band_panel(
                qs.q, shared, r=DTW_R), SYMBOL["dtw_band_panel"]),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            "library_ms": None,
            "tolerance": f"bitwise, shared {tuple(shared.shape)} and "
                         f"gathered {tuple(gathered.shape)}, r in "
                         f"{{0, {DTW_R}, {n - 1}}}"}
    emit({"phase": "kernels", "kernel": "dtw_band_panel", **line})
    return line


def _compare_ssm(scan_in: dict) -> dict:
    """At the prefill shape on layer 0's real coefficients, at the decode
    shape (S = 1) from that scan's last state, and at a state size that is
    no power of two (the first SSM_ODD_N states of the same coefficients
    over SSM_ODD_STEPS steps; one state fewer than the config's where that
    is smaller), which the kernel pads in registers; and at the shapes a
    rank of the mesh phase's serving run gives it (its batch rows, the
    prompt and meta tokens, its 1 / M of the channels; the decode from
    the slice of the prefill's last state), on slices of the same
    coefficients."""
    xc, dt, bm, cm, a = (scan_in[k] for k in ("xc", "dt", "bm", "cm", "a"))
    one = lambda t: t[:, -1:].contiguous()
    odd = min(SSM_ODD_N, max(bm.shape[-1] - 1, 1))
    part = lambda t: t[:, :SSM_ODD_STEPS, :odd].contiguous()
    rb = MESH_SERVE_BATCH // MODEL_AXIS_MESH[0]
    rs = min(MESH_SERVE_PROMPT + get_config(MESH_SERVE_ARCH).meta_tokens,
             xc.shape[1])
    rd = xc.shape[2] // MODEL_AXIS_MESH[1]
    rank = lambda t: t[:rb, :rs, :rd].contiguous()
    rank_bc = lambda t: t[:rb, :rs].contiguous()
    cases = {"prefill": (xc, dt, bm, cm, a, None),
             "decode": (one(xc), one(dt), one(bm), one(cm), a,
                        scan_in["h_last"]),
             f"n{odd}": (xc[:, :SSM_ODD_STEPS].contiguous(),
                         dt[:, :SSM_ODD_STEPS].contiguous(), part(bm),
                         part(cm), a[:, :odd].contiguous(), None),
             "rank_prefill": (rank(xc), rank(dt), rank_bc(bm), rank_bc(cm),
                              a[:rd].contiguous(), None),
             "rank_decode": (one(rank(xc)), one(rank(dt)), one(rank_bc(bm)),
                             one(rank_bc(cm)), a[:rd].contiguous(),
                             scan_in["h_last"][:rb, :rd].contiguous())}
    ok_all, line = True, {}
    for label, args in cases.items():
        y, h_last = ssm_scan(*args)
        yr, hr = ref.ssm_scan_ref(*args)
        errs = []
        for name, got, want in (("y", y, yr), ("h_last", h_last, hr)):
            err = (got - want).abs()
            tol = SSM_REL * (want.abs() + want.abs().max())
            ok_all &= check(bool(torch.isfinite(got).all())
                            and bool((err <= tol).all()),
                            f"ssm_scan {label} {name}: within {SSM_REL} x "
                            f"(|ref| + max|ref|)")
            errs.append(float(err.max()))
        b, s_len, d = args[0].shape
        n = args[2].shape[-1]
        b_ms, b_by, b_unit = roofline.ssm_bound(b, s_len, d, n,
                                                args[5] is not None)
        line[label] = {"shape": [b, s_len, d, n],
                       "max_abs_err_y": errs[0], "max_abs_err_h_last": errs[1],
                       "ms": time_cuda(lambda: ssm_scan(*args)),
                       "device_ms": device_ms(lambda: ssm_scan(*args),
                                              SYMBOL["ssm_scan"]),
                       "plain_ms": time_cuda(lambda: ref.ssm_scan_ref(*args),
                                             reps=3, warmup=1),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "bound_unit": b_unit}
    pre = line["prefill"]
    out = {"shape": pre["shape"], "cases": line,
           "max_abs_err": max(max(c["max_abs_err_y"], c["max_abs_err_h_last"])
                              for c in line.values()),
           "match": ok_all, "ms": pre["ms"], "device_ms": pre["device_ms"],
           "plain_ms": pre["plain_ms"],
           "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
           "bound_unit": pre["bound_unit"], "library_ms": None,
           "library": "none: no single PyTorch call computes a selective scan",
           "tolerance": f"y and h_last within {SSM_REL} x (|ref| + max|ref|): "
                        "fp32 with FMA contraction and ex2.approx a few ulps "
                        "from torch.exp, over a recurrence that decays"}
    emit({"phase": "kernels", "kernel": "ssm_scan", **out})
    return out


def device_ms_by_kernel(fn, reps: int = 20, warmup: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` by each device event it
    launches (kernel, memset), over the same back-to-back calls."""
    by = {}
    for e in _profiled(fn, reps, warmup):
        by[e.key] = by.get(e.key, 0.0) + e.self_device_time_total / reps / 1e3
    check(bool(by), "the profiler saw device time of ssm_scan_bwd")
    return by


def _sass_count(fragment: str) -> int | None:
    """Instructions in the SASS of the built library's kernel whose mangled
    name holds ``fragment`` (``cuobjdump -sass``), predicated ones included;
    None where the toolkit has no cuobjdump or the kernel is not found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    try:
        out = subprocess.run([tool, "-sass", str(_build.library().path)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    for fn in re.split(r"\n\s+Function : ", out.stdout)[1:]:
        if fragment in fn.split("\n", 1)[0]:
            return len(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?[A-Z]", fn))
    return None


def _bwd_traffic(b: int, s: int, d: int, n: int) -> dict:
    """``ssm_scan_bwd``'s bytes beyond the work's own, from its scratch:
    the clusters' dB, dC partials and the dA chain's (B, D, N) buffer,
    each written once and read once (at most what reaches device memory);
    apart, the two chains' hops through their (B, D, N) buffers, a read
    and a write a span each, which stay in L2."""
    lib = _build.library().lib
    work = roofline.ssm_scan_bwd_work(b, s, d, n, False).nbytes
    beyond = 2 * 4 * (lib.ssm_scan_bwd_scratch(b, s, d, n, 0) + b * d * n)
    spans = -(-s // _build.SSM_CKPT_STEPS)
    return {"work_bytes": work, "beyond_bytes": beyond,
            "beyond_share": beyond / work,
            "l2_chain_bytes": 2 * 2 * spans * 4 * b * d * n}


def _compare_ssm_bwd(train_in: dict, seed: int) -> dict:
    """``ssm_scan_bwd`` against the plain reverse scan in float64 at
    Hymba's training shape: on layer 0's operands of ``hybrid_train``'s
    batch (N = 16; dh_last None as in training, and given), and on random
    operands at each of BWD_STATE_SIZES; and on random operands at
    train_4k's per-rank shape (BWD_TRAIN_4K); two launches bitwise equal.
    Timed at the training case and at train_4k's, each with its device
    time split by the CUDA kernels (and memset) a call launches, its issue
    floor (BWD_INSTR_PER_ELEMENT, worked out, not measured) and its bytes
    beyond the work's own."""
    xc = train_in["xc"]
    b, s, d = xc.shape
    dev = xc.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev)
    dy = rnd(b, s, d) * 0.1
    base = tuple(train_in[k] for k in ("xc", "dt", "bm", "cm", "a"))
    rand_ops = lambda b, s, d, n: (rnd(b, s, d) * 0.5,
                                   rnd(b, s, d).abs() * 0.1,
                                   rnd(b, s, n) * 0.5, rnd(b, s, n) * 0.5,
                                   -rnd(d, n).abs() - 0.1)
    cases = {"train": (base, dy, None),
             "train_dh_last": (base, dy, rnd(b, d, base[2].shape[-1]))}
    for n in BWD_STATE_SIZES:
        cases[f"n{n}"] = (rand_ops(b, s, d, n), dy, rnd(b, d, n))
    b4, s4, d4, n4 = BWD_TRAIN_4K
    cases["train_4k"] = (rand_ops(b4, s4, d4, n4), rnd(b4, s4, d4) * 0.1,
                         None)
    ok_all, line, timed = True, {}, {}
    names = ("dxc", "ddt", "dbm", "dcm", "da", "dh0")
    # the N = 16 kernel runs each of its instructions about once a span in
    # each thread, and a thread holds one (d, n) of a 32-step span
    sass = _sass_count("ssm_scan_bwd_kernelILi16E")
    sass_per_element = None if sass is None else sass / _build.SSM_CKPT_STEPS
    for label, (opnds, dyc, dhl) in cases.items():
        _, _, ck = ssm_scan_with_checkpoints(*opnds)
        got = ssm_scan_bwd(*opnds, ck, dyc, dhl)
        again = ssm_scan_bwd(*opnds, ck, dyc, dhl)
        f64 = lambda t: None if t is None else t.double()
        _, _, ckr = ref.ssm_scan_with_checkpoints_ref(*map(f64, opnds))
        want = ref.ssm_scan_bwd_ref(*map(f64, opnds), ckr, f64(dyc),
                                    f64(dhl))
        errs, rels = {}, {}
        for name, gt, wt in zip(names, got, want):
            top = float(wt.abs().max())
            errs[name] = float((gt.double() - wt).abs().max())
            rels[name] = errs[name] / max(top, 1e-30)
            ok_all &= check(bool(torch.isfinite(gt).all())
                            and errs[name] <= BWD_REL * top,
                            f"ssm_scan_bwd {label} {name}: within {BWD_REL} "
                            f"x max|ref|, got {rels[name]:.3g}")
        same = all(torch.equal(p, q) for p, q in zip(got, again))
        ok_all &= check(same, f"ssm_scan_bwd {label}: two launches bitwise "
                              "equal")
        shape = [*opnds[0].shape, opnds[2].shape[-1]]
        line[label] = {"shape": shape, "dh_last": dhl is not None,
                       "max_abs_err": errs, "rel_err": rels,
                       "deterministic": same}
        del got, again, want, ckr
        if label not in ("train", "train_4k"):
            continue
        call = lambda: ssm_scan_bwd(*opnds, ck, dyc)
        b_ms, b_by, b_unit = roofline.ssm_bwd_bound(*shape, False)
        by_kernel = device_ms_by_kernel(call)
        timed[label] = {
            "shape": shape, "ms": time_cuda(call),
            "device_ms": sum(by_kernel.values()),
            "device_ms_by_kernel": by_kernel,
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            "issue_floor_ms": math.prod(shape) * BWD_INSTR_PER_ELEMENT
            / INSTR_RATE * 1e3,
            "sass_issue_floor_ms": None if sass is None else
            math.prod(shape) * sass_per_element / INSTR_RATE * 1e3,
            **_bwd_traffic(*shape),
            "forward_ms": {"plain_launch": time_cuda(
                lambda: ssm_scan(*opnds)), "training_launch": time_cuda(
                lambda: ssm_scan_with_checkpoints(*opnds))}}
        timed[label]["ns_per_element"] = (timed[label]["device_ms"] * 1e6
                                          / math.prod(shape))
    opnds, dyc, _ = cases["train"]
    ck32 = ref.ssm_scan_with_checkpoints_ref(*opnds)[2]
    train = timed["train"]
    out = {"shape": line["train"]["shape"], "cases": line, "timed": timed,
           "max_abs_err": max(max(c["max_abs_err"].values())
                              for c in line.values()),
           "max_rel_err": max(max(c["rel_err"].values())
                              for c in line.values()),
           "match": ok_all, "ms": train["ms"],
           "device_ms": train["device_ms"],
           "plain_ms": time_cuda(lambda: ref.ssm_scan_bwd_ref(
               *opnds, ck32, dyc), reps=1, warmup=0),
           "bound_ms": train["bound_ms"], "bound_by": train["bound_by"],
           "bound_unit": train["bound_unit"],
           "library_ms": None,
           "library": "none: no PyTorch call computes a selective scan's "
                      "gradient",
           "issue_floor_unit": f"{BWD_INSTR_PER_ELEMENT} instructions a "
                               "(b, t, d, n) (the kernel's arithmetic, "
                               "shuffles and shared loads) at one warp "
                               "instruction a clock on each of 528 "
                               "schedulers at an assumed 1.98 GHz",
           "sass_instructions": sass, "sass_per_element": sass_per_element,
           "sass_issue_floor_unit": "the N = 16 kernel's SASS instructions "
                                    "(cuobjdump) over its 32 elements a "
                                    "thread, at the same rate",
           "tolerance": f"each gradient within {BWD_REL} x its max |ref| "
                        "(float64 plain version): fp32 sums over up to "
                        "4,224 steps and 1,600 channels, ex2.approx a "
                        "few ulps from exp"}
    emit({"phase": "kernels", "kernel": "ssm_scan_bwd", **out})
    return out


def phase_kernels(raw, index, queries, n_slice: int, n_dtw: int,
                  scan_in: dict, main_k10, sanitize_blocks: int,
                  shard_blocks: int, train_in: dict, seed: int) -> dict:
    """Every kernel against its plain version at the shapes the paths give
    it.  Beside the main batch, the serving walks' batches: ``serve``'s
    tenants (SERVE_BATCH queries) and the CLI's one-query warm-up on the
    10M index's envelopes, and ``sanitize``'s tenants and their drain
    (SANITIZE_BATCH and SANITIZE_TENANTS x SANITIZE_BATCH queries) on the
    ``sanitize_blocks`` envelopes of its index (the CLI's 4 x 4 queries
    at k=1 take the same two batch sizes); and the main batch on a
    ``dist4`` / ``dist_ooc`` shard's ``shard_blocks`` envelopes."""
    metric = engine.ED()
    prep = engine.prepare(metric, index, queries, 10)
    qs = prep.qs
    dqs = engine.DTW(r=DTW_R).prep_queries(queries[:n_dtw].contiguous(),
                                           w=index.w)
    order, _, _ = engine.block_major_schedule(prep.block_lb)
    topk_panels = walk_topk_panels(index, queries, n_dtw, prep)
    sanitize_qs = (SANITIZE_BATCH, SANITIZE_TENANTS * SANITIZE_BATCH)
    slices = sorted({q for q in (1, SERVE_BATCH, *sanitize_qs)
                     if q < queries.shape[0]})
    return {
        "isax_summarize": _compare_summarize(raw, n_slice),
        "lb_scan": _compare_lb_scan(
            qs.aux[0], index, dqs.aux[2], dqs.aux[3],
            [(qn, nb) for qn in slices for nb in
             ((index.n_blocks, sanitize_blocks) if qn in sanitize_qs
              else (index.n_blocks,))]
            + [(queries.shape[0], min(shard_blocks, index.n_blocks))]),
        "block_topk": _compare_block_topk(topk_panels),
        "fused_panel_topk": _compare_fused(
            index, qs, prep.front.threshold(),
            main_k10.dist[:, -1].double().square().float(), prep.block_lb,
            order, slices),
        "batch_l2": _compare_batch_l2(qs.q, index.raw.reshape(-1, index.n)),
        "dtw_band_panel": _compare_dtw(index, queries[:n_dtw]),
        "ssm_scan": _compare_ssm(scan_in),
        "ssm_scan_bwd": _compare_ssm_bwd(train_in, seed),
    }


def phase_exact(raw, queries, paths: dict) -> None:
    """Brute force over every series with the plain versions, not ``ops``;
    ``paths`` maps a path's name to its {k: (result, seconds)}."""
    q = isax.znorm(queries)
    qn = q.shape[0]
    kmax = max(k for results in paths.values() for k in results)
    best_d = torch.full((qn, kmax), ref.INF, device=q.device)
    best_i = torch.full((qn, kmax), -1, dtype=torch.int32, device=q.device)
    t0 = time.perf_counter()
    for i in range(0, raw.shape[0], SCAN_CHUNK):
        j = min(i + SCAN_CHUNK, raw.shape[0])
        d = ref.batch_l2_ref(q, isax.znorm(raw[i:j]))
        ids = torch.arange(i, j, dtype=torch.int32,
                           device=q.device).expand(qn, -1)
        cd, ci = ref.topk_by_dist_id(d, ids, kmax)
        best_d, best_i = ref.topk_by_dist_id(torch.cat([best_d, cd], 1),
                                             torch.cat([best_i, ci], 1), kmax)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    tol = DIST_REL * 2 * (q * q).sum(1)                  # z-normed: |x|^2 = |q|^2
    line = {"phase": "exact", "scan_seconds": scan_s,
            "tolerance": f"squared distances within {DIST_REL}*(|q|^2+|x|^2)"}
    for name, results in paths.items():
        line[name] = {}
        for k, (res, _) in results.items():
            got_i = res.idx
            want_i, want_d = best_i[:, :k], best_d[:, :k]
            got_d = res.dist.double() ** 2
            dist_ok = bool(((got_d - want_d.double()).abs()
                            <= tol[:, None].double()).all())
            diff = got_i != want_i
            ties_ok = True
            if bool(diff.any()):
                qi, ri = torch.nonzero(diff, as_tuple=True)
                x = isax.znorm(raw[got_i[qi, ri].long()])
                dk = ((q[qi] - x) ** 2).sum(1)
                ties_ok = bool(((dk - want_d[qi, ri]).abs() <= tol[qi]).all())
            line[name][f"k{k}"] = {
                "ids_equal": int((~diff).sum()), "near_ties": int(diff.sum()),
                "max_sq_dist_err": float((got_d - want_d.double())
                                         .abs().max())}
            check(dist_ok and ties_ok, f"exact {name} k={k}: answers equal "
                                       "the brute-force scan (ids, but near "
                                       "ties)")
    emit(line)


def _drop_page_cache(path: Path) -> bool:
    """Ask the kernel to drop ``path``'s clean pages, so the next read of
    it goes to the disk.  -> whether the advice was accepted."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        return True
    except (OSError, AttributeError):
        return False


def _ooc_series(args, n_series: int) -> tuple[int, dict]:
    """How many series the on-disk phase writes: ``--ooc-series`` (all of
    them by default), cut in whole millions until the series file, the
    index file and the build's run and merge files take at most half the
    free disk.  -> (n, the disk line)."""
    OOC_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(OOC_DIR).free
    want = min(args.ooc_series or n_series, n_series)
    n = want
    while n > 0 and 2 * n * OOC_BYTES_PER_SERIES > free:
        n = (n - 1) // 1_000_000 * 1_000_000
    line = {"dir": str(OOC_DIR), "free_bytes": free,
            "bytes_per_series": OOC_BYTES_PER_SERIES,
            "needed_bytes": n * OOC_BYTES_PER_SERIES, "series": n}
    if n < want:
        line["cut"] = (f"series cut from {want} to {n}: the files must fit "
                       "in half the free disk")
    return n, line


def _ids_agree(name: str, got, want, q, raw) -> dict:
    """phase_exact's rule: ids equal, but where the two differ the id
    returned lies at a near tie (its true squared distance within
    DIST_REL * (|q|^2 + |x|^2) of the wanted one)."""
    tol = DIST_REL * 2 * (q * q).sum(1)
    want_d = want.dist.double() ** 2
    diff = got.idx != want.idx
    ties_ok = True
    if bool(diff.any()):
        qi, ri = torch.nonzero(diff, as_tuple=True)
        x = isax.znorm(raw[got.idx[qi, ri].long()])
        dk = ((q[qi] - x) ** 2).sum(1).double()
        ties_ok = bool(((dk - want_d[qi, ri]).abs() <= tol[qi]).all())
    check(ties_ok, f"{name}: ids equal (but near ties)")
    return {"ids_equal": int((~diff).sum()), "near_ties": int(diff.sum())}


def _bitwise(a, b) -> bool:
    return (torch.equal(a.idx, b.idx) and torch.equal(a.dist, b.dist)
            and all(torch.equal(x, y) for x, y in zip(a.stats, b.stats)))


def _io_line(res, secs: float, tel: dict | None = None) -> dict:
    io = res.io
    line = {"seconds": secs, "bytes_read": io.bytes_read,
            "read_fraction": io.read_fraction,
            "blocks_fetched": io.blocks_fetched, "cache_hits": io.cache_hits,
            "blocks_refined": io.blocks_refined}
    if tel is not None:
        line.update({key: tel[key] for key in
                     ("syncs", "dispatches", "walk_blocks",
                      "demand_misses") if key in tel})
    return line


def phase_ooc(args, raw, index, queries, refs: dict, dtw_res
              ) -> tuple[dict, dict | None]:
    """The on-disk index: the series written to a headerless file, the
    staged pipeline build, the file against the in-memory index bit for
    bit, the cached walk (ED at two pipeline settings, a warm repeat,
    DTW) against the in-memory answers.  The files stay under
    ``OOC_DIR`` for the later phases (the caller removes them).  -> (the
    phase's launches, {"n", "series", "index", "ucr10"} for the later
    phases, or None when the disk could not hold the files)."""
    n_all = raw.shape[0]
    n, disk = _ooc_series(args, n_all)
    line = {"phase": "ooc", "disk": disk, "capacity": CAPACITY,
            "shards": OOC_SHARDS, "workers": OOC_WORKERS,
            "cache_blocks": OOC_CACHE_BLOCKS}
    launches: dict[str, int] = {}

    def count(kernels: tuple, what: str) -> None:
        got = ops.launch_counts()
        for name, c in got.items():
            launches[name] = launches.get(name, 0) + c
        for name in kernels:
            check(got[name] > 0, f"kernel {name} launched on the ooc path "
                                 f"({what})")

    if not check(n > 0, "the disk holds the on-disk phase's files"):
        emit(line)
        return launches, None
    sub = raw[:n]
    if n < n_all:       # the cut: its own in-memory index and answers
        index = core.build(sub, capacity=CAPACITY)
        refs = {"block_major": {k: (core.search_block_major(
                    index, queries, k=k), 0.0) for k in (1, 10)},
                "ucr": {10: (core.search_scan(sub, queries, k=10), 0.0)}}
        dtw_res = dtw.search_dtw(index, queries[:args.dtw_queries]
                                 .contiguous(), r=DTW_R, k=10)
    # 1. the series, as the headerless f32 file users hand a build
    series = OOC_DIR / "series.f32"
    t0 = time.perf_counter()
    for i in range(0, n, SCAN_CHUNK):
        storage.SeriesStore.append(series,
                                   sub[i:i + SCAN_CHUNK].cpu().numpy())
    store = storage.SeriesStore(series, length=LENGTH)
    line["series_write_seconds"] = time.perf_counter() - t0
    line["series_bytes"] = store.nbytes

    # 2. the staged build (pipeline_build is run_pipeline + open_index;
    # the two are called apart to read the BuildReport)
    path = OOC_DIR / "index.dsix"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, report = storage.run_pipeline(store, path, capacity=CAPACITY,
                                     shards=OOC_SHARDS,
                                     workers=OOC_WORKERS)
    torch.cuda.synchronize()
    count(("isax_summarize",), "build")
    line["build"] = {"seconds": time.perf_counter() - t0,
                     "file_bytes": os.path.getsize(path),
                     "report": report.as_dict()}
    opened = storage.open_index(path)

    # 3. the file against the in-memory index, bit for bit
    same = all(torch.equal(getattr(opened, f), getattr(index, f))
               for f in ("ids", "slo", "shi", "elo", "ehi"))
    check(same, "ooc: ids/slo/shi/elo/ehi of the pipeline's file "
                "bitwise equal core.build's")
    raw_same = True
    mm = opened.host_raw.blocks
    # read from the disk: the rate bounds a cold walk that reads it all
    dropped = _drop_page_cache(path)
    t0 = time.perf_counter()
    for b0 in range(0, opened.n_blocks, OOC_COMPARE_BLOCKS):
        b1 = min(b0 + OOC_COMPARE_BLOCKS, opened.n_blocks)
        part = torch.from_numpy(np.array(mm[b0:b1])).to(index.raw.device)
        raw_same &= torch.equal(part, index.raw[b0:b1])
    secs = time.perf_counter() - t0
    check(raw_same, "ooc: the pipeline's raw section torch.equal "
                    "core.build's index.raw")
    line["byte_identity"] = {"summaries": same, "raw": raw_same}
    line["raw_sequential_read"] = {
        "page_cache_dropped": dropped, "seconds": secs,
        "bytes_per_s": mm.nbytes / secs,
        "what": "the raw section read in 256-block steps from the disk "
                "into the card and compared, one thread"}

    # 4. the ED walk from the disk, at two pipeline settings
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    walks = {}
    q = isax.znorm(queries)
    for d, g in OOC_SETTINGS:
        for k in (1, 10):
            dropped = _drop_page_cache(path)
            tel: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = storage.ooc_search(opened, queries, k=k,
                                     cache_blocks=OOC_CACHE_BLOCKS,
                                     pipeline_depth=d, group_blocks=g,
                                     telemetry=tel)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            walks[(d, g, k)] = res
            bm = refs["block_major"][k][0]
            entry = {"page_cache_dropped": dropped,
                     **_io_line(res, secs, tel),
                     "vs_block_major": _ids_agree(
                         f"ooc ({d}, {g}) k={k} vs block-major", res, bm,
                         q, raw)}
            if k in refs["ucr"]:
                entry["vs_ucr"] = _ids_agree(
                    f"ooc ({d}, {g}) k={k} vs UCR", res,
                    refs["ucr"][k][0], q, raw)
            gd, wd = res.dist.double() ** 2, bm.dist.double() ** 2
            check(bool(((gd - wd).abs() <= 1e-5 * wd + 1e-6).all()),
                  f"ooc ({d}, {g}) k={k}: squared distances within "
                  "rtol 1e-5 of block-major's")
            line[f"ed_d{d}_g{g}_k{k}"] = entry
    count(("lb_scan", "fused_panel_topk"), "ED walk")
    (d0, g0), (d1, g1) = OOC_SETTINGS
    for k in (1, 10):
        check(_bitwise(walks[(d0, g0, k)], walks[(d1, g1, k)]),
              f"ooc k={k}: ({d0}, {g0}) and ({d1}, {g1}) bitwise equal "
              "in dist, idx and every SearchStats counter")
    line["ed_max_memory_allocated"] = torch.cuda.max_memory_allocated()

    # 5. a warm repeat through a session that holds every block
    _drop_page_cache(path)
    with storage.SearchSession(opened,
                               cache_blocks=max(opened.n_blocks, d1 + g1),
                               pipeline_depth=d1,
                               group_blocks=g1) as sess:
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sess.search(queries, k=10)
            torch.cuda.synchronize()
            runs.append((res, time.perf_counter() - t0,
                         dict(sess.last_telemetry)))
        check(_bitwise(runs[0][0], runs[1][0]),
              "ooc warm repeat bitwise equal the cold batch")
        check(runs[1][0].io.bytes_read == 0,
              "ooc warm repeat read 0 bytes")
        line["warm"] = {"cold": _io_line(*runs[0]),
                        "warm": _io_line(*runs[1]),
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated()}

        # 6. DTW through the same session
        ops.reset_launch_counts()
        dq = queries[:args.dtw_queries].contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.search(dq, k=10, metric=engine.DTW(r=DTW_R))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count(("lb_scan", "block_topk", "dtw_band_panel"), "DTW walk")
        diff = res.idx != dtw_res.idx
        ties_ok = True
        if bool(diff.any()):
            qz = isax.znorm(dq)
            x = isax.znorm(raw[res.idx.long().flatten()]).reshape(
                res.idx.shape + (LENGTH,))
            dk = ref.dtw_band_panel_ref(qz, x, r=DTW_R).double()
            wd = dtw_res.dist.double() ** 2
            ties_ok = bool(((dk - wd).abs()
                            <= DIST_REL * wd + 1e-6)[diff].all())
        check(ties_ok, "ooc DTW k=10: ids equal phase dtw's (but near "
                       "ties)")
        line["dtw"] = {"r": DTW_R, "queries": dq.shape[0],
                       **_io_line(res, secs, sess.last_telemetry),
                       "ids_equal": int((~diff).sum()),
                       "near_ties": int(diff.sum())}
    line["launches"] = launches
    emit(line)
    return launches, {"n": n, "series": series, "index": path,
                      "ucr10": refs["ucr"][10][0]}


# ---------------------------------------------------------------------------
# the distributed protocol and search serving
# ---------------------------------------------------------------------------

class _SeriesRows:
    """Rows of the series file by id, on the card: ``_ids_agree``'s raw
    once the in-memory series are gone from the card."""

    def __init__(self, store, device):
        self.mm = store.memmap()
        self.device = device

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        rows = np.asarray(self.mm[ids.cpu().numpy()], dtype=np.float32)
        return torch.from_numpy(rows).to(self.device)


def _dist_ok(name: str, res, want, q, raw) -> dict:
    """The ids against a brute-force answer under ``exact``'s rule, the
    squared distances within DIST_REL * (|q|^2 + |x|^2) of it."""
    tol = DIST_REL * 2 * (q * q).sum(1)
    k = res.idx.shape[1]
    want = want._replace(dist=want.dist[:, :k], idx=want.idx[:, :k])
    gd, wd = res.dist.double() ** 2, want.dist.double() ** 2
    check(bool(((gd - wd).abs() <= tol[:, None].double()).all()),
          f"{name}: squared distances within {DIST_REL} x (|q|^2 + |x|^2) "
          "of the brute-force scan's")
    return {**_ids_agree(name, res, want, q, raw),
            "max_sq_dist_err": float((gd - wd).abs().max())}


def _group_init(name: str) -> str:
    """A fresh ``file://`` store for a process group, under build/."""
    path = ROOT / "build" / f"{name}.store"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    return f"file://{path}"


def phase_dist1(index, queries, bm: dict) -> dict:
    """``distributed.search_sharded`` on a world-size-1 NCCL group over the
    main index: with one shard the global threshold is the shard's own,
    so the answer and every counter must be bitwise block-major's."""
    import torch.distributed as tdist
    from datetime import timedelta
    tdist.init_process_group(DIST1_BACKEND, init_method=_group_init("dist1"),
                             world_size=1, rank=0,
                             timeout=timedelta(seconds=DIST_TIMEOUT_S))
    try:
        results, lines, launches = run_path(
            "block_major",
            lambda k: distributed.search_sharded(index, queries, k=k),
            ks=(10,))
        res = results[10][0]
        same = _bitwise(res, bm[10][0])
        check(same, "dist1: search_sharded on one rank bitwise equals "
                    "search_block_major (dist, idx, every counter)")
        emit({"phase": "dist1", "backend": tdist.get_backend(),
              "world_size": tdist.get_world_size(), "launches": launches,
              "bitwise_block_major": same, **lines})
    finally:
        tdist.destroy_process_group()
    return launches


def phase_serve(args, ooc: dict) -> dict:
    """Multi-tenant serving on the on-disk index: 4 tenant threads x 25
    near-data queries in one coalesced drain, each tenant bitwise its
    isolated ``SearchSession.search``; an anytime answer whose certificate
    brackets the exact k-th distance and whose ``refine_to_exact`` is
    bitwise the exact answer; and the ``launch.serve --search-index`` CLI
    once, as a subprocess, with 4 queries a tenant (its default) at
    k=``SERVE_CLI_K``.  Sessions walk at (pipeline_depth, group_blocks) =
    ``WALK_PIPELINE``; the index file stays in the page cache (the ooc
    phase just read it), so the phase times the walks, not the disk."""
    path = ooc["index"]
    opened = storage.open_index(path)
    loads = serve.tenant_traffic(opened, args.seed, SERVE_TENANTS,
                                 SERVE_BATCH)
    d, g = WALK_PIPELINE
    line = {"phase": "serve", "tenants": SERVE_TENANTS,
            "batch": SERVE_BATCH, "k": SERVE_K,
            "cache_blocks": OOC_CACHE_BLOCKS, "pipeline": [d, g],
            "n_blocks": opened.n_blocks, "page_cache": "warm"}

    def session():
        return storage.SearchSession(opened, cache_blocks=OOC_CACHE_BLOCKS,
                                     pipeline_depth=d, group_blocks=g)

    torch.cuda.synchronize()
    ops.reset_launch_counts()

    # 1. every tenant alone, each in a fresh session
    isolated, fetched, t0 = [], 0, time.perf_counter()
    for q in loads:
        with session() as sess:
            isolated.append(sess.search(q, k=SERVE_K))
            fetched += sess.blocks_fetched
    torch.cuda.synchronize()
    line["isolated"] = {"seconds": time.perf_counter() - t0,
                        "disk_blocks": fetched}

    # 2. the same tenants as threads through one coalesced drain
    results: list = [None] * SERVE_TENANTS
    errors: list = []
    with session() as sess:
        admitted = threading.Barrier(SERVE_TENANTS)

        def tenant(i):
            try:
                t = sess.submit(loads[i], k=SERVE_K)
                admitted.wait(timeout=DIST_TIMEOUT_S)
                results[i] = t.result(timeout=DIST_TIMEOUT_S)
            except BaseException as e:     # reported as a failed check
                errors.append(repr(e))

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(SERVE_TENANTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=DIST_TIMEOUT_S)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(not errors and not any(th.is_alive() for th in threads),
              f"serve: every tenant thread answered ({errors})")
        drain_blocks = sess.blocks_fetched
        line["coalesced"] = {"seconds": secs, "disk_blocks": drain_blocks,
                             "batches_billed": sess.batches,
                             "hit_rate": sess.hit_rate}
    same = all(r is not None and torch.equal(r.idx, w.idx)
               and torch.equal(r.dist, w.dist)
               for r, w in zip(results, isolated))
    check(same, "serve: each tenant's coalesced answer bitwise its isolated "
                "SearchSession.search")
    check(drain_blocks <= fetched, "serve: the drain read no more disk "
                                   "blocks than the isolated runs together")
    line["coalesced"]["bitwise_isolated"] = same

    # 3. an anytime answer, certified, then refined to exact
    exact = isolated[0]
    with session() as sess:
        t0 = time.perf_counter()
        a = sess.search(loads[0], k=SERVE_K, deadline_blocks=SERVE_DEADLINE)
        torch.cuda.synchronize()
        anytime_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex = a.refine_to_exact()
        torch.cuda.synchronize()
        refine_s = time.perf_counter() - t0
    c = a.certificate
    kth = exact.dist[:, -1].cpu().numpy()
    brackets = bool((c.lower <= kth + 1e-5 * np.abs(kth)).all()
                    and (c.upper >= kth - 1e-5 * np.abs(kth)).all())
    check(brackets, "serve: the anytime certificate brackets the exact "
                    "k-th distance")
    refined_same = _bitwise(ex, exact)
    check(refined_same, "serve: refine_to_exact bitwise the exact answer "
                        "(dist, idx, every counter)")
    line["anytime"] = {"deadline_blocks": SERVE_DEADLINE,
                       "seconds": anytime_s, "refine_seconds": refine_s,
                       "gap_mean": float(c.gap.mean()),
                       "gap_max": float(c.gap.max()),
                       "certified_exact": int(c.exact.sum()),
                       "blocks_deferred_max": int(c.blocks_deferred.max()),
                       "refine_disk_blocks": ex.io.blocks_fetched,
                       "brackets": brackets,
                       "refine_bitwise_exact": refined_same}
    launches = ops.launch_counts()
    for name in ("lb_scan", "fused_panel_topk"):
        check(launches[name] > 0, f"kernel {name} launched on the serve path")
    line["launches"] = launches

    # 4. the serving CLI, once, in its own process
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--search-index",
         str(path), "--tenants", str(SERVE_TENANTS), "--k",
         str(SERVE_CLI_K), "--deadline-blocks", str(SERVE_DEADLINE),
         "--seed", str(args.seed), "--device", str(opened.ids.device)],
        capture_output=True, text=True, env=env, timeout=DIST_TIMEOUT_S)
    out = cli.stdout.strip().splitlines()
    check(cli.returncode == 0 and "certificate verified True" in cli.stdout,
          f"serve: launch.serve --search-index exits 0 with a verified "
          f"certificate (rc {cli.returncode}: {cli.stderr[-2000:]})")
    line["cli"] = {"returncode": cli.returncode, "k": SERVE_CLI_K,
                   "cut": "k cut from the CLI's default 5 to "
                          f"{SERVE_CLI_K} for the time limit: at k=5 its "
                          "4 x 4 near-data queries walk ~7,700 of the "
                          "9,766 blocks",
                   "seconds": time.perf_counter() - t0, "stdout": out}
    emit(line)
    return launches


# ---------------------------------------------------------------------------
# static analysis and the runtime lock sanitizer
# ---------------------------------------------------------------------------

def phase_analysis() -> None:
    """The port's checkers (``repro_torch.analysis``: lock discipline,
    host syncs, kernel/oracle contracts) over ``src/repro_torch``, in
    process: any finding fails the run.  Prints the sanctioned ``# sync``
    sites of ``core/engine.py`` grouped by the frequency each comment
    states: the device->host transfers of the walks."""
    from repro_torch.analysis import cli, run_analysis
    from repro_torch.analysis import syncs as syncs_lib
    t0 = time.perf_counter()
    project, errors = cli.load_project([str(ROOT / "src" / "repro_torch")])
    findings = errors + run_analysis(project)
    check(not findings, "analysis: the port's checkers find nothing ("
          + "; ".join(f.text() for f in findings[:20]) + ")")
    eng = project.by_module.get("repro_torch.core.engine")
    check(eng is not None and eng.sync_trace_module(),
          "analysis: core/engine.py carries '# repro: sync-trace'")
    sites: dict[str, list[int]] = {}
    for ln, freq in (syncs_lib.sync_sites(eng) if eng else []):
        sites.setdefault(freq, []).append(ln)
    emit({"phase": "analysis", "files": len(project.files),
          "findings": len(findings),
          "engine_sync_sites": {f: {"count": len(v), "lines": v}
                                for f, v in sorted(sites.items())},
          "seconds": time.perf_counter() - t0})


def sanitize_child(cfg_path: str) -> int:
    """``phase_sanitize``'s subprocess, started with ``REPRO_SANITIZE=1``
    (the guarded classes read it when they are decorated, at import):
    the sanitizer armed, one deliberate off-lock write caught, the
    pipeline build of the phase's rows, and the tenants served isolated
    and through one coalesced drain from threads, on the index file of
    those rows that the main process built unsanitized.  Writes its
    numbers and answers beside ``cfg_path``; -> 0 if every check
    passed."""
    from repro_torch.analysis import sanitize
    from repro_torch.storage.format import IndexFileWriter
    cfg = json.loads(Path(cfg_path).read_text())
    work = Path(cfg_path).parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info: dict = {"seconds": {}, "launches": {}}

    def lap(step: str, t0: float) -> None:
        torch.cuda.synchronize()
        info["seconds"][step] = time.perf_counter() - t0

    # 1. armed: the guarded classes hold instrumented locks
    t0 = time.perf_counter()
    opened = storage.open_index(cfg["index"])
    d, g = WALK_PIPELINE

    def session():
        return storage.SearchSession(opened, cache_blocks=OOC_CACHE_BLOCKS,
                                     pipeline_depth=d, group_blocks=g)

    with session() as sess:
        info["locks"] = {"session": type(sess._coalescer_lock).__name__,
                         "cache": type(sess.cache._lock).__name__}
    info["enabled"] = sanitize.enabled()
    check(info["enabled"] and set(info["locks"].values())
          == {"InstrumentedLock"}, "sanitize: REPRO_SANITIZE=1 armed the "
          f"sanitizer and the session's locks ({info['locks']})")
    lap("open", t0)

    # 2. one deliberate off-lock write to a guarded field
    wr = IndexFileWriter(work / "probe.dsix", n=8, w=4, card=4, capacity=4,
                         n_real=16, n_blocks=4,
                         tmp_path=work / "probe.partial")
    try:
        wr.append_raw_rows(np.zeros((4, 8), np.float32))   # locked path
        with wr._lock:
            wr._raw_rows = 0                               # held: fine
        try:
            wr._raw_rows = 7                               # off-lock
            caught = False
        except sanitize.SanitizeError:
            caught = True
    finally:
        wr.abort()
    info["offlock_write_caught"] = caught
    check(caught, "sanitize: an off-lock write to IndexFileWriter._raw_rows "
                  "raised SanitizeError")

    # 3. the staged build of the phase's rows, sanitized
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, report = storage.run_pipeline(
        storage.SeriesStore(cfg["series"], length=LENGTH), cfg["sanitized"],
        capacity=CAPACITY, shards=OOC_SHARDS, workers=OOC_WORKERS)
    lap("build", t0)
    info["launches"]["build"] = ops.launch_counts()
    info["build_report"] = report.as_dict()
    check(info["launches"]["build"]["isax_summarize"] > 0,
          "kernel isax_summarize launched on the sanitized build")

    # 4. the tenants alone, then from threads through one coalesced drain
    loads = serve.tenant_traffic(opened, cfg["seed"], SANITIZE_TENANTS,
                                 SANITIZE_BATCH)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    isolated = []
    for q in loads:
        with session() as sess:
            isolated.append(sess.search(q, k=SERVE_K))
    lap("isolated", t0)
    results: list = [None] * SANITIZE_TENANTS
    errors: list = []
    t0 = time.perf_counter()
    with session() as sess:
        admitted = threading.Barrier(SANITIZE_TENANTS)

        def tenant(i):
            try:
                t = sess.submit(loads[i], k=SERVE_K)
                admitted.wait(timeout=DIST_TIMEOUT_S)
                results[i] = t.result(timeout=DIST_TIMEOUT_S)
            except BaseException as e:     # reported as a failed check
                errors.append(repr(e))

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(SANITIZE_TENANTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=DIST_TIMEOUT_S)
        alive = any(th.is_alive() for th in threads)
    lap("drain", t0)
    info["launches"]["walk"] = ops.launch_counts()
    for name in ("lb_scan", "fused_panel_topk"):
        check(info["launches"]["walk"][name] > 0,
              f"kernel {name} launched on the sanitized walks")
    check(not errors and not alive, "sanitize: every tenant thread's ticket "
          f"resolved with no SanitizeError ({errors})")
    same = all(r is not None and torch.equal(r.idx, w.idx)
               and torch.equal(r.dist, w.dist)
               for r, w in zip(results, isolated))
    info["drain_bitwise_isolated"] = same
    check(same, "sanitize: each tenant's drained answer bitwise its "
                "isolated SearchSession.search")
    if same:
        np.savez(work / "answers.npz",
                 queries=torch.cat(loads).cpu().numpy(),
                 idx=torch.cat([r.idx for r in results]).cpu().numpy(),
                 dist=torch.cat([r.dist for r in results]).cpu().numpy())
    (work / "child.json").write_text(json.dumps(info))
    return 1 if FAILURES else 0


def phase_sanitize(args, ooc: dict, raw, lb_blocks: int) -> dict:
    """The port's classes under the runtime lock sanitizer.  The first
    ``SANITIZE_ROWS`` rows of the on-disk phase's series file are built
    here unsanitized; a subprocess started with ``REPRO_SANITIZE=1``
    (``sanitize_child``) then builds the same rows and serves
    ``SANITIZE_TENANTS`` x ``SANITIZE_BATCH`` near-data queries at k=10
    on the unsanitized file, isolated and through one drain from
    threads (on the 10M file the walks would take ~35 s of a phase meant
    for well under a minute).  Its file must equal the unsanitized one
    byte for byte, and its drained ids the brute-force scan's over those
    rows under ``exact``'s rule.  ``lb_blocks`` are the envelope widths
    ``phase_kernels`` checked ``lb_scan`` at; the index's must be one."""
    work = OOC_DIR / "sanitize"
    work.mkdir(parents=True, exist_ok=True)
    m = min(SANITIZE_ROWS, ooc["n"])
    line = {"phase": "sanitize", "rows": m, "tenants": SANITIZE_TENANTS,
            "batch": SANITIZE_BATCH, "k": SERVE_K,
            "pipeline": list(WALK_PIPELINE), "seconds": {}}
    # 1. the phase's rows, as their own series file
    t0 = time.perf_counter()
    src = storage.SeriesStore(ooc["series"], length=LENGTH)
    series = work / "series.f32"
    for i in range(0, m, SCAN_CHUNK):
        storage.SeriesStore.append(series, src.read(i, min(i + SCAN_CHUNK,
                                                           m)))
    line["seconds"]["series"] = time.perf_counter() - t0
    # 2. the unsanitized build of those rows: the walks' index
    t0 = time.perf_counter()
    plain = work / "plain.dsix"
    storage.run_pipeline(storage.SeriesStore(series, length=LENGTH), plain,
                         capacity=CAPACITY, shards=OOC_SHARDS,
                         workers=OOC_WORKERS)
    torch.cuda.synchronize()
    line["seconds"]["plain_build"] = time.perf_counter() - t0
    n_blocks = -(-m // CAPACITY)
    line["n_blocks"] = n_blocks
    check(n_blocks == lb_blocks, f"sanitize: the walks' {n_blocks} envelope "
          f"blocks are the {lb_blocks} lb_scan was checked at")
    # 3. the sanitized subprocess
    cfg = work / "cfg.json"
    cfg.write_text(json.dumps({"index": str(plain),
                               "series": str(series),
                               "sanitized": str(work / "sanitized.dsix"),
                               "seed": args.seed}))
    env = dict(os.environ, REPRO_SANITIZE="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.sanitize_child(sys.argv[1]))", str(cfg)],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=DIST_RANKS_TIMEOUT_S)
    line["seconds"]["child"] = time.perf_counter() - t0
    check(child.returncode == 0, "sanitize: the REPRO_SANITIZE=1 subprocess "
          f"exits 0 (rc {child.returncode}: {child.stderr[-3000:]})")
    info = (json.loads((work / "child.json").read_text())
            if (work / "child.json").exists() else {})
    line["child"] = info
    # 4. the sanitized build's file, byte for byte the unsanitized one's
    t0 = time.perf_counter()
    same = (work / "sanitized.dsix").exists() and filecmp.cmp(
        plain, work / "sanitized.dsix", shallow=False)
    line["seconds"]["compare"] = time.perf_counter() - t0
    line["build_bitwise_unsanitized"] = same
    check(same, "sanitize: the sanitized pipeline's file is bitwise the "
                "unsanitized one's")
    # 5. the drained answers against the brute-force scan
    answers = work / "answers.npz"
    if check(answers.exists(), "sanitize: the subprocess wrote its answers"):
        ans = np.load(answers)
        dev = raw.device
        q = torch.from_numpy(ans["queries"]).to(dev)
        got = core.SearchResult(
            dist=torch.from_numpy(ans["dist"]).to(dev),
            idx=torch.from_numpy(ans["idx"]).to(dev), stats=None)
        t0 = time.perf_counter()
        want = core.search_scan(raw[:m], q, k=SERVE_K)
        torch.cuda.synchronize()
        line["seconds"]["scan"] = time.perf_counter() - t0
        line["vs_brute_force"] = _dist_ok("sanitize drain k=10", got, want,
                                          isax.znorm(q), raw)
    shutil.rmtree(work, ignore_errors=True)
    launches: dict[str, int] = {}
    for counts in info.get("launches", {}).values():
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
    for name in ("isax_summarize", "lb_scan", "fused_panel_topk"):
        check(launches.get(name, 0) > 0,
              f"kernel {name} launched on the sanitize path")
    line["launches"] = launches
    emit(line)
    return launches

DIST4_CASES = ("block_major_k1", "block_major_k10", "query_major_k10",
               "scan_k10")
DIST4_KERNELS = {"block_major_k1": PATH_KERNELS["block_major"],
                 "block_major_k10": PATH_KERNELS["block_major"],
                 "query_major_k10": PATH_KERNELS["query_major"],
                 "scan_k10": PATH_KERNELS["ucr"]}


def _dist4_rank(rank: int, cfg: dict) -> None:
    """One rank of ``phase_dist4`` (a spawned process): its range of the
    series file, its shard with global ids, the sharded searches between
    barriers, its shard saved; results to ``cfg["out"]``."""
    import torch.distributed as tdist
    from datetime import timedelta
    started = time.time() - cfg["t0"]
    dev = torch.device(cfg["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    world = cfg["world"]
    tdist.init_process_group("gloo", init_method=cfg["init"],
                             world_size=world, rank=rank,
                             timeout=timedelta(seconds=cfg["timeout"]))
    grouped = time.time() - cfg["t0"]
    try:
        per = cfg["n"] // world
        lo = rank * per
        store = storage.SeriesStore(cfg["series"], length=LENGTH)
        t0 = time.perf_counter()
        rows = store.read(lo, lo + per)
        read_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        local = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        shard = distributed.build_sharded(local, lo, capacity=CAPACITY,
                                          device=dev)
        sync()
        info = {"rank": rank, "rows": [lo, lo + per], "started": started,
                "grouped": grouped, "read_seconds": read_s,
                "build_seconds": time.perf_counter() - t0,
                "launches": {"build": ops.launch_counts()}, "seconds": {}}
        q = torch.from_numpy(np.load(cfg["queries"])).to(dev)
        runs = {
            "block_major_k1": lambda: distributed.search_sharded(
                shard, q, k=1, device=dev),
            "block_major_k10": lambda: distributed.search_sharded(
                shard, q, k=10, device=dev),
            "query_major_k10": lambda: distributed.search_sharded(
                shard, q, k=10, schedule="query_major",
                blocks_per_iter=QUERY_MAJOR_BLOCKS, device=dev),
            "scan_k10": lambda: distributed.search_sharded_scan(
                local, lo, q, k=10, device=dev),
        }
        out = {}
        for name in DIST4_CASES:
            tdist.barrier()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = runs[name]()
            sync()
            tdist.barrier()
            info["seconds"][name] = time.perf_counter() - t0
            info["launches"][name] = ops.launch_counts()
            out[name + "_dist"] = res.dist.cpu().numpy()
            out[name + "_idx"] = res.idx.cpu().numpy()
            for f in res.stats._fields:
                out[name + "_" + f] = getattr(res.stats, f).cpu().numpy()
        info["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                        if cuda else None)
        t0 = time.perf_counter()
        storage.save_index(shard, cfg["shards"][rank])
        info["save_seconds"] = time.perf_counter() - t0
        np.savez(Path(cfg["out"]) / f"rank{rank}.npz", **out)
        tdist.barrier()
        info["done"] = time.time() - cfg["t0"]
        (Path(cfg["out"]) / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        tdist.destroy_process_group()


def _spawn_ranks(fn, world: int, cfg: dict, timeout_s: float) -> bool:
    """Run ``fn(rank, cfg)`` in ``world`` spawned processes; -> whether
    every rank ended cleanly within ``timeout_s``.  A rank that raises or
    dies, or a run past the limit (the others are then killed), fails."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=(cfg,), nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                check(False, f"{world} ranks ended within {timeout_s} s")
                return False
        return True
    except Exception as e:     # torch's ProcessRaisedException / ...Exited
        check(False, f"every rank ended cleanly: {e}")
        return False
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=30)


def phase_dist4(args, ooc: dict, queries_np: np.ndarray) -> dict:
    """The two-round protocol across 4 processes on the one card, over
    gloo: each rank builds its quarter of the on-disk phase's series file
    with global ids, runs ``search_sharded`` (block-major k=1 and 10,
    query-major k=10) and ``search_sharded_scan`` (k=10), and saves its
    shard for ``dist_ooc``.  The ids are checked against the brute-force
    scan, and every rank must hold the same answer."""
    n, ref = ooc["n"], ooc["ucr10"]
    dev = ref.dist.device
    out = OOC_DIR / "dist4"
    out.mkdir(parents=True, exist_ok=True)
    # the queries go by file: a spawn argument over the pipe's 64 KiB
    # blocks each start until that child has imported this module
    np.save(out / "queries.npy", queries_np)
    cfg = {"world": DIST_WORLD, "n": n, "series": str(ooc["series"]),
           "queries": str(out / "queries.npy"), "out": str(out),
           "device": str(dev),
           "init": _group_init("dist4"), "timeout": DIST_TIMEOUT_S,
           "t0": time.time(),
           "shards": [str(OOC_DIR / f"shard{r}.dsix")
                      for r in range(DIST_WORLD)]}
    line = {"phase": "dist4", "world_size": DIST_WORLD, "backend": "gloo",
            "series": n, "series_per_rank": n // DIST_WORLD,
            "queries": queries_np.shape[0]}
    launches: dict[str, int] = {}
    if not check(n % DIST_WORLD == 0, f"dist4: the {n} series divide "
                                      f"into {DIST_WORLD} equal ranges"):
        emit(line)
        return launches
    t0 = time.perf_counter()
    ok = _spawn_ranks(_dist4_rank, DIST_WORLD, cfg, DIST_RANKS_TIMEOUT_S)
    line["seconds"] = time.perf_counter() - t0
    if not ok:
        emit(line)
        return launches
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(DIST_WORLD)]
    infos = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(DIST_WORLD)]
    check(all(Path(f).exists() for f in cfg["shards"]),
          "dist4: every rank saved its shard")
    # started / grouped / done: seconds after the spawn to the rank's
    # first line, to its group's forming, to its last barrier
    line["ranks"] = [{key: i[key] for key in
                      ("rank", "rows", "started", "grouped", "read_seconds",
                       "build_seconds", "save_seconds", "done",
                       "max_memory_allocated")}
                     for i in infos]
    q = isax.znorm(torch.from_numpy(queries_np).to(dev))
    rows = _SeriesRows(storage.SeriesStore(ooc["series"], length=LENGTH),
                       dev)
    for name in DIST4_CASES:
        r0 = ranks[0]
        same = all(np.array_equal(r[key], r0[key]) for r in ranks[1:]
                   for key in r0 if key.startswith(name + "_"))
        check(same, f"dist4 {name}: every rank holds the same answer")
        res = core.SearchResult(
            dist=torch.from_numpy(r0[name + "_dist"]).to(dev),
            idx=torch.from_numpy(r0[name + "_idx"]).to(dev),
            stats=core.SearchStats(*(torch.from_numpy(r0[name + "_" + f])
                                     for f in core.SearchStats._fields)))
        summed = {p: sum(i["launches"][name][p] for i in infos)
                  for p in infos[0]["launches"][name]}
        for kernel in DIST4_KERNELS[name]:
            check(summed[kernel] > 0, f"kernel {kernel} launched on the "
                                      f"dist4 {name} path")
        for kernel, c in summed.items():
            launches[kernel] = launches.get(kernel, 0) + c
        line[name] = {
            "seconds_rank0": infos[0]["seconds"][name],
            "seconds_by_rank": [i["seconds"][name] for i in infos],
            "blocks_visited_sum": int(res.stats.blocks_visited.sum()),
            "blocks_visited_mean": float(res.stats.blocks_visited.double()
                                         .mean()),
            "series_refined_mean": float(res.stats.series_refined.double()
                                         .mean()),
            "iters": int(res.stats.iters), "launches": summed,
            "ranks_agree": same,
            "vs_brute_force": _dist_ok(f"dist4 {name}", res, ref, q, rows)}
    build = {p: sum(i["launches"]["build"][p] for i in infos)
             for p in infos[0]["launches"]["build"]}
    check(build["isax_summarize"] > 0,
          "kernel isax_summarize launched on the dist4 build")
    launches["isax_summarize"] = (launches.get("isax_summarize", 0)
                                  + build["isax_summarize"])
    line["launches"] = launches
    emit(line)
    return launches


def phase_dist_ooc(ooc: dict, queries) -> dict:
    """``search_sharded_ooc`` over 4 ``SearchSession``s on dist4's shard
    files, from a cold disk, k=10, at ``WALK_PIPELINE``, checked against
    the brute-force scan."""
    shards = [OOC_DIR / f"shard{r}.dsix" for r in range(DIST_WORLD)]
    line = {"phase": "dist_ooc", "shards": DIST_WORLD,
            "cache_blocks": OOC_CACHE_BLOCKS}
    if not check(all(p.exists() for p in shards),
                 "dist_ooc: dist4's shard files exist"):
        emit(line)
        return {}
    opened = [storage.open_index(p) for p in shards]
    dropped = all([_drop_page_cache(p) for p in shards])
    d, g = WALK_PIPELINE
    line["pipeline"] = [d, g]
    sessions = [storage.SearchSession(o, cache_blocks=OOC_CACHE_BLOCKS,
                                      pipeline_depth=d, group_blocks=g)
                for o in opened]
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = distributed.search_sharded_ooc(sessions, queries, k=10)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        for s in sessions:
            s.close()
    for name in ("lb_scan", "fused_panel_topk"):
        check(launches[name] > 0, f"kernel {name} launched on the dist_ooc "
                                  "path")
    q = isax.znorm(queries)
    rows = _SeriesRows(storage.SeriesStore(ooc["series"], length=LENGTH),
                       q.device)
    line.update({"page_cache_dropped": dropped,
                 **_io_line(res, secs),
                 "bytes_scan": res.io.bytes_scan,
                 "blocks_total": res.io.blocks_total,
                 "blocks_visited_sum": int(res.stats.blocks_visited.sum()),
                 "launches": launches,
                 "vs_brute_force": _dist_ok("dist_ooc k=10", res,
                                            ooc["ucr10"], q, rows)})
    emit(line)
    return launches


REPLACES = {
    "isax_summarize": ("src/repro_torch/kernels/csrc/isax_summarize.cu",
                       "src/repro/kernels/isax_summarize.py:41"),
    "lb_scan": ("src/repro_torch/kernels/csrc/lb_scan.cu",
                "src/repro/kernels/lb_scan.py:38"),
    "block_topk": ("src/repro_torch/kernels/csrc/block_topk.cu",
                   "src/repro/kernels/block_topk.py:78"),
    "fused_panel_topk": ("src/repro_torch/kernels/csrc/fused_refine.cu",
                         "src/repro/kernels/fused_refine.py:91"),
    "batch_l2": ("src/repro_torch/kernels/csrc/batch_l2.cu",
                 "src/repro/kernels/batch_l2.py:36"),
    "dtw_band_panel": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                       "src/repro/kernels/dtw_band.py:66"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:54"),
    "ssm_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                     "none: the reference differentiates the jnp chunked "
                     "scan, src/repro/models/mamba.py:71 (its Pallas "
                     "ssm_scan, src/repro/kernels/ssm_scan.py:54, has no "
                     "backward)"),
}

# the path whose launch count the kernels line reports for each kernel
LAUNCH_PATH = {"isax_summarize": "block_major", "lb_scan": "flat",
               "block_topk": "block_major", "fused_panel_topk": "block_major",
               "batch_l2": "flat", "dtw_band_panel": "dtw", "ssm_scan": "lm",
               "ssm_scan_bwd": "hybrid_train"}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--dtw-queries", type=int, default=10)
    ap.add_argument("--lm-batch", type=int, default=LM_BATCH)
    ap.add_argument("--lm-prompt", type=int, default=LM_PROMPT)
    ap.add_argument("--lm-gen", type=int, default=LM_GEN)
    ap.add_argument("--lm-smoke", action="store_true",
                    help="the LM phases (lm, dense, train, families) on "
                         "smoke() configs at --lm-prompt / --lm-gen sizes")
    ap.add_argument("--ooc-series", type=int, default=None,
                    help="series the on-disk phase writes (default all; "
                         "cut in whole millions to fit half the free disk)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.analysis import sanitize
    if sanitize.enabled():
        print("chip_smoke: refusing to time with REPRO_SANITIZE set: the "
              "instrumented locks would be measured instead of the plain "
              "ones (the sanitize phase arms its own subprocess)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # no fp32 product in TF32
    torch.backends.cudnn.allow_tf32 = False

    dev = phase_device()
    phase_build()
    raw = random_walk_cuda(args.n_series, LENGTH, args.seed)
    queries = random_walk_cuda(args.queries, LENGTH, args.seed + 1)
    index, main_results, main_launches = phase_main(args, raw, queries)
    sched_results, launches = phase_schedules(index, queries)
    launches["block_major"] = main_launches
    ucr_results, launches["ucr"] = phase_ucr(raw, queries)
    dtw_results, launches["dtw"] = phase_dtw(
        index, raw, queries[:args.dtw_queries].contiguous(), args.queries)
    launches["lm"], scan_in = phase_lm(args)
    launches["dense"] = phase_dense(args)
    launches["train"] = phase_train(args)
    launches["families"] = phase_families(args)
    launches["hybrid_train"], train_in = phase_hybrid_train(args)
    launches["mesh"] = phase_mesh(args)
    phase_roofline(args)
    # the envelope widths of the sanitize phase's index (its rows of the
    # on-disk phase's series) and of a dist4 shard
    ooc_n = min(args.ooc_series or args.n_series, args.n_series)
    sanitize_blocks = -(-min(SANITIZE_ROWS, ooc_n) // CAPACITY)
    lines = phase_kernels(raw, index, queries,
                          min(SUMMARIZE_SLICE, args.n_series),
                          args.dtw_queries, scan_in, main_results[10][0],
                          sanitize_blocks,
                          -(-(ooc_n // DIST_WORLD) // CAPACITY), train_in,
                          args.seed)
    phase_exact(raw, queries, {"block_major": main_results, **sched_results,
                               "ucr": ucr_results})
    try:
        launches["ooc"], ooc = phase_ooc(args, raw, index, queries,
                                         {"block_major": main_results,
                                          "ucr": ucr_results},
                                         dtw_results[10][0])
        launches["dist1"] = phase_dist1(index, queries, main_results)
        if ooc is not None:
            launches["serve"] = phase_serve(args, ooc)
            phase_analysis()
            launches["sanitize"] = phase_sanitize(args, ooc, raw,
                                                  sanitize_blocks)
            # the ranks share the card: free the main process's series
            # and index first
            del raw, index
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            launches["dist4"] = phase_dist4(args, ooc,
                                            queries.cpu().numpy())
            launches["dist_ooc"] = phase_dist_ooc(ooc, queries)
    finally:
        shutil.rmtree(OOC_DIR, ignore_errors=True)

    kernels = []
    for name, line in lines.items():
        source, replaces = REPLACES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[LAUNCH_PATH[name]][name],
                        "launches_path": LAUNCH_PATH[name],
                        "launches_by_path": {p: c[name] for p, c in
                                             launches.items() if c.get(name)},
                        "match": line["match"],
                        "max_abs_err": line["max_abs_err"], "ms": line["ms"],
                        "device_ms": line["device_ms"],
                        "plain_ms": line["plain_ms"],
                        "bound_ms": line["bound_ms"],
                        "bound_by": line["bound_by"],
                        "bound_unit": line["bound_unit"],
                        "library_ms": line["library_ms"],
                        **({"cases": line["cases"]}
                           if name == "lb_scan" else {})})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": kernels})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:\n  "
              + "\n  ".join(FAILURES), file=sys.stderr)
        return 1
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
