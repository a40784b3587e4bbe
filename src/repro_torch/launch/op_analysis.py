"""Loop-aware cost count of one call of a step, from the operations it
dispatches.

The counterpart of ``repro.launch.hlo_analysis``.  There is no HLO in
the port: a ``TorchDispatchMode`` sees every ATen operation a call runs,
on meta tensors (no memory, no card) or on real ones, and totals the
three roofline inputs by the reference's rules:

  * FLOPs — a matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
    ``dot``) is 2 * prod(output dims) * the contracted dim, reported as
    ``dot_flops`` and split by the operands' type (``dot_by_dtype``:
    bf16 / fp32 / fp64, each priced on its own unit); every other
    operation that is not a view counts one FLOP an output element;
  * HBM bytes — every operation that is not a view writes its output
    once; operand reads are deduplicated over a loop body (the reference
    deduplicates per HLO computation): a tensor read by several
    operations of one body counts once.  Views are free; a gather
    (``index``, ``index_select``, ``gather``, ``embedding``) reads what
    it gathers, not its whole source; an in-place scatter
    (``index_put_``, ``index_add_``, ``scatter_add_``, ...) writes what
    it scatters, not its whole destination (a decode step's cache write
    moves one token's K/V);
  * collective bytes — each ``c10d`` collective the call dispatches:
    all-reduce twice its tensor (ring reduce-scatter + all-gather),
    all-gather, reduce-scatter and all-to-all once (``COLLECTIVES``).
    A count passes a fake process group of the mesh's size
    (``fake_group``), so no rank has to exist.

Each call of a hand-written kernel (``kernels/ops.py``) is recorded by
name with its work from ``launch.roofline.kernel_work`` (bytes, fp32
operations, exps), not from the operations that implement it, so a count
reads the same whether the card's kernel, the CPU's plain version or
the meta device's shapes ran.

**Loops.**  XLA keeps a scanned layer stack as one ``while`` body, and
the reference multiplies that body by its ``known_trip_count``.  Here a
layer stack is a host loop, and counting every layer of a 96-layer
model, every chunk of a 32k-token attention, takes minutes; so the
loops ``models.common.identical`` marks (each run of identical layers
of ``transformer.segments``, Whisper's encoder and decoder, RWKV's
blocks, a query chunk's causal KV chunks, a step's microbatches) run
one body, whose work is multiplied by the loop's length; under autograd
three, the first, the last, and one between them multiplied by the
length less two, since the two ends differ in their backward.  Runs of
one layer kind share their bodies; a step's first microbatch differs
from the rest, which one body stands for.  A body's backward
is found by the autograd node that runs it: each node records the
sequence number it was made with, and the body's forward spans a range
of them.  ``count(..., loop_aware=False)`` runs every body, each once,
under the same rules: the two agree exactly, FLOPs, bytes and kernel
calls (tests/test_torch_roofline.py).  Operations the count cannot
price (a convolution, a fused attention) count one FLOP an output
element and go into ``warnings``, as the reference flags a ``while``
without a trip count.

**Peak bytes.**  Storages are tracked as they are made and freed: the
arguments plus the largest sum of live storages during the call.  A
skipped body's storages are not made, so each body adds (multiplier
- 1) times what it left alive (a training step's saved layer inputs);
this part is an estimate, the rest a count.  ``n_ops`` counts the
operations priced, kernel calls included: about one launch each on the
card, which is what a host-bound step pays for.

**Speed.**  Most of a count's time is the meta kernels, which work out
an output's shape in Python.  An operation whose outputs alias no input
runs its meta kernel once a signature (the operands' layouts and the
other arguments); a later call of the same signature gets empty meta
outputs of the recorded layout.  A count on real tensors runs every
operation, and equals the count on meta ones (tests/test_torch_roofline.py).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import math
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.models import common

aten = torch.ops.aten
META = torch.device("meta")

COLLECTIVES = {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
               "all-to-all": 1}
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all"}

_DOTS = {aten.mm.default: 0, aten.bmm.default: 0, aten.mv.default: 0,
         aten.dot.default: 0, aten.addmm.default: 1,
         aten.baddbmm.default: 1, aten.addmv.default: 1}
_DOT_CLASS = {torch.bfloat16: "bf16", torch.float16: "bf16",
              torch.float32: "fp32", torch.float64: "fp64"}
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.detach.default,
         aten.alias.default, aten.lift_fresh.default,
         aten._unsafe_view.default}
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# in-place scatters -> the operand holding what they write
_SCATTERS = {aten.index_put_.default: 2, aten._index_put_impl_.default: 2,
             aten.index_copy_.default: 3, aten.index_add_.default: 3,
             aten.scatter_.src: 3, aten.scatter_add_.default: 3,
             aten.scatter_reduce_.two: 3, aten.scatter_.value: 2}
_OVERWRITES = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}
_UNPRICED = {aten.convolution.default,
             aten._scaled_dot_product_flash_attention.default,
             aten._scaled_dot_product_efficient_attention.default}


@dataclasses.dataclass
class CostTotals:
    """One call's count, loops multiplied out."""
    flops: int = 0
    dot_flops: int = 0
    dot_by_dtype: dict = dataclasses.field(default_factory=dict)
    kernel_flops: int = 0        # the kernels' operations (in ``flops``)
    bytes: int = 0
    coll_bytes: int = 0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    flops_once: int = 0          # every counted loop body once
    n_ops: int = 0               # priced operations: about a launch each
    arg_bytes: int = 0
    peak_bytes: int = 0          # arguments + the largest live sum
    warnings: list = dataclasses.field(default_factory=list)

    @property
    def kernel_calls(self) -> dict[str, int]:
        return {k: v["calls"] for k, v in self.kernels.items()}


class _Body:
    """What one loop body (or the call outside every body) did, before
    its multiplier."""

    def __init__(self, mult: int, parent: "_Body | None"):
        self.mult, self.parent = mult, parent
        self.t = CostTotals()
        self.read: set = set()
        self.retained = 0
        self.seq = (0, 0)          # the autograd sequence numbers its
        #                            forward spans, once it has closed

    def weight(self) -> int:
        w, b = 1, self
        while b is not None:
            w, b = w * b.mult, b.parent
        return w


_FRESH: dict = {}                # op -> whether its outputs alias no input


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _leaves(tree) -> list:
    """The leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return [y for x in tree for y in _leaves(x)]
    if isinstance(tree, dict):
        return [y for x in tree.values() for y in _leaves(x)]
    return [tree]


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


class _NotMeta(Exception):
    pass


def _sig(tree):
    """A hashable signature of an operation's arguments: each meta
    tensor's layout, the other values with their types."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_meta:
            raise _NotMeta
        return tree.dtype, tree.shape, tree.stride(), tree.storage_offset()
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(_sig(x) for x in tree)
    if isinstance(tree, dict):
        return tuple((k, _sig(v)) for k, v in tree.items())
    return type(tree), tree          # 1, 1.0 and True differ here


class _Counter(TorchDispatchMode):

    def __init__(self, loop_aware: bool):
        super().__init__()
        self.loop_aware = loop_aware
        self.top = _Body(1, None)
        self.bodies = [self.top]
        self.stack = [self.top]
        self.ranges: list[tuple[int, int, _Body]] = []
        self.memo: dict = {}
        self.quiet = 0            # inside a kernel call: no op is priced
        self.ids: dict[int, int] = {}
        self.serial = 0
        self.live = self.peak = 0
        self.layouts: dict = {}   # meta outputs by signature (``_run``)

    # -- storages ---------------------------------------------------------

    def _sid(self, t: torch.Tensor) -> int:
        """A serial of ``t``'s storage, counted live until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        sid = self.ids.get(key)
        if sid is None:
            self.serial += 1
            sid = self.ids[key] = self.serial
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key, n).atexit = False
        return sid

    def _freed(self, key: int, n: int) -> None:
        self.ids.pop(key, None)
        self.live -= n

    # -- the meta kernels, once a signature ---------------------------------

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on meta tensors, an operation that
        makes fresh meta outputs runs its meta kernel once a signature
        (op, arguments' shapes, strides and dtypes, the other arguments),
        and later calls get empty outputs of the same layout."""
        fresh = _FRESH.get(func)
        if fresh is None:
            schema = func._schema
            fresh = _FRESH[func] = not any(
                a.alias_info is not None
                for a in (*schema.arguments, *schema.returns))
        try:
            key = (func, _sig(args), _sig(kwargs)) if fresh else None
            hit = self.layouts.get(key)
        except (TypeError, _NotMeta):      # unhashable; a real tensor
            key = hit = None
        if hit is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if key is not None and all(isinstance(o, torch.Tensor)
                                       and o.is_meta for o in outs):
                self.layouts[key] = type(out), [
                    (o.shape, o.stride(), o.dtype) for o in outs]
            return out
        kind, layouts = hit
        outs = [torch.empty_strided(shape, stride, dtype=dtype, device=META)
                for shape, stride, dtype in layouts]
        return outs[0] if kind is torch.Tensor else kind(outs)

    # -- where an operation's work goes ------------------------------------

    def _body(self, node=None) -> _Body:
        """The body an operation's work goes to: in a backward, the one
        whose forward made the autograd node running it, or a body opened
        inside that one (a checkpointed layer's recomputed KV loop); else
        the innermost open one."""
        inner = self.stack[-1]
        if node is None or not self.ranges:
            return inner
        seq = node._sequence_nr()
        i = bisect.bisect_right(self.ranges, (seq, math.inf)) - 1
        body = self.ranges[i][2] if i >= 0 else None
        while body is not None and not body.seq[0] <= seq < body.seq[1]:
            body = body.parent
        if body is None or body is self.top:
            return inner
        b = inner
        while b is not None and b is not body:
            b = b.parent
        return inner if b is body else body

    def _read(self, body: _Body, t: torch.Tensor) -> None:
        key = (self._sid(t), t.storage_offset(), tuple(t.shape),
               tuple(t.stride()), t.dtype)
        if key not in body.read:
            body.read.add(key)
            body.t.bytes += _bytes(t)

    # -- the dispatch -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten._to_copy.default and args[0].is_meta \
                and kwargs.get("device", META) != META:
            # a message moved to where the group's backend takes it (the
            # host for gloo): with NCCL it stays on the card, so it is free
            out = func(*args, **{**kwargs, "device": META})
            self._sid(out)
            return out
        out = self._run(func, args, kwargs)
        outs = _tensors(out)
        for t in outs:
            self._sid(t)
        if self.quiet or func in _FREE or func.is_view:
            return out
        node = torch._C._current_autograd_node()
        if node is not None and node.name() == "UnbindBackward0" \
                and func is not aten.stack.default:
            # the zeros it fills in for the layers a loop-aware count did
            # not run: no work of the step (a whole run fills none)
            return out
        body = self._body(node)
        body.t.n_ops += 1
        if func.namespace == "c10d":
            self._collective(body, func, args)
            return out
        if func in _SCATTERS:
            self._scatter(body, func, args)
            return out
        t = body.t
        n_out = sum(o.numel() for o in outs)
        if func in _DOTS:
            lhs = args[_DOTS[func]]
            f = 2 * n_out * lhs.shape[-1]
            t.flops += f
            t.dot_flops += f
            cls = _DOT_CLASS.get(lhs.dtype, "fp32")
            t.dot_by_dtype[cls] = t.dot_by_dtype.get(cls, 0) + f
        else:
            t.flops += n_out
            if func in _UNPRICED:
                msg = f"{func}: counted at one FLOP an output element"
                if msg not in self.top.t.warnings:
                    self.top.t.warnings.append(msg)
        t.bytes += sum(_bytes(o) for o in outs)
        if func in _GATHERS:
            t.bytes += sum(_bytes(o) for o in outs)       # what it gathers
            for i in _tensors((args[1:], kwargs)):
                if i.dtype in (torch.int32, torch.int64, torch.bool):
                    self._read(body, i)
            return out
        inputs = _tensors((args, kwargs))
        if func in _OVERWRITES:
            inputs = inputs[1:]
        for i in inputs:
            self._read(body, i)
        return out

    def _scatter(self, body: _Body, func, args) -> None:
        """An in-place scatter writes (and prices) what it scatters; it
        reads that and the indices, not its destination."""
        src = args[_SCATTERS[func]]
        if func is aten.scatter_.value:
            n = src.numel()                 # the index: one value a slot
        elif func in (aten.index_put_.default,
                      aten._index_put_impl_.default):
            idx = args[1]
            n = src.numel()
            if all(i is not None for i in idx):
                lead = torch.broadcast_shapes(*(i.shape for i in idx))
                n = max(n, math.prod(lead)
                        * math.prod(args[0].shape[len(idx):]))
        else:
            n = src.numel()
        for i in _tensors(args[1:]):
            self._read(body, i)
        body.t.flops += n
        body.t.bytes += n * args[0].element_size()

    def _collective(self, body: _Body, func, args) -> None:
        name = _C10D.get(func._opname)
        if name is None:
            return
        nbytes = sum(_bytes(x) for x in _tensors(args[0]))
        body.t.coll_bytes += nbytes * COLLECTIVES[name]
        body.t.coll_by_op[name] = (body.t.coll_by_op.get(name, 0)
                                   + nbytes * COLLECTIVES[name])
        body.t.bytes += nbytes

    # -- kernels and loops (called by ops and models.common) ---------------

    @contextlib.contextmanager
    def kernel_call(self, name: str, operands: dict):
        work = roofline.kernel_work(name, operands)
        t = self._body(torch._C._current_autograd_node()).t
        k = t.kernels.setdefault(name, {"calls": 0, "bytes": 0, "ops": {}})
        k["calls"] += 1
        k["bytes"] += work.nbytes
        for cls, n in work.ops.items():
            k["ops"][cls] = k["ops"].get(cls, 0) + n
        t.bytes += work.nbytes
        t.flops += sum(work.ops.values())
        t.kernel_flops += sum(work.ops.values())
        self.quiet += 1
        try:
            yield
        finally:
            self.quiet -= 1

    @contextlib.contextmanager
    def _scope(self, mult: int):
        body = _Body(mult, self._body(torch._C._current_autograd_node()))
        self.bodies.append(body)
        self.stack.append(body)
        live0 = self.live
        start = torch._C._autograd._get_sequence_nr()
        body.seq = (start, start)
        try:
            yield body
        finally:
            self.stack.pop()
            body.seq = (start, torch._C._autograd._get_sequence_nr())
            body.retained = self.live - live0
            bisect.insort(self.ranges, (start, body.seq[1], body),
                          key=lambda r: r[:2])

    def loop(self, items: list, key: str, first_differs: bool):
        return self._loop(items, key, first_differs) if items else iter(())

    def _loop(self, items, key, first_differs):
        if not self.loop_aware:
            for it in items:
                with self._scope(1):
                    yield it
            return
        if first_differs:
            with self._scope(1):
                yield items[0]
            if len(items) > 1:
                with self._scope(len(items) - 1):
                    yield items[1]
            return
        memo = (id(self.stack[-1]), key)
        body = self.memo.get(memo) if key is not None else None
        if body is not None:               # a later run of the same body
            body.mult += len(items)
            return
        # without autograd the bodies are alike: one stands for all.
        # Under it, three: the first, whose carried inputs need no
        # gradient (a KV chunk's running softmax starts from constants);
        # the last run forward, whose backward comes first and so starts
        # the sum of a gradient every body adds into one tensor made
        # before the loop (Whisper's encoder output, a query chunk); and
        # one for those between
        n = len(items)
        if not torch.is_grad_enabled():
            with self._scope(n) as body:
                yield items[0]
            if key is not None:
                self.memo[memo] = body
            return
        with self._scope(1) as body:
            yield items[0]
        if n > 2:
            with self._scope(n - 2) as body:
                yield items[1]
        if n > 1:
            with self._scope(1):
                yield items[-1]
        if key is not None:
            self.memo[memo] = body

    # -- totals -------------------------------------------------------------

    def totals(self) -> CostTotals:
        out = CostTotals(warnings=list(self.top.t.warnings))
        for b in self.bodies:
            w, t = b.weight(), b.t
            out.flops += w * t.flops
            out.flops_once += t.flops
            out.dot_flops += w * t.dot_flops
            out.kernel_flops += w * t.kernel_flops
            out.n_ops += w * (t.n_ops + sum(k["calls"]
                                            for k in t.kernels.values()))
            out.bytes += w * t.bytes
            out.coll_bytes += w * t.coll_bytes
            for src, dst in ((t.dot_by_dtype, out.dot_by_dtype),
                             (t.coll_by_op, out.coll_by_op)):
                for k, v in src.items():
                    dst[k] = dst.get(k, 0) + w * v
            for name, k in t.kernels.items():
                o = out.kernels.setdefault(name, {"calls": 0, "bytes": 0,
                                                  "ops": {}})
                o["calls"] += w * k["calls"]
                o["bytes"] += w * k["bytes"]
                for cls, n in k["ops"].items():
                    o["ops"][cls] = o["ops"].get(cls, 0) + w * n
        # a skipped body's storages were never made: each run adds what
        # its body left alive, once for each body it stands for
        extra = sum((b.mult - 1) * max(b.retained, 0)
                    for b in self.bodies[1:])
        out.peak_bytes = self.peak + extra
        return out


def count(fn, *args, loop_aware: bool = True, **kwargs) -> CostTotals:
    """Run ``fn(*args, **kwargs)`` once under the counter and return its
    totals (``loop_aware=False``: every loop body run and counted)."""
    counter = _Counter(loop_aware)
    for t in _tensors((args, kwargs)):
        counter._sid(t)
    arg_bytes = counter.live
    if ops._observer is not None or common.loop_counter is not None:
        raise RuntimeError("a count is already running")
    ops._observer = common.loop_counter = counter
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        ops._observer = common.loop_counter = None
    out = counter.totals()
    out.arg_bytes = arg_bytes
    return out


# ---------------------------------------------------------------------------
# A process group of any size, with no ranks behind it
# ---------------------------------------------------------------------------

_WORLD = 512                     # the reference's dry run: 512 placeholders
_GROUPS: dict[tuple, object] = {}


def fake_group(size: int, axis: str = "data"):
    """A group of ``size`` ranks on torch's fake backend, which accepts
    every collective and moves nothing; this process is rank 0.  Groups
    are kept by mesh axis and size, so a mesh's "data" and "model" axes
    of one size get a group each.  It initializes the default group (a
    world of 512) on first use, so call it in a process that runs no
    real group (``launch.dryrun`` does)."""
    if size > _WORLD:
        raise ValueError(f"a fake group holds at most {_WORLD} ranks")
    if not dist.is_initialized():
        # importing fake_pg registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=_WORLD)
    if (axis, size) not in _GROUPS:
        _GROUPS[axis, size] = dist.new_group(list(range(size)))
    return _GROUPS[axis, size]


def close_fake_groups() -> None:
    """Destroy the fake groups and the default group ``fake_group`` made,
    so that the process can start a real one."""
    if _GROUPS:
        _GROUPS.clear()
        dist.destroy_process_group()
