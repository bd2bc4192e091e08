"""The op census of one step: FLOPs, bytes, op counts, peak live bytes
and each kernel's launches and work, on any device, the meta device
included (the port's counterpart of ``repro/utils/hlo.py`` and of XLA's
``cost_analysis()`` / ``memory_analysis()``, which the reference's dry
run reads).

:class:`Census` is a ``TorchDispatchMode``. For every aten op it counts

- matmul and conv FLOPs, by ``torch.utils.flop_counter``'s formulas;
- bytes: each tensor argument read once and each output written once,
  as XLA's "bytes accessed" counts an HLO op's operands and outputs (a
  stride-0 dim counts once; views, and allocations that write nothing,
  are free);
- the op, by name;
- live bytes: a new storage is added when an op makes it and taken off
  when it dies; the storages already there when the count starts
  (parameters, optimizer state, inputs, caches) count from the start
  (``base_bytes``), and the peak is the largest sum.

It counts the work of one device (``device``): ops that touch no tensor
there (host-side ones, such as checkpointing's copy of the CPU's RNG
state in a CUDA program) and other devices' bytes and storages are left
out, so a step counts the same on the card and on meta.

A kernel op of :mod:`repro_torch.kernels.ops` (B2 ``flash_attention``,
B3 ``decode_attention``, B4 ``mamba_scan``, B5 ``mlstm_scan``, B1
``quantize_boundary`` and the STE forward) hands its call to the census,
which makes it a *kernel span*:

- **fused** (the default, the program the card runs): the op takes the
  card's structure (the same autograd Functions), and each launch adds
  its kernel's ``work()`` once and counts one launch; the body does not
  count. On a CUDA tensor the body is the kernel itself; on a meta
  tensor it is the wrapper's checks and allocations without the launch
  (its ``*_meta`` twin), so the dry run allocates what the card does; on
  a CPU tensor it is the plain version, for its values. The backward of
  B2 (``flash_attention_bwd_plain``) and of B4 and B5 (the plain scan,
  recomputed) is plain PyTorch on the card and counts op by op.
- **plain**: the plain version counts op by op, as the reference's count
  of its jnp paths does; each kernel's share is kept in
  ``plain_kernels``.

Recurrences are counted by the reference's top-up (``dryrun.py``,
``_scan_topup``): the sLSTM token loop in both modes and the plain
chunked scans in plain mode run uncounted (on meta they make their
outputs only); the census records each call's trips and, when it
exits, counts the body's first two and first three trips on fresh meta
inputs of the call's shapes, forward and (where the call was
differentiated) backward apart, and adds two trips' count plus (trips -
2) times the difference, for each forward call (a remat recompute is
another call) and each backward. From the third trip on every trip of
these loops does the same work (a trip's backward writes the whole
sequence's gradient, so the trips are counted at the call's full
length), and the count is that of the whole loop op by op. The
reference's top-up takes one and two trips: the plain scans' first
trips differ in their backward (the carried state needs no gradient
before the second trip, nor its update before the third).

On one card there is no collective: ``collectives`` holds the five keys
of ``hlo.collective_stats``, each zero.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import (decode_attn, flash_attn, mamba_scan,
                                 mlstm_scan, ops, split_quant)
from repro_torch.kernels.recompute import flat, recompute_grads

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# allocations that write nothing: no bytes moved
_ALLOC_ONLY = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}
# Not work: a tensor made from Python data (``torch.tensor``) is lifted
# on a real device and not on meta.
_NOT_COUNTED = {_aten.lift_fresh.default}


class Count:
    """FLOPs (matmul and conv FLOPs, and kernel operations), bytes and op
    counts by name."""

    def __init__(self, flops=0.0, nbytes=0.0, ops_=None):
        self.flops, self.bytes = float(flops), float(nbytes)
        self.ops = collections.Counter(ops_ or {})

    def copy(self) -> "Count":
        return Count(self.flops, self.bytes, self.ops)

    def __sub__(self, other: "Count") -> "Count":
        c = Count(self.flops - other.flops, self.bytes - other.bytes,
                  self.ops)
        c.ops.subtract(other.ops)
        return c

    def add(self, other: "Count", times: int = 1) -> None:
        self.flops += times * other.flops
        self.bytes += times * other.bytes
        for k, v in other.ops.items():
            self.ops[k] += times * v


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A kernel's launch: its wrapper on the card, its meta twin, its
    plain version and its work (bytes, operations) from the launch's
    arguments."""

    name: str
    card: Callable
    meta: Callable
    plain: Callable
    work: Callable


def _flash_plain(q, k, v, *, causal=True, window=None, lse=False):
    fn = (flash_attn.flash_attention_lse_plain if lse
          else flash_attn.flash_attention_plain)
    return fn(q, k, v, causal=causal, window=window)


def _decode_work(q, k, v, lengths):
    """B3's work over the valid rows: on meta, where lengths has no
    values, every cache row (the dry run's cell is a full cache)."""
    rows = (q.shape[0] * k.shape[2] if lengths.is_meta
            else int(lengths.sum()))
    return decode_attn.work(q, k, rows)


FLASH = Kernel("flash_attn_fwd", flash_attn.flash_attention_fwd,
               flash_attn.flash_attention_fwd_meta, _flash_plain,
               lambda q, k, v, **kw: flash_attn.work(q, k, **kw))
DECODE = Kernel("decode_attn", decode_attn.decode_attention,
                decode_attn.decode_attention_meta,
                decode_attn.decode_attention_plain, _decode_work)
MAMBA = Kernel("mamba_scan", mamba_scan.mamba_chunk_scan,
               mamba_scan.mamba_chunk_scan_meta,
               mamba_scan.mamba_chunk_scan_plain, mamba_scan.work)
MLSTM = Kernel("mlstm_scan", mlstm_scan.mlstm_chunk_scan,
               mlstm_scan.mlstm_chunk_scan_meta,
               mlstm_scan.mlstm_chunk_scan_plain, mlstm_scan.work)
QUANT_ROWS = Kernel("split_quant", split_quant.quantize_rows,
                    split_quant.quantize_rows_meta,
                    split_quant.quantize_rows_plain,
                    lambda x: split_quant.work(x, fused=False))
QUANT_DQ = Kernel("split_quant", split_quant.quantize_dequantize,
                  split_quant.quantize_dequantize_meta,
                  split_quant.quantize_dequantize_plain,
                  lambda x: split_quant.work(x, fused=True))
KERNELS = ("flash_attn_fwd", "decode_attn", "split_quant", "mamba_scan",
           "mlstm_scan")


@dataclasses.dataclass(frozen=True)
class Recurrence:
    """A loop the census counts by the top-up: ``body`` (the loop, whose
    ``steps`` runs only its first trips), its outputs on meta without
    running it (``out``), how its flat outputs nest (``unflat``) and its
    trips."""

    name: str
    body: Callable
    out: Callable
    unflat: Callable
    trips: Callable            # (inputs, kw) -> trips


def _chunks(ins, kw):
    S = ins[0].shape[1]
    return -(-S // min(kw["chunk"], S)) if S else 0


SLSTM = Recurrence(
    "slstm", ops.slstm_loop,
    lambda xp, wh, c0, n0, h0, m0: (
        xp.new_empty(xp.shape[:2] + (wh.shape[0],)),
        tuple(t.new_empty(t.shape) for t in (c0, n0, h0, m0))),
    lambda f: (f[0], tuple(f[1:5])),
    lambda ins, kw: ins[0].shape[1])
MAMBA_PLAIN = Recurrence(
    "mamba_scan", mamba_scan.mamba_chunk_scan_plain,
    lambda x, dt, a_log, b, c, chunk: (
        torch.empty_like(x),
        x.new_empty(x.shape[:1] + x.shape[2:] + b.shape[-1:],
                    dtype=torch.float32)),
    lambda f: (f[0], f[1]), _chunks)
MLSTM_PLAIN = Recurrence(
    "mlstm_scan", mlstm_scan.mlstm_chunk_scan_plain,
    lambda q, k, v, i_pre, f_pre, chunk: (
        torch.empty_like(q),
        (q.new_empty(q.shape[:1] + q.shape[2:] + q.shape[-1:],
                     dtype=torch.float32),
         q.new_empty(q.shape[:1] + q.shape[2:], dtype=torch.float32),
         q.new_empty(q.shape[:1] + q.shape[2:3], dtype=torch.float32))),
    lambda f: (f[0], tuple(f[1:4])), _chunks)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of t's elements, a stride-0 (broadcast) dim counted once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride:
            n *= size
    return n


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class Census(TorchDispatchMode):
    """Counts what runs while it is entered (module docstring); read
    :meth:`result` after it exits. ``fused``: kernel spans count their
    kernel's work (the card's program), else the plain versions op by
    op; ``device``: the device whose work counts."""

    def __init__(self, fused: bool = True, device="meta"):
        super().__init__()
        self.fused = fused
        self.device = torch.device(device).type
        self.count = Count()
        self.kernels = {n: {"launches": 0, "flops": 0.0, "bytes": 0.0}
                        for n in KERNELS}
        self.plain_kernels: Dict[str, Dict[str, float]] = {}
        self.live = self.peak = self.base = 0
        self._storages: Dict[int, int] = {}
        self._finalizers = []
        self._quiet_depth = 0
        self._trips: Dict[Tuple, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        self._prev = None

    # ------------------------------------------------------------ entry
    def __enter__(self):
        self._prev, ops.census = ops.census, self
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ops.census = self._prev
            for f in self._finalizers:
                f.detach()
            self._finalizers.clear()
            if exc[0] is None:
                self._resolve_trips()

    def track(self, *trees) -> None:
        """Count the tensors of ``trees`` (parameters, optimizer state,
        inputs, caches) as live from the start."""
        for t in self._on_device(_tensors(trees)):
            self._storage(t, existing=True)

    def result(self) -> Dict[str, Any]:
        return {
            "flops": self.count.flops, "bytes": self.count.bytes,
            "n_ops": sum(self.count.ops.values()),
            "ops": dict(sorted((k, v) for k, v in self.count.ops.items()
                               if v)),
            "peak_bytes": self.peak, "base_bytes": self.base,
            "kernels": {n: dict(v) for n, v in self.kernels.items()},
            "plain_kernels": {n: dict(v)
                              for n, v in self.plain_kernels.items()},
            "collectives": {op: {"count": 0, "bytes": 0.0}
                            for op in COLLECTIVES},
        }

    # ------------------------------------------------------ live bytes
    def _storage(self, t, existing: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        if existing:             # alive all along: at the peak too
            self.base += n
            self.peak += n
        self.peak = max(self.peak, self.live)
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    @contextlib.contextmanager
    def _quiet(self):
        """Nothing inside counts (its allocations do)."""
        self._quiet_depth += 1
        try:
            yield
        finally:
            self._quiet_depth -= 1

    # ---------------------------------------------------------- aten ops
    def _on_device(self, ts):
        return [t for t in ts if t.device.type == self.device]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = self._on_device(_tensors((args, kwargs)))
        for t in ins:
            self._storage(t, existing=True)
        out = func(*args, **kwargs)
        outs = self._on_device(_tensors(out))
        for t in outs:
            self._storage(t, existing=False)
        if self._quiet_depth or not (ins or outs) or func in _NOT_COUNTED:
            return out
        c = self.count
        c.ops[str(func.overloadpacket)] += 1
        if func.overloadpacket in flop_registry:
            c.flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if not self._free_op(func, ins, outs):
            c.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out

    @staticmethod
    def _free_op(func, ins, outs) -> bool:
        """Views and aliases of an input, and allocations, move no bytes."""
        if func.is_view or func in _ALLOC_ONLY:
            return True
        if func._schema.is_mutable or not outs:
            return False
        held = {t.untyped_storage()._cdata for t in ins}
        return all(t.untyped_storage()._cdata in held for t in outs)

    # ----------------------------------------------------- kernel spans
    def _span(self, kern: Kernel):
        """One launch of ``kern``: its work counted once, its body not."""
        def run(*args, **kw):
            with self._quiet():
                nbytes, nops = kern.work(*args, **kw)
                dev = args[0].device.type
                impl = (kern.meta if dev == "meta"
                        else kern.plain if dev == "cpu" else kern.card)
                out = impl(*args, **kw)
            k = self.kernels[kern.name]
            k["launches"] += 1
            k["flops"] += nops
            k["bytes"] += nbytes
            self.count.flops += nops
            self.count.bytes += nbytes
            return out
        return run

    def _plain_span(self, name: str, fn, *args, **kw):
        """The plain version counted op by op, its share kept by name."""
        before = self.count.copy()
        out = fn(*args, **kw)
        self._plain_share(name, self.count - before)
        return out

    def _plain_share(self, name, c: Count, calls: int = 1) -> None:
        k = self.plain_kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += calls
        k["flops"] += c.flops
        k["bytes"] += c.bytes

    def flash_attention(self, q, k, v, *, causal, window):
        if self.fused:
            return ops.flash_card(q, k, v, causal=causal, window=window,
                                  kernel=self._span(FLASH))
        return self._plain_span(FLASH.name, flash_attn.flash_attention_plain,
                                q, k, v, causal=causal, window=window)

    def decode_attention(self, q, k, v, lengths):
        if self.fused:
            return self._span(DECODE)(q, k, v, lengths)
        return self._plain_span(DECODE.name, DECODE.plain, q, k, v, lengths)

    def mamba_scan(self, x, dt, a_log, b, c, *, chunk):
        if self.fused:
            return mamba_scan.mamba_scan_grad(x, dt, a_log, b, c, chunk=chunk,
                                              forward_fn=self._span(MAMBA))
        return self._topup(MAMBA_PLAIN, (x, dt, a_log, b, c), chunk=chunk)

    def mlstm_scan(self, q, k, v, i_pre, f_pre, *, chunk):
        if self.fused:
            return mlstm_scan.mlstm_scan_grad(q, k, v, i_pre, f_pre,
                                              chunk=chunk,
                                              forward_fn=self._span(MLSTM))
        return self._topup(MLSTM_PLAIN, (q, k, v, i_pre, f_pre), chunk=chunk)

    def slstm_scan(self, *inputs):
        return self._topup(SLSTM, inputs)

    def quantize_rows(self, x):
        if self.fused:
            return self._span(QUANT_ROWS)(x)
        return self._plain_span(QUANT_ROWS.name, QUANT_ROWS.plain, x)

    def quantize_dequantize(self, x):
        if self.fused:
            return self._span(QUANT_DQ)(x)
        return self._plain_span(QUANT_DQ.name, QUANT_DQ.plain, x)

    # ----------------------------------------------------------- top-up
    def _topup(self, rec: Recurrence, inputs, **kw):
        trips = rec.trips(inputs, kw)
        if trips < 1:
            return rec.body(*inputs, **kw)
        needs = tuple(t.requires_grad for t in inputs)
        train = torch.is_grad_enabled() and any(needs)
        key = (rec, tuple(sorted(kw.items())),
               tuple(tuple(t.shape) for t in inputs),
               tuple(t.dtype for t in inputs), needs if train else None)
        self._record((key, "fwd", None), trips)
        if train:
            return rec.unflat(_TopUp.apply(self, rec, key, trips, kw,
                                           *inputs))
        return rec.unflat(self._quiet_run(rec, inputs, kw))

    def _record(self, rkey, trips) -> None:
        """One call of ``trips`` trips, under (key, phase, the gradients'
        layout)."""
        self._trips[rkey][trips] += 1

    def _quiet_run(self, rec, inputs, kw):
        with self._quiet():
            if inputs[0].is_meta:
                return flat(rec.out(*inputs, **kw))
            return flat(rec.body(*inputs, **kw))

    def _resolve_trips(self) -> None:
        """Add each recorded recurrence, forward and backward apart: a call
        of up to three trips as counted; a longer one as its first two
        trips plus (trips - 2) x (three trips - two trips). Three, since a
        scan's first trips differ in their backward: the carried state
        needs a gradient from the second trip on, and its update's from
        the third."""
        measured = {}

        def first(key, k, layout, i):
            if (key, k, layout) not in measured:
                measured[key, k, layout] = self._per_trips(key, k, layout)
            return measured[key, k, layout][i]

        for (key, phase, layout), calls in sorted(
                self._trips.items(), key=lambda kv: repr(kv[0])):
            i = 0 if phase == "fwd" else 1
            add = Count()
            for trips, n in calls.items():
                if trips <= 3:
                    add.add(first(key, trips, layout, i), n)
                else:
                    two = first(key, 2, layout, i)
                    add.add(two, n)
                    add.add(first(key, 3, layout, i) - two, n * (trips - 2))
            self.count.add(add)
            if phase == "fwd" and key[0].name in KERNELS:
                self._plain_share(key[0].name, add, sum(calls.values()))
        self._trips.clear()

    def _per_trips(self, key, k: int, layout) -> Tuple[Count, Count]:
        """(forward, backward) Count of the body's first k trips, on fresh
        meta inputs of the key's shapes, dtypes and grad flags; the
        backward from the outputs that got a gradient (``layout``: per
        output None, or which dims of its gradient have stride 0)."""
        rec, kw, shapes, dtypes, needs = key
        needs = needs or (False,) * len(dtypes)
        ins = [torch.empty(s, dtype=d, device="meta").requires_grad_(n)
               for s, d, n in zip(shapes, dtypes, needs)]
        sub = Census(fused=self.fused, device="meta")
        with sub, torch.set_grad_enabled(any(needs)):
            out = flat(rec.body(*ins, **dict(kw), steps=k))
            fwd = sub.count.copy()
            if layout is not None:
                with sub._quiet():
                    pairs = [(o, torch.ones(
                        [1 if z else n for n, z in zip(o.shape, zeros)],
                        dtype=o.dtype, device="meta").expand(o.shape))
                        for o, zeros in zip(out, layout) if zeros is not None]
                torch.autograd.grad([o for o, _ in pairs],
                                    [t for t in ins if t.requires_grad],
                                    [g for _, g in pairs], allow_unused=True)
        return fwd, sub.count - fwd


class _TopUp(torch.autograd.Function):
    """A recurrence differentiated under a census: the forward runs it
    uncounted (its count is recorded), the backward records its count
    (from the outputs that get a gradient, in that gradient's layout) and
    takes the gradients uncounted, by recompute (empty on meta)."""

    @staticmethod
    def forward(ctx, census, rec, key, trips, kw, *inputs):
        ctx.census, ctx.rec, ctx.key, ctx.trips, ctx.kw = (census, rec, key,
                                                           trips, kw)
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return tuple(census._quiet_run(rec, inputs, kw))

    @staticmethod
    def backward(ctx, *gouts):
        census, inputs = ctx.census, ctx.saved_tensors
        needs = ctx.needs_input_grad[5:]
        layout = tuple(None if g is None else tuple(s == 0 for s in g.stride())
                       for g in gouts)
        census._record((ctx.key, "bwd", layout), ctx.trips)
        with census._quiet():
            if inputs[0].is_meta:
                grads = tuple(torch.empty_like(t) if n else None
                              for t, n in zip(inputs, needs))
            else:
                grads = recompute_grads(ctx.rec.body, inputs, needs, gouts,
                                        **ctx.kw)
        return (None,) * 5 + tuple(grads)
