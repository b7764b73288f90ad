"""Loop-free count of the work one eager step does: flops, bytes,
collectives and the peak of live temporaries.

The counterpart of ``repro/distributed/hlo_analysis.py``.  The reference
reads an XLA executable's optimized HLO text; the port has no HLO, so
``OpCounter`` (a ``TorchDispatchMode``) reads the aten operators one
eager call dispatches, on meta, CPU or CUDA tensors alike.  A loop in
Python dispatches its body once a trip, so no trip count is needed.

* flops: the reference's rule, ``2 * prod(result) * prod(contracted)``,
  over the product family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``mv``, ``dot``, ``convolution`` and the scaled-dot-product attention
  operators); elementwise work is not counted, as the reference counts
  none.
* bytes: operand plus result bytes of every operator that is not a view
  (a view moves nothing), and for an in-place scatter (``scatter_``,
  ``index_put_``, ``index_copy_``, ...) twice the bytes it writes plus
  its index, as the reference charges a dynamic-update-slice.  Eager
  PyTorch fuses nothing, so every intermediate is written and read
  again: the count is an upper bound of the reference's post-fusion
  one.
* peak live bytes: every new storage an operator returns counts from
  then until the last tensor on it is freed; tensors made before the
  counter opened (weights, inputs, a cache) are not temporaries and are
  not counted.
* collectives by kind: each call of a function marked with
  ``counted_collective`` (``distributed.tp.all_reduce``) and the bytes
  of its result (one copy of the reduced tensor).
* the port's kernels by formula: a call of a wrapper marked with
  ``counted_kernel`` (``flash_decode_attention``, ``flash_attention``,
  ``mamba1_scan``, ``ssd_scan``) adds its ``work`` (the kernel module's
  ``bound_flops`` and ``bound_bytes``), and the operators dispatched
  inside it are not counted.  So a step reads the same work whether the
  kernel ran on the card, its plain version on the CPU, or shape
  inference on meta.

``count(fn, *args)`` runs ``fn`` under a counter and returns the
counter; ``OpCounter.totals()`` gives ``analyse_hlo_text``'s keys.
"""
from __future__ import annotations

import functools
import math
import threading
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

aten = torch.ops.aten

# the counters open on this thread, innermost last (the hooks below
# report to it); thread-local as the dispatch mode's own stack is
_OPEN = threading.local()


def _open() -> List["OpCounter"]:
    if not hasattr(_OPEN, "stack"):
        _OPEN.stack = []
    return _OPEN.stack


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def _mm(args, out) -> int:
    a, b = args[0], args[1]
    return 2 * _prod(out.shape) * int(a.shape[-1])


def _addmm(args, out) -> int:               # (bias, a, b)
    return 2 * _prod(out.shape) * int(args[1].shape[-1])


def _conv(args, out) -> int:                # (input, weight, ...)
    return 2 * _prod(out.shape) * _prod(args[1].shape[1:])


def _sdpa(args, out) -> int:                # (q, k, v, ...)
    q, k, v = args[0], args[1], args[2]
    B, H, Sq = (int(d) for d in q.shape[:3])
    return 2 * B * H * Sq * int(k.shape[-2]) * (int(q.shape[-1])
                                                + int(v.shape[-1]))


def _flop_rules() -> Dict[Any, Callable]:
    rules = {aten.mm.default: _mm, aten.bmm.default: _mm,
             aten.mv.default: _mm, aten.dot.default: _mm,
             aten.addmm.default: _addmm, aten.baddbmm.default: _addmm,
             aten.convolution.default: _conv}
    for name in ("_scaled_dot_product_efficient_attention",
                 "_scaled_dot_product_flash_attention",
                 "_scaled_dot_product_cudnn_attention",
                 "_scaled_dot_product_flash_attention_for_cpu"):
        op = getattr(aten, name, None)
        if op is not None:
            rules[op.default] = _sdpa
    return rules


_FLOPS = _flop_rules()

# in-place writes of a region: charged 2 x the bytes written + the index
# (the reference's dynamic-update-slice rule)
_SCATTERS = {aten.scatter_.src, aten.scatter_.value,
             aten.scatter_add_.default, aten.index_put_.default,
             aten.index_copy_.default, aten.masked_scatter_.default}

# allocations that write nothing
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the operators dispatched while it is open (``with
    OpCounter() as c:``); see the module's docstring for the rules."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll_by_kind = {k: 0 for k in COLLECTIVE_OPS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.kernel_calls: Dict[str, int] = {}
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.live = 0
        self.peak_live = 0
        self._inside = 0                    # depth of counted calls
        self._storages: Dict[int, list] = {}   # storage -> [bytes, refs]
        self._tracked: Dict[int, Any] = {}     # id(tensor) -> weakref

    # -- the dispatch hook --------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        self.ops += 1
        outs = _tensors(out)
        rule = _FLOPS.get(func)
        if rule is not None and outs:
            self.flops += rule(args, outs[0])
        if func in _SCATTERS:
            src = _tensors(args[1:]) + _tensors(kwargs)
            self.bytes += sum(_nbytes(t) for t in src) \
                + sum(_nbytes(t) for t in src[-1:])
        elif not func.is_view and func not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in outs)
        self._track(outs, fresh=not func.is_view
                    and not func._schema.is_mutable)
        return out

    # -- live temporaries ---------------------------------------------------
    def _track(self, outs, fresh: bool) -> None:
        """Count each new storage among ``outs`` as live until its last
        tensor is freed (a view of a counted storage holds it too)."""
        for t in outs:
            if id(t) in self._tracked and self._tracked[id(t)]() is t:
                continue
            key = t.untyped_storage()._cdata
            entry = self._storages.get(key)
            if entry is None:
                if not fresh:
                    continue                # a view of an argument
                entry = [t.untyped_storage().nbytes(), 0]
                self._storages[key] = entry
                self.live += entry[0]
                self.peak_live = max(self.peak_live, self.live)
            entry[1] += 1
            tid = id(t)
            self._tracked[tid] = weakref.ref(
                t, functools.partial(self._release, key, tid))

    def _release(self, key: int, tid: int, _ref) -> None:
        self._tracked.pop(tid, None)
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    # -- counted calls (the hooks) ------------------------------------------
    def kernel_call(self, name: str, fn, work, args, kwargs):
        self._inside += 1
        try:
            flops, nbytes = work(*args, **kwargs)
            out = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.flops += flops
        self.bytes += nbytes
        self._track(_tensors(out), fresh=True)
        return out

    def collective_call(self, kind: str, fn, args, kwargs):
        self._inside += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        outs = _tensors(out)
        self.coll_by_kind[kind] += _nbytes(outs[0]) if outs else 0
        self.coll_counts[kind] += 1
        self._track(outs, fresh=True)
        return out

    # -- reading ------------------------------------------------------------
    def __enter__(self):
        _open().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _open().remove(self)
        return super().__exit__(*exc)

    @property
    def coll_bytes(self) -> int:
        return sum(self.coll_by_kind.values())

    def totals(self) -> Dict[str, Any]:
        """``analyse_hlo_text``'s keys (``flops``, ``bytes``,
        ``coll_bytes``, ``coll_by_kind``, ``coll_counts``) and the
        counter's own (operators, kernel calls and their part, the peak
        of live temporaries)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": self.coll_bytes,
                "coll_by_kind": dict(self.coll_by_kind),
                "coll_counts": dict(self.coll_counts), "ops": self.ops,
                "kernel_calls": dict(self.kernel_calls),
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "peak_live_bytes": self.peak_live}


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, OpCounter]:
    """``(fn(*args, **kwargs), the counter that read it)``."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c


# ---------------------------------------------------------------------------
# hooks: what the dispatched operators do not show
# ---------------------------------------------------------------------------

def counted_kernel(work: Callable[..., Tuple[int, int]]):
    """Mark a hand-written kernel's wrapper: under an open ``OpCounter`` a
    call adds ``work(*args, **kwargs)`` (its flops and bytes) and none of
    the operators it dispatches; with none open the call is the
    wrapper's own."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            stack = _open()
            if not stack:
                return fn(*args, **kwargs)
            return stack[-1].kernel_call(fn.__name__, fn, work, args, kwargs)
        return call
    return deco


def counted_collective(kind: str):
    """Mark a collective (``kind`` one of ``COLLECTIVE_OPS``): under an
    open ``OpCounter`` a call is counted with the bytes of its result's
    first tensor, and the copies it dispatches are not."""
    if kind not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {kind!r}")

    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            stack = _open()
            if not stack:
                return fn(*args, **kwargs)
            return stack[-1].collective_call(kind, fn, args, kwargs)
        return call
    return deco
