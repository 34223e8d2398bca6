"""The cost of one traced step: flops, collective bytes, an HBM-traffic
proxy and the peak of live temporaries (the port of the JAX package's
``launch/hlo_cost.py``).

The reference folds XLA's compiled HLO text into an :class:`HloCost`,
multiplying each while body by its trip count. An eager PyTorch step has
no HLO. Its counterpart is the stream of aten ops that the step
dispatches, which :class:`CostMode`, a ``TorchDispatchMode``, watches as
they run (on any device; the dry run runs them on ``meta``, where they
allocate nothing):

* ``flops``: the matmul-class ops (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, the convolutions, the SDPA ops), priced by the formulas of
  ``torch.utils.flop_counter``'s registry, a table of formulas and no
  kernel. These are what ``analyze_hlo`` counts as dots. A backward's
  products are counted as autograd dispatches them, and a remat's
  recompute with them.
* ``hbm_proxy_bytes``: the output bytes of every op that materialises a
  tensor. Views and metadata ops (``view``, ``t``, ``transpose``,
  ``expand``, ``slice``, ``select``, ``as_strided``, ``alias``,
  ``detach``: every op whose output aliases an input without writing it),
  ``_unsafe_view`` and the allocations that write nothing (``empty``...)
  are left out, as the reference leaves out ``parameter``,
  ``get-tuple-element``, ``tuple`` and ``bitcast``. Eager runs no fusion,
  so every intermediate is written: this proxy is an upper bound of
  XLA's, which counts fusion results only.
* collectives: what the code that moves bytes between ranks reports
  through :func:`record_collective` (``parallel/moe_ep.py``,
  ``parallel/pipeline.py``, ``parallel/compression.py``), the
  counterpart of the HLO's collective ops and their result bytes.
* ``peak_bytes``: the most bytes of storage that the traced ops held at
  once. An allocation is counted at the op whose output first holds a
  storage (not an input's), and a free when that storage dies. This is
  eager liveness, autograd's saved tensors included, not XLA's buffer
  assignment.

Trip counts. Eager unrolls every Python loop, so "scan == unroll" holds
by construction. A long loop of identical bodies can still be costed
once: inside ``mode.repeat(n)`` every op and collective counts ``n``
times (the reference's while-body multiplication), and :func:`loop` hands
a loop its iterations and that region. ``n_whiles`` is the number of
regions entered with ``n > 1``.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: The reference's collective kinds (HLO op names).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
#: Ops that allocate and write nothing, or alias without the view flag.
_NO_BYTES = {_aten._unsafe_view.default, _aten.empty.memory_format,
             _aten.empty_strided.default, _aten.empty_like.default,
             _aten.new_empty.default, _aten.new_empty_strided.default}


class Census:
    """Collectives by kind: ``kinds[kind] = {"count", "bytes",
    "elems"}``."""

    def __init__(self):
        self.kinds: dict = {}

    def add(self, kind: str, count, nbytes, nelems) -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}")
        k = self.kinds.setdefault(kind, {"count": 0, "bytes": 0,
                                         "elems": 0})
        k["count"] += count
        k["bytes"] += nbytes
        k["elems"] += nelems

    def total(self, key: str):
        return sum(k[key] for k in self.kinds.values())

    def as_dict(self) -> dict:
        return {**self.kinds, "total_bytes": self.total("bytes"),
                "total_count": self.total("count")}


@dataclass
class HloCost:
    flops: float
    coll_bytes: float
    coll_elems: float
    coll_counts: dict
    hbm_proxy_bytes: float
    n_whiles: int

    def coll_bytes_dtype(self, dtype_bytes: int) -> float:
        """Collective bytes at the model's native dtype width: the element
        count times ``dtype_bytes``, as the reference projects its
        f32-promoted CPU collectives (here the bytes are already the
        dtype's, so this equals ``coll_bytes`` for a one-dtype step)."""
        return self.coll_elems * dtype_bytes


class CostMode(TorchDispatchMode):
    """Counts the ops dispatched while it is active (module docstring).

    ``fold``: :func:`loop` runs one body of a loop inside a ``repeat``
    region (the dry run's; its values are then not the loop's, which
    does not matter on ``meta``). Subclasses may watch each op through
    :meth:`observe`."""

    def __init__(self, fold: bool = False):
        super().__init__()
        self.fold = fold
        self.flops = 0.0
        self.hbm_proxy_bytes = 0.0
        self.collectives = Census()
        self.n_whiles = 0
        self.mult = 1
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}  # storage key -> bytes
        self._writes: dict = {}  # op -> whether its output is written

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Every op and collective inside counts ``n`` times."""
        n = int(n)
        self.n_whiles += n > 1
        prev, self.mult = self.mult, self.mult * n
        try:
            yield
        finally:
            self.mult = prev

    def record_collective(self, kind: str, nbytes: int, nelems: int) -> None:
        self.collectives.add(kind, self.mult, self.mult * nbytes,
                             self.mult * nelems)

    def cost(self) -> HloCost:
        colls = self.collectives
        return HloCost(flops=self.flops, coll_bytes=colls.total("bytes"),
                       coll_elems=colls.total("elems"),
                       coll_counts={k: c["count"]
                                    for k, c in colls.kinds.items()},
                       hbm_proxy_bytes=self.hbm_proxy_bytes,
                       n_whiles=self.n_whiles)

    def observe(self, func, args, kwargs, out) -> None:
        """Called after every op; the base mode does nothing here."""

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += self.mult * formula(*args, **kwargs, out_val=out)
        writes = self._writes.get(func)
        if writes is None:
            writes = self._writes[func] = not (func.is_view
                                               or func in _NO_BYTES)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if writes:
            self.hbm_proxy_bytes += self.mult * sum(
                t.numel() * t.element_size() for t in outs)
        inputs = None
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            if inputs is None:
                inputs = {x.untyped_storage()._cdata
                          for x in tree_flatten((args, kwargs))[0]
                          if isinstance(x, torch.Tensor)}
            if key in inputs:
                continue
            nbytes = st.nbytes()
            self._live[key] = nbytes
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        self.observe(func, args, kwargs, out)
        return out


def _active() -> CostMode | None:
    """The innermost active :class:`CostMode` of this thread, if any."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostMode):
            return mode
    return None


def record_collective(kind: str, nbytes: int, nelems: int) -> None:
    """Report a collective of ``kind`` (one of :data:`COLLECTIVES`) that
    moves ``nbytes`` (``nelems`` elements) to the active
    :class:`CostMode`; nothing when none is active."""
    mode = _active()
    if mode is not None:
        mode.record_collective(kind, nbytes, nelems)


def loop(n: int):
    """``(iterations, region)`` for a loop of ``n`` bodies of equal cost:
    ``(1, mode.repeat(n))`` under a folding :class:`CostMode`, else ``(n,
    a null context)``. Run the body ``iterations`` times inside
    ``region``."""
    mode = _active()
    if mode is None or not mode.fold:
        return n, contextlib.nullcontext()
    return 1, mode.repeat(n)


def analyze(fn, *args, **kw) -> HloCost:
    """The :class:`HloCost` of ``fn(*args, **kw)``, run under a
    :class:`CostMode`."""
    with CostMode() as mode:
        fn(*args, **kw)
    return mode.cost()
