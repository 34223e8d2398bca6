"""Ambient sharding hints (the port of the JAX package's
``parallel/hints.py``).

Model code reads thread-local hints: the MoE dispatch takes its block
count from ``hint("dp_size")`` and its all-to-all mesh from
``hint("a2a")``, the transformer its remat policy from ``hint("remat")``.
The launcher runs a step inside ``sharding_hints(ep='model',
dp=('data',), ...)``; without hints the same code runs unmeshed.

``constrain`` is where the reference pins an activation's layout with
``with_sharding_constraint``. The port runs every mesh from one
controller, where each tensor is whole: a layout constraint changes no
value, and placement happens only at the explicit collectives of
``parallel/moe_ep.py``, ``parallel/pipeline.py`` and
``parallel/compression.py``. So ``constrain`` returns ``x`` itself: it
calls ``spec_fn(hints)`` when hints are active (the spec functions stay
exercised) and does not call it when none are.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable

_TLS = threading.local()


def _current() -> dict | None:
    return getattr(_TLS, "hints", None)


@contextmanager
def sharding_hints(**kw):
    prev = _current()
    _TLS.hints = kw
    try:
        yield
    finally:
        _TLS.hints = prev


def hints_active() -> bool:
    return _current() is not None


def hint(name: str, default=None):
    h = _current()
    return h.get(name, default) if h else default


def constrain(x, spec_fn: Callable[[dict], object]):
    """``x`` itself; ``spec_fn(hints)`` is evaluated when hints are
    active, as the reference evaluates it before its constraint."""
    h = _current()
    if not h:
        return x
    spec_fn(h)
    return x


def with_hints(fn, **kw):
    """Wrap fn so the hints are active while it runs."""

    def wrapped(*args, **kwargs):
        with sharding_hints(**kw):
            return fn(*args, **kwargs)

    return wrapped
