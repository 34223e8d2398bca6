"""The general generators of the traffic: open-loop serving requests, and
the token batches of a training mix (:func:`token_batch`).

A ``serve`` mix (``bench/traffic/<mix>.json``) gives ``rate_per_s``, its
``tenants``, a ``pool`` of initial states per tenant, and ``steps``: a
``log_uniform`` law over ``[min, max]`` rounded to a ``multiple``. Every
seed gets the same multiset of inter-arrival gaps (the quantiles of the
exponential law at that rate), of step counts (the quantiles of the step
law) and of tenants (round robin), each in an order drawn from the seed,
so the seed changes the order of the work and never its amount. The order
is stratified (:func:`stratified`): every ``block`` consecutive requests
take one value from each of ``block`` strata of each multiset, so every
stretch of the window offers the same mix of gaps and sizes, and the tail
latency reads the system, not where the seed happened to cluster the
longest requests.
"""

from __future__ import annotations

import math

import numpy as np


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def step_counts(law: dict, n: int) -> np.ndarray:
    if law["law"] != "log_uniform":
        raise ValueError(f"unknown step law {law['law']!r}")
    lo, hi, mult = int(law["min"]), int(law["max"]), int(law["multiple"])
    raw = np.exp(math.log(lo) + quantiles(n) * math.log(hi / lo))
    return np.clip(np.rint(raw / mult).astype(np.int64) * mult, lo, hi)


def stratified(values: np.ndarray, block: int, rng) -> np.ndarray:
    """``values`` (``n``, a multiple of ``block``) reordered so that each
    run of ``block`` consecutive entries holds one value of each of the
    ``block`` strata of the sorted values, in an order drawn from
    ``rng``."""
    v = np.sort(values).reshape(block, -1)  # row s: stratum s
    v = np.stack([rng.permutation(row) for row in v], axis=1)
    return np.concatenate([rng.permutation(b) for b in v])


def open_loop(mix: dict, seed: int, seconds: float) -> dict:
    """The arrival schedule of one run: ``due_s`` (offsets from the
    window's start, ascending), ``tenant``, ``steps`` and ``pool`` (the
    index of the initial state) per request, and ``in_window``, the
    requests due before ``seconds`` on this schedule."""
    rate = float(mix["rate_per_s"])
    block = int(mix["block"])
    n = block * (int(math.ceil(rate * seconds * 1.25 / block)) + 1)
    rng = np.random.default_rng(seed)
    gaps = stratified(-np.log1p(-quantiles(n)) / rate, block, rng)
    due = np.cumsum(gaps)
    steps = stratified(step_counts(mix["steps"], n), block, rng)
    tenant = stratified(np.arange(n) % len(mix["tenants"]), block, rng)
    pool = rng.integers(int(mix["pool"]), size=n)
    return {"due_s": due.tolist(), "tenant": tenant, "steps": steps,
            "pool": pool, "in_window": int(np.sum(due < seconds))}


def token_batch(mix: dict, vocab: int, seed: int, step: int) -> dict:
    """Batch ``step`` of a ``train`` mix: ``batch`` rows of ``seq``
    tokens uniform over ``[0, vocab)`` and the next token of each as its
    label, numpy int32, a pure function of (seed, step) by Philox's
    counter (the law of the port's ``train.data.SyntheticTokens``)."""
    if mix["tokens"] != "uniform":
        raise ValueError(f"unknown token law {mix['tokens']!r}")
    rng = np.random.Generator(np.random.Philox(key=int(seed),
                                               counter=[step, 0, 0, 0]))
    toks = rng.integers(0, int(vocab),
                        (int(mix["batch"]), int(mix["seq"]) + 1),
                        dtype=np.int64).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
