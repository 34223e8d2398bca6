"""Honest model↔measurement loop: timing, calibration, measurement cache.

The port of the JAX package's ``core/measure.py`` (docs/pipeline.md
§measure, docs/port.md §dse). The analytic (n, m) model means something
only when it is compared against *measured* performance of the platform
actually running; this module keeps that loop honest in three pieces:

1. **Timing harness** — :func:`time_run`: warm-up calls are separated
   from measured reps (a kernel's first ``nvcc`` build and first launch
   never land in the sample), *every* rep is synchronized inside its own
   host-clock bracket (a CUDA launch returns before the card is done;
   synchronizing only the last rep lets reps overlap and under-counts
   wall time), the reported wall time is the median of the reps, and
   the timer's own overhead — measured from back-to-back
   ``perf_counter`` pairs — is subtracted. The wall is the host clock
   around a synchronized rep, as in the reference: at the reference's
   256×128 grid a run is bound by its launches' host time, which only
   the host clock sees.

2. **Backend calibration** — micro-benchmarks measure the live
   platform's effective elementwise f32 throughput
   (:func:`measure_elementwise_gflops`, a generated FMA-chain SPD core
   run through the port's generated stream kernel) and memory bandwidth
   (:func:`measure_memory_bandwidth_gbs`), producing a
   :class:`BackendCalibration` whose :meth:`~BackendCalibration.target`
   is a :class:`~repro_torch.core.dse.GPUTarget` with *measured*
   constants. :func:`calibrate_execution` anchors the compute constant
   through the same ``run_factory`` the explorer times, over a small
   probe set spanning the lattice's fused-step range
   (:data:`PROBE_PLANS`), so predicted-vs-measured becomes a
   model-fidelity signal — the model must still predict how performance
   moves across the (block_h, m, d) lattice from those anchors.

3. **Measurement cache** — :class:`MeasurementCache`: a persistent
   on-disk store keyed by (core fingerprint, grid shape, run plan,
   backend, interpret, reps, warmup) and the port's :func:`code_salt`,
   so repeated sweeps skip re-timing. Its default path and environment
   variable are the port's own (:func:`default_cache_path`): a record of
   the JAX package's can never serve a card's lookup. ``interpret`` is
   true exactly when the plain torch versions ran (a CPU state), so a
   CPU record never serves a card run either.

``Explorer.search`` threads all three (docs/pipeline.md §execute).
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import statistics
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Mapping, Sequence

import torch

from .dse import GPUModel, GPUTarget, StreamWorkload
from .legalize import blocking_plan

__all__ = [
    "BackendCalibration",
    "MeasurementCache",
    "PROBE_PLANS",
    "Timing",
    "backend_descriptor",
    "block_until_ready",
    "calibrate_backend",
    "calibrate_execution",
    "code_salt",
    "core_fingerprint",
    "default_cache_path",
    "measure_elementwise_gflops",
    "measure_memory_bandwidth_gbs",
    "measured_run",
    "resolve_cache",
    "time_run",
    "timer_overhead",
]


# --------------------------------------------------------------------------
# Timing harness
# --------------------------------------------------------------------------


def timer_overhead(samples: int = 64) -> float:
    """Median cost of one timed-region bracket (two ``perf_counter`` calls).

    Subtracted from every measured rep so sub-millisecond kernels are not
    inflated by the clock itself.
    """
    deltas = []
    for _ in range(max(8, samples)):
        t0 = time.perf_counter()
        t1 = time.perf_counter()
        deltas.append(t1 - t0)
    return statistics.median(deltas)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def block_until_ready(x):
    """Wait until the card has finished ``x``: ``torch.cuda.synchronize``
    of every CUDA device a tensor of ``x`` (a tensor, or a list, tuple or
    dict of them) lies on; nothing for CPU tensors. Returns ``x``."""
    devices = {t.device for t in _tensors(x) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return x


@dataclass(frozen=True)
class Timing:
    """One timed measurement: median-of-reps wall time plus the raw sample."""

    wall_s: float  # median per-rep wall time, timer overhead subtracted
    times_s: tuple  # every measured rep (post-subtraction), in order
    reps: int
    warmup: int
    overhead_s: float  # per-bracket timer overhead that was subtracted

    @property
    def total_s(self) -> float:
        return float(sum(self.times_s))


def time_run(
    fn: Callable[[], object],
    *,
    reps: int = 3,
    warmup: int = 1,
    block: Callable | None = None,
) -> Timing:
    """Time ``fn`` honestly: warm up, block every rep, take the median.

    * ``warmup`` un-timed calls run (and are blocked) first, so a
      kernel's build and first launch never land in the measured sample;
    * each of the ``reps`` measured calls is individually synchronized
      with ``block`` (default :func:`block_until_ready`:
      ``torch.cuda.synchronize`` of the result's card, nothing on the
      CPU) *inside* its host-clock bracket;
    * the reported ``wall_s`` is the median rep, with the timer's own
      bracket overhead (:func:`timer_overhead`) subtracted and the
      result floored at 1 ns so downstream rates stay finite.
    """
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    if block is None:
        block = block_until_ready
    for _ in range(warmup):
        block(fn())
    overhead = timer_overhead()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block(fn())
        t1 = time.perf_counter()
        times.append(max(t1 - t0 - overhead, 1e-9))
    return Timing(
        wall_s=max(statistics.median(times), 1e-9),
        times_s=tuple(times),
        reps=reps,
        warmup=warmup,
        overhead_s=overhead,
    )


# --------------------------------------------------------------------------
# Core fingerprints (cache keys that survive process restarts)
# --------------------------------------------------------------------------


def _core_struct(core) -> dict:
    """A canonical, JSON-stable description of a DFG ``Core``."""
    return {
        "name": core.name,
        "main_in": [list(i.ports) for i in core.main_in],
        "main_out": [list(i.ports) for i in core.main_out],
        "brch_in": [list(i.ports) for i in core.brch_in],
        "brch_out": [list(i.ports) for i in core.brch_out],
        "regs": list(core.regs),
        "params": {k: float(v) for k, v in sorted(core.params.items())},
        "drcts": [[list(d), list(s)] for d, s in core.drcts],
        "nodes": [
            [
                n.name,
                n.kind,
                list(n.inputs),
                list(n.outputs),
                repr(n.expr),
                n.module,
                n.delay,
                list(n.params),
            ]
            for n in core.nodes
        ],
    }


def backend_descriptor(device="cuda") -> str:
    """Cache-key identity of the platform a ``device`` runs on.

    ``cuda/<card name>`` for a CUDA device (two card models sharing a
    cache file never serve each other's timings); ``cpu/<machine>`` for
    the CPU, where the plain torch versions run.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda/{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}/{platform.machine() or '?'}"


def core_fingerprint(obj) -> str:
    """Stable content hash of an SPD core (any pipeline stage of it).

    Accepts a ``StreamKernel``, ``CompiledCore``, DFG ``Core``, or a
    plain string tag (for hand-written back ends with no SPD source).
    Two structurally identical cores fingerprint identically across
    processes — and across the two packages, whose cores share field
    names and reprs; any change to the graph changes the key.
    """
    if isinstance(obj, str):
        return "tag:" + obj
    compiled = getattr(obj, "compiled", obj)  # StreamKernel -> CompiledCore
    core = getattr(compiled, "core", compiled)  # CompiledCore -> Core
    blob = json.dumps(_core_struct(core), sort_keys=True).encode()
    return "spd:" + hashlib.sha256(blob).hexdigest()[:16]


# --------------------------------------------------------------------------
# Persistent measurement cache
# --------------------------------------------------------------------------


def default_cache_path() -> str:
    """``$REPRO_TORCH_MEASURE_CACHE``, or ``build/repro_torch/
    measure-cache.json`` of the checkout (beside the built kernels)."""
    env = os.environ.get("REPRO_TORCH_MEASURE_CACHE")
    if env:
        return env
    from repro_torch.kernels.build import build_dir

    return str(build_dir() / "measure-cache.json")


#: Modules whose implementation determines a measurement's wall time even
#: when the SPD core's DFG (the fingerprint) is unchanged: the harness,
#: graph evaluation, the IR and its CUDA printer, the launch wrappers.
_SALT_MODULES = (
    "repro_torch.core.measure",
    "repro_torch.core.compiler",
    "repro_torch.core.dfg",
    "repro_torch.core.library",
    "repro_torch.core.codegen",
    "repro_torch.core.legalize",
    "repro_torch.core.distribute",
    "repro_torch.kernels.build",
    "repro_torch.kernels.spd_stream.spd_stream",
    "repro_torch.kernels.spd_stream.sharded",
    "repro_torch.kernels.spd_stream.streaming",
    "repro_torch.kernels.spd_stream.ops",
    "repro_torch.kernels.lbm_stream.lbm_stream",
    "repro_torch.kernels.lbm_stream.ops",
)

_CODE_SALT: list[str] = []  # computed once per process


def code_salt() -> str:
    """Hash of the torch version, the port's kernel-path modules, every
    file of ``csrc/`` and ``kernels/build.py``'s ``nvcc`` flags.

    Folded into every cache key: a kernel change or a torch upgrade
    changes measured wall times without changing any core's DFG, so it
    must invalidate the cache — a kernel change never serves a stale
    timing.
    """
    if not _CODE_SALT:
        import importlib.util

        from repro_torch.kernels import build

        h = hashlib.sha256()
        h.update(torch.__version__.encode())
        for mod in _SALT_MODULES:
            spec = importlib.util.find_spec(mod)
            h.update(Path(spec.origin).read_bytes())
        for path in sorted(build.CSRC.iterdir()):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        h.update(" ".join(build.NVCC_FLAGS + build.FLASH_NVCC_FLAGS).encode())
        _CODE_SALT.append(h.hexdigest()[:12])
    return _CODE_SALT[0]


class MeasurementCache:
    """On-disk store of timed measurements, keyed by what determines them.

    A key is the SHA-256 of (core fingerprint, grid shape, run plan
    ``(block_h, m, steps, d, double_buffer)``, backend, interpret, reps,
    warmup) plus the :func:`code_salt`, so neither a changed core *nor* a
    changed kernel can ever serve a stale timing (see :meth:`make_key`).
    Values are the :class:`Timing` facts, so the cache file doubles as a
    measurement log. Writes are atomic (temp file + ``os.replace``) and
    re-merge the on-disk state first, under a lock, so concurrent runs do
    not clobber each other's entries. ``hits``/``misses`` count this
    process's lookups.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = os.fspath(path) if path is not None else default_cache_path()
        self.hits = 0
        self.misses = 0
        self._data: dict[str, dict] = self._load()

    # ---- keys --------------------------------------------------------------

    @staticmethod
    def make_key(
        fingerprint: str,
        grid_shape: Sequence[int],
        plan: Sequence[int],
        backend: str,
        interpret: bool,
        reps: int,
        warmup: int,
    ) -> str:
        """Deterministic key over everything a measurement depends on."""
        fields = {
            "fingerprint": fingerprint,
            "grid_shape": [int(v) for v in grid_shape],
            # (block_h, m, steps, d[, db, b[, fusion]]) — the trailing
            # fusion spec is a string (docs/pipeline.md §program)
            "plan": [v if isinstance(v, str) else int(v) for v in plan],
            "backend": backend,
            "interpret": bool(interpret),
            "reps": int(reps),
            "warmup": int(warmup),
            "code": code_salt(),  # kernel sources + torch version
        }
        blob = json.dumps(fields, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:24]

    # ---- lookups -----------------------------------------------------------

    def get(self, key: str) -> dict | None:
        rec = self._data.get(key)
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def peek(self, key: str) -> dict | None:
        """Like :meth:`get` but without touching the hit/miss counters
        (surrogate strategies scan every candidate's key to warm-start;
        those scans are bookkeeping, not lookups)."""
        return self._data.get(key)

    def put(self, key: str, record: dict) -> None:
        self._data[key] = dict(record)
        self._flush()

    def stats(self) -> dict:
        return {
            "path": self.path,
            "entries": len(self._data),
            "hits": self.hits,
            "misses": self.misses,
        }

    def __len__(self) -> int:
        return len(self._data)

    # ---- persistence -------------------------------------------------------

    def _load(self) -> dict[str, dict]:
        try:
            with open(self.path, encoding="utf-8") as fh:
                data = json.load(fh)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def _flush(self) -> None:
        # A full re-load + rewrite per put(): a measurement costs far more
        # than rewriting this file, and flushing eagerly keeps everything
        # an interrupted sweep paid for while concurrent runs merge.
        directory = os.path.dirname(self.path) or "."
        os.makedirs(directory, exist_ok=True)
        # Serialize load→merge→replace against concurrent writers (study
        # resume leans on it). Platforms without flock fall back to the
        # unlocked merge.
        lock_fh = None
        try:
            import fcntl

            lock_fh = open(f"{self.path}.lock", "w")
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
        except (ImportError, OSError):
            lock_fh = None
        try:
            merged = self._load()  # re-merge concurrent writers, newest wins
            merged.update(self._data)
            self._data = merged
            tmp = f"{self.path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(merged, fh, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                # A read-only cache location must never fail the measurement.
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        finally:
            if lock_fh is not None:
                try:
                    import fcntl

                    fcntl.flock(lock_fh, fcntl.LOCK_UN)
                except (ImportError, OSError):
                    pass
                lock_fh.close()


def resolve_cache(policy) -> MeasurementCache | None:
    """Normalize a search's cache policy argument.

    ``None``/``False`` → no caching; ``True`` → the default on-disk
    cache (:func:`default_cache_path`); a path → a cache at that path;
    a :class:`MeasurementCache` → itself (lets callers read hit/miss
    stats afterwards).
    """
    if policy is None or policy is False:
        return None
    if policy is True:
        return MeasurementCache()
    if isinstance(policy, MeasurementCache):
        return policy
    return MeasurementCache(policy)


def measured_run(
    run: Callable[[], object],
    *,
    key: str | None = None,
    cache: MeasurementCache | None = None,
    reps: int = 3,
    warmup: int = 1,
) -> tuple[float, bool]:
    """Time ``run`` through the cache: ``(wall_s, came_from_cache)``.

    With a cache and a key, a prior measurement under the identical key
    is returned without re-running; otherwise the run is timed with
    :func:`time_run` and the result stored.
    """
    if cache is not None and key is not None:
        rec = cache.get(key)
        if rec is not None:
            return float(rec["wall_s"]), True
    timing = time_run(run, reps=reps, warmup=warmup)
    if cache is not None and key is not None:
        cache.put(
            key,
            {
                "wall_s": timing.wall_s,
                "times_s": list(timing.times_s),
                "reps": timing.reps,
                "warmup": timing.warmup,
                "overhead_s": timing.overhead_s,
            },
        )
    return timing.wall_s, False


# --------------------------------------------------------------------------
# Backend calibration
# --------------------------------------------------------------------------


#: Per-process memo of bandwidth probes, keyed by (backend, mbytes, reps,
#: warmup): a platform's bandwidth does not drift within one process.
_MEM_PROBE_MEMO: dict[tuple, float] = {}

#: Default probe buffers, MiB. On the card 1 GiB, far beyond the H100's
#: 50 MB L2: a buffer that fits L2 would report L2 bandwidth and make every
#: calibrated prediction optimistic (docs/port.md §dse). On the CPU, where
#: the plain versions run, the reference's 32 MiB.
PROBE_MBYTES = {"cuda": 1024, "cpu": 32}


def measure_memory_bandwidth_gbs(
    mbytes: int | None = None, *, device="cuda", reps: int = 3,
    warmup: int = 1, memo: bool = True,
) -> float:
    """Effective f32 streaming bandwidth (GB/s) of ``device``.

    Times a torch ``a + 1.0`` pass over an ``mbytes`` f32 buffer — one
    read + one write per element, the same traffic shape as a stream
    kernel's HBM round trip — and reports moved bytes / median wall.
    ``mbytes=None`` takes :data:`PROBE_MBYTES` of the device's type.
    A probe, not a kernel of the port. Memoized per process (``memo=False``
    forces a fresh probe) and never persisted, so every session measures
    the platform it has.
    """
    dev = torch.device(device)
    if mbytes is None:
        mbytes = PROBE_MBYTES.get(dev.type, 32)
    key = (backend_descriptor(dev), mbytes, reps, warmup)
    if memo and key in _MEM_PROBE_MEMO:
        return _MEM_PROBE_MEMO[key]
    n = max(1, (mbytes * 2**20) // 4)
    x = torch.full((n,), 1.5, dtype=torch.float32, device=dev)
    timing = time_run(lambda: x + 1.0, reps=reps, warmup=warmup)
    bw = 2 * n * 4 / timing.wall_s / 1e9
    if memo:
        _MEM_PROBE_MEMO[key] = bw
    return bw


def _fma_chain_spd(chain: int) -> str:
    """SPD source of a ``chain``-deep FMA pipeline (2·chain flops/elem)."""
    lines = [
        "Name CalibChain;",
        "Main_In {mi::u};",
        "Main_Out {mo::v};",
        "Append_Reg {rg::a};",
    ]
    prev = "u"
    for i in range(chain):
        out = "v" if i == chain - 1 else f"t{i}"
        lines.append(f"EQU N{i}, {out} = {prev}*a + 0.125;")
        prev = out
    return "\n".join(lines)


def fma_chain_kernel(chain: int = 32, device="cuda"):
    """The ``chain``-deep FMA core (:func:`_fma_chain_spd`) lowered to the
    port's generated stream kernel: halo 0, one state plane, one
    register."""
    from .compiler import Registry
    from .spd import parse_spd

    return Registry().compile(parse_spd(_fma_chain_spd(chain))).stream_kernel(
        device=device)


def measure_elementwise_gflops(
    device="cuda",
    *,
    chain: int = 32,
    shape: tuple[int, int] = (128, 128),
    m: int = 1,
    block_h: int = 32,
    reps: int = 3,
    warmup: int = 1,
) -> float:
    """Effective elementwise f32 throughput (GFLOP/s) of ``device``.

    Compiles a generated ``chain``-deep FMA SPD core through the port's
    codegen and times its streamed launch (``run_blocked``) — so the
    number reflects the execution path the explorer measures (the
    generated kernel on the card, its plain version on the CPU), not a
    synthetic loop. The kernel's first build lands in the warm-up.
    """
    h, w = shape
    kern = fma_chain_kernel(chain, device)
    state = torch.full((1, h, w), 0.5, dtype=torch.float32,
                       device=kern.device)
    bh, mm, _ = blocking_plan(h, block_h, m, halo=kern.halo, width=w, words=1)
    timing = time_run(
        lambda: kern.run_blocked(state, (0.997,), steps=mm, m=mm, block_h=bh),
        reps=reps,
        warmup=warmup,
    )
    flops = h * w * mm * 2 * chain  # halo = 0: no recompute term
    return flops / timing.wall_s / 1e9


@dataclass(frozen=True)
class BackendCalibration:
    """Measured constants of the platform actually running.

    ``elem_gflops`` / ``mem_gbs`` are the single-device effective
    elementwise f32 throughput and memory bandwidth; ``by_d`` optionally
    carries measured *aggregate* throughput per device-axis value (d
    shards on one host's CPU share it, so aggregate throughput is
    measured, not assumed d-linear). :meth:`target` folds the
    measurements into a :class:`~repro_torch.core.dse.GPUTarget`, which
    :meth:`repro_torch.core.dse.GPUModel.calibrated` wraps into a model —
    the calibrated side of the predicted-vs-measured diff
    (docs/pipeline.md §measure). ``interpret`` is true when the plain
    torch versions ran (the CPU).
    """

    backend: str
    interpret: bool
    elem_gflops: float
    mem_gbs: float
    by_d: tuple = ()  # ((d, aggregate_gflops), ...)
    detail: Mapping = field(default_factory=dict)

    def gflops(self, d: int = 1) -> float:
        """Measured aggregate throughput across ``d`` devices; the
        single-device figure when ``d`` was not probed (unprobed scaling
        is not assumed)."""
        return float(dict(self.by_d).get(int(d), self.elem_gflops))

    def target(self, d: int = 1, base: GPUTarget | None = None) -> GPUTarget:
        """A :class:`GPUTarget` carrying this calibration's constants.

        Per-device compute is aggregate/d so the model's ``× d`` scaling
        reproduces the *measured* aggregate for that device count.
        Bandwidth divides by ``d`` only when the devices share one host
        memory system (the CPU, where the plain versions run); every card
        has its own HBM, so the per-card constant stands there.
        """
        base = base or GPUTarget()
        d = max(1, int(d))
        mode = ":plain" if self.interpret else ""
        shared_memory = self.interpret or self.backend.startswith("cpu")
        return replace(
            base,
            name=f"{base.name}+measured[{self.backend}{mode}]",
            vpu_f32_tflops=self.gflops(d) / d / 1e3,
            hbm_gbs=self.mem_gbs / d if shared_memory else self.mem_gbs,
        )

    def model(self, d: int = 1, base: GPUTarget | None = None) -> GPUModel:
        """Shorthand for ``GPUModel.calibrated(self, d=d, base=base)``."""
        return GPUModel.calibrated(self, d=d, base=base)


def calibrate_backend(
    device="cuda",
    *,
    chain: int = 32,
    shape: tuple[int, int] = (128, 128),
    m: int = 1,
    mem_mbytes: int | None = None,
    reps: int = 3,
    warmup: int = 1,
) -> BackendCalibration:
    """Generic platform calibration from the two micro-benchmarks.

    The compute constant comes from the FMA-chain probe kernel
    (:func:`measure_elementwise_gflops`), the bandwidth constant from
    :func:`measure_memory_bandwidth_gbs` — no application core needed.
    For per-kernel anchoring inside the explorer's measurement loop use
    :func:`calibrate_execution`.
    """
    dev = torch.device(device)
    gflops = measure_elementwise_gflops(
        dev, chain=chain, shape=shape, m=m, reps=reps, warmup=warmup
    )
    mem = measure_memory_bandwidth_gbs(mem_mbytes, device=dev, reps=reps,
                                       warmup=warmup)
    return BackendCalibration(
        backend=backend_descriptor(dev),
        interpret=dev.type == "cpu",
        elem_gflops=gflops,
        mem_gbs=mem,
        by_d=((1, gflops),),
        detail={"chain": chain, "shape": list(shape), "m": m,
                "mem_mbytes": mem_mbytes or PROBE_MBYTES.get(dev.type, 32)},
    )


#: Default calibration probe set, as (block_h, m) pairs. Two anchors
#: spanning the lattice's fused-step range: a run has a per-launch cost
#: the roofline does not model, so a single anchor at one m
#: systematically mis-prices points at another. Each probe legalizes like
#: any frontier point; the anchors' geometric mean becomes the platform's
#: effective throughput.
PROBE_PLANS: tuple = ((16, 4), (64, 8))


def calibrate_execution(
    run_factory: Callable,
    *,
    workload: StreamWorkload,
    grid_shape: tuple[int, int],
    halo: int | None = None,
    width: int = 0,
    words: int = 0,
    d_values: Sequence[int] = (1,),
    probe_plans: Sequence[tuple[int, int]] = PROBE_PLANS,
    device="cuda",
    reps: int = 3,
    warmup: int = 1,
    cache: MeasurementCache | None = None,
    fingerprint: str | None = None,
    mem_gbs: float | None = None,
) -> BackendCalibration:
    """Anchor the compute constant through the *actual* execution path.

    Runs a small probe set — ``probe_plans`` as (block_h, m) requests,
    each legalized exactly like a frontier point (duplicates after
    legalization collapse) — through the same ``run_factory`` the
    explorer times, per requested device-axis value, and backs the
    platform's effective elementwise throughput out of the wall times
    (counting halo-recomputed sites: that is work the device really
    performed; the anchor is the geometric mean over the probe set). A
    probe plan the factory declines (``None``: no tile fits, docs/port.md
    §dse) is skipped. ``device`` is where the runs execute; the records
    carry ``interpret`` true when it is the CPU.

    Probe measurements go through the same :class:`MeasurementCache`
    key space as frontier runs, so repeated sweeps skip re-calibration
    and a probe plan that legalizes onto a frontier point's plan reuses
    its timing outright.
    """
    h, w = grid_shape
    halo = workload.halo if halo is None else halo
    dev = torch.device(device)
    interpret = dev.type == "cpu"
    backend = backend_descriptor(dev)
    by_d = []
    for d in d_values:
        d = int(d)
        plans = []
        for req_bh, req_m in probe_plans:
            try:
                bh, m, db = blocking_plan(
                    h, req_bh, req_m, halo=halo, width=width, words=words,
                    d=d,
                )
            except ValueError:
                continue  # this anchor has no legal plan here; the
                #           others still calibrate
            if (bh, m, db) not in plans:
                plans.append((bh, m, db))
        rates = []
        for bh, m, db in plans:
            nsteps = m
            run = run_factory(nsteps, m, bh, d, db)
            if run is None:
                continue
            # Same key space as frontier runs, so a probe plan that
            # coincides with a frontier point shares its timing.
            key = None
            if cache is not None and fingerprint is not None:
                key = MeasurementCache.make_key(
                    fingerprint, (h, w), (bh, m, nsteps, d, int(db)),
                    backend, interpret, reps, warmup,
                )
            wall, _ = measured_run(
                run, key=key, cache=cache, reps=reps, warmup=warmup
            )
            useful = bh / (bh + 2 * m * halo) if halo else 1.0
            computed_flops = h * w * nsteps * workload.flops_per_elem / useful
            rates.append(computed_flops / wall / 1e9)
        if rates:
            by_d.append((d, float(statistics.geometric_mean(rates))))
    if not by_d:
        raise ValueError(
            "calibrate_execution: run_factory produced no runnable probe "
            f"for any d in {tuple(d_values)}"
        )
    if mem_gbs is None:
        mem_gbs = measure_memory_bandwidth_gbs(device=dev, reps=reps,
                                               warmup=warmup)
    anchor = dict(by_d)
    return BackendCalibration(
        backend=backend,
        interpret=interpret,
        elem_gflops=anchor.get(1, by_d[0][1]),
        mem_gbs=float(mem_gbs),
        by_d=tuple(by_d),
        detail={
            "probe_plans": [list(p) for p in probe_plans],
            "grid_shape": [h, w],
            "flops_per_elem": workload.flops_per_elem,
        },
    )
