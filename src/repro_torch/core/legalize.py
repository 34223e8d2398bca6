"""Shared (block_h, m, d) legalization for temporal-blocking stream kernels.

A copy of the JAX package's ``core/legalize.py`` (every function there is
held to its original by ``tests/test_torch_legalize.py``), plus what the
Hopper launch needs on top: the shared-memory budget of one thread block
(:data:`SMEM_BYTES`), the pricing of the port kernels' actual tile
(:func:`tile_smem_bytes`) and the column-tile choice ``block_w``
(:func:`launch_tile`, docs/port.md §tile). ``block_w`` is a launch
detail, like the VMEM clamp: :data:`PLAN_FIELDS` and :class:`RunPlan` are
unchanged. The TPU names below (``VMEM_BYTES``, the DSE model) describe
the reference plan lattice, which the port keeps so plans stay comparable.

A design point chosen by the analytic models (`repro.core.dse`) is
grid-agnostic: the sweep lattice may propose a block height that does not
divide the concrete grid, a fused-step count the halo cannot source, a
stripe that overflows VMEM, or a device count that does not split the
grid into equal shards. All kernel back ends — the hand-written
``repro.kernels.lbm_stream``, the generic SPD codegen path
``repro.kernels.spd_stream``, and the multi-device
``repro.core.distribute`` wrapper — legalize through the functions here,
so model and measurement always agree on what "the closest legal plan"
means (docs/pipeline.md §legalize).

``VMEM_BYTES`` is the single definition of the on-chip vector-memory
budget: the DSE model's :class:`~repro.core.dse.TPUTarget` feasibility
check and the legalizer's stripe clamp both read it, so a point the model
calls feasible is one the legalizer will not shrink.

The device axis ``d`` (spatial parallelism across chips,
docs/pipeline.md §distribute) legalizes *per shard*: the grid's ``h``
rows must split into ``d`` equal shards (a hard error otherwise — there
is no "closest" shard count), and the (block_h, m) plan is then
legalized against the shard height ``h / d``, with the same VMEM stripe
accounting a single device uses (every shard keeps its own
``block_h + 2·m·halo``-row stripes resident).

``dx`` factors the device count into a 2-D mesh ``(dy, dx)`` with
``dy = d / dx`` (DESIGN.md §15): rows shard over ``dy`` as before and
columns shard over ``dx``, so the shard geometry is
``(h / dy, width / dx)``. Legalization then runs against the shard
height ``h / dy`` and prices stripes at the per-shard width plus the
``2·m·halo_x`` guard columns each fused launch keeps resident — wide
grids legalize larger ``block_h``/``m`` under ``dx > 1`` because the
per-stripe width term shrinks by ``dx``. A width the column axis does
not divide is a hard error (:func:`shard_width`), exactly mirroring the
row axis.

``double_buffer`` is a first-class plan dimension (docs/pipeline.md
§stream): with it on, the streaming kernels ping/pong two stripe
buffers so copy overlaps compute, and every stripe is accounted at
``VMEM_DOUBLE_BUFFER`` times its size; with it off, one buffer streams
sequentially and the whole budget holds a single stripe — the
*streaming fallback* :func:`blocking_plan` drops to when no
double-buffered stripe fits.

The batch axis ``b`` (docs/pipeline.md §serve, DESIGN.md §13) stacks
``b`` independent simulations into one launch along a leading array
dimension: every stripe then holds ``b`` members' rows at once, so all
stripe accounting scales linearly — ``b × stripe_vmem_bytes(..., b=1)``
— single-sourced here so the serving engine's batched plans and the
model's feasibility mask (``TPUModel.evaluate``) price the identical
geometry.

``fusion`` is the program-graph plan dimension (docs/pipeline.md
§program, DESIGN.md §14): a multi-stage stream program partitions its
stage chain into *fusion clusters* — ``"3"`` fuses three stages into
one stripe body, ``"1+2"`` cuts after the first stage, ``"1+1+1"``
pipelines every stage as its own launch. A fused cluster's composed
halo is the **sum** of its member stages' per-step stencil extents, and
its stripe residency is the **sum** of the member stages' stripes at
that composed halo (:func:`cluster_vmem_bytes`), so
:func:`program_blocking_plan` legalizes the whole partition against the
same ``VMEM_BYTES`` budget a single core uses. The empty string is the
legacy single-core plan.

Plan identity is single-sourced here as :data:`PLAN_FIELDS` /
:class:`RunPlan` (mirroring ``EXECUTED_POINT_FIELDS``): the search
runner, the study journal, and the measurement cache all derive their
keys from ``RunPlan.key()`` / ``RunPlan.from_dict``, so adding a plan
dimension (as ``fusion`` was) is a one-line change here rather than a
drift across call sites.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields

#: TPU v5e on-chip vector memory (VMEM) capacity in bytes. Single source of
#: truth for the DSE model (``TPUTarget.vmem_bytes``) and the legalizer.
VMEM_BYTES = 128 * 1024 * 1024

#: Ping/pong streaming keeps two stripes resident (one computing, one in
#: DMA flight), so a double-buffered stripe occupies twice its size.
#: Single source of truth: ``TPUModel`` and the legalizer both call
#: :func:`stripe_vmem_bytes` rather than re-implementing this multiplier.
VMEM_DOUBLE_BUFFER = 2

#: The one definition of plan identity, in dataclass-field order
#: (mirrors ``EXECUTED_POINT_FIELDS`` in ``repro.core.search``). The
#: study journal, measurement-cache keys, and strategy dedupe tables all
#: derive their tuples from :class:`RunPlan` over these fields, so a new
#: plan dimension is added *here* and nowhere else.
PLAN_FIELDS = (
    "block_h", "m", "steps", "d", "reps", "double_buffer", "b", "fusion",
    "dx",
)


@dataclass(frozen=True)
class RunPlan:
    """One concrete, legalized measurement plan — the unit of identity
    for the in-run dedupe table, the measurement cache, and the study
    journal (docs/pipeline.md §legalize, §study).

    ``fusion`` is the program-graph partition spec (docs/pipeline.md
    §program) — ``""`` for single-core plans, ``"2+1"``-style cluster
    sizes for stream programs — carried as plan identity so a fused and
    a pipelined execution of the same lattice point are distinct
    measurements.

    ``dx`` is the column axis of the 2-D device mesh (DESIGN.md §15):
    ``d`` stays the *total* device count (the compatible ``dy·dx``
    spelling, so journals and caches written by the 1-D ring replay
    unchanged) and ``dx`` factors it, ``dy = d / dx``. ``dx = 1`` is
    the legacy row-ring plan.
    """

    block_h: int
    m: int
    steps: int
    d: int
    reps: int
    double_buffer: bool = True
    b: int = 1
    fusion: str = ""
    dx: int = 1

    def key(self) -> tuple:
        """Hashable identity tuple, ordered exactly as PLAN_FIELDS."""
        return (self.block_h, self.m, self.steps, self.d, self.reps,
                bool(self.double_buffer), self.b, self.fusion, self.dx)

    def as_dict(self) -> dict:
        return {
            "block_h": self.block_h, "m": self.m, "steps": self.steps,
            "d": self.d, "reps": self.reps,
            "double_buffer": bool(self.double_buffer), "b": self.b,
            "fusion": self.fusion, "dx": self.dx,
        }

    @classmethod
    def from_dict(cls, rec: dict) -> "RunPlan":
        """Rebuild a plan from a journal/report record, tolerating
        records written before newer plan dimensions existed (absent
        ``double_buffer``/``b``/``fusion``/``dx`` take their
        defaults — a ``d``-only 1-D-ring record is the ``dx = 1``
        mesh, DESIGN.md §15)."""
        return cls(
            block_h=int(rec["block_h"]), m=int(rec["m"]),
            steps=int(rec["steps"]), d=int(rec["d"]),
            reps=int(rec.get("reps", 1)),
            double_buffer=bool(rec.get("double_buffer", True)),
            b=int(rec.get("b", 1)),
            fusion=str(rec.get("fusion", "") or ""),
            dx=int(rec.get("dx", 1)),
        )


assert tuple(f.name for f in fields(RunPlan)) == PLAN_FIELDS


def parse_fusion(spec: str, nstages: int) -> tuple[int, ...]:
    """Parse a fusion partition spec into a tuple of cluster sizes.

    ``"3"`` → ``(3,)`` (fully fused), ``"1+2"`` → ``(1, 2)``,
    ``"1+1+1"`` → fully pipelined; ``""`` means fully fused (the
    default for a program, and the only spelling for ``nstages == 1``).
    Sizes must be positive and sum to ``nstages`` — a spec for the
    wrong program shape is a hard error, not a closest-legal fallback.
    """
    if nstages < 1:
        raise ValueError(f"program needs >= 1 stage, got {nstages}")
    if not spec:
        return (nstages,)
    try:
        sizes = tuple(int(part) for part in str(spec).split("+"))
    except ValueError:
        raise ValueError(f"malformed fusion spec {spec!r}") from None
    if any(s < 1 for s in sizes):
        raise ValueError(f"fusion spec {spec!r} has a non-positive cluster")
    if sum(sizes) != nstages:
        raise ValueError(
            f"fusion spec {spec!r} partitions {sum(sizes)} stages, "
            f"program has {nstages}"
        )
    return sizes


def stripe_vmem_bytes(block_h, m, width: int, words: int,
                      halo: int = 1, double_buffer: bool = True,
                      b: int = 1, halo_x: int = 0):
    """VMEM bytes of one (block_h + 2·m·halo)-row f32 stripe of ``words``
    fields, matching the residency term of ``TPUModel.evaluate``.

    ``double_buffer=True`` prices the ping/pong pair
    (:data:`VMEM_DOUBLE_BUFFER` stripes resident); ``False`` prices the
    single-buffer streaming fallback. ``b`` is the batch axis
    (docs/pipeline.md §serve): ``b`` stacked simulations keep ``b``
    copies of every stripe resident, a plain linear multiplier — the one
    place the batched geometry is priced, so model and legalizer cannot
    drift. ``block_h``/``m`` may be numpy arrays (the model's batched
    lattice evaluation broadcasts through).

    ``halo_x`` prices the guard columns of a column-sharded stripe
    (DESIGN.md §15): under ``dx > 1`` every fused launch keeps
    ``2·m·halo_x`` neighbor columns resident alongside the per-shard
    ``width``, mirroring the ``2·m·halo`` guard rows. Callers pass 0
    when the column axis is unsharded, keeping legacy accounting
    byte-identical.
    """
    rows = block_h + 2 * m * halo
    mult = VMEM_DOUBLE_BUFFER if double_buffer else 1
    if getattr(b, "shape", None) in (None, ()):  # scalar: clamp to >= 1
        b = max(int(b), 1)
    # else: array batch-axis values broadcast straight through (the
    # model's batched lattice evaluation pre-clamps them)
    if getattr(width, "shape", None) in (None, ()):  # scalar: clamp
        width = max(int(width), 1)
    cols = width + 2 * m * halo_x
    return rows * cols * max(words, 1) * 4 * mult * b


def shard_width(w: int, dx: int) -> int:
    """Columns per shard when ``w`` grid columns split across ``dx``
    devices (the column axis of the 2-D mesh, DESIGN.md §15).

    Exactly mirrors :func:`shard_height`: a width the column axis does
    not divide is a hard error — there is no "closest" mesh shape to
    fall back to.
    """
    dx = int(dx)
    if dx < 1:
        raise ValueError(f"column device axis must be >= 1, got dx={dx}")
    if w % dx:
        raise ValueError(
            f"grid width w={w} does not split into dx={dx} equal shards "
            f"(column-sharded stream kernels need w % dx == 0)"
        )
    return w // dx


def shard_height(h: int, d: int) -> int:
    """Rows per shard when ``h`` grid rows split across ``d`` devices.

    The sharded stream kernels decompose the grid along y into ``d``
    equal contiguous shards (docs/pipeline.md §distribute); a height the
    device axis does not divide is a hard error — unlike (block_h, m)
    there is no "closest legal" shard count to fall back to.
    """
    d = int(d)
    if d < 1:
        raise ValueError(f"device axis must be >= 1, got d={d}")
    if h % d:
        raise ValueError(
            f"grid height h={h} does not split into d={d} equal shards "
            f"(sharded stream kernels need h % d == 0)"
        )
    return h // d


def mesh_shape(d: int, dx: int) -> tuple[int, int]:
    """Factor a total device count into the ``(dy, dx)`` mesh
    (DESIGN.md §15).

    ``d`` stays the total device count everywhere (plan identity,
    journals, caches); ``dx`` must divide it — a non-factorizing pair is
    a hard error, like an unshardable grid.
    """
    d, dx = int(d), int(dx)
    if d < 1:
        raise ValueError(f"device axis must be >= 1, got d={d}")
    if dx < 1:
        raise ValueError(f"column device axis must be >= 1, got dx={dx}")
    if d % dx:
        raise ValueError(
            f"mesh dx={dx} does not divide the device count d={d} "
            f"(a (dy, dx) mesh needs d == dy * dx)"
        )
    return d // dx, dx


def legal_block_values(h: int, m: int, *, halo: int = 1,
                       width: int = 0, words: int = 0,
                       vmem_bytes: int = VMEM_BYTES,
                       d: int = 1,
                       double_buffer: bool = True,
                       b: int = 1, dx: int = 1,
                       halo_x: int = 0) -> tuple[int, ...]:
    """Every legal ``block_h`` for ``m`` fused steps on an ``h``-row grid.

    The ascending chain of shard-height divisors that can source the
    ``m·halo`` stencil halo and (when the stripe geometry is supplied)
    fit the shared VMEM budget — i.e. exactly the values
    :func:`blocking_plan` chooses among for the same ``double_buffer``
    setting. Search strategies (``repro.core.search``, docs/pipeline.md
    §search) step block_h through this chain directly, which is what
    makes the block height a first-class searched dimension rather than
    a legalization byproduct; an empty tuple means no block is legal for
    this ``m`` (the neighborhood move is simply not available).

    ``dx`` factors ``d`` into the 2-D mesh (DESIGN.md §15): the divisor
    chain runs over the shard height ``h / dy`` and stripes are priced
    at the per-shard width ``width / dx`` plus the ``2·m·halo_x`` guard
    columns.
    """
    if h < 1:
        raise ValueError(f"grid height must be positive, got {h}")
    dy, dx = mesh_shape(d, dx)
    local_h = shard_height(h, dy)
    local_w = shard_width(width, dx) if width else width
    guard_x = max(0, int(halo_x)) if dx > 1 else 0
    halo = max(0, int(halo))
    m = max(1, min(int(m), local_h))
    floor = max(1, m * halo)
    legal = [
        v for v in range(1, local_h + 1)
        if local_h % v == 0 and v >= floor
    ]
    if width and words:
        legal = [
            v for v in legal
            if stripe_vmem_bytes(v, m, local_w, words, halo,
                                 double_buffer, b=b,
                                 halo_x=guard_x) <= vmem_bytes
        ]
    return tuple(legal)


def blocking_plan(h: int, block_h: int, m: int, *, halo: int = 1,
                  width: int = 0, words: int = 0,
                  vmem_bytes: int = VMEM_BYTES, d: int = 1,
                  double_buffer: bool = True,
                  b: int = 1, dx: int = 1,
                  halo_x: int = 0) -> tuple[int, int, bool]:
    """Legalize a model-chosen (block_h, m) for a grid of ``h`` rows.

    The temporal-blocking kernels require ``block_h | h`` and
    ``m * halo <= block_h`` (the y-halo is sourced from one neighbor
    stripe per side; ``halo`` is the per-step stencil reach inferred by
    ``repro.core.codegen``, 1 for the LBM kernel). The model's lattice is
    grid-agnostic, so its pick may violate either; this returns the
    closest legal plan ``(block_h, m, double_buffer)``: the largest
    divisor of ``h`` that is <= the requested block (or the smallest one
    >= m*halo when the request is too small), with ``m`` clamped into
    [1, h].

    With ``d > 1`` the plan is legalized *per shard*: ``h`` must split
    into ``d`` equal shards (:func:`shard_height` raises otherwise) and
    the divisor search runs over the shard height ``h / d`` — each shard
    of the distributed kernel (docs/pipeline.md §distribute) tiles its
    own rows independently, with the same per-stripe VMEM residency as a
    single device.

    When ``width``/``words`` are supplied the plan is additionally kept
    under the shared VMEM budget (:data:`VMEM_BYTES`): only legal
    divisors whose stripe fits are considered — the same residency
    arithmetic ``TPUModel`` uses for its feasibility mask. A
    double-buffered request whose smallest ping/pong stripe pair
    overflows the budget falls back to ``double_buffer=False`` (the
    single-buffer streaming path, docs/pipeline.md §stream), whose
    stripe budget is the whole VMEM; only when even that cannot fit is a
    ``ValueError`` raised (better than an opaque on-device VMEM
    allocation failure).

    ``b > 1`` legalizes a batched launch (docs/pipeline.md §serve):
    the same divisor chain, with every stripe priced at ``b`` members'
    residency — a batch that would overflow VMEM shrinks the block (or
    drops to single-buffer) exactly as a wider grid would.

    ``dx > 1`` legalizes against the 2-D mesh shard geometry
    ``(h / dy, width / dx)`` (DESIGN.md §15): the divisor chain runs
    over the ``dy``-shard height and every stripe is priced at the
    per-shard width plus its ``2·m·halo_x`` guard columns — the reason
    wide grids legalize larger blocks under column sharding.
    """
    if h < 1:
        raise ValueError(f"grid height must be positive, got {h}")
    dy, dx = mesh_shape(d, dx)
    local_h = shard_height(h, dy)
    width = shard_width(width, dx) if width else width
    halo_x = max(0, int(halo_x)) if dx > 1 else 0
    halo = max(0, int(halo))
    m = max(1, min(int(m), local_h))
    floor = max(1, m * halo)
    divisors = [v for v in range(1, local_h + 1) if local_h % v == 0]
    legal = [v for v in divisors if v >= floor]
    while not legal and m > 1:  # m*halo exceeds the shard: shrink m
        m -= 1
        floor = max(1, m * halo)
        legal = [v for v in divisors if v >= floor]
    if not legal:  # even one fused step cannot source its halo
        raise ValueError(
            f"stencil halo {halo} cannot be sourced on a shard of "
            f"h={local_h} rows (needs a block of >= {halo} rows dividing "
            f"it{f'; grid h={h} over d={d} shards' if d > 1 else ''})"
        )
    double_buffer = bool(double_buffer)
    b = max(1, int(b))
    if width and words:
        fits = [
            v for v in legal
            if stripe_vmem_bytes(v, m, width, words, halo,
                                 double_buffer, b=b,
                                 halo_x=halo_x) <= vmem_bytes
        ]
        if not fits and double_buffer:
            # Streaming fallback: a single-buffered stripe has the whole
            # budget to itself, so stripes up to VMEM_DOUBLE_BUFFER times
            # larger still stream (sequentially) through VMEM.
            double_buffer = False
            fits = [
                v for v in legal
                if stripe_vmem_bytes(v, m, width, words, halo,
                                     double_buffer, b=b,
                                     halo_x=halo_x) <= vmem_bytes
            ]
        if not fits:  # no legal block fits: fail loudly, not on-device
            smallest = min(legal)
            raise ValueError(
                f"no legal block for shard h={local_h} fits VMEM even via "
                f"the single-buffer streaming fallback "
                f"(double_buffer=False): smallest stripe "
                f"(block_h={smallest}, m={m}, halo={halo}, b={b}) needs "
                f"{stripe_vmem_bytes(smallest, m, width, words, halo, False, b=b, halo_x=halo_x)}"
                f" B > budget {vmem_bytes} B"
            )
        legal = fits
    under = [v for v in legal if v <= block_h]
    return (max(under) if under else min(legal)), m, double_buffer


def constraint_violation(h: int, block_h: int, m: int, *, halo: int = 1,
                         width: int = 0, words: int = 0,
                         vmem_bytes: int = VMEM_BYTES, d: int = 1,
                         double_buffer: bool = True,
                         b: int = 1, dx: int = 1,
                         halo_x: int = 0) -> float:
    """Continuous distance-to-feasibility of a (block_h, m, d) request.

    Exactly ``0.0`` iff :func:`blocking_plan` would produce a legal plan
    for the same arguments (including via the single-buffer streaming
    fallback); positive otherwise, and **monotone in the VMEM
    overshoot** — the deeper the smallest legal stripe overflows the
    budget, the larger the distance. Surrogate search strategies
    (docs/pipeline.md §study) use this as a penalty signal instead of
    hard-rejecting infeasible candidates: a continuous violation gives
    the sampler a gradient toward the feasible region, where a boolean
    would leave it blind (the ``constraint_violation``-as-gradient trick
    of Optuna-style DSE harnesses).

    The three failure modes, by increasing distance-from-legal:

    * **VMEM overflow** — every legal divisor's stripe exceeds the
      budget even single-buffered: violation is the fractional overshoot
      of the *smallest* legal single-buffered stripe,
      ``(bytes - vmem_bytes) / vmem_bytes``;
    * **unsourceable halo** — the per-step stencil reach exceeds the
      shard height: ``1 +`` the fractional excess (strictly above every
      VMEM violation of the same order);
    * **unshardable grid** — ``h % dy != 0`` (or, for a 2-D mesh,
      ``width % dx != 0`` / ``d % dx != 0``, DESIGN.md §15) has no
      closest legal plan at all: ``1 +`` the fractional remainder.
    """
    if h < 1:
        raise ValueError(f"grid height must be positive, got {h}")
    d, dx = int(d), int(dx)
    if d < 1:
        raise ValueError(f"device axis must be >= 1, got d={d}")
    if dx < 1:
        raise ValueError(f"column device axis must be >= 1, got dx={dx}")
    if d % dx:
        return 1.0 + (d % dx) / dx
    dy = d // dx
    if h % dy:
        return 1.0 + (h % dy) / dy
    if width and width % dx:
        return 1.0 + (width % dx) / dx
    local_h = h // dy
    width = width // dx if width else width
    halo_x = max(0, int(halo_x)) if dx > 1 else 0
    halo = max(0, int(halo))
    m = max(1, min(int(m), local_h))
    if halo > local_h:
        # even one fused step cannot source its halo on this shard
        return 1.0 + (halo - local_h) / local_h
    if not (width and words):
        return 0.0
    # Mirror blocking_plan's m-shrink loop, then price the smallest
    # legal stripe against the budget. blocking_plan falls back to
    # double_buffer=False before erroring, so a request is only
    # infeasible when even the single-buffered stripe overflows.
    divisors = [v for v in range(1, local_h + 1) if local_h % v == 0]
    floor = max(1, m * halo)
    legal = [v for v in divisors if v >= floor]
    while not legal and m > 1:
        m -= 1
        floor = max(1, m * halo)
        legal = [v for v in divisors if v >= floor]
    b = max(1, int(b))
    need = min(
        stripe_vmem_bytes(v, m, width, words, halo, double_buffer, b=b,
                          halo_x=halo_x)
        for v in legal
    )
    if need <= vmem_bytes:
        return 0.0
    if double_buffer:
        need = min(
            stripe_vmem_bytes(v, m, width, words, halo, False, b=b,
                              halo_x=halo_x)
            for v in legal
        )
        if need <= vmem_bytes:
            return 0.0
    return (need - vmem_bytes) / vmem_bytes


def cluster_vmem_bytes(block_h, m, width: int, stage_words,
                       stage_halos, double_buffer: bool = True,
                       b: int = 1):
    """VMEM bytes of one fusion cluster's stripe set (docs/pipeline.md
    §program, DESIGN.md §14).

    A fused cluster evaluates its member stages inside one stripe body,
    so every member stage's field set stays stripe-resident at once: the
    residency is the **sum** of the member stages' stripes, each priced
    at the cluster's *composed* halo — the sum of the members' per-step
    stencil extents, since stage k's reads reach through every upstream
    member's stencil. ``stage_words``/``stage_halos`` are the member
    stages' field counts and per-step halos, in chain order.
    """
    halo_c = sum(int(x) for x in stage_halos)
    return sum(
        stripe_vmem_bytes(block_h, m, width, int(w), halo_c,
                          double_buffer, b=b)
        for w in stage_words
    )


def program_blocking_plan(h: int, block_h: int, m: int, *,
                          stages, fusion: str = "", width: int = 0,
                          vmem_bytes: int = VMEM_BYTES, d: int = 1,
                          double_buffer: bool = True,
                          b: int = 1, dx: int = 1) -> tuple[int, int, bool]:
    """Legalize a (block_h, m) plan for a stream *program* under a
    fusion partition (docs/pipeline.md §program, DESIGN.md §14).

    ``stages`` is the program's stage chain as ``(words, halo)`` pairs;
    ``fusion`` partitions it into clusters (:func:`parse_fusion`). Every
    cluster must satisfy the single-core constraints at its *composed*
    halo — block divides the shard, the cluster's fused steps can source
    their halo, and the cluster's stripe set
    (:func:`cluster_vmem_bytes`) fits the shared budget; the returned
    plan is the closest one legal for **all** clusters at once.

    Temporal blocking only applies within a single launch, so a
    single-cluster (fully fused) partition blocks ``m`` steps per HBM
    round trip while a multi-cluster (pipelined) partition launches each
    cluster at one program step at a time — the per-cluster fused-step
    count is ``m`` iff the partition has one cluster, else 1. A
    partition with no legal block raises a ``ValueError`` naming the
    offending cluster (better than an opaque on-device VMEM failure).

    ``dx > 1`` legalizes against the 2-D mesh shard geometry
    (DESIGN.md §15): the divisor chain runs over the ``dy``-shard height
    and every cluster's stripe set is priced at the per-shard width
    ``width / dx``.
    """
    stages = [(int(w), int(hh)) for (w, hh) in stages]
    sizes = parse_fusion(fusion, len(stages))
    clusters, lo = [], 0
    for s in sizes:
        clusters.append(stages[lo:lo + s])
        lo += s
    dy, dx = mesh_shape(d, dx)
    local_h = shard_height(h, dy)
    width = shard_width(width, dx) if width else width
    fused = len(clusters) == 1
    m = max(1, min(int(m), local_h))
    b = max(1, int(b))
    spec = fusion or str(len(stages))
    divisors = [v for v in range(1, local_h + 1) if local_h % v == 0]
    geom = [
        (sum(w for w, _ in c), sum(hh for _, hh in c)) for c in clusters
    ]

    def _legal(m_c, db, vmem):
        """Blocks legal for every cluster; (legal, offending ci)."""
        legal = divisors
        for ci, (words_sum, halo_c) in enumerate(geom):
            ok = [v for v in legal if v >= max(1, m_c * halo_c)]
            if vmem and width and words_sum:
                ok = [
                    v for v in ok
                    if cluster_vmem_bytes(v, m_c, width,
                                          [w for w, _ in clusters[ci]],
                                          [hh for _, hh in clusters[ci]],
                                          db, b=b) <= vmem_bytes
                ]
            if not ok:
                return [], ci
            legal = ok
        return legal, None

    # Mirror blocking_plan: shrink the fused-step count only when a
    # cluster's composed halo cannot be sourced on the shard at all
    # (pipelined clusters launch one program step at a time, m_c = 1).
    m_c = m if fused else 1
    while True:
        legal, ci = _legal(m_c, double_buffer, vmem=False)
        if legal:
            break
        if m_c > 1:
            m_c -= 1
            continue
        halo_c = geom[ci][1]
        raise ValueError(
            f"fusion cluster {ci} of spec {spec!r}: composed stencil "
            f"halo {halo_c} cannot be sourced on a shard of h={local_h} "
            f"rows (needs a block of >= {halo_c} rows dividing it"
            f"{f'; grid h={h} over d={d} shards' if d > 1 else ''})"
        )
    db = bool(double_buffer)
    fits, ci = _legal(m_c, db, vmem=True)
    if not fits and db:
        # Streaming fallback: single-buffered stripes have the whole
        # budget to themselves (docs/pipeline.md §stream).
        db = False
        fits, ci = _legal(m_c, db, vmem=True)
    if not fits:
        words_sum, halo_c = geom[ci]
        smallest = min(legal)
        raise ValueError(
            f"fusion cluster {ci} of spec {spec!r} fits no legal block "
            f"on shard h={local_h} even via the single-buffer streaming "
            f"fallback (double_buffer=False): smallest stripe set "
            f"(block_h={smallest}, m={m_c}, composed halo={halo_c}, "
            f"words={words_sum}, b={b}) needs "
            f"{cluster_vmem_bytes(smallest, m_c, width, [w for w, _ in clusters[ci]], [hh for _, hh in clusters[ci]], False, b=b)}"
            f" B > budget {vmem_bytes} B"
        )
    if fused:
        m = m_c
    under = [v for v in fits if v <= block_h]
    return (max(under) if under else min(fits)), m, db


def resolve_run_plan(
    h: int, point, steps: int | None = None, *, halo: int = 1,
    width: int = 0, words: int = 0, d: int = 1,
    vmem_bytes: int = VMEM_BYTES, b: int | None = None,
    stages=None, fusion: str | None = None,
    dx: int | None = None, halo_x: int = 0,
) -> tuple[int, int, int, bool]:
    """Turn a DSE design point into a concrete
    (block_h, m, steps, double_buffer) plan.

    ``point`` is any object with ``m`` and ``detail['block_rows']`` (a
    :class:`repro.core.dse.DesignPoint` from a TPU sweep); a
    ``detail['double_buffer']`` entry requests the buffer protocol
    (default ping/pong). The blocking is legalized with
    :func:`blocking_plan` — per shard when ``d > 1``, with the
    double-buffered→single-buffered streaming fallback applied; ``steps``
    defaults to one fused launch (m steps) and is rounded down to a
    multiple of m.

    ``b`` is the batch axis (docs/pipeline.md §serve): ``None`` reads
    the point's ``detail['b']`` (1 when absent, matching pre-batch
    points), an explicit value overrides. The batch scales the VMEM
    accounting; it is not returned — it is a launch-shape property the
    caller already holds, not something legalization changes.

    ``stages``/``fusion`` switch to the program-graph legalization
    (docs/pipeline.md §program): ``stages`` is the program's
    ``(words, halo)`` chain and ``fusion`` the partition spec (``None``
    reads the point's ``detail['fusion']``), legalized through
    :func:`program_blocking_plan` instead of the single-core
    :func:`blocking_plan`. The return shape is unchanged — fusion, like
    ``b``, is identity the caller already holds.

    ``dx`` is the mesh column axis (DESIGN.md §15): ``None`` reads the
    point's ``detail['dx']`` (1 when absent, matching pre-mesh points),
    an explicit value overrides; ``halo_x`` is the per-step x stencil
    reach the guard columns must cover.
    """
    detail = getattr(point, "detail", None) or {}
    requested_db = bool(detail.get("double_buffer", True))
    if b is None:
        b = int(detail.get("b", 1))
    if fusion is None:
        fusion = str(detail.get("fusion", "") or "")
    if dx is None:
        dx = int(detail.get("dx", 1))
    if stages is not None:
        block_h, m, double_buffer = program_blocking_plan(
            h, int(point.detail["block_rows"]), int(point.m),
            stages=stages, fusion=fusion, width=width,
            vmem_bytes=vmem_bytes, d=d, double_buffer=requested_db, b=b,
            dx=dx,
        )
    else:
        block_h, m, double_buffer = blocking_plan(
            h, int(point.detail["block_rows"]), int(point.m),
            halo=halo, width=width, words=words, d=d,
            vmem_bytes=vmem_bytes, double_buffer=requested_db, b=b,
            dx=dx, halo_x=halo_x,
        )
    nsteps = m if steps is None else max(m, (steps // m) * m)
    return block_h, m, nsteps, double_buffer


#: Shared memory one Hopper thread block can use (227 KB of the SM's 256 KB;
#: above 48 KB only as opt-in dynamic shared memory).
SMEM_BYTES = 232_448

#: Widest column tile :func:`launch_tile` proposes before it shrinks to fit.
MAX_BLOCK_W = 128

#: Shared memory of one Hopper SM (228 KB) and what each resident block
#: reserves of it (1 KB): k blocks share an SM when k·(tile + 1 KB) fits,
#: so one block may take all of :data:`SMEM_BYTES`.
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024


def block_smem_budget(blocks_per_sm: int) -> int:
    """Shared-memory bytes a tile may take so ``blocks_per_sm`` blocks
    share one SM."""
    return SM_SMEM_BYTES // int(blocks_per_sm) - BLOCK_RESERVED_BYTES


def tile_smem_bytes(block_h: int, block_w: int, m: int, *, halo: int,
                    halo_x: int, planes: int, guard_rows: int = 0) -> int:
    """Shared-memory bytes of one port-kernel tile (docs/port.md §tile).

    A tile keeps ``planes`` f32 planes of ``(block_h + 2·m·halo) ×
    (block_w + 2·m·halo_x)`` cells resident, and ``guard_rows`` more rows
    of the same width: the generated stream kernel holds ``P + K`` planes
    for a core whose state lives in registers (a load slot and the ``K``
    materialized intermediates), else ``nbuf·P + K`` (``nbuf`` state
    buffers and ring slots: 1 in place or 2 ping/pong, plus 1 when a
    streamed launch prefetches the next tile), with ``2·(halo + 1)``
    guard rows that keep every stencil tap inside the allocation
    (``StripeProgram.launch_planes``, ``StripeProgram.guard_rows``); the
    hand-written LBM kernel ``9 + 10`` (post-collision populations and
    the load slot) and no guard rows. The wrappers pass exactly this many
    bytes as the launch's dynamic shared memory. Integer numpy arrays of
    ``block_h``/``m`` broadcast (the GPU model's batched ``smem`` rule,
    docs/port.md §dse).
    """
    rows = block_h + 2 * m * halo
    cols = block_w + 2 * m * halo_x
    return (rows * planes + guard_rows) * cols * 4


def launch_tile(width: int, block_h: int, m: int, *, halo: int,
                halo_x: int, planes, block_w: int | None = None,
                double_buffer: bool = True, blocks_per_sm: int = 1,
                guard_rows: int = 0,
                owner_cells: int = 0) -> tuple[int, bool]:
    """Pick the column tile ``block_w`` of a Hopper launch.

    ``planes(double_buffer)`` gives the resident plane count of the
    kernel's tile, ``guard_rows`` its rows beside the planes
    (:func:`tile_smem_bytes`). An explicit ``block_w`` is checked, never
    shrunk. With ``block_w=None`` the widest of ``min(width,
    MAX_BLOCK_W)``, then halvings down to 1, whose tile fits
    :data:`SMEM_BYTES` is taken; when
    no double-buffered tile fits, the single-buffer tile is tried (the
    same streaming fallback :func:`blocking_plan` takes for VMEM). A plan
    that fits nowhere raises ``ValueError`` here, not at launch.

    ``blocks_per_sm > 1`` (the generated stream kernel, whose registers
    allow it) first looks for a tile that leaves room for that many blocks
    on one SM (:func:`block_smem_budget`): the widest width whose
    double-buffered tile, else single-buffer tile, fits that budget, since
    a narrower tile recomputes more guard cells than the prefetch saves
    (docs/port.md §tile); only when none does, the one-block rule above.

    ``owner_cells > 0`` (a register-state core: the stripe cells a block's
    threads hold in registers) then narrows a proposed ``block_w`` to the
    widest halving whose stripe the owners hold, where one does, and drops
    the prefetch of a stripe they do not hold (:func:`stripe_owned`).
    Returns ``(block_w, double_buffer)``.
    """
    bw, db = _launch_tile(width, block_h, m, halo=halo, halo_x=halo_x,
                          planes=planes, block_w=block_w,
                          double_buffer=double_buffer,
                          blocks_per_sm=blocks_per_sm, guard_rows=guard_rows)
    if owner_cells:
        def owned(w):
            return stripe_owned(block_h, w, m, halo=halo, halo_x=halo_x,
                                owner_cells=owner_cells)

        if block_w is None:
            w = bw
            while w > 1 and not owned(w):
                w //= 2
            if owned(w):
                bw = w
        if not owned(bw):
            db = False
    return bw, db


def stripe_owned(block_h: int, block_w: int, m: int, *, halo: int,
                 halo_x: int, owner_cells: int) -> bool:
    """Whether a tile's ``(block_h + 2·m·halo) × (block_w + 2·m·halo_x)``
    stripe fits the ``owner_cells`` a register-state core's threads hold
    (the rule the kernel applies, ``spd_owned``; 0 cells hold none)."""
    return ((block_h + 2 * m * halo) * (block_w + 2 * m * halo_x)
            <= owner_cells)


def _launch_tile(width, block_h, m, *, halo, halo_x, planes, block_w,
                 double_buffer, blocks_per_sm, guard_rows):
    width = int(width)
    if width < 1:
        raise ValueError(f"grid width must be positive, got {width}")
    dbs = (True, False) if double_buffer else (False,)
    if block_w is None and int(blocks_per_sm) > 1:
        budget = block_smem_budget(blocks_per_sm)
        bw = min(width, MAX_BLOCK_W)
        while bw >= 1:
            for db in dbs:
                if tile_smem_bytes(block_h, bw, m, halo=halo, halo_x=halo_x,
                                   planes=planes(db),
                                   guard_rows=guard_rows) <= budget:
                    return bw, db
            bw //= 2
    for db in dbs:
        price = functools.partial(
            tile_smem_bytes, block_h, m=m, halo=halo, halo_x=halo_x,
            planes=planes(db), guard_rows=guard_rows,
        )
        if block_w is not None:
            if not 1 <= int(block_w):
                raise ValueError(f"block_w must be >= 1, got {block_w}")
            if price(int(block_w)) <= SMEM_BYTES:
                return int(block_w), db
            continue
        bw = min(width, MAX_BLOCK_W)
        while bw >= 1:
            if price(bw) <= SMEM_BYTES:
                return bw, db
            bw //= 2
    raise ValueError(
        f"no column tile fits {SMEM_BYTES} B of shared memory: "
        f"block_h={block_h}, m={m}, halo={halo}, halo_x={halo_x}, "
        f"block_w={block_w if block_w is not None else 1} needs "
        f"{tile_smem_bytes(block_h, block_w or 1, m, halo=halo, halo_x=halo_x, planes=planes(False), guard_rows=guard_rows)} B"
    )


def launch_cell_steps(rows, width, block_h, block_w, m, *, halo: int,
                      halo_x: int, b=1):
    """Stripe cell-steps one launch executes (docs/port.md §tile): ``b``
    members of ``rows / block_h`` by ``ceil(width / block_w)`` tiles, each
    stepping its whole ``(block_h + 2·m·halo) × (block_w + 2·m·halo_x)``
    stripe ``m`` times (the kernel's ``RC`` cells every step). Over the
    ``b·rows·width·m`` updates the launch keeps, the recompute of its
    halo rows and guard columns. Integer numpy arrays broadcast (the GPU
    model's launch-tile term)."""
    ntx = -(-width // block_w)
    return (b * (rows // block_h) * ntx * (block_h + 2 * m * halo)
            * (block_w + 2 * m * halo_x) * m)


__all__ = [
    "MAX_BLOCK_W",
    "PLAN_FIELDS",
    "SMEM_BYTES",
    "SM_SMEM_BYTES",
    "BLOCK_RESERVED_BYTES",
    "block_smem_budget",
    "RunPlan",
    "VMEM_BYTES",
    "VMEM_DOUBLE_BUFFER",
    "blocking_plan",
    "cluster_vmem_bytes",
    "constraint_violation",
    "legal_block_values",
    "mesh_shape",
    "parse_fusion",
    "program_blocking_plan",
    "resolve_run_plan",
    "shard_height",
    "shard_width",
    "stripe_vmem_bytes",
    "tile_smem_bytes",
    "launch_tile",
    "launch_cell_steps",
    "stripe_owned",
]
