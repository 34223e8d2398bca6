"""The SPD stream-computing DSL on PyTorch: parser, DFG, compiler,
transforms, legalizer, the Hopper stream-kernel codegen and its device
mesh, and the design-space exploration loop (models, measurement,
search; docs/port.md §dse)."""

from .codegen import (
    CodegenError,
    StencilSummary,
    StreamKernel,
    StripeProgram,
    lower_stripe,
    stencil_summary,
)
from .compiler import CompiledCore, HardwareReport, Registry, SPDCompileError
from .dfg import Core, Node, SPDError, SPDGraphError, schedule
from .dse import DesignPoint, FPGAModel, GPUModel, GPUTarget, StreamWorkload
from .distribute import (
    ShardedStreamKernel,
    device_axis_values,
    mesh_axis_values,
    ring_mesh,
)
from .explorer import Explorer, Sweep, pareto_mask
from .legalize import (
    SMEM_BYTES,
    VMEM_BYTES,
    blocking_plan,
    launch_tile,
    legal_block_values,
    resolve_run_plan,
    shard_height,
    tile_smem_bytes,
)
from .library import LibraryModule, default_registry_modules
from .measure import (
    BackendCalibration,
    MeasurementCache,
    calibrate_backend,
    calibrate_execution,
    core_fingerprint,
    time_run,
)
from .search import (
    ExecutedPoint,
    ExhaustiveSearch,
    LocalRefine,
    SearchResult,
    SearchRunner,
    SearchStrategy,
    SuccessiveHalving,
    get_strategy,
)
from .spd import SPDParseError, parse_spd, parse_spd_file
from .transforms import (
    spatial_duplicate,
    spatial_duplicate_spd,
    temporal_cascade,
    temporal_cascade_spd,
)

__all__ = [
    "BackendCalibration",
    "CodegenError",
    "CompiledCore",
    "Core",
    "DesignPoint",
    "ExecutedPoint",
    "ExhaustiveSearch",
    "Explorer",
    "FPGAModel",
    "GPUModel",
    "GPUTarget",
    "HardwareReport",
    "LibraryModule",
    "LocalRefine",
    "MeasurementCache",
    "Node",
    "Registry",
    "SMEM_BYTES",
    "SPDCompileError",
    "SPDError",
    "SPDGraphError",
    "SPDParseError",
    "SearchResult",
    "SearchRunner",
    "SearchStrategy",
    "ShardedStreamKernel",
    "StencilSummary",
    "StreamKernel",
    "StreamWorkload",
    "StripeProgram",
    "SuccessiveHalving",
    "Sweep",
    "VMEM_BYTES",
    "blocking_plan",
    "calibrate_backend",
    "calibrate_execution",
    "core_fingerprint",
    "default_registry_modules",
    "device_axis_values",
    "get_strategy",
    "launch_tile",
    "legal_block_values",
    "lower_stripe",
    "mesh_axis_values",
    "pareto_mask",
    "parse_spd",
    "parse_spd_file",
    "resolve_run_plan",
    "ring_mesh",
    "schedule",
    "shard_height",
    "spatial_duplicate",
    "spatial_duplicate_spd",
    "stencil_summary",
    "temporal_cascade",
    "temporal_cascade_spd",
    "tile_smem_bytes",
    "time_run",
]
