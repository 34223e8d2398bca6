"""The SPD stream-computing DSL on PyTorch: parser, DFG, compiler,
transforms, legalizer, the Hopper stream-kernel codegen and its device
mesh."""

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
from .distribute import (
    ShardedStreamKernel,
    device_axis_values,
    mesh_axis_values,
    ring_mesh,
)
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
from .spd import SPDParseError, parse_spd, parse_spd_file
from .transforms import (
    spatial_duplicate,
    spatial_duplicate_spd,
    temporal_cascade,
    temporal_cascade_spd,
)

__all__ = [
    "CodegenError",
    "CompiledCore",
    "Core",
    "HardwareReport",
    "LibraryModule",
    "Node",
    "Registry",
    "SMEM_BYTES",
    "SPDCompileError",
    "SPDError",
    "SPDGraphError",
    "SPDParseError",
    "ShardedStreamKernel",
    "StencilSummary",
    "StreamKernel",
    "StripeProgram",
    "VMEM_BYTES",
    "blocking_plan",
    "default_registry_modules",
    "device_axis_values",
    "launch_tile",
    "legal_block_values",
    "lower_stripe",
    "mesh_axis_values",
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
]
