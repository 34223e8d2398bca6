"""The SPD stream-computing DSL on PyTorch: parser, DFG, compiler,
transforms, legalizer and the Hopper stream-kernel codegen."""

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
    "StencilSummary",
    "StreamKernel",
    "StripeProgram",
    "VMEM_BYTES",
    "blocking_plan",
    "default_registry_modules",
    "launch_tile",
    "legal_block_values",
    "lower_stripe",
    "parse_spd",
    "parse_spd_file",
    "resolve_run_plan",
    "schedule",
    "shard_height",
    "spatial_duplicate",
    "spatial_duplicate_spd",
    "stencil_summary",
    "temporal_cascade",
    "temporal_cascade_spd",
    "tile_smem_bytes",
]
