"""Structural (n, m) transforms over SPD cores (the port of the JAX
package's ``core/transforms.py``; only the lane helpers touch tensors).

``temporal_cascade``  — the paper's Fig. 2c / Fig. 11: chain m copies of a PE
so one pass over the stream advances m iterations. Emitted as SPD source (in
the style the paper writes by hand) and recompiled, so the transform
exercises the same front-end path a user would.

``spatial_duplicate`` — the paper's Fig. 2b / Fig. 8: n lanes processing an
n-wide stream. Generic duplication is only valid for lane-local (elementwise)
cores; cores with stream-offset modules need a lane-aware variant, exactly as
the paper wrote dedicated x1/x2/x4 translation stages (§III-B). The LBM app
provides those in ``repro_torch.apps.lbm``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .compiler import CompiledCore, Registry, SPDCompileError
from .dfg import Core
from .spd import parse_spd

# Library modules that are pure per-element functions (safe to lane-split).
_ELEMENTWISE_MODULES = {"SyncMux", "Comparator", "Eliminator"}


def temporal_cascade_spd(core: Core, m: int) -> str:
    """Emit SPD source for m cascaded instances of ``core`` (Fig. 11 style)."""
    mi = core.main_input_ports()
    mo = core.main_output_ports()
    if len(mi) != len(mo):
        raise SPDCompileError(
            f"temporal cascade needs |main_in| == |main_out| "
            f"({len(mi)} != {len(mo)}) so PEs can chain"
        )
    if core.brch_input_ports() or core.brch_output_ports():
        raise SPDCompileError("temporal cascade: branch ports not chainable")
    name = f"{core.name}_t{m}"
    lines = [f"Name {name};"]
    lines.append("Main_In {Mi::" + ",".join(f"i_{p}" for p in mi) + "};")
    lines.append("Main_Out {Mo::" + ",".join(f"o_{p}" for p in mo) + "};")
    if core.regs:
        lines.append("Append_Reg {Rg::" + ",".join(core.regs) + "};")
    cur = [f"i_{p}" for p in mi]
    for s in range(1, m + 1):
        outs = [f"s{s}_{p}" for p in mo]
        call_in = ",".join(cur + list(core.regs))
        lines.append(
            f"HDL PE_{s}, 0, ({','.join(outs)}) = {core.name}({call_in});"
        )
        cur = outs
    lines.append(
        "DRCT (" + ",".join(f"o_{p}" for p in mo) + ") = (" + ",".join(cur) + ");"
    )
    return "\n".join(lines)


def temporal_cascade(compiled: CompiledCore, m: int) -> CompiledCore:
    src = temporal_cascade_spd(compiled.core, m)
    core = parse_spd(src)
    return compiled.registry.compile(core)


def spatial_duplicate_spd(core: Core, n: int) -> str:
    """Emit SPD source for an n-lane duplication of an elementwise core."""
    for node in core.nodes:
        if node.kind == "hdl" and node.module not in _ELEMENTWISE_MODULES:
            raise SPDCompileError(
                f"spatial_duplicate: node {node.name} ({node.module}) holds "
                "stream state; write a lane-aware variant (see repro_torch.apps.lbm)"
            )
    mi = core.main_input_ports()
    mo = core.main_output_ports()
    bi = core.brch_input_ports()
    bo = core.brch_output_ports()
    name = f"{core.name}_s{n}"
    lines = [f"Name {name};"]
    lines.append(
        "Main_In {Mi::"
        + ",".join(f"{p}_l{j}" for j in range(n) for p in mi)
        + "};"
    )
    lines.append(
        "Main_Out {Mo::"
        + ",".join(f"{p}_l{j}" for j in range(n) for p in mo)
        + "};"
    )
    if bi:
        lines.append(
            "Brch_In {Bi::"
            + ",".join(f"{p}_l{j}" for j in range(n) for p in bi)
            + "};"
        )
    if bo:
        lines.append(
            "Brch_Out {Bo::"
            + ",".join(f"{p}_l{j}" for j in range(n) for p in bo)
            + "};"
        )
    if core.regs:
        lines.append("Append_Reg {Rg::" + ",".join(core.regs) + "};")
    for j in range(n):
        outs = [f"{p}_l{j}" for p in mo] + [f"{p}_l{j}" for p in bo]
        ins = [f"{p}_l{j}" for p in mi] + [f"{p}_l{j}" for p in bi] + list(core.regs)
        lines.append(
            f"HDL Lane_{j}, 0, ({','.join(outs)}) = {core.name}({','.join(ins)});"
        )
    return "\n".join(lines)


def spatial_duplicate(compiled: CompiledCore, n: int) -> CompiledCore:
    src = spatial_duplicate_spd(compiled.core, n)
    core = parse_spd(src)
    return compiled.registry.compile(core)


# --------------------------------------------------------------------------
# Stream helpers
# --------------------------------------------------------------------------


def interleave_lanes(x, n: int):
    """Split a flat stream (T, ...) into n column-interleaved lanes.

    Returns a list of n streams of length T//n: lane j holds elements
    ``j, j+n, j+2n, ...`` — the wiring of the paper's n-wide stream.
    """
    t = x.shape[0] - x.shape[0] % n
    return [x[:t][j::n] for j in range(n)]


def deinterleave_lanes(lanes: Sequence):
    """Inverse of :func:`interleave_lanes`."""
    stacked = torch.stack(list(lanes), dim=1)  # (T//n, n, ...)
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))


def compact_stream(x, en):
    """Host-side Eliminator compaction: keep elements where en != 0."""
    xn = torch.as_tensor(x).cpu().numpy()
    en_ = torch.as_tensor(en).cpu().numpy()
    return xn[en_ != 0]
