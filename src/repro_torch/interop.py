"""What crosses between the JAX package and the port: data and structure.

The system has no weights. Its inputs are SPD text, Append_Reg values and
initial states; :func:`from_numpy` moves a state onto a device, and
:func:`core_structure` renders a parsed ``Core`` as plain Python so the
two packages' parsers can be compared without importing each other.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card raises.

    The port's entry points default to ``"cuda"`` and never fall back to
    the CPU quietly: pass ``device="cpu"`` to run the plain versions.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch versions"
        )
    return dev


def from_numpy(x, device) -> torch.Tensor:
    """A contiguous f32 tensor of ``x`` (numpy, sequence or tensor) on
    ``device``."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)


def core_structure(core) -> tuple:
    """A parsed ``Core`` as a nested tuple of plain Python values: name,
    ports, regs, params, nodes (kind, module, inputs, outputs, params,
    delay, expression repr) and DRCT lines. Works on either package's
    ``Core`` (their dataclasses share field names and reprs)."""
    return (
        core.name,
        tuple((i.name, tuple(i.ports)) for i in core.main_in),
        tuple((i.name, tuple(i.ports)) for i in core.main_out),
        tuple((i.name, tuple(i.ports)) for i in core.brch_in),
        tuple((i.name, tuple(i.ports)) for i in core.brch_out),
        tuple(core.regs),
        tuple(sorted(core.params.items())),
        tuple(
            (n.name, n.kind, n.module, tuple(n.inputs), tuple(n.outputs),
             tuple(n.params), n.delay, repr(n.expr))
            for n in core.nodes
        ),
        tuple((tuple(d), tuple(s)) for d, s in core.drcts),
    )
