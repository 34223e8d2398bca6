"""Hand-written fused m-step D2Q9 LBM kernel (``csrc/lbm_stream.cu``).

Replaces the JAX package's ``kernels/lbm_stream/lbm_stream.py:
lbm_multistep`` (with ``_kernel`` and ``_step``): the paper's temporal
parallelism realized as temporal blocking — one HBM round trip advances
``m`` time steps. Persistent thread blocks walk the ``(block_h + 2m) ×
(block_w + 2m)`` stripes; each thread keeps the 9 populations and the
attribute of the stripe cells it owns in registers across m collide →
stream → bounce steps, shared memory holds the post-collision populations
and a load slot into which the next tile's stripe is copied (16-byte
``cp.async``) while this one steps, and only the center cells are written
(docs/port.md §tile). A tile with more stripe cells than the owners hold
(:data:`LBM_CELLS`) takes the kernel's second instantiation: the
populations stay in the load slot and are stepped there in place, with
no prefetch, in the same 19 planes. It is the independent anchor the
generated uLBM PE kernel is held to.

Bound on the card: at least ``(9 + 1 + 9)·H·W·4`` bytes of HBM traffic per
launch; with 131 flops per cell-step the m fused steps raise the
arithmetic per byte while the traffic stays constant.

On a CPU tensor :func:`lbm_multistep` runs :func:`lbm_multistep_plain`,
the port of ``_step`` over the same tiles; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.lbm import EX, EY, OPP, W as LATTICE_W
from repro_torch.core.codegen import _tile_shift, gather_tiles, scatter_centers
from repro_torch.core.compiler import f32
from repro_torch.core.legalize import launch_tile, tile_smem_bytes

#: Shared-memory planes of one tile: 9 post-collision populations and the
#: load slot's 10 (9 populations, the attributes).
LBM_PLANES = 19
#: Stripe cells the kernel's 512 threads own in registers, 4 each
#: (``lbm_max_cells`` of ``csrc/lbm_stream.cu``); a larger tile runs with
#: its populations in the load slot (:func:`lbm_owned`).
LBM_CELLS = 2048


def lbm_owned(block_h: int, block_w: int, m: int) -> bool:
    """Whether a tile's populations live in the owners' registers (the
    rule ``lbm_multistep`` of ``csrc/lbm_stream.cu`` applies)."""
    return (block_h + 2 * m) * (block_w + 2 * m) <= LBM_CELLS


def _step(f, attr, one_tau, u_lid):
    """One collide → stream → bounce step on ``(T, 9, R, C)`` tiles.

    The port of the reference's ``_step`` with every stencil read a
    zero-fill tile shift; cells within ``1`` of the tile edge go stale
    each step (the temporal-blocking trapezoid). ``rho`` is summed in
    index order, as the kernel sums it.
    """
    dev = f.device
    fi = [f[:, i] for i in range(9)]
    fluid = attr < 0.5
    rho = fi[0]
    for i in range(1, 9):
        rho = rho + fi[i]
    inv_rho = 1.0 / rho
    ux = (fi[1] + fi[5] + fi[8] - fi[3] - fi[6] - fi[7]) * inv_rho
    uy = (fi[2] + fi[5] + fi[6] - fi[4] - fi[7] - fi[8]) * inv_rho
    usq = ux * ux + uy * uy
    post = []
    for i in range(9):
        w = f32(LATTICE_W[i], dev)
        if i == 0:
            feq = w * rho * (1.0 - 1.5 * usq)
        else:
            cu = f32(EX[i], dev) * ux + f32(EY[i], dev) * uy
            feq = w * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
        gi = fi[i] - one_tau * (fi[i] - feq)
        post.append(torch.where(fluid, gi, fi[i]))
    streamed = [_tile_shift(post[i], int(EY[i]), int(EX[i]))
                for i in range(9)]
    solid = attr >= 0.5
    moving = attr >= 1.5
    out = []
    for i in range(9):
        refl = streamed[int(OPP[i])]
        corr = f32(6.0 * float(LATTICE_W[i]) * float(EX[i]), dev)
        bb = torch.where(moving, refl + corr * u_lid, refl)
        out.append(torch.where(solid, bb, streamed[i]))
    return torch.stack(out, dim=1)


def lbm_multistep_plain(f, attr, one_tau, u_lid=0.0, *, m: int,
                        block_h: int, block_w: int):
    """The kernel's plain version over the launch's tiles."""
    _, h, w = f.shape
    tiles = gather_tiles(torch.cat([f, attr[None]]), block_h, block_w, m, m)
    ft, at = tiles[:, :9], tiles[:, 9]
    one_tau, u_lid = f32(one_tau, f.device), f32(u_lid, f.device)
    for _ in range(m):
        ft = _step(ft, at, one_tau, u_lid)
    return scatter_centers(ft, h, w, block_h, block_w, m, m)


def lbm_multistep(f, attr, one_tau, u_lid=0.0, *, m: int = 4,
                  block_h: int = 32, block_w: int | None = None, out=None):
    """Fused m-step periodic LBM update.

    Args:
      f: (9, H, W) f32 distributions.
      attr: (H, W) f32 cell attributes (0 fluid / 1 wall / 2 moving lid).
      one_tau: 1/tau relaxation; u_lid: lid velocity for attr==2 cells.
      m: fused time steps per HBM round trip (temporal parallelism).
      block_h, block_w: the tile (``block_w=None``: the widest whose
        stripe fits shared memory).
    """
    if f.dim() != 3 or f.shape[0] != 9 or attr.shape != f.shape[1:]:
        raise ValueError(
            f"need f (9, H, W) and attr (H, W), got {tuple(f.shape)} and "
            f"{tuple(attr.shape)}"
        )
    if f.dtype != torch.float32 or attr.dtype != torch.float32:
        raise TypeError("f and attr must be float32")
    _, h, w = f.shape
    if h % block_h:
        raise ValueError(f"H={h} must be divisible by block_h={block_h}")
    if m > block_h:
        raise ValueError(f"m={m} must be <= block_h={block_h} (halo source)")
    block_w, _ = launch_tile(w, block_h, m, halo=1, halo_x=1,
                             planes=lambda db: LBM_PLANES, block_w=block_w,
                             double_buffer=False)
    if f.device.type == "cpu":
        return lbm_multistep_plain(f, attr, one_tau, u_lid, m=m,
                                   block_h=block_h, block_w=block_w)
    from repro_torch.kernels.build import check, load_lbm_library
    from repro_torch.kernels.spd_stream.spd_stream import cuda_args

    out = cuda_args(f, out)
    if attr.device != f.device or not attr.is_contiguous():
        raise ValueError("attr must be contiguous, on f's device")
    smem = tile_smem_bytes(block_h, block_w, m, halo=1, halo_x=1,
                           planes=LBM_PLANES)
    lib = load_lbm_library()
    with torch.cuda.device(f.device):
        check(lib.lbm_multistep(
            f.data_ptr(), attr.data_ptr(), out.data_ptr(), h, w, block_h,
            block_w, m, float(np.float32(one_tau)), float(np.float32(u_lid)),
            smem, f.device.index,
            torch.cuda.current_stream(f.device).cuda_stream,
        ), "lbm_multistep")
    lbm_multistep.launches += 1
    return out


lbm_multistep.launches = 0
