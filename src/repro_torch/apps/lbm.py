"""D2Q9 lattice-Boltzmann fluid dynamics — the paper's benchmark, on the port.

The port of the JAX package's ``apps/lbm.py``. Three SPD sub-modules
mirror the paper's §III-B decomposition:

* ``uLBM_calc``   — BGK collision as SPD ``EQU`` formulae (131 FP ops:
  66 add, 64 mul, 1 div).
* ``uLBM_Trans2D``— translation (streaming) via ``Stencil2D`` nodes, one
  per lattice direction.
* ``uLBM_bndry``  — bounce-back with a moving-wall momentum correction,
  from ``Comparator``/``SyncMux`` nodes; ``uLBM_bndryHDL`` is the same
  unit as one fixed-function library module with a CUDA emitter.

``PE`` chains calc -> trans -> bndry (paper Fig. 7); temporal cascades come
from :func:`repro_torch.core.transforms.temporal_cascade`. A full-grid
torch reference and the Taylor-Green / Couette / cavity initial states
live here too; :class:`LBMSimulation` runs the PE through the generated
Hopper stream kernel (docs/pipeline.md §codegen). :func:`lbm_program` is
the same PE as a 3-core stream program (collide+stream → boundary →
moments, docs/port.md §program), every fusion partition bitwise equal to
the PE.

Lattice convention (matches the kernels and tests):
    e0=( 0, 0)  e1=( 1, 0)  e2=( 0, 1)  e3=(-1, 0)  e4=( 0,-1)
    e5=( 1, 1)  e6=(-1, 1)  e7=(-1,-1)  e8=( 1,-1)
axis 0 of a field is y, axis 1 is x; attribute 0=fluid, 1=solid wall,
2=moving wall (velocity ``u_lid`` in +x).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.compiler import Registry, f32
from repro_torch.core.library import LibraryModule, _shift2d, f32_literal
from repro_torch.core.spd import parse_spd
from repro_torch.core.transforms import temporal_cascade
from repro_torch.interop import from_numpy, resolve_device

# --------------------------------------------------------------------------
# Lattice constants
# --------------------------------------------------------------------------

EX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1])
EY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1])
W = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6])
CS2 = 1.0 / 3.0


def viscosity(tau: float) -> float:
    return CS2 * (tau - 0.5)


def _lattice(values, like: torch.Tensor) -> torch.Tensor:
    """A (9, 1, 1) f32 column of lattice constants on ``like``'s device."""
    return torch.as_tensor(np.asarray(values, np.float32),
                           device=like.device).reshape(9, 1, 1)


# --------------------------------------------------------------------------
# Full-grid torch reference (the oracle)
# --------------------------------------------------------------------------


def collide(f: torch.Tensor, one_tau) -> torch.Tensor:
    """BGK collision on a stacked field f: (9, H, W) -> (9, H, W)."""
    rho = torch.sum(f, dim=0)
    inv_rho = 1.0 / rho
    ux = (f[1] + f[5] + f[8] - f[3] - f[6] - f[7]) * inv_rho
    uy = (f[2] + f[5] + f[6] - f[4] - f[7] - f[8]) * inv_rho
    usq = ux * ux + uy * uy
    cu = _lattice(EX, f) * ux + _lattice(EY, f) * uy
    feq = _lattice(W, f) * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
    return f - f32(one_tau, f.device) * (f - feq)


def stream(f: torch.Tensor, mode: str = "wrap") -> torch.Tensor:
    """Translation: f_i(x + e_i) <- f_i(x). axis0=y, axis1=x."""
    return torch.stack([
        _shift2d(f[i], int(EY[i]), int(EX[i]), mode) for i in range(9)
    ])


def bounce_back(f: torch.Tensor, attr: torch.Tensor, u_lid,
                rho0: float = 1.0) -> torch.Tensor:
    """Full-way bounce-back at solid nodes (attr>=1); attr==2 adds the
    moving-wall momentum correction 6 w_i rho0 (e_i . u_w)."""
    solid = attr >= 0.5
    moving = attr >= 1.5
    reflected = f[torch.as_tensor(OPP, device=f.device)]
    corr = (6.0 * _lattice(W, f) * f32(rho0, f.device) * _lattice(EX, f)
            * f32(u_lid, f.device))
    bb = torch.where(moving[None], reflected + corr, reflected)
    return torch.where(solid[None], bb, f)


def ref_step(f, attr, one_tau, u_lid=0.0, mode="wrap"):
    """One LBM time step: collide (fluid only) -> stream -> boundary."""
    fluid = attr < 0.5
    fc = torch.where(fluid[None], collide(f, one_tau), f)
    fs = stream(fc, mode=mode)
    return bounce_back(fs, attr, u_lid)


def ref_run(f, attr, one_tau, steps: int, u_lid=0.0, mode="wrap"):
    for _ in range(steps):
        f = ref_step(f, attr, one_tau, u_lid, mode)
    return f


def macroscopics(f):
    rho = torch.sum(f, dim=0)
    ux = (f[1] + f[5] + f[8] - f[3] - f[6] - f[7]) / rho
    uy = (f[2] + f[5] + f[6] - f[4] - f[7] - f[8]) / rho
    return rho, ux, uy


# --------------------------------------------------------------------------
# SPD sources (the paper's Figs. 6-11 rebuilt)
# --------------------------------------------------------------------------

_F = [f"f{i}" for i in range(9)]


def calc_spd() -> str:
    """BGK collision as SPD EQU formulae (131 FP ops)."""
    L = [
        "Name uLBM_calc;",
        "Main_In {mi::" + ",".join(_F) + ",atr};",
        "Main_Out {mo::" + ",".join(f"g{i}" for i in range(9)) + ",oatr};",
        "Append_Reg {rg::one_tau};",
        "Param w0 = 0.444444444;",
        "Param w1 = 0.111111111;",
        "Param w5 = 0.027777778;",
        "EQU Nrho, rho = f0+f1+f2+f3+f4+f5+f6+f7+f8;",
        "EQU Nirh, irho = 1.0 / rho;",
        "EQU Nux, ux = (f1+f5+f8-f3-f6-f7)*irho;",
        "EQU Nuy, uy = (f2+f5+f6-f4-f7-f8)*irho;",
        "EQU Nusq, usq = ux*ux + uy*uy;",
        "EQU Nfe0, feq0 = w0*rho*(1.0 - 1.5*usq);",
    ]
    for i in range(1, 9):
        ex, ey = int(EX[i]), int(EY[i])
        wname = "w1" if i <= 4 else "w5"
        if ey == 0:
            cu = "ux" if ex == 1 else "-ux"  # negation is a free sign flip
        elif ex == 0:
            cu = "uy" if ey == 1 else "-uy"
        else:
            sx = "ux" if ex == 1 else "-ux"
            sy = "+uy" if ey == 1 else "-uy"
            cu = f"({sx}{sy})"
        L.append(f"EQU Ncu{i}, cu{i} = {cu};")
        L.append(
            f"EQU Nfe{i}, feq{i} = {wname}*rho*"
            f"(1.0 + 3.0*cu{i} + 4.5*cu{i}*cu{i} - 1.5*usq);"
        )
    for i in range(9):
        L.append(f"EQU Ng{i}, gc{i} = f{i} - one_tau*(f{i} - feq{i});")
    # Collision applies on fluid cells only; walls pass through untouched.
    L.append("HDL Csld, 0, (sld) = Comparator(atr, half), op=ge;")
    L.append("Param half = 0.5;")
    for i in range(9):
        L.append(f"HDL Mg{i}, 0, (g{i}) = SyncMux(sld, f{i}, gc{i});")
    L.append("DRCT (oatr) = (atr);")
    return "\n".join(L)


def trans_spd(width: int, mode: str = "wrap") -> str:
    """Translation stage: one Stencil2D offset per lattice direction."""
    L = [
        "Name uLBM_Trans2D;",
        "Main_In {mi::" + ",".join(f"g{i}" for i in range(9)) + ",atr};",
        "Main_Out {mo::" + ",".join(f"s{i}" for i in range(9)) + ",oatr};",
    ]
    for i in range(9):
        dy, dx = int(EY[i]), int(EX[i])
        L.append(
            f"HDL T{i}, 0, (s{i}) = Stencil2D(g{i}), "
            f"dy={dy}, dx={dx}, W={width}, mode={mode};"
        )
    L.append("DRCT (oatr) = (atr);")
    return "\n".join(L)


def bndry_spd() -> str:
    """Bounce-back boundary stage built from Comparator/SyncMux nodes."""
    L = [
        "Name uLBM_bndry;",
        "Main_In {mi::" + ",".join(f"s{i}" for i in range(9)) + ",atr};",
        "Main_Out {mo::" + ",".join(f"h{i}" for i in range(9)) + ",oatr};",
        "Append_Reg {rg::u_lid,rho0};",
        "Param half = 0.5;",
        "Param oneh = 1.5;",
        "HDL Csld, 0, (sld) = Comparator(atr, half), op=ge;",
        "HDL Cmov, 0, (mov) = Comparator(atr, oneh), op=ge;",
    ]
    for i in range(9):
        o = int(OPP[i])
        if EX[i] != 0:
            # moving-wall momentum correction: +6 w_i rho0 (e_i . u_w)
            coef = 6.0 * float(W[i]) * float(EX[i])
            sign = "+" if coef >= 0 else "-"
            L.append(
                f"EQU Nc{i}, corr{i} = s{o} {sign} "
                f"{abs(coef):.9f}*u_lid*rho0;"
            )
            L.append(f"HDL Mm{i}, 0, (bb{i}) = SyncMux(mov, corr{i}, s{o});")
        else:
            L.append(f"EQU Nc{i}, bb{i} = s{o};")
        L.append(f"HDL Ms{i}, 0, (h{i}) = SyncMux(sld, bb{i}, s{i});")
    L.append("DRCT (oatr) = (atr);")
    return "\n".join(L)


def _bndry_hdl_impl(ins, p):
    """Fixed-function bounce-back unit (the paper's uLBM_bndry HDL node).

    Elementwise over per-direction streams with f32 lattice constants;
    :func:`_bndry_hdl_cuda` prints the same operations for the generated
    stream kernel (docs/port.md §ir).
    """
    f = [x.to(torch.float32) for x in ins[:9]]
    attr, u_lid, rho0 = ins[9], ins[10], ins[11]
    solid = attr >= 0.5
    moving = attr >= 1.5
    out = []
    for i in range(9):
        refl = f[int(OPP[i])]
        coef = 6.0 * float(W[i]) * float(EX[i])
        bb = torch.where(
            moving, refl + f32(coef, refl.device) * rho0 * u_lid, refl
        ) if coef else refl
        out.append(torch.where(solid, bb, f[i]))
    return out + [attr]


def _bndry_hdl_cuda(outs, ins, p):
    """Device statements of :func:`_bndry_hdl_impl`, op for op."""
    f, (attr, u_lid, rho0) = ins[:9], ins[9:]
    L = [
        f"const bool {outs[9]}_sld = {attr} >= 0.5f;",
        f"const bool {outs[9]}_mov = {attr} >= 1.5f;",
    ]
    for i in range(9):
        refl = f[int(OPP[i])]
        coef = 6.0 * float(W[i]) * float(EX[i])
        bb = (f"({outs[9]}_mov ? ({refl} + (({f32_literal(coef)} * {rho0})"
              f" * {u_lid})) : {refl})" if coef else refl)
        L.append(f"const float {outs[i]} = {outs[9]}_sld ? {bb} : {f[i]};")
    L.append(f"const float {outs[9]} = {attr};")
    return L


def _register_bndry_module(reg: Registry) -> None:
    reg.register_library(
        LibraryModule(
            "uLBM_bndryHDL", 12, 10, (), _bndry_hdl_impl,
            # reflect network + mux + one MAC stage of fixed-function logic
            delay_fn=lambda p: 8,
            cuda=_bndry_hdl_cuda,
        )
    )


def pe_spd(width: int, mode: str = "wrap", name: str = "PEx1",
           bndry: str = "hdl") -> str:
    """One processing element: calc -> trans -> bndry (paper Fig. 7).

    ``bndry='hdl'`` mirrors the paper (uLBM_bndry is a fixed-function HDL
    node, so the PE's FP-operator census stays at the computation pipeline's
    131); ``bndry='spd'`` uses the SPD-described boundary stage instead.
    """
    fin = ",".join(_F)
    g = ",".join(f"g{i}" for i in range(9))
    s = ",".join(f"s{i}" for i in range(9))
    h = ",".join(f"h{i}" for i in range(9))
    bmod = "uLBM_bndryHDL" if bndry == "hdl" else "uLBM_bndry"
    return f"""
Name {name};
Main_In {{mi::{fin},atr}};
Main_Out {{mo::{h},oatr}};
Append_Reg {{rg::one_tau,u_lid,rho0}};
HDL Ucalc, 0, ({g},a1) = uLBM_calc({fin},atr,one_tau);
HDL Utrans, 0, ({s},a2) = uLBM_Trans2D({g},a1);
HDL Ubndry, 0, ({h},a3) = {bmod}({s},a2,u_lid,rho0);
DRCT (oatr) = (a3);
"""


def collide_stream_spd(width: int, mode: str = "wrap",
                       name: str = "uLBM_CollideStream") -> str:
    """Program stage 1: BGK collision chained into translation.

    The first core of the 3-core LBM stream program (docs/port.md
    §program): the first two HDL calls of :func:`pe_spd`, so the
    program's fused execution stays bitwise equal to the monolithic PE.
    """
    fin = ",".join(_F)
    g = ",".join(f"g{i}" for i in range(9))
    s = ",".join(f"s{i}" for i in range(9))
    return f"""
Name {name};
Main_In {{mi::{fin},atr}};
Main_Out {{mo::{s},oatr}};
Append_Reg {{rg::one_tau}};
HDL Ucalc, 0, ({g},a1) = uLBM_calc({fin},atr,one_tau);
HDL Utrans, 0, ({s},a2) = uLBM_Trans2D({g},a1);
DRCT (oatr) = (a2);
"""


def bndry_stage_spd(name: str = "uLBM_Bndry2D", bndry: str = "hdl") -> str:
    """Program stage 2: the bounce-back boundary unit as its own core.

    Stencil-free (halo 0): a pipelined cut before this stage costs one
    HBM round trip per step but no extra halo rows.
    """
    s = ",".join(f"s{i}" for i in range(9))
    h = ",".join(f"h{i}" for i in range(9))
    bmod = "uLBM_bndryHDL" if bndry == "hdl" else "uLBM_bndry"
    return f"""
Name {name};
Main_In {{mi::{s},atr}};
Main_Out {{mo::{h},oatr}};
Append_Reg {{rg::u_lid,rho0}};
HDL Ubndry, 0, ({h},a3) = {bmod}({s},atr,u_lid,rho0);
DRCT (oatr) = (a3);
"""


def moments_spd(name: str = "uLBM_Moments") -> str:
    """Program stage 3: macroscopic diagnostics, distributions pass through.

    Computes rho/ux/uy *inside the stripe* and forwards the distributions
    unchanged — which keeps every fusion partition of the program bitwise
    equal to the monolithic PE. The diagnostics reach no output: the
    generated kernel computes them, and ``nvcc`` removes them.
    """
    hin = ",".join(f"h{i}" for i in range(9))
    L = [
        f"Name {name};",
        "Main_In {mi::" + hin + ",atr};",
        "Main_Out {mo::" + ",".join(f"o{i}" for i in range(9)) + ",oatr};",
        "EQU Mrho, rho = h0+h1+h2+h3+h4+h5+h6+h7+h8;",
        "EQU Mirh, irho = 1.0 / rho;",
        "EQU Mux, ux = (h1+h5+h8-h3-h6-h7)*irho;",
        "EQU Muy, uy = (h2+h5+h6-h4-h7-h8)*irho;",
    ]
    for i in range(9):
        L.append(f"DRCT (o{i}) = (h{i});")
    L.append("DRCT (oatr) = (atr);")
    return "\n".join(L)


def build_lbm_registry(width: int, mode: str = "wrap",
                       bndry: str = "hdl") -> Registry:
    """Compile the three stages + PE into a fresh registry."""
    reg = Registry()
    _register_bndry_module(reg)
    reg.compile(parse_spd(calc_spd()))
    reg.compile(parse_spd(trans_spd(width, mode)))
    reg.compile(parse_spd(bndry_spd()))
    reg.compile(parse_spd(pe_spd(width, mode, bndry=bndry)))
    return reg


def lbm_program(width: int, mode: str = "wrap", bndry: str = "hdl",
                device="cuda"):
    """The LBM application as a 3-core stream program (docs/port.md
    §program).

    collide+stream → boundary handling → macroscopic diagnostics, with
    the fusion partition — which stages share one generated kernel — left
    to the DSE (``StreamProgram.explorer().sweep_gpu(fusion_values=...)``).
    Fully fused it is the monolithic :func:`pe_spd` pipeline plus
    in-stripe diagnostics; every partition is bitwise equal to it.
    """
    from repro_torch.core.program import StreamProgram

    reg = build_lbm_registry(width, mode, bndry)
    reg.compile(parse_spd(collide_stream_spd(width, mode)))
    reg.compile(parse_spd(bndry_stage_spd(bndry=bndry)))
    reg.compile(parse_spd(moments_spd()))
    return StreamProgram(
        reg,
        ["uLBM_CollideStream", "uLBM_Bndry2D", "uLBM_Moments"],
        width=width,
        name="uLBM_Program",
        device=device,
    )


# --------------------------------------------------------------------------
# Simulation driver
# --------------------------------------------------------------------------


@dataclass
class LBMProblem:
    height: int
    width: int
    tau: float = 0.8
    u_lid: float = 0.0
    mode: str = "wrap"  # 'wrap' (periodic) or 'zero' (walled domains)

    @property
    def one_tau(self) -> float:
        return 1.0 / self.tau


class LBMSimulation:
    """Runs LBM via the SPD-compiled PE (optionally cascaded m times).

    :meth:`run` applies the compiled dataflow function on full grids;
    :meth:`stream_kernel` is the PE lowered to the generated Hopper
    stream kernel. ``device`` is where :meth:`stream_state` puts the
    packed state (``"cuda"`` without a card raises).
    """

    def __init__(self, problem: LBMProblem, m: int = 1, bndry: str = "hdl",
                 device="cuda"):
        self.problem = problem
        self.m = m
        self.device = resolve_device(device)
        self.registry = build_lbm_registry(problem.width, problem.mode, bndry)
        pe = self.registry._cores["PEx1"]
        self.pe = pe if m == 1 else temporal_cascade(pe, m)
        self._stream_kernel = None
        self._programs: dict = {}

    def _apply(self, f, attr):
        p = self.problem
        ins = [f[i] for i in range(9)] + [
            attr,
            f32(p.one_tau, f.device),
            f32(p.u_lid, f.device),
            f32(1.0, f.device),
        ]
        outs = self.pe.apply(ins)
        return torch.stack(outs[:9])

    def run(self, f, attr, steps: int):
        if steps % self.m:
            raise ValueError(f"steps ({steps}) must be a multiple of m={self.m}")
        for _ in range(steps // self.m):
            f = self._apply(f, attr)
        return f

    @property
    def hardware_report(self):
        return self.pe.hardware_report

    def stream_workload(self):
        """DSE workload for this problem: T = H*W elements, W-wide rows,
        with the Hopper tile of the PE's generated kernel
        (``CompiledCore.stream_workload``)."""
        p = self.problem
        return self.pe.stream_workload(p.height * p.width, grid_w=p.width)

    def explorer(self, **kw):
        """Design-space :class:`~repro_torch.core.explorer.Explorer` for
        this simulation's compiled PE on this problem size. The PE's
        generated kernel is the explorer's core, so GPU lattice points —
        multi-device ones included — execute through it
        (``Explorer.search``, docs/pipeline.md §execute)."""
        from repro_torch.core.explorer import Explorer

        kw.setdefault("core", self.stream_kernel())
        return Explorer(self.stream_workload(),
                        census=self.hardware_report.census, **kw)

    # ---- codegen'd-kernel surface (docs/pipeline.md §codegen) -------------

    def stream_kernel(self):
        """The PE lowered to a generated stream kernel (built once)."""
        if self._stream_kernel is None:
            self._stream_kernel = self.pe.stream_kernel(device=self.device)
        return self._stream_kernel

    def stream_state(self, f, attr) -> torch.Tensor:
        """Pack (9, H, W) populations + attr (numpy or torch) into the
        kernel's (10, H, W) state."""
        f = from_numpy(f, self.device)
        return self.stream_kernel().pack([f[i] for i in range(9)] + [attr])

    def stream_regs(self) -> tuple:
        """``Append_Reg`` values of the PE for this problem."""
        return (self.problem.one_tau, self.problem.u_lid, 1.0)

    # ---- stream-program surface (docs/port.md §program) -------------------

    def program(self, bndry: str = "hdl"):
        """This problem as the 3-core stream program (built once per
        boundary variant, on this simulation's device).

        Same state packing (:meth:`stream_state`) and register values
        (:meth:`stream_regs` — flat program order is ``one_tau, u_lid,
        rho0``, matching the PE) as the monolithic kernel, so the two
        paths are directly bit-comparable.
        """
        if bndry not in self._programs:
            self._programs[bndry] = lbm_program(
                self.problem.width, self.problem.mode, bndry,
                device=self.device,
            )
        return self._programs[bndry]


# --------------------------------------------------------------------------
# Initial conditions + analytic references
# --------------------------------------------------------------------------


def equilibrium(rho, ux, uy):
    usq = ux * ux + uy * uy
    cu = _lattice(EX, rho) * ux + _lattice(EY, rho) * uy
    return _lattice(W, rho) * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu
                                     - 1.5 * usq)


def _grid(h: int, w: int, device):
    dev = resolve_device(device)
    return torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )


def taylor_green_init(h: int, w: int, u0: float = 0.05, device="cuda"):
    """Periodic Taylor-Green vortex; returns (f, attr, decay_rate)."""
    y, x = _grid(h, w, device)
    kx, ky = 2 * math.pi / w, 2 * math.pi / h
    ux = -u0 * torch.cos(kx * x) * torch.sin(ky * y)
    uy = u0 * (kx / ky) * torch.sin(kx * x) * torch.cos(ky * y)
    rho = torch.ones_like(x)
    attr = torch.zeros_like(x)
    return equilibrium(rho, ux, uy), attr, float(kx * kx + ky * ky)


def couette_init(h: int, w: int, device="cuda"):
    """Channel with static bottom wall and moving top lid (+x)."""
    rho = torch.ones((h, w), dtype=torch.float32,
                     device=resolve_device(device))
    f = equilibrium(rho, torch.zeros_like(rho), torch.zeros_like(rho))
    attr = torch.zeros_like(rho)
    attr[0, :] = 1.0  # bottom: static wall
    attr[-1, :] = 2.0  # top: moving lid
    return f, attr


def cavity_init(h: int, w: int, device="cuda"):
    """Lid-driven cavity: three static walls + moving top lid."""
    f, attr = couette_init(h, w, device)
    attr[:, 0] = 1.0
    attr[:, -1] = 1.0
    attr[-1, :] = 2.0
    return f, attr


def tgv_kinetic_energy(f):
    _, ux, uy = macroscopics(f)
    return float(torch.mean(ux * ux + uy * uy))
