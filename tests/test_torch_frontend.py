"""Port front end against the JAX package: parser, compiler, census,
stencil inference, codegen rejections and the IR's phase split.

Both packages parse the same SPD text; the cores must be structurally
identical and compile to identical hardware reports (census, depth,
balance registers, buffer bits, halo) — exact equality, no tolerance.
"""

import dataclasses
import glob
import os

import pytest

from repro.apps import diffusion as jdif
from repro.apps import lbm as jlbm
from repro.core import CodegenError as JCodegenError
from repro.core import Registry as JRegistry
from repro.core import parse_spd as jparse
from repro.core import stencil_summary as jsummary
from repro.core import temporal_cascade_spd as jcascade_spd
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm
from repro_torch.core import CodegenError, Registry, parse_spd, stencil_summary
from repro_torch.core import temporal_cascade_spd
from repro_torch.interop import core_structure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPD_FILES = sorted(glob.glob(os.path.join(ROOT, "src/repro/apps/spd/*.spd")))


def _generated_sources():
    pe = jparse(jlbm.pe_spd(720))
    return {
        "diffusion": jdif.diffusion_spd(128),
        "calc": jlbm.calc_spd(),
        "trans": jlbm.trans_spd(720),
        "bndry": jlbm.bndry_spd(),
        "pe_hdl": jlbm.pe_spd(720),
        "pe_spd": jlbm.pe_spd(720, bndry="spd"),
        "pe_t4": jcascade_spd(pe, 4),
    }


def test_seven_spd_files_shipped():
    assert len(SPD_FILES) == 7


@pytest.mark.parametrize("path", SPD_FILES, ids=os.path.basename)
def test_parsers_agree_on_spd_files(path):
    with open(path) as fh:
        text = fh.read()
    assert core_structure(parse_spd(text)) == core_structure(jparse(text))


@pytest.mark.parametrize("name", sorted(_generated_sources()))
def test_parsers_agree_on_generated_sources(name):
    text = _generated_sources()[name]
    assert core_structure(parse_spd(text)) == core_structure(jparse(text))


def test_port_apps_emit_the_reference_sources():
    """The port's SPD generators print the reference's text verbatim."""
    assert tdif.diffusion_spd(128) == jdif.diffusion_spd(128)
    assert tlbm.calc_spd() == jlbm.calc_spd()
    assert tlbm.trans_spd(720) == jlbm.trans_spd(720)
    assert tlbm.bndry_spd() == jlbm.bndry_spd()
    for bndry in ("hdl", "spd"):
        assert tlbm.pe_spd(720, bndry=bndry) == jlbm.pe_spd(720, bndry=bndry)
    core = parse_spd(tlbm.pe_spd(720))
    assert temporal_cascade_spd(core, 2) == jcascade_spd(jparse(
        jlbm.pe_spd(720)), 2)


@pytest.mark.parametrize("bndry", ["hdl", "spd"])
@pytest.mark.parametrize("m", [1, 2])
def test_hardware_reports_equal(bndry, m):
    """Census, depth, balance registers, buffer bits and halo: exact."""
    tsim = tlbm.LBMSimulation(tlbm.LBMProblem(300, 720), m=m, bndry=bndry,
                              device="cpu")
    jsim = jlbm.LBMSimulation(jlbm.LBMProblem(300, 720), m=m, bndry=bndry)
    for name, jcore in jsim.registry._cores.items():
        tcore = tsim.registry._cores[name]
        assert (dataclasses.asdict(tcore.hardware_report)
                == dataclasses.asdict(jcore.hardware_report)), name
    assert (dataclasses.asdict(tsim.hardware_report)
            == dataclasses.asdict(jsim.hardware_report))


def test_calc_census_is_131_flops_and_pe_depth():
    reg = Registry()
    calc = reg.compile(parse_spd(tlbm.calc_spd()))
    assert calc.flops == 131
    assert calc.census["div"] == 1
    assert calc.census["add"] + calc.census["mul"] == 130
    tpe = tlbm.LBMSimulation(tlbm.LBMProblem(16, 24), device="cpu").pe
    jpe = jlbm.LBMSimulation(jlbm.LBMProblem(16, 24)).pe
    assert tpe.hardware_report.depth == jpe.hardware_report.depth
    assert tpe.schedule.node_start == jpe.schedule.node_start
    t4 = tlbm.LBMSimulation(tlbm.LBMProblem(16, 24), m=4, device="cpu")
    assert t4.hardware_report.depth == 4 * tpe.hardware_report.depth


def test_diffusion_report_equal():
    t = tdif.compile_diffusion(128).hardware_report
    j = jdif.compile_diffusion(128).hardware_report
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _summary_tuple(s):
    return (dict(s.port_reads), s.offsets, s.halo_y, s.halo_x, s.modes)


@pytest.mark.parametrize("name", sorted(_generated_sources()))
def test_stencil_summaries_equal(name):
    text = _generated_sources()[name]
    treg, jreg = Registry(), JRegistry()
    tlbm._register_bndry_module(treg)
    jlbm._register_bndry_module(jreg)
    for src in (jlbm.calc_spd(), jlbm.trans_spd(720), jlbm.bndry_spd(),
                jlbm.pe_spd(720)):
        treg.compile(parse_spd(src))
        jreg.compile(jparse(src))
    t = stencil_summary(treg.compile(parse_spd(text)))
    j = jsummary(jreg.compile(jparse(text)))
    assert _summary_tuple(t) == _summary_tuple(j)


_REJECTED = {
    "zero_mode": ("""
        Name ZeroMode;
        Main_In {mi::x};
        Main_Out {mo::y};
        HDL S1, 0, (y) = Stencil2D(x), dy=1, dx=0, W=64, mode=zero;
    """, "mode"),
    "branch": ("""
        Name HasBranch;
        Main_In {mi::x};
        Main_Out {mo::y};
        Brch_Out {bo::t};
        EQU N1, y = x + 1.0;
        DRCT (t) = (y);
    """, "branch"),
    "port_counts": ("""
        Name TwoToOne;
        Main_In {mi::a,b};
        Main_Out {mo::y};
        EQU N1, y = a + b;
    """, "main_out"),
    "stream_1d": ("""
        Name HasDelay;
        Main_In {mi::x};
        Main_Out {mo::y};
        HDL D1, 0, (y) = Delay(x), 3;
    """, "1-D stream"),
}


@pytest.mark.parametrize("case", sorted(_REJECTED))
def test_codegen_rejections_equal(case):
    text, match = _REJECTED[case]
    with pytest.raises(JCodegenError, match=match):
        JRegistry().compile(jparse(text)).stream_kernel()
    with pytest.raises(CodegenError, match=match):
        Registry().compile(parse_spd(text)).stream_kernel(device="cpu")


def test_module_without_emitter_is_rejected_by_name():
    from repro_torch.core import LibraryModule

    reg = Registry()
    reg.register_library(LibraryModule(
        "NoEmit", 1, 1, (), lambda ins, p: [ins[0]], delay_fn=lambda p: 1,
    ))
    core = reg.compile(parse_spd("""
        Name UsesNoEmit;
        Main_In {mi::x};
        Main_Out {mo::y};
        HDL N1, 0, (y) = NoEmit(x);
    """))
    with pytest.raises(CodegenError, match="NoEmit.*no CUDA emitter"):
        core.stream_kernel(device="cpu")


def test_ir_phase_counts():
    """Diffusion reads its input only: one phase. The uLBM PE stencils
    the calc stage's g0..g8: two phases, nine materialized planes."""
    dif = tdif.DiffusionSimulation(16, 64, device="cpu").kernel.program
    assert (len(dif.phases), dif.K) == (1, 0)
    for bndry in ("hdl", "spd"):
        sim = tlbm.LBMSimulation(tlbm.LBMProblem(16, 64), bndry=bndry,
                                 device="cpu")
        prog = sim.stream_kernel().program
        assert (len(prog.phases), prog.K, prog.P) == (2, 9, 10)


def test_cuda_source_prints_f32_literals_only():
    """Every float literal carries the f suffix (no silent double)."""
    import re

    for sim in (tdif.DiffusionSimulation(16, 64, device="cpu"),):
        src = sim.kernel.program.cuda_source()
        assert "src[0 * RC + idx - (1 * C + (0))]" in src
    src = tlbm.LBMSimulation(tlbm.LBMProblem(16, 64), device="cpu") \
        .stream_kernel().program.cuda_source()
    body = src.split("struct SpdCore", 1)[1]
    bare = re.findall(r"(?<![\w.])\d+\.\d*(?:e[-+]?\d+)?(?![\w.])", body)
    assert not bare, f"literals without an f suffix: {bare}"
    # two phases in each of the shared-state and register-state steps
    assert src.count("__syncthreads()") == 4
