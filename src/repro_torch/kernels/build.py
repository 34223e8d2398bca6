"""Build and load the port's CUDA kernels (docs/port.md §build).

Every kernel is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``: pointers and the CUDA stream travel
as ``c_void_p``, each entry point returns ``cudaGetLastError()`` (or a
negative code of its own: an under-priced shared-memory size, a missing
instantiation, a refused TMA descriptor) and :func:`check` raises on
anything but 0. Libraries are cached under ``build/repro_torch/`` by a
hash of their source, the headers they include and the flags, so a
process builds each kernel once; nothing is compiled at import time.
The set-up counters of :mod:`repro_torch.tracing` count the ``nvcc`` runs
(``builds``) and time the waits for them (``setup.build``) and the loads
(``setup.load``).

Flags: ``sm_90a``, ``-O3`` and ``-fmad=false`` — no multiply-add is
contracted, so a kernel's arithmetic is op for op that of its plain torch
version — and no ``--use_fast_math``, which would change ``/``, ``sqrt``
and ``exp``. The flash-attention library is held to its plain version
under a tolerance, not bit for bit, and is built without ``-fmad=false``
(:data:`FLASH_NVCC_FLAGS`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.tracing import add, timed

CSRC = Path(__file__).resolve().parents[1] / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

FLASH_NVCC_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")

_LIBS: dict[str, ctypes.CDLL] = {}


def flags_for(name: str) -> tuple:
    """The ``nvcc`` flags of the library ``name``."""
    return FLASH_NVCC_FLAGS if name.startswith("flash") else NVCC_FLAGS


def build_dir() -> Path:
    """``build/repro_torch/`` of the checkout (``build/`` is ignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin); the port's CUDA "
            "kernels are built on the machine with the card"
        )
    return path


def _headers() -> str:
    return "".join(
        p.read_text() for p in sorted(CSRC.glob("*.cuh"))
    )


def _paths(name: str, source: str) -> tuple[Path, Path]:
    key = hashlib.sha256(
        (source + _headers() + " ".join(flags_for(name))).encode()
    ).hexdigest()[:16]
    d = build_dir()
    return d / f"{name}-{key}.cu", d / f"{name}-{key}.so"


def library_path(name: str, source: str) -> Path:
    """Where the library of ``source`` is built; its ``nvcc`` output
    (``-Xptxas -v`` included) is beside it with the suffix ``.log``."""
    return _paths(name, source)[1]


def _start(name: str, source: str):
    """Start one ``nvcc``; returns ``(so_path, process or None)``."""
    cu, so = _paths(name, source)
    if so.exists():
        return so, None
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(source)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags_for(name), "-I", str(CSRC), "-o", str(tmp),
           str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    add("builds", 1)
    return so, (proc, tmp, cmd)


def _finish(so: Path, job) -> None:
    if job is None:
        return
    proc, tmp, cmd = job
    with timed("setup.build"):
        out, _ = proc.communicate()
    so.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
        )
    os.replace(tmp, so)


def build_all(sources: dict[str, str]) -> float:
    """Compile every ``{name: source}`` at once, one ``nvcc`` each, all
    started together; returns the wall seconds."""
    t0 = time.perf_counter()
    jobs = [_start(name, src) for name, src in sources.items()]
    for so, job in jobs:
        _finish(so, job)
    return time.perf_counter() - t0


def load(name: str, source: str) -> ctypes.CDLL:
    """The library of ``source``, compiled on first use."""
    so, job = _start(name, source)
    _finish(so, job)
    key = str(so)
    if key not in _LIBS:
        with timed("setup.load"):
            _LIBS[key] = ctypes.CDLL(key)
    return _LIBS[key]


def ptxas_usage(log: str) -> dict[str, tuple[int, int]]:
    """``{entry function: (registers, spill bytes)}`` from ``nvcc -Xptxas
    -v`` output (the ``.log`` beside a library); spill bytes are stores
    plus loads."""
    usage, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)), spill)
            name = None
    return usage


def check(rc: int, what: str) -> None:
    """Raise unless a C entry point returned 0."""
    if rc == -1:
        raise RuntimeError(f"{what}: shared memory passed is below the "
                           "kernel's own pricing of the tile")
    if rc == -2:
        raise RuntimeError(f"{what}: the library has no instantiation for "
                           "this head dim and dtype")
    if rc == -3:
        raise RuntimeError(f"{what}: no TMA descriptor (the driver refused "
                           "the base or a stride, or has no "
                           "cuTensorMapEncodeTiled)")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


class SpdRegs(ctypes.Structure):
    """``struct SpdRegs`` of ``csrc/spd_tile.cuh``, passed by value."""

    _fields_ = [("v", ctypes.c_float * 16)]


def spd_regs(values) -> SpdRegs:
    regs = SpdRegs()
    for i, v in enumerate(values):
        regs.v[i] = float(v)
    return regs


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def load_spd_library(program) -> ctypes.CDLL:
    """Build and bind a generated stream kernel's four launches (see
    ``csrc/spd_stream.cuh``)."""
    lib = load(f"spd_{program.name}", program.cuda_source())
    lib.spd_multistep.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, SpdRegs,
                                  _LL, _I, _P]
    lib.spd_multistep.restype = _I
    lib.spd_multistep_streamed.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I,
                                           _I, SpdRegs, _LL, _I, _P]
    lib.spd_multistep_streamed.restype = _I
    lib.spd_multistep_halo.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _I,
                                       SpdRegs, _LL, _I, _P]
    lib.spd_multistep_halo.restype = _I
    lib.spd_multistep_halo_streamed.argtypes = [_P, _P, _I, _I, _I, _I, _I,
                                                _I, _I, _I, SpdRegs, _LL, _I,
                                                _P]
    lib.spd_multistep_halo_streamed.restype = _I
    lib.spd_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.spd_smem_bytes.restype = _LL
    lib.spd_tile_planes.argtypes = [_I, _I]
    lib.spd_tile_planes.restype = _I
    lib.spd_owner_cells.argtypes = []
    lib.spd_owner_cells.restype = _I
    return lib


def lbm_source() -> str:
    return (CSRC / "lbm_stream.cu").read_text()


@functools.cache
def load_lbm_library() -> ctypes.CDLL:
    """Build and bind the hand-written D2Q9 kernel (``csrc/lbm_stream.cu``),
    once per process: a launch then costs no hash of the source."""
    lib = load("lbm_stream", lbm_source())
    lib.lbm_multistep.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I,
                                  ctypes.c_float, ctypes.c_float, _LL, _I,
                                  _P]
    lib.lbm_multistep.restype = _I
    lib.lbm_smem_bytes.argtypes = [_I, _I, _I]
    lib.lbm_smem_bytes.restype = _LL
    lib.lbm_max_cells.argtypes = []
    lib.lbm_max_cells.restype = _I
    return lib


class FlashStrides(ctypes.Structure):
    """``struct FlashStrides`` of ``csrc/flash_attention.cu``: the batch,
    head and sequence strides (elements) of q, k, v and the output."""

    _fields_ = [("s", ctypes.c_longlong * 12)]


def flash_source() -> str:
    return (CSRC / "flash_attention.cu").read_text()


@functools.cache
def load_flash_library() -> ctypes.CDLL:
    """Build and bind the hand-written flash-attention kernel
    (``csrc/flash_attention.cu``), once per process: a launch then costs
    no hash of the source on the host."""
    lib = load("flash_attention", flash_source())
    # (q, k, v, o, dtype, b, hq, hkv, sq, sk, d, dv, strides, scale,
    # causal, window, lse, lse batch stride, lse head stride, f32 output,
    # stream)
    lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _I, _I, FlashStrides,
                                        ctypes.c_float, _I, _I, _P, _LL, _LL,
                                        _P, _P]
    lib.flash_attention_fwd.restype = _I
    # (q, k, v, f32 o, do, lse, d scratch, dq, dk, dv, b, hq, hkv, sq, sk, d,
    # dv, lse row stride, strides of q k v o, of dq dk dv do, scale, causal,
    # window, stream)
    lib.flash_attention_bwd.argtypes = [*[_P] * 10, _I, _I, _I, _I, _I, _I,
                                        _I, _LL, FlashStrides, FlashStrides,
                                        ctypes.c_float, _I, _I, _P]
    lib.flash_attention_bwd.restype = _I
    lib.flash_wgmma_probe.argtypes = [_P, _P, _P, _P, _P, _I, _P]
    lib.flash_wgmma_probe.restype = _I
    return lib


def adamw_source() -> str:
    return (CSRC / "adamw.cu").read_text()


@functools.cache
def load_adamw_library() -> ctypes.CDLL:
    """Build and bind the fused AdamW pass (``csrc/adamw.cu``), once per
    process."""
    lib = load("adamw", adamw_source())
    for fn in ("adamw_tile", "adamw_max_parts", "adamw_sumsq_blocks"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = _I
    lib.adamw_table_bytes.argtypes = []
    lib.adamw_table_bytes.restype = _LL
    lib.adamw_sumsq.argtypes = [_P, _P, _P]
    lib.adamw_sumsq.restype = _I
    lib.adamw_finalize.argtypes = [_P, _I, ctypes.c_float, _P, _P]
    lib.adamw_finalize.restype = _I
    lib.adamw_step.argtypes = [_P, _P, _P, _P, _P, *[ctypes.c_float] * 6,
                               _I, _P]
    lib.adamw_step.restype = _I
    return lib
