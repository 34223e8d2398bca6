"""Build variants of the Hopper flash kernel and time them side by side.

Each variant is ``csrc/flash_attention.cu`` with one design choice undone
by a textual substitution: the 128-key softmax step instead of 64 keys,
no ``setmaxnreg``. All are
built in parallel with the library's own flags and timed (CUDA events) in
one process on the Qwen3-8B prefill launch (q 4x32x2048x128, kv
4x8x2048x128, bf16, causal), beside ptxas's registers, spills and
performance notes for the bf16 D 128 kernel and the max abs difference
from the plain version. On the machine with the card::

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.variants
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import time

#: Edits to the kernel's source, each [(old, new), ...].
BN128 = [("constexpr int BN = 64;", "constexpr int BN = 128;")]
NO_SETMAXNREG = [
    ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n"\n'
     '                 :: "n"(PRODUCER_REGS));\n', ""),
    ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n"\n'
     '                 :: "n"(CONSUMER_REGS));\n', ""),
]
#: name -> the edits applied together.
VARIANTS = {
    "kernel": [],
    "bn128": BN128,
    "no_setmaxnreg": NO_SETMAXNREG,
}


def variant_source(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"variant edit does not apply once: {old!r}")
        source = source.replace(old, new)
    return source


def ptxas_d128(log: str) -> str:
    """Registers, spills and performance notes of the bf16 D 128 kernel."""
    m = re.search(r"hopper12flash_kernelILi128E\w*' for 'sm_90a'\n.*?\n"
                  r"\s*(.*spill loads)\n.*?Used (\d+) registers", log)
    notes = sorted(set(re.findall(r"\((C75\d\d)\)", log)))
    return (f"{m.group(2)} registers, {m.group(1)}" if m else "not found") + (
        f", notes {notes}" if notes else "")


def main() -> None:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_plain,
    )
    from repro_torch.kernels.timing import card_line, ms_rounds

    if not torch.cuda.is_available():
        raise SystemExit("variants: needs the card")
    srcs = {name: variant_source(build.flash_source(), edits)
            for name, edits in VARIANTS.items()}
    build.build_all({f"flash_{name}": src for name, src in srcs.items()})

    b, hq, hkv, s, d = 4, 32, 8, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, hq, s, d), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((b, hkv, s, d), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    want = flash_attention_plain(q, k, v).float()
    ops = 4 * b * hq * d * (s * (s + 1) // 2)
    print(f"{card_line()}; causal prefill launch q {tuple(q.shape)} kv "
          f"{tuple(k.shape)} bf16")
    out = torch.empty((b, s, hq, d), dtype=q.dtype,
                      device="cuda").transpose(1, 2)
    st = build.FlashStrides()
    for i, x in enumerate((q, k, v, out)):
        for j in range(3):
            st.s[3 * i + j] = x.stride(j)
    stream = torch.cuda.current_stream().cuda_stream
    runs, errs, notes = {}, {}, {}
    for name, src in srcs.items():
        so = build.library_path(f"flash_{name}", src)
        fwd = ctypes.CDLL(str(so)).flash_attention_fwd
        fwd.argtypes = build.FLASH_FWD_ARGTYPES

        def run(fwd=fwd, name=name):
            build.check(fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), 1, b, hq, hkv, s, s, d, st,
                            d ** -0.5, 1, 0, stream), name)

        run()
        torch.cuda.synchronize()
        errs[name] = float((out.float() - want).abs().max())
        notes[name] = ptxas_d128(so.with_suffix(".log").read_text())
        runs[name] = run

    times = ms_rounds(runs, rounds=3, iters=50, warmup=4)
    # The card's clock and power under each variant: nvidia-smi samples
    # while ~0.7 s of launches are queued.
    clocks = {}
    for name, run in runs.items():
        for _ in range(2000):
            run()
        clocks[name] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        torch.cuda.synchronize()
    # Host time of the wrapper's library lookup: hashing the source on
    # every call (uncached) against the cached binding.
    for label, fn in (("hashing the source", lambda: build.load(
            "flash_attention", build.flash_source())),
            ("cached", build.load_flash_library)):
        fn()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        print(f"  library lookup, {label}: "
              f"{(time.perf_counter() - t0) / 50 * 1e3:.4f} ms of host time")
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"  {name}: {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}), "
              f"{ops / ms / 1e9:.1f} TFLOP/s, max abs err vs plain "
              f"{errs[name]:.3e}; under load {clocks[name]}; ptxas "
              f"{notes[name]}")


if __name__ == "__main__":
    main()
