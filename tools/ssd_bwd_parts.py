#!/usr/bin/env python3
"""Where the SSD backward's chunk-parallel launch spends its time.

Builds copies of ``csrc/ssd_scan_bwd.cu`` in which parts of
``ssd_bwd_chunk_kernel`` do nothing (their loops run zero times, so the
results are wrong, but every other part runs as it does), and times the
whole backward of each copy at mamba2-1.3b's training shape (B 1, S 4096,
H 64, P 64, N 128, chunk 64) with ``chip_smoke.time_ms``. The parts:

    U       U = dH B^T, both halves of a warp pair
    dx      (W G)^T dy
    dB      the per-head dB product
    dC      the per-head dC product and its dy.(H0 C) fold
    D       D = dy x^T
    hd      <dH, H0>
    loads   the ring's copies of x, dy, H0 and dH
    split   the split of each item's x and dy into TF32 hi and lo, a part
            only of the variant in ``tools/ssd_bwd_split_once.patch``
    WG      W G and the zeroing of D at each head
    dA      warp 0's dA and reverse running sum

A variant is a "+"-joined list of parts left out ("full" leaves out
nothing). Each part is switched off by replacing one exact fragment of the
kernel's text (``PARTS``), so the tool is tied to the kernel as it is
written: after an edit to ``ssd_bwd_chunk_kernel`` it stops with the name of
a part asked for whose text it no longer finds, and ``PARTS`` is brought up
to date with the kernel. Each copy is built with the library's own nvcc flags into
``build/ssd_bwd_parts/``; ptxas' spill report of the chunk kernel is
printed beside its time, since a variant may spill where the kernel does
not.

Run from the repository root on a machine with one CUDA card:

    python3 tools/ssd_bwd_parts.py [VARIANT ...]
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402

OUT = ROOT / "build" / "ssd_bwd_parts"
# part -> (text in the chunk kernel, the same text with the part's loop
# bound or body switched off by the macro SKIP_<part>)
PARTS = {
    "U": ("for (int k = dh_side ? 0 : kh; k < (dh_side ? kh : KN); ++k)",
          "for (int k = dh_side ? 0 : kh; k < (SKIP_U ? 0 : (dh_side ? kh : KN)); ++k)"),
    "dx": ("for (int k = 2 * ri; k < KL; ++k)\n          mma3(r,",
           "for (int k = 2 * ri; k < (SKIP_dx ? 0 : KL); ++k)\n          mma3(r,"),
    "dB": ("const float* sb = dhs + quad * kHS + 16 * wi + grp;\n#pragma unroll 1\n"
           "        for (int k = 0; k < kKS; ++k) {",
           "const float* sb = dhs + quad * kHS + 16 * wi + grp;\n#pragma unroll 1\n"
           "        for (int k = 0; k < (SKIP_dB ? 0 : kKS); ++k) {"),
    "dC": ("#pragma unroll 1\n        for (int k = 0; k < kKS; ++k) {\n"
           "          const SplitB b0 = split_b(sb[8 * k * kHS], sb[(8 * k + 4) * kHS]);\n"
           "          const SplitB b1 = split_b(sb[8 * k * kHS + 8], sb[(8 * k + 4) * kHS + 8]);\n"
           "#pragma unroll\n          for (int mt = 0; mt < 4; ++mt) {\n"
           "            const int l0",
           "#pragma unroll 1\n        for (int k = 0; k < (SKIP_dC ? 0 : kKS); ++k) {\n"
           "          const SplitB b0 = split_b(sb[8 * k * kHS], sb[(8 * k + 4) * kHS]);\n"
           "          const SplitB b1 = split_b(sb[8 * k * kHS + 8], sb[(8 * k + 4) * kHS + 8]);\n"
           "#pragma unroll\n          for (int mt = 0; mt < 4; ++mt) {\n"
           "            const int l0"),
    "D": ("for (int u = wi; u < kLower; u += 8) {\n          int ti, tj;\n"
          "          lower_tile(u, ti, tj);\n          const float* ya",
          "for (int u = wi; u < (SKIP_D ? 0 : kLower); u += 8) {\n          int ti, tj;\n"
          "          lower_tile(u, ti, tj);\n          const float* ya"),
    "hd": ("for (int e = tid; e < kRows * kN; e += kThreads) {",
           "for (int e = tid; e < (SKIP_hd ? 0 : kRows * kN); e += kThreads) {"),
    "loads": ("  auto load_item = [&](int t) {\n",
              "  auto load_item = [&](int t) {\n    if (SKIP_loads) return;\n"),
    "split": ("{                                 // split the x and dy it copied, once\n",
              "if (!SKIP_split) {                // split the x and dy it copied, once\n"),
    "WG": ("for (int e = tid; e < kL * kL; e += kThreads) {\n      const int l = e / kL",
           "for (int e = tid; e < (SKIP_WG ? 0 : kL * kL); e += kThreads) {\n"
           "      const int l = e / kL"),
    "dA": ("if (warp == 0) {                    // dA,",
           "if (warp == 0 && !SKIP_dA) {        // dA,"),
}
DEFAULT = ["full", "U", "dx", "dB", "dC", "D", "dB+dC",
           "U+dx+dB+dC+D+hd", "U+dx+dB+dC+D+hd+loads", "U+dx+dB+dC+D+hd+loads+WG+dA"]


def variant_source(wanted) -> str:
    """The kernel with every part found in it switched by its macro; fails
    if a part in ``wanted`` is not found once."""
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    for part, (old, new) in PARTS.items():
        if src.count(old) > 1 or (part in wanted and src.count(old) != 1):
            raise SystemExit(f"part {part}: its text is not once in ssd_scan_bwd.cu")
        src = src.replace(old, new)
    macros = "".join(f"#ifndef SKIP_{p}\n#define SKIP_{p} 0\n#endif\n" for p in PARTS)
    return macros + src


def main():
    variants = sys.argv[1:] or DEFAULT
    for v in variants:
        bad = [p for p in v.split("+") if p != "full" and p not in PARTS]
        if bad:
            raise SystemExit(f"unknown parts {bad}; parts: {', '.join(PARTS)}")
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ssd_scan_bwd_parts.cu"
    src.write_text(variant_source({p for v in variants for p in v.split("+")}))
    procs = {}
    for v in variants:
        flags = [f"-DSKIP_{p}=1" for p in v.split("+") if p != "full"]
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(build.CSRC), "-o",
               str(OUT / f"lib{v}.so"), str(src)]
        procs[v] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    spills = {}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {v}: nvcc failed:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "spill stores" in line and "chunk_kernel" in entry:
                spills[v] = line.strip()

    cs.phase_device()
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    b, s, h, p, n, chunk = 1, cs.TRAIN_SEQ, cs.SSD_H, cs.SSD_P, cs.SSD_N, cs.M_BLOCK
    x, dta, bm, cm, _ = cs.ssd_inputs(gen, b, s, h, p, n)
    y, final, states = ssd_mod.ssd_scan(x, dta, bm, cm, chunk=chunk, return_all_states=True)
    dy, dfinal = torch.randn_like(y), torch.randn_like(final)
    plan = ssd_mod.ssd_bwd_plan(b, s, h, p, n, chunk)
    f32 = dict(dtype=torch.float32, device=cs.DEV)
    outs = [torch.empty(plan.dh_end, **f32), torch.empty_like(x), torch.empty((b, s, h), **f32),
            torch.empty(plan.partials, **f32), torch.empty(plan.partials, **f32),
            torch.empty((b, s, n), **f32), torch.empty((b, s, n), **f32)]
    ins = [t.data_ptr() for t in (x, dta, bm, cm, states, dy, dfinal)]
    for v in variants:
        fn = ctypes.CDLL(str(OUT / f"lib{v}.so")).ssd_scan_bwd
        fn.argtypes = ssd_mod._BWD_ARGTYPES
        fn.restype = ctypes.c_int

        def call():
            build.check(fn(*ins, *[t.data_ptr() for t in outs], b, s, h, p, n, chunk,
                           plan.group, torch.cuda.current_stream().cuda_stream), v)
        what = "every part" if v == "full" else f"without {v}"
        print(f"  {what:<40s} {cs.time_ms(call, iters=15):.4f} ms  ({spills.get(v, '?')})",
              flush=True)
    print(cs._smi())


if __name__ == "__main__":
    main()
