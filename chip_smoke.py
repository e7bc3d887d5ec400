#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: the five CUDA kernels from ``src/repro_torch/kernels/csrc`` with
     nvcc for sm_90a, one process per source, all started together (seconds,
     and ptxas' registers / shared memory / spills; the redesigned kernels
     (bf16 tensor-core prefill, warp-split legacy decode, clustered split-K
     decode, 3xTF32 SSD scan, the RG-LRU scan's shared-memory ring) must
     not spill);
  3. attention kernels (split-K and legacy warp-split decode, chunked
     prefill) against their plain PyTorch versions on the card, at the main
     path's shapes (qwen3-4b: Hq 32, Hkv 8, hd 128, page 16, bf16), at the
     other serves' head shapes (codeqwen1.5-7b's MHA, Hkv 32; yi-9b's and
     qwen3-moe's G 8, Hkv 4; musicgen-medium's MHA of 24 heads at hd 64,
     B 1, 8 and 32), at long context (B 2, 512-page tables) and
     with more splits than live tiles, and on the cases of
     tests/test_kernels.py, garbage pages included;
  4. attention kernel time beside its bound, the plain version's time and
     ``scaled_dot_product_attention``'s (a yardstick the port never calls):
     decode at the serve's B 8, at B 32 and at long context (B 2, contexts
     8192 and 5000), split-K also at 1, 2, 4 and 8 splits; and the prefill
     tile height not taken; decode at B 8 and prefill also at codeqwen's
     and musicgen-medium's MHA shapes;
  5. serve full-width qwen3-4b (36 layers, bf16, seeded random weights)
     through ``EchoEngine``: online and offline requests must all finish,
     through the kernels only; then the same mix with ``attn_impl="pallas"``,
     whose decode goes through the legacy kernel only; a profile of a
     decode step and a prefill chunk of the first (one split-K cluster
     launch a layer and no merge kernel in the decode step, one prefill
     launch a layer in the chunk), and of a decode step of the second;
  6. token parity of a tiny float32 attention model between the CPU (plain
     versions) and the card (kernels), and again on the card with host-tier
     swap; and CPU against card with the legacy decode schedule;
  7. the SSD chunk-scan kernel against its plain chunked version in float32:
     the cases of tests/test_kernels.py and mamba2-1.3b's shape (B 1, H 64,
     P 64, N 128, chunk 64, S 64 / 128 / 512), each from a zero and a random
     initial state, with normal and slow decay; y, the final state and every
     chunk's state;
  8. SSD kernel time at the serve's span shape beside its float32 bound, its
     3xTF32 tensor-core bound and the plain version's time (no single
     PyTorch call computes the scan);
  9. serve full-width mamba2-1.3b (48 layers, bf16, seeded random weights)
     through ``EchoEngine`` and the state-snapshot runner: every request
     finishes, every span's 48 SSD scans go through the kernel, snapshot
     prefix reuse happens on the card; then a profile of one span and one
     decode step;
 10. token parity of a tiny float32 mamba2 between the CPU, the card, and the
     card with host-tier swap of state snapshots;
 11. the RG-LRU scan kernel against its plain version: the cases of
     tests/test_kernels.py in float32, and the hybrid path's shapes (B 1
     and 4, W 4096, S 1 / 37 / 128 / 2085 / 3072, a from the model's gate) from
     float32 and bfloat16 inputs; S one step either side of a slab (127,
     129, 255, 257), S 8192 (round the ring many times), ragged channel
     tiles (W 4104, 4112) and a view that starts one element into its
     buffer;
 12. RG-LRU kernel time at B 1, W 4096, S 128 and 3072 beside its bound, the
     floor (an empty launch of the same grid and shared memory), a + b
     into h (the same bytes through one PyTorch elementwise kernel), its
     PR 15 time and the plain version's (no single PyTorch call computes
     it), with the rate it reaches;
 13. serve full-width recurrentgemma-9b (38 layers, bf16, seeded random
     weights) through ``EchoEngine`` and the state-snapshot runner, token by
     token as the JAX runner does: every request finishes, snapshot prefix
     reuse happens on the card;
 14. its dense path at full width in bf16: ``Model.prefill`` (26 RG-LRU
     kernel launches a call) of the serve's prompt and of 3072 tokens (the
     blockwise attention branch), ``pad_cache`` onto the window ring and
     decode steps; held against the prompt stepped token by token and
     against a float32 copy of the model (in float32 to 1e-4; in bf16 to
     limits set from the rounding both paths show); then a profile of the
     S 128 and S 3072 prefills (26 RG-LRU kernel launches each) and of
     engine decode steps, one of them storing a block-boundary snapshot;
 15. token parity of a tiny float32 hybrid (5 layers, window 8) between the
     CPU, the card, the card with host-tier swap, and the card's dense path;
 16. serve full-width qwen3-moe-30b-a3b (48 layers, 128 experts of d_ff 768,
     top-8, bf16, seeded random weights) through ``EchoEngine`` with phase
     5's mix and checks, on a card freed of every earlier phase; the peak
     memory of the init (the weights and one float32 temporary) and of the
     serve; a profile of a decode step and a prefill chunk, with the expert
     products' device time, and no copy of an expert weight;
 17. one full-width MoE layer of that model, upcast to float32, on the card
     against the CPU: a 64-token chunk group and a decode batch of 5 padded
     to 8 route to equal ``dispatch`` tensors, and the outputs agree to
     1e-4 (relative norm);
 18. token parity of a tiny float32 MoE (qwen3-moe reduced) between the CPU
     and the card, and between the two with host-tier swap, at capacity
     factors 8.0 and 0.5 (where routing drops tokens, so the swap run's
     other batches change its tokens);
 19. serve full-width yi-9b (48 layers, G 8) and codeqwen1.5-7b (32 layers,
     MHA) through ``EchoEngine`` with a smaller mix, the checks of phase 5,
     and a profile of a decode step and a prefill chunk of each;
 20. serve full-width musicgen-medium (48 layers, d 1536, 24 heads of hd 64,
     bf16, seeded random weights) through ``EchoEngine`` with phase 5's mix
     and checks, an ``EngineProbe`` and a ``Tracer`` attached: the probe
     saw every iteration, ``repro_torch.obs.check`` accepts the Prometheus
     text and the trace JSON, and the profiled decode step and prefill chunk
     launch one split-K or one prefill kernel a layer;
 21. its dense path with conditioning frames (``Model.prefill`` with
     ``mm_embeds``, ``pad_cache``, decode steps) in bf16 against a float32
     copy of the weights, and the frames' effect on the logits; then tiny
     float32 qwen2-vl-72b (M-RoPE) and llama4-scout-17b-a16e (top-1 with a
     shared expert, capacity factors 8.0 and 0.5): engine tokens on the CPU
     and the card, with and without host-tier swap, and the prefill with
     frames;
 22. two engines on musicgen's one copy of the weights, each with its own
     pool and host tier, as replicas under a ``cluster.Router``: a cached
     document's pages migrate from replica 0 to replica 1, whose greedy
     tokens equal replica 0's, and a request evacuated from replica 0
     mid-decode finishes on replica 1 with no block leaked.

A profile's figures come from a trace that holds the device record of every
launch, copy and memset of the step: the profiler at times drops the first
device records of a trace, so 1024 small launches open each trace ahead of
the step, and a trace that still lacks some of the step's is taken again,
at most three times in all (``tools/profile_drops.py`` measures how often).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cluster import Replica, Router  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import ECHO, SLO, EchoEngine, Request, TaskType, TimeModel  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import chunked_prefill as cp_mod  # noqa: E402
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    default_num_splits, paged_attention, paged_attention_splitk)
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.state_cache import StateRunner  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer, instrument_engine  # noqa: E402
from repro_torch.obs.check import check_prometheus, check_trace  # noqa: E402
from repro_torch.params import tree_leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {"decode": {torch.bfloat16: 2e-2, torch.float32: 2e-4},
       "prefill": {torch.bfloat16: 3e-2, torch.float32: 2e-4}}
# and per case ||kernel - plain|| / ||plain||: an error of a few percent
# spread over every element (a dropped page at long context) stays under
# the elementwise tolerance, not under this one
REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# main-path shapes: qwen3-4b through the engine's paged runner
HQ, HKV, HD, BS, MAX_PAGES, CHUNK, NUM_BLOCKS = 32, 8, 128, 16, 32, 64, 2048
# the kv-head counts of the other paged serves at Hq 32, hd 128:
# codeqwen1.5-7b's MHA (G 1), and yi-9b's and qwen3-moe-30b-a3b's G 8
CQ_HKV, G8_HKV = 32, 4
# musicgen-medium's heads: MHA, 24 of hd 64 (a head count off a power of two)
MG_H, MG_HD = 24, 64
# its dense path: a prompt of S tokens whose first frames are conditioning
# embeddings, then decode steps; bf16 against a float32 copy of the weights
# must stay within DENSE_REL_LIMIT (relative norm of the logits)
MM_S, MM_FRAMES, MM_STEPS, DENSE_REL_LIMIT = 128, 32, 8, 0.1
# the two replicas of phase 22: device pool and host tier, in blocks, each
REP_BLOCKS = 256
# the serves' request mixes: (prompt length, arrival s) of the online
# requests, then offline documents x questions of doc + q tokens
SERVE_MIX = dict(online=((40, 0.0), (96, 0.05), (150, 0.1), (200, 0.2)),
                 docs=2, questions=3, doc=160, q=24, new=16)
SMALL_MIX = dict(online=((40, 0.0), (96, 0.05)), docs=1, questions=2, doc=160,
                 q=24, new=8)
# mamba2-1.3b through the state runner: one block per SSD chunk, engine
# chunks of two blocks; the snapshot pool holds at most one 97.6 MiB host
# snapshot per block
M_BLOCK, M_CHUNK, M_BLOCKS = 64, 128, 64
SSD_H, SSD_P, SSD_N = 64, 64, 128
# recurrentgemma-9b through the state runner (token by token; one 25.2 MiB
# host snapshot per block) and its dense path; W is the LRU width
R_BLOCK, R_CHUNK, R_BLOCKS, R_LAYERS_RGLRU, W = 32, 64, 64, 26, 4096
DEV = "cuda"
# the kernels redesigned for Hopper, by their names in ptxas' output and in
# profiler traces
PREFILL_TC, LEGACY_DECODE = "chunked_prefill_tc_kernel", "paged_warp_split_kernel"
SPLITK_DECODE, SSD_KERNEL = "splitk_cluster_kernel", "ssd_scan_tc_kernel"
RGLRU_KERNEL = "rglru_ring_kernel"
# profiles: the runtime calls that each leave one record on the device;
# the small launches that open a trace, ahead of the step (the profiler at
# times drops the first device records of a trace); the range that marks
# the step; and the traces a profile may take before one holds every
# device record of its step
DEVICE_CALLS = ("LaunchKernel", "MemcpyAsync", "MemsetAsync")
PRIMER_LAUNCHES = 1024
STEP_MARK = "chip_smoke step"
TRACE_ATTEMPTS = 3
# the RG-LRU kernel's phase 12 times before its redesign (PR 15's runs on
# an NVIDIA H100 80GB HBM3 at 700 W, PERF.md), by S
RGLRU_PR15_MS = {128: 0.0192, 3072: 0.0949}
# the long-context decode shape split-K's clusters exist for: B 2 at
# contexts 8192 and 5000 over 512-page tables (54.0 MB of K/V)
LONG_CTX, LONG_NBLK = [8192, 5000], 512
# the prefill tile height not taken by default, timed beside the default
ALT_TILE_ROWS = next(r for r in cp_mod.TILE_ROWS if r != cp_mod.DEFAULT_TILE_ROWS)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, iters=30, warmup=3):
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch, with L2 flushed before each one (a 256 MB write):
    the serving path finds its KV and weights cold, 36 layers apart. A
    device-side spin of about 0.2 ms after the flush keeps the host ahead
    of the card, so the wrapper's own host work before its launch never
    lands between the two events; the median drops the odd launch where a
    host stall outlasted the spin (one such stall put a 0.02 ms kernel's
    mean at 0.55 ms)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        torch.cuda._sleep(400_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ inputs
def decode_inputs(gen, b, hq, hkv, hd, bs, nblk, ctx, dtype, num_pages):
    q = torch.randn((b, hq, hd), generator=gen, device=DEV).to(dtype)
    kp = torch.randn((num_pages, bs, hkv, hd), generator=gen, device=DEV).to(dtype)
    vp = torch.randn((num_pages, bs, hkv, hd), generator=gen, device=DEV).to(dtype)
    bt = torch.stack([torch.randperm(num_pages, generator=gen, device=DEV)[:nblk]
                      for _ in range(b)]).to(torch.int32)
    cl = torch.tensor(ctx, dtype=torch.int32, device=DEV)
    return q, kp, vp, bt, cl


def prefill_inputs(gen, sc, t, hq, hkv, hd, dtype):
    q = torch.randn((sc, hq, hd), generator=gen, device=DEV).to(dtype)
    k = torch.randn((t, hkv, hd), generator=gen, device=DEV).to(dtype)
    v = torch.randn((t, hkv, hd), generator=gen, device=DEV).to(dtype)
    return q, k, v


def compare(name, got, want, tol, live=None):
    rel_tol = REL_TOL[got.dtype]
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    if live is not None:
        got, want = got[live], want[live]
    err = float((got - want).abs().max())
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want).clamp_min(1e-30))
    ok = bool(torch.allclose(got, want, rtol=tol, atol=tol)) and rel < rel_tol
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:g} rel_err={rel:.3e} "
          f"rel_tol={rel_tol:g} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phases
def phase_device():
    phase("1 device")
    check(torch.cuda.is_available(), "no CUDA device (torch.cuda.is_available() is False)")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind, count


def phase_build():
    phase("2 build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
          + ", ".join(f"{n} {s:.1f} s" for n, s in build.build_seconds.items()))
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print(f"  {name}: {line.strip()}")
    # the redesigned kernels must not spill (ptxas' report exists only for
    # a library built in this run)
    for lib, kern in (("chunked_prefill", PREFILL_TC), ("paged_attention", LEGACY_DECODE),
                      ("paged_attention_splitk", SPLITK_DECODE), ("ssd_scan", SSD_KERNEL),
                      ("rglru_scan", RGLRU_KERNEL)):
        entry, found = "", []
        for line in build.build_log[lib].splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "spill stores" in line and kern in entry:
                found.append(line.strip())
        if build.build_log[lib]:
            spilled = [x for x in found if " 0 bytes spill stores, 0 bytes spill loads" not in x]
            print(f"  {kern}: {len(found)} instantiations, {len(spilled)} spilling")
            check(found and not spilled, f"{kern}: no ptxas report, or spills: {spilled}")
        else:
            print(f"  {kern}: spill check skipped (library from the build cache)")


def phase_kernels(gen):
    phase("3 kernels vs plain versions")
    errs = {"paged_attention_splitk": 0.0, "paged_attention": 0.0,
            "chunked_prefill_attention": 0.0}
    # main-path decode: ragged contexts up to the table with one full row,
    # then the serve's own shape (contexts near 100); one padded row each
    # then the long-context shape (a full cluster of splits, a padded row)
    # and two live tiles under 8 splits
    shapes = [(b, lo, hi, MAX_PAGES, None, HQ, HKV, HD) for b, lo, hi in (
        (1, 1, MAX_PAGES * BS), (8, 1, MAX_PAGES * BS), (32, 1, MAX_PAGES * BS),
        (8, 80, 120))]
    shapes += [(2, LONG_CTX[0], LONG_CTX[0], LONG_NBLK, None, HQ, HKV, HD),
               (1, 20, 20, MAX_PAGES, 8, HQ, HKV, HD)]
    # the other serves' head shapes, at a full table and at their contexts
    shapes += [(8, lo, hi, MAX_PAGES, None, HQ, hkv, HD) for hkv in (CQ_HKV, G8_HKV)
               for lo, hi in ((1, MAX_PAGES * BS), (80, 120))]
    # musicgen-medium's (hd 64, 24 heads, G 1) at B 1, 8 and 32 up to the
    # table and at the serve's contexts
    shapes += [(b, lo, hi, MAX_PAGES, None, MG_H, MG_H, MG_HD) for b, lo, hi in (
        (1, 1, MAX_PAGES * BS), (8, 1, MAX_PAGES * BS), (32, 1, MAX_PAGES * BS),
        (8, 80, 120))]
    for b, lo, hi, nblk, splits, hq, hkv, hd in shapes:
        ctx = torch.randint(lo, hi + 1, (b,), generator=gen, device=DEV).tolist()
        if hi == nblk * BS:
            ctx[0] = hi
        if b > 1:
            ctx[-1] = 0
        ins = decode_inputs(gen, b, hq, hkv, hd, BS, nblk, ctx, torch.bfloat16,
                            NUM_BLOCKS)
        live = ins[4] > 0
        want = ref.ref_paged_attention(*ins)
        for name, fn in (("paged_attention_splitk",
                          lambda *a: paged_attention_splitk(*a, num_splits=splits)),
                         ("paged_attention", paged_attention)):
            got = fn(*ins)
            check(bool((got[~live] == 0).all()), f"{name}: a ctx=0 row is not zero")
            e = compare(f"{name} bf16 B={b} Hq={hq} Hkv={hkv} hd={hd} nblk={nblk} "
                        f"ctx {lo}..{hi}"
                        + (f" splits={splits}" if splits and fn is not paged_attention
                           else ""), got, want, TOL["decode"][torch.bfloat16], live)
            errs[name] = max(errs[name], e)
    for hq, hkv, hd in ((HQ, HKV, HD), (HQ, CQ_HKV, HD), (HQ, G8_HKV, HD),
                        (MG_H, MG_H, MG_HD)):
        for ctx in (0, 37, 448):
            ins = prefill_inputs(gen, CHUNK, MAX_PAGES * BS, hq, hkv, hd, torch.bfloat16)
            want = ref.ref_chunked_prefill_attention(*ins, ctx)
            what = f"prefill bf16 Sc=64 T=512 Hq={hq} Hkv={hkv} hd={hd} ctx={ctx}"
            e = compare(what, chunked_prefill_attention(*ins, ctx), want,
                        TOL["prefill"][torch.bfloat16])
            errs["chunked_prefill_attention"] = max(errs["chunked_prefill_attention"], e)
            compare(f"{what} {ALT_TILE_ROWS}-row tiles",
                    chunked_prefill_attention(*ins, ctx, tile_rows=ALT_TILE_ROWS), want,
                    TOL["prefill"][torch.bfloat16])
    # the cases of tests/test_kernels.py, both dtypes
    decode_cases = [(2, 4, 4, 32, 8, 4, [32, 17]), (3, 8, 2, 64, 16, 6, [96, 5, 48]),
                    (2, 8, 1, 32, 8, 5, [40, 3]), (4, 4, 1, 16, 4, 3, [12, 1, 7, 9])]
    chunked_cases = [(64, 128, 4, 2, 32, 0), (64, 128, 4, 2, 32, 37),
                     (32, 64, 2, 1, 64, 30), (100, 420, 4, 1, 32, 250),
                     (65, 131, 8, 2, 32, 66), (7, 16, 4, 4, 16, 9),
                     (64, 192, 8, 8, 32, 128)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, hkv, hd, bs, nblk, ctx in decode_cases:
            ins = decode_inputs(gen, b, hq, hkv, hd, bs, nblk, ctx, dtype, nblk * b + 2)
            want = ref.ref_paged_attention(*ins)
            for splits in (1, 2, 4, 8, None):
                compare(f"decode {str(dtype)[6:]} b={b} hq={hq} hkv={hkv} hd={hd} "
                        f"bs={bs} splits={splits}",
                        paged_attention_splitk(*ins, num_splits=splits), want,
                        TOL["decode"][dtype])
            e = compare(f"legacy decode {str(dtype)[6:]} b={b} hq={hq} hkv={hkv} "
                        f"hd={hd} bs={bs}", paged_attention(*ins), want,
                        TOL["decode"][dtype])
            errs["paged_attention"] = max(errs["paged_attention"], e)
        for sc, t, hq, hkv, hd, ctx in chunked_cases:
            ins = prefill_inputs(gen, sc, t, hq, hkv, hd, dtype)
            compare(f"prefill {str(dtype)[6:]} sc={sc} t={t} hq={hq} hkv={hkv} "
                    f"hd={hd} ctx={ctx}", chunked_prefill_attention(*ins, ctx),
                    ref.ref_chunked_prefill_attention(*ins, ctx), TOL["prefill"][dtype])
    _garbage_pages(gen)
    torch.cuda.synchronize()
    return errs


def _garbage_pages(gen):
    """tests/test_kernels.py's garbage-pages case, on both decode kernels:
    pages the table does not reference, and for the legacy kernel a table
    entry past the context pointing far outside the pool, change nothing."""
    b, hq, hkv, hd, bs, p = 1, 2, 1, 16, 8, 6
    q = torch.randn((b, hq, hd), generator=gen, device=DEV)
    kp = torch.randn((p, bs, hkv, hd), generator=gen, device=DEV)
    vp = torch.randn((p, bs, hkv, hd), generator=gen, device=DEV)
    bt = torch.tensor([[1, 3]], dtype=torch.int32, device=DEV)
    cl = torch.tensor([12], dtype=torch.int32, device=DEV)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0], kp2[2], vp2[4] = 999.0, -999.0, 123.0
    far = torch.tensor([[1, 3, 1 << 30]], dtype=torch.int32, device=DEV)
    for name, fn in (("paged_attention_splitk", paged_attention_splitk),
                     ("paged_attention", paged_attention)):
        out1, out2 = fn(q, kp, vp, bt, cl), fn(q, kp2, vp2, bt, cl)
        same = bool(torch.equal(out1, out2))
        if fn is paged_attention:
            same &= bool(torch.equal(out1, fn(q, kp, vp, far, cl)))
        print(f"  {name} garbage pages: output unchanged {same}")
        check(same, f"{name}: unreferenced pages reached the output")
        compare(f"{name} garbage-pages case", out1,
                ref.ref_paged_attention(q, kp, vp, bt, cl), TOL["decode"][torch.float32])


def _sdpa_decode(q, kp, vp, bt, cl):
    """Dense inputs for one ``scaled_dot_product_attention`` call computing
    the same decode (gathered outside the timed call)."""
    b, hq, hd = q.shape
    p, bs, hkv, _ = kp.shape
    idx = (bt.long()[:, :, None] * bs + torch.arange(bs, device=DEV)).reshape(b, -1)
    k = kp.reshape(p * bs, hkv, hd)[idx].transpose(1, 2)         # (B,Hkv,T,hd)
    v = vp.reshape(p * bs, hkv, hd)[idx].transpose(1, 2)
    mask = (torch.arange(idx.shape[1], device=DEV)[None] < cl.long()[:, None])
    return q[:, :, None], k, v, mask[:, None, None]


def _decode_rows(gen, errs, b, ctx, nblk=MAX_PAGES, hkv=HKV, hq=HQ, hd=HD):
    """Time one decode launch at batch ``b`` with contexts ``ctx`` over
    tables of ``nblk`` pages (by default the main path's width), ``hq``
    query and ``hkv`` kv heads of ``hd``: split-K (its default split count,
    then 1, 2, 4 and 8 splits a row) and the legacy kernel, beside one
    bound and one SDPA time."""
    ins = decode_inputs(gen, b, hq, hkv, hd, BS, nblk, ctx, torch.bfloat16,
                        NUM_BLOCKS)
    item = 2
    live_pages = sum(-(-c // BS) for c in ctx)
    nbytes = (2 * b * hq * hd * item + sum(ctx) * hkv * hd * 2 * item
              + live_pages * 4 + b * 4)
    flops = 4 * sum(ctx) * hq * hd
    sq, sk, sv, smask = _sdpa_decode(*ins)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = (f"B={b} Hq={hq} Hkv={hkv} hd={hd} bs={BS} nblk={nblk} "
             f"sum(ctx)={sum(ctx)} bf16, default splits "
             f"{default_num_splits(b, hkv, nblk, BS, sms)}")
    splits_ms = {n: time_ms(lambda: paged_attention_splitk(*ins, num_splits=n))
                 for n in (1, 2, 4, 8)}
    common = dict(
        route="cuda", shape=shape,
        plain_ms=time_ms(lambda: ref.ref_paged_attention(*ins)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=smask, enable_gqa=True)),
        bound=bound(nbytes, flops, torch.bfloat16))
    return [dict(common, name="paged_attention_splitk",
                 source="src/repro_torch/kernels/csrc/paged_attention_splitk.cu",
                 replaces="src/repro/kernels/paged_attention.py:164",
                 ms=time_ms(lambda: paged_attention_splitk(*ins)),
                 one_split_ms=splits_ms[1], splits_ms=splits_ms,
                 max_abs_err=errs["paged_attention_splitk"]),
            dict(common, name="paged_attention",
                 source="src/repro_torch/kernels/csrc/paged_attention.cu",
                 replaces="src/repro/kernels/paged_attention.py:78",
                 ms=time_ms(lambda: paged_attention(*ins)),
                 max_abs_err=errs["paged_attention"])]


def _prefill_row(gen, errs, hkv, hq=HQ, hd=HD):
    """Time one engine chunk against the longest prefix of the table, with
    ``hq`` query and ``hkv`` kv heads of ``hd``, beside the other tile
    height, one bound and SDPA."""
    item = 2
    sc, t, c = CHUNK, MAX_PAGES * BS, 448
    ins = prefill_inputs(gen, sc, t, hq, hkv, hd, torch.bfloat16)
    keys = min(t, c + sc)
    nbytes = 2 * sc * hq * hd * item + keys * hkv * hd * 2 * item
    flops = 4 * hd * hq * sum(min(t, c + i + 1) for i in range(sc))
    mask = (torch.arange(t, device=DEV)[None] <= c + torch.arange(sc, device=DEV)[:, None])
    pq, pk, pv = (x.transpose(0, 1)[None] for x in ins)
    return dict(
        name="chunked_prefill_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/chunked_prefill.cu",
        replaces="src/repro/kernels/chunked_prefill.py:94",
        shape=f"Sc={sc} T={t} ctx={c} Hq={hq} Hkv={hkv} hd={hd} bf16",
        ms=time_ms(lambda: chunked_prefill_attention(*ins, c)),
        other=(f"{ALT_TILE_ROWS}-row tiles",
               time_ms(lambda: chunked_prefill_attention(*ins, c, tile_rows=ALT_TILE_ROWS))),
        plain_ms=time_ms(lambda: ref.ref_chunked_prefill_attention(*ins, c)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            pq, pk, pv, attn_mask=mask, enable_gqa=True)),
        bound=bound(nbytes, flops, torch.bfloat16),
        max_abs_err=errs["chunked_prefill_attention"])


def phase_timing(gen, errs):
    """Rows of kernel times; the first row of each kernel is the shape the
    serve of phase 5 gives it and goes into the JSON line."""
    phase("4 kernel time")
    # decode as the serve runs it (batch 8, contexts near 100), then a
    # full batch of 32 with ragged contexts up to the table, long context,
    # and batch 8 at codeqwen's MHA shape and at musicgen-medium's
    def serve_ctx():
        return torch.randint(80, 121, (8,), generator=gen, device=DEV).tolist()
    rows = (_decode_rows(gen, errs, 8, serve_ctx())
            + _decode_rows(gen, errs, 32, torch.randint(
                1, MAX_PAGES * BS + 1, (32,), generator=gen, device=DEV).tolist())
            + _decode_rows(gen, errs, 2, LONG_CTX, LONG_NBLK)
            + _decode_rows(gen, errs, 8, serve_ctx(), hkv=CQ_HKV)
            + _decode_rows(gen, errs, 8, serve_ctx(), hkv=MG_H, hq=MG_H, hd=MG_HD))
    # prefill at qwen3-4b's shape, then at codeqwen's MHA shape and at
    # musicgen-medium's
    rows += [_prefill_row(gen, errs, HKV), _prefill_row(gen, errs, CQ_HKV),
             _prefill_row(gen, errs, MG_H, hq=MG_H, hd=MG_HD)]
    for r in rows:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms"
              + (", splits " + ", ".join(f"{n}: {t:.4f}" for n, t in r["splits_ms"].items())
                 + " ms" if "splits_ms" in r else "")
              + (f", {r['other'][0]} {r['other'][1]:.4f} ms" if "other" in r else ""))
    return rows


def _trace(fn, primer=PRIMER_LAUNCHES, record_shapes=False):
    """One ``torch.profiler`` trace: ``primer`` small launches and a
    synchronize, then ``fn`` and a synchronize inside a ``STEP_MARK``
    range. Kineto drops a device record whose start, mapped to the host
    clock, falls before the traced window; on the card the first records
    of a trace are at times mapped seconds before their own launch (more
    of them the longer the process has run), and the trace lacks them. The
    primer takes those losses in place of the step. Returns the profile,
    the correlation ids of the launches, copies and memsets the runtime
    recorded inside the range, and how many device records the trace lacks
    of those and of the primer's."""
    from torch.profiler import ProfilerActivity, profile, record_function
    buf = torch.zeros(1, device=DEV)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        for _ in range(primer):
            buf.add_(1)
        torch.cuda.synchronize()
        with record_function(STEP_MARK):
            fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    mark = next(e for e in events if e.name() == STEP_MARK and e.device_type() == cpu)
    step, primed = set(), set()
    for e in events:
        if e.device_type() == cpu and any(c in e.name() for c in DEVICE_CALLS):
            inside = mark.start_ns() <= e.start_ns() <= mark.end_ns()
            (step if inside else primed).add(e.correlation_id())
    on_device = {e.correlation_id() for e in events
                 if e.device_type() == torch.autograd.DeviceType.CUDA}
    check(step and len(primed) == primer,
          f"the trace holds {len(step)} calls of the step and {len(primed)} of the "
          f"primer's {primer}")
    return prof, step, len(step - on_device), len(primed - on_device)


def _profile_steps(steps, ours, what, ops=None):
    """Where a step's time goes: for each of ``steps`` (name -> call), the
    wall time (mean of 5, no profiler), and from one ``_trace`` that holds
    the device record of every launch, copy and memset of the step (taken
    again, at most ``TRACE_ATTEMPTS`` times in all, while one lacks some)
    the step's device time summed over kernels and copies, their number,
    and the ones that took longest; then the share of our kernels (names
    containing one of ``ours``). ``ops`` ({label: predicate(op name, input
    shapes)}) also sums, by label, the host operators that match (traced
    with their shapes) and the device time of the kernels they launched.
    Returns {step: {device kernel or copy name: (ms, launches)}}, where
    ``ops`` adds {("op", label): (ms, operator calls)}."""
    traces = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            prof, step, dropped, primer_dropped = _trace(fn, record_shapes=ops is not None)
            if not dropped:
                break
            print(f"  profile {name}: trace {attempt} lacks the device records of "
                  f"{dropped} of the step's {len(step)} calls, tracing again")
        check(not dropped, f"profile {name}: each of {TRACE_ATTEMPTS} traces lacks "
              f"device records of the step")
        # the step's device-side events only (kernels and copies): the
        # CPU-side op rows of key_averages() carry the same device time again
        events = prof.events()
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.id in step]
        mark = next(e.time_range for e in events if e.name == STEP_MARK
                    and e.device_type == torch.autograd.DeviceType.CPU)
        dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        by_name = {}
        for e in dev:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
        print(f"  profile {name}: wall {wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
              f"({dev_ms / wall_ms:.1%}), {len(dev)} device kernels and copies "
              f"(the trace lacks {primer_dropped} of the primer's {PRIMER_LAUNCHES})")
        for kname, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"    {t:8.3f} ms x{n:<4d} {kname[:90]}")
        mine = [(t, n) for kname, (t, n) in by_name.items()
                if any(o in kname for o in ours)]
        print(f"    {what} (ours): {sum(t for t, _ in mine):.3f} ms over "
              f"{sum(n for _, n in mine)} launches, "
              f"{sum(t for t, _ in mine) / max(dev_ms, 1e-9):.1%} of device busy")
        for label, pred in (ops or {}).items():
            hit = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and mark.start <= e.time_range.start <= mark.end
                   and pred(e.name, e.input_shapes)]
            t = sum(k.duration for e in hit for k in e.kernels) / 1e3
            by_name[("op", label)] = (t, len(hit))
            print(f"    {label}: {len(hit)} operator calls, {t:.3f} ms of device "
                  f"time, {t / max(dev_ms, 1e-9):.1%} of device busy")
        traces[name] = by_name
    return traces


def _launches(by_name, names):
    """Launches in one step's trace of the kernels whose names contain one
    of ``names``."""
    return sum(n for kname, (_, n) in by_name.items() if any(o in kname for o in names))


def _attention_steps(runner):
    """One decode step (batch 8) and one prefill chunk of the paged runner."""
    tables = [list(range(i * 8, i * 8 + 8)) for i in range(8)]
    return {
        "decode B=8 ctx=101": lambda: runner.decode([1] * 8, tables, [100] * 8),
        "prefill Sc=64 ctx=128": lambda: runner.prefill_chunk(
            list(range(CHUNK)), 128, list(range(64, 76))),
    }


def _reset_counts():
    paged_attention_splitk.launches = 0
    paged_attention.launches = 0
    chunked_prefill_attention.launches = 0
    ref.ref_paged_attention.cuda_calls = 0
    ref.ref_chunked_prefill_attention.cuda_calls = 0


def phase_serve():
    phase("5 serve qwen3-4b at full width")
    cfg = get_config("qwen3-4b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    print(f"init: {cfg.num_layers} layers d={cfg.d_model} vocab={cfg.vocab_size} "
          f"{cfg.dtype}, {cfg.param_count / 1e9:.2f} B params in "
          f"{time.perf_counter() - t0:.1f} s")
    online, offline, eng, stats, wall = _serve_paged(model, params, "auto", SERVE_MIX)
    launches = {"paged_attention_splitk": paged_attention_splitk.launches,
                "chunked_prefill_attention": chunked_prefill_attention.launches}
    check(min(launches.values()) > 0, "a kernel of the path never launched")
    _print_serve(online, offline, stats, wall)
    attn = (SPLITK_DECODE, PREFILL_TC, LEGACY_DECODE, "merge")
    traces = _profile_steps(_attention_steps(eng.runner), attn[:2], "attention kernels")
    seen = {k: _launches(v, attn) for k, v in traces.items()}
    print(f"  attention launches per profiled step: {seen}")
    check(all(n == cfg.num_layers for n in seen.values()),
          f"a profiled step launched other than one attention kernel a layer: {seen}")
    decode_trace = traces["decode B=8 ctx=101"]
    check(_launches(decode_trace, (SPLITK_DECODE,)) == cfg.num_layers
          and not _launches(decode_trace, ("merge",)),
          "the split-K decode step is not one cluster launch a layer")
    del eng
    torch.cuda.empty_cache()

    # the same mix through the legacy decode kernel
    print("serve again with attn_impl='pallas' (legacy decode schedule)")
    on2, off2, eng, _, wall = _serve_paged(model, params, "pallas", SERVE_MIX)
    check(paged_attention_splitk.launches == 0,
          "the split-K kernel launched in the legacy-schedule serve")
    launches["paged_attention"] = paged_attention.launches
    pairs = [(a, b) for r1, r2 in zip(online + offline, on2 + off2)
             for a, b in zip(r1.output_tokens, r2.output_tokens)]
    print(f"  {wall:.3f} s wall; online TTFT s mean "
          f"{np.mean([r.ttft() for r in on2]):.4f}, TPOT s mean "
          f"{np.mean([r.tpot() for r in on2]):.4f}; output tokens equal to the "
          f"split-K serve's: {sum(a == b for a, b in pairs)} of {len(pairs)} "
          f"({sum(a == b for a, b in pairs) / len(pairs):.1%})")
    decode = {k: fn for k, fn in _attention_steps(eng.runner).items()
              if k.startswith("decode")}
    traces = _profile_steps(decode, (LEGACY_DECODE,), "legacy decode kernel")
    check(all(_launches(v, (LEGACY_DECODE,)) for v in traces.values()),
          f"the legacy decode step launched no {LEGACY_DECODE}")
    del eng, params
    torch.cuda.empty_cache()
    return launches


def _print_serve(online, offline, stats, wall):
    ttft = [r.ttft() for r in online]
    tpot = [r.tpot() for r in online]
    out_tokens = sum(r.n_output for r in online + offline)
    print(f"serve: {len(online)} online + {len(offline)} offline requests, "
          f"{len(stats.iterations)} iterations in {wall:.3f} s wall")
    print(f"  online TTFT s: mean {np.mean(ttft):.4f} max {np.max(ttft):.4f}; "
          f"TPOT s: mean {np.mean(tpot):.4f} max {np.max(tpot):.4f}")
    print(f"  output tokens {out_tokens}, {out_tokens / wall:.1f} tok/s; "
          f"offline throughput {stats.offline_throughput():.1f} tok/s (engine clock)")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _serve_paged(model, params, attn_impl, mix, attach=None):
    """``mix`` (``SERVE_MIX`` or ``SMALL_MIX``) through a paged engine with
    ``attn_impl``: every request finishes with its tokens inside the
    vocabulary, every decode step and prefill chunk launches its kernel
    once a layer, and no plain attention runs on the card. ``attach``, if
    given, is called with the engine before the requests go in. Returns
    (online, offline, engine, stats, wall seconds)."""
    cfg = model.cfg
    eng = EchoEngine(model, params, ECHO, num_blocks=NUM_BLOCKS, block_size=BS,
                     chunk_size=CHUNK, max_pages_per_seq=MAX_PAGES,
                     time_model=TimeModel.h100(), clock="wall", device=DEV,
                     attn_impl=attn_impl)
    # warm the libraries (cuBLAS handles, kernel modules) on free pages
    eng.runner.prefill_chunk(list(range(CHUNK)), 0, [0, 1, 2, 3])
    eng.runner.decode([1], [[0, 1, 2, 3, 4]], [CHUNK])
    torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size

    def toks(n):
        return tuple(int(x) for x in rng.integers(0, vocab, n))
    online = [Request(prompt=toks(n), max_new_tokens=mix["new"],
                      task_type=TaskType.ONLINE, arrival_time=at,
                      slo=SLO(ttft=2.0, tpot=0.5))
              for n, at in mix["online"]]
    offline = []
    for _ in range(mix["docs"]):
        doc = toks(mix["doc"])
        offline += [Request(prompt=doc + toks(mix["q"]), max_new_tokens=mix["new"],
                            task_type=TaskType.OFFLINE) for _ in range(mix["questions"])]
    if attach is not None:
        attach(eng)
    for r in online + offline:
        eng.submit(r)

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = eng.run(max_iters=5000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode = paged_attention if attn_impl == "pallas" else paged_attention_splitk
    launches = {"decode": decode.launches,
                "chunked_prefill_attention": chunked_prefill_attention.launches}
    plain_calls = (ref.ref_paged_attention.cuda_calls
                   + ref.ref_chunked_prefill_attention.cuda_calls)

    for r in online + offline:
        check(r.done and r.n_output == r.max_new_tokens,
              f"request {r.rid} finished {r.n_output}/{r.max_new_tokens} tokens")
        check(all(0 <= t < vocab for t in r.output_tokens), "token outside the vocabulary")
    n_chunks = sum(rec.n_prefill for rec in stats.iterations)
    n_decode_steps = sum(1 for rec in stats.iterations if rec.n_decode)
    print(f"launches {{{decode.__name__!r}: {launches['decode']}, "
          f"'chunked_prefill_attention': {launches['chunked_prefill_attention']}}}, "
          f"prefill chunks {n_chunks}, decode steps {n_decode_steps}, plain "
          f"attention calls on CUDA {plain_calls}")
    check(launches["chunked_prefill_attention"] == cfg.num_layers * n_chunks,
          "prefill kernel launches != layers x chunks")
    check(launches["decode"] == cfg.num_layers * n_decode_steps,
          "decode kernel launches != layers x decode steps")
    check(plain_calls == 0, "the plain attention ran on CUDA tensors in the serve")
    return online, offline, eng, stats, wall


def _tiny_engine_tokens(model, params, device, swap, attn_impl="auto"):
    kw = (dict(num_blocks=16, host_kv_blocks=32) if swap else dict(num_blocks=64))
    eng = EchoEngine(model, params, ECHO, block_size=8, chunk_size=16,
                     max_pages_per_seq=16, device=device, attn_impl=attn_impl, **kw)
    rng = np.random.default_rng(2)
    vocab = model.cfg.vocab_size
    off = Request(prompt=tuple(int(x) for x in rng.integers(0, vocab, 56)),
                  max_new_tokens=6, task_type=TaskType.OFFLINE)
    eng.submit(off)
    for _ in range(3):
        eng.step()
    on = Request(prompt=tuple(int(x) for x in rng.integers(0, vocab, 88)),
                 max_new_tokens=12, task_type=TaskType.ONLINE,
                 arrival_time=eng.now, slo=SLO(10, 10))
    eng.submit(on)
    others = [Request(prompt=tuple(int(x) for x in rng.integers(0, vocab, n)),
                      max_new_tokens=6, task_type=TaskType.OFFLINE,
                      arrival_time=eng.now) for n in (13, 25, 40)]
    for r in others:
        eng.submit(r)
    eng.run(max_iters=2000)
    reqs = [off, on] + others
    check(all(r.done for r in reqs), f"tiny engine on {device} left requests unfinished")
    return [r.output_tokens for r in reqs], eng


def phase_parity():
    phase("6 CPU vs CUDA token parity (tiny float32)")
    cfg = ModelConfig(name="tiny-dense", family="dense", source="test",
                      num_layers=2, d_model=64, vocab_size=128, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, dtype="float32",
                      rope_theta=10_000.0)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cuda_params = tree_map(lambda t: t.to(DEV), params)
    _reset_counts()
    cpu_tokens, _ = _tiny_engine_tokens(model, params, "cpu", swap=False)
    gpu_tokens, _ = _tiny_engine_tokens(model, cuda_params, DEV, swap=False)
    check(cpu_tokens == gpu_tokens, f"CPU {cpu_tokens} != CUDA {gpu_tokens}")
    swap_tokens, eng = _tiny_engine_tokens(model, cuda_params, DEV, swap=True)
    m = eng.bm.metrics
    print(f"  swap run: swapped out {m.swapped_out_tokens} / in "
          f"{m.swapped_in_tokens} tokens")
    check(m.swapped_out_tokens > 0 and m.swapped_in_tokens > 0,
          "the host tier never swapped")
    check(cpu_tokens == swap_tokens, f"CPU {cpu_tokens} != CUDA+swap {swap_tokens}")
    check(paged_attention_splitk.launches > 0 and chunked_prefill_attention.launches > 0,
          "the CUDA engine did not launch both kernels")
    print(f"  tokens equal on CPU, CUDA and CUDA+swap: {cpu_tokens}")
    splitk = paged_attention_splitk.launches
    cpu_legacy, _ = _tiny_engine_tokens(model, params, "cpu", swap=False,
                                        attn_impl="pallas")
    gpu_legacy, _ = _tiny_engine_tokens(model, cuda_params, DEV, swap=False,
                                        attn_impl="pallas")
    check(cpu_legacy == gpu_legacy, f"legacy schedule: CPU {cpu_legacy} != CUDA "
          f"{gpu_legacy}")
    check(paged_attention.launches > 0 and paged_attention_splitk.launches == splitk,
          "the legacy-schedule engine did not decode through the legacy kernel only")
    print(f"  legacy schedule: tokens equal on CPU and CUDA: {cpu_legacy}")


# ------------------------------------------------------------------ SSD scan
def ssd_inputs(gen, b, s, h, p, n, slow=False, with_init=False):
    """x, dt_a, B, C and an optional initial state, float32; ``slow`` makes
    dt_a about -0.01 softplus(.), so the carried and initial state dominate y."""
    x = torch.randn((b, s, h, p), generator=gen, device=DEV)
    dta = -(0.01 if slow else 1.0) * F.softplus(
        torch.randn((b, s, h), generator=gen, device=DEV))
    bm = torch.randn((b, s, n), generator=gen, device=DEV)
    cm = torch.randn((b, s, n), generator=gen, device=DEV)
    init = torch.randn((b, h, p, n), generator=gen, device=DEV) if with_init else None
    return x, dta, bm, cm, init


def phase_ssd_kernel(gen):
    phase("7 SSD kernel vs plain version (float32)")
    err = 0.0
    cases = [(2, 64, 2, 8, 4, 16), (1, 128, 4, 16, 8, 32), (3, 32, 1, 4, 16, 16)]
    cases += [(1, s, SSD_H, SSD_P, SSD_N, M_BLOCK) for s in (64, 128, 512)]
    # batch 2 over four chunks (the double buffer), and chunk 32 at mamba2's
    # widths with 8 heads (16-row slices: a cluster of 4 a head)
    cases += [(2, 256, SSD_H, SSD_P, SSD_N, M_BLOCK), (1, 96, 8, SSD_P, SSD_N, 32)]
    for b, s, h, p, n, chunk in cases:
        for with_init in (False, True):
            for slow in (False, True):
                x, dta, bm, cm, init = ssd_inputs(gen, b, s, h, p, n, slow, with_init)
                got = ssd_scan(x, dta, bm, cm, chunk=chunk, initial_state=init,
                               return_all_states=True)
                want = ssd_chunked(x, dta, bm, cm, chunk, initial_state=init,
                                   return_all_states=True)
                tag = (f"ssd b={b} s={s} h={h} p={p} n={n} chunk={chunk} "
                       f"{'init' if with_init else 'zero-init'}"
                       f"{' slow-decay' if slow else ''}")
                for what, g, w in zip(("y", "final", "states"), got, want):
                    check(g.shape == w.shape, f"{tag} {what}: shape {tuple(g.shape)}")
                    err = max(err, compare(f"{tag} {what}", g, w, 2e-4))
    torch.cuda.synchronize()
    return err


def phase_ssd_timing(gen, err):
    """The SSD scan as the serve's span runs it: one engine chunk of 128
    tokens, from a state, with every chunk's state captured."""
    phase("8 SSD kernel time")
    b, s, h, p, n, chunk = 1, M_CHUNK, SSD_H, SSD_P, SSD_N, M_BLOCK
    x, dta, bm, cm, init = ssd_inputs(gen, b, s, h, p, n, with_init=True)
    nc = s // chunk
    f32 = 4
    nbytes = f32 * (2 * b * s * h * p + b * s * h + 2 * b * s * n
                    + (2 + nc) * b * h * p * n)   # x, y, dt_a, B, C, init, final, states
    tri = chunk * (chunk + 1) // 2                 # causal (s, t) pairs of a chunk
    flops = 2 * b * nc * h * (tri * n + tri * p + 2 * chunk * n * p)
    t_bound, by = bound(nbytes, flops, torch.float32)
    # the products run on the tensor cores in 3xTF32: three TF32 products
    # each (495 TFLOP/s dense, NVIDIA data sheet)
    tc_bound = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                   (3 * flops / 495e12 * 1e3, "operations"))
    row = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:66",
        shape=f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} f32, initial state, "
              f"per-chunk states",
        ms=time_ms(lambda: ssd_scan(x, dta, bm, cm, chunk=chunk, initial_state=init,
                                    return_all_states=True)),
        plain_ms=time_ms(lambda: ssd_chunked(x, dta, bm, cm, chunk, initial_state=init,
                                             return_all_states=True)),
        library_ms=None, bound_ms=t_bound, bound_by=by, max_abs_err=err)
    print(f"  ssd_scan [{row['shape']}]: kernel {row['ms']:.4f} ms, bound "
          f"{t_bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP "
          f"in float32), tensor-core bound {tc_bound[0]:.4f} ms ({tc_bound[1]}: 3 x "
          f"{flops / 1e9:.3f} GFLOP at 495 TFLOP/s TF32), "
          f"plain {row['plain_ms']:.4f} ms, library none (no single PyTorch call "
          f"computes the SSD scan)")
    return row


def _reset_state_counts(runner=None):
    ssd_scan.launches = 0
    ssd_chunked.cuda_calls = 0
    ref.ref_ssd_sequential.cuda_calls = 0
    if runner is not None:
        runner.span_calls = 0


def phase_serve_mamba():
    phase("9 serve mamba2-1.3b at full width")
    cfg = get_config("mamba2-1.3b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    print(f"init: {cfg.num_layers} layers d={cfg.d_model} state N={cfg.ssm_state} "
          f"vocab={cfg.vocab_size} {cfg.dtype}, {cfg.param_count / 1e9:.3f} B params, "
          f"one state {model.cache_bytes(1, 1) / 2**20:.1f} MiB, in "
          f"{time.perf_counter() - t0:.1f} s")
    eng = EchoEngine(model, params, ECHO, num_blocks=M_BLOCKS, block_size=M_BLOCK,
                     chunk_size=M_CHUNK, max_pages_per_seq=16,
                     time_model=TimeModel.h100(), clock="wall", device=DEV)
    runner = eng.runner
    # warm the libraries on a spare block id (stale pool slots are harmless)
    runner.prefill_chunk(list(range(M_BLOCK)), 0, [M_BLOCKS - 1], rid=-1)
    runner.decode([1], [[M_BLOCKS - 1, M_BLOCKS - 2]], [M_BLOCK], rids=[-1])
    runner.release(-1)
    runner.pool.clear()
    torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size

    def toks(n):
        return tuple(int(x) for x in rng.integers(0, vocab, n))
    online = [Request(prompt=toks(n), max_new_tokens=16, task_type=TaskType.ONLINE,
                      arrival_time=at, slo=SLO(ttft=2.0, tpot=0.5))
              for n, at in ((64, 0.0), (128, 0.05), (200, 0.1), (256, 0.2))]
    offline = []
    for _ in range(2):
        doc = toks(192)
        offline += [Request(prompt=doc + toks(16), max_new_tokens=16,
                            task_type=TaskType.OFFLINE) for _ in range(3)]
    for r in online + offline:
        eng.submit(r)

    _reset_state_counts(runner)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = eng.run(max_iters=5000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ssd_scan.launches
    plain_calls = ssd_chunked.cuda_calls + ref.ref_ssd_sequential.cuda_calls
    spans = runner.span_calls

    for r in online + offline:
        check(r.done and r.n_output == r.max_new_tokens,
              f"request {r.rid} finished {r.n_output}/{r.max_new_tokens} tokens")
        check(all(0 <= t < vocab for t in r.output_tokens), "token outside the vocabulary")
    m = eng.bm.metrics
    print(f"ssd_scan launches {launches}, span calls {spans} (x {cfg.num_layers} layers "
          f"= {cfg.num_layers * spans}), plain SSD calls on CUDA {plain_calls}, "
          f"hit blocks {m.hit_blocks} of {m.lookup_blocks} looked up")
    check(launches == cfg.num_layers * spans, "ssd_scan launches != layers x span calls")
    check(launches > 0, "the SSD kernel never launched in the serve")
    check(plain_calls == 0, "the plain SSD scan ran on CUDA tensors in the serve")
    check(m.hit_blocks > 0, "no snapshot prefix reuse in the serve")

    ttft = [r.ttft() for r in online]
    tpot = [r.tpot() for r in online]
    out_tokens = sum(r.n_output for r in online + offline)
    pool_bytes = sum(t.numel() * t.element_size() for e in runner.pool.values()
                     for t in tree_leaves(e) if t.device.type == "cpu")
    print(f"serve: {len(online)} online + {len(offline)} offline requests, "
          f"{len(stats.iterations)} iterations in {wall:.3f} s wall")
    print(f"  online TTFT s: mean {np.mean(ttft):.4f} max {np.max(ttft):.4f}; "
          f"TPOT s: mean {np.mean(tpot):.4f} max {np.max(tpot):.4f}")
    print(f"  output tokens {out_tokens}, {out_tokens / wall:.1f} tok/s; "
          f"offline throughput {stats.offline_throughput():.1f} tok/s (engine clock)")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"snapshot pool {len(runner.pool)} snapshots, {pool_bytes / 2**30:.2f} GiB "
          f"on the host")
    spare = [M_BLOCKS - 3, M_BLOCKS - 2, M_BLOCKS - 1]
    span = f"span S={M_CHUNK} from zero state"
    traces = _profile_steps({
        span: lambda: runner.prefill_chunk(list(range(M_CHUNK)), 0, spare[:2], rid=-1),
        f"decode one request at pos {M_CHUNK}": lambda: runner.decode(
            [1], [spare], [M_CHUNK], rids=[-1]),
    }, (SSD_KERNEL,), "SSD kernel")
    check(_launches(traces[span], (SSD_KERNEL,)) == cfg.num_layers,
          f"the profiled span did not launch {SSD_KERNEL} once a layer")
    del eng, runner, params
    torch.cuda.empty_cache()
    return launches


def phase_parity_mamba():
    phase("10 CPU vs CUDA token parity (tiny float32 mamba2)")
    cfg = ModelConfig(name="tiny-mamba2", family="ssm", source="test",
                      num_layers=2, d_model=64, vocab_size=128, ssm_state=16,
                      ssm_head_dim=16, ssm_chunk=16, tie_embeddings=True,
                      dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cuda_params = tree_map(lambda t: t.to(DEV), params)
    bs = cfg.ssm_chunk

    def run(p, device, swap):
        """tests/test_state_tiering.py's workload on a tight pool."""
        eng = EchoEngine(model, p, ECHO, num_blocks=8, block_size=bs,
                         chunk_size=2 * bs, max_pages_per_seq=16, max_running=2,
                         host_kv_blocks=32 if swap else 0, device=device)
        rng = np.random.default_rng(3)

        def toks(n):
            return tuple(int(x) for x in rng.integers(0, cfg.vocab_size, n))
        doc = toks(3 * bs)
        reqs = [Request(prompt=doc + toks(7), max_new_tokens=4,
                        task_type=TaskType.OFFLINE) for _ in range(6)]
        reqs += [Request(prompt=toks(3 * bs), max_new_tokens=4,
                         task_type=TaskType.ONLINE, arrival_time=0.0004 * (i + 1),
                         slo=SLO(30.0, 5.0)) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_iters=2000)
        check(all(r.done for r in reqs), f"tiny mamba2 on {device} left requests unfinished")
        return [r.output_tokens for r in reqs], eng

    _reset_state_counts()
    cpu_tokens, _ = run(params, "cpu", swap=False)
    gpu_tokens, eng = run(cuda_params, DEV, swap=False)
    check(cpu_tokens == gpu_tokens, f"CPU {cpu_tokens} != CUDA {gpu_tokens}")
    check(ssd_scan.launches == cfg.num_layers * eng.runner.span_calls > 0,
          "the CUDA state engine did not run every span through the SSD kernel")
    check(ssd_chunked.cuda_calls == 0, "the plain SSD scan ran on CUDA tensors")
    swap_tokens, eng = run(cuda_params, DEV, swap=True)
    m = eng.bm.metrics
    print(f"  hit blocks {m.hit_blocks}; swap run: swapped out {m.swapped_out_tokens} "
          f"/ in {m.swapped_in_tokens} tokens ({m.swapped_out_bytes} / "
          f"{m.swapped_in_bytes} bytes)")
    check(m.swapped_out_tokens > 0 and m.swapped_in_tokens > 0,
          "the host tier never swapped a snapshot")
    check(cpu_tokens == swap_tokens, f"CPU {cpu_tokens} != CUDA+swap {swap_tokens}")
    print(f"  tokens equal on CPU, CUDA and CUDA+swap: {cpu_tokens}")


# ------------------------------------------------------------------ RG-LRU
def rglru_inputs(gen, b, s, w, dtype=torch.float32, gate=True):
    """a, b (B,S,W). ``gate``: a as the model's gate makes it,
    exp(-8 softplus(2) r) with r in (0, 1); else sigmoid of a normal draw
    (tests/test_kernels.py's)."""
    if gate:
        r = torch.rand((b, s, w), generator=gen, device=DEV)
        a = torch.exp(-8.0 * F.softplus(torch.tensor(2.0, device=DEV)) * r)
    else:
        a = torch.sigmoid(torch.randn((b, s, w), generator=gen, device=DEV))
    bb = torch.randn((b, s, w), generator=gen, device=DEV)
    return a.to(dtype), bb.to(dtype)


def phase_rglru_kernel(gen):
    phase("11 RG-LRU kernel vs plain version")
    err = 0.0
    # (b, s, w, gate, tol, offset): tests/test_kernels.py's sweep in
    # float32, then the hybrid path's shapes from both input types; S
    # covers one slab (128 steps in float32, 256 in bfloat16), one step
    # either side of a slab, ragged last slabs and many turns of the ring;
    # W 4104 and 4112 leave a ragged tile of 8 and 16 channels; offset 1
    # makes a and b views that start one element into their buffers
    cases = [(2, 64, 32, False, 2e-5, 0), (1, 128, 64, False, 2e-5, 0),
             (3, 32, 16, False, 2e-5, 0)]
    cases += [(b, s, W, True, 1e-4, 0) for b in (1, 4) for s in (1, 37, 128, 2085, 3072)]
    cases += [(1, s, W, True, 1e-4, 0) for s in (127, 129, 255, 257, 8192)]
    cases += [(1, 300, w, True, 1e-4, 0) for w in (4104, 4112)]
    cases += [(1, 128, W, True, 1e-4, 1)]
    for b, s, w, gate, tol, offset in cases:
        for dtype in ((torch.float32,) if not gate else (torch.float32, torch.bfloat16)):
            a, bb = rglru_inputs(gen, b, s, w, dtype, gate)
            if offset:
                a, bb = (torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(b, s, w)
                         for x in (a, bb))
                check(a.data_ptr() % 16 != 0, "the offset view is aligned")
            got = rglru_scan(a, bb)
            want = ref.ref_rglru_scan(a, bb)
            check(got.shape == want.shape and got.dtype == torch.float32,
                  f"rglru b={b} s={s} w={w}: shape {tuple(got.shape)} {got.dtype}")
            e = float((got - want).abs().max())
            rel = float(torch.linalg.vector_norm(got - want)
                        / torch.linalg.vector_norm(want))
            ok = bool(torch.allclose(got, want, rtol=tol, atol=tol)) and rel < 1e-5
            print(f"  rglru b={b} s={s} w={w}{' offset 1' if offset else ''} "
                  f"{str(dtype)[6:]} {'gate' if gate else 'sigmoid'}: max_abs_err={e:.3e} tol={tol:g} "
                  f"rel_err={rel:.3e} rel_tol=1e-05 {'ok' if ok else 'MISMATCH'}")
            check(ok, "the RG-LRU kernel disagrees with its plain version")
            err = max(err, e)
    torch.cuda.synchronize()
    return err


def phase_rglru_timing(gen, err):
    """The RG-LRU scan as ``Model.prefill`` runs it: float32 a and b from
    the gates, batch 1, the LRU width; a short and a long prompt. Beside
    the kernel: the floor (an empty kernel on the same grid, block and
    shared memory, under the same harness), a + b into h (the same bytes
    through one PyTorch elementwise kernel) and the kernel's PR 15 time
    (the builders' runs on this card type, ``PERF.md``)."""
    phase("12 RG-LRU kernel time")
    rows = []
    for s in (128, 3072):
        a, bb = rglru_inputs(gen, 1, s, W)
        nbytes = 3 * 4 * s * W                     # a, b in; h out; float32
        t_bound, by = bound(nbytes, 2 * s * W, torch.float32)
        plan = rglru_mod.rglru_plan(1, s, W, torch.float32)
        out = torch.empty_like(a)
        floor = time_ms(lambda: rglru_mod.empty_launch(1, W, plan, DEV))
        add_ms = time_ms(lambda: torch.add(a, bb, out=out))
        rows.append(dict(
            name="rglru_scan", route="cuda",
            source="src/repro_torch/kernels/csrc/rglru_scan.cu",
            replaces="src/repro/kernels/rglru_scan.py:41",
            shape=f"B=1 S={s} W={W} f32",
            ms=time_ms(lambda: rglru_scan(a, bb)),
            plain_ms=time_ms(lambda: ref.ref_rglru_scan(a, bb), iters=10, warmup=1),
            library_ms=None, bound_ms=t_bound, bound_by=by, max_abs_err=err))
        r = rows[-1]
        print(f"  rglru_scan [{r['shape']}] ({plan.slabs} slab(s) of {plan.rows} steps, "
              f"{plan.stages} stage(s), {plan.grid[0] * plan.grid[1]} CTAs): kernel "
              f"{r['ms']:.4f} ms ({nbytes / r['ms'] / 1e6:.0f} GB/s), bound {t_bound:.4f} "
              f"ms ({by}: {nbytes / 1e6:.2f} MB), floor {floor:.4f} ms, a + b into h "
              f"{add_ms:.4f} ms, PR 15 {RGLRU_PR15_MS[s]:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library none (no single PyTorch call "
              f"computes a linear recurrence)")
    return rows


def _reset_rglru_counts():
    rglru_scan.launches = 0
    ref.ref_rglru_scan.cuda_calls = 0


def phase_serve_hybrid():
    """Returns the model, its weights, the engine and the longer online
    prompt, which phase 14 runs through the dense path."""
    phase("13 serve recurrentgemma-9b at full width")
    cfg = get_config("recurrentgemma-9b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    print(f"init: {cfg.num_layers} layers ({R_LAYERS_RGLRU} rglru) d={cfg.d_model} "
          f"W={W} window={cfg.window} vocab={cfg.vocab_size} {cfg.dtype}, "
          f"{sum(t.numel() for t in tree_leaves(params)):,} params, one state "
          f"{model.cache_bytes(1, cfg.window):,} B, in {time.perf_counter() - t0:.1f} s")
    eng = EchoEngine(model, params, ECHO, num_blocks=R_BLOCKS, block_size=R_BLOCK,
                     chunk_size=R_CHUNK, max_pages_per_seq=16,
                     time_model=TimeModel.h100(), clock="wall", device=DEV)
    runner = eng.runner
    # warm the libraries on a spare block id (stale pool slots are harmless)
    runner.prefill_chunk([1, 2], 0, [R_BLOCKS - 1], rid=-1)
    runner.decode([3], [[R_BLOCKS - 1]], [2], rids=[-1])
    runner.release(-1)
    runner.pool.clear()
    torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size

    def toks(n):
        return tuple(int(x) for x in rng.integers(0, vocab, n))
    online = [Request(prompt=toks(n), max_new_tokens=8, task_type=TaskType.ONLINE,
                      arrival_time=at, slo=SLO(ttft=30.0, tpot=2.0))
              for n, at in ((64, 0.0), (96, 0.2))]
    offline = []
    for _ in range(2):
        doc = toks(64)
        offline += [Request(prompt=doc + toks(16), max_new_tokens=8,
                            task_type=TaskType.OFFLINE) for _ in range(2)]
    for r in online + offline:
        eng.submit(r)

    _reset_rglru_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = eng.run(max_iters=5000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in online + offline:
        check(r.done and r.n_output == r.max_new_tokens,
              f"request {r.rid} finished {r.n_output}/{r.max_new_tokens} tokens")
        check(all(0 <= t < vocab for t in r.output_tokens), "token outside the vocabulary")
    m = eng.bm.metrics
    prompt_tokens = sum(len(r.prompt) for r in online + offline)
    print(f"hit blocks {m.hit_blocks} of {m.lookup_blocks} looked up; "
          f"{prompt_tokens} prompt tokens; rglru launches {rglru_scan.launches} (the "
          f"engine steps every token through decode_step, as the JAX runner does); "
          f"plain RG-LRU calls on CUDA {ref.ref_rglru_scan.cuda_calls}")
    check(m.hit_blocks > 0, "no snapshot prefix reuse in the serve")
    check(ref.ref_rglru_scan.cuda_calls == 0, "the plain RG-LRU scan ran on CUDA")

    ttft = [r.ttft() for r in online]
    tpot = [r.tpot() for r in online]
    out_tokens = sum(r.n_output for r in online + offline)
    pool_bytes = sum(t.numel() * t.element_size() for e in runner.pool.values()
                     for t in tree_leaves(e) if t.device.type == "cpu")
    print(f"serve: {len(online)} online + {len(offline)} offline requests, "
          f"{len(stats.iterations)} iterations in {wall:.3f} s wall")
    print(f"  online TTFT s: mean {np.mean(ttft):.4f} max {np.max(ttft):.4f}; "
          f"TPOT s: mean {np.mean(tpot):.4f} max {np.max(tpot):.4f}")
    print(f"  output tokens {out_tokens}, {out_tokens / wall:.2f} tok/s")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"snapshot pool {len(runner.pool)} snapshots, {pool_bytes:,} B "
          f"({pool_bytes / 2**30:.2f} GiB) on the host")
    return model, params, eng, online[1].prompt


def _both_paths(model, params, prompt):
    """Last-position logits of ``prompt`` from ``Model.prefill`` (checked to
    launch the RG-LRU kernel once a layer) and from a fresh state runner
    stepping it token by token through ``decode_step``, float32."""
    before = rglru_scan.launches
    last, _ = model.prefill(params, torch.tensor([prompt], device=DEV))
    n = rglru_scan.launches - before
    check(n == R_LAYERS_RGLRU, f"Model.prefill launched the RG-LRU kernel {n} times")
    runner = StateRunner(model, params, R_BLOCKS, R_BLOCK, 16, R_CHUNK, device=DEV)
    nb = -(-len(prompt) // R_BLOCK)
    step = runner.prefill_chunk(list(prompt), 0, list(range(nb)), rid=0)
    return last[0].float(), torch.from_numpy(step).to(DEV)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase_dense_hybrid(model, params, eng, prompt):
    """Returns the RG-LRU launches of the main path's bf16 ``Model.prefill``
    calls; the float32 copy that checks them runs after the count is read."""
    phase("14 dense path of recurrentgemma-9b at full width")
    cfg = model.cfg
    s = 3072
    toks = torch.randint(0, cfg.vocab_size, (1, s),
                         generator=torch.Generator(device=DEV).manual_seed(1),
                         device=DEV)
    _reset_rglru_counts()
    with torch.inference_mode():
        # the main path in bf16: the serve's prompt both ways, a prompt
        # that takes the blockwise attention branch, pad_cache, decode
        pre16, step16 = _both_paths(model, params, prompt)
        before = rglru_scan.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        long16, cache = model.prefill(params, toks)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        n = rglru_scan.launches - before
        print(f"  prefill S={s} (blockwise attention, window {cfg.window}): "
              f"{t_prefill * 1e3:.1f} ms wall, {n} RG-LRU launches, logits finite "
              f"{bool(torch.isfinite(long16).all())}")
        check(n == R_LAYERS_RGLRU, f"Model.prefill S={s} made {n} RG-LRU launches")
        check(bool(torch.isfinite(long16).all()), "non-finite prefill logits")
        cache = model.pad_cache(cache, s, s + 9)
        ring = tree_leaves(cache[0][2])[0]
        check(ring.shape[2] == cfg.window, f"ring of {ring.shape[2]} slots")
        cur = torch.argmax(long16, dim=-1)
        finite = True
        for pos in range(s, s + 8):
            lg, cache = model.decode_step(params, cur, cache,
                                          torch.tensor([pos], device=DEV))
            finite &= bool(torch.isfinite(lg).all())
            cur = torch.argmax(lg, dim=-1)
        print(f"  pad_cache onto the {cfg.window}-slot ring, 8 decode steps: "
              f"logits finite {finite}")
        check(finite, "non-finite decode logits after pad_cache")
        del cache
        launches = rglru_scan.launches
        check(ref.ref_rglru_scan.cuda_calls == 0, "the plain RG-LRU scan ran on CUDA")

        # the check: a float32 copy (the bf16 weights upcast, exactly) runs
        # both prompts; its launches are not the main path's
        model32 = Model(dataclasses.replace(cfg, dtype="float32"))
        params32 = tree_map(lambda t: t.float(), params)
        pre32, step32 = _both_paths(model32, params32, prompt)
        long32, _ = model32.prefill(params32, toks)
        long32 = long32[0].float()
        del model32, params32
        torch.cuda.empty_cache()
    rel32 = _rel(pre32, step32)
    print(f"  prefill S={len(prompt)} vs token by token, float32 (bf16 weights "
          f"upcast): last-position logits rel_err={rel32:.3e} (limit 1e-4), "
          f"argmax agree {int(torch.argmax(pre32)) == int(torch.argmax(step32))}")
    check(rel32 < 1e-4, "Model.prefill disagrees with the token-by-token path")
    # bf16 rounds at other places on each path, and each lands about as
    # far from float32 (5.7-5.9e-2 at S 96 and S 3072 on the card), so a
    # bf16 prefill must stay within 1.2x of the bf16 token-by-token path's
    # own distance to float32
    d_pre, d_step = _rel(pre16, step32), _rel(step16, step32)
    print(f"  the same in bf16: rel_err={_rel(pre16, step16):.3e}, argmax agree "
          f"{int(torch.argmax(pre16)) == int(torch.argmax(step16))}; distance to "
          f"the float32 token-by-token logits: prefill {d_pre:.3e}, token by "
          f"token {d_step:.3e} (limit: prefill <= 1.2 x token by token)")
    check(d_pre <= 1.2 * d_step, "bf16 Model.prefill strays from float32")
    d_long = _rel(long16[0].float(), long32)
    print(f"  prefill S={s} bf16 vs the float32 copy: last-position logits "
          f"rel_err={d_long:.3e} (limit 1.2 x {d_step:.3e}), argmax agree "
          f"{int(torch.argmax(long16)) == int(torch.argmax(long32))}")
    check(d_long <= 1.2 * d_step, f"bf16 Model.prefill S={s} strays from float32")

    toks128 = torch.arange(128, device=DEV)[None]
    spare = list(range(R_BLOCKS - 4, R_BLOCKS))

    def prefill(t):
        with torch.inference_mode():
            return model.prefill(params, t)
    traces = _profile_steps({
        "Model.prefill S=128": lambda: prefill(toks128),
        f"Model.prefill S={s}": lambda: prefill(toks),
        "engine decode step, one request at pos 64": lambda: eng.runner.decode(
            [1], [spare], [64], rids=[-1]),
        "the same at pos 63, storing a block-boundary snapshot":
            lambda: eng.runner.decode([1], [spare], [R_BLOCK * 2 - 1], rids=[-1]),
    }, (RGLRU_KERNEL,), "RG-LRU kernel")
    for n in (128, s):
        got = _launches(traces[f"Model.prefill S={n}"], (RGLRU_KERNEL,))
        check(got == R_LAYERS_RGLRU,
              f"the S {n} prefill's trace shows {got} {RGLRU_KERNEL} launches")
    return launches


def phase_parity_hybrid():
    phase("15 CPU vs CUDA token parity (tiny float32 hybrid)")
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              num_layers=5, window=8)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cuda_params = tree_map(lambda t: t.to(DEV), params)
    bs = 16

    def run(p, device, swap):
        """tests/test_state_tiering.py's workload on a tight pool."""
        eng = EchoEngine(model, p, ECHO, num_blocks=8, block_size=bs,
                         chunk_size=2 * bs, max_pages_per_seq=16, max_running=2,
                         host_kv_blocks=32 if swap else 0, device=device)
        rng = np.random.default_rng(3)

        def toks(n):
            return tuple(int(x) for x in rng.integers(0, cfg.vocab_size, n))
        doc = toks(3 * bs)
        reqs = [Request(prompt=doc + toks(7), max_new_tokens=4,
                        task_type=TaskType.OFFLINE) for _ in range(6)]
        reqs += [Request(prompt=toks(3 * bs), max_new_tokens=4,
                         task_type=TaskType.ONLINE, arrival_time=0.0004 * (i + 1),
                         slo=SLO(30.0, 5.0)) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_iters=2000)
        check(all(r.done for r in reqs), f"tiny hybrid on {device} left requests unfinished")
        return reqs, eng

    reqs, _ = run(params, "cpu", swap=False)
    cpu_tokens = [r.output_tokens for r in reqs]
    gpu, eng = run(cuda_params, DEV, swap=False)
    check(cpu_tokens == [r.output_tokens for r in gpu], "CPU != CUDA tokens")
    swap, eng = run(cuda_params, DEV, swap=True)
    m = eng.bm.metrics
    print(f"  hit blocks {m.hit_blocks}; swap run: swapped out {m.swapped_out_tokens} "
          f"/ in {m.swapped_in_tokens} tokens ({m.swapped_out_bytes} / "
          f"{m.swapped_in_bytes} bytes)")
    check(m.swapped_out_tokens > 0 and m.swapped_in_tokens > 0,
          "the host tier never swapped a snapshot")
    check(cpu_tokens == [r.output_tokens for r in swap], "CPU != CUDA+swap tokens")

    _reset_rglru_counts()
    dense = []
    with torch.inference_mode():
        for r in reqs:
            n = len(r.prompt)
            last, cache = model.prefill(cuda_params, torch.tensor([r.prompt], device=DEV))
            cache = model.pad_cache(cache, n, n + r.max_new_tokens + 1)
            out = [int(torch.argmax(last[0]))]
            for pos in range(n, n + r.max_new_tokens - 1):
                lg, cache = model.decode_step(cuda_params,
                                              torch.tensor([out[-1]], device=DEV),
                                              cache, torch.tensor([pos], device=DEV))
                out.append(int(torch.argmax(lg[0])))
            dense.append(out)
    check(rglru_scan.launches == 4 * len(reqs) and ref.ref_rglru_scan.cuda_calls == 0,
          "the dense path did not run every RG-LRU layer through the kernel")
    check(cpu_tokens == dense, f"CPU {cpu_tokens} != CUDA dense path {dense}")
    print(f"  tokens equal on CPU, CUDA, CUDA+swap and the CUDA dense path: {cpu_tokens}")


# ------------------------------------------------------------------ MoE
def _free_card(what):
    """Fail unless the earlier phases left (nearly) nothing allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"  before {what}: {held / 2**20:.1f} MiB allocated on the card")
    check(held < 1 << 30, f"{held} B still allocated before {what}")


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _init_full_width(cfg):
    """Seeded random weights of ``cfg`` on the card, with the init's peak
    memory over the weights: at most one float32 temporary (a stacked
    weight is drawn one layer at a time)."""
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    weights = _nbytes(params)
    over = torch.cuda.max_memory_allocated() - weights
    # the largest float32 draw: the (vocab, d) embedding, or one layer of
    # the largest stacked weight
    temp = 4 * max([cfg.vocab_size * cfg.d_model]
                   + [t[0].numel() for t in tree_leaves(params["layers"])])
    print(f"init: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
          f"Hq={cfg.num_heads} Hkv={cfg.num_kv_heads} hd={cfg.head_dim} "
          f"vocab={cfg.vocab_size} {cfg.dtype}, "
          f"{sum(t.numel() for t in tree_leaves(params)):,} params, "
          f"{weights / 1e9:.2f} GB, KV {model.cache_bytes(1, 1):,} B a token, "
          f"in {time.perf_counter() - t0:.1f} s; init peak over the weights "
          f"{over / 1e6:.1f} MB (largest float32 temporary {temp / 1e6:.1f} MB)")
    check(over <= temp + (64 << 20), "the init held more than one float32 temporary")
    return model, params


def phase_serve_moe():
    """Returns the model and its weights, which phase 17 takes a layer of."""
    phase("16 serve qwen3-moe-30b-a3b at full width")
    _free_card("the MoE init")
    cfg = get_config("qwen3-moe-30b-a3b")
    model, params = _init_full_width(cfg)
    print(f"  {cfg.num_experts} experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, "
          f"capacity factor {cfg.capacity_factor}; pool {NUM_BLOCKS} blocks x {BS} "
          f"tokens = {model.cache_bytes(1, 1) * BS * NUM_BLOCKS / 1e9:.2f} GB")
    online, offline, eng, stats, wall = _serve_paged(model, params, "auto", SERVE_MIX)
    _print_serve(online, offline, stats, wall)
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff

    def expert(shape):              # a stored expert weight, (E, d, ff) or (E, ff, d)
        return list(shape) in ([e, d, ff], [e, ff, d])
    ops = {"expert products (bmm on an expert weight)":
           lambda name, shapes: name == "aten::bmm" and any(map(expert, shapes)),
           "copies of an expert weight":
           lambda name, shapes: name in ("aten::copy_", "aten::clone", "aten::contiguous",
                                         "aten::_to_copy") and any(map(expert, shapes))}
    attn = (SPLITK_DECODE, PREFILL_TC)
    traces = _profile_steps(_attention_steps(eng.runner), attn, "attention kernels", ops)
    # the dense dispatch reads every expert of every layer each step
    expert_bytes = 3 * e * d * ff * 2 * cfg.num_layers
    for name, by_name in traces.items():
        check(_launches(by_name, attn) == cfg.num_layers,
              f"{name}: not one attention launch a layer")
        ms, calls = by_name[("op", "expert products (bmm on an expert weight)")]
        print(f"  {name}: expert products read {expert_bytes / 1e9:.2f} GB in {ms:.3f} ms "
              f"({expert_bytes / max(ms, 1e-9) / 1e9:.2f} TB/s; bound "
              f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s)")
        check(calls == 3 * cfg.num_layers,
              f"{name}: {calls} expert products, not 3 a layer")
        check(by_name[("op", "copies of an expert weight")][1] == 0,
              f"{name}: an expert weight was copied")
    del eng
    torch.cuda.empty_cache()
    return model, params


def _top_gap(gates, k):
    """The smallest gap between consecutive ones of each row's k + 1
    largest gates, in float64: the margin of the k argmax choices."""
    top = gates.double().sort(-1, descending=True).values[..., :k + 1]
    return float((top[..., :-1] - top[..., 1:]).min())


def phase_moe_layer(model, params):
    """Layer 0's router and experts, upcast to float32 (2.4 GB on each
    side), on the card (TF32 off) and on the CPU."""
    phase("17 one full-width MoE layer: card against CPU (float32)")
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    card = tree_map(lambda a: a[0].float(), params["layers"][0][0]["moe"])
    host = tree_map(lambda t: t.cpu(), card)
    d, k = cfg.d_model, cfg.top_k
    print(f"  layer 0: {_nbytes(card) / 1e9:.2f} GB in float32 on each side")
    for what, live, rows in (("chunk group of 64", CHUNK, (1, CHUNK)),
                             ("decode batch of 5 padded to 8", 5, (8, 1))):
        # inputs whose rows keep their choices 1e-6 apart on the CPU:
        # routing is discrete, and a closer pair would make equal dispatch
        # a matter of rounding, not of the port
        for seed in range(5, 25):
            g = torch.Generator().manual_seed(seed)
            x = torch.randn(rows + (d,), generator=g)
            if rows[0] > 1:             # padded rows: copies of one row
                x[live:] = x[live]
            gates = torch.softmax(x.reshape(-1, d) @ host["router"], -1)
            if _top_gap(gates, k) > 1e-6:
                break
        check(_top_gap(gates, k) > 1e-6, f"{what}: no input seed with a 1e-6 margin")
        t = rows[0] * rows[1]
        cap = max(int(np.ceil(t * cfg.capacity_factor * k / cfg.num_experts)), 1)
        routes = [moe._route(torch.softmax(xx.reshape(1, t, d) @ p["router"], -1), k, cap)
                  for xx, p in ((x, host), (x.to(DEV), card))]
        same = torch.equal(routes[1][0].cpu(), routes[0][0])
        kept = int(routes[0][0].sum())
        want = moe.moe_apply(host, cfg, x)
        got = moe.moe_apply(card, cfg, x.to(DEV)).cpu()
        err = float((got - want).abs().max())
        rel = _rel(got, want)
        print(f"  {what} (input seed {seed}, margin {_top_gap(gates, k):.2e}): capacity "
              f"{cap}, {kept} of {t * k} choices kept, dispatch equal {same}; "
              f"output max_abs_err={err:.3e} rel_err={rel:.3e} (limit 1e-4)")
        check(same, f"{what}: the card routes other than the CPU")
        check(rel < 1e-4, f"{what}: the card's MoE output strays from the CPU's")
    del card, host


def phase_parity_moe():
    """Once capacity binds (factor 0.5), a token's experts depend on the
    tokens routed with it, so the swap run's schedule (a smaller pool,
    preemption, other batches) changes its tokens: the card's swap run is
    held against the CPU's swap run. At factor 8.0 nothing is dropped and
    all four runs agree."""
    phase("18 CPU vs CUDA token parity (tiny float32 MoE)")
    for cf in (8.0, 0.5):
        cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                                  capacity_factor=cf)
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        cuda_params = tree_map(lambda t: t.to(DEV), params)
        _reset_counts()
        cpu_tokens, _ = _tiny_engine_tokens(model, params, "cpu", swap=False)
        gpu_tokens, _ = _tiny_engine_tokens(model, cuda_params, DEV, swap=False)
        check(cpu_tokens == gpu_tokens, f"cf {cf}: CPU {cpu_tokens} != CUDA {gpu_tokens}")
        cpu_swap, _ = _tiny_engine_tokens(model, params, "cpu", swap=True)
        swap_tokens, eng = _tiny_engine_tokens(model, cuda_params, DEV, swap=True)
        m = eng.bm.metrics
        check(m.swapped_out_tokens > 0 and m.swapped_in_tokens > 0,
              "the host tier never swapped")
        check(cpu_swap == swap_tokens, f"cf {cf}: CPU+swap {cpu_swap} != CUDA+swap "
              f"{swap_tokens}")
        if cf >= 1:
            check(cpu_tokens == swap_tokens, f"cf {cf}: the swap run's tokens differ")
        check(paged_attention_splitk.launches > 0 and chunked_prefill_attention.launches > 0
              and ref.ref_paged_attention.cuda_calls == 0
              and ref.ref_chunked_prefill_attention.cuda_calls == 0,
              "the CUDA MoE engine did not attend through both kernels only")
        print(f"  capacity factor {cf}: swapped out {m.swapped_out_tokens} / in "
              f"{m.swapped_in_tokens} tokens; tokens equal on CPU and CUDA: "
              f"{cpu_tokens}; on CPU+swap and CUDA+swap: {swap_tokens} (the swap "
              f"schedule {'changed' if swap_tokens != cpu_tokens else 'kept'} them)")


def phase_serve_dense():
    phase("19 serve yi-9b and codeqwen1.5-7b at full width")
    launches = {}
    for arch in ("yi-9b", "codeqwen1.5-7b"):
        _free_card(f"the {arch} init")
        model, params = _init_full_width(get_config(arch))
        print(f"  pool {NUM_BLOCKS} blocks x {BS} tokens = "
              f"{model.cache_bytes(1, 1) * BS * NUM_BLOCKS / 1e9:.2f} GB")
        online, offline, eng, stats, wall = _serve_paged(model, params, "auto", SMALL_MIX)
        _print_serve(online, offline, stats, wall)
        launches[arch] = (paged_attention_splitk.launches,
                          chunked_prefill_attention.launches)
        attn = (SPLITK_DECODE, PREFILL_TC)
        traces = _profile_steps(_attention_steps(eng.runner), attn, "attention kernels")
        check(all(_launches(v, attn) == model.cfg.num_layers for v in traces.values()),
              f"{arch}: a profiled step launched other than one attention kernel a layer")
        del eng, params, model
        torch.cuda.empty_cache()
    print(f"  (split-K, prefill) launches: {launches}")


# ------------------------------------------------------------------ multimodal
def phase_serve_musicgen():
    """Returns the model and its weights, which phases 21 and 22 reuse."""
    phase("20 serve musicgen-medium at full width")
    _free_card("the musicgen-medium init")
    cfg = get_config("musicgen-medium")
    model, params = _init_full_width(cfg)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = {b: default_num_splits(b, cfg.num_kv_heads, MAX_PAGES, BS, sms)
              for b in (1, 2, 4, 8)}
    print(f"  pool {NUM_BLOCKS} blocks x {BS} tokens = "
          f"{model.cache_bytes(1, 1) * BS * NUM_BLOCKS / 1e9:.2f} GB; split-K splits "
          f"a row at {MAX_PAGES}-page tables, by decode batch: {splits}")
    registry, tracer = MetricsRegistry(), Tracer()
    online, offline, eng, stats, wall = _serve_paged(
        model, params, "auto", SERVE_MIX,
        attach=lambda e: instrument_engine(e, registry, tracer, replica=0))
    _print_serve(online, offline, stats, wall)

    # the probe saw every iteration; the port's checker reads both artifacts
    probed = registry.get("iteration_seconds").labels("0").count
    with tempfile.TemporaryDirectory() as tmp:
        prom, trace = Path(tmp) / "metrics.prom", Path(tmp) / "trace.json"
        registry.write(str(prom))
        tracer.write(str(trace))
        m, t = check_prometheus(str(prom)), check_trace(str(trace))
        sizes = prom.stat().st_size, trace.stat().st_size
    print(f"  obs: {probed} iterations probed of {len(stats.iterations)} recorded; "
          f"Prometheus text {sizes[0]:,} B, {m}; trace JSON {sizes[1]:,} B, {t}, "
          f"{tracer.dropped_events} dropped")
    check(probed == len(stats.iterations), "the probe missed iterations")
    check(m["samples"] > 0 and t["spans"] > 0 and t["instants"] > 0,
          "empty observability artifacts")

    traces = _profile_steps(_attention_steps(eng.runner), (SPLITK_DECODE, PREFILL_TC),
                            "attention kernels")
    for name, by_name in traces.items():
        kern = SPLITK_DECODE if name.startswith("decode") else PREFILL_TC
        got = _launches(by_name, (SPLITK_DECODE, PREFILL_TC, LEGACY_DECODE, "merge"))
        check(got == _launches(by_name, (kern,)) == cfg.num_layers,
              f"{name}: {got} attention launches, not one {kern} a layer")
    check(ref.ref_paged_attention.cuda_calls == 0
          and ref.ref_chunked_prefill_attention.cuda_calls == 0,
          "a plain attention ran on the card")
    del eng
    torch.cuda.empty_cache()
    return model, params


def _mm_inputs(cfg, b, s, frames, seed, device):
    """Tokens (b, s) and conditioning frames (b, frames, mm_embed_dim),
    float32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    mm = torch.from_numpy(rng.standard_normal((b, frames, cfg.mm_embed_dim))
                          .astype(np.float32))
    return toks.to(device), mm.to(device)


def _mrope_rows(b, s):
    """Three distinct M-RoPE position rows (time, height, width of a
    patch grid), (3, b, s) int64."""
    grid = torch.arange(s)
    return torch.stack([grid // 6, (grid // 3) % 2 + 2, grid % 3])[:, None].expand(3, b, s)


def phase_dense_multimodal(model, params):
    phase("21 the multimodal dense path")
    cfg = model.cfg
    toks, mm = _mm_inputs(cfg, 1, MM_S, MM_FRAMES, 3, DEV)
    # a float32 copy of the same weights (bf16 upcast exactly), TF32 off
    model32 = Model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last16, cache16 = model.prefill(params, toks, mm)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        bare16, _ = model.prefill(params, toks)
        last32, cache32 = model32.prefill(params32, toks, mm)
        bare32, _ = model32.prefill(params32, toks)
        # pad_cache, then decode steps fed the float32 path's greedy tokens
        cache16 = model.pad_cache(cache16, MM_S, MM_S + MM_STEPS + 1)
        cache32 = model32.pad_cache(cache32, MM_S, MM_S + MM_STEPS + 1)
        cur = torch.argmax(last32, -1)
        steps, finite = [], bool(torch.isfinite(last16).all())
        for pos in range(MM_S, MM_S + MM_STEPS):
            p = torch.tensor([pos], device=DEV)
            lg16, cache16 = model.decode_step(params, cur, cache16, p)
            lg32, cache32 = model32.decode_step(params32, cur, cache32, p)
            finite &= bool(torch.isfinite(lg16).all())
            steps.append(_rel(lg16[0].float(), lg32[0]))
            cur = torch.argmax(lg32, -1)
    del model32, params32, cache16, cache32
    torch.cuda.empty_cache()
    d_mm, d_bare = _rel(last16[0].float(), last32[0]), _rel(bare16[0].float(), bare32[0])
    moved = _rel(last32[0], bare32[0])
    print(f"  Model.prefill S={MM_S} with {MM_FRAMES} frames of {cfg.mm_embed_dim}, bf16: "
          f"{t_prefill * 1e3:.1f} ms wall; last logits against the float32 copy "
          f"rel_err={d_mm:.3e} (without frames {d_bare:.3e}), argmax agree "
          f"{int(torch.argmax(last16)) == int(torch.argmax(last32))}; limit "
          f"{DENSE_REL_LIMIT}")
    print(f"  the frames move the float32 last logits by rel {moved:.3e} "
          f"(limit: more than the bf16 rounding {d_mm:.3e})")
    print(f"  pad_cache, {MM_STEPS} decode steps: logits finite {finite}; rel_err "
          f"against float32 per step: {', '.join(f'{e:.3e}' for e in steps)}")
    check(finite, "non-finite multimodal logits")
    check(max([d_mm, d_bare] + steps) < DENSE_REL_LIMIT,
          "the bf16 dense path strays from its float32 copy")
    check(moved > d_mm, "the conditioning frames do not move the logits")

    # tiny float32 multimodal configs: the engine's tokens and the dense
    # path with frames, CPU against CUDA
    for arch, cf in (("qwen2-vl-72b", None), ("llama4-scout-17b-a16e", 8.0),
                     ("llama4-scout-17b-a16e", 0.5)):
        cfg = get_config(arch).reduced()
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        tiny = Model(cfg)
        cpu_params = tiny.init(torch.Generator().manual_seed(0))
        cuda_params = tree_map(lambda t: t.to(DEV), cpu_params)
        what = arch + (f" reduced, capacity factor {cf}" if cf else " reduced")
        _reset_counts()
        cpu_tokens, _ = _tiny_engine_tokens(tiny, cpu_params, "cpu", swap=False)
        gpu_tokens, _ = _tiny_engine_tokens(tiny, cuda_params, DEV, swap=False)
        check(cpu_tokens == gpu_tokens, f"{what}: CPU {cpu_tokens} != CUDA {gpu_tokens}")
        cpu_swap, _ = _tiny_engine_tokens(tiny, cpu_params, "cpu", swap=True)
        swap_tokens, eng = _tiny_engine_tokens(tiny, cuda_params, DEV, swap=True)
        m = eng.bm.metrics
        check(m.swapped_out_tokens > 0 and m.swapped_in_tokens > 0,
              f"{what}: the host tier never swapped")
        check(cpu_swap == swap_tokens, f"{what}: CPU+swap {cpu_swap} != CUDA+swap "
              f"{swap_tokens}")
        if cf is None or cf >= 1:
            check(cpu_tokens == swap_tokens, f"{what}: the swap run's tokens differ")
        check(paged_attention_splitk.launches > 0 and chunked_prefill_attention.launches > 0
              and ref.ref_paged_attention.cuda_calls == 0
              and ref.ref_chunked_prefill_attention.cuda_calls == 0,
              f"{what}: the card did not attend through both kernels only")
        toks, mm = _mm_inputs(cfg, 2, 20, 6, 5, "cpu")
        kw = dict(seq_lens=torch.tensor([20, 13]))
        if cfg.mrope_sections:
            kw["positions"] = _mrope_rows(2, 20)
        want, _ = tiny.prefill(cpu_params, toks, mm, **kw)
        got, _ = tiny.prefill(cuda_params, toks.to(DEV), mm.to(DEV),
                              **{k: v.to(DEV) for k, v in kw.items()})
        err = float((got.cpu() - want).abs().max())
        print(f"  {what}: tokens equal on CPU and CUDA {cpu_tokens}; with swap "
              f"(out {m.swapped_out_tokens} / in {m.swapped_in_tokens} tokens) "
              f"{swap_tokens}; prefill with frames"
              f"{' and three M-RoPE rows' if cfg.mrope_sections else ''} "
              f"max_abs_err={err:.3e} (limit 1e-5)")
        check(torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5),
              f"{what}: the prefill with frames differs on the card")


def phase_replicas(model, params):
    """Two engines share musicgen's weights on the card, each with its own
    pool and host tier, as replicas 0 and 1 under a router: replica 0's
    cached document moves to replica 1 as real pages, and a request
    evacuated from replica 0 mid-decode finishes on replica 1."""
    phase("22 two replicas on one card: prefix migration and evacuation")
    cfg = model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()

    def engine():
        return EchoEngine(model, params, ECHO, num_blocks=REP_BLOCKS, block_size=BS,
                          chunk_size=CHUNK, max_pages_per_seq=MAX_PAGES,
                          host_kv_blocks=REP_BLOCKS, time_model=TimeModel.h100(),
                          clock="wall", device=DEV)
    rep0, rep1 = Replica(0, engine()), Replica(1, engine())
    router = Router([rep0, rep1])
    grown = torch.cuda.memory_allocated() - held
    pool = model.cache_bytes(1, 1) * BS * REP_BLOCKS
    print(f"  two engines: {grown / 1e9:.3f} GB more on the card for two pools of "
          f"{pool / 1e9:.3f} GB (a copy of the weights would add "
          f"{_nbytes(params) / 1e9:.2f} GB)")
    check(grown < 2 * pool + (64 << 20), "a replica copied the weights")
    _reset_counts()

    rng = np.random.default_rng(7)

    def offline(n_new, *parts):
        return Request(prompt=sum(parts, ()), max_new_tokens=n_new,
                       task_type=TaskType.OFFLINE)

    def toks(n):
        return tuple(int(x) for x in rng.integers(0, cfg.vocab_size, n))
    doc, question = toks(6 * BS), toks(12)       # the document fills 6 blocks
    seed_req = offline(2, doc)
    rep0.submit(seed_req)
    rep0.engine.run(max_iters=500)
    local = offline(16, doc, question)
    rep0.submit(local)
    rep0.engine.run(max_iters=500)
    check(seed_req.done and local.done, "replica 0 left its requests unfinished")

    # the export's pages, read off the card, and its wall time
    exported = []
    export = rep0.engine.export_prefix

    def timed_export(tokens):
        t0 = time.perf_counter()
        out = export(tokens)
        exported.append((out, time.perf_counter() - t0))
        return out
    rep0.engine.export_prefix = timed_export
    moved = offline(16, doc, question)
    t0 = time.perf_counter()
    admitted = router.migrate_prefix(rep0, rep1, moved)
    t_migrate = time.perf_counter() - t0
    ((hbs, n_bytes), t_export), = exported
    check(len(hbs) == len(doc) // BS and all(hb.payload is not None for hb in hbs),
          f"exported {len(hbs)} blocks, not the document's {len(doc) // BS} with pages")
    check(admitted == n_bytes > 0, f"admitted {admitted} B of {n_bytes} B exported")
    check(rep1.engine.bm.metrics.migrated_in_blocks == len(hbs),
          "replica 1 did not take in every block")
    rep1.submit(moved)
    t0 = time.perf_counter()
    rep1.engine.run(max_iters=500)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    m1, st1 = rep1.engine.bm.metrics, rep1.engine.stats
    print(f"  migrated {len(hbs)} blocks, {n_bytes:,} B ({n_bytes // len(hbs):,} B a "
          f"block): export (device to host, {2 * cfg.num_layers * len(hbs)} page "
          f"copies) {t_export * 1e3:.2f} ms, {n_bytes / t_export / 1e9:.2f} GB/s; "
          f"migrate_prefix {t_migrate * 1e3:.2f} ms")
    print(f"  replica 1: swapped in {m1.swapped_in_tokens} tokens, "
          f"{st1.swapped_in_bytes:,} B, copy time {st1.swap_transfer_time * 1e3:.2f} ms "
          f"({st1.swapped_in_bytes / max(st1.swap_transfer_time, 1e-9) / 1e9:.2f} GB/s); "
          f"the question served in {t_serve * 1e3:.1f} ms wall")
    print(f"  tokens: replica 0 {local.output_tokens}; replica 1 {moved.output_tokens}")
    check(moved.done and m1.swapped_in_tokens > 0,
          "replica 1 recomputed the prefix instead of restoring it")
    check(moved.output_tokens == local.output_tokens,
          "the migrated prefix gave other tokens than the local run")

    # evacuation mid-decode
    req = offline(16, toks(4 * BS))
    rep0.submit(req)
    for _ in range(100):
        if req.n_output >= 4:
            break
        rep0.engine.step()
    before = list(req.output_tokens)
    evacuated = rep0.evacuate()
    snap0 = rep0.engine.bm.occupancy_snapshot()
    print(f"  evacuated {len(evacuated)} request(s) at {len(before)} of "
          f"{req.max_new_tokens} tokens; replica 0 then holds {snap0['running']} "
          f"running blocks ({snap0['cached']} cached, {snap0['free']} free); its "
          f"runner keeps no state a request (the pool's pages are the block "
          f"manager's)")
    check(evacuated == [req] and not req.block_ids and snap0["running"] == 0
          and not rep0.has_work(), "replica 0 kept the evacuated request")
    rep1.submit(req)
    rep1.engine.run(max_iters=500)
    snap1 = rep1.engine.bm.occupancy_snapshot()
    print(f"  replica 1 finished it: {req.output_tokens} (the first {len(before)} "
          f"kept); then {snap1['running']} running blocks, {snap1['cached']} cached, "
          f"{snap1['free']} free of {snap1['total']}")
    check(req.done and req.output_tokens[:len(before)] == before,
          "the evacuated request lost its tokens")
    check(snap1["running"] == 0 and snap1["free"] + snap1["cached"] == snap1["total"],
          "replica 1 leaked blocks")
    check(paged_attention_splitk.launches > 0 and chunked_prefill_attention.launches > 0
          and ref.ref_paged_attention.cuda_calls == 0
          and ref.ref_chunked_prefill_attention.cuda_calls == 0,
          "the replicas did not attend through both kernels only")
    del rep0, rep1, router
    torch.cuda.empty_cache()


def main():
    kind, count = phase_device()
    gen = torch.Generator(device=DEV).manual_seed(0)
    phase_build()
    errs = phase_kernels(gen)
    rows = phase_timing(gen, errs)
    launches = phase_serve()
    phase_parity()
    ssd_err = phase_ssd_kernel(gen)
    rows.append(phase_ssd_timing(gen, ssd_err))
    launches["ssd_scan"] = phase_serve_mamba()
    phase_parity_mamba()
    rglru_err = phase_rglru_kernel(gen)
    rows += phase_rglru_timing(gen, rglru_err)
    model, params, eng, prompt = phase_serve_hybrid()
    launches["rglru_scan"] = phase_dense_hybrid(model, params, eng, prompt)
    del model, params, eng
    torch.cuda.empty_cache()
    phase_parity_hybrid()
    model, params = phase_serve_moe()
    phase_moe_layer(model, params)
    del model, params
    phase_parity_moe()
    phase_serve_dense()
    model, params = phase_serve_musicgen()
    phase_dense_multimodal(model, params)
    phase_replicas(model, params)
    del model, params
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    first = {}
    for r in rows:
        first.setdefault(r["name"], r)
    for r in first.values():
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in first.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
