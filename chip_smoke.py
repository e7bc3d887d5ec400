#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     for sm_90a (seconds, and ptxas' registers / shared memory / spills);
  3. kernels against their plain PyTorch versions on the card, at the main
     path's shapes (qwen3-4b: Hq 32, Hkv 8, hd 128, page 16, bf16) and on the
     cases of tests/test_kernels.py;
  4. kernel time beside its bound, the plain version's time and
     ``scaled_dot_product_attention``'s (a yardstick the port never calls);
  5. serve full-width qwen3-4b (36 layers, bf16, seeded random weights)
     through ``EchoEngine``: online and offline requests must all finish,
     through the kernels only;
  6. token parity of a tiny float32 model between the CPU (plain versions)
     and the card (kernels), and again on the card with host-tier swap.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import ECHO, SLO, EchoEngine, Request, TaskType, TimeModel  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_splitk  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.params import tree_map  # noqa: E402

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
DEV = "cuda"


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch, with L2 flushed before each one (a 256 MB write):
    the serving path finds its KV and weights cold, 36 layers apart."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


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


def phase_kernels(gen):
    phase("3 kernels vs plain versions")
    errs = {"paged_attention_splitk": 0.0, "chunked_prefill_attention": 0.0}
    # main-path decode: ragged contexts up to the table with one full row,
    # then the serve's own shape (contexts near 100); one padded row each
    for b, lo, hi in ((1, 1, MAX_PAGES * BS), (8, 1, MAX_PAGES * BS),
                      (32, 1, MAX_PAGES * BS), (8, 80, 120)):
        ctx = torch.randint(lo, hi + 1, (b,), generator=gen, device=DEV).tolist()
        if hi == MAX_PAGES * BS:
            ctx[0] = hi
        if b > 1:
            ctx[-1] = 0
        ins = decode_inputs(gen, b, HQ, HKV, HD, BS, MAX_PAGES, ctx,
                            torch.bfloat16, NUM_BLOCKS)
        live = ins[4] > 0
        e = compare(f"decode bf16 B={b} ctx {lo}..{hi}", paged_attention_splitk(*ins),
                    ref.ref_paged_attention(*ins), TOL["decode"][torch.bfloat16], live)
        errs["paged_attention_splitk"] = max(errs["paged_attention_splitk"], e)
    for ctx in (0, 37, 448):
        ins = prefill_inputs(gen, CHUNK, MAX_PAGES * BS, HQ, HKV, HD, torch.bfloat16)
        e = compare(f"prefill bf16 Sc=64 T=512 ctx={ctx}",
                    chunked_prefill_attention(*ins, ctx),
                    ref.ref_chunked_prefill_attention(*ins, ctx),
                    TOL["prefill"][torch.bfloat16])
        errs["chunked_prefill_attention"] = max(errs["chunked_prefill_attention"], e)
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
            for splits in (1, 2, 4, None):
                compare(f"decode {str(dtype)[6:]} b={b} hq={hq} hkv={hkv} hd={hd} "
                        f"bs={bs} splits={splits}",
                        paged_attention_splitk(*ins, num_splits=splits), want,
                        TOL["decode"][dtype])
        for sc, t, hq, hkv, hd, ctx in chunked_cases:
            ins = prefill_inputs(gen, sc, t, hq, hkv, hd, dtype)
            compare(f"prefill {str(dtype)[6:]} sc={sc} t={t} hq={hq} hkv={hkv} "
                    f"hd={hd} ctx={ctx}", chunked_prefill_attention(*ins, ctx),
                    ref.ref_chunked_prefill_attention(*ins, ctx), TOL["prefill"][dtype])
    torch.cuda.synchronize()
    return errs


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


def _decode_row(gen, errs, b, ctx):
    """Time one decode launch at batch ``b`` with contexts ``ctx``, the
    main path's table width; also with one split per row, the schedule
    in which one CTA walks all of a row's live pages."""
    ins = decode_inputs(gen, b, HQ, HKV, HD, BS, MAX_PAGES, ctx, torch.bfloat16,
                        NUM_BLOCKS)
    item = 2
    live_pages = sum(-(-c // BS) for c in ctx)
    nbytes = (2 * b * HQ * HD * item + sum(ctx) * HKV * HD * 2 * item
              + live_pages * 4 + b * 4)
    flops = 4 * sum(ctx) * HQ * HD
    sq, sk, sv, smask = _sdpa_decode(*ins)
    return dict(
        name="paged_attention_splitk", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention_splitk.cu",
        replaces="src/repro/kernels/paged_attention.py:164",
        shape=f"B={b} Hq={HQ} Hkv={HKV} hd={HD} bs={BS} nblk={MAX_PAGES} "
              f"sum(ctx)={sum(ctx)} bf16",
        ms=time_ms(lambda: paged_attention_splitk(*ins)),
        one_split_ms=time_ms(lambda: paged_attention_splitk(*ins, num_splits=1)),
        plain_ms=time_ms(lambda: ref.ref_paged_attention(*ins)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=smask, enable_gqa=True)),
        bound=bound(nbytes, flops, torch.bfloat16),
        max_abs_err=errs["paged_attention_splitk"])


def phase_timing(gen, errs):
    """Rows of kernel times; the first row of each kernel is the shape the
    serve of phase 5 gives it and goes into the JSON line."""
    phase("4 kernel time")
    # decode as the serve runs it (batch 8, contexts near 100), then a
    # full batch of 32 with ragged contexts up to the table
    rows = [_decode_row(gen, errs, 8, torch.randint(
                80, 121, (8,), generator=gen, device=DEV).tolist()),
            _decode_row(gen, errs, 32, torch.randint(
                1, MAX_PAGES * BS + 1, (32,), generator=gen, device=DEV).tolist())]
    # prefill: one engine chunk against the longest prefix of the table
    item = 2
    sc, t, c = CHUNK, MAX_PAGES * BS, 448
    ins = prefill_inputs(gen, sc, t, HQ, HKV, HD, torch.bfloat16)
    keys = min(t, c + sc)
    nbytes = 2 * sc * HQ * HD * item + keys * HKV * HD * 2 * item
    flops = 4 * HD * HQ * sum(min(t, c + i + 1) for i in range(sc))
    mask = (torch.arange(t, device=DEV)[None] <= c + torch.arange(sc, device=DEV)[:, None])
    pq, pk, pv = (x.transpose(0, 1)[None] for x in ins)
    rows.append(dict(
        name="chunked_prefill_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/chunked_prefill.cu",
        replaces="src/repro/kernels/chunked_prefill.py:94",
        shape=f"Sc={sc} T={t} ctx={c} Hq={HQ} Hkv={HKV} hd={HD} bf16",
        ms=time_ms(lambda: chunked_prefill_attention(*ins, c)),
        plain_ms=time_ms(lambda: ref.ref_chunked_prefill_attention(*ins, c)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            pq, pk, pv, attn_mask=mask, enable_gqa=True)),
        bound=bound(nbytes, flops, torch.bfloat16),
        max_abs_err=errs["chunked_prefill_attention"]))
    for r in rows:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms"
              + (f", one split {r['one_split_ms']:.4f} ms" if "one_split_ms" in r else ""))
    return rows


def _profile_steps(runner):
    """Where a step's time goes: for one decode step (batch 8) and one
    prefill chunk, the wall time (mean of 5, no profiler), and from one
    ``torch.profiler`` trace the device time summed over kernels and
    copies, their number, and the ones that took longest."""
    from torch.profiler import ProfilerActivity, profile
    tables = [list(range(i * 8, i * 8 + 8)) for i in range(8)]
    steps = {
        "decode B=8 ctx=101": lambda: runner.decode([1] * 8, tables, [100] * 8),
        "prefill Sc=64 ctx=128": lambda: runner.prefill_chunk(
            list(range(CHUNK)), 128, list(range(64, 76))),
    }
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only (kernels and copies): the CPU-side op
        # rows of key_averages() carry the same device time again
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        by_name = {}
        for e in dev:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
        print(f"  profile {name}: wall {wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
              f"({dev_ms / wall_ms:.1%}), {len(dev)} device kernels and copies")
        for kname, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"    {t:8.3f} ms x{n:<4d} {kname[:90]}")
        attn = [(t, n) for kname, (t, n) in by_name.items()
                if "splitk_" in kname or "chunked_prefill_kernel" in kname]
        print(f"    attention kernels (ours): {sum(t for t, _ in attn):.3f} ms over "
              f"{sum(n for _, n in attn)} launches")


def _reset_counts():
    paged_attention_splitk.launches = 0
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
    eng = EchoEngine(model, params, ECHO, num_blocks=NUM_BLOCKS, block_size=BS,
                     chunk_size=CHUNK, max_pages_per_seq=MAX_PAGES,
                     time_model=TimeModel.h100(), clock="wall", device=DEV)
    # warm the libraries (cuBLAS handles, kernel modules) on free pages
    eng.runner.prefill_chunk(list(range(CHUNK)), 0, [0, 1, 2, 3])
    eng.runner.decode([1], [[0, 1, 2, 3, 4]], [CHUNK])
    torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size

    def toks(n):
        return tuple(int(x) for x in rng.integers(0, vocab, n))
    online = [Request(prompt=toks(n), max_new_tokens=16, task_type=TaskType.ONLINE,
                      arrival_time=at, slo=SLO(ttft=2.0, tpot=0.5))
              for n, at in ((40, 0.0), (96, 0.05), (150, 0.1), (200, 0.2))]
    offline = []
    for _ in range(2):
        doc = toks(160)
        offline += [Request(prompt=doc + toks(24), max_new_tokens=16,
                            task_type=TaskType.OFFLINE) for _ in range(3)]
    for r in online + offline:
        eng.submit(r)

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = eng.run(max_iters=5000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention_splitk": paged_attention_splitk.launches,
                "chunked_prefill_attention": chunked_prefill_attention.launches}
    plain_calls = (ref.ref_paged_attention.cuda_calls
                   + ref.ref_chunked_prefill_attention.cuda_calls)

    for r in online + offline:
        check(r.done and r.n_output == r.max_new_tokens,
              f"request {r.rid} finished {r.n_output}/{r.max_new_tokens} tokens")
        check(all(0 <= t < vocab for t in r.output_tokens), "token outside the vocabulary")
    n_chunks = sum(rec.n_prefill for rec in stats.iterations)
    n_decode_steps = sum(1 for rec in stats.iterations if rec.n_decode)
    print(f"launches {launches}, prefill chunks {n_chunks}, decode steps "
          f"{n_decode_steps}, plain attention calls on CUDA {plain_calls}")
    check(launches["chunked_prefill_attention"] == cfg.num_layers * n_chunks,
          "prefill kernel launches != layers x chunks")
    check(launches["paged_attention_splitk"] == cfg.num_layers * n_decode_steps,
          "decode kernel launches != layers x decode steps")
    check(min(launches.values()) > 0, "a kernel of the path never launched")
    check(plain_calls == 0, "the plain attention ran on CUDA tensors in the serve")

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
    _profile_steps(eng.runner)
    del eng, params
    torch.cuda.empty_cache()
    return launches


def _tiny_engine_tokens(model, params, device, swap):
    kw = (dict(num_blocks=16, host_kv_blocks=32) if swap else dict(num_blocks=64))
    eng = EchoEngine(model, params, ECHO, block_size=8, chunk_size=16,
                     max_pages_per_seq=16, device=device, **kw)
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


def main():
    kind, count = phase_device()
    gen = torch.Generator(device=DEV).manual_seed(0)
    phase_build()
    errs = phase_kernels(gen)
    rows = phase_timing(gen, errs)
    launches = phase_serve()
    phase_parity()
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
