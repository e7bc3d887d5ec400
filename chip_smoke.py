#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (the
     five forward kernels and, since the training phases, the two scans'
     backward kernels) with nvcc for sm_90a, one process per source, all
     started together (seconds, and ptxas' registers / shared memory /
     spills; the redesigned kernels (bf16 tensor-core prefill, warp-split
     legacy decode, clustered split-K decode, 3xTF32 SSD scan, the RG-LRU
     scan's shared-memory ring) must not spill);
  3. attention kernels (split-K and legacy warp-split decode, chunked
     prefill) against their plain PyTorch versions on the card, at the main
     path's shapes (qwen3-4b: Hq 32, Hkv 8, hd 128, page 16, bf16), at the
     other serves' head shapes (codeqwen1.5-7b's MHA, Hkv 32; yi-9b's and
     qwen3-moe's G 8, Hkv 4; musicgen-medium's MHA of 24 heads at hd 64,
     B 1, 8 and 32), at long context (B 2, 512-page tables) and
     with more splits than live tiles, and on the cases of
     tests/test_kernels.py, garbage pages included; and at query groups
     past 8, which the decode kernels take in slices of 8 rows: granite-34b's
     MQA (Hq 48, Hkv 1, six slices), llama4-scout's G 5 (Hq 40, Hkv 8), and
     G 9 and G 12 (a short last slice), and qwen2-vl-72b's G 8 (Hq 64, Hkv
     8), in bf16 and float32, B 1, 8 and 32, granite's, llama4-scout's and
     qwen2-vl's heads also at long context, garbage pages included, the
     prefill at all five;
  4. attention kernel time beside its bound, the plain version's time and
     ``scaled_dot_product_attention``'s (a yardstick the port never calls):
     decode at the serve's B 8, at B 32 and at long context (B 2, contexts
     8192 and 5000), split-K also at 1, 2, 4 and 8 splits; and the prefill
     tile height not taken; decode at B 8 and prefill also at codeqwen's
     and musicgen-medium's MHA shapes, and at the heads of granite-34b's
     MQA, llama4-scout (Hq 40, Hkv 8) and qwen2-vl (Hq 64, Hkv 8), decode
     at B 8 and at long context;
  5. serve full-width qwen3-4b (36 layers, bf16, seeded random weights)
     through ``EchoEngine``: online and offline requests must all finish,
     through the kernels only; then the same mix with ``attn_impl="pallas"``,
     whose decode goes through the legacy kernel only; a profile of a
     decode step and a prefill chunk of the first (one split-K cluster
     launch a layer and no merge kernel in the decode step, one prefill
     launch a layer in the chunk), and of a decode step of the second;
  6. token parity of tiny float32 attention models, G 2 and G 48 (48
     query heads on one kv head), between the CPU (plain versions) and the
     card (kernels), and again on the card with host-tier swap; and CPU
     against card with the legacy decode schedule;
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
     serve; a profile of a decode step and a prefill chunk, with the device
     time of the expert products, of ``_route`` and of the whole MoE
     layer, and no copy of an expert weight;
 17. one full-width MoE layer of that model, upcast to float32, on the card
     against the CPU: a 64-token chunk group and a decode batch of 5 padded
     to 8 route to equal ``dispatch`` tensors, and the outputs agree to
     1e-4 (relative norm);
 17b. the same for one full-width llama4-scout-17b-a16e MoE layer (16
     experts of d_ff 8192, top-1 at capacity factor 1.25, the shared
     expert; 8.6 GB in float32 on each side), from phase 19c's weights:
     capacity 5 for the chunk group, 1 for the decode batch, where most
     choices are dropped and those tokens keep the shared expert alone;
 18. token parity of a tiny float32 MoE (qwen3-moe reduced) between the CPU
     and the card, and between the two with host-tier swap, at capacity
     factors 8.0 and 0.5 (where routing drops tokens, so the swap run's
     other batches change its tokens);
 19. serve full-width yi-9b (48 layers, G 8) and codeqwen1.5-7b (32 layers,
     MHA) through ``EchoEngine`` with a smaller mix, the checks of phase 5,
     and a profile of a decode step and a prefill chunk of each;
 19b. serve granite-34b at full width (d 6144, MQA: 48 query heads of hd
     128 on one kv head, d_ff 24576, vocab 49152, bf16, seeded random
     weights) with its depth cut to 56 of 88 layers (60.0 GB of weights;
     88 would be 93.9 GB), or to 48 if the freed card cannot hold 56 (the
     phase's name then says so), with phase 19's mix and checks; the init's
     peak over the weights and the pool's size; a profile of a decode step
     (one split-K launch a layer, no plain version) and a prefill chunk
     (one prefill launch a layer); then the same mix with
     ``attn_impl="pallas"`` and a profiled decode step through the legacy
     kernel only, beside the card's name and power limit; the profiled
     steps' device-to-host copies (the logits) and the phase's seconds;
 19c. the same for llama4-scout-17b-a16e at full width (d 5120, Hq 40 on
     Hkv 8 of hd 128, 16 experts of d_ff 8192, top-1 plus a shared expert,
     vocab 202048) with its depth cut to 12 of 48 layers (57.0 GB; 8 if
     the freed card cannot hold 12), and in the decode step's and prefill
     chunk's profiles phase 16's MoE figures: the device time of the
     three products on an expert weight a layer (and their read rate), of
     ``_route`` and of the whole MoE layer, with no copy of an expert
     weight;
 19d. the same for qwen2-vl-72b at full width (d 8192, Hq 64 on Hkv 8 of
     hd 128, d_ff 29568, vocab 152064) with its depth cut to 32 of 80
     layers (61.2 GB; 24 if the freed card cannot hold 32); serving passes
     three equal M-RoPE rows, which is plain RoPE;
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
 21b. phase 21's dense path with frames at full width on a fresh 2-layer
     cut of llama4-scout-17b-a16e (32 frames of 1408) and of qwen2-vl-72b
     (32 frames of 1280), bf16 against the float32 copy; qwen2-vl's also
     with three distinct M-RoPE rows through its sections (16, 24, 24),
     which must move the float32 logits by more than the bf16 gap
     (phases 19c, 17b, 19d and 21b run after 19b, before 20);
 22. two engines on musicgen's one copy of the weights, each with its own
     pool and host tier, as replicas under a ``cluster.Router``: a cached
     document's pages migrate from replica 0 to replica 1, whose greedy
     tokens equal replica 0's, and a request evacuated from replica 0
     mid-decode finishes on replica 1 with no block leaked;
 23. the real-time front door (``repro_torch.serving``, ``repro_torch.rt``)
     on full-width qwen3-4b, on a card freed of every earlier phase: the
     link calibration of the card's pageable host copies (applied, 0.5-100
     GB/s); phase 5's mix through ``EchoService.drive`` and through
     ``AsyncEchoEngine`` on a paused ``ManualClock``, two engines on one
     copy of the weights, with equal tokens and engine-domain finish times
     request by request; ``EchoServer`` on loopback over a wall-clock
     engine with the probes attached, eight concurrent clients, one of
     which hangs up after its second token (its request aborted, its
     blocks freed, no leak after the drain), with the wall TTFT and TPOT
     of each class and the time each ``to_thread`` hop adds; and
     ``python -m repro_torch.launch.serve`` as a subprocess on the card:
     ``--serve`` answering three requests and draining on SIGINT, then a
     trace replay in which every online request finishes;
 24. the two scans' backward kernels (port-only: the JAX package
     differentiates its XLA scans) against their plain backwards in
     float32, to 1e-5 of the largest plain value and in relative norm,
     each of their kernels free of spills (the SSD backward's three: the dH
     walk, the chunk terms, the head groups' sum; its two product kernels
     with tensor-core HMMA instructions in ``cuobjdump -sass``): RG-LRU at
     recurrentgemma's training shape (B 1, W 4096, S 4096), S 4000, 300 and
     37, W 4104 and a misaligned view; SSD at mamba2's (B 1, H 64, P 64, N
     128, chunk 64, S 4096), at S 4032 whose last 32 steps are the model's
     padding, at B 2, at chunk 32, at 12 heads (a short last head group)
     and on the cases of tests/test_kernels.py, normal and slow decay; two
     SSD backward launches on the same inputs bitwise equal; then each
     one's time at S 4096 beside its bound (the SSD's also beside its
     3xTF32 tensor-core bound), its plain backward's, the SSD backward's
     three launches' shares from a trace and the bytes its design moves;
     and the SSD forward at the training shape (S 4096, per-chunk states)
     beside its bounds;
 25. train full-width mamba2-1.3b (48 layers, bf16, seeded random
     weights) for 12 steps of ``make_train_step`` at its defaults (peak lr
     3e-4, warmup 100) at B 1, S 4096 from ``TokenStream``, on a card freed
     of earlier phases: the mean of the last 3 losses below that of the
     first 3; every leaf's gradient finite and non-zero at every step; 96
     SSD forward launches (each layer again under checkpointing) and 48
     backward calls a step, and in the profiled step's trace 48 of each of
     the backward's three kernels, no plain version on the card; peak memory,
     step wall, tokens/s, 6 N T over the step as a share of 989 TFLOP/s,
     and a profile of one step; the first step's loss and gradient norm
     through autograd of the plain scans on the card, on the same bf16
     weights (printed: bf16 rounding alone moves this model's gradient
     norm further, see below) and on a float32 copy of them, where they
     must equal the kernels' to 1e-3 (a check applied after the last
     phase, so every phase runs first); each bf16 path's gap from the
     float32 step is printed beside the kernel-vs-plain gap;
 26. the same for recurrentgemma-9b at full width with its depth cut to 14
     layers (four checkpointed (rglru, rglru, attn) units and the unrolled
     pair; at 38 layers its weights, gradients and AdamW moments alone are
     102 GB): 18 RG-LRU forward and 10 backward launches a step; its first
     step through the kernels and through the plain scans equal to 1e-3 on
     the bf16 weights, held after the last phase;
 27. the same for full-width qwen3-4b, whose training path runs no kernel
     of the repo, as in JAX: the in-place optimizer over 8.8 GB of weights,
     8.8 GB of gradients and 35.3 GB of moments (its first-step
     comparison, bf16, held as phase 26's);
 28. tiny and reduced float32 configs (dense, qwen3-moe, mamba2,
     recurrentgemma) trained 3 steps on the CPU and on the card: losses and
     gradient norms to 1e-5, the first step's gradients and parameter
     steps to the CPU tests' tolerances, the parameter gaps in lr units;
 29. ``python -m repro_torch.launch.train --device cuda`` on reduced
     mamba2 for 3 steps, its checkpoint restored on the card leaf for leaf;
 30. the production dry run (``python -m repro_torch.launch.dryrun``, a
     ``fake`` process group of 256 ranks in each subprocess, on the host)
     at full width: mamba2-1.3b, qwen3-4b and qwen3-moe-30b-a3b at
     train_4k and decode_32k on the single-pod mesh, and granite-34b's
     train_4k on the two-pod mesh (512 ranks), side by side; each
     record's per-rank bytes, ``fits_80gb`` against the card's memory,
     collectives and trace time, and its peak a rank (the arguments plus
     ``temp_bytes``, the live-bytes peak of the traced step), failing on
     any record not ``ok`` or without a positive ``temp_bytes``; each
     train record's collectives and largest storage inside
     ``adamw_update``, failing where that storage or an all-gather's result
     exceeds the rank's largest parameter shard in float32 (ZeRO-1 keeps
     the update inside each parameter's `model` shard); the dry
     run's counts of three steps on a (1, 1) mesh: phase 31's training
     step and its 128-token prefill (mamba2-1.3b), and phase 27's
     training step (qwen3-4b), whose peak must lie within PEAK_RTOL (5%)
     of the card's ``torch.cuda.max_memory_allocated()`` over phase 27's
     steps, less what earlier phases left allocated;
 31. phase 25's run again on a (data 1, model 1) ``DeviceMesh`` over an
     NCCL process group of one rank (a ``HashStore``, no network), with the
     logical-axis hook installed: full-width mamba2-1.3b distributed by
     ``param_shardings`` with ZeRO-1 moments, 12 steps whose losses and
     gradient norms must equal phase 25's bitwise, the SSD forward and
     backward kernels launched through ``local_map`` (96 and 48 a step, in
     the counters and in a profiled step's trace), the card's peak memory
     over the 12 steps within PEAK_RTOL of the dry run's peak for the same
     step; the mesh's parameters and ZeRO-1 moments saved through
     ``training.checkpoint`` and restored into the same placements,
     bitwise; then ``Model.prefill`` of a 128-token prompt, with the moments
     freed, its peak within PEAK_RTOL of the dry run's, and 8 greedy decode
     steps on the mesh, whose tokens must equal the unsharded path's on the
     same weights; the group destroyed after.

A profile's figures come from a trace that holds the device record of every
launch, copy and memset of the step: the profiler at times drops the first
device records of a trace, so 1024 small launches open each trace ahead of
the step, and a trace that still lacks some of the step's is taken again,
at most three times in all (``tools/profile_drops.py`` measures how often).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import chunked_prefill as cp_mod  # noqa: E402
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    default_num_splits, group_slices, paged_attention, paged_attention_splitk)
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_bwd_work, ssd_chunked, ssd_fwd_flops, ssd_scan)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.state_cache import StateRunner  # noqa: E402
from repro_torch.models.transformer import segments as tfm_segments  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer, instrument_engine  # noqa: E402
from repro_torch.obs.check import check_prometheus, check_trace  # noqa: E402
from repro_torch.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.rt import AsyncEchoEngine, EchoServer, ManualClock, request_once  # noqa: E402
from repro_torch.rt.calibrate import calibrate_link  # noqa: E402
from repro_torch.serving import EchoService, HandleStatus  # noqa: E402
from repro_torch.training import adamw_init, make_train_step  # noqa: E402
from repro_torch.training import train_step as train_step_mod  # noqa: E402
from repro_torch.training.checkpoint import restore as restore_checkpoint  # noqa: E402
from repro_torch.training.data import TokenStream  # noqa: E402
from repro_torch.training.optimizer import global_norm  # noqa: E402
from repro_torch.training.train_step import loss_and_grads  # noqa: E402

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
# the published heads of llama4-scout-17b-a16e (G 5: one slice of 8 rows,
# three masked) and qwen2-vl-72b (G 8: one full slice), (Hq, Hkv, hd)
SCOUT_HEADS, QVL_HEADS = (40, 8, HD), (64, 8, HD)
# query groups past 8 (Hq, Hkv, hd): granite-34b's MQA (G 48, six slices of
# 8 rows), llama4-scout's G 5, then G 9 and G 12, whose last slice is short
GRANITE_HQ, GRANITE_HKV = 48, 1
MQA_HEADS = [(GRANITE_HQ, GRANITE_HKV, HD), SCOUT_HEADS, (9, 1, HD), (24, 2, 64)]
# phases 19b-19d: configs served at full width with their depth cut to
# what the card holds (bf16: granite-34b's 88 layers are 93.9 GB,
# llama4-scout's 48 are 215.5, qwen2-vl's 80 are 145.4), arch -> (layers,
# the cut taken if the freed card cannot hold the first one's weights,
# pool, the init's largest float32 draw and CUT_HEADROOM more)
DEPTH_CUTS = {"granite-34b": (56, 48), "llama4-scout-17b-a16e": (12, 8),
              "qwen2-vl-72b": (32, 24)}
CUT_HEADROOM = 4 << 30
# the MoE profiles' labels: the products on an expert weight, copies of
# one, and the profiler ranges around each call of ``moe._route`` and of
# ``moe.moe_apply`` (the whole layer), by the function each wraps
EXPERT_PRODUCTS = "expert products (bmm on an expert weight)"
EXPERT_COPIES = "copies of an expert weight"
ROUTE_MARK, MOE_MARK = "moe._route", "moe.moe_apply"
RANGED = {"_route": ROUTE_MARK, "moe_apply": MOE_MARK}
# phase 21b: the multimodal dense path of each at full width, 2 layers
MM_CUT_LAYERS = 2
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
# phase 23's TCP clients: SERVE_MIX's four online prompts and four offline
# questions over one shared document; the online client HANG_UP (the
# 96-token one) asks for HANG_UP_NEW tokens, far more than it reads, and
# hangs up after its HANG_UP_AFTER-th, so the server's next writes fail
# while the request still runs; and the wall seconds the CLI subprocess
# may take to come up and to drain
FRONT_DOOR_MIX = dict(SERVE_MIX, docs=1, questions=4)
HANG_UP, HANG_UP_AFTER, HANG_UP_NEW = 1, 2, 64
CLI_TIMEOUT = 300
# phases 24-29, training: the backward kernels' names in ptxas' output and
# in traces (the SSD backward's three: the dH walk, the chunk terms, the
# head groups' sum); their tolerance against the plain backwards (float32, to that
# share of the plain gradient's largest value and in relative norm); the
# train_4k shape (B 1, S 4096) and the steps of each full-width run, whose
# first step must agree with autograd of the plain scans to PLAIN_RTOL (in
# bf16, and for mamba2 on a float32 copy: bf16 rounding moves mamba2's
# gradient norm further than that, in the JAX package too, so two orders
# of float32 sums in its scans do as well; tools/bf16_spread.py);
# recurrentgemma-9b's depth, cut so its weights, gradients and AdamW moments
# (12 bytes a parameter, 45.7 GB) fit the card beside the activations; and
# the CPU-vs-card runs' steps, batch and sequence
SSD_BWD_KERNELS = ("ssd_bwd_dh_kernel", "ssd_bwd_chunk_kernel", "ssd_bwd_sum_kernel")
RGLRU_BWD_KERNEL = "rglru_bwd_ring_kernel"
BWD_TOL = 1e-5
TRAIN_SEQ, TRAIN_STEPS, PLAIN_RTOL = 4096, 12, 1e-3
R_TRAIN_LAYERS = 14
TRAIN_STEPS_PARITY, PARITY_BATCH, PARITY_SEQ = 3, 2, 32
# phases 30-31, the multi-device layer: the dry run's set at full width on
# the single-pod mesh (one subprocess each, side by side, with the (1, 1)
# mesh's counts of MESH_STEPS beside them) and its time limit; phase 31's
# prompt and decode steps after its training steps; and how far the dry
# run's peak a rank may lie from the card's measured peak for one step
DRYRUN_SET = [(a, s, False) for a in ("mamba2-1.3b", "qwen3-4b", "qwen3-moe-30b-a3b")
              for s in ("train_4k", "decode_32k")]
# ZeRO-1's record: its moments split each parameter's `model` shard over
# the data and pod ranks, and the optimizer must stay inside that shard
ZERO1_RECORD = ("granite-34b", "train_4k", True)
DRYRUN_SET.append(ZERO1_RECORD)
DRYRUN_TIMEOUT = 600
MESH_PROMPT, MESH_DECODE = 128, 8
MESH_STEPS = {"mamba2 train": ("mamba2-1.3b", TRAIN_SEQ, "train"),
              "mamba2 prefill": ("mamba2-1.3b", MESH_PROMPT, "prefill"),
              "qwen3 train": ("qwen3-4b", TRAIN_SEQ, "train")}
PEAK_RTOL = 0.05


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
def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device():
    phase("1 device")
    check(torch.cuda.is_available(), "no CUDA device (torch.cuda.is_available() is False)")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(_smi())
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
        _decode_case(gen, errs, b, _ragged_ctx(gen, b, lo, hi, nblk), f"ctx {lo}..{hi}",
                     nblk, splits, hq, hkv, hd, torch.bfloat16)
    # query groups past 8 and qwen2-vl's heads in both dtypes: B 1 up to
    # the table, B 8 at the serve's contexts, B 32 ragged up to the table
    # (a ctx-0 row), and at the heads of granite, llama4-scout and qwen2-vl
    # long context (B 2, 8192 and 5000: a full cluster)
    for dtype in (torch.bfloat16, torch.float32):
        for hq, hkv, hd in MQA_HEADS + [QVL_HEADS]:
            for b, lo, hi in ((1, 1, MAX_PAGES * BS), (8, 80, 120), (32, 1, MAX_PAGES * BS)):
                _decode_case(gen, errs, b, _ragged_ctx(gen, b, lo, hi, MAX_PAGES),
                             f"ctx {lo}..{hi}", MAX_PAGES, None, hq, hkv, hd, dtype)
        for hq, hkv, hd in ((GRANITE_HQ, GRANITE_HKV, HD), SCOUT_HEADS, QVL_HEADS):
            _decode_case(gen, errs, 2, LONG_CTX, f"ctx {LONG_CTX}", LONG_NBLK, None,
                         hq, hkv, hd, dtype)
    for hq, hkv, hd in ((HQ, HKV, HD), (HQ, CQ_HKV, HD), (HQ, G8_HKV, HD),
                        (MG_H, MG_H, MG_HD), *MQA_HEADS, QVL_HEADS):
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
    # then those of tests/test_torch_mqa.py: G 5, 9, 12 and 48
    decode_cases = [(2, 4, 4, 32, 8, 4, [32, 17]), (3, 8, 2, 64, 16, 6, [96, 5, 48]),
                    (2, 8, 1, 32, 8, 5, [40, 3]), (4, 4, 1, 16, 4, 3, [12, 1, 7, 9]),
                    (3, 10, 2, 16, 8, 5, [33, 5, 17]), (2, 9, 1, 32, 8, 4, [30, 3]),
                    (3, 12, 1, 16, 4, 6, [24, 2, 9]), (3, 48, 1, 32, 16, 6, [5, 70, 96])]
    chunked_cases = [(64, 128, 4, 2, 32, 0), (64, 128, 4, 2, 32, 37),
                     (32, 64, 2, 1, 64, 30), (100, 420, 4, 1, 32, 250),
                     (65, 131, 8, 2, 32, 66), (7, 16, 4, 4, 16, 9),
                     (64, 192, 8, 8, 32, 128),
                     (16, 64, 10, 2, 16, 20), (13, 40, 9, 1, 32, 11),
                     (24, 80, 12, 1, 16, 0), (32, 128, 48, 1, 32, 37),
                     (7, 40, 48, 1, 16, 33), (64, 512, 48, 1, 128, 448)]
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


def _ragged_ctx(gen, b, lo, hi, nblk):
    """B contexts drawn from lo..hi; a full table in the first row when hi
    is the table's width, and ctx 0 (a padded row) in the last when B > 1."""
    ctx = torch.randint(lo, hi + 1, (b,), generator=gen, device=DEV).tolist()
    if hi == nblk * BS:
        ctx[0] = hi
    if b > 1:
        ctx[-1] = 0
    return ctx


def _decode_case(gen, errs, b, ctx, what, nblk, splits, hq, hkv, hd, dtype):
    """Both decode kernels against the plain version on one input: ctx-0
    rows must come out zero, the live rows within phase 3's tolerances."""
    ins = decode_inputs(gen, b, hq, hkv, hd, BS, nblk, ctx, dtype, NUM_BLOCKS)
    live = ins[4] > 0
    want = ref.ref_paged_attention(*ins)
    for name, fn in (("paged_attention_splitk",
                      lambda *a: paged_attention_splitk(*a, num_splits=splits)),
                     ("paged_attention", paged_attention)):
        got = fn(*ins)
        check(bool((got[~live] == 0).all()), f"{name}: a ctx=0 row is not zero")
        e = compare(f"{name} {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} hd={hd} "
                    f"nblk={nblk} {what}"
                    + (f" splits={splits}" if splits and fn is not paged_attention
                       else ""), got, want, TOL["decode"][dtype], live)
        errs[name] = max(errs[name], e)


def _garbage_pages(gen):
    """tests/test_kernels.py's garbage-pages case, on both decode kernels,
    then at granite-34b's head shape (48 query heads on one kv head, six
    slices) in both dtypes: pages the table does not reference, and a table
    entry past the context pointing far outside the pool, change nothing."""
    cases = [(1, 2, 1, 16, 8, 6, [[1, 3]], [12], torch.float32)]
    cases += [(2, GRANITE_HQ, GRANITE_HKV, HD, BS, 12, [[1, 3, 5], [7, 9, 11]], [40, 20],
               dt) for dt in (torch.bfloat16, torch.float32)]
    for b, hq, hkv, hd, bs, p, table, ctx, dtype in cases:
        q = torch.randn((b, hq, hd), generator=gen, device=DEV).to(dtype)
        kp = torch.randn((p, bs, hkv, hd), generator=gen, device=DEV).to(dtype)
        vp = torch.randn((p, bs, hkv, hd), generator=gen, device=DEV).to(dtype)
        bt = torch.tensor(table, dtype=torch.int32, device=DEV)
        cl = torch.tensor(ctx, dtype=torch.int32, device=DEV)
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[0], kp2[2], vp2[4] = 999.0, -999.0, 123.0
        far = torch.cat([bt, torch.full((b, 1), 1 << 30, dtype=torch.int32,
                                        device=DEV)], 1)
        for name, fn in (("paged_attention_splitk", paged_attention_splitk),
                         ("paged_attention", paged_attention)):
            out1, out2 = fn(q, kp, vp, bt, cl), fn(q, kp2, vp2, bt, cl)
            same = bool(torch.equal(out1, out2)) and bool(
                torch.equal(out1, fn(q, kp, vp, far, cl)))
            what = f"{name} {str(dtype)[6:]} Hq={hq} Hkv={hkv} garbage-pages case"
            print(f"  {what}: output unchanged {same}")
            check(same, f"{what}: unreferenced pages reached the output")
            compare(what, out1, ref.ref_paged_attention(q, kp, vp, bt, cl),
                    TOL["decode"][dtype])


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
             f"{default_num_splits(b, hkv, nblk, BS, sms, hq // hkv)}")
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
    # batch 8 at codeqwen's MHA shape and at musicgen-medium's, and
    # granite-34b's MQA (48 query heads on one kv head), llama4-scout's
    # heads and qwen2-vl's, each at batch 8 and at long context
    def serve_ctx():
        return torch.randint(80, 121, (8,), generator=gen, device=DEV).tolist()
    rows = (_decode_rows(gen, errs, 8, serve_ctx())
            + _decode_rows(gen, errs, 32, torch.randint(
                1, MAX_PAGES * BS + 1, (32,), generator=gen, device=DEV).tolist())
            + _decode_rows(gen, errs, 2, LONG_CTX, LONG_NBLK)
            + _decode_rows(gen, errs, 8, serve_ctx(), hkv=CQ_HKV)
            + _decode_rows(gen, errs, 8, serve_ctx(), hkv=MG_H, hq=MG_H, hd=MG_HD))
    for hq, hkv, hd in ((GRANITE_HQ, GRANITE_HKV, HD), SCOUT_HEADS, QVL_HEADS):
        rows += (_decode_rows(gen, errs, 8, serve_ctx(), hkv=hkv, hq=hq, hd=hd)
                 + _decode_rows(gen, errs, 2, LONG_CTX, LONG_NBLK, hkv=hkv, hq=hq, hd=hd))
    # prefill at qwen3-4b's shape, then at codeqwen's MHA shape, at
    # musicgen-medium's, at granite-34b's MQA, llama4-scout's and qwen2-vl's
    rows += [_prefill_row(gen, errs, HKV), _prefill_row(gen, errs, CQ_HKV),
             _prefill_row(gen, errs, MG_H, hq=MG_H, hd=MG_HD),
             _prefill_row(gen, errs, GRANITE_HKV, hq=GRANITE_HQ),
             _prefill_row(gen, errs, SCOUT_HEADS[1], hq=SCOUT_HEADS[0]),
             _prefill_row(gen, errs, QVL_HEADS[1], hq=QVL_HEADS[0])]
    for r in rows:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
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
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation()}
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
        # CPU-side op rows of key_averages() carry the same device time again,
        # and a ``record_function`` range leaves a device-side annotation
        # spanning its kernels, whose id may equal a launch's
        events = prof.events()
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.id in step
               and not e.is_user_annotation]
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
        # an operator's (or a range's) device time: that of the step's
        # kernels and copies whose runtime call lies inside it
        calls = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                 and e.id in step and any(c in e.name for c in DEVICE_CALLS)]
        for label, pred in (ops or {}).items():
            hit = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and mark.start <= e.time_range.start <= mark.end
                   and pred(e.name, e.input_shapes)]
            inside = {c.id for c in calls for h in hit
                      if h.time_range.start <= c.time_range.start <= h.time_range.end}
            t = sum(e.time_range.elapsed_us() for e in dev if e.id in inside) / 1e3
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
    launches, (online, stats, wall), _ = _serve_both_schedules(model, params, SERVE_MIX)
    # what phase 23's front door is held against: the engine's own loop
    engine_loop = dict(tpot=float(np.mean([r.tpot() for r in online])),
                       iter_ms=wall / len(stats.iterations) * 1e3)
    del params
    torch.cuda.empty_cache()
    return launches, engine_loop


def _no_plain_attention(what):
    check(ref.ref_paged_attention.cuda_calls == 0
          and ref.ref_chunked_prefill_attention.cuda_calls == 0,
          f"{what} ran a plain attention on the card")


def _serve_both_schedules(model, params, mix, ops=None):
    """``mix`` through ``_serve_paged`` with split-K decode, then with the
    legacy decode kernel (``attn_impl="pallas"``); a profile of a decode
    step and a prefill chunk of the first (one split-K cluster launch a
    layer and no merge kernel in the decode step, one prefill launch a
    layer in the chunk; ``ops`` as ``_profile_steps`` takes them) and of a
    decode step of the second (one legacy launch a layer), none running a
    plain version on the card. Returns the serves' kernel launches, the
    first serve's (online, stats, wall) and its profiles."""
    layers = model.cfg.num_layers
    online, offline, eng, stats, wall = _serve_paged(model, params, "auto", mix)
    launches = {"paged_attention_splitk": paged_attention_splitk.launches,
                "chunked_prefill_attention": chunked_prefill_attention.launches}
    check(min(launches.values()) > 0, "a kernel of the path never launched")
    _print_serve(online, offline, stats, wall)
    attn = (SPLITK_DECODE, PREFILL_TC, LEGACY_DECODE, "merge")
    _reset_counts()
    traces = _profile_steps(_attention_steps(eng.runner), attn[:2], "attention kernels", ops)
    _no_plain_attention("a profiled step of the split-K serve")
    seen = {k: _launches(v, attn) for k, v in traces.items()}
    print(f"  attention launches per profiled step: {seen}; {_smi()}")
    check(all(n == layers for n in seen.values()),
          f"a profiled step launched other than one attention kernel a layer: {seen}")
    decode_trace = traces["decode B=8 ctx=101"]
    check(_launches(decode_trace, (SPLITK_DECODE,)) == layers
          and not _launches(decode_trace, ("merge",)),
          "the split-K decode step is not one cluster launch a layer")
    del eng
    torch.cuda.empty_cache()

    print("serve again with attn_impl='pallas' (legacy decode schedule)")
    on2, off2, eng, _, wall2 = _serve_paged(model, params, "pallas", mix)
    check(paged_attention_splitk.launches == 0,
          "the split-K kernel launched in the legacy-schedule serve")
    launches["paged_attention"] = paged_attention.launches
    pairs = [(a, b) for r1, r2 in zip(online + offline, on2 + off2)
             for a, b in zip(r1.output_tokens, r2.output_tokens)]
    print(f"  {wall2:.3f} s wall; online TTFT s mean "
          f"{np.mean([r.ttft() for r in on2]):.4f}, TPOT s mean "
          f"{np.mean([r.tpot() for r in on2]):.4f}; output tokens equal to the "
          f"split-K serve's: {sum(a == b for a, b in pairs)} of {len(pairs)} "
          f"({sum(a == b for a, b in pairs) / len(pairs):.1%})")
    decode = {k: fn for k, fn in _attention_steps(eng.runner).items()
              if k.startswith("decode")}
    legacy = _profile_steps(decode, (LEGACY_DECODE,), "legacy decode kernel")
    check(all(_launches(v, (LEGACY_DECODE,)) == layers for v in legacy.values()),
          f"the legacy decode step is not one {LEGACY_DECODE} a layer")
    _no_plain_attention("a profiled step of the legacy serve")
    check(paged_attention_splitk.launches == 0,
          "the split-K kernel launched in the legacy serve's profiled step")
    del eng
    torch.cuda.empty_cache()
    return launches, (online, stats, wall), traces


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


def _paged_engine(model, params, **kw):
    """A paged engine with the main path's pool and chunking on the card,
    its libraries (cuBLAS handles, kernel modules) warmed on free pages."""
    eng = EchoEngine(model, params, ECHO, num_blocks=NUM_BLOCKS, block_size=BS,
                     chunk_size=CHUNK, max_pages_per_seq=MAX_PAGES, device=DEV, **kw)
    eng.runner.prefill_chunk(list(range(CHUNK)), 0, [0, 1, 2, 3])
    eng.runner.decode([1], [[0, 1, 2, 3, 4]], [CHUNK])
    torch.cuda.synchronize()
    return eng


def _mix_requests(vocab, mix):
    """``mix``'s online and offline requests, tokens drawn from seed 0."""
    rng = np.random.default_rng(0)

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
    return online, offline


def _serve_paged(model, params, attn_impl, mix, attach=None):
    """``mix`` (``SERVE_MIX`` or ``SMALL_MIX``) through a paged engine with
    ``attn_impl``: every request finishes with its tokens inside the
    vocabulary, every decode step and prefill chunk launches its kernel
    once a layer, and no plain attention runs on the card. ``attach``, if
    given, is called with the engine before the requests go in. Returns
    (online, offline, engine, stats, wall seconds)."""
    cfg = model.cfg
    eng = _paged_engine(model, params, time_model=TimeModel.h100(), clock="wall",
                        attn_impl=attn_impl)
    vocab = cfg.vocab_size
    online, offline = _mix_requests(vocab, mix)
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
    phase("6 CPU vs CUDA token parity (tiny float32, G 2 and G 48)")
    for hq, hkv in ((4, 2), (GRANITE_HQ, GRANITE_HKV)):
        cfg = ModelConfig(name=f"tiny-dense-g{hq // hkv}", family="dense",
                          source="test", num_layers=2, d_model=64, vocab_size=128,
                          num_heads=hq, num_kv_heads=hkv, head_dim=16, d_ff=128,
                          dtype="float32", rope_theta=10_000.0)
        print(f"  {cfg.name}: Hq {hq}, Hkv {hkv}")
        _tiny_parity(cfg)


def _tiny_parity(cfg):
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
    _no_plain_attention("a tiny engine on the card")
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
    flops = ssd_fwd_flops(b, s, h, p, n, chunk)
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
        t_bound, by = bound(nbytes, rglru_mod.rglru_flops(1, s, W),
                            torch.float32)
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
    return held


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _f32_draw(cfg, params):
    """Bytes of the init's largest float32 draw: the (vocab, d) embedding,
    or one layer of the largest stacked weight of ``params`` (the weights
    or ``Model.param_specs()``)."""
    return 4 * max([cfg.vocab_size * cfg.d_model]
                   + [t[0].numel() for t in tree_leaves(params["layers"])])


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
    temp = _f32_draw(cfg, params)
    print(f"init: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
          f"Hq={cfg.num_heads} Hkv={cfg.num_kv_heads} hd={cfg.head_dim} "
          f"vocab={cfg.vocab_size} {cfg.dtype}, "
          f"{sum(t.numel() for t in tree_leaves(params)):,} params, "
          f"{weights / 1e9:.2f} GB, KV {model.cache_bytes(1, 1):,} B a token, "
          f"in {time.perf_counter() - t0:.1f} s; init peak over the weights "
          f"{over / 1e6:.1f} MB (largest float32 temporary {temp / 1e6:.1f} MB)")
    check(over <= temp + (64 << 20), "the init held more than one float32 temporary")
    return model, params


@contextlib.contextmanager
def _moe_ranged():
    """While the block runs, ``moe.moe_apply`` and ``moe._route`` each run
    inside a profiler range (``MOE_MARK``, ``ROUTE_MARK``), so a MoE
    profile can sum the device time of the layer and of its routing."""
    from torch.profiler import record_function
    saved = {name: getattr(moe, name) for name in RANGED}

    def ranged(name, fn):
        def call(*args):
            with record_function(RANGED[name]):
                return fn(*args)
        return call
    for name, fn in saved.items():
        setattr(moe, name, ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)


def _moe_ops(cfg):
    """``_profile_steps``' ops for a MoE model (under ``_moe_ranged``): the
    three batched products on a stored expert weight, (E, d, ff) or (E, ff,
    d); copies of an expert weight; ``_route``; and the whole layer."""
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff

    def expert(shape):
        return list(shape) in ([e, d, ff], [e, ff, d])
    return {EXPERT_PRODUCTS:
            lambda name, shapes: name == "aten::bmm" and any(map(expert, shapes)),
            EXPERT_COPIES:
            lambda name, shapes: name in ("aten::copy_", "aten::clone", "aten::contiguous",
                                          "aten::_to_copy") and any(map(expert, shapes)),
            ROUTE_MARK: lambda name, shapes: name == ROUTE_MARK,
            MOE_MARK: lambda name, shapes: name == MOE_MARK}


def _moe_profile(cfg, traces):
    """In each profiled step of a MoE serve, traced with ``_moe_ops``: the
    rate of the expert products (the dense dispatch reads every expert of
    every layer each step), ``_route``'s time and the rest of the layer
    (the dispatch into and the combine out of the expert slots, the
    shared expert); fails unless the step ran three expert products, one
    ``_route`` and one MoE layer a layer, and copied no expert weight."""
    layers = cfg.num_layers
    expert_bytes = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * 2 * layers
    for name, by_name in traces.items():
        ms, calls = by_name[("op", EXPERT_PRODUCTS)]
        route_ms, routes = by_name[("op", ROUTE_MARK)]
        moe_ms, applies = by_name[("op", MOE_MARK)]
        print(f"  {name}: expert products read {expert_bytes / 1e9:.2f} GB in {ms:.3f} ms "
              f"({expert_bytes / max(ms, 1e-9) / 1e9:.2f} TB/s; bound "
              f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s); "
              f"_route {route_ms:.3f} ms; the MoE layers {moe_ms:.3f} ms, of which "
              f"{moe_ms - ms - route_ms:.3f} ms neither")
        check(calls == 3 * layers, f"{name}: {calls} expert products, not 3 a layer")
        check(routes == applies == layers,
              f"{name}: {routes} _route and {applies} moe_apply calls, not one a layer")
        check(by_name[("op", EXPERT_COPIES)][1] == 0, f"{name}: an expert weight was copied")


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
    attn = (SPLITK_DECODE, PREFILL_TC)
    with _moe_ranged():
        traces = _profile_steps(_attention_steps(eng.runner), attn, "attention kernels",
                                _moe_ops(cfg))
    for name, by_name in traces.items():
        check(_launches(by_name, attn) == cfg.num_layers,
              f"{name}: not one attention launch a layer")
    _moe_profile(cfg, traces)
    del eng
    torch.cuda.empty_cache()
    return model, params


def _top_gap(gates, k):
    """The smallest gap between consecutive ones of each row's k + 1
    largest gates, in float64: the margin of the k argmax choices."""
    top = gates.double().sort(-1, descending=True).values[..., :k + 1]
    return float((top[..., :-1] - top[..., 1:]).min())


def phase_moe_layer(model, params, tag="17"):
    """Layer 0's router and experts (and shared expert, if the model has
    one), upcast to float32 (qwen3-moe-30b-a3b's 2.4 GB, llama4-scout's
    8.6 GB on each side), on the card (TF32 off) and on the CPU."""
    phase(f"{tag} one full-width {model.cfg.name} MoE layer: card against CPU (float32)")
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


def _depth_cut(arch):
    """``arch`` at full width with its depth cut for phases 19b-19d: the
    first of ``DEPTH_CUTS[arch]`` if the card, with earlier phases' memory
    released, holds its weights, the pool, the init's largest float32 draw
    and ``CUT_HEADROOM``; else the fallback. Returns (config, why)."""
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    layers, fallback = DEPTH_CUTS[arch]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = Model(cfg)
    specs = model.param_specs()
    need = (_nbytes(specs) + _f32_draw(cfg, specs) + CUT_HEADROOM
            + model.cache_bytes(1, 1) * BS * NUM_BLOCKS)
    if free >= need:
        return cfg, f"{free / 1e9:.2f} GB free, {need / 1e9:.2f} GB needed"
    return (dataclasses.replace(cfg, num_layers=fallback),
            f"{free / 1e9:.2f} GB free, under the {need / 1e9:.2f} GB {layers} layers need")


def phase_serve_cut(tag, arch):
    """``arch`` at full width, its depth cut by ``_depth_cut``, through
    EchoEngine with both decode schedules and phase 19's mix; for a MoE
    model the split-K serve's profiles also time the expert products and
    ``_route`` (``_moe_profile``). Returns the model, its weights and the
    split-K, legacy and prefill launches of its serves."""
    t0 = time.perf_counter()
    cfg, why = _depth_cut(arch)
    cut = (f"depth cut to {cfg.num_layers} layers" if cfg.num_layers == DEPTH_CUTS[arch][0]
           else f"depth cut to {cfg.num_layers} layers ({why})")
    phase(f"{tag} serve {arch} at full width, {cut}")
    print(f"  depth: {why}")
    _free_card(f"the {arch} init")
    model, params = _init_full_width(cfg)
    g = cfg.num_heads // cfg.num_kv_heads
    print(f"  G {g} ({cfg.num_heads} query heads on {cfg.num_kv_heads} kv head"
          f"{'s' if cfg.num_kv_heads > 1 else ''}, {group_slices(g)} slice"
          f"{'s' if group_slices(g) > 1 else ''} of 8 a decode CTA); pool {NUM_BLOCKS} "
          f"blocks x {BS} tokens = "
          f"{model.cache_bytes(1, 1) * BS * NUM_BLOCKS / 1e9:.2f} GB")
    moe_ops = _moe_ops(cfg) if cfg.num_experts else None
    with _moe_ranged():
        launches, _, traces = _serve_both_schedules(model, params, SMALL_MIX, moe_ops)
    if moe_ops:
        _moe_profile(cfg, traces)
    print(f"  (split-K, legacy, prefill) launches: ({launches['paged_attention_splitk']}, "
          f"{launches['paged_attention']}, {launches['chunked_prefill_attention']})")
    # the runner copies each step's float32 logits to the host
    for name, by_name in traces.items():
        copies = [(t, n) for k, (t, n) in by_name.items()
                  if isinstance(k, str) and "DtoH" in k]
        rows = 8 if name.startswith("decode") else 1
        print(f"  {name}: device-to-host copies {sum(t for t, _ in copies):.3f} ms over "
              f"{sum(n for _, n in copies)} (the logits: {rows} x {cfg.vocab_size} "
              f"float32, {rows * cfg.vocab_size * 4 / 1e6:.2f} MB)")
    print(f"  phase {tag}: {time.perf_counter() - t0:.1f} s wall")
    return model, params, launches


def phase_serve_granite():
    """granite-34b at full width, its depth cut, through EchoEngine with
    both decode schedules. Returns the split-K, legacy and prefill launches
    of its serves."""
    model, params, launches = phase_serve_cut("19b", "granite-34b")
    del params, model
    torch.cuda.empty_cache()
    return launches


def phase_serve_scout():
    """llama4-scout-17b-a16e at full width, its depth cut. Returns the
    model and its weights, which phase 17b takes a layer of."""
    model, params, _ = phase_serve_cut("19c", "llama4-scout-17b-a16e")
    return model, params


def phase_serve_qwen2_vl():
    """qwen2-vl-72b at full width, its depth cut. Serving passes three
    equal M-RoPE rows, which is plain RoPE; phase 21b holds the sections."""
    model, params, _ = phase_serve_cut("19d", "qwen2-vl-72b")
    del params, model
    torch.cuda.empty_cache()


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


def _dense_frames(model, params, positions=None):
    """``Model.prefill`` of MM_S tokens whose first MM_FRAMES positions are
    conditioning frames, ``pad_cache`` and MM_STEPS decode steps, in bf16
    against a float32 copy of the weights (bf16 upcast exactly, TF32 off):
    within DENSE_REL_LIMIT, and the frames move the float32 logits by more
    than the bf16 gap. ``positions`` (3, 1, MM_S), M-RoPE rows, go to both
    prefills with frames, and must move the float32 logits by more than
    the bf16 gap too."""
    cfg = model.cfg
    toks, mm = _mm_inputs(cfg, 1, MM_S, MM_FRAMES, 3, DEV)
    kw = {} if positions is None else dict(positions=positions.to(DEV))
    model32 = Model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last16, cache16 = model.prefill(params, toks, mm, **kw)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        bare16, _ = model.prefill(params, toks)
        last32, cache32 = model32.prefill(params32, toks, mm, **kw)
        bare32, _ = model32.prefill(params32, toks)
        flat32 = model32.prefill(params32, toks, mm)[0] if kw else None
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
    print(f"  Model.prefill S={MM_S} with {MM_FRAMES} frames of {cfg.mm_embed_dim}"
          f"{' and three M-RoPE rows' if kw else ''}, bf16: {t_prefill * 1e3:.1f} ms wall; "
          f"last logits against the float32 copy rel_err={d_mm:.3e} (without frames "
          f"{d_bare:.3e}), argmax agree "
          f"{int(torch.argmax(last16)) == int(torch.argmax(last32))}; limit "
          f"{DENSE_REL_LIMIT}")
    print(f"  the frames move the float32 last logits by rel {moved:.3e} "
          f"(limit: more than the bf16 rounding {d_mm:.3e})")
    print(f"  pad_cache, {MM_STEPS} decode steps: logits finite {finite}; rel_err "
          f"against float32 per step: {', '.join(f'{e:.3e}' for e in steps)}")
    check(finite, f"{cfg.name}: non-finite multimodal logits")
    check(max([d_mm, d_bare] + steps) < DENSE_REL_LIMIT,
          f"{cfg.name}: the bf16 dense path strays from its float32 copy")
    check(moved > d_mm, f"{cfg.name}: the conditioning frames do not move the logits")
    if kw:
        rows = _rel(last32[0], flat32[0])
        print(f"  M-RoPE sections {cfg.mrope_sections}: the three distinct rows move the "
              f"float32 last logits by rel {rows:.3e} against one row (limit: more "
              f"than the bf16 rounding {d_mm:.3e})")
        check(rows > d_mm, f"{cfg.name}: the M-RoPE rows do not move the logits")


def phase_dense_multimodal(model, params):
    phase("21 the multimodal dense path")
    _dense_frames(model, params)

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


def phase_dense_cut():
    """The dense path with frames of llama4-scout-17b-a16e and qwen2-vl-72b
    at full width, each on a fresh MM_CUT_LAYERS-layer cut (its bf16
    weights and their float32 copy: about 39 and 26 GB); qwen2-vl's also
    with three distinct M-RoPE rows through its sections."""
    t0 = time.perf_counter()
    phase(f"21b the multimodal dense path at full width, depth cut to {MM_CUT_LAYERS} layers")
    for arch in ("llama4-scout-17b-a16e", "qwen2-vl-72b"):
        _free_card(f"the {arch} {MM_CUT_LAYERS}-layer init")
        model, params = _init_full_width(
            dataclasses.replace(get_config(arch), num_layers=MM_CUT_LAYERS))
        _dense_frames(model, params,
                      _mrope_rows(1, MM_S) if model.cfg.mrope_sections else None)
        del model, params
        torch.cuda.empty_cache()
    print(f"  phase 21b: {time.perf_counter() - t0:.1f} s wall")


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


# ------------------------------------------------------------------ front door
def _replay_equals_drive(model, params):
    """``SERVE_MIX`` through ``EchoService.drive`` on one engine and through
    ``AsyncEchoEngine`` on a paused ``ManualClock`` (explicit arrival stamps)
    on another that shares the weights: request by request the same tokens
    and engine-domain finish times, every step through the kernels."""
    vocab = model.cfg.vocab_size
    eng_a = _paged_engine(model, params, time_model=TimeModel.h100())
    online_a, offline_a = _mix_requests(vocab, SERVE_MIX)
    t0 = time.perf_counter()
    EchoService(eng_a).drive(online_a + offline_a, max_iters=5000)
    t_drive = time.perf_counter() - t0
    eng_b = _paged_engine(model, params, time_model=TimeModel.h100())
    online_b, offline_b = _mix_requests(vocab, SERVE_MIX)
    rt = AsyncEchoEngine(eng_b, clock=ManualClock())

    async def replay():
        async with rt:
            hs = [await rt.submit_request(r) for r in online_b + offline_b]
            return [await h.result() for h in hs]
    _reset_counts()
    t0 = time.perf_counter()
    results = asyncio.run(replay())
    t_replay = time.perf_counter() - t0
    chunks = sum(rec.n_prefill for rec in eng_b.stats.iterations)
    steps = sum(1 for rec in eng_b.stats.iterations if rec.n_decode)
    layers = model.cfg.num_layers
    print(f"  drive {len(eng_a.stats.iterations)} iterations in {t_drive:.3f} s wall; "
          f"the async replay {len(eng_b.stats.iterations)} in {t_replay:.3f} s "
          f"({rt.stats.hops} hops); launches split-K "
          f"{paged_attention_splitk.launches} ({layers} x {steps} decode steps), "
          f"prefill {chunked_prefill_attention.launches} ({layers} x {chunks} chunks)")
    check(paged_attention_splitk.launches == layers * steps > 0
          and chunked_prefill_attention.launches == layers * chunks > 0
          and ref.ref_paged_attention.cuda_calls == 0
          and ref.ref_chunked_prefill_attention.cuda_calls == 0,
          "the replay did not attend through both kernels once a layer a step")
    want = online_a + offline_a
    for res, ref_req in zip(results, want):
        check(res.status is HandleStatus.FINISHED and ref_req.done,
              f"request {ref_req.rid}: {res.status.value} through the front door")
        check(res.tokens == list(ref_req.output_tokens),
              f"request {ref_req.rid}: front-door tokens differ from the drive's")
        check(res.finish_time == ref_req.finish_time,
              f"request {ref_req.rid}: finish {res.finish_time} != {ref_req.finish_time}")
    leaks = rt.kv_leaks()
    check(not any(leaks.values()), f"the replay leaked: {leaks}")
    print(f"  {len(results)} requests: tokens and engine-domain finish times equal to "
          f"the drive's; kv leaks after drain: none")
    del eng_a, eng_b, rt
    gc.collect()
    torch.cuda.empty_cache()


async def _client(host, port, prompt, max_new, task, hang_up_after=None):
    """One connection: send a request, read token lines until ``done`` or,
    with ``hang_up_after``, close after that many tokens. Returns the token
    lines and the done line (None when it hung up)."""
    reader, writer = await asyncio.open_connection(host, port)
    spec = {"prompt": list(prompt), "max_new_tokens": max_new, "task_type": task}
    if task == "online":
        spec["slo"] = [2.0, 0.5]
    writer.write(json.dumps(spec).encode() + b"\n")
    await writer.drain()
    tokens, done = [], None
    try:
        while done is None:
            line = await reader.readline()
            if not line:
                raise ConnectionError("server closed mid-stream")
            obj = json.loads(line)
            if obj.get("done"):
                done = obj
            else:
                tokens.append(obj)
                if hang_up_after is not None and len(tokens) == hang_up_after:
                    break
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass
    return tokens, done


def _tcp_serve(model, params, tm, engine_loop):
    """A wall-clock engine behind ``EchoServer`` on loopback with the probe
    and a tracer attached; eight concurrent clients, one hanging up."""
    vocab = model.cfg.vocab_size
    eng = _paged_engine(model, params, time_model=tm, clock="wall")
    rt = AsyncEchoEngine(eng)
    registry = rt.instrument(MetricsRegistry(), Tracer())
    aborted = []
    rt.events.on_abort(aborted.append)
    hops = []                          # (enter, leave) of each worker hop
    step_hop = rt._step_hop

    def timed_hop():
        t_in = time.perf_counter()
        out = step_hop()
        hops.append((t_in, time.perf_counter()))
        return out
    rt._step_hop = timed_hop
    online, offline = _mix_requests(vocab, FRONT_DOOR_MIX)

    async def serve():
        await rt.start()
        srv = await EchoServer(rt, port=0).start()
        host, port = srv.address
        clients = [_client(host, port, r.prompt, r.max_new_tokens, "online")
                   if i != HANG_UP else
                   _client(host, port, r.prompt, HANG_UP_NEW, "online", HANG_UP_AFTER)
                   for i, r in enumerate(online)]
        clients += [_client(host, port, r.prompt, r.max_new_tokens, "offline")
                    for r in offline]
        out = await asyncio.gather(*clients)
        await srv.close()
        return out, srv
    _reset_counts()
    t0 = time.perf_counter()
    out, srv = asyncio.run(serve())
    wall = time.perf_counter() - t0
    launches = {"paged_attention_splitk": paged_attention_splitk.launches,
                "chunked_prefill_attention": chunked_prefill_attention.launches}
    print(f"  {len(out)} clients over loopback in {wall:.3f} s wall: "
          f"{srv.requests_served} requests served over {srv.connections} connections; "
          f"launches {launches}")
    check(min(launches.values()) > 0 and ref.ref_paged_attention.cuda_calls == 0
          and ref.ref_chunked_prefill_attention.cuda_calls == 0,
          "the TCP serve did not attend through both kernels only")
    finished = {"online": [], "offline": []}
    for i, (tokens, done) in enumerate(out):
        kind = "online" if i < len(online) else "offline"
        if i == HANG_UP:
            check(done is None and len(tokens) == HANG_UP_AFTER,
                  f"the hanging-up client read {len(tokens)} tokens, done={done}")
            continue
        want = (online + offline)[i].max_new_tokens
        check(done is not None and done["status"] == "finished"
              and len(tokens) == done["n_tokens"] == want
              and [t["index"] for t in tokens] == list(range(want)),
              f"client {i} ({kind}): {len(tokens)} token lines of {want}, done={done}")
        finished[kind].append(done)
    check(srv.requests_served == len(out) - 1, "a request was not served")
    check(rt.stats.aborted == 1 and len(aborted) == 1, "the hang-up did not abort")
    victim = aborted[0].request
    check(victim.block_ids == [] and victim.n_output >= HANG_UP_AFTER,
          f"the aborted request kept {len(victim.block_ids)} blocks")
    leaks = rt.kv_leaks()
    check(not any(leaks.values()), f"the TCP serve leaked after drain: {leaks}")
    first = registry.get("rt_ttft_wall_seconds").labels().count
    check(first == len(out), f"rt_ttft_wall_seconds counted {first} first tokens, "
          f"not the {len(out)} requests' (the hang-up's included)")
    for kind, dones in finished.items():
        ttft = [d["ttft_wall"] for d in dones]
        tpot = [d["tpot_wall"] for d in dones]
        print(f"  {kind}: {len(dones)} finished; wall TTFT s mean {np.mean(ttft):.4f} "
              f"max {np.max(ttft):.4f}; wall TPOT s mean {np.mean(tpot):.4f} "
              f"max {np.max(tpot):.4f}")
    st = rt.stats
    print(f"  RTStats: steps {st.steps}, hops {st.hops}, peak live {st.peak_live}, "
          f"finished {st.finished}, aborted {st.aborted}, shed {st.shed}; the "
          f"aborted request freed its blocks at {victim.n_output} tokens")
    inside = [b - a for a, b in hops]
    between = [b[0] - a[1] for a, b in zip(hops, hops[1:])]
    print(f"  hop: {len(hops)} hops, worker {np.mean(inside) * 1e3:.2f} ms mean inside "
          f"(engine.step), {np.mean(between) * 1e3:.3f} ms mean between hops on the "
          f"loop (median {np.median(between) * 1e3:.3f}); phase 5's engine loop "
          f"{engine_loop['iter_ms']:.2f} ms an iteration")
    tpot_on = float(np.mean([d["tpot_wall"] for d in finished["online"]]))
    print(f"  online wall TPOT: front door {tpot_on:.4f} s, phase 5's engine loop "
          f"{engine_loop['tpot']:.4f} s ({tpot_on / engine_loop['tpot'] - 1:+.1%})")
    del eng, rt
    gc.collect()
    torch.cuda.empty_cache()


def _cli_on_card():
    """``python -m repro_torch.launch.serve`` as a user runs it, on the card
    (reduced qwen3-4b, ``--device`` left at cuda): the TCP front door with
    three requests and SIGINT, then the trace replay."""
    root = Path(__file__).resolve().parent
    # unbuffered: the listening line must reach the pipe while it serves
    env = dict(os.environ, PYTHONPATH=str(root / "src"), PYTHONUNBUFFERED="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + ["--serve", "--port", "0", "--arch", "qwen3-4b"],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(CLI_TIMEOUT, proc.kill)
    watchdog.start()
    try:
        head = []
        for line in proc.stdout:
            head.append(line.rstrip())
            found = re.search(r"listening on ([\d.]+):(\d+)", line)
            if found:
                break
        check(found is not None, f"the CLI never listened: {head} "
              f"{proc.stderr.read()[-2000:] if proc.poll() is not None else ''}")
        host, port = found.group(1), int(found.group(2))
        print(f"  the CLI listened {time.perf_counter() - t0:.1f} s after its start")

        async def three():
            return await asyncio.gather(*[
                request_once(host, port, [1, 2, 3 + i] * 8, max_new_tokens=8)
                for i in range(3)])
        outs = asyncio.run(three())
        proc.send_signal(signal.SIGINT)
        rest, err = proc.communicate(timeout=CLI_TIMEOUT)
    finally:
        watchdog.cancel()
        proc.kill()
    text = "\n".join(head) + "\n" + rest
    for line in text.splitlines():
        print(f"  cli> {line}")
    check(proc.returncode == 0, f"the CLI exited {proc.returncode}: {err[-2000:]}")
    check(all(o["status"] == "finished" and len(o["tokens"]) == 8 for o in outs),
          f"the CLI's answers: {outs}")
    check(any(ln.startswith("link calibrated on") for ln in head),
          "the CLI printed no applied link calibration")
    check("kv leaks after drain: none" in rest and "served 3 requests" in rest,
          "the CLI did not drain three requests without leaks")
    replay = subprocess.run(cmd + ["--arch", "qwen3-4b", "--duration", "2", "--n-docs", "1",
                                   "--questions", "2"], cwd=root, env=env,
                            capture_output=True, text=True, timeout=CLI_TIMEOUT)
    for line in replay.stdout.splitlines():
        print(f"  cli> {line}")
    found = re.search(r"online finished: (\d+)/(\d+)", replay.stdout)
    check(replay.returncode == 0 and found and found.group(1) == found.group(2),
          f"the CLI replay: rc {replay.returncode}, {replay.stderr[-2000:]}")


def phase_front_door(engine_loop):
    """The real-time front door on full-width qwen3-4b: the link
    calibration, the async loop against the replay, the TCP server on the
    wall clock, and the CLI."""
    phase("23 the real-time front door on qwen3-4b at full width")
    t_phase = time.perf_counter()
    _free_card("the qwen3-4b init")
    tm = TimeModel.h100()
    cal = calibrate_link(tm, device=DEV)
    print(f"  {cal.summary()}; {_smi()}")
    by_size = {}
    for i, (n, t) in enumerate(cal.samples):
        by_size.setdefault(n, ([], []))[i % 2].append(t)
    for n, (up, down) in by_size.items():
        print(f"    {n >> 10} KiB: host to device {n / np.median(up) / 1e9:.2f} GB/s "
              f"({', '.join(f'{t * 1e6:.0f}' for t in up)} us), device to host "
              f"{n / np.median(down) / 1e9:.2f} GB/s "
              f"({', '.join(f'{t * 1e6:.0f}' for t in down)} us)")
    print("    under a 512x512 float32 product: "
          + ", ".join(f"{n >> 10} KiB {t * 1e6:.0f} us" for _, n, t in cal.overlap_samples)
          + f" (the product alone {cal.overlap_samples[0][0] * 1e6:.0f} us)")
    check(cal.applied, f"link calibration not applied: {cal.error}")
    check(0.5 <= cal.bandwidth_gbs <= 100.0,
          f"fitted link {cal.bandwidth_gbs:.2f} GB/s outside 0.5-100")
    model = Model(get_config("qwen3-4b"))
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    print("  the front door against the replay (ManualClock, two engines on one "
          "copy of the weights)")
    _replay_equals_drive(model, params)
    print("  TCP on loopback, wall clock")
    _tcp_serve(model, params, tm, engine_loop)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print("  the CLI on the card")
    _cli_on_card()
    print(f"  phase 23: {time.perf_counter() - t_phase:.1f} s wall")


# ------------------------------------------------------------------ training
def _bwd_compare(name, got, want):
    """A backward kernel's gradient against its plain backward (float32):
    elementwise to BWD_TOL of the plain gradient's largest value, and in
    relative norm to BWD_TOL."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name}: shape {tuple(got.shape)} or non-finite values")
    scale = float(want.abs().max().clamp_min(1e-30))
    err = float((got - want).abs().max())
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want).clamp_min(1e-30))
    ok = err <= BWD_TOL * scale and rel < BWD_TOL
    print(f"  {name}: max_abs_err={err:.3e} (of max {scale:.3e}) rel_err={rel:.3e} "
          f"tol={BWD_TOL:g} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: the backward kernel disagrees with its plain backward")
    return err


def _no_spills(lib, kern):
    """ptxas' report of ``kern`` in ``lib``'s build: no spill stores or loads."""
    entry, found = "", []
    for line in build.build_log[lib].splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "spill stores" in line and kern in entry:
            found.append(line.strip())
    if not build.build_log[lib]:
        print(f"  {kern}: spill check skipped (library from the build cache)")
        return
    spilled = [x for x in found if " 0 bytes spill stores, 0 bytes spill loads" not in x]
    print(f"  {kern}: {len(found)} instantiations, {len(spilled)} spilling")
    check(found and not spilled, f"{kern}: no ptxas report, or spills: {spilled}")


def _sass_tensor_core(lib, kernels):
    """``cuobjdump -sass`` of ``lib``'s library: each of ``kernels``' HMMA
    (tensor-core) and FFMA instructions; fails unless every kernel but the
    last (the sum, which multiplies nothing) has HMMA instructions."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build._target(lib))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, fn = {k: {"HMMA": 0, "FFMA": 0} for k in kernels}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = next((k for k in kernels if k in line), None)
        elif fn:
            for op in ("HMMA", "FFMA"):
                counts[fn][op] += op in line
    print(f"  {lib} SASS: " + ", ".join(f"{k} {v['HMMA']} HMMA, {v['FFMA']} FFMA"
                                         for k, v in counts.items()))
    check(all(counts[k]["HMMA"] for k in kernels[:-1]),
          f"{lib}: a product kernel without tensor-core instructions: {counts}")


def _ssd_padded(x, dta, bm, cm, pad):
    """The last ``pad`` steps as ``ssm_context`` pads a sequence to a chunk
    multiple: dt = 0 (decay 1) and zero x, B and C."""
    for t in (x, dta, bm, cm):
        t[:, t.shape[1] - pad:] = 0.0


def phase_backward_kernels(gen):
    """Returns the timing rows of the two backward kernels."""
    phase("24 backward kernels vs plain backwards (float32)")
    _no_spills("rglru_scan_bwd", RGLRU_BWD_KERNEL)
    for kern in SSD_BWD_KERNELS:
        _no_spills("ssd_scan_bwd", kern)
    _sass_tensor_core("ssd_scan_bwd", SSD_BWD_KERNELS)
    rg_err = 0.0
    # (b, s, w, offset): recurrentgemma's training shape (S 4096), S 4000
    # (a partial last slab), short S, ragged channel tiles, and a view one
    # element into its buffer; a from the model's gate
    for b, s, w, offset in [(1, 4096, W, 0), (1, 4000, W, 0), (2, 300, W, 0),
                            (1, 37, W, 0), (1, 300, 4104, 0), (1, 128, W, 1)]:
        a, bb = rglru_inputs(gen, b, s, w)
        g = torch.randn((b, s, w), generator=gen, device=DEV)
        if offset:
            a = torch.cat([a.new_zeros(offset), a.flatten()])[offset:].view(b, s, w)
            check(a.data_ptr() % 16 != 0, "the offset view is aligned")
        h = rglru_scan(a, bb)
        got = rglru_mod.rglru_scan_bwd(a, h, g)
        want = ref.ref_rglru_scan_bwd(a, h, g)
        for what, x, y in zip(("da", "db"), got, want):
            rg_err = max(rg_err, _bwd_compare(
                f"rglru_bwd b={b} s={s} w={w}{' offset 1' if offset else ''} {what}", x, y))
    ssd_err = 0.0
    # the sweep, mamba2's training shape, a padded S, batch 2 (a grid over
    # batch), chunk 32 at mamba2's widths and 12 heads (a short last group)
    cases = [(2, 64, 2, 8, 4, 16, 0), (1, 128, 4, 16, 8, 32, 0), (3, 32, 1, 4, 16, 16, 0),
             (1, TRAIN_SEQ, SSD_H, SSD_P, SSD_N, M_BLOCK, 0),
             (1, TRAIN_SEQ - M_BLOCK, SSD_H, SSD_P, SSD_N, M_BLOCK, 32),
             (2, 512, SSD_H, SSD_P, SSD_N, M_BLOCK, 0), (1, 1024, SSD_H, SSD_P, SSD_N, 32, 0),
             (1, 256, 12, SSD_P, SSD_N, M_BLOCK, 0)]
    for b, s, h, p, n, chunk, pad in cases:
        for slow in (False, True):
            x, dta, bm, cm, _ = ssd_inputs(gen, b, s, h, p, n, slow)
            _ssd_padded(x, dta, bm, cm, pad)
            y, final, states = ssd_scan(x, dta, bm, cm, chunk=chunk, return_all_states=True)
            dy, dfinal = torch.randn_like(y), torch.randn_like(final)
            dy[:, s - pad:] = 0.0
            got = ssd_mod.ssd_scan_bwd(x, dta, bm, cm, chunk, states, dy, dfinal)
            want = ssd_mod.ssd_chunked_bwd(x, dta, bm, cm, chunk, states, dy, dfinal)
            tag = (f"ssd_bwd b={b} s={s}{f' ({s - pad} padded)' if pad else ''} h={h} p={p} "
                   f"n={n} chunk={chunk}{' slow-decay' if slow else ''}")
            for what, gg, ww in zip(("dx", "d dt_a", "dB", "dC"), got, want):
                ssd_err = max(ssd_err, _bwd_compare(f"{tag} {what}", gg, ww))
    rows = []
    a, bb = rglru_inputs(gen, 1, TRAIN_SEQ, W)
    h = rglru_scan(a, bb)
    g = torch.randn_like(h)
    nbytes = 5 * 4 * TRAIN_SEQ * W                 # a, h, g in; da, db out
    t_bound, by = bound(nbytes, rglru_mod.rglru_bwd_flops(1, TRAIN_SEQ, W), torch.float32)
    rows.append(dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
        replaces="port-only: the JAX package differentiates its XLA associative scan "
                 "(src/repro/models/rglru.py:66)",
        shape=f"B=1 S={TRAIN_SEQ} W={W} f32",
        ms=time_ms(lambda: rglru_mod.rglru_scan_bwd(a, h, g)),
        plain_ms=time_ms(lambda: ref.ref_rglru_scan_bwd(a, h, g), iters=5, warmup=1),
        library_ms=None, bound_ms=t_bound, bound_by=by, max_abs_err=rg_err))
    b, s, hh, p, n, chunk = 1, TRAIN_SEQ, SSD_H, SSD_P, SSD_N, M_BLOCK
    x, dta, bm, cm, _ = ssd_inputs(gen, b, s, hh, p, n)
    y, final, states = ssd_scan(x, dta, bm, cm, chunk=chunk, return_all_states=True)
    dy, dfinal = torch.randn_like(y), torch.randn_like(final)

    def bwd():
        return ssd_mod.ssd_scan_bwd(x, dta, bm, cm, chunk, states, dy, dfinal)
    same = [torch.equal(u, v) for u, v in zip(bwd(), bwd())]
    print(f"  ssd_bwd determinism [B={b} S={s}]: two launches on the same inputs "
          f"bitwise equal in dx, d dt_a, dB, dC: {same}")
    check(all(same), "two launches of the SSD backward on the same inputs differ")
    sbytes, flops, wide = ssd_bwd_work(b, s, hh, p, n, chunk)
    s_bound, s_by = bound(sbytes, flops, torch.float32)
    rows.append(dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        replaces="port-only: the JAX package differentiates its XLA ssd_chunked "
                 "(src/repro/models/ssm.py:61)",
        shape=f"B={b} S={s} H={hh} P={p} N={n} chunk={chunk} f32",
        ms=time_ms(bwd, iters=10),
        plain_ms=time_ms(lambda: ssd_mod.ssd_chunked_bwd(x, dta, bm, cm, chunk, states, dy,
                                                         dfinal), iters=10),
        library_ms=None, bound_ms=s_bound, bound_by=s_by, max_abs_err=ssd_err))
    # the same products on the tensor cores in 3xTF32, as the forward's row
    # states it: three TF32 products each (495 TFLOP/s dense, NVIDIA data sheet)
    tc_bound = max((sbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                   (3 * flops / 495e12 * 1e3, "operations"))
    wide_f32, wide_tc = bound(sbytes, wide, torch.float32)[0], 3 * wide / 495e12 * 1e3
    tc = (f"; tensor-core bound {tc_bound[0]:.4f} ms ({tc_bound[1]}: 3 x {flops / 1e9:.3f} "
          f"GFLOP at 495 TFLOP/s TF32), kernel at {rows[1]['ms'] / tc_bound[0]:.2f} x it; "
          f"the wider count (W D products per head, H0 C formed) {wide / 1e9:.3f} GFLOP: "
          f"bounds {wide_f32:.4f} ms float32, {wide_tc:.4f} ms tensor-core, kernel at "
          f"{rows[1]['ms'] / wide_f32:.2f} x and {rows[1]['ms'] / wide_tc:.2f} x them")
    for r, work in zip(rows, (f"{nbytes / 1e6:.2f} MB", f"{sbytes / 1e6:.2f} MB, "
                              f"{flops / 1e9:.3f} GFLOP")):
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {work}; float32), kernel at "
              f"{r['ms'] / r['bound_ms']:.2f} x it{tc if r is rows[1] else ''}; plain "
              f"{r['plain_ms']:.4f} ms, library none (no single PyTorch call computes "
              f"the scan's adjoint); {_smi()}")
    _ssd_bwd_launches(bwd, ssd_bwd_design_bytes(b, s, hh, p, n, chunk), sbytes)
    _ssd_forward_train_shape(gen)
    torch.cuda.synchronize()
    return rows


def ssd_bwd_design_bytes(b, s, h, p, n, chunk):
    """Bytes the backward kernel's own design moves, by launch, each array
    counted once per launch that reads or writes it: the walk reads dt_a, C,
    dy and dfinal and writes dh_end (B,S/L,H,P,N); the chunk terms read x,
    dt_a, B, C, the states, dy and dh_end and write dx, d dt_a and the head
    groups' dB and dC partials; their sum reads the partials and writes dB
    and dC. Not the bound's count (``ssd_bwd_work``), which has no dh_end
    and no partials."""
    plan = ssd_mod.ssd_bwd_plan(b, s, h, p, n, chunk)
    state = int(np.prod(plan.dh_end))
    part = 2 * int(np.prod(plan.partials))
    walk = b * s * h + b * s * n + b * s * h * p + b * h * p * n + state
    body = 3 * b * s * h * p + 2 * b * s * h + 2 * b * s * n + 2 * state + part
    total = part + 2 * b * s * n
    return {"walk": 4 * walk, "chunk terms": 4 * body, "sum": 4 * total}


def _ssd_bwd_launches(bwd, design, bound_bytes):
    """Each of the SSD backward's launches: its device time over 10 calls
    from one trace, its share of the three, and the design's own bytes."""
    prof, _, dropped, _ = _trace(lambda: [bwd() for _ in range(10)])
    check(not dropped, "the SSD backward's trace lacks device records")
    times = {k: 0.0 for k in SSD_BWD_KERNELS}
    counts = dict.fromkeys(SSD_BWD_KERNELS, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            for k in SSD_BWD_KERNELS:
                if k in e.name():
                    times[k] += e.duration_ns() / 1e6
                    counts[k] += 1
    check(all(v == 10 for v in counts.values()),
          f"10 backward calls should launch each of its kernels 10 times: {counts}")
    total = sum(times.values())
    for (k, t), (what, nbytes) in zip(times.items(), design.items()):
        print(f"    {k} ({what}): {t / 10:.4f} ms a call, {t / total:.1%} of the three; "
              f"the design moves {nbytes / 1e6:.1f} MB here "
              f"({nbytes / (t / 10 * 1e-3) / 1e12:.2f} TB/s)")
    allb = sum(design.values())
    print(f"  the design's own bytes (with dh_end and the partials, each counted once a "
          f"launch): {allb / 1e6:.1f} MB, {allb / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 "
          f"TB/s; the bound's inputs and outputs: {bound_bytes / 1e6:.1f} MB")


def _ssd_forward_train_shape(gen):
    """The forward scan as the training path calls it (96 times a mamba2
    step): B 1, S 4096, from a zero state, every chunk's state out; its
    time beside its bounds (a measurement only, not a JSON row)."""
    b, s, h, p, n, chunk = 1, TRAIN_SEQ, SSD_H, SSD_P, SSD_N, M_BLOCK
    x, dta, bm, cm, _ = ssd_inputs(gen, b, s, h, p, n)
    nc = s // chunk
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + (1 + nc) * b * h * p * n)
    flops = ssd_fwd_flops(b, s, h, p, n, chunk)
    t_bound, by = bound(nbytes, flops, torch.float32)
    tc = max(nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / 495e12 * 1e3)
    ms = time_ms(lambda: ssd_scan(x, dta, bm, cm, chunk=chunk, return_all_states=True),
                 iters=10)
    print(f"  ssd_scan forward [B={b} S={s} H={h} P={p} N={n} chunk={chunk} f32, zero start, "
          f"per-chunk states]: kernel {ms:.4f} ms, bound {t_bound:.4f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP in float32; kernel at "
          f"{ms / t_bound:.2f} x it), tensor-core bound {tc:.4f} ms (kernel at {ms / tc:.2f} "
          f"x it); {_smi()}")


class _PlainScans:
    """Within it the model's two scans run their plain forwards on the
    card, differentiated by autograd: a check-only comparison."""

    def __enter__(self):
        self.saved = ops.ssd_scan, ops.rglru_scan

        def ssd(x, dt_a, b_mat, c_mat, *, chunk, initial_state=None,
                return_all_states=False):
            return ssd_chunked(x, dt_a, b_mat, c_mat, chunk, initial_state=initial_state,
                               return_all_states=return_all_states)
        ops.ssd_scan, ops.rglru_scan = ssd, ref.ref_rglru_scan

    def __exit__(self, *exc):
        ops.ssd_scan, ops.rglru_scan = self.saved


class _GradWitness:
    """Within it each step's gradients are checked as ``make_train_step``
    hands them to the optimizer: one (finite, non-zero) flag pair per leaf,
    kept on the card and read once at the end; the update itself is
    untouched."""

    def __enter__(self):
        self.flags, self.inner = [], train_step_mod.adamw_update

        def update(params, grads, state, **kw):
            self.flags.append(torch.stack([torch.stack([torch.isfinite(g).all(), g.any()])
                                           for g in tree_leaves(grads)]))
            return self.inner(params, grads, state, **kw)
        train_step_mod.adamw_update = update
        return self

    def __exit__(self, *exc):
        train_step_mod.adamw_update = self.inner

    def bad_leaves(self):
        """(step, leaf) of every non-finite or all-zero gradient."""
        flags = torch.stack(self.flags).cpu()
        return [(i, k) for i, k in zip(*np.nonzero(~flags.all(-1).numpy()))]


def _gemm_kind(name):
    """A device kernel's kind by its name: cuBLAS GEMMs ("nvjet", "gemm",
    "xmma"), float32 ones among them (SIMT "f32f32" / "sgemm" names)."""
    low = name.lower()
    if not any(k in low for k in ("gemm", "nvjet", "xmma")):
        return None
    return "f32" if any(k in low for k in ("f32f32", "sgemm")) else "other"


def _train_profile(step_fn, wall_ms, ours):
    """One traced training step: device busy share against the untraced
    step wall, the kernels that took longest, our kernels, the GEMMs by
    kind, and the launches made inside ``adamw_update`` (its own range).
    Returns {device kernel or copy name: (ms, launches)}."""
    from torch.profiler import record_function
    inner = train_step_mod.adamw_update

    def marked(*a, **k):
        with record_function("adamw_update"):
            return inner(*a, **k)
    train_step_mod.adamw_update = marked
    try:
        for _ in range(TRACE_ATTEMPTS):
            prof, step, dropped, _ = _trace(step_fn)
            if not dropped:
                break
        check(not dropped, "every trace of the training step lacks device records")
    finally:
        train_step_mod.adamw_update = inner
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    rng = next(e for e in events if e.name() == "adamw_update" and e.device_type() == cpu)
    in_opt = {e.correlation_id() for e in events
              if e.device_type() == cpu and any(c in e.name() for c in DEVICE_CALLS)
              and rng.start_ns() <= e.start_ns() <= rng.end_ns()}
    dev = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
           and e.correlation_id() in step and not e.is_user_annotation()]
    busy = sum(e.duration_ns() for e in dev) / 1e6
    by_name = {}
    for e in dev:
        t, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (t + e.duration_ns() / 1e6, n + 1)
    print(f"  profile of one step: device busy {busy:.1f} ms of the {wall_ms:.1f} ms "
          f"step ({busy / wall_ms:.1%}), {len(dev)} device kernels and copies")
    for kname, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {t:9.2f} ms x{n:<5d} {kname[:90]}")
    groups = [(f"ours ({', '.join(ours)})", lambda k: any(o in k for o in ours)),
              ("float32 GEMMs", lambda k: _gemm_kind(k) == "f32"),
              ("bf16 GEMMs", lambda k: _gemm_kind(k) == "other")]
    for label, pred in groups:
        hit = [(t, n) for kname, (t, n) in by_name.items() if pred(kname)]
        t = sum(t for t, _ in hit)
        print(f"    {label}: {t:.2f} ms over {sum(n for _, n in hit)} launches "
              f"({t / max(busy, 1e-9):.1%} of device busy)")
    opt = [e for e in dev if e.correlation_id() in in_opt]
    t = sum(e.duration_ns() for e in opt) / 1e6
    print(f"    the optimizer (adamw_update): {len(opt)} launches, {t:.2f} ms "
          f"({t / max(busy, 1e-9):.1%} of device busy)")
    return by_name


def _scan_counts():
    """Launch counters of the scans' kernels and calls of their plain
    versions on the card: name -> (read, reset)."""
    fns = {"ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_mod.ssd_scan_bwd,
           "rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_mod.rglru_scan_bwd}
    plain = (ssd_chunked, ssd_mod.ssd_chunked_bwd, ref.ref_rglru_scan,
             ref.ref_rglru_scan_bwd)
    out = {k: (lambda f=f: f.launches, lambda f=f: setattr(f, "launches", 0))
           for k, f in fns.items()}
    out["plain"] = (lambda: sum(f.cuda_calls for f in plain),
                    lambda: [setattr(f, "cuda_calls", 0) for f in plain])
    return out


def _plain_gap(what, kernel, plain):
    """What the first step's (loss, gradient norm) through the kernels
    and through autograd of the plain scans show amiss at PLAIN_RTOL, for
    ``main`` to hold after the last phase (None when they agree), and the
    two relative gaps."""
    gaps = [abs(k - p) / abs(p) for k, p in zip(kernel, plain)]
    amiss = None if max(gaps) <= PLAIN_RTOL else (
        f"{what}: loss {gaps[0]:.2e} and gradient norm {gaps[1]:.2e} apart (relative), "
        f"over {PLAIN_RTOL:g}")
    return amiss, gaps


def _train_full_width(cfg, ours, hold_bf16=True):
    """Train ``cfg`` with seeded random weights on a card freed of earlier
    phases: TRAIN_STEPS steps of ``make_train_step`` at its defaults (peak
    lr 3e-4, warmup 100) with total_steps TRAIN_STEPS, B 1, S TRAIN_SEQ from
    ``TokenStream``. Checks: the mean of the last 3 losses below the mean of
    the first 3 (tests/test_training.py:14); every leaf's gradient finite
    and non-zero at every step. Compares the first step's loss and gradient
    norm with those through autograd of the plain scans on the same weights
    and batch; with ``hold_bf16`` the comparison is held to PLAIN_RTOL by
    ``main`` after the last phase, so that every phase runs and prints
    whatever it finds. Prints peak memory, step wall, tokens/s and 6 N T
    over the step as a share of 989 TFLOP/s, and a profile of one step.
    Returns the scans' launches over the steps, the trace's {kernel: (ms,
    launches)}, what the held comparison found amiss (None when it agrees
    or is not held), the first step's (loss, gradient norm) through the
    kernels and through the plain scans, and the run: every step's loss and
    gradient norm, the step wall, the peak memory, and the profiled step's
    device busy ms and device records, and the bytes allocated before the
    run (``left``, by earlier phases) and when the peak count was reset
    (``base``)."""
    left = _free_card(f"training {cfg.name}")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, vocab={cfg.vocab_size}, "
          f"{cfg.dtype}, {n_params:,} params ({_nbytes(params) / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; B=1 S={TRAIN_SEQ}; {_smi()}")
    stream = TokenStream(cfg.vocab_size, seed=0).batches(1, TRAIN_SEQ)
    batches = [next(stream) for _ in range(TRAIN_STEPS + 1)]
    first = {k: torch.as_tensor(v).to(DEV) for k, v in batches[0].items()}
    with _PlainScans():
        loss, grads = loss_and_grads(model, params, first)
        plain_loss, plain_gnorm = float(loss), float(global_norm(grads))
    del loss, grads
    counts = _scan_counts()
    opt = adamw_init(params)
    step = make_train_step(model, total_steps=TRAIN_STEPS, device=DEV)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _, reset in counts.values():
        reset()
    losses, gnorms, walls = [], [], []
    with _GradWitness() as witness:
        for i, batch in enumerate(batches[:TRAIN_STEPS]):
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            walls.append(time.perf_counter() - t0)
            print(f"  step {i:2d}: loss {losses[-1]:.4f} gnorm {gnorms[-1]:.4f} lr "
                  f"{met['lr']:.2e} wall {walls[-1]:.3f} s")
    seen = {k: get() for k, (get, _) in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    wall = statistics.mean(walls[2:])
    mfu = 6 * n_params * TRAIN_SEQ / wall / PEAK_FLOPS[torch.bfloat16]
    print(f"  peak memory {peak / 1e9:.2f} GB, step wall {wall:.3f} s (mean of steps "
          f"2-{TRAIN_STEPS - 1}), {TRAIN_SEQ / wall:.0f} tokens/s, 6 N T over the step "
          f"{mfu:.4f} of 989 TFLOP/s bf16; launches over the {TRAIN_STEPS} steps: "
          + ", ".join(f"{k} {v}" for k, v in seen.items()))
    bad = witness.bad_leaves()
    first3, last3 = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    print(f"  checks: mean loss of the last 3 steps {last3:.4f} vs the first 3 {first3:.4f}; "
          f"{len(tree_leaves(params))} leaves x {TRAIN_STEPS} steps of gradients, "
          f"{len(bad)} non-finite or zero")
    check(last3 < first3, f"the loss did not fall: {losses}")
    check(not bad, f"non-finite or all-zero gradients (step, leaf): {bad}")
    check(seen["plain"] == 0, f"{seen['plain']} plain scan calls on the card in training")
    first = (losses[0], gnorms[0]), (plain_loss, plain_gnorm)
    plain, gaps = _plain_gap(cfg.name, *first)
    held = (f"{'within' if plain is None else 'OVER'} {PLAIN_RTOL:g}, held at the end of "
            f"the run" if hold_bf16 else "printed; held on the float32 copy below")
    print(f"  the first step through the kernels and through autograd of the plain scans: "
          f"loss {losses[0]:.6f} / {plain_loss:.6f}, gradient norm {gnorms[0]:.6f} / "
          f"{plain_gnorm:.6f}, {gaps[0]:.2e} and {gaps[1]:.2e} apart (relative; {held})")
    batch = batches[-1]
    by_name = _train_profile(lambda: step(params, opt, batch), wall * 1e3, ours)
    del model, params, opt, step
    run = dict(losses=losses, gnorms=gnorms, wall=wall, peak=peak, left=left, base=base,
               busy=sum(t for t, _ in by_name.values()),
               launches=sum(n for _, n in by_name.values()))
    return seen, by_name, plain if hold_bf16 else None, first, run


def _float32_first_step(cfg, bf16_first):
    """The first step's loss and gradient norm through the kernels and
    through autograd of the plain scans, on a float32 copy of the same
    seeded weights and the same batch: how far apart the two paths are
    without the model's bf16 rounding. Prints it, and how far each path's
    bf16 first step (``bf16_first``, as ``_train_full_width`` returns it)
    lies from its float32 one. Returns what it finds amiss at PLAIN_RTOL
    (None when the two paths agree), for ``main`` to hold."""
    _free_card(f"{cfg.name} in float32")
    model = Model(dataclasses.replace(cfg, dtype="float32"))
    params = tree_map(lambda t: t.float(),
                      Model(cfg).init(torch.Generator(device=DEV).manual_seed(0)))
    batch = next(TokenStream(cfg.vocab_size, seed=0).batches(1, TRAIN_SEQ))
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in batch.items()}
    out = []
    for plain in (False, True):
        with _PlainScans() if plain else contextlib.nullcontext():
            loss, grads = loss_and_grads(model, params, batch)
            out.append((float(loss), float(global_norm(grads))))
        del loss, grads
    amiss, gaps = _plain_gap(f"{cfg.name} on a float32 copy", *out)
    (lk, gk), (lp, gp) = out
    print(f"  the same first step on a float32 copy of the weights: loss {lk:.6f} / {lp:.6f}, "
          f"gradient norm {gk:.6f} / {gp:.6f}, {gaps[0]:.2e} and {gaps[1]:.2e} apart "
          f"(relative; {'within' if amiss is None else 'OVER'} {PLAIN_RTOL:g}, held at the "
          f"end of the run)")
    for what, (lb, gb), (lf, gf) in zip(("kernels", "plain scans"), bf16_first, out):
        print(f"  through the {what}, the bf16 first step lies from the float32 one: loss "
              f"{abs(lb - lf) / abs(lf):.2e}, gradient norm {abs(gb - gf) / abs(gf):.2e} "
              f"(relative)")
    del model, params
    return amiss


def phase_train_mamba():
    """Returns the SSD backward kernel's launches over the steps, the
    plain-scan comparison's finding on the float32 copy, and the run (for
    phase 31)."""
    phase("25 train mamba2-1.3b at full width")
    cfg = get_config("mamba2-1.3b")
    seen, by_name, _, first, run = _train_full_width(cfg, (SSD_KERNEL, *SSD_BWD_KERNELS),
                                                     hold_bf16=False)
    plain = _float32_first_step(cfg, first)
    n = cfg.num_layers * TRAIN_STEPS
    # each layer's scan runs again when its checkpointed unit is recomputed
    check(seen["ssd_scan"] == 2 * n and seen["ssd_scan_bwd"] == n,
          f"{TRAIN_STEPS} steps should launch the SSD forward {2 * n} times and its "
          f"backward {n} times: {seen}")
    per_kernel = {k: _launches(by_name, (k,)) for k in (SSD_KERNEL, *SSD_BWD_KERNELS)}
    print(f"  the profiled step's SSD launches: {per_kernel}")
    check(per_kernel[SSD_KERNEL] == 2 * cfg.num_layers
          and all(per_kernel[k] == cfg.num_layers for k in SSD_BWD_KERNELS),
          "the profiled step's trace does not show the SSD kernels' launches: the "
          f"forward twice a layer and each backward kernel once: {per_kernel}")
    return seen["ssd_scan_bwd"], plain, run


def phase_train_hybrid():
    """Returns the RG-LRU backward kernel's launches over the steps and the
    plain-scan comparison's finding."""
    phase(f"26 train recurrentgemma-9b at full width, depth cut to {R_TRAIN_LAYERS} layers")
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=R_TRAIN_LAYERS)
    segs = tfm_segments(cfg)
    units = segs[0][2]
    scanned = units * sum(k == "rglru" for k in segs[0][1])
    unrolled = sum(k == "rglru" for s in segs[1:] for k in s[1])
    print(f"  depth {R_TRAIN_LAYERS} of 38: {units} checkpointed (rglru, rglru, attn) units "
          f"and an unrolled {segs[1][1] if len(segs) > 1 else ()}; {scanned + unrolled} "
          f"RG-LRU layers")
    seen, by_name, plain, _, _ = _train_full_width(cfg, (RGLRU_KERNEL, RGLRU_BWD_KERNEL))
    check(seen["rglru_scan"] == (2 * scanned + unrolled) * TRAIN_STEPS
          and seen["rglru_scan_bwd"] == (scanned + unrolled) * TRAIN_STEPS,
          f"{TRAIN_STEPS} steps should launch the RG-LRU forward "
          f"{(2 * scanned + unrolled) * TRAIN_STEPS} times and its backward "
          f"{(scanned + unrolled) * TRAIN_STEPS} times: {seen}")
    check(_launches(by_name, (RGLRU_KERNEL,)) == 2 * scanned + unrolled
          and _launches(by_name, (RGLRU_BWD_KERNEL,)) == scanned + unrolled,
          "the profiled step's trace does not show the RG-LRU kernels' launches")
    return seen["rglru_scan_bwd"], plain


def phase_train_qwen():
    """Returns the plain-scan comparison's finding and the run (for phase
    30's memory comparison)."""
    phase("27 train qwen3-4b at full width")
    seen, _, plain, _, run = _train_full_width(get_config("qwen3-4b"), ("none of ours",))
    check(not any(seen.values()), f"qwen3-4b's training launched scan kernels: {seen}")
    return plain, run


def _tiny_train_run(cfg, params, device):
    """TRAIN_STEPS_PARITY steps at the defaults on ``device`` from a copy of
    ``params``: per step the loss, the gradient norm, the lr, and copies of
    the gradients before and of the parameters after the step."""
    model = Model(cfg)
    params = tree_map(lambda t: t.to(device, copy=True), params)
    opt = adamw_init(params)
    step = make_train_step(model, total_steps=TRAIN_STEPS, device=device)
    stream = TokenStream(cfg.vocab_size, seed=0).batches(PARITY_BATCH, PARITY_SEQ)
    out = []
    for _ in range(TRAIN_STEPS_PARITY):
        batch = next(stream)
        _, grads = loss_and_grads(model, params,
                                  {k: torch.as_tensor(v).to(device) for k, v in batch.items()})
        params, opt, met = step(params, opt, batch)
        out.append(dict(loss=float(met["loss"]), gnorm=float(met["grad_norm"]), lr=met["lr"],
                        grads=[g.cpu() for g in grads],
                        params=[t.to("cpu", copy=True) for t in tree_leaves(params)]))
    return out


def phase_train_parity():
    """Tiny float32 models, TRAIN_STEPS_PARITY steps at the defaults on the
    CPU and on the card, with the CPU tests' tolerances: the loss and the
    gradient norm to 1e-5 relative; the first step's gradients to rtol 1e-4
    / atol 1e-6 and its parameter steps within 0.1 lr beyond what the
    gradients' difference moves AdamW's first update; then the largest
    parameter gap in lr units after each step."""
    phase("28 CPU vs CUDA training parity (tiny and reduced, float32)")
    tiny = ModelConfig(name="tiny-dense", family="dense", source="test", num_layers=2,
                       d_model=64, vocab_size=128, num_heads=4, num_kv_heads=2,
                       head_dim=16, d_ff=128, dtype="float32", rope_theta=10_000.0)
    counts = _scan_counts()
    for cfg in (tiny, get_config("qwen3-moe-30b-a3b").reduced(),
                get_config("mamba2-1.3b").reduced(), get_config("recurrentgemma-9b").reduced()):
        params = Model(cfg).init(torch.Generator().manual_seed(0))
        for _, reset in counts.values():
            reset()
        cpu, card = _tiny_train_run(cfg, params, "cpu"), _tiny_train_run(cfg, params, DEV)
        seen = {k: get() for k, (get, _) in counts.items()}
        lr_sum, gaps = 0.0, []
        for i, (c, g) in enumerate(zip(cpu, card)):
            check(abs(c["loss"] - g["loss"]) <= 1e-5 * abs(c["loss"]),
                  f"{cfg.name} step {i}: loss CPU {c['loss']} card {g['loss']}")
            check(abs(c["gnorm"] - g["gnorm"]) <= 1e-5 * abs(c["gnorm"]),
                  f"{cfg.name} step {i}: gradient norm CPU {c['gnorm']} card {g['gnorm']}")
            lr_sum += c["lr"]
            gaps.append(max(float((a - b).abs().max()) if a.numel() else 0.0
                            for a, b in zip(c["params"], g["params"])) / lr_sum)
        c, g = cpu[0], card[0]
        for k, (gc_, gg, p0, pc, pg) in enumerate(zip(c["grads"], g["grads"],
                                                      tree_leaves(params),
                                                      c["params"], g["params"])):
            if not gc_.numel():
                continue
            check(torch.allclose(gg, gc_, rtol=1e-4, atol=1e-6),
                  f"{cfg.name}: gradient {k} of the first step")
            gap = ((pg - p0) - (pc - p0)).abs().double()
            check(bool((gap <= 0.1 * c["lr"]).all()),
                  f"{cfg.name}: the first step of parameter {k}, "
                  f"{float(gap.max()) / c['lr']:.4f} lr from the CPU's")
        check(seen["plain"] == 0, f"{cfg.name}: a plain scan ran on the card")
        scans = sum(v for k, v in seen.items() if k != "plain")
        check(scans > 0 or not (cfg.ssm_state or cfg.block_pattern),
              f"{cfg.name}: no scan kernel launched on the card")
        print(f"  {cfg.name}: {TRAIN_STEPS_PARITY} steps, losses CPU "
              f"{[round(x['loss'], 7) for x in cpu]} card {[round(x['loss'], 7) for x in card]}; "
              f"largest parameter gap after each step {', '.join(f'{x:.3e}' for x in gaps)} "
              f"lr (of the lr summed so far); card launches "
              + ", ".join(f"{k} {v}" for k, v in seen.items()))


def phase_train_cli():
    phase("29 the training CLI on the card, its checkpoint restored on the card")
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck")
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device",
                              "cuda", "--arch", "mamba2-1.3b", "--steps", "3", "--save", path],
                             capture_output=True, text=True, timeout=CLI_TIMEOUT, cwd=root,
                             env=dict(os.environ, PYTHONPATH=str(root / "src")))
        for line in out.stdout.splitlines():
            print(f"  cli> {line}")
        check(out.returncode == 0, f"the train CLI failed: {out.stderr[-2000:]}")
        losses = [float(ln.split()[3]) for ln in out.stdout.splitlines()
                  if ln.startswith("step")]
        check(len(losses) == 2 and all(np.isfinite(losses)), f"the CLI's losses {losses}")
        check(out.stdout.splitlines()[-1] == f"saved checkpoint to {path}.npz",
              "the train CLI did not save")
        like = Model(get_config("mamba2-1.3b").reduced()).init(
            torch.Generator(device=DEV).manual_seed(1))
        got, step_n = restore_checkpoint(path, like)
        with np.load(path + ".npz") as data:
            for i, t in enumerate(tree_leaves(got)):
                check(t.device.type == "cuda" and np.array_equal(
                    t.cpu().numpy(), data[f"leaf_{i}"]), f"restored leaf {i} differs")
        check(step_n == 3, f"restored step {step_n}")
        print(f"  the CLI's checkpoint restored on the card: {len(tree_leaves(got))} leaves "
              f"equal to the file, step {step_n}")


def _full(t):
    """A DTensor's whole value (on a mesh of one rank, its shard)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


_MESH_COUNT = """
import json, time
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
t0 = time.perf_counter()
with dryrun.fake_world(1):
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    m = dryrun.measure(get_config({arch!r}), InputShape("mesh", {seq}, 1, {kind!r}), mesh)
out = {{k: m[k] for k in ("per_rank_bytes", "argument_bytes", "temp_bytes", "output_bytes")}}
out["wall_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def _hold_peak(what, count, peak, left, base):
    """The dry run's peak a rank for a step (its arguments plus
    ``temp_bytes``) against the card's for the same step: ``peak``
    (``torch.cuda.max_memory_allocated()`` over it) less ``left``, what
    earlier phases left allocated; ``base``, allocated when the peak count
    was reset, is printed beside. Fails beyond PEAK_RTOL."""
    dry = count["argument_bytes"] + count["temp_bytes"]
    card = peak - left
    gap = dry / card - 1
    print(f"  {what}: the dry run's peak {dry / 1e9:.3f} GB a rank (arguments "
          f"{count['argument_bytes'] / 1e9:.3f} + temp_bytes {count['temp_bytes'] / 1e9:.3f}"
          f"; output_bytes {count['output_bytes'] / 1e9:.3f}) against the card's "
          f"{card / 1e9:.3f} GB (max_memory_allocated {peak / 1e9:.3f} less {left / 1e9:.3f} "
          f"left by earlier phases; {(base - left) / 1e9:.3f} allocated at the start): "
          f"{dry - card:+,} B, {gap:+.2%} (bound {PEAK_RTOL:.0%})")
    check(abs(gap) <= PEAK_RTOL, f"{what}: the dry run's peak {dry} B lies {gap:+.2%} from "
          f"the card's {card} B")


def _zero1_check(r):
    """Prints what ``adamw_update`` alone issued and created in a train
    record (``RankCounter.span``), and fails where a storage it created,
    or an all-gather's result, exceeds the largest parameter shard of the
    rank in float32: ZeRO-1 keeps the update inside each parameter's own
    `model` shard."""
    o = r["optimizer"]
    ops_ = ", ".join(f"{k} {o['calls'][k]} calls {o['collectives'][k] / 1e9:.3f} GB (largest "
                     f"{o['largest_result'][k] / 1e9:.3f})" for k in ("all-reduce", "all-gather",
                                                                     "reduce-scatter"))
    print(f"    inside adamw_update: {ops_}; largest storage created "
          f"{o['largest_storage'] / 1e9:.3f} GB against the largest parameter shard in float32 "
          f"{o['shard_bytes_f32'] / 1e9:.3f} GB")
    check(0 < o["largest_storage"] <= o["shard_bytes_f32"],
          f"{r['arch']} x {r['shape']} x {r['mesh']}: the optimizer created a storage of "
          f"{o['largest_storage']} B, past the largest parameter shard in float32 "
          f"({o['shard_bytes_f32']} B)")
    check(o["largest_result"]["all-gather"] <= o["shard_bytes_f32"],
          f"{r['arch']} x {r['shape']} x {r['mesh']}: the optimizer gathered "
          f"{o['largest_result']['all-gather']} B at once")


def phase_dryrun(qwen_run):
    """Holds phase 27's peak (``qwen_run``) against the dry run's count of
    the same step on a (1, 1) mesh. Returns the (1, 1) mesh's counts of
    MESH_STEPS, for phase 31."""
    phase("30 the production dry run at full width (fake process group, on the host)")
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as out:
        cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
                 "--out", out] + (["--multipod"] if mp else []) for a, s, mp in DRYRUN_SET]
        cmds += [[sys.executable, "-c", _MESH_COUNT.format(arch=a, seq=n, kind=k)]
                 for a, n, k in MESH_STEPS.values()]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, cwd=root, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for c in cmds]
        try:
            results = [p.communicate(timeout=DRYRUN_TIMEOUT) + (p.returncode,) for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.perf_counter() - t0
        for c, (stdout, stderr, rc) in zip(cmds, results):
            check(rc == 0, f"{' '.join(c[1:4])[:200]} failed: {stdout[-2000:]}{stderr[-2000:]}")
        recs = [json.loads(f.read_text()) for f in sorted(Path(out).glob("*.json"))]
    check(len(recs) == len(DRYRUN_SET), f"{len(recs)} dry-run records of {len(DRYRUN_SET)}")
    print(f"  {len(recs)} combinations ({len(recs) - 1} on pod16x16, 256 ranks; "
          f"{ZERO1_RECORD[0]} {ZERO1_RECORD[1]} on pod2x16x16, 512) and {len(MESH_STEPS)} "
          f"steps on a (1, 1) mesh, one process each, side by side: {wall:.1f} s wall; {_smi()}")
    for r in recs:
        check(r["ok"], f"dry run {r['arch']} x {r['shape']}: {r.get('error')}")
        b, c, rf, mem = r["per_rank_bytes"], r["collectives"], r["roofline"], r["memory"]
        check(isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
              and isinstance(mem["output_bytes"], int),
              f"dry run {r['arch']} x {r['shape']}: memory {mem}")
        ops_ = ", ".join(f"{k} {c[k] / 1e9:.3f}" for k in ("all-reduce", "all-gather",
                                                        "reduce-scatter", "all-to-all"))
        print(f"  {r['arch']} x {r['shape']} x {r['mesh']}: per rank params "
              f"{b['params'] / 1e9:.3f} GB, grads {b['grads'] / 1e9:.3f}, moments "
              f"{b['moments'] / 1e9:.3f}, inputs {b['inputs'] / 1e9:.3f}, total "
              f"{b['total'] / 1e9:.3f} GB; peak "
              f"{(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:.3f} GB (arguments "
              f"{mem['argument_bytes'] / 1e9:.3f} + temp_bytes {mem['temp_bytes'] / 1e9:.3f}; "
              f"output_bytes {mem['output_bytes'] / 1e9:.3f}), fits_80gb {r['fits_80gb']} "
              f"(card {r['device_memory_bytes'] / 1e9:.2f} GB); "
              f"{r['flops']:.4e} flops, {r['bytes_accessed']:.4e} B accessed; collectives "
              f"{c['count']} ops, {c['total'] / 1e9:.3f} GB ({ops_}); roofline compute "
              f"{rf['compute_s']:.4f} s, memory {rf['memory_s']:.4f} s, collective >= "
              f"{rf['collective_s']:.4f} s ({rf['dominant']}); traced in {r['wall_s']:.1f} s")
        if "optimizer" in r:
            _zero1_check(r)
    check(any((r["arch"], r["shape"], r["mesh"]) == (ZERO1_RECORD[0], ZERO1_RECORD[1],
                                                     "pod2x16x16") for r in recs),
          f"no record of {ZERO1_RECORD}")
    counts = {what: json.loads(res[0].splitlines()[-1])
              for what, res in zip(MESH_STEPS, results[len(DRYRUN_SET):])}
    for what, m in counts.items():
        arch, seq, kind = MESH_STEPS[what]
        print(f"  {arch} {kind} at B 1, S {seq} on a (1, 1) mesh: "
              + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in m["per_rank_bytes"].items())
              + f"; temp_bytes {m['temp_bytes'] / 1e9:.3f} GB, output_bytes "
              f"{m['output_bytes'] / 1e9:.3f} GB; traced in {m['wall_s']:.1f} s")
    _hold_peak("qwen3-4b's training step (phase 27, no mesh)", counts["qwen3 train"],
               qwen_run["peak"], qwen_run["left"], qwen_run["base"])
    return counts


def _greedy(model, params, prompt, pos_like, peaks=None):
    """The prefill's token and MESH_DECODE greedy decode steps' tokens, and
    the logits of each; the card's peak memory right after the prefill is
    appended to ``peaks`` where it is given."""
    logits, cache = model.prefill(params, prompt)
    if peaks is not None:
        peaks.append(torch.cuda.max_memory_allocated())
    cur = torch.argmax(logits, dim=-1)
    out, seen = [int(_full(cur)[0])], [_full(logits)]
    for i in range(MESH_DECODE):
        logits, cache = model.decode_step(params, cur, cache, pos_like(cur, MESH_PROMPT + i))
        cur = torch.argmax(logits, dim=-1)
        out.append(int(_full(cur)[0]))
        seen.append(_full(logits))
    return out, seen


def _checkpoint_zero1(params, opt):
    """Saves the mesh's training state (parameters and ZeRO-1 moments)
    through ``training.checkpoint`` and restores it into the same layout:
    every restored leaf in its placements and bitwise the saved one."""
    from repro_torch.training import checkpoint
    state = {"params": params, "m": opt.m, "v": opt.v}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "zero1")
        t0 = time.perf_counter()
        checkpoint.save(path, state, step=opt.step)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path + ".npz")
        t0 = time.perf_counter()
        restored, step_n = checkpoint.restore(path, state)
        t_restore = time.perf_counter() - t0
    leaves, saved = tree_leaves(restored), tree_leaves(state)
    same = [a.placements == b.placements and torch.equal(a.to_local(), b.to_local())
            for a, b in zip(leaves, saved)]
    moments = same[len(tree_leaves(params)):]
    print(f"  the ZeRO-1 state saved ({size / 1e9:.3f} GB, {len(saved)} leaves, {t_save:.1f} s) "
          f"and restored into the mesh's layout ({t_restore:.1f} s): {sum(moments)} of "
          f"{len(moments)} moments and {sum(same) - sum(moments)} of "
          f"{len(same) - len(moments)} parameters bitwise equal, step {step_n}")
    check(all(same) and step_n == opt.step,
          f"the restored ZeRO-1 state differs: {same.count(False)} leaves, step {step_n}")
    del restored, leaves


def phase_train_mesh(mamba_run, counts):
    """Phase 25's training run again, distributed over a (data 1, model 1)
    ``DeviceMesh`` on the card with the logical-axis hook installed; its
    peak memory and its prefill's held against the dry run's ``counts``
    (phase 30's)."""
    phase("31 train mamba2-1.3b at full width on a (data 1, model 1) DeviceMesh "
          "(NCCL, one rank)")
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    left = _free_card("training on the mesh")
    cfg = get_config("mamba2-1.3b")
    model = Model(cfg)
    routed, inner = [0], ops._dtensor_ssd_scan

    def counted(*a, **k):
        routed[0] += 1
        return inner(*a, **k)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    ops._dtensor_ssd_scan = counted
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        params = sharding.param_shardings(
            model.init(torch.Generator(device=DEV).manual_seed(0)), mesh)
        opt = sharding.zero1_adamw_init(params, mesh)
        _, placements = sharding.input_specs(
            cfg, InputShape("train_4k", TRAIN_SEQ, 1, "train"), mesh)
        stream = TokenStream(cfg.vocab_size, seed=0).batches(1, TRAIN_SEQ)
        batches = [sharding.distribute({k: torch.as_tensor(v).to(DEV)
                                        for k, v in next(stream).items()}, placements, mesh)
                   for _ in range(TRAIN_STEPS + 1)]
        print(f"  mesh {mesh}; {len(tree_leaves(params))} DTensor leaves, "
              f"{sum(isinstance(t, DTensor) for t in tree_leaves(opt.m))} ZeRO-1 moments; "
              f"{_smi()}")
        step = make_train_step(model, total_steps=TRAIN_STEPS, device=DEV)
        scans = _scan_counts()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for _, reset in scans.values():
            reset()
        losses, gnorms, walls = [], [], []
        with sharding.on_mesh(mesh):
            for i, batch in enumerate(batches[:TRAIN_STEPS]):
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                losses.append(float(_full(met["loss"])))
                gnorms.append(float(_full(met["grad_norm"])))
                walls.append(time.perf_counter() - t0)
                print(f"  step {i:2d}: loss {losses[-1]:.4f} gnorm {gnorms[-1]:.4f} wall "
                      f"{walls[-1]:.3f} s")
        seen = {k: get() for k, (get, _) in scans.items()}
        peak = torch.cuda.max_memory_allocated()
        wall = statistics.mean(walls[2:])
        n = cfg.num_layers * TRAIN_STEPS
        print(f"  launches over the {TRAIN_STEPS} steps: "
              + ", ".join(f"{k} {v}" for k, v in seen.items())
              + f"; SSD scans through local_map {routed[0]}")
        same = losses == mamba_run["losses"] and gnorms == mamba_run["gnorms"]
        print(f"  against phase 25 (the same weights and batches, no mesh): losses and "
              f"gradient norms of all {TRAIN_STEPS} steps {'bitwise equal' if same else 'DIFFER'}"
              f"; step wall {wall:.3f} s vs {mamba_run['wall']:.3f} s "
              f"({wall / mamba_run['wall'] - 1:+.1%}); peak memory {peak / 1e9:.2f} GB vs "
              f"{mamba_run['peak'] / 1e9:.2f} GB")
        check(same, f"the mesh's steps differ from phase 25's: losses {losses} vs "
              f"{mamba_run['losses']}, gradient norms {gnorms} vs {mamba_run['gnorms']}")
        check(seen["ssd_scan"] == 2 * n and seen["ssd_scan_bwd"] == n and routed[0] == 2 * n,
              f"{TRAIN_STEPS} steps should launch the SSD forward {2 * n} times through "
              f"local_map and its backward {n} times: {seen}, routed {routed[0]}")
        check(seen["plain"] == 0, f"{seen['plain']} plain scan calls on the card")
        _hold_peak(f"mamba2-1.3b's training step on the mesh ({TRAIN_STEPS} steps)",
                   counts["mamba2 train"], peak, left, base)

        def profiled():
            with sharding.on_mesh(mesh):
                step(params, opt, batches[-1])
        by_name = _train_profile(profiled, wall * 1e3, (SSD_KERNEL, *SSD_BWD_KERNELS))
        per_kernel = {k: _launches(by_name, (k,)) for k in (SSD_KERNEL, *SSD_BWD_KERNELS)}
        busy = sum(t for t, _ in by_name.values())
        records = sum(c for _, c in by_name.values())
        print(f"  the profiled step's SSD launches: {per_kernel}; device busy {busy:.1f} ms "
              f"({busy / (wall * 1e3):.1%} of the step) vs phase 25's {mamba_run['busy']:.1f} "
              f"ms ({mamba_run['busy'] / (mamba_run['wall'] * 1e3):.1%}); {records} device "
              f"records vs {mamba_run['launches']}")
        check(per_kernel[SSD_KERNEL] == 2 * cfg.num_layers
              and all(per_kernel[k] == cfg.num_layers for k in SSD_BWD_KERNELS),
              f"the profiled step's trace does not show the SSD kernels' launches: {per_kernel}")

        _checkpoint_zero1(params, opt)

        # the prefill's arguments are the weights and the prompt: the
        # training run's moments and batches go first
        del opt, batches, step, met
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device=DEV).manual_seed(5)
        prompt = torch.randint(0, cfg.vocab_size, (1, MESH_PROMPT), device=DEV, generator=gen)
        _, pl = sharding.input_specs(cfg, InputShape("p", MESH_PROMPT, 1, "prefill"), mesh)
        tokens = sharding.distribute({"tokens": prompt}, pl, mesh)["tokens"]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before, peaks = ssd_scan.launches, []
        with torch.no_grad(), sharding.on_mesh(mesh):
            got, got_logits = _greedy(model, params, tokens, lambda cur, p: DTensor.from_local(
                torch.full((1,), p, dtype=torch.int32, device=DEV), mesh, cur.placements,
                run_check=False), peaks)
        prefill_launches = ssd_scan.launches - before
        _hold_peak(f"mamba2-1.3b's {MESH_PROMPT}-token prefill on the mesh",
                   counts["mamba2 prefill"], peaks[0], left, base)
        plain = tree_map(_full, params)
        with torch.no_grad():
            want, want_logits = _greedy(
                model, plain, prompt,
                lambda cur, p: torch.full((1,), p, dtype=torch.int32, device=DEV))
        same_logits = all(torch.equal(a, b) for a, b in zip(got_logits, want_logits))
        print(f"  prefill of {MESH_PROMPT} tokens and {MESH_DECODE} decode steps on the mesh "
              f"({prefill_launches} SSD launches): {got}; unsharded: {want}; logits "
              f"{'bitwise equal' if same_logits else 'DIFFER'}")
        check(got == want, f"the mesh's tokens {got} differ from the unsharded {want}")
        check(prefill_launches == cfg.num_layers,
              f"the prefill on the mesh launched the SSD kernel {prefill_launches} times")
        del params, plain
    finally:
        ops._dtensor_ssd_scan = inner
        dist.destroy_process_group()


def main():
    kind, count = phase_device()
    gen = torch.Generator(device=DEV).manual_seed(0)
    phase_build()
    errs = phase_kernels(gen)
    rows = phase_timing(gen, errs)
    launches, engine_loop = phase_serve()
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
    phase_serve_granite()
    model, params = phase_serve_scout()
    phase_moe_layer(model, params, "17b")
    del model, params
    phase_serve_qwen2_vl()
    phase_dense_cut()
    model, params = phase_serve_musicgen()
    phase_dense_multimodal(model, params)
    phase_replicas(model, params)
    del model, params
    phase_front_door(engine_loop)
    t_train = time.perf_counter()
    rows += phase_backward_kernels(gen)
    launches["ssd_scan_bwd"], plain_mamba, mamba_run = phase_train_mamba()
    launches["rglru_scan_bwd"], plain_hybrid = phase_train_hybrid()
    plain_qwen, qwen_run = phase_train_qwen()
    phase_train_parity()
    phase_train_cli()
    print(f"phases 24-29: {time.perf_counter() - t_train:.1f} s wall")
    t_mesh = time.perf_counter()
    phase_train_mesh(mamba_run, phase_dryrun(qwen_run))
    print(f"phases 30-31: {time.perf_counter() - t_mesh:.1f} s wall")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    first = {}
    for r in rows:
        first.setdefault(r["name"], r)
    for r in first.values():
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in first.values()]}))
    amiss = [x for x in (plain_mamba, plain_hybrid, plain_qwen) if x]
    check(not amiss, "the first training step through the kernels and through autograd "
          "of the plain scans disagree: " + "; ".join(amiss))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
