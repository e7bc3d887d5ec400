"""The dry run's memory analysis (``repro_torch.launch.dryrun``) on the CPU.

* The live-bytes tracker (``RankCounter.watch``) on a hand-built chain of
  products whose peak is known in closed form: exact, on plain tensors and
  on DTensors over a (1, 1) mesh of a ``fake`` process group; a view, an
  alias or an in-place result adds nothing; ``logsumexp``'s composite
  temporary counts, as the CPU's own allocator sees it.
* Reduced qwen3-4b at a train, a prefill and a decode shape on the
  (1, 1) fake mesh: the dry run's ``temp_bytes`` within 2% of the peak of
  the same step on real CPU tensors, measured by ``torch.profiler``'s
  memory events, independently of the tracker. The model reaches no scan
  kernel, so both run the same ops.
* The scans' ``meta`` routes allocate what their card routes allocate:
  the SSD backward's ``dh_end`` and partial buffers (``ssd_bwd_plan``),
  alive only during the call, its outputs, and the float32 and aligned
  copies the card route makes of its operands; the RG-LRU scans' outputs
  and copies, with ``rglru_plan``'s and ``rglru_bwd_plan``'s checks.

The records of the CLI (every one with ``temp_bytes`` > 0, a train
record's at least its gradients') are checked in ``tests/test_torch_dryrun.py``
on that file's records.

Three faults the count found on the production mesh stay fixed: the
loss's normaliser and gold logits (``train_step._logz``, ``_gold``) and
the MoE route's accumulators (``moe._route``) were built by ops that give
every rank a whole copy of a batch-sized tensor (the logsumexp gathered
the whole vocab; the gather's backward made zeros of the whole (B,S,V)).
A rank of pod16x16 at B 256 now holds no more than a (1, 1) mesh at its
16 rows, and on a vocab-sharded mesh of two gloo ranks ``_gold`` equals
the plain gather and ``_logz`` the plain logsumexp, gradients too.
"""
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import DTensor, Replicate  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.launch import dryrun, sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PEAK_RTOL = 0.02
B, S = 2, 64
META = torch.device("meta")


@pytest.fixture
def mesh():
    """A (data 1, model 1) mesh over a ``fake`` group of one rank."""
    with dryrun.fake_world(1):
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")


def _watched(fn, *entry):
    """(result, peak, live bytes after) of ``fn(*entry)`` under a tracker
    that takes ``entry`` as live at the start."""
    counter = dryrun.RankCounter()
    with counter:
        counter.watch(entry)
        out = fn(*entry)
    return out, counter.peak, counter.live


def _profiled_peak(fn):
    """The most bytes the CPU allocator held during ``fn()`` past what it
    held at the start, from the profiler's memory events in time order."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        out = fn()
        del out
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    return peak


# ------------------------------------------------------------------ the tracker
M, K, N1, N2, N3 = 8, 16, 32, 24, 40


def _chain(x, w1, w2, w3):
    """Three products; a view, a reshape and an in-place scale between them."""
    a = x @ w1                        # A = M x N1
    b = (a @ w2).t()                  # B = M x N2, seen through a view
    del a
    c = b.t().reshape(M, N2)          # views of B
    c.mul_(2.0)                       # in place
    return c @ w3                     # D = M x N3, while B is alive


def _chain_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((M, K), (K, N1), (N1, N2), (N2, N3))]


def _chain_peak():
    a, b, d = (4 * M * n for n in (N1, N2, N3))
    return max(a + b, b + d), d


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_tracker_peak_of_a_chain_is_exact(device):
    ins = [t.to(device) for t in _chain_inputs()]
    out, peak, live = _watched(_chain, *ins)
    want_peak, want_live = _chain_peak()
    assert (peak, live) == (want_peak, want_live)
    del out


def test_tracker_peak_of_a_chain_under_dtensor(mesh):
    ins = [DTensor.from_local(t.to(META), mesh, [Replicate(), Replicate()], run_check=False)
           for t in _chain_inputs()]
    out, peak, live = _watched(_chain, *ins)
    assert isinstance(out, DTensor)
    assert (peak, live) == _chain_peak()


def test_tracker_views_and_in_place_results_add_nothing():
    x = torch.empty((M, N1), device=META)

    def views(t):
        u = t[1:]
        v = t.view(-1)
        w = t.t().contiguous().t()    # a copy: one new storage
        u.add_(1.0)
        return u, v, w, t.detach()
    out, peak, live = _watched(views, x)
    assert peak == live == 4 * M * N1


def test_tracker_counts_logsumexp_s_temporary_as_the_cpu_allocates_it():
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((64, 1000)),
                        dtype=torch.float32)
    _, peak, live = _watched(lambda t: torch.logsumexp(t, dim=-1), x)
    assert peak >= x.numel() * 4 + 64 * 4 and live == 64 * 4
    assert peak == _profiled_peak(lambda: torch.logsumexp(x, dim=-1))
    _, meta_peak, _ = _watched(lambda t: torch.logsumexp(t, dim=-1), x.to(META))
    assert meta_peak == peak


# ---------------------------------------------------------------- the step, real
def _real_step(cfg, shape, mesh):
    """The step ``dryrun.measure`` traces, as a thunk over real CPU
    DTensors on ``mesh``: seeded weights, ZeRO-1 moments for a train shape,
    a numpy-seeded batch (a decode cache for a decode shape)."""
    model = Model(cfg)
    params = sharding.param_shardings(model.init(torch.Generator().manual_seed(0)), mesh)
    _, placements = sharding.input_specs(cfg, shape, mesh)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.int32)
    if shape.kind == "train":
        opt = sharding.zero1_adamw_init(params, mesh)
        batch = sharding.distribute({"tokens": tokens, "labels": tokens.clone()},
                                    placements, mesh)
        step = make_train_step(model, device="cpu")
        return lambda: step(params, opt, batch)
    if shape.kind == "prefill":
        batch = sharding.distribute({"tokens": tokens}, placements, mesh)
        return lambda: model.prefill(params, batch["tokens"])
    batch = sharding.distribute(
        {"tokens": tokens[:, 0], "cache": model.make_cache(B, S, device="cpu"),
         "pos": torch.full((B,), S // 2, dtype=torch.int32)}, placements, mesh)
    return lambda: model.decode_step(params, batch["tokens"], batch["cache"], batch["pos"])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_peak_is_the_cpu_step_s(mesh, kind):
    cfg = get_config("qwen3-4b").reduced()
    shape = InputShape(kind, S, B, kind)
    counted = dryrun.measure(cfg, shape, mesh)
    with sharding.on_mesh(mesh):
        measured = _profiled_peak(_real_step(cfg, shape, mesh))
    assert measured > 0
    assert abs(counted["temp_bytes"] / measured - 1) <= PEAK_RTOL, (counted, measured)
    rank = counted["per_rank_bytes"]
    assert counted["argument_bytes"] == rank["params"] + rank["moments"] + rank["inputs"]
    if kind == "train":
        assert counted["temp_bytes"] >= rank["grads"]
        assert counted["output_bytes"] == 8          # the loss and the norm; the rest in place
    else:
        assert counted["output_bytes"] > 0           # logits and the cache


# ------------------------------------------------------------------ the kernels
def _ssd_dims(arch, reduced):
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    seq = 4 * cfg.ssm_chunk
    return 1, seq, heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk


def _nbytes(shape, item=4):
    return math.prod(shape) * item


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_ssd_scan_bwd_meta_allocates_the_card_buffers(reduced):
    b, s, h, p, n, chunk = _ssd_dims("mamba2-1.3b", reduced)
    f32 = dict(dtype=torch.float32, device=META)
    args = (torch.empty((b, s, h, p), **f32), torch.empty((b, s, h), **f32),
            torch.empty((b, s, n), **f32), torch.empty((b, s, n), **f32))
    rest = (torch.empty((b, s // chunk, h, p, n), **f32), torch.empty((b, s, h, p), **f32),
            torch.empty((b, h, p, n), **f32))
    plan = ssd_mod.ssd_bwd_plan(b, s, h, p, n, chunk)
    outs = _nbytes((b, s, h, p)) + _nbytes((b, s, h)) + 2 * _nbytes((b, s, n))
    buffers = _nbytes(plan.dh_end) + 2 * _nbytes(plan.partials)

    def bwd(x, dta, bm, cm, states, dy, dfinal):
        return ssd_mod.ssd_scan_bwd(x, dta, bm, cm, chunk, states, dy, dfinal)
    out, peak, live = _watched(bwd, *args, *rest)
    assert peak == buffers + outs
    assert live == outs                 # the buffers died with the call, as on the card
    # B and C in bf16, as the model passes them: the card route's float32 copies
    half = (args[0], args[1]) + tuple(t.to(torch.bfloat16) for t in args[2:])
    _, peak, live = _watched(bwd, *half, *rest)
    assert peak == buffers + outs + 2 * _nbytes((b, s, n)) and live == outs
    del out


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_ssd_scan_meta_allocates_the_card_outputs_and_copies(reduced):
    b, s, h, p, n, chunk = _ssd_dims("mamba2-1.3b", reduced)
    f32 = dict(dtype=torch.float32, device=META)
    x, dta = torch.empty((b, s, h, p), **f32), torch.empty((b, s, h), **f32)
    bc = torch.empty((b, s, 2 * n), dtype=torch.bfloat16, device=META)

    def fwd(x, dta, bc):
        return ssd_mod.ssd_scan(x, dta, bc[..., :n], bc[..., n:], chunk=chunk,
                                return_all_states=True)
    out, peak, live = _watched(fwd, x, dta, bc)
    outs = _nbytes((b, s, h, p)) + _nbytes((b, h, p, n)) + _nbytes((b, s // chunk, h, p, n))
    assert live == outs and peak == outs + 2 * _nbytes((b, s, n))
    del out


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rglru_meta_routes_allocate_the_card_buffers(reduced, dtype):
    cfg = get_config("recurrentgemma-9b")
    cfg = cfg.reduced() if reduced else cfg
    b, s, w = 1, 300, cfg.lru_width or cfg.d_model
    item = torch.empty((), dtype=dtype).element_size()
    a = torch.empty((b, s, w), dtype=dtype, device=META)
    rglru_mod.rglru_plan(b, s, w, dtype)           # the card's checks pass here
    h, peak, live = _watched(rglru_mod.rglru_scan, a, a.clone())
    assert peak == live == _nbytes((b, s, w))      # h, float32
    g = torch.empty((b, s, w), device=META)
    rglru_mod.rglru_bwd_plan(b, s, w, dtype)
    out, peak, live = _watched(rglru_mod.rglru_scan_bwd, a, h, g)
    assert peak == live == 2 * _nbytes((b, s, w), item)
    # a view that starts off a 16-byte boundary is copied before the
    # launch, on the card and here
    view = torch.empty(b * s * w + 1, dtype=dtype, device=META)[1:].view(b, s, w)
    _, peak, live = _watched(rglru_mod.rglru_scan, view, view)
    assert live == _nbytes((b, s, w)) and peak == live + 2 * _nbytes((b, s, w), item)
    del out


def test_rglru_meta_route_raises_where_the_card_route_does():
    a = torch.empty((1, 8, 6), device=META)        # 24-byte rows: no 16-byte copies
    with pytest.raises(ValueError, match="16 bytes"):
        rglru_mod.rglru_scan(a, a)
    with pytest.raises(ValueError, match="16 bytes"):
        rglru_mod.rglru_scan_bwd(a, a, a)


# ------------------------------------------------- faults the count found
@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b", "mamba2-1.3b"])
def test_production_mesh_rank_holds_no_replicated_batch(arch):
    cfg = get_config(arch).reduced()
    with dryrun.fake_world(256):
        sharded = dryrun.measure(cfg, InputShape("train", S, 256, "train"),
                                 make_production_mesh(multi_pod=False, device_type="cpu"))
    with dryrun.fake_world(1):
        one = dryrun.measure(cfg, InputShape("train", S, 256 // 16, "train"),
                             make_mesh((1, 1), ("data", "model"), device_type="cpu"))
    assert sharded["temp_bytes"] <= 1.05 * one["temp_bytes"], (sharded, one)


_GOLD = """
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.training.train_step import _gold, _logz

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=2)
g = torch.Generator().manual_seed(0)
logits = torch.randn(4, 5, 8, generator=g)
idx = torch.randint(0, 8, (4, 5), generator=g)
w = torch.randn(4, 5, generator=g)
want = torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
want_grad = torch.zeros_like(logits).scatter_add_(-1, idx[..., None], w[..., None])
for shape, pl in (((1, 2), [Replicate(), Shard(2)]), ((2, 1), [Shard(0), Replicate()])):
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    lg = distribute_tensor(logits, mesh, pl).requires_grad_()
    ix = distribute_tensor(idx, mesh, [p if p == Shard(0) else Replicate() for p in pl])
    gold = _gold(lg, ix)
    assert torch.equal(gold.full_tensor(), want), shape
    (gold.full_tensor() * w).sum().backward()
    assert tuple(lg.grad.placements) == tuple(pl), lg.grad.placements
    assert torch.equal(lg.grad.full_tensor(), want_grad), shape
    lg.grad = None
    logz = _logz(lg)
    assert torch.allclose(logz.full_tensor(), torch.logsumexp(logits, dim=-1),
                          rtol=1e-6, atol=0), shape
    (logz.full_tensor() * w).sum().backward()
    assert tuple(lg.grad.placements) == tuple(pl), lg.grad.placements
    assert torch.allclose(lg.grad.full_tensor(), torch.softmax(logits, dim=-1) * w[..., None],
                          rtol=1e-5, atol=1e-7), shape
dist.destroy_process_group()
print("ok")
"""


def test_loss_terms_on_vocab_shards_equal_the_plain_ones():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _GOLD, str(r), str(port)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err[-3000:]
