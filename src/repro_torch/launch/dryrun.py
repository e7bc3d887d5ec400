"""Multi-pod dry run: trace every (arch x input-shape x mesh) step on the
production mesh, shape only, in one process.

The port of ``repro/launch/dryrun.py``, rewritten: PyTorch has no HLO to
lower and compile. This process opens a ``fake`` process group of the
mesh's world size (256 or 512 ranks; the store is
``torch.testing._internal.distributed.fake_pg.FakeStore``, a private
testing module of PyTorch), in which every collective returns at once, and
builds the production ``DeviceMesh`` over it. The step then runs as rank
0 would run it, on ``meta`` DTensors distributed by the sharding rules,
with the logical-axis hook installed (``repro_torch.launch.sharding``):

* train: ``make_train_step`` with ZeRO-1 AdamW moments (sharded like each
  parameter plus over ``("data", "pod")``);
* prefill: ``Model.prefill``;
* decode: ``Model.decode_step`` over the sharded cache.

Nothing is allocated and nothing is computed; the scan kernels take their
shape-only ``meta`` route. Per rank (rank 0's shard), each record holds:

* the bytes of the parameters, gradients, moments and inputs (the decode
  cache among them), exact, from the local shard shapes;
* ``flops``: the products' operations (PyTorch's flop formulas for mm,
  bmm, convolution, attention) counted on the local ops each rank runs,
  plus the scan kernels' own counts (``ssd_fwd_flops``, ``ssd_bwd_work``,
  ``rglru_flops``); elementwise work is not counted, as in
  ``FlopCounterMode``, which would count the same products on the global
  shapes;
* ``bytes_accessed``: every local op's operand and result bytes, views
  excluded, as eager PyTorch runs them unfused, plus the kernels' operands;
* ``collectives``: each collective's result bytes by op, counted by a
  ``CommDebugMode``;
* ``model_flops_global`` and ``model_flops_per_chip``: 6 (train) or 2
  (prefill, decode) x N_active x tokens, as in the reference;
* ``compile_s``: the wall seconds of building and tracing the step;
* a roofline at the datasheet peaks of an NVIDIA H100 SXM (80GB HBM3,
  700 W): ``compute_s`` at 989 TFLOP/s (bf16), ``memory_s`` at 3.35 TB/s,
  ``collective_s`` at 450 GB/s a direction (NVLink), a lower bound: a
  `model` axis of 16 spans two 8-card NVLink domains, and no rate between
  them is known here;
* ``fits_80gb``: whether a rank's parameters, gradients, moments and
  inputs fit the card's memory as ``torch.cuda.get_device_properties``
  reports it; None where no card is present.

It does not reproduce: XLA's ``memory_analysis`` temporaries (the
activation peak: ``memory.temp_bytes`` is None), HLO-level collective
fusion (every DTensor redistribution is counted as eager PyTorch issues
it), and ``probe_corrected``: eager execution traces every layer, so no
scan body is counted once and ``corrected`` holds the direct counts.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --reduced

``--reduced`` (port-only) traces each arch's ``.reduced()`` config.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._guards import detect_fake_mode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape
from repro_torch.kernels import rglru_scan as rglru_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import (distribute, input_specs, on_mesh,
                                         param_shardings, zero1_adamw_init)
from repro_torch.models.model import Model
from repro_torch.params import tree_leaves
from repro_torch.training.train_step import make_train_step

# NVIDIA H100 SXM (80GB HBM3, 700 W) datasheet peaks
PEAK_FLOPS = 989e12        # bf16 dense, per card
HBM_BW = 3.35e12           # B/s per card
NVLINK_BW = 450e9          # B/s a direction per card; a lower bound (see above)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_KERNELS = (ssd_mod.ssd_scan, ssd_mod.ssd_scan_bwd, rglru_mod.rglru_scan,
            rglru_mod.rglru_scan_bwd)


def _collective_name(op_name: str) -> str:
    """The reference's HLO op name of a torch collective."""
    for key, name in (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                      ("all_gather", "all-gather"), ("allgather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("alltoall", "all-to-all"), ("all_to_all", "all-to-all")):
        if key in op_name:
            return name
    return "collective-permute"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class RankCounter(CommDebugMode):
    """A ``CommDebugMode`` that also sums, over the local ops of rank 0
    (it lets DTensor dispatch first and sees what DTensor runs locally),
    each collective's result bytes by op, the products' operations
    (``torch.utils.flop_counter``'s formulas) and every op's operand and
    result bytes (views excluded)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if detect_fake_mode(args):
            return out          # DTensor's shape propagation, not a rank's op
        pkt = func._overloadpacket
        if pkt in self.comm_registry:
            self.comm_counts[pkt] += 1
            self.coll[_collective_name(pkt.__name__)] += _nbytes(_tensors(out))
            self.count += 1
            return out
        if pkt in flop_registry:
            self.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
        returns = func._schema.returns
        if not any(r.alias_info is not None and not r.alias_info.is_write for r in returns):
            self.bytes += _nbytes(_tensors(args) + _tensors(kwargs) + _tensors(out))
        return out


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() if isinstance(t, DTensor)
               else t.numel() * t.element_size() for t in tree_leaves(tree))


def _device_memory():
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


def measure(cfg, shape, mesh) -> dict:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a mesh over the
    process group that is up) with meta tensors, and count it. Returns the
    per-rank bytes, flops, bytes accessed and collectives."""
    model = Model(cfg)
    pspecs = model.param_specs()
    params = param_shardings(pspecs, mesh)
    args, placements = input_specs(cfg, shape, mesh)
    batch = distribute(args, placements, mesh)
    rank = {"params": _local_bytes(params), "inputs": _local_bytes(batch),
            "grads": 0, "moments": 0}
    for k in _KERNELS:
        k.meta_flops, k.meta_bytes = 0, 0
    counter = RankCounter()
    with counter, on_mesh(mesh):
        if shape.kind == "train":
            opt = zero1_adamw_init(params, mesh)
            rank["grads"] = rank["params"]     # a gradient is laid out as its parameter
            rank["moments"] = _local_bytes((opt.m, opt.v))
            step = make_train_step(model, device="cpu")
            out = step(params, opt, batch)
        elif shape.kind == "prefill":
            out = model.prefill(params, batch["tokens"], mm_embeds=batch.get("mm_embeds"))
        else:
            out = model.decode_step(params, batch["tokens"], batch["cache"], batch["pos"])
    rank["total"] = sum(rank.values())
    kernel_flops = sum(k.meta_flops for k in _KERNELS)
    coll = dict(counter.coll)
    coll["total"] = sum(counter.coll.values())
    coll["count"] = counter.count
    del out
    return {"per_rank_bytes": rank, "flops": float(counter.flops + kernel_flops),
            "kernel_flops": float(kernel_flops),
            "bytes_accessed": float(counter.bytes + sum(k.meta_bytes for k in _KERNELS)),
            "collectives": coll}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process being rank 0, destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            verbose: bool = True, reduced: bool = False) -> dict:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = get_shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "ok": False}
    if reduced:
        rec["config"] = cfg.name
    t0 = time.time()
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            m = measure(cfg, shape, mesh)
        rec["compile_s"] = round(time.time() - t0, 1)
        rec["wall_s"] = time.time() - t0
        rec["flops"] = m["flops"]
        rec["kernel_flops"] = m["kernel_flops"]
        rec["bytes_accessed"] = m["bytes_accessed"]
        rank = m["per_rank_bytes"]
        rec["per_rank_bytes"] = rank
        rec["memory"] = {
            "argument_bytes": rank["params"] + rank["moments"] + rank["inputs"],
            "output_bytes": None,       # updated in place, or logits + cache (not kept)
            "temp_bytes": None,         # the activation peak: not reproduced
            "generated_code_bytes": None,
        }
        cap = _device_memory()
        rec["device_memory_bytes"] = cap
        rec["fits_80gb"] = None if cap is None else rank["total"] <= cap
        rec["collectives"] = m["collectives"]
        rec["corrected"] = {"flops": m["flops"], "bytes": m["bytes_accessed"],
                            "collectives": {k: v for k, v in m["collectives"].items()
                                            if k != "count"}}
        rec["roofline"] = {
            "compute_s": m["flops"] / PEAK_FLOPS,
            "memory_s": m["bytes_accessed"] / HBM_BW,
            "collective_s": m["collectives"]["total"] / NVLINK_BW,
        }
        dom = max(rec["roofline"], key=rec["roofline"].get)
        rec["roofline"]["dominant"] = dom
        # MODEL_FLOPS (useful compute): 6*N_active*D train, 2*N_active*D fwd
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        mult = 6 if shape.kind == "train" else 2
        rec["model_flops_global"] = mult * cfg.active_param_count * tokens
        rec["model_flops_per_chip"] = rec["model_flops_global"] / chips
        if m["flops"] > 0:
            rec["useful_ratio"] = rec["model_flops_per_chip"] / m["flops"]
        rec["ok"] = True
    except Exception as e:  # a failure here is a bug in the system
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}_{shape_name}_{mesh_name}.json".replace("/", "_")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')})"
        extra = ""
        if rec["ok"]:
            rank = rec["per_rank_bytes"]
            extra = (f" flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e}"
                     f" coll={rec['collectives']['total']:.3e}"
                     f" rank_bytes={rank['total']:.3e} fits_80gb={rec['fits_80gb']}"
                     f" t={rec['compile_s']}s")
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: {status}{extra}",
              flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="trace each arch's .reduced() config (port-only)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args()

    combos = []
    archs = ARCH_IDS if args.all or not args.arch else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if args.all or not args.shape else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multipod,)
    for a in archs:
        for s in shapes:
            for mp in meshes:
                combos.append((a, s, mp))

    failures = 0
    for a, s, mp in combos:
        rec = run_one(a, s, mp, args.out, reduced=args.reduced)
        failures += 0 if rec["ok"] else 1
    print(f"[dryrun] done: {len(combos) - failures}/{len(combos)} OK")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
