"""``python -m repro_torch.launch.dryrun`` on the CPU, against the reference's
arithmetic.

The CLI opens its own ``fake`` process group (256 and 512 ranks), so it
runs in subprocesses: one per family (dense, MoE, SSM, hybrid, vision-
language, audio), each on the ``.reduced()`` config, all four input
shapes on both production meshes. Every record must be ``ok``; the file
names and the record keys are the reference's; the per-rank parameter
bytes are the sum of JAX's shard arithmetic over JAX's ``param_specs``
(each dim divided by the product of the axes its spec names);
``model_flops_global`` is the reference's 6 (train) or 2 x N_active x
tokens; and the memory analysis is whole: integer ``temp_bytes`` above 0
(a train step's at least its gradients) and ``output_bytes``, no
``generated_code_bytes``.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["qwen3-4b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "recurrentgemma-9b",
            "qwen2-vl-72b", "musicgen-medium"]
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
TIMEOUT = 240


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{(arch, shape, mesh): record} from one CLI run a family, run side by
    side, one torch thread each."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--both-meshes", "--reduced", "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in FAMILIES]
    logs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            logs.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            p.kill()
    for arch, (rc, stdout, stderr) in zip(FAMILIES, logs):
        assert rc == 0, f"{arch}: {stdout[-2000:]}{stderr[-2000:]}"
        assert stdout.splitlines()[-1] == "[dryrun] done: 8/8 OK", stdout[-2000:]
    recs = {}
    for f in sorted(out.glob("*.json")):
        rec = json.loads(f.read_text())
        assert f.name == f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return recs


def test_every_combination_ran(records):
    want = {(a, s, m) for a in FAMILIES for s in INPUT_SHAPES for m in MESHES}
    assert set(records) == want
    assert all(r["ok"] for r in records.values())


def _reference_keys():
    """The record keys the reference's ``run_one`` writes."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    first = re.search(r"rec = \{(.*?)\}", src, re.S).group(1)
    keys = set(re.findall(r'"(\w+)":', first)) | set(re.findall(r'rec\["(\w+)"\]', src))
    return keys - {"error", "traceback"}


def test_record_keys_are_the_reference_s(records):
    keys = _reference_keys()
    assert {"arch", "shape", "mesh", "chips", "ok", "flops", "collectives",
            "roofline", "model_flops_global"} <= keys
    for rec in records.values():
        missing = keys - set(rec) - ({"useful_ratio"} if not rec["flops"] else set())
        assert not missing, (rec["arch"], rec["shape"], missing)
        assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                        "dominant"}
        assert {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "total", "count"} <= set(rec["collectives"])
        assert rec["chips"] == (512 if rec["mesh"] == "pod2x16x16" else 256)
        assert rec["fits_80gb"] is None          # no card here: not measured
        mem = rec["memory"]
        assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                            "generated_code_bytes"}
        assert all(type(mem[k]) is int for k in ("argument_bytes", "output_bytes",
                                                  "temp_bytes"))
        assert mem["generated_code_bytes"] is None     # eager: no executable


def _param_bytes(arch, mesh):
    """Per-rank parameter bytes by JAX's shard arithmetic."""
    stand_in = SimpleNamespace(shape=mesh)
    total = 0
    specs = JModel(jget_config(arch).reduced()).param_specs()
    for path, leaf in jax.tree_util.tree_flatten_with_path(specs)[0]:
        names = [k.key for k in path if isinstance(getattr(k, "key", None), str)]
        spec = jsh._leaf_spec(names, leaf, stand_in)
        n = 1
        for d, s in zip(leaf.shape, spec):
            axes = (s,) if isinstance(s, str) else (s or ())
            n *= d // int(np.prod([mesh[a] for a in axes]))
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", FAMILIES)
def test_per_rank_bytes_and_model_flops_are_the_reference_s(records, arch):
    cfg = jget_config(arch).reduced()
    for (a, shape_name, mesh_name), rec in records.items():
        if a != arch:
            continue
        rank = rec["per_rank_bytes"]
        assert rank["params"] == _param_bytes(arch, MESHES[mesh_name])
        shape = INPUT_SHAPES[shape_name]
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        mult = 6 if shape.kind == "train" else 2
        assert rec["model_flops_global"] == mult * cfg.active_param_count * tokens
        assert rec["model_flops_per_chip"] == rec["model_flops_global"] / rec["chips"]
        if shape.kind == "train":
            assert rank["grads"] == rank["params"] and rank["moments"] > 0
        else:
            assert rank["grads"] == rank["moments"] == 0
        assert rank["total"] == sum(v for k, v in rank.items() if k != "total")
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_memory_counts_the_step_s_temporaries(records, arch):
    """Every record's ``temp_bytes`` (the traced step's live-bytes peak past
    its arguments) is positive; a train step's holds at least its
    gradients, and returns only the loss and the norm beside the arguments
    it updates in place; ``argument_bytes`` are the bytes live at entry."""
    for (a, shape_name, _), rec in records.items():
        if a != arch:
            continue
        mem, rank = rec["memory"], rec["per_rank_bytes"]
        assert mem["temp_bytes"] > 0, (shape_name, mem)
        assert mem["argument_bytes"] == rank["params"] + rank["moments"] + rank["inputs"]
        if INPUT_SHAPES[shape_name].kind == "train":
            assert mem["temp_bytes"] >= rank["grads"] > 0
            assert mem["output_bytes"] == 8
        else:
            assert mem["output_bytes"] > 0
