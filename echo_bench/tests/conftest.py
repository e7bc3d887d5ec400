"""A checkout for the harness's CPU tests: ``BENCHMARK.json`` with a tiny
cell added, a copy of ``echo_bench`` with the tiny configuration, mix and
limits added as files (nothing in the copied files is edited), and the
port's ``src`` beside it. Run from the repository's root:

    python -m pytest -q echo_bench/tests
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
DATA = Path(__file__).resolve().parent / "data"
TINY_CELL = "tiny.tiny_mix"


def make_checkout(dest: Path, mix_name: str = "tiny_mix", mix: dict = None) -> Path:
    shutil.copytree(REPO / "echo_bench", dest / "echo_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (dest / "src").symlink_to(REPO / "src")
    eb = dest / "echo_bench"
    shutil.copy(DATA / "tiny.json", eb / "configs" / "tiny.json")
    mix = mix if mix is not None else json.loads((DATA / "tiny_mix.json").read_text())
    (eb / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    cell = f"tiny.{mix_name}"
    shutil.copy(DATA / "tiny_limits.json", eb / "limits" / f"{cell}.json")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests", "file":
                             "echo_bench/configs/tiny.json", "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": cell, "config": "tiny", "traffic": mix_name,
                               "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path)
