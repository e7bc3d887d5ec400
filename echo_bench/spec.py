"""What a run serves, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits its check compares against
(``limits/<cell>.json``) and the per-layer metrics it reports
(``metrics/<name>.py``). Adding any of them is adding a file."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(ValueError):
    """A cell, configuration, mix or metric that the files do not define."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path.relative_to(ROOT)} does not exist")
    with path.open() as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[name]
    here = root / HERE.name
    config = _load(here / "configs" / f"{w['config']}.json")
    if config["name"] != w["config"]:
        raise SpecError(f"configs/{w['config']}.json names itself {config['name']!r}")
    traffic = _load(here / "traffic" / f"{w['traffic']}.json")
    limits = _load(here / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<name>.py``. A metric's name
    may hold dots, so the file is loaded by its path, not imported."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path.relative_to(root)} for metric {name!r}")
    modname = "echo_bench.metrics." + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
