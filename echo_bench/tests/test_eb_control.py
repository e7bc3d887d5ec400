"""The control: the reference computed in fp8 (the precision below the
configuration's bf16; float32's below on the tiny CPU cell) in the
program's place reads above the cell's limit, where the program reads
below it. On the CPU at the tiny size; on the card at the cells' own
sizes (one seed each; ``tools/readings.py`` takes the dozen)."""
from __future__ import annotations

import json

import pytest

from conftest import TINY_CELL, make_checkout

CELLS = ["yi-9b.docqa", "qwen3-4b.docqa"]


def test_control_fails_the_tiny_limit(tmp_path):
    from echo_bench.spec import load_cell
    from echo_bench.tools.readings import reading
    root = make_checkout(tmp_path)
    cell = load_cell(TINY_CELL, root)
    r = reading(cell, 2147483647, 2.0, control=True)
    limit = cell.limits["max_logit_gap"]
    assert r["max_logit_gap"] <= limit < r["control_gap"], json.dumps(r)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_limit_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from echo_bench.spec import ROOT, load_cell
    from echo_bench.tools.readings import reading
    cell = load_cell(name, ROOT)
    r = reading(cell, 977, 10.0, control=True)
    limit = cell.limits["max_logit_gap"]
    assert r["max_logit_gap"] <= limit < r["control_gap"], json.dumps(r)
