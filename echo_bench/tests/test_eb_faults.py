"""A run with the served path broken underneath, on the tiny CPU cell:
the check has to come out false for each fault a one-chip serving cell
can have (no exchange between chips exists on one chip)."""
from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import TINY_CELL


def _token_altered(sess, monkeypatch):
    runner = sess.engine.runner
    decode = runner.decode

    def bad(tokens, block_tables, pos, rids=None):
        out = decode(tokens, block_tables, pos, rids=rids)
        out[0] = np.roll(out[0], 1)               # row 0's best token moves by one
        return out
    runner.decode = bad


def _half_batch(sess, monkeypatch):
    runner = sess.engine.runner
    decode = runner.decode

    def bad(tokens, block_tables, pos, rids=None):
        h = max(len(tokens) // 2, 1)
        out = decode(tokens[:h], block_tables[:h], pos[:h])
        return np.concatenate([out] + [out[:1]] * (len(tokens) - h))
    runner.decode = bad


def _state_unchanged(sess, monkeypatch):
    from repro_torch.models import paged
    monkeypatch.setattr(paged, "_write_pages", lambda pages, idx, new: None)


@pytest.mark.parametrize("fault", [None, _token_altered, _half_batch, _state_unchanged],
                         ids=["none", "token_altered", "half_batch", "state_unchanged"])
def test_a_broken_path_is_not_correct(checkout, monkeypatch, capsys, fault):
    from echo_bench import run
    monkeypatch.setattr(run, "ROOT", checkout)
    patch = None if fault is None else (lambda sess: fault(sess, monkeypatch))
    rc = run.main(["--workload", TINY_CELL, "--seed", "2147483701", "--seconds", "2",
                   "--trace", "0"], patch=patch)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is (fault is None), out["check"]
    if fault is not None:      # caught by the comparison itself
        assert out["check"]["max_logit_gap"]["value"] > out["check"]["max_logit_gap"]["limit"]
