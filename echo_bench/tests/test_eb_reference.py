"""The plain reference against the port's paged runner on the CPU at tiny
sizes: prefill over several chunks, a request whose prefix pages come from
another request's KV, decode steps; the tied and qk-norm layout and the
untied one without qk-norm."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from echo_bench import reference
from echo_bench.weights import make_params

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=256, rope_theta=10000.0, norm_eps=1e-6, dtype="float32")
VARIANTS = {"qwen3-4b": dict(qk_norm=True, tie_embeddings=True),
            "yi-9b": dict(qk_norm=False, tie_embeddings=False)}


def _port(arch, m):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.paged import TorchPagedRunner
    cfg = dataclasses.replace(get_config(arch), **m)
    params = make_params(m, 3, "cpu")
    runner = TorchPagedRunner(Model(cfg), params, 64, 4, 16, 8, device="cpu")
    return params, runner


@pytest.mark.parametrize("arch", sorted(VARIANTS))
def test_reference_matches_the_runner(arch):
    m = dict(TINY, **VARIANTS[arch])
    params, runner = _port(arch, m)
    rng = np.random.default_rng(0)
    a = [int(x) for x in rng.integers(0, 256, 30)]
    b = a[:16] + [int(x) for x in rng.integers(0, 256, 13)]
    table_a, table_b = list(range(10)), list(range(4)) + list(range(20, 26))
    got, want_rows = {}, {"a": [], "b": []}
    for start in range(0, 30, 8):                     # four chunks, the last short
        chunk = a[start:start + 8]
        got[("a", start + len(chunk) - 1)] = runner.prefill_chunk(chunk, start, table_a)
    for start in (16, 24):                            # b's first 16 tokens: a's pages
        chunk = b[start:start + 8]
        got[("b", start + len(chunk) - 1)] = runner.prefill_chunk(chunk, start, table_b)
    seq = {"a": list(a), "b": list(b)}
    for step in range(3):                             # decode both, batched
        toks = [int(rng.integers(0, 256)) for _ in range(2)]
        pos = [len(seq["a"]), len(seq["b"])]
        out = runner.decode(toks, [table_a, table_b], pos)
        for i, k in enumerate("ab"):
            seq[k].append(toks[i])
            got[(k, pos[i])] = out[i]
    for k, p in got:
        want_rows[k].append(p)
    ref = reference.logits_at(m, params, [seq["a"], seq["b"]],
                              [want_rows["a"], want_rows["b"]])
    for r, k in zip(ref, "ab"):
        for row, p in zip(r, want_rows[k]):
            np.testing.assert_allclose(got[(k, p)], row.numpy(), atol=2e-5, rtol=1e-4)


def test_gap_is_zero_on_the_reference_argmax_and_positive_off_it():
    ref = torch.tensor([[0.1, 0.9, 0.3], [2.0, -1.0, 1.5]])
    assert reference.gaps(ref, torch.tensor([1, 0])).tolist() == [0.0, 0.0]
    assert reference.gaps(ref, torch.tensor([2, 2])).tolist() == pytest.approx([0.6, 0.5])


def test_fp8_control_departs_and_float32_does_not():
    m = dict(TINY, **VARIANTS["qwen3-4b"])
    params = make_params(m, 5, "cpu")
    rng = np.random.default_rng(1)
    seq = [int(x) for x in rng.integers(0, 256, 40)]
    rows = list(range(10, 40))
    full = reference.logits_at(m, params, [seq], [rows])[0]
    blocked = reference.logits_at(m, params, [seq], [rows], q_block=7, row_block=5)[0]
    torch.testing.assert_close(blocked, full, atol=1e-5, rtol=1e-5)
    ctl = reference.logits_at(m, params, [seq], [rows], quant="fp8")[0]
    assert float((ctl - full).abs().max()) > 1e-3
