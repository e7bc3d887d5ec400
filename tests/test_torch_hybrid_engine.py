"""The port's engine on the hybrid RG-LRU family against the JAX engine with
the same weights, on recurrentgemma reduced to 5 layers with a window of 8
(one scanned (rglru, rglru, attn) unit and the unrolled (rglru, rglru), as
at full width; prompts longer than the window): snapshot prefix sharing
and the dense path's tokens (tests/test_engine.py's hybrid scenario),
preemption by recompute, a host-tier round trip, and the aliasing contract
of the snapshot pool over the attention ring. Then the legacy serial-page
decode schedule (``attn_impl="pallas"``) against the JAX engine's in
interpret mode, on the tiny attention model."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.state_cache import StateRunner  # noqa: E402
from repro_torch.params import from_jax, tree_leaves  # noqa: E402

BS = 16          # block size: two blocks span the window's ring twice


def _pair(jcfg, seed=0):
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    return (jm, jp), (tm, from_jax(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.fixture(scope="module")
def models():
    return _pair(dataclasses.replace(jget_config("recurrentgemma-9b").reduced(),
                                     num_layers=5, window=8))


def _prompt(rng, vocab, n):
    return tuple(int(x) for x in rng.integers(0, vocab, n))


def _serve(core, model, params, reqs, **eng_kw):
    eng = core.EchoEngine(model, params, core.ECHO, **eng_kw)
    reqs = [core.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                         task_type=getattr(core.TaskType, r.task_type.name),
                         arrival_time=r.arrival_time,
                         slo=core.SLO(r.slo.ttft, r.slo.tpot) if r.slo else None)
            for r in reqs]
    for r in reqs:
        eng.submit(r)
    eng.run(max_iters=2000)
    assert all(r.done for r in reqs)
    return eng, reqs


def _compare(models, reqs, **eng_kw):
    """Serve ``reqs`` (port Requests) through both engines: equal greedy
    tokens and preemption counts."""
    (jm, jp), (tm, tp) = models
    jeng, jreqs = _serve(jcore, jm, jp, reqs, **eng_kw)
    teng, treqs = _serve(tcore, tm, tp, reqs, device="cpu", **eng_kw)
    for j, t in zip(jreqs, treqs):
        assert t.output_tokens == j.output_tokens
        assert t.n_preemptions == j.n_preemptions
    return jeng, teng, jreqs, treqs


def _dense_generate(model, params, prompt, n_new):
    """tests/test_engine.py's dense-path oracle, on the port:
    ``Model.prefill`` + ``pad_cache`` + ``decode_step``."""
    last, cache = model.prefill(params, torch.tensor([prompt]))
    cache = model.pad_cache(cache, len(prompt), len(prompt) + n_new + 1)
    out = [int(torch.argmax(last[0]))]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        lg, cache = model.decode_step(params, torch.tensor([out[-1]]), cache,
                                      torch.tensor([pos]))
        out.append(int(torch.argmax(lg[0])))
    return out


def test_snapshot_prefix_sharing_matches_jax_engine_and_dense_path(models):
    """Two questions over one 32-token document: the second resumes from
    the document's boundary snapshot, and both engines give the tokens of
    the port's dense path."""
    tm, tp = models[1]
    rng = np.random.default_rng(4)
    doc = _prompt(rng, tm.cfg.vocab_size, 32)
    reqs = [tcore.Request(prompt=doc + _prompt(rng, tm.cfg.vocab_size, 7),
                          max_new_tokens=4, task_type=tcore.TaskType.OFFLINE)
            for _ in range(2)]
    jeng, teng, _, treqs = _compare(models, reqs, num_blocks=64, block_size=BS,
                                    chunk_size=BS, max_pages_per_seq=16)
    assert isinstance(teng.runner, StateRunner)
    assert teng.runner.span_calls == 0, "the hybrid runner has no span function"
    assert teng.bm.metrics.hit_blocks > 0, "snapshot prefix must be reused"
    assert teng.bm.metrics.hit_blocks == jeng.bm.metrics.hit_blocks
    with torch.inference_mode():
        for r in treqs:
            assert r.output_tokens == _dense_generate(tm, tp, r.prompt, 4)


def test_preemption_recompute_matches_jax_engine(models):
    cfg = models[1][0].cfg
    rng = np.random.default_rng(2)
    reqs = [tcore.Request(prompt=_prompt(rng, cfg.vocab_size, 3 * BS),
                          max_new_tokens=6, task_type=tcore.TaskType.OFFLINE)
            for _ in range(3)]
    reqs.append(tcore.Request(prompt=_prompt(rng, cfg.vocab_size, 3 * BS),
                              max_new_tokens=6, task_type=tcore.TaskType.ONLINE,
                              arrival_time=0.0004, slo=tcore.SLO(30.0, 5.0)))
    _, _, _, treqs = _compare(models, reqs, num_blocks=8, block_size=BS,
                              chunk_size=2 * BS, max_pages_per_seq=16,
                              max_running=2)
    assert sum(r.n_preemptions for r in treqs) >= 1, "scenario must preempt"


def test_host_tier_swap_matches_jax_engine(models):
    """tests/test_state_tiering.py's workload: snapshots parked on the host
    tier and restored give the tokens of the JAX engine with the same tier,
    and of the port without it."""
    cfg = models[1][0].cfg
    rng = np.random.default_rng(3)
    doc = _prompt(rng, cfg.vocab_size, 3 * BS)
    reqs = [tcore.Request(prompt=doc + _prompt(rng, cfg.vocab_size, 7),
                          max_new_tokens=4, task_type=tcore.TaskType.OFFLINE)
            for _ in range(6)]
    reqs += [tcore.Request(prompt=_prompt(rng, cfg.vocab_size, 3 * BS),
                           max_new_tokens=4, task_type=tcore.TaskType.ONLINE,
                           arrival_time=0.0004 * (i + 1), slo=tcore.SLO(30.0, 5.0))
             for i in range(3)]
    kw = dict(num_blocks=8, block_size=BS, chunk_size=2 * BS,
              max_pages_per_seq=16, max_running=2)
    jeng, teng, _, treqs = _compare(models, reqs, host_kv_blocks=32, **kw)
    m = teng.bm.metrics
    assert m.swapped_out_tokens > 0 and m.swapped_in_tokens > 0
    assert m.swapped_out_bytes == jeng.bm.metrics.swapped_out_bytes
    assert m.swapped_in_bytes == jeng.bm.metrics.swapped_in_bytes
    tm, tp = models[1]
    _, plain = _serve(tcore, tm, tp, reqs, device="cpu", **kw)
    assert [r.output_tokens for r in plain] == [r.output_tokens for r in treqs]


def _snapshot(tree):
    return [t.clone() for t in tree_leaves(tree)]


def _same(tree, saved):
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), saved))


def test_snapshot_pool_is_never_aliased_by_ring_writes(models):
    """Blocks of 4 tokens against a ring of 8 slots: later decode steps
    overwrite every ring slot a stored snapshot holds, so a write into the
    ring in place would reach the snapshot (on the CPU a pool entry is the
    live state's own tensors). A resume from a boundary snapshot reaches
    the state of one uninterrupted prefill, and no stored snapshot moves."""
    tm, tp = models[1]
    bs = 4
    runner = StateRunner(tm, tp, 32, bs, 16, 2 * bs, device="cpu")
    toks = [int(t) for t in np.random.default_rng(0).integers(0, tm.cfg.vocab_size,
                                                              6 * bs)]
    runner.prefill_chunk(toks[:2 * bs], 0, [0, 1], rid=0)
    saved = {b: _snapshot(runner.pool[b]) for b in (0, 1)}
    # decode rid 0 across two boundaries (the pool then holds live states
    # the later steps must not reach) and once around the ring
    for p in range(2 * bs, 5 * bs):
        runner.decode([toks[p]], [[0, 1, 2, 3, 4]], [p], rids=[0])
    for b in (2, 3, 4):
        saved[b] = _snapshot(runner.pool[b])
    for p in range(5 * bs, 6 * bs):
        runner.decode([toks[p]], [[0, 1, 2, 3, 4, 5]], [p], rids=[0])

    # resume from block 1's snapshot; compare with one uninterrupted prefill
    runner.prefill_chunk(toks[2 * bs:4 * bs], 2 * bs, [0, 1, 6, 7], rid=1)
    runner.prefill_chunk(toks[:4 * bs], 0, [8, 9, 10, 11], rid=2)
    for a, b in zip(tree_leaves(runner.live[1]), tree_leaves(runner.live[2])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    for a, b in zip(tree_leaves(runner.pool[7]), tree_leaves(runner.pool[11])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    for rid in (1, 2):
        for p in range(4 * bs, 6 * bs):
            runner.decode([7], [[0]], [p], rids=[rid])
    for b, leaves in saved.items():
        assert _same(runner.pool[b], leaves), f"snapshot of block {b} changed"
    # a host-tier payload restored under another id and stepped from
    payload = runner.read_block(1)
    runner.write_block(20, payload)
    runner.prefill_chunk(toks[2 * bs:3 * bs], 2 * bs, [0, 20, 21], rid=3)
    for p in range(3 * bs, 5 * bs):
        runner.decode([9], [[0, 20, 21, 22, 23]], [p], rids=[3])
    assert _same(runner.pool[1], saved[1]) and _same(payload, saved[1])


def test_legacy_schedule_engine_matches_jax_engine(tiny_cfg):
    """``attn_impl="pallas"``: the port's engine (the legacy kernel's plain
    version on the CPU) against the JAX engine running its legacy Pallas
    decode kernel in interpret mode, with prefix sharing and a preemption."""
    (jm, jp), (tm, tp) = _pair(tiny_cfg)
    rng = np.random.default_rng(1)
    doc = _prompt(rng, tiny_cfg.vocab_size, 24)
    reqs = [tcore.Request(prompt=doc + _prompt(rng, tiny_cfg.vocab_size, 8),
                          max_new_tokens=5, task_type=tcore.TaskType.OFFLINE)
            for _ in range(2)]
    reqs.append(tcore.Request(prompt=_prompt(rng, tiny_cfg.vocab_size, 40),
                              max_new_tokens=5, task_type=tcore.TaskType.ONLINE,
                              arrival_time=0.002, slo=tcore.SLO(10, 10)))
    kw = dict(num_blocks=14, block_size=8, chunk_size=16, max_pages_per_seq=16,
              attn_impl="pallas")
    jeng, teng, _, treqs = _compare(((jm, jp), (tm, tp)), reqs, **kw)
    assert teng.runner.attn_impl == "pallas"
    assert teng.bm.metrics.hit_blocks > 0
