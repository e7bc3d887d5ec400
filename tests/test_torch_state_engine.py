"""The port's state-snapshot engine path against the JAX engine with the same
weights, on mamba2-1.3b reduced: the scenarios of tests/test_engine.py
(snapshot prefix sharing, preemption by recompute) and of
tests/test_state_tiering.py (a host-tier round trip), plus the aliasing
contract of the snapshot pool: torch tensors are mutable and ``t.to("cpu")``
returns ``t`` itself on the CPU, so no later step may reach a stored
snapshot."""
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


def _pair(jcfg, seed=0, edit=None):
    """The JAX model and params, and the port's with the same weights;
    ``edit`` rewrites the JAX params first."""
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    if edit is not None:
        jp = edit(jp)
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    return (jm, jp), (tm, from_jax(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.fixture(scope="module")
def models():
    return _pair(jget_config("mamba2-1.3b").reduced())


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


def test_snapshot_prefix_sharing_matches_jax_engine(models):
    """tests/test_engine.py's mamba2 scenario: two questions over one
    document reuse its boundary snapshots and give the JAX tokens."""
    cfg = models[1][0].cfg
    rng = np.random.default_rng(3)
    doc = _prompt(rng, cfg.vocab_size, 48)
    reqs = [tcore.Request(prompt=doc + _prompt(rng, cfg.vocab_size, 9),
                          max_new_tokens=5, task_type=tcore.TaskType.OFFLINE)
            for _ in range(2)]
    jeng, teng, _, _ = _compare(models, reqs, num_blocks=64,
                                block_size=cfg.ssm_chunk, chunk_size=32,
                                max_pages_per_seq=16)
    assert isinstance(teng.runner, StateRunner)
    assert teng.bm.metrics.hit_blocks > 0, "snapshot prefix must be reused"
    assert teng.bm.metrics.hit_blocks == jeng.bm.metrics.hit_blocks
    assert teng.runner.span_calls > 0


def test_preemption_recompute_matches_jax_engine(models):
    cfg = models[1][0].cfg
    bs = cfg.ssm_chunk
    rng = np.random.default_rng(2)
    reqs = [tcore.Request(prompt=_prompt(rng, cfg.vocab_size, 3 * bs),
                          max_new_tokens=6, task_type=tcore.TaskType.OFFLINE)
            for _ in range(3)]
    reqs.append(tcore.Request(prompt=_prompt(rng, cfg.vocab_size, 3 * bs),
                              max_new_tokens=6, task_type=tcore.TaskType.ONLINE,
                              arrival_time=0.0004, slo=tcore.SLO(30.0, 5.0)))
    _, _, _, treqs = _compare(models, reqs, num_blocks=8, block_size=bs,
                              chunk_size=2 * bs, max_pages_per_seq=16,
                              max_running=2)
    assert sum(r.n_preemptions for r in treqs) >= 1, "scenario must preempt"


def _tiering_workload(cfg, bs, seed=3):
    """tests/test_state_tiering.py's workload: one shared document with
    pooled questions, and an online burst that flushes it off the device."""
    rng = np.random.default_rng(seed)
    doc = _prompt(rng, cfg.vocab_size, 3 * bs)
    reqs = [tcore.Request(prompt=doc + _prompt(rng, cfg.vocab_size, 7),
                          max_new_tokens=4, task_type=tcore.TaskType.OFFLINE)
            for _ in range(6)]
    reqs += [tcore.Request(prompt=_prompt(rng, cfg.vocab_size, 3 * bs),
                           max_new_tokens=4, task_type=tcore.TaskType.ONLINE,
                           arrival_time=0.0004 * (i + 1), slo=tcore.SLO(30.0, 5.0))
             for i in range(3)]
    return reqs


def test_host_tier_swap_matches_jax_engine(models):
    """Snapshots parked on the host tier and restored give the tokens of
    the JAX engine with the same tier, and of the port without it."""
    cfg = models[1][0].cfg
    bs = cfg.ssm_chunk
    reqs = _tiering_workload(cfg, bs)
    kw = dict(num_blocks=8, block_size=bs, chunk_size=2 * bs,
              max_pages_per_seq=16, max_running=2)
    jeng, teng, _, treqs = _compare(models, reqs, host_kv_blocks=32, **kw)
    m = teng.bm.metrics
    assert m.swapped_out_tokens > 0 and m.swapped_in_tokens > 0
    assert m.swapped_out_bytes == jeng.bm.metrics.swapped_out_bytes
    assert m.swapped_in_bytes == jeng.bm.metrics.swapped_in_bytes
    (tm, tp) = models[1]
    _, plain = _serve(tcore, tm, tp, reqs, device="cpu", **kw)
    assert [r.output_tokens for r in plain] == [r.output_tokens for r in treqs]


def _snapshot(tree):
    return [t.clone() for t in tree_leaves(tree)]


def _same(tree, saved):
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), saved))


def test_snapshot_pool_is_never_aliased_by_later_steps():
    """With A_log very negative the decay is slow, so a wrong or corrupted
    snapshot changes the state visibly. A resume from a boundary snapshot
    reaches the state of one uninterrupted prefill, and neither the resume
    nor later decode steps (including one that stores the live state itself
    as a boundary snapshot) change a stored snapshot."""
    def slow(params):
        (blocks,) = params["layers"][0]
        blocks["ssm"]["A_log"] = blocks["ssm"]["A_log"] - 8.0
        return params
    _, (tm, tp) = _pair(jget_config("mamba2-1.3b").reduced(), seed=4, edit=slow)
    bs = tm.cfg.ssm_chunk
    runner = StateRunner(tm, tp, 16, bs, 16, 2 * bs, device="cpu")
    toks = list(np.random.default_rng(0).integers(0, tm.cfg.vocab_size, 4 * bs))
    toks = [int(t) for t in toks]

    runner.prefill_chunk(toks[:2 * bs], 0, [0, 1], rid=0)
    saved = {b: _snapshot(runner.pool[b]) for b in (0, 1)}
    # decode rid 0 across the boundary of block 2: the pool then holds the
    # live state of that step, and the steps after it must not reach it
    for p in range(2 * bs, 3 * bs):
        runner.decode([toks[p]], [[0, 1, 2, 3]], [p], rids=[0])
    assert 2 in runner.pool
    saved[2] = _snapshot(runner.pool[2])
    for p in range(3 * bs, 3 * bs + 3):
        runner.decode([toks[p]], [[0, 1, 2, 3]], [p], rids=[0])

    # resume a new request from block 1's snapshot; compare with one
    # uninterrupted prefill of the same tokens
    runner.prefill_chunk(toks[2 * bs:], 2 * bs, [0, 1, 4, 5], rid=1)
    runner.prefill_chunk(toks, 0, [6, 7, 8, 9], rid=2)
    for a, b in zip(tree_leaves(runner.live[1]), tree_leaves(runner.live[2])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    for a, b in zip(tree_leaves(runner.pool[5]), tree_leaves(runner.pool[9])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    # more steps on every live request; no stored snapshot moved
    for rid, p in ((1, 4 * bs), (2, 4 * bs)):
        runner.decode([7], [[0]], [p], rids=[rid])
    for b, leaves in saved.items():
        assert _same(runner.pool[b], leaves), f"snapshot of block {b} changed"
    # the host tier's payload is the pool entry; restoring it elsewhere and
    # stepping from it leaves the original untouched
    payload = runner.read_block(1)
    runner.write_block(12, payload)
    runner.prefill_chunk(toks[2 * bs:3 * bs], 2 * bs, [0, 12, 13], rid=3)
    runner.decode([9], [[0, 12, 13, 14]], [3 * bs], rids=[3])
    assert _same(runner.pool[1], saved[1]) and _same(payload, saved[1])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_hybrid_and_default_device_raise(arch):
    """A state engine, pure-SSM or hybrid, on the default device raises
    where no card is present; on the CPU it builds the state runner."""
    (_, _), (tm, tp) = _pair(jget_config(arch).reduced())
    bs = tm.cfg.ssm_chunk
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcore.EchoEngine(tm, tp, tcore.ECHO, num_blocks=16, block_size=bs,
                             chunk_size=2 * bs)
    eng = tcore.EchoEngine(tm, tp, tcore.ECHO, num_blocks=16, block_size=bs,
                           chunk_size=2 * bs, device="cpu")
    assert isinstance(eng.runner, StateRunner)
