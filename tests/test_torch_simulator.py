"""The port's §5.4 deployment simulator (``repro_torch.core.simulator``)
against the JAX package's on the virtual clock, with no model: the same
workload gives equal ``EngineStats`` (SLO attainment, offline throughput,
the iteration records) and an equal ``CapacityReport``, and the clones
carry or renew rids as the reference's do."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402

CANDIDATES = (64, 96, 128, 192, 256)


def _workload(core, seed=0, n_online=24, n_docs=3, questions=4):
    """Online requests of 64-383 tokens arriving every 40 ms under a tight
    SLO, and offline questions over shared 256-token documents."""
    rng = np.random.default_rng(seed)

    def toks(n):
        return tuple(int(x) for x in rng.integers(0, 32000, n))
    online = [core.Request(prompt=toks(int(rng.integers(64, 384))),
                           max_new_tokens=int(rng.integers(16, 64)),
                           task_type=core.TaskType.ONLINE,
                           arrival_time=0.04 * i,
                           slo=core.SLO(ttft=0.25, tpot=0.05))
              for i in range(n_online)]
    offline = []
    for _ in range(n_docs):
        doc = toks(256)
        offline += [core.Request(prompt=doc + toks(32), max_new_tokens=32,
                                 task_type=core.TaskType.OFFLINE)
                    for _ in range(questions)]
    return online, offline


def _summary(stats):
    """Everything the virtual clock decides, requests named by their order
    of finishing (rids differ between the packages)."""
    return dict(
        ttft=stats.slo_attainment("ttft"), tpot=stats.slo_attainment("tpot"),
        offline=stats.offline_throughput(), n_iters=len(stats.iterations),
        iters=[(r.t, r.n_prefill, r.n_decode, r.iter_time, r.offline_tokens,
                r.online_tokens, r.hit_rate) for r in stats.iterations],
        finished=[(r.is_online, len(r.prompt), r.n_output, r.ttft(), r.tpot())
                  for r in stats.finished])


@pytest.mark.parametrize("num_blocks", [64, 128, 256])
def test_simulate_matches_jax(num_blocks):
    got = tsim.simulate(*_workload(tcore), tcore.TimeModel.h100(), num_blocks)
    want = jsim.simulate(*_workload(jcore), jcore.TimeModel.h100(), num_blocks)
    assert _summary(got) == _summary(want)
    assert len(got.finished) == 36


def test_simulate_with_clock_model_and_duration_matches_jax():
    """A ground-truth clock other than the estimate (§5 calibration), cut
    at a duration."""
    def run(core, sim):
        tm = core.TimeModel.h100()
        clock = core.PerturbedTimeModel(tm, scale=1.3, jitter=0.2, seed=1)
        return sim.simulate(*_workload(core, seed=1), tm, 128, clock_model=clock,
                            duration=0.6, policy=core.BS)
    got, want = run(tcore, tsim), run(jcore, jsim)
    assert _summary(got) == _summary(want)
    assert 0 < len(got.finished) < 36


@pytest.mark.parametrize("candidates,chosen", [(CANDIDATES, 192), ((64, 96), None)])
def test_estimate_capacity_matches_jax(candidates, chosen):
    def run(core, sim):
        return sim.estimate_capacity(*_workload(core), core.TimeModel.h100(),
                                     candidate_blocks=candidates)
    got, want = run(tcore, tsim), run(jcore, jsim)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.min_blocks_for_slo == chosen
    assert (got.offline_throughput is None) == (chosen is None)
    if chosen is not None:
        assert got.offline_throughput > 0


def test_clone_requests_and_fabricated_tokens_match_jax():
    """Clones are unstarted copies with fresh rids unless ``preserve_rid``;
    with the same rids the model-less engines fabricate the same tokens."""
    online, offline = _workload(tcore, n_online=4, n_docs=1, questions=2)
    fresh = tsim.clone_requests(online + offline)
    kept = tsim.clone_requests(online + offline, preserve_rid=True)
    for r, f, k in zip(online + offline, fresh, kept):
        assert f.rid != r.rid and k.rid == r.rid
        for c in (f, k):
            assert (c.prompt, c.max_new_tokens, c.task_type, c.arrival_time, c.slo) == \
                (r.prompt, r.max_new_tokens, r.task_type, r.arrival_time, r.slo)
            assert c.output_tokens == [] and not c.done
    jreqs = [jcore.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                           task_type=jcore.TaskType[r.task_type.name],
                           arrival_time=r.arrival_time, rid=r.rid,
                           slo=jcore.SLO(r.slo.ttft, r.slo.tpot) if r.slo else None)
             for r in online + offline]
    outs = []
    for core, sim, reqs in ((tcore, tsim, online + offline), (jcore, jsim, jreqs)):
        eng = core.EchoEngine(None, None, core.ECHO, num_blocks=128,
                              time_model=core.TimeModel.h100())
        clones = sim.clone_requests(reqs, preserve_rid=True)
        for r in clones:
            eng.submit(r)
        eng.run(max_iters=5000)
        assert all(r.done for r in clones)
        outs.append([r.output_tokens for r in clones])
    assert outs[0] == outs[1]
