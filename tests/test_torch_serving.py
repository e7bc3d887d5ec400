"""The port's ``serving/`` against the JAX package's, with the same weights:
the scenarios of tests/test_serving.py that hold for a real model, run on
the tiny model in both packages (the port on ``device="cpu"``, its
kernels' plain versions). ``drive`` against the legacy engine and the
cluster, live metrics against the post-hoc stats, streaming, aborts of a
running and of a preempted request, and the three admission gates: each
package must pass the reference's own checks, and the two must agree on
every request's status, tokens and engine-domain finish time, on the
shed and abort counts and on ``LiveMetrics.percentiles()``. Last, the
service's Prometheus text is byte-equal between the packages.

Requests are numbered 0.. in submission order in both packages (each
counts its own rids), so the records compare directly."""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.cluster as jcluster  # noqa: E402
import repro.core.engine as jengine_mod  # noqa: E402
import repro.core.simulator as jsimulator  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
import repro_torch.cluster as tcluster  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.engine as tengine_mod  # noqa: E402
import repro_torch.core.simulator as tsimulator  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402

VOCAB = 128          # tiny_cfg's


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's CPU kernels would otherwise occupy every core, which
    beside other test workers oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides(tiny_cfg):
    """The two packages, each with its model and the same weights."""
    jm = JModel(tiny_cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(tiny_cfg)))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return {
        "jax": types.SimpleNamespace(
            core=jcore, cluster=jcluster, data=jdata, obs=jobs, serving=jserving,
            simulator=jsimulator, engine_mod=jengine_mod, model=jm, params=jparams,
            engine_kw={}),
        "port": types.SimpleNamespace(
            core=tcore, cluster=tcluster, data=tdata, obs=tobs, serving=tserving,
            simulator=tsimulator, engine_mod=tengine_mod, model=tm, params=tparams,
            engine_kw={"device": "cpu"}),
    }


def both(sides, scenario):
    """Run ``scenario(pkg)`` in both packages; the results must be equal."""
    assert scenario(sides["port"]) == scenario(sides["jax"])


# ---------------------------------------------------------------- helpers
def assert_no_block_leaks(engine):
    """Every referenced block must be owned by a live running request, the
    free, cached and running blocks must account for every block, and the
    host tier stays within capacity and never holds a hash that is also on
    the device."""
    owned = set()
    for r in engine.scheduler.running:
        owned.update(r.block_ids)
    for b in engine.bm.blocks:
        if b.ref > 0:
            assert b.bid in owned, f"block {b.bid} referenced but unowned"
    assert (engine.bm.free_blocks + engine.bm.cached_blocks
            + engine.bm.running_blocks) == engine.bm.num_blocks
    host = engine.bm.host
    if host is not None:
        assert len(host) <= host.capacity
        for h in host.blocks:
            assert h not in engine.bm.hash_to_bid, f"hash {h} resident on BOTH tiers"


def assert_no_owner_pin_leaks(engine):
    """On a drained engine no block on either tier still carries an
    unfinished-owner pin."""
    for b in engine.bm.blocks:
        assert b.unfinished_owners == 0, f"device block {b.bid} pinned by a dead owner"
    if engine.bm.host is not None:
        for hb in engine.bm.host.blocks.values():
            assert hb.unfinished_owners == 0, \
                f"host block hash {hb.hash} pinned by a dead owner"


def numbered(reqs):
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def engine(pkg, num_blocks=128, **kw):
    return pkg.core.EchoEngine(pkg.model, pkg.params, pkg.core.ECHO,
                               num_blocks=num_blocks, block_size=16, chunk_size=32,
                               time_model=pkg.core.TimeModel.a100(),
                               **pkg.engine_kw, **kw)


def workload(pkg, seed=0, duration=3.0, rate=2.0, docs=2, questions=4):
    """tests/test_serving.py's workload, cut to two documents of four
    questions and three seconds of online arrivals, inside the tiny
    model's vocabulary."""
    rng = np.random.default_rng(seed)
    arrivals = list(np.cumsum(rng.exponential(1.0 / rate, int(rate * duration))))
    online = pkg.data.make_online_requests(arrivals, prompt_mean=48, prompt_std=12,
                                           max_new_mean=8, vocab=VOCAB,
                                           slo=pkg.core.SLO(1.0, 0.1), seed=seed + 1)
    offline = pkg.data.make_offline_corpus(docs, questions, doc_len=96, question_len=16,
                                           max_new=6, vocab=VOCAB, seed=seed + 2)
    return numbered(online + offline)


def outcome(reqs):
    """What two runs must agree on, request by request."""
    return [(r.state.value, tuple(r.output_tokens), r.finish_time) for r in reqs]


def handle_outcome(handles):
    return [(h.status.value, tuple(h.request.output_tokens), h.request.finish_time)
            for h in handles]


def toks(seed, n):
    return tuple(int(x) for x in np.random.default_rng(seed).integers(0, VOCAB, n))


# ---------------------------------------------------------------- equivalence
def _drive_vs_legacy(pkg):
    reqs = workload(pkg)
    clone = pkg.simulator.clone_requests
    legacy = engine(pkg)
    legacy_reqs = clone(reqs, preserve_rid=True)
    for r in legacy_reqs:
        legacy.submit(r)
    want = legacy.run(max_iters=20_000, until_time=60.0)
    service = pkg.serving.EchoService(engine(pkg))
    driven = clone(reqs, preserve_rid=True)
    got = service.drive(driven, max_iters=20_000, until_time=60.0)
    assert len(got.finished) == len(want.finished) == len(reqs)
    assert got.offline_throughput() == want.offline_throughput()
    assert got.slo_attainment("ttft") == want.slo_attainment("ttft")
    assert got.slo_attainment("tpot") == want.slo_attainment("tpot")
    assert outcome(driven) == outcome(legacy_reqs)
    return (outcome(driven), got.offline_throughput(), got.slo_attainment("ttft"),
            got.slo_attainment("tpot"))


def test_drive_matches_legacy_engine(sides):
    both(sides, _drive_vs_legacy)


def _drive_vs_legacy_cluster(pkg):
    """The cluster is model-less (virtual clock, fabricated tokens)."""
    rng = np.random.default_rng(7)
    arrivals = list(np.cumsum(rng.exponential(1.0 / 3.0, 24)))
    online = pkg.data.make_online_requests(arrivals, prompt_mean=48, prompt_std=12,
                                           max_new_mean=8,
                                           slo=pkg.core.SLO(1.0, 0.1), seed=8)
    offline = pkg.data.make_offline_corpus(3, 8, doc_len=96, question_len=16,
                                           max_new=6, seed=9)
    reqs = numbered(online + offline)
    clone = pkg.simulator.clone_requests

    def sim():
        return pkg.cluster.ClusterSimulator(3, pkg.core.ECHO, num_blocks=96,
                                            time_model=pkg.core.TimeModel.a100(), seed=0)
    legacy = sim()
    legacy.submit_all(clone(reqs, preserve_rid=True))
    want = legacy.run(until_time=60.0)
    service = pkg.serving.EchoService(sim())
    driven = clone(reqs, preserve_rid=True)
    got = service.drive(driven, until_time=60.0)
    assert got.finished_counts() == want.finished_counts()
    assert got.offline_throughput() == want.offline_throughput()
    assert got.slo_attainment("ttft") == want.slo_attainment("ttft")
    return (outcome(driven), got.finished_counts(), got.offline_throughput(),
            got.slo_attainment("tpot"))


def test_drive_matches_legacy_cluster(sides):
    both(sides, _drive_vs_legacy_cluster)


def _live_metrics(pkg):
    reqs = workload(pkg, seed=3)
    service = pkg.serving.EchoService(engine(pkg))
    stats = service.drive(reqs, max_iters=20_000)
    live = service.live
    on_done = sum(1 for r in stats.finished if r.is_online)
    assert live.finished_online == on_done
    assert live.finished_offline == len(stats.finished) - on_done
    assert live.slo_attainment("ttft") == stats.slo_attainment("ttft")
    assert live.slo_attainment("tpot") == stats.slo_attainment("tpot")
    pcts = live.percentiles()
    assert {"ttft", "tpot"} <= set(pcts)
    return outcome(reqs), pcts, live.online_tokens, live.offline_throughput()


def test_live_metrics_match_post_hoc_stats(sides):
    both(sides, _live_metrics)


# ----------------------------------------------------------------- streaming
def _token_events(pkg):
    eng = engine(pkg)
    service = pkg.serving.EchoService(eng)
    seen_at_iter = []
    service.events.on_token(lambda ev: seen_at_iter.append(len(eng.stats.iterations)))
    reqs = workload(pkg, seed=11)
    service.drive(reqs, max_iters=20_000)
    total = len(eng.stats.iterations)
    assert seen_at_iter, "no token events fired"
    assert seen_at_iter[0] < total - 1, "first token event must precede the final iteration"
    return seen_at_iter, outcome(reqs)


def test_streaming_token_events_arrive_before_final_iteration(sides):
    both(sides, _token_events)


def _handle_stream(pkg):
    service = pkg.serving.EchoService(engine(pkg))
    h = service.submit(tuple(range(40)), task_type="online", max_new_tokens=6,
                       slo=pkg.core.SLO(1.0, 0.1), arrival_time=0.0)
    doc = toks(1, 80)
    offs = [service.submit(doc + toks(10 + i, 6), task_type="offline", max_new_tokens=4)
            for i in range(3)]
    got, backlog = [], []
    for ev in h.tokens():
        got.append(ev.token)
        assert ev.handle is h and ev.index == len(got) - 1
        if ev.first:
            backlog.append(service.backend.has_work())
    assert backlog == [True], "streaming must interleave with the offline work"
    assert got == list(h.request.output_tokens)
    assert h.status is pkg.serving.HandleStatus.FINISHED
    service.run()
    return got, handle_outcome(offs)


def test_handle_tokens_generator_streams_incrementally(sides):
    both(sides, _handle_stream)


# --------------------------------------------------------------- cancellation
def _abort_running_online(pkg):
    HS = pkg.serving.HandleStatus
    service = pkg.serving.EchoService(engine(pkg, num_blocks=96))
    target = service.submit(tuple(range(64)), task_type="online", max_new_tokens=50,
                            slo=pkg.core.SLO(5.0, 1.0), arrival_time=0.0)
    rest = [service.submit(toks(20 + i, 48), task_type="offline", max_new_tokens=4)
            for i in range(3)]
    for ev in target.tokens():
        if ev.index >= 2:
            break
    assert target.status is HS.RUNNING and target.request.block_ids
    eng = service.engine
    assert target.abort()
    assert target.status is HS.ABORTED
    assert target.request.block_ids == [], "abort must release all blocks"
    assert target.request not in eng.scheduler.running
    assert_no_block_leaks(eng)
    assert not target.abort(), "double-abort must be a no-op"
    stats = service.run()
    assert all(h.status is HS.FINISHED for h in rest)
    assert target.request in stats.aborted and target.request not in stats.finished
    assert_no_block_leaks(eng)
    assert eng.bm.running_blocks == 0
    return (tuple(target.request.output_tokens), handle_outcome(rest),
            service.live.aborted, len(stats.aborted))


def test_abort_running_online_request_frees_blocks(sides):
    both(sides, _abort_running_online)


def _abort_preempted_offline(pkg):
    """A tiny cache and an online burst preempt an offline request
    (recompute mode: it goes back to the OfflinePool); aborting it drops
    its radix-pool pins."""
    HS = pkg.serving.HandleStatus
    eng = engine(pkg, num_blocks=20)
    service = pkg.serving.EchoService(eng)
    doc = toks(30, 96)
    offs = [service.submit(doc + toks(31 + i, 8), task_type="offline", max_new_tokens=40)
            for i in range(2)]
    onl = [service.submit(toks(40 + i, 60), task_type="online", max_new_tokens=12,
                          slo=pkg.core.SLO(10.0, 1.0), arrival_time=0.01 * (i + 1))
           for i in range(3)]
    preempted = []
    service.events.on_preempt(lambda hd: preempted.append(hd))
    victim = None
    for _ in range(400):
        victim = next((h for h in offs if h.status is HS.PREEMPTED), None)
        if victim is not None or not service.step():
            break
    assert victim is not None, "no offline request was preempted"
    assert preempted and victim.request in eng.pool
    chain = eng.pool._chains[victim.request.rid]
    rc_before = [eng.pool.rc(h) for h in chain]
    assert victim.abort()
    assert victim.request not in eng.pool
    assert [eng.pool.rc(h) for h in chain] == [b - 1 for b in rc_before], \
        "radix-pool pin not dropped"
    assert victim.request.block_ids == []
    assert_no_block_leaks(eng)
    service.run()
    survivors = onl + [o for o in offs if o is not victim]
    assert all(h.status is HS.FINISHED for h in survivors)
    assert eng.bm.running_blocks == 0
    assert_no_block_leaks(eng)
    assert_no_owner_pin_leaks(eng)
    return (offs.index(victim), tuple(victim.request.output_tokens),
            handle_outcome(survivors), service.live.aborted)


def test_abort_preempted_offline_request_drops_pool_pins(sides):
    both(sides, _abort_preempted_offline)


# ----------------------------------------------------------------- admission
def _bounded_queue(pkg):
    HS = pkg.serving.HandleStatus
    service = pkg.serving.EchoService(
        engine(pkg), admission=pkg.serving.AdmissionConfig(max_online_queue=2))
    shed = []
    service.events.on_shed(lambda hd: shed.append(hd))
    hs = [service.submit(tuple(range(i, i + 30)), task_type="online", max_new_tokens=3,
                         slo=pkg.core.SLO(1.0, 0.1), arrival_time=0.0)
          for i in range(6)]
    assert [h.status for h in hs].count(HS.SHED) == 4 == len(shed)
    service.run()
    assert sum(h.status is HS.FINISHED for h in hs) == 2
    assert service.live.shed == 4
    return handle_outcome(hs), service.live.shed, service.live.percentiles()


def test_bounded_online_queue_sheds(sides):
    both(sides, _bounded_queue)


def _slo_infeasible(pkg):
    HS = pkg.serving.HandleStatus
    service = pkg.serving.EchoService(
        engine(pkg), admission=pkg.serving.AdmissionConfig(slo_shed_factor=1.0))
    # impossibly tight TTFT: the TimeModel alone predicts a miss
    bad = service.submit(tuple(i % VOCAB for i in range(512)), task_type="online",
                         max_new_tokens=4, slo=pkg.core.SLO(ttft=1e-6, tpot=0.1),
                         arrival_time=0.0)
    assert bad.status is HS.SHED
    ok = service.submit(tuple(range(40)), task_type="online", max_new_tokens=4,
                        slo=pkg.core.SLO(10.0, 1.0), arrival_time=0.0)
    assert ok.status is HS.QUEUED
    service.run()
    assert ok.status is HS.FINISHED
    return handle_outcome([bad, ok]), service.live.shed


def test_slo_infeasible_arrival_is_shed(sides):
    both(sides, _slo_infeasible)


def _soft_cap(pkg):
    HS = pkg.serving.HandleStatus
    service = pkg.serving.EchoService(
        engine(pkg), admission=pkg.serving.AdmissionConfig(offline_pool_cap=2))
    requeued = []
    service.events.on_requeue(lambda hd: requeued.append(hd.rid))
    hs = [service.submit(toks(50 + i, 40), task_type="offline", max_new_tokens=3)
          for i in range(5)]
    deferred = [h for h in hs if h._deferred]
    assert len(deferred) == 3, "work beyond the soft cap must be deferred"
    assert all(h.status is HS.QUEUED for h in deferred)
    assert service.backend.offline_backlog() == 2
    service.run()
    assert all(h.status is HS.FINISHED for h in hs), "deferred work must be fed"
    assert len(requeued) == 3 == service.live.requeued
    return handle_outcome(hs), [hs.index(h) for h in deferred]


def test_offline_soft_cap_defers_and_feeds(sides):
    both(sides, _soft_cap)


# ------------------------------------------------------------- observability
class _CountingClock:
    """``time.perf_counter`` advancing 250 µs a call: the engine stamps its
    schedule time with the host clock, which the probes record."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return self.n * 2.5e-4


def test_service_prometheus_text_matches_jax(sides, monkeypatch):
    """``EchoService.instrument`` in both packages over the same drive gives
    a byte-equal Prometheus text and an equal trace."""
    def run(pkg):
        clock = _CountingClock()
        monkeypatch.setattr(pkg.engine_mod, "time", clock)
        service = pkg.serving.EchoService(engine(pkg, num_blocks=48))
        tracer = pkg.obs.Tracer()
        registry = service.instrument(pkg.obs.MetricsRegistry(), tracer)
        reqs = workload(pkg, seed=5)
        service.drive(reqs, max_iters=20_000)
        monkeypatch.undo()
        assert clock.n > 0
        return registry, tracer, reqs

    jreg, jtr, jreqs = run(sides["jax"])
    treg, ttr, treqs = run(sides["port"])
    assert outcome(treqs) == outcome(jreqs)
    prom = treg.to_prometheus()
    assert "ttft" in prom
    assert prom.encode() == jreg.to_prometheus().encode()
    assert json.dumps(treg.to_json(), sort_keys=True) == \
        json.dumps(jreg.to_json(), sort_keys=True)
    assert ttr.to_dict() == jtr.to_dict()
