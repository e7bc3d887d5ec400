"""The port's ``cluster/`` against the JAX package's: ``ClusterSimulator``
runs on the virtual clock give equal fingerprints (tests/test_cluster.py's)
with the affinity and random routers, a chaos kill and a straggler, and the
autoscaler; ``FleetPlanner`` finds the same minimum fleet; and cross-replica
KV migration moves real pages between two ``TorchPagedRunner``s (float32,
CPU), so the migrated question's greedy tokens equal the JAX package's
reference generator, and an evacuated request finishes on the other
replica with every block freed."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster as jcluster  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
from repro.core.simulator import clone_requests as jclone  # noqa: E402
import repro_torch.cluster as tcluster  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.simulator import clone_requests as tclone  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from tests.test_engine import _reference_generate  # noqa: E402

JAX = (jcluster, jcore, jdata, jclone)
PORT = (tcluster, tcore, tdata, tclone)


def _workload(pkg, duration=12.0, seed=0, n_docs=4, questions=16):
    """tests/test_cluster.py's two-tenant workload, requests numbered 0..
    (each package counts its own rids)."""
    _, core, data, _ = pkg
    tenants = (data.TenantSpec("a", online_rate=1.0, n_docs=n_docs,
                               questions_per_doc=questions),
               data.TenantSpec("b", online_rate=0.5, slo=core.SLO(1.5, 0.15),
                               n_docs=n_docs, questions_per_doc=questions))
    online, offline = data.make_multi_tenant_workload(tenants, duration, seed=seed)
    for i, r in enumerate(online + offline):
        r.rid = i
    return online, offline


def _fingerprint(stats):
    """tests/test_cluster.py's fingerprint, with the fleet's lifecycle and
    router counters."""
    m = stats.merged()
    iters = [(round(r.t, 9), r.n_prefill, r.n_decode, r.offline_tokens,
              r.online_tokens) for r in m.iterations]
    finished = sorted((r.arrival_time, r.prompt_len, r.max_new_tokens,
                       round(r.finish_time, 9)) for r in m.finished)
    return (iters, finished, [(round(t, 9), i, s) for t, i, s in stats.lifecycle],
            dataclasses.asdict(stats.router), round(stats.replica_seconds, 9))


SCENARIOS = {
    "affinity": dict(router_policy="affinity"),
    "random": dict(router_policy="random"),
    "chaos": dict(router_policy="affinity", n=3,
                  chaos=dict(kills=[(4.0, 0)], degrades=[(1.0, 1, 3.0, 5.0)]),
                  host_kv_blocks=64),
    "autoscaler": dict(router_policy="affinity", n=1, autoscaler=True),
}


def _simulate(pkg, scenario):
    cluster, core, _, clone = pkg
    kw = dict(SCENARIOS[scenario])
    n = kw.pop("n", 2)
    if "chaos" in kw:
        kw["chaos"] = cluster.ChaosConfig(**kw["chaos"])
    if kw.pop("autoscaler", False):
        kw.update(autoscaler=cluster.FleetController(
            min_replicas=1, max_replicas=3, rate_per_replica=0.5, interval=0.5,
            cooldown=1.0, queue_high=2, window=4.0, bin_s=1.0), join_delay=0.25)
    sim = cluster.ClusterSimulator(n, core.ECHO, num_blocks=96,
                                   time_model=core.TimeModel.a100(), seed=0, **kw)
    online, offline = _workload(pkg)
    sim.submit_all(clone(online, preserve_rid=True) + clone(offline, preserve_rid=True))
    return sim, sim.run(until_time=120.0)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_cluster_simulator_matches_jax(scenario):
    jsim, jstats = _simulate(JAX, scenario)
    tsim, tstats = _simulate(PORT, scenario)
    want, got = _fingerprint(jstats), _fingerprint(tstats)
    assert got == want
    assert got[0] and got[1], "the run must iterate and finish requests"
    assert len(tsim.replicas) == len(jsim.replicas)
    if scenario == "chaos":
        assert tstats.kills and len(tstats.kills) == len(jstats.kills)
    if scenario == "autoscaler":
        assert len(tsim.replicas) > 1, "the autoscaler must add a replica"


def test_fleet_planner_matches_jax():
    reports = []
    for pkg in (JAX, PORT):
        cluster, core, _, _ = pkg
        online, offline = _workload(pkg, duration=8.0, n_docs=3, questions=8)
        planner = cluster.FleetPlanner(core.TimeModel.a100())
        reports.append(planner.plan(online, offline, candidate_replicas=(1, 2, 4),
                                    candidate_blocks=(96,), slo_target=0.9,
                                    duration=8.0))
    want, got = reports
    assert got.min_replicas is not None
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------- migration
@pytest.fixture(scope="module")
def port_model(tiny_model):
    jm, jp = tiny_model
    tm = Model(ModelConfig(**dataclasses.asdict(jm.cfg)))
    return tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _engine(model, params, **kw):
    return tcore.EchoEngine(model, params, tcore.ECHO, num_blocks=16, block_size=8,
                            chunk_size=16, max_pages_per_seq=16, host_kv_blocks=32,
                            device="cpu", **kw)


def _offline(prompt, max_new):
    return tcore.Request(prompt=tuple(prompt), max_new_tokens=max_new,
                         task_type=tcore.TaskType.OFFLINE)


def test_migrated_prefix_is_bit_exact_with_paged_runner(tiny_model, port_model):
    """tests/test_elasticity.py's acceptance test on the port, through the
    router: the document's pages leave replica 0's runner and land in
    replica 1's host tier, which restores them instead of recomputing; the
    migrated question's tokens equal the JAX reference generator's."""
    model, params = port_model
    rng = np.random.default_rng(5)
    vocab = model.cfg.vocab_size
    doc = tuple(int(x) for x in rng.integers(0, vocab, 48))    # 6 blocks
    q = tuple(int(x) for x in rng.integers(0, vocab, 8))
    rep0 = tcluster.Replica(0, _engine(model, params))
    rep1 = tcluster.Replica(1, _engine(model, params))
    router = tcluster.Router([rep0, rep1])

    seed_req = _offline(doc, 2)
    rep0.submit(seed_req)
    rep0.engine.run(max_iters=200)
    local = _offline(doc + q, 6)
    rep0.submit(local)
    rep0.engine.run(max_iters=200)
    assert seed_req.done and local.done

    exported = []
    export = rep0.engine.export_prefix
    rep0.engine.export_prefix = lambda tokens: exported.append(export(tokens)) or exported[-1]
    moved = _offline(doc + q, 6)
    admitted = router.migrate_prefix(rep0, rep1, moved)
    (hbs, n_bytes), = exported
    assert hbs and all(hb.payload is not None for hb in hbs), \
        "a real-runner export must carry the actual KV pages"
    assert admitted == n_bytes > 0
    assert router.stats.migrated_blocks == len(hbs)
    rep1.submit(moved)
    rep1.engine.run(max_iters=200)
    assert moved.done
    assert rep1.engine.bm.metrics.migrated_in_blocks == len(hbs)
    assert rep1.engine.bm.metrics.swapped_in_tokens > 0, \
        "the question must restore the migrated prefix, not recompute it"
    ref = _reference_generate(*tiny_model, doc + q, 6)
    assert moved.output_tokens == ref, "migrated KV diverged from computed"
    assert local.output_tokens == ref


def test_evacuated_request_finishes_on_the_other_replica(tiny_model, port_model):
    """A request evacuated mid-decode leaves replica 0 with no block of its
    own; replica 1 re-prefills prompt and tokens so far, finishes it with
    the reference generator's tokens, and frees every block."""
    model, params = port_model
    rng = np.random.default_rng(6)
    prompt = tuple(int(x) for x in rng.integers(0, model.cfg.vocab_size, 30))
    rep0 = tcluster.Replica(0, _engine(model, params))
    rep1 = tcluster.Replica(1, _engine(model, params))
    req = _offline(prompt, 8)
    rep0.submit(req)
    while req.n_output < 3:
        rep0.engine.step()
    before = list(req.output_tokens)
    assert not req.done
    assert req in rep0.evacuate()
    assert not req.block_ids
    assert rep0.engine.bm.occupancy_snapshot()["running"] == 0
    assert not rep0.has_work()
    rep1.submit(req)
    rep1.engine.run(max_iters=200)
    assert req.done and req.output_tokens[:len(before)] == before
    assert req.output_tokens == _reference_generate(*tiny_model, prompt, 8)
    snap = rep1.engine.bm.occupancy_snapshot()
    assert snap["running"] == 0 and snap["free"] + snap["cached"] == snap["total"]


def test_export_import_roundtrip_dedups(port_model):
    model, params = port_model
    src = _engine(model, params)
    rng = np.random.default_rng(9)
    doc = tuple(int(x) for x in rng.integers(0, model.cfg.vocab_size, 24))   # 3 blocks
    r = _offline(doc, 2)
    src.submit(r)
    src.run(max_iters=100)
    hbs, _ = src.export_prefix(doc)
    assert hbs
    dst = tcore.EchoEngine(None, None, tcore.ECHO, num_blocks=16, block_size=8,
                           chunk_size=16, host_kv_blocks=32)
    first = dst.import_prefix(hbs)
    again = dst.import_prefix(hbs)
    assert first > 0
    assert again == 0, "duplicate imports must not cross the fabric twice"
    assert dst.bm.metrics.migrated_in_blocks == len(hbs)
