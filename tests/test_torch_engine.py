"""The port's engine against the JAX engine with the same weights: the
token-parity scenarios of tests/test_engine.py (plain serving, prefix
sharing, preemption by recompute) and a host-tier swap round trip. On the
virtual clock the two engines must also take the same scheduling
decisions: per iteration the same prefill spans, decode set and
preemptions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402


@pytest.fixture(scope="module")
def models(tiny_cfg):
    jm = JModel(tiny_cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(tiny_cfg)))
    return (jm, params), (tm, from_jax(jax.tree.map(np.asarray, params), "cpu"))


def _recorder(core):
    class Recorder(core.EngineListener):
        """Per-iteration scheduling decisions, requests named by their
        submission index so the two engines' records compare directly."""

        def __init__(self, reqs):
            self.index = {r.rid: i for i, r in enumerate(reqs)}
            self.iters = []
            self._preempts = 0

        def on_preempt(self, req, t):
            self._preempts += 1

        def on_iteration(self, rec, detail):
            self.iters.append((
                tuple((self.index[r.rid], s, e) for r, s, e in detail.prefill_spans),
                tuple(sorted(self.index[r.rid] for r in detail.decodes)),
                self._preempts))
            self._preempts = 0
    return Recorder


def _serve(core, model, params, specs, steps_first=0, **eng_kw):
    """Run ``specs`` [(prompt, max_new, task, arrival, slo)] through one
    engine; ``steps_first`` steps run before the requests flagged late
    (arrival None) are submitted at the engine's clock."""
    reqs = [core.Request(prompt=p, max_new_tokens=n,
                         task_type=getattr(core.TaskType, task),
                         arrival_time=arr or 0.0,
                         slo=core.SLO(*slo) if slo else None)
            for p, n, task, arr, slo in specs]
    eng = core.EchoEngine(model, params, core.ECHO, **eng_kw)
    rec = _recorder(core)(reqs)
    eng.listeners.append(rec)
    late = [r for r, s in zip(reqs, specs) if s[3] is None]
    for r in reqs:
        if r not in late:
            eng.submit(r)
    for _ in range(steps_first):
        eng.step()
    for r in late:
        r.arrival_time = eng.now
        eng.submit(r)
    eng.run(max_iters=1000)
    return eng, reqs, rec


def _compare(models, specs, steps_first=0, **eng_kw):
    (jm, jp), (tm, tp) = models
    jeng, jreqs, jrec = _serve(jcore, jm, jp, specs, steps_first, **eng_kw)
    teng, treqs, trec = _serve(tcore, tm, tp, specs, steps_first,
                               device="cpu", **eng_kw)
    assert all(r.done for r in jreqs) and all(r.done for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert t.output_tokens == j.output_tokens
        assert t.n_preemptions == j.n_preemptions
    assert trec.iters == jrec.iters
    return jeng, teng, jreqs, treqs


def _prompt(rng, vocab, n):
    return tuple(int(x) for x in rng.integers(0, vocab, n))


ENGINE_KW = dict(num_blocks=64, block_size=8, chunk_size=16, max_pages_per_seq=16)


def test_engine_matches_jax_engine(models):
    rng = np.random.default_rng(0)
    vocab = models[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, n), 6, "OFFLINE", 0.0, None) for n in (13, 25, 40)]
    _compare(models, specs, **ENGINE_KW)


def test_prefix_sharing_matches_jax_engine(models):
    rng = np.random.default_rng(1)
    vocab = models[0][0].cfg.vocab_size
    doc = _prompt(rng, vocab, 24)
    specs = [(doc + _prompt(rng, vocab, 8), 5, "OFFLINE", 0.0, None)
             for _ in range(2)]
    _, teng, _, _ = _compare(models, specs, **ENGINE_KW)
    assert teng.bm.metrics.hit_blocks > 0, "prefix must actually be shared"


def test_preemption_recompute_matches_jax_engine(models):
    rng = np.random.default_rng(2)
    vocab = models[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, 40), 6, "OFFLINE", 0.0, None),
             (_prompt(rng, vocab, 40), 6, "ONLINE", 0.002, (10, 10))]
    _compare(models, specs, **dict(ENGINE_KW, num_blocks=14))


def test_host_tier_swap_matches_jax_engine(models):
    """Preempt an offline request, park its committed blocks on the host
    tier, restore them: the tokens equal the JAX engine's, and the swap path
    (snapshot on the engine thread, materialize and stage on the copy
    worker, in-place write at the fence) really ran."""
    rng = np.random.default_rng(2)
    vocab = models[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, 56), 6, "OFFLINE", 0.0, None),
             (_prompt(rng, vocab, 88), 12, "ONLINE", None, (10, 10))]
    jeng, teng, _, treqs = _compare(
        models, specs, steps_first=3, num_blocks=16, block_size=8,
        chunk_size=16, max_pages_per_seq=16, host_kv_blocks=32)
    assert treqs[0].n_preemptions >= 1
    assert teng.bm.metrics.swapped_out_tokens > 0
    assert teng.bm.metrics.swapped_in_tokens > 0
    assert teng._stager is not None
    assert teng.stats.swapped_in_bytes == jeng.stats.swapped_in_bytes


def test_model_less_simulator_needs_no_device():
    """The §5.4 simulator path (no model) never touches a device."""
    eng = tcore.EchoEngine(None, None, tcore.ECHO, num_blocks=32, block_size=8,
                           chunk_size=16)
    eng.submit(tcore.Request(prompt=tuple(range(20)), max_new_tokens=3,
                             task_type=tcore.TaskType.OFFLINE))
    stats = eng.run(max_iters=100)
    assert len(stats.finished) == 1 and stats.finished[0].n_output == 3
