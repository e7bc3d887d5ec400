"""The port's ``rt/`` on the tiny model (``device="cpu"``), held against the
JAX package where the result is deterministic: the async loop on a paused
``ManualClock`` replays a trace to the JAX ``EchoService.drive``'s tokens
and finish times, on one engine and on a model-less two-replica cluster,
and the ``RTProbe`` gives the JAX package's Prometheus text and trace. The
front door's lifecycle (stream, mid-stream abort, graceful drain,
submit-queue shed, slow-consumer cap, step re-entry), the TCP server on
port 0 and ``calibrate_link``'s fit, guard and device contract are
checked on the port."""
import asyncio
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.rt.calibrate as jcalibrate  # noqa: E402
import repro_torch.rt.calibrate as tcalibrate  # noqa: E402
from repro_torch.core import Request, TaskType  # noqa: E402
from repro_torch.obs.trace import RT_PID  # noqa: E402
from repro_torch.rt import (AsyncEchoEngine, EchoServer, ManualClock,  # noqa: E402
                            RTState, SubmitQueueFull, request_once)
from repro_torch.rt import calibrate_link  # noqa: E402
from repro_torch.serving import HandleStatus  # noqa: E402
from tests.test_torch_serving import (  # noqa: E402,F401
    _CountingClock, assert_no_block_leaks, assert_no_owner_pin_leaks, engine,
    numbered, one_torch_thread, outcome, sides, workload)


def leakcheck(rt):
    leaks = rt.kv_leaks()
    assert not any(leaks.values()), f"leaked after drain: {leaks}"
    for eng in rt.service.backend.engines():
        assert_no_block_leaks(eng)
        assert_no_owner_pin_leaks(eng)


@pytest.fixture(scope="module")
def port(sides):
    return sides["port"]


# ------------------------------------------------------------- equivalence
def test_wall_loop_matches_jax_drive_on_paused_clock(sides, port):
    """The async loop is plumbing, not policy: a trace replayed through the
    port's loop (paused serving clock, explicit arrival stamps) gives the
    JAX package's synchronous ``drive`` request by request."""
    jax_side = sides["jax"]
    want_reqs = workload(jax_side, seed=11, rate=3.0)
    jax_side.serving.EchoService(engine(jax_side)).drive(
        want_reqs, max_iters=20_000, until_time=60.0)
    reqs = workload(port, seed=11, rate=3.0)

    async def main():
        rt = AsyncEchoEngine(engine(port), clock=ManualClock())
        async with rt:
            hs = [await rt.submit_request(r) for r in reqs]
            results = [await h.result() for h in hs]
        leakcheck(rt)
        return results

    results = asyncio.run(main())
    assert all(r.status is HandleStatus.FINISHED for r in results)
    assert outcome(reqs) == outcome(want_reqs)
    for res, want in zip(results, want_reqs):
        assert res.tokens == list(want.output_tokens)
        assert res.finish_time == want.finish_time
        assert res.ttft == want.ttft()


def test_wall_loop_matches_jax_drive_on_cluster(sides, port):
    """The same on a model-less cluster of two replicas."""
    def sim(pkg):
        return pkg.cluster.ClusterSimulator(2, pkg.core.ECHO, num_blocks=96,
                                            time_model=pkg.core.TimeModel.a100(),
                                            seed=0)

    def trace(pkg):
        rng = np.random.default_rng(5)
        arrivals = list(np.cumsum(rng.exponential(0.5, 8)))
        online = pkg.data.make_online_requests(arrivals, prompt_mean=48, prompt_std=12,
                                               max_new_mean=8,
                                               slo=pkg.core.SLO(1.0, 0.1), seed=6)
        offline = pkg.data.make_offline_corpus(3, 8, doc_len=96, question_len=16,
                                               max_new=6, seed=7)
        return numbered(online + offline)

    jax_side = sides["jax"]
    want_reqs = trace(jax_side)
    want = jax_side.serving.EchoService(sim(jax_side)).drive(want_reqs, until_time=60.0)
    reqs = trace(port)

    async def main():
        rt = AsyncEchoEngine(sim(port), clock=ManualClock())
        async with rt:
            hs = [await rt.submit_request(r) for r in reqs]
            out = [await h.result() for h in hs]
        leakcheck(rt)
        return out

    results = asyncio.run(main())
    finished = [r for r in results if r.status is HandleStatus.FINISHED]
    assert len(finished) == len(want.merged().finished) == len(reqs)
    assert [r.finish_time for r in results] == [r.finish_time for r in want_reqs]
    assert [r.tokens for r in results] == [list(r.output_tokens) for r in want_reqs]


# ------------------------------------------------------------- lifecycle
def test_stream_and_result(port):
    async def main():
        rt = AsyncEchoEngine(engine(port), clock=ManualClock())
        async with rt:
            h = await rt.submit([1, 2, 3], max_new_tokens=8)
            got = []
            async for ev in h.tokens():
                got.append(ev.token)
                assert ev.index == len(got) - 1
            assert len(got) == 8
            res = await h.result()
            assert res.status is HandleStatus.FINISHED
            assert res.tokens == got
            assert h.wall_ttft() is not None
        assert rt.state is RTState.STOPPED
        leakcheck(rt)
    asyncio.run(main())


def test_graceful_drain_with_inflight_decode(port):
    """drain() lets requests that are mid-decode finish, not shed them, and
    leaves zero KV residue; the closed front door sheds late submits."""
    async def main():
        rt = AsyncEchoEngine(engine(port), clock=ManualClock())
        await rt.start()
        hs = [await rt.submit([1 + i, 2, 3], max_new_tokens=24) for i in range(6)]
        first = await hs[0].tokens().__anext__()
        assert first.index == 0
        await rt.drain()
        for h in hs:
            res = await h.result()
            assert res.status is HandleStatus.FINISHED, res.status
            assert len(res.tokens) == 24
        assert rt.stats.drain_sheds == 0
        leakcheck(rt)
        late = await rt.submit([9, 9], max_new_tokens=4)
        assert late.status is HandleStatus.SHED
        assert rt.stats.shed_closed == 1
    asyncio.run(main())


def test_mid_stream_abort_releases_kv(port):
    """``await handle.abort()`` mid-decode frees blocks and pins at once and
    ends the token stream; the host tier's stager is flushed at drain."""
    async def main():
        rt = AsyncEchoEngine(engine(port, num_blocks=64, host_kv_blocks=32),
                             clock=ManualClock())
        async with rt:
            victim = await rt.submit([1] * 40, max_new_tokens=200)
            others = [await rt.submit([7 + i] * 8, max_new_tokens=8) for i in range(3)]
            seen = 0
            async for _ev in victim.tokens():
                seen += 1
                if seen == 3:
                    assert await victim.abort() is True
            assert 3 <= seen < 200
            assert victim.status is HandleStatus.ABORTED
            assert await victim.abort() is False
            assert (await victim.result()).status is HandleStatus.ABORTED
            for h in others:
                assert (await h.result()).status is HandleStatus.FINISHED
        assert rt.stats.aborted == 1
        leakcheck(rt)
    asyncio.run(main())


def test_submit_queue_sheds_when_saturated(port):
    async def main():
        rt = AsyncEchoEngine(engine(port), clock=ManualClock(), max_submit_queue=4)
        # loop not started: nothing drains the queue, so 4 fit, the rest shed
        hs = [await rt.submit([1, i], max_new_tokens=2, wait=False) for i in range(10)]
        shed = [h for h in hs if h.status is HandleStatus.SHED]
        assert len(shed) == 6 == rt.stats.shed_submit_queue
        for h in shed:
            res = await h.result()
            assert res.status is HandleStatus.SHED and res.tokens == []
        with pytest.raises(SubmitQueueFull):
            rt.try_submit_nowait(Request(prompt=(1,), max_new_tokens=2,
                                         task_type=TaskType.ONLINE, arrival_time=0.0))
        await rt.start()
        await rt.drain()
        assert rt.stats.finished == 4
        leakcheck(rt)
    asyncio.run(main())


def test_slow_consumer_hits_token_queue_cap(port):
    """A consumer that never reads is aborted at the queue cap instead of
    buffering the whole generation."""
    async def main():
        rt = AsyncEchoEngine(engine(port), clock=ManualClock(), token_queue_cap=4)
        async with rt:
            h = await rt.submit([1, 2, 3], max_new_tokens=64)
            res = await h.result()
        assert res.status is HandleStatus.ABORTED
        assert h.overflowed and rt.stats.slow_consumer_aborts == 1
        assert len(res.tokens) < 64
        assert len([ev async for ev in h.tokens()]) <= 4
        leakcheck(rt)
    asyncio.run(main())


def test_engine_step_rejects_reentry(port):
    """The step lock fails loudly on a second concurrent driver rather than
    corrupt the scheduler and KV state."""
    eng = engine(port)
    eng.submit(Request(prompt=(1, 2, 3), max_new_tokens=4, task_type=TaskType.ONLINE,
                       arrival_time=0.0))
    entered, release = threading.Event(), threading.Event()
    orig = eng._step_impl

    def slow_step():
        entered.set()
        release.wait(5.0)
        return orig()
    eng._step_impl = slow_step
    t = threading.Thread(target=eng.step)
    t.start()
    assert entered.wait(5.0)
    with pytest.raises(RuntimeError, match="re-entered"):
        eng.step()
    release.set()
    t.join(5.0)
    assert not t.is_alive()
    eng._step_impl = orig
    eng.run(100)
    assert not eng.scheduler.running and len(eng.stats.finished) == 1


# ------------------------------------------------------------- TCP server
def test_tcp_server_roundtrip_and_drain(port):
    async def main():
        rt = AsyncEchoEngine(engine(port))
        await rt.start()
        srv = await EchoServer(rt, port=0).start()
        host, p = srv.address
        outs = await asyncio.gather(*[
            request_once(host, p, [1, 2, 3 + i], max_new_tokens=4) for i in range(8)])
        assert all(o["status"] == "finished" and len(o["tokens"]) == 4 for o in outs)
        await srv.close()
        assert srv.requests_served == 8
        leakcheck(rt)
    asyncio.run(main())


def test_tcp_server_disconnect_aborts_inflight(port):
    async def main():
        rt = AsyncEchoEngine(engine(port))
        await rt.start()
        srv = await EchoServer(rt, port=0).start()
        reader, writer = await asyncio.open_connection(*srv.address)
        writer.write(json.dumps({"prompt": [1] * 30, "max_new_tokens": 500}).encode()
                     + b"\n")
        await writer.drain()
        await reader.readline()             # one token arrived
        writer.close()                      # hang up mid-stream
        try:
            await writer.wait_closed()
        except ConnectionResetError:
            pass
        await asyncio.wait_for(srv.close(), timeout=30.0)
        assert rt.stats.aborted == 1
        leakcheck(rt)
    asyncio.run(main())


def test_tcp_server_rejects_malformed_request(port):
    async def main():
        rt = AsyncEchoEngine(engine(port))
        await rt.start()
        srv = await EchoServer(rt, port=0).start()
        reader, writer = await asyncio.open_connection(*srv.address)
        writer.write(b'{"nope": 1}\n')
        await writer.drain()
        assert "error" in json.loads(await reader.readline())
        # the connection survives: a valid request still works
        writer.write(json.dumps({"prompt": [1, 2], "max_new_tokens": 2}).encode() + b"\n")
        await writer.drain()
        lines = [json.loads(await reader.readline()) for _ in range(3)]
        assert [ln.get("index") for ln in lines[:2]] == [0, 1] and lines[2]["done"]
        writer.close()
        await srv.close()
        leakcheck(rt)
    asyncio.run(main())


# ------------------------------------------------------------- observability
def test_rt_probe_matches_jax(sides, monkeypatch):
    """``AsyncEchoEngine.instrument`` in both packages over the same replay:
    the wall-clock histograms (the serving clock advances 10 ms a token),
    the service's metrics and the per-connection spans are equal, byte for
    byte in the Prometheus text."""
    import repro.rt as jrt
    import repro_torch.rt as trt

    def run(pkg, rt_mod):
        counting = _CountingClock()
        monkeypatch.setattr(pkg.engine_mod, "time", counting)
        clock = rt_mod.ManualClock()
        reqs = workload(pkg, seed=2, duration=2.0, rate=3.0)
        rt = rt_mod.AsyncEchoEngine(engine(pkg), clock=clock)
        rt.events.on_token(lambda ev: clock.advance(0.01))
        tracer = pkg.obs.Tracer()
        registry = rt.instrument(pkg.obs.MetricsRegistry(), tracer)

        async def main():
            async with rt:
                hs = [await rt.submit_request(r) for r in reqs]
                for h in hs:
                    await h.result()
        asyncio.run(main())
        monkeypatch.undo()
        leakcheck(rt)
        return registry, tracer, reqs

    jreg, jtr, jreqs = run(sides["jax"], jrt)
    treg, ttr, treqs = run(sides["port"], trt)
    assert outcome(treqs) == outcome(jreqs)
    assert treg.get("rt_requests_total").labels("finished").value == len(treqs)
    assert treg.get("rt_ttft_wall_seconds").percentile(0.5) > 0.0
    assert treg.to_prometheus().encode() == jreg.to_prometheus().encode()
    rt_spans = [e for e in ttr._events if e[4] == RT_PID]
    assert len(rt_spans) >= len(treqs)
    assert ttr.to_dict() == jtr.to_dict()


# ------------------------------------------------------------- calibration
LINK = [(n, 2e-10 * n + 5e-5 + 1e-6 * (i % 3))          # 5 GB/s, 50 us floor
        for i, n in enumerate((1 << 18, 1 << 18, 1 << 20, 1 << 20, 1 << 22, 1 << 22))]
OVERLAP = [(3e-4, n, 3e-4 + 2e-5 + 1e-6 * i) for i, n in enumerate((1 << 18, 1 << 20))]


@pytest.fixture
def fake_card(monkeypatch):
    """The port's calibration path up to the copies, without a card: the
    device resolves to CUDA, the card has a name, and the timings come
    from ``measure_link`` / ``measure_overlap``, which each test sets."""
    monkeypatch.setattr(tcalibrate, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "test card")
    return monkeypatch


def test_calibrate_link_fit_matches_jax(fake_card, sides):
    """The same samples fit the same swap terms in both packages."""
    terms, cals = [], []
    for pkg, mod in ((sides["jax"], jcalibrate), (sides["port"], tcalibrate)):
        fake_card.setattr(mod, "measure_link", lambda *a, **k: list(LINK))
        fake_card.setattr(mod, "measure_overlap", lambda *a, **k: list(OVERLAP))
        tm = pkg.core.TimeModel.h100()
        cal = mod.calibrate_link(tm)
        assert cal.applied and cal.samples == LINK and cal.overlap_samples == OVERLAP
        cals.append(cal)
        terms.append((tm.swap_byte, tm.swap_floor, tm.swap_launch,
                      cal.swap_byte, cal.swap_floor, cal.swap_launch, cal.bandwidth_gbs))
    assert terms[1] == terms[0]
    assert terms[1][0] == pytest.approx(2e-10, rel=1e-2)
    assert cals[1].backend == "test card"
    assert cals[1].summary().replace("test card", "cpu") == cals[0].summary()


def test_calibrate_link_degenerate_fit_restores_presets(fake_card, port):
    tm = port.core.TimeModel.h100()
    before = (tm.swap_byte, tm.swap_floor, tm.swap_launch)
    # all-equal timings: a fitted byte rate of zero
    fake_card.setattr(tcalibrate, "measure_link",
                      lambda *a, **k: [(1 << 18, 1e-4), (1 << 22, 1e-4)])
    cal = calibrate_link(tm, overlap=False)
    assert not cal.applied and "degenerate" in cal.error
    assert cal.backend == "test card"
    assert (tm.swap_byte, tm.swap_floor, tm.swap_launch) == before


class _FakeLink:
    """A card's pageable copies on a scripted clock: 2e-10 s a byte plus a
    50 us floor each way (5 GB/s), and the first timed upload of each size
    (its third, after the two warm-ups) stalled by 2 ms, as a preempted
    host thread stalls it."""
    BYTE, FLOOR, STALL = 2e-10, 5e-5, 2e-3

    def __init__(self):
        self.now, self.uploads = 0.0, {}

    def clock(self):
        return self.now

    def upload(self, buf, dev):
        n = buf.nbytes
        k = self.uploads[n] = self.uploads.get(n, 0) + 1
        self.now += self.BYTE * n + self.FLOOR + (self.STALL if k == 3 else 0.0)
        link = self

        class OnCard:
            def cpu(self):
                link.now += link.BYTE * n + link.FLOOR
        return OnCard()


@pytest.fixture
def fake_link(fake_card):
    link = _FakeLink()
    fake_card.setattr(tcalibrate, "_upload", link.upload)
    fake_card.setattr(tcalibrate, "time", type("T", (), {"perf_counter": link.clock}))
    return link


def test_measure_link_keeps_each_sizes_fastest_copy(fake_link):
    """One sample a size and direction, the fastest of the repeats: the
    stalled upload of each size does not reach the fit."""
    samples = tcalibrate.measure_link(repeats=3)
    want = [(n, _FakeLink.BYTE * n + _FakeLink.FLOOR)
            for n in tcalibrate.DEFAULT_SIZES for _ in range(2)]
    assert [n for n, _ in samples] == [n for n, _ in want]
    assert [t for _, t in samples] == pytest.approx([t for _, t in want], rel=1e-9)
    assert all(k == 2 + 3 for k in fake_link.uploads.values())


def test_calibrate_link_fits_the_link_through_stalls(fake_link, port):
    tm = port.core.TimeModel.h100()
    cal = calibrate_link(tm, overlap=False)
    assert cal.applied and cal.bandwidth_gbs == pytest.approx(5.0, rel=1e-6)
    assert tm.swap_floor == pytest.approx(_FakeLink.FLOOR, rel=1e-6)


@pytest.mark.parametrize("sizes,repeats", [((), 5), (tcalibrate.DEFAULT_SIZES, 0)])
def test_calibrate_link_without_samples_raises(fake_link, port, sizes, repeats):
    tm = port.core.TimeModel.h100()
    before = (tm.swap_byte, tm.swap_floor, tm.swap_launch)
    with pytest.raises(ValueError, match="at least one size and one repeat"):
        calibrate_link(tm, sizes=sizes, repeats=repeats)
    assert not fake_link.uploads
    assert (tm.swap_byte, tm.swap_floor, tm.swap_launch) == before


def test_calibrate_link_on_cpu_keeps_presets(port):
    tm = port.core.TimeModel.h100()
    before = (tm.swap_byte, tm.swap_floor, tm.swap_launch)
    cal = calibrate_link(tm, device="cpu")
    assert not cal.applied and cal.backend == "cpu"
    assert cal.error == "no host↔device link on the CPU"
    assert (tm.swap_byte, tm.swap_floor, tm.swap_launch) == before
    assert cal.summary().startswith("link calibration skipped")


def test_calibrate_link_default_device_without_card_raises(port):
    """No silent fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    tm = port.core.TimeModel.h100()
    before = (tm.swap_byte, tm.swap_floor, tm.swap_launch)
    with pytest.raises(RuntimeError, match="cuda"):
        calibrate_link(tm)
    with pytest.raises(RuntimeError, match="cuda"):
        tcalibrate.measure_link()
    assert (tm.swap_byte, tm.swap_floor, tm.swap_launch) == before

