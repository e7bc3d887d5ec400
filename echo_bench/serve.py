"""Drive the port's ``EchoEngine`` under a cell's traffic and record it.

The engine is the one a deployment runs: ``EchoEngine`` with policy ECHO,
``clock="wall"``, the scheduler's estimate ``TimeModel.h100()`` (named in
the configuration file), no host KV tier, serving through
``TorchPagedRunner`` (split-K decode, chunked prefill). The benchmark keeps
its own monotonic clock (``time.perf_counter``): an open-loop generator
submits each online request once its due time has passed, between engine
steps, with ``arrival_time = engine.now`` so the engine takes it at once;
an ``EngineListener`` stamps every online token on that clock. The whole
offline backlog is submitted before the ramp.

Spans: the runner's ``prefill_chunk`` and ``decode`` and the scheduler's
``schedule`` are wrapped on their instances; each call is timed on the
benchmark's clock and its arguments kept (chunk length and context of a
prefill, the contexts of a decode's live rows). While the profiler runs,
each also opens a named range for the device trace. The page pool's
occupancy by task type (``BlockManager.usage_breakdown``: running and
cached blocks, online and offline, and blocks never used) is read at the
window's start and end.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from repro_torch.configs import get_config
from repro_torch.core.engine import EchoEngine, EngineListener
from repro_torch.core.estimator import TimeModel
from repro_torch.core.policies import ECHO
from repro_torch.core.request import SLO, Request, TaskType
from repro_torch.models.model import Model
from repro_torch.models.paged import TorchPagedRunner

from echo_bench import stats, traffic
from echo_bench.devtrace import Profiler

clock = time.perf_counter


@dataclass
class Call:
    kind: str                      # "prefill" or "decode"
    t0: float
    t1: float
    rid: Optional[int] = None      # prefill: the request
    chunk: int = 0                 # prefill: live rows
    ctx: Tuple[int, ...] = ()      # prefill: (start,); decode: each row's context
    rids: Tuple[int, ...] = ()     # decode: each row's request


@dataclass
class Record:
    """What one run saw; the per-layer readers take it."""
    model: dict                    # the configuration's "model"
    engine: dict                   # the configuration's "engine"
    window: Tuple[float, float] = (0.0, 0.0)
    calls: List[Call] = field(default_factory=list)
    iterations: List[Tuple[float, float]] = field(default_factory=list)  # (t, schedule s)
    counters: Dict[str, Dict[str, int]] = field(default_factory=dict)    # "start"/"end"
    occupancy: Dict[str, Dict[str, int]] = field(default_factory=dict)   # "start"/"end"
    num_blocks: int = 0            # the page pool
    offline_rids: frozenset = frozenset()
    offline_progress: int = 0      # offline tokens credited in the window
    trace: object = None           # devtrace.Trace of the profiled sub-window
    online: List[Tuple[float, int]] = field(default_factory=list)   # (due, rid)
    token_times: Dict[int, List[float]] = field(default_factory=dict)  # rid -> stamps
    drain_end: float = 0.0

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t < self.window[1]

    def ttfts(self) -> Tuple[List[float], int]:
        """``stats.ttfts`` of the online requests due in the window."""
        firsts = [self.token_times[rid][0] if rid in self.token_times else None
                  for _, rid in self.online]
        return stats.ttfts([d for d, _ in self.online], firsts, self.window, self.drain_end)

    def itls(self) -> List[float]:
        return stats.itls(self.token_times, self.window)


def model_config(cfg: dict):
    """The port's ``ModelConfig``: the registry's arch with the file's
    ``replace`` fields, held to the file's ``model`` numbers."""
    mc = dataclasses.replace(get_config(cfg["arch"]), **cfg.get("replace", {}))
    m = cfg["model"]
    for k, v in m.items():
        if getattr(mc, k) != v:
            raise ValueError(f"{cfg['name']}: registry {cfg['arch']!r} gives {k}="
                             f"{getattr(mc, k)!r}, the file states {v!r}")
    return mc


class Tokens(EngineListener):
    """Stamps each online token on the benchmark's clock."""

    def __init__(self):
        self.times: Dict[int, List[float]] = {}
        self.iterations: List[Tuple[float, float]] = []

    def on_token(self, req, tok, t):
        if req.is_online:
            self.times.setdefault(req.rid, []).append(clock())


class TokensAndIterations(Tokens):
    """Also keeps each iteration's end and ``schedule_wall`` (the engine
    builds its ``IterationDetail`` only for a listener that overrides
    ``on_iteration``, so the untraced run does not pay for it)."""

    def on_iteration(self, rec, detail):
        self.iterations.append((clock(), detail.schedule_wall))


def pool_blocks(cfg: dict, params, model, device) -> int:
    """Blocks the page pool gets: what the card has left after the weights
    and the activation peak of the cell's largest calls (a full prefill
    chunk over a full table, a decode of ``max_running`` rows), less the
    stated margin, as vLLM's ``gpu_memory_utilization`` sizes its pool. On
    the CPU the file states the count."""
    e, m = cfg["engine"], cfg["model"]
    pool = cfg["pool"]
    if pool["rule"] == "blocks":
        return int(pool["blocks"])
    probe = TorchPagedRunner(model, params, e["max_pages_per_seq"] + 1, e["block_size"],
                             e["max_pages_per_seq"], e["chunk_size"], device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    table = list(range(e["max_pages_per_seq"]))
    probe.prefill_chunk([1] * e["chunk_size"], 0, table)
    b = e["max_running"]
    probe.decode([1] * b, [table] * b, [e["block_size"]] * b)
    torch.cuda.synchronize()
    act = torch.cuda.max_memory_allocated() - base
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    per_block = (2 * m["num_layers"] * e["block_size"] * m["num_kv_heads"] * m["head_dim"]
                 * (2 if m["dtype"] == "bfloat16" else 4))
    n = int((free - act - pool["margin_gib"] * 2 ** 30) // per_block)
    return n // pool["round_blocks"] * pool["round_blocks"]


def warm_up(runner, e: dict) -> None:
    """Every shape the window uses: a chunk (the runner pads each to
    ``chunk_size``), near the start and deep in a full table, and a decode
    at each padded batch (powers of two up to ``max_running``). The kernels
    build at the first call."""
    table = list(range(e["max_pages_per_seq"]))
    deep = e["max_pages_per_seq"] * e["block_size"] - e["chunk_size"]
    runner.prefill_chunk([1] * e["chunk_size"], 0, table)
    runner.prefill_chunk([1] * 7, deep, table)
    b = 1
    while True:
        runner.decode([1] * b, [table] * b, [e["block_size"]] * b)
        if b >= e["max_running"]:
            break
        b *= 2


class Session:
    def __init__(self, cfg: dict, mix: dict, params, seed: int, seconds: float, device: str,
                 trace: bool, rate_per_s: float = None, iterations: bool = False):
        e = cfg["engine"]
        if e["policy"] != ECHO.name or e["time_model"] != "h100" or e["host_kv_blocks"]:
            raise ValueError("the cells serve ECHO on TimeModel.h100() without a host tier")
        self.mix, self.seconds = mix, float(seconds)
        t0 = clock()
        model = Model(model_config(cfg))
        self.num_blocks = pool_blocks(cfg, params, model, device)
        t1 = clock()
        self.engine = EchoEngine(
            model, params, ECHO, num_blocks=self.num_blocks,
            block_size=e["block_size"], chunk_size=e["chunk_size"],
            max_pages_per_seq=e["max_pages_per_seq"], time_model=TimeModel.h100(),
            clock="wall", max_batch_tokens=e["max_batch_tokens"],
            max_running=e["max_running"], host_kv_blocks=0, device=device)
        warm_up(self.engine.runner, e)
        if device == "cuda":
            torch.cuda.synchronize()
        t2 = clock()
        vocab = cfg["model"]["vocab_size"]
        self.online = traffic.make_online(mix, vocab, seed, seconds, rate_per_s)
        self.offline_specs = traffic.make_offline(mix, vocab, seed)
        self.setup_parts = {"pool sizing and build": t1 - t0, "engine and warm-up": t2 - t1,
                            "traffic": clock() - t2}
        self.rec = Record(model=cfg["model"], engine=e, num_blocks=self.num_blocks)
        self.listener = TokensAndIterations() if trace or iterations else Tokens()
        self.engine.listeners.append(self.listener)
        # the device trace needs the card: a CPU run reports no device metric
        self.profiler = Profiler() if trace and device == "cuda" else None
        if self.profiler is not None:
            self.profiler.prime()
        self.first_ctx: Dict[int, int] = {}          # rid -> context of its first chunk
        self.chunks: Dict[int, int] = {}             # rid -> prefill calls
        self._wrap()

    # ------------------------------------------------------------ spans
    def _wrap(self) -> None:
        runner, sched, rec, prof = self.engine.runner, self.engine.scheduler, self.rec, \
            self.profiler
        prefill, decode, schedule = runner.prefill_chunk, runner.decode, sched.schedule

        def timed(kind, fn, call, *a, **k):
            i = len(rec.calls)
            call.t0 = clock()
            if prof is not None and prof.active:
                with prof.mark(f"eb.{kind}#{i}"):
                    out = fn(*a, **k)
            else:
                out = fn(*a, **k)
            call.t1 = clock()
            rec.calls.append(call)
            return out

        def prefill_chunk(token_chunk, ctx_len, block_table, rid=None):
            if rid not in self.first_ctx:
                self.first_ctx[rid] = ctx_len
            self.chunks[rid] = self.chunks.get(rid, 0) + 1
            call = Call("prefill", 0.0, 0.0, rid=rid, chunk=len(token_chunk),
                        ctx=(ctx_len,))
            return timed("prefill", prefill, call, token_chunk, ctx_len, block_table, rid=rid)

        def decode_(tokens, block_tables, pos, rids=None):
            call = Call("decode", 0.0, 0.0, ctx=tuple(p + 1 for p in pos),
                        rids=tuple(rids) if rids is not None else ())
            return timed("decode", decode, call, tokens, block_tables, pos, rids=rids)

        def schedule_(now):
            if prof is not None and prof.active:
                with prof.mark("eb.schedule"):
                    return schedule(now)
            return schedule(now)

        runner.prefill_chunk, runner.decode, sched.schedule = prefill_chunk, decode_, schedule_

    # ------------------------------------------------------------ the run
    def run(self, until_done: bool = False) -> dict:
        """Ramp, window, drain. The drain serves on until every online
        request due in the window has its first token (``until_done``: has
        finished), or ``drain_s`` has passed."""
        seconds = self.seconds
        eng, mix, rec, prof = self.engine, self.mix, self.rec, self.profiler
        slo = SLO(ttft=mix["slo"]["ttft_s"], tpot=mix["slo"]["tpot_s"])
        offline = [Request(prompt=s.prompt, max_new_tokens=s.max_new,
                           task_type=TaskType.OFFLINE, arrival_time=eng.now)
                   for s in self.offline_specs]
        self.offline = offline
        rec.offline_rids = frozenset(r.rid for r in offline)
        for r in offline:
            eng.submit(r)
        hw: Dict[int, int] = {}

        def progress() -> int:
            return sum((r.prompt_len if r.done else hw.get(r.rid, 0)) + r.n_output
                       for r in offline)

        # the set-up's objects (the engine's blocks, the backlog) outlive the
        # run: out of the collector's reach, as serving processes freeze
        # theirs after start-up, a full collection does not walk them
        gc.collect()
        gc.freeze()
        t_ramp = clock()
        w0 = t_ramp + float(mix["ramp_s"])
        w1 = w0 + seconds
        # the profiled sub-window: the window's last ``profile_s`` seconds,
        # so that stopping the profiler (seconds of the host's) falls after
        # the window has closed
        p0 = max(w1 - float(mix["profile_s"]), w0)
        drain_until = w1 + float(mix["drain_s"])
        online, due, late = [], [], []
        i, phase = 0, "ramp"
        start = end = None
        while True:
            now = clock()
            while i < len(self.online) and t_ramp + self.online[i].due_s <= now:
                s = self.online[i]
                r = Request(prompt=s.prompt, max_new_tokens=s.max_new,
                            task_type=TaskType.ONLINE, arrival_time=eng.now, slo=slo)
                eng.submit(r)
                online.append(r)
                due.append(t_ramp + s.due_s)
                late.append(now - due[-1])
                i += 1
            if phase == "ramp" and now >= w0:
                rec.occupancy["start"] = eng.bm.usage_breakdown()
                now = clock()
                phase, start = "window", now
                rec.counters["start"] = self._counters()
                prog0, it0 = progress(), len(self.listener.iterations)
                queue0 = eng.online_queue_depth()
            if phase == "window" and prof is not None and not prof.active \
                    and not prof.done and now >= p0:
                prof.start()
            if phase == "window" and now >= w1:
                if prof is not None and prof.active:
                    prof.stop()
                phase, end = "drain", now
                rec.counters["end"] = self._counters()
                rec.occupancy["end"] = eng.bm.usage_breakdown()
                prog1 = progress()
                queue1 = eng.online_queue_depth()
                rec.window = (start, end)
                backlog = [r for r in offline if not r.done]
                left = sum(r.prompt_len + r.max_new_tokens - ((r.prompt_len if r.done else
                           hw.get(r.rid, 0)) + r.n_output) for r in backlog)
                total = sum(r.prompt_len + r.max_new_tokens for r in offline)
            if phase == "drain":
                waiting = [r for r, d in zip(online, due) if start <= d < end
                           and (not r.done if until_done
                                else r.rid not in self.listener.times)]
                if not waiting or now >= drain_until:
                    break
            if prof is not None and prof.active:
                with prof.mark("eb.step"):
                    eng.step()
            else:
                out = eng.step()
                if out is None and not eng.has_work():
                    time.sleep(0.001)
            for r in eng.scheduler.running:
                if not r.is_online:
                    c = min(r.computed_tokens, r.prompt_len)
                    if c > hw.get(r.rid, 0):
                        hw[r.rid] = c
        rec.iterations = [x for x in self.listener.iterations[it0:] if rec.in_window(x[0])]
        rec.online = [(d, r.rid) for r, d in zip(online, due)]
        rec.token_times, rec.drain_end = self.listener.times, clock()
        rec.offline_progress = prog1 - prog0
        return dict(online=online, due=due, late=late, start=start, end=end,
                    offline_progress=prog1 - prog0,
                    backlog_requests=(len(backlog), len(offline)),
                    backlog_tokens=(left, total), blocks=self.num_blocks,
                    queue=(queue0, queue1))

    def _counters(self) -> Dict[str, int]:
        return dataclasses.asdict(self.engine.bm.metrics)

    def close(self) -> None:
        """Drop the engine (its page pool) so that the reference fits."""
        runner = self.engine.runner
        for name in ("prefill_chunk", "decode"):
            runner.__dict__.pop(name, None)
        self.engine.scheduler.__dict__.pop("schedule", None)
        self.engine = None
        gc.unfreeze()
        gc.collect()
