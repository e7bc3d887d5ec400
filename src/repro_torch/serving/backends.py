"""Backend adapters: one stepping/intake/abort surface over a single
``EchoEngine`` or a ``ClusterSimulator``.

The facade never touches engine internals directly — everything it needs
(intake, one-event stepping, cancellation, load signals for admission,
legacy batch runs) goes through this protocol, so a service drives a
single-GPU engine and an N-replica cluster identically. ``run_legacy``
delegates to the backend's own ``run`` loop, guaranteeing the ``drive``
compatibility path reproduces the exact trace-benchmark numbers.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.cluster.replica import ReplicaState
from repro_torch.cluster.simulator import ClusterSimulator
from repro_torch.core.engine import MAX_STALLS, EchoEngine, EngineListener
from repro_torch.core.request import Request


class EngineBackend:
    """Single-engine backend."""

    default_max_iters = 10_000         # EchoEngine.run's default

    def __init__(self, engine: EchoEngine):
        self.engine = engine
        self._stalls = 0

    # ------------------------------------------------------------- surface
    def engines(self) -> List[EchoEngine]:
        return [self.engine]

    def attach(self, listener: EngineListener) -> None:
        if listener not in self.engine.listeners:
            self.engine.listeners.append(listener)

    def now(self) -> float:
        return self.engine.now

    def submit(self, req: Request) -> None:
        self.engine.submit(req)
        self._stalls = 0               # new work can unblock a stalled engine

    def abort(self, req: Request) -> bool:
        return self.engine.abort(req)

    def has_work(self) -> bool:
        return self.engine.has_work()

    def step(self, until_time: Optional[float] = None) -> bool:
        """One engine iteration with EchoEngine.run's stall semantics:
        returns False once nothing is left (or the backlog is provably
        unschedulable — the deadlock guard)."""
        eng = self.engine
        if until_time is not None and eng.now >= until_time:
            return False
        if self._stalls > MAX_STALLS or not self.has_work():
            return False
        rec = eng.step()
        if rec is None and not eng.pending:
            self._stalls += 1
        else:
            self._stalls = 0
        return True

    def run_legacy(self, max_iters: Optional[int] = None,
                   until_time: Optional[float] = None):
        return self.engine.run(max_iters or self.default_max_iters,
                               until_time=until_time)

    def flush(self) -> None:
        """Land in-flight swap staging (graceful-drain hook)."""
        self.engine.flush_swaps()

    def stats(self):
        return self.engine.stats

    # --------------------------------------------------------- load signals
    # (delegated to the engine — the same accounting cluster replicas use,
    # so engine and cluster admission caps compare)
    def online_queue_depth(self) -> int:
        return self.engine.online_queue_depth()

    def offline_backlog(self) -> int:
        return self.engine.offline_backlog()

    def predicted_ttft(self, req: Request) -> float:
        return self.engine.predicted_first_token_latency(req)


class ClusterBackend:
    """N-replica backend: intake goes through the cluster's arrival heap so
    the router places it; stepping advances one cluster event."""

    default_max_iters = 200_000        # ClusterSimulator.run's default

    def __init__(self, sim: ClusterSimulator):
        self.sim = sim

    # ------------------------------------------------------------- surface
    def engines(self) -> List[EchoEngine]:
        return [rep.engine for rep in self.sim.replicas]

    def attach(self, listener: EngineListener) -> None:
        for eng in self.engines():
            if listener not in eng.listeners:
                eng.listeners.append(listener)

    def now(self) -> float:
        """The cluster's event frontier: the clock of the next replica to
        step. Idle replicas must not hold it back — the legacy loop
        dispatches an arrival once ``t_arr <= min(busy replica clocks)``,
        and the service's held-arrival release mirrors that condition. With
        nothing busy, time has effectively advanced to the latest clock."""
        busy = [rep.engine.now for rep in self.sim.replicas
                if rep.state != ReplicaState.DOWN and rep.has_work()]
        if busy:
            return min(busy)
        return max((eng.now for eng in self.engines()), default=0.0)

    def submit(self, req: Request) -> None:
        self.sim.submit(req)

    def abort(self, req: Request) -> bool:
        return self.sim.abort(req)

    def has_work(self) -> bool:
        return bool(self.sim._pending) or \
            any(rep.has_work() for rep in self.sim.replicas)

    def step(self, until_time: Optional[float] = None) -> bool:
        return self.sim.step_event(until_time)

    def run_legacy(self, max_iters: Optional[int] = None,
                   until_time: Optional[float] = None):
        return self.sim.run(max_iters or self.default_max_iters,
                            until_time=until_time)

    def flush(self) -> None:
        for eng in self.engines():
            eng.flush_swaps()

    def stats(self):
        return self.sim.stats()

    # --------------------------------------------------------- load signals
    def online_queue_depth(self) -> int:
        n = sum(1 for _, _, r in self.sim._pending if r.is_online)
        n += sum(rep.online_queue_depth() for rep in self.sim.replicas)
        return n

    def offline_backlog(self) -> int:
        n = sum(1 for _, _, r in self.sim._pending if not r.is_online)
        n += sum(rep.offline_backlog() for rep in self.sim.replicas)
        return n

    def predicted_ttft(self, req: Request) -> float:
        """Best placement among replicas the router would actually use —
        JOINING/DRAINING/DOWN members must not make admission optimistic.
        With no routable replica (mid-failover), infinity: shed/queue."""
        live = self.sim.router.routable()
        if not live:
            return float("inf")
        return min(rep.predicted_added_latency(req) for rep in live)


def make_backend(target):
    """Coerce an ``EchoEngine``, ``ClusterSimulator``, or ready-made backend
    into the backend protocol."""
    if isinstance(target, EchoEngine):
        return EngineBackend(target)
    if isinstance(target, ClusterSimulator):
        return ClusterBackend(target)
    if hasattr(target, "step") and hasattr(target, "submit") \
            and hasattr(target, "engines"):
        return target
    raise TypeError(f"cannot build a serving backend from {type(target)!r}")
