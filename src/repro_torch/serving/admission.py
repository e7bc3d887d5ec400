"""Admission control: backpressure at the service front door.

Today's engine keeps an unbounded ``pending`` list — a traffic spike simply
queues forever and every SLO is missed late instead of shed early. The
controller applies three gates at ``submit`` time (HyGen/ConServe-style
elastic co-location, §4):

  * bounded online queue   — over ``max_online_queue`` waiting online
                             requests, new online arrivals are SHED;
  * SLO-feasibility shed   — if the TimeModel predicts the request cannot
                             make its TTFT deadline even if admitted now
                             (predicted first-token latency > ttft *
                             ``slo_shed_factor``), admit nobody we will
                             certainly fail: SHED on arrival;
  * offline pool soft cap  — offline work beyond ``offline_pool_cap``
                             backlog is *deferred* (held in a service-side
                             overflow queue, status QUEUED) and fed to the
                             backend as the pool drains — backpressure
                             without data loss, since offline tasks have no
                             deadline.

All gates default to off; a gate-less controller admits everything, which
is exactly the legacy ``submit_all`` behaviour the ``drive`` compatibility
path relies on.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional

from repro_torch.serving.handle import RequestHandle

ADMIT, SHED, DEFER = "admit", "shed", "defer"


@dataclass(frozen=True)
class AdmissionConfig:
    max_online_queue: Optional[int] = None   # bounded online queue (None=∞)
    slo_shed_factor: Optional[float] = None  # shed if pred TTFT > f * slo.ttft
    offline_pool_cap: Optional[int] = None   # soft cap on offline backlog

    @property
    def active(self) -> bool:
        return (self.max_online_queue is not None
                or self.slo_shed_factor is not None
                or self.offline_pool_cap is not None)


class AdmissionController:
    """Applies an ``AdmissionConfig`` against a service backend."""

    def __init__(self, config: AdmissionConfig):
        self.config = config
        self.deferred: Deque[RequestHandle] = deque()
        self._deferred_rids: set = set()   # live membership, O(1) cancel
        self._tombstones: set = set()      # rids cancelled while deferred
        self.shed_online = 0
        self.deferred_total = 0
        self.requeued_total = 0

    # ------------------------------------------------------------- verdict
    def verdict(self, backend, handle: RequestHandle) -> str:
        c = self.config
        req = handle.request
        if req.is_online:
            if c.max_online_queue is not None and \
                    backend.online_queue_depth() >= c.max_online_queue:
                self.shed_online += 1
                return SHED
            if c.slo_shed_factor is not None and req.slo is not None:
                pred = backend.predicted_ttft(req)
                if pred > req.slo.ttft * c.slo_shed_factor:
                    self.shed_online += 1
                    return SHED
            return ADMIT
        if c.offline_pool_cap is not None and \
                backend.offline_backlog() >= c.offline_pool_cap:
            self.deferred.append(handle)
            self._deferred_rids.add(handle.rid)
            self.deferred_total += 1
            return DEFER
        return ADMIT

    # ------------------------------------------------------------- pumping
    def pump(self, backend, events=None) -> int:
        """Feed deferred offline work into the backend while its backlog is
        under the soft cap. Called by the service before every step.

        Each resubmission re-runs the admission verdict (the gate may have
        tightened, or the handle may have gone terminal while deferred —
        blindly submitting an aborted handle would resurrect it) and emits a
        ``requeue`` event so LiveMetrics sees every deferred->queued
        transition. Cancelled handles are tombstoned by ``cancel`` and
        dropped lazily here, keeping cancellation O(1)."""
        fed = 0
        while self.deferred:
            handle = self.deferred.popleft()
            if handle.rid in self._tombstones:       # cancelled while queued
                self._tombstones.discard(handle.rid)
                continue
            self._deferred_rids.discard(handle.rid)
            if handle.done:                          # aborted/terminal: drop
                handle._deferred = False
                continue
            verdict = self.verdict(backend, handle)
            if verdict == DEFER:
                # still capped: verdict() re-appended at the TAIL; restore
                # the handle to the head so a saturated cap does not rotate
                # the queue (deferred work must drain FIFO)
                self.deferred.pop()
                self.deferred.appendleft(handle)
                self.deferred_total -= 1             # not a new deferral
                break
            handle._deferred = False
            if verdict == ADMIT:
                backend.submit(handle.request)
                self.requeued_total += 1
                if events is not None:
                    events.emit("requeue", handle)
                fed += 1
            else:                                    # SHED (gate tightened)
                handle._shed = True
                if events is not None:
                    events.emit("shed", handle)
        return fed

    def cancel(self, handle: RequestHandle) -> bool:
        """Drop a still-deferred handle from the overflow queue — O(1) via a
        tombstone; the deque entry is skipped on the next ``pump``."""
        if handle.rid not in self._deferred_rids:
            return False
        self._deferred_rids.discard(handle.rid)
        self._tombstones.add(handle.rid)
        handle._deferred = False
        return True
