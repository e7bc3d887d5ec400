"""Request handles: the caller's view of one in-flight request.

A ``RequestHandle`` is returned by ``EchoService.submit`` and is the only
object a front-end needs to hold: it streams token events (``tokens()``),
blocks for the final result (``result()``), reports live lifecycle status
(``status``), and cancels mid-flight (``abort()``). Streaming in this
discrete-event world means the generator *drives* the backend — each
``tokens()`` iteration advances the service until the next token (or a
terminal state) appears, so tokens interleave with scheduling exactly as
they would on a wall-clock server.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, List, Optional

from repro_torch.core.request import Request, RequestState

if TYPE_CHECKING:                      # avoid a runtime import cycle
    from repro_torch.serving.service import EchoService


class HandleStatus(enum.Enum):
    QUEUED = "queued"          # admitted; waiting for KV/batch slots
    RUNNING = "running"        # in the active batch (prefilling or decoding)
    PREEMPTED = "preempted"    # evicted mid-flight; will be re-admitted
    FINISHED = "finished"      # all tokens generated
    ABORTED = "aborted"        # cancelled; resources released
    SHED = "shed"              # rejected by admission control


TERMINAL_STATUSES = frozenset(
    (HandleStatus.FINISHED, HandleStatus.ABORTED, HandleStatus.SHED))


@dataclass(frozen=True)
class TokenEvent:
    """One generated token, stamped with the (virtual or wall) clock."""
    handle: "RequestHandle"
    token: int
    t: float                   # service clock at emission (iteration end)
    index: int                 # 0-based output position

    @property
    def first(self) -> bool:
        return self.index == 0


@dataclass
class RequestResult:
    """Terminal summary returned by ``RequestHandle.result()``."""
    tokens: List[int]
    status: HandleStatus
    ttft: Optional[float]
    tpot: Optional[float]
    finish_time: Optional[float]
    n_preemptions: int


class RequestHandle:
    """Live view of one request inside an ``EchoService``."""

    def __init__(self, service: "EchoService", request: Request):
        self._service = service
        self.request = request
        self.token_events: List[TokenEvent] = []
        self._shed = False             # rejected at admission
        self._aborted = False
        self._deferred = False         # held in the admission overflow queue

    # ------------------------------------------------------------- identity
    @property
    def rid(self) -> int:
        return self.request.rid

    def __repr__(self) -> str:
        return (f"RequestHandle(rid={self.rid}, "
                f"status={self.status.value}, "
                f"tokens={len(self.token_events)})")

    # ------------------------------------------------------------- status
    @property
    def status(self) -> HandleStatus:
        if self._shed:
            return HandleStatus.SHED
        req = self.request
        if self._aborted or req.state == RequestState.ABORTED:
            return HandleStatus.ABORTED
        if req.state == RequestState.FINISHED:
            return HandleStatus.FINISHED
        if req.state == RequestState.RUNNING:
            return HandleStatus.RUNNING
        # WAITING: either never started or kicked out mid-flight
        if req.n_preemptions > 0:
            return HandleStatus.PREEMPTED
        return HandleStatus.QUEUED

    @property
    def done(self) -> bool:
        return self.status in TERMINAL_STATUSES

    # ------------------------------------------------------------- metrics
    def ttft(self) -> Optional[float]:
        return self.request.ttft()

    def tpot(self) -> Optional[float]:
        return self.request.tpot()

    # ------------------------------------------------------------- stream
    def tokens(self) -> Iterator[TokenEvent]:
        """Incremental token events. Replays what already arrived, then
        *drives the service* one event at a time until this request reaches
        a terminal state (or the backend can make no more progress)."""
        i = 0
        while True:
            while i < len(self.token_events):
                yield self.token_events[i]
                i += 1
            if self.done:
                return
            if not self._service.step():
                return                  # backend drained or stalled

    # ------------------------------------------------------------- result
    def result(self) -> RequestResult:
        """Drive the service until this request is terminal, then summarize.
        Never raises on cancellation — an aborted/shed request reports its
        partial tokens with the matching status."""
        while not self.done and self._service.step():
            pass
        req = self.request
        return RequestResult(tokens=list(req.output_tokens),
                             status=self.status,
                             ttft=req.ttft(), tpot=req.tpot(),
                             finish_time=req.finish_time,
                             n_preemptions=req.n_preemptions)

    # ------------------------------------------------------------- control
    def abort(self) -> bool:
        """Cancel mid-flight: frees KV blocks, drops radix-pool pins, and
        removes the request from scheduler queues. Returns False if the
        request was already terminal."""
        return self._service.abort(self)
