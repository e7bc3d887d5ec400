"""Async request handles: one live connection's view of its request.

``AsyncEchoEngine.submit`` returns an ``AsyncRequestHandle``. The caller
streams tokens with ``async for ev in handle.tokens()``, awaits the
terminal summary with ``await handle.result()``, and cancels mid-flight
with ``await handle.abort()``. Unlike the synchronous
``serving.RequestHandle`` — whose ``tokens()`` generator *drives* the
backend — this handle is passive: the engine's continuous-batching loop
pushes token events into a bounded per-request queue and the consumer
just awaits them, so thousands of connections stream concurrently off one
loop.

Every handle carries stamps in both time domains: the backend's clock
(``t_engine`` on each token, the engine-side TTFT/TPOT in ``result()``)
and the serving clock (``t_wall``, ``wall_ttft()``, ``wall_tpot()``) —
the latter is what a real client measures against its SLO.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import TYPE_CHECKING, AsyncIterator, Optional

from repro_torch.core.request import Request
from repro_torch.serving.handle import HandleStatus, RequestResult

if TYPE_CHECKING:                      # avoid a runtime import cycle
    from repro_torch.rt.engine_loop import AsyncEchoEngine

_EOS = object()                        # closes the token stream


class SubmitQueueFull(RuntimeError):
    """Raised by ``submit(..., wait=False)`` when the bounded submit queue
    is saturated and the engine is configured to raise instead of shed."""


@dataclass(frozen=True)
class AsyncTokenEvent:
    """One streamed token, stamped in both time domains."""
    token: int
    index: int                 # 0-based output position
    t_engine: float            # backend clock at emission (iteration end)
    t_wall: float              # serving clock when the loop delivered it

    @property
    def first(self) -> bool:
        return self.index == 0


class AsyncRequestHandle:
    """Live view of one request inside an ``AsyncEchoEngine``."""

    def __init__(self, engine: "AsyncEchoEngine", request: Request, *,
                 token_queue_cap: int = 0, live_arrival: bool = True):
        self._engine = engine
        self.request = request
        self.live_arrival = live_arrival   # stamp arrival at intake drain
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=token_queue_cap)
        self._done: asyncio.Future = \
            asyncio.get_running_loop().create_future()
        self._sync = None                  # serving handle once admitted
        self._closed: Optional[HandleStatus] = None   # set at finalize
        self._cancelled = False            # aborted while still in intake
        self.overflowed = False            # slow consumer: queue cap hit
        # wall-domain stamps (serving clock)
        self.t_submit_wall: float = engine.clock.now()
        self.t_first_token_wall: Optional[float] = None
        self.t_last_token_wall: Optional[float] = None
        self.t_finish_wall: Optional[float] = None
        self.n_tokens = 0                  # tokens pushed (streamed or not)

    # ------------------------------------------------------------- identity
    @property
    def rid(self) -> int:
        return self.request.rid

    def __repr__(self) -> str:
        return (f"AsyncRequestHandle(rid={self.rid}, "
                f"status={self.status.value}, tokens={self.n_tokens})")

    # ------------------------------------------------------------- status
    @property
    def status(self) -> HandleStatus:
        if self._closed is not None:
            return self._closed
        if self._cancelled:
            return HandleStatus.ABORTED
        if self._sync is not None:
            return self._sync.status
        return HandleStatus.QUEUED         # still in the intake queue

    @property
    def done(self) -> bool:
        return self._closed is not None or self._cancelled

    # ------------------------------------------------------------- metrics
    def wall_ttft(self) -> Optional[float]:
        """Serving-clock time from submit to first streamed token."""
        if self.t_first_token_wall is None:
            return None
        return self.t_first_token_wall - self.t_submit_wall

    def wall_tpot(self) -> Optional[float]:
        """Serving-clock seconds per output token after the first."""
        if self.t_last_token_wall is None or self.n_tokens < 2:
            return None
        return ((self.t_last_token_wall - self.t_first_token_wall)
                / (self.n_tokens - 1))

    def wall_latency(self) -> Optional[float]:
        """Submit-to-terminal serving-clock latency."""
        if self.t_finish_wall is None:
            return None
        return self.t_finish_wall - self.t_submit_wall

    # ------------------------------------------------------------- stream
    async def tokens(self) -> AsyncIterator[AsyncTokenEvent]:
        """Stream token events as the engine loop produces them. Ends when
        the request reaches a terminal state (finished, aborted, or shed —
        check ``status`` afterwards to tell which)."""
        while True:
            item = await self._queue.get()
            if item is _EOS:
                return
            yield item

    # ------------------------------------------------------------- result
    async def result(self) -> RequestResult:
        """Await the terminal summary (engine-domain ttft/tpot; the wall
        numbers live on the handle). Never raises on cancellation: an
        aborted/shed request reports partial tokens with its status."""
        return await asyncio.shield(self._done)

    # ------------------------------------------------------------- control
    async def abort(self) -> bool:
        """Cancel mid-flight: the loop frees KV blocks, drops radix-pool
        pins, and removes the request from scheduler queues. Returns False
        if the request was already terminal."""
        return await self._engine._abort(self)

    # --------------------------------------------------- loop-thread side
    # (the methods below run on the event-loop thread only)
    def _push_token(self, token: int, index: int, t_engine: float,
                    t_wall: float) -> bool:
        """Queue one token for the consumer. Returns False when the bounded
        queue is full — the slow-consumer signal the engine turns into an
        abort."""
        ev = AsyncTokenEvent(token=token, index=index,
                             t_engine=t_engine, t_wall=t_wall)
        try:
            self._queue.put_nowait(ev)
        except asyncio.QueueFull:
            self.overflowed = True
            return False
        if self.t_first_token_wall is None:
            self.t_first_token_wall = t_wall
        self.t_last_token_wall = t_wall
        self.n_tokens += 1
        return True

    def _finalize(self, status: HandleStatus, t_wall: float) -> None:
        """Terminal transition: close the stream and resolve ``result()``.
        Idempotent — the first status wins."""
        if self._closed is not None:
            return
        self._closed = status
        self.t_finish_wall = t_wall
        try:
            self._queue.put_nowait(_EOS)
        except asyncio.QueueFull:
            # slow consumer raced the close: drop the oldest undelivered
            # token so the EOS always lands and the stream terminates
            try:
                self._queue.get_nowait()
            except asyncio.QueueEmpty:
                pass
            self._queue.put_nowait(_EOS)
        if not self._done.done():
            req = self.request
            self._done.set_result(RequestResult(
                tokens=list(req.output_tokens), status=status,
                ttft=req.ttft(), tpot=req.tpot(),
                finish_time=req.finish_time,
                n_preemptions=req.n_preemptions))
