"""Request bookkeeping: task types, SLOs, lifecycle, latency budgets (§5.1)."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class TaskType(enum.Enum):
    ONLINE = "online"
    OFFLINE = "offline"


class RequestState(enum.Enum):
    WAITING = "waiting"        # queued / pooled, no KV resident
    RUNNING = "running"        # in the active batch (prefilling or decoding)
    PREEMPTED = "preempted"    # evicted mid-flight; will be re-admitted
    FINISHED = "finished"
    ABORTED = "aborted"        # cancelled mid-flight; resources released


@dataclass(frozen=True)
class SLO:
    ttft: float = 1.0          # s, time-to-first-token
    tpot: float = 0.18         # s, time-per-output-token


_counter = itertools.count()


@dataclass
class Request:
    prompt: Tuple[int, ...]
    max_new_tokens: int
    task_type: TaskType
    arrival_time: float = 0.0
    slo: Optional[SLO] = None
    rid: int = field(default_factory=lambda: next(_counter))

    state: RequestState = RequestState.WAITING
    computed_tokens: int = 0               # positions with KV resident
    prefill_target_len: int = 0            # snapshot of known tokens at admission
    output_tokens: List[int] = field(default_factory=list)
    block_ids: List[int] = field(default_factory=list)
    n_preemptions: int = 0
    recomputed_tokens: int = 0             # prefill tokens re-done after preemption
    swapped_in_tokens: int = 0             # prefill tokens restored from host KV
    owner_pins: List[int] = field(default_factory=list)
    # block hashes carrying this request's unfinished-owner pin (set when a
    # preemption releases its committed blocks; cleared on return or abort)

    # metrics
    first_token_time: Optional[float] = None
    first_scheduled_time: Optional[float] = None   # first batch admission
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    # ------------------------------------------------------------- helpers
    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def full_tokens(self) -> Tuple[int, ...]:
        """Known token content (prompt + generated). After a recompute-mode
        preemption the generated tokens are re-prefilled as prompt (vLLM)."""
        return self.prompt + tuple(self.output_tokens)

    def admit(self, now: Optional[float] = None) -> None:
        """(Re-)admission: prefill covers all currently-known tokens.
        The first admission is stamped for queue-delay metrics."""
        self.prefill_target_len = len(self.full_tokens)
        self.state = RequestState.RUNNING
        if now is not None and self.first_scheduled_time is None:
            self.first_scheduled_time = now

    @property
    def prefill_done(self) -> bool:
        return self.computed_tokens >= self.prefill_target_len

    @property
    def remaining_prefill(self) -> int:
        return max(self.prefill_target_len - self.computed_tokens, 0)

    @property
    def n_output(self) -> int:
        return len(self.output_tokens)

    @property
    def done(self) -> bool:
        return self.n_output >= self.max_new_tokens

    @property
    def total_len(self) -> int:
        """Positions with KV resident."""
        return self.computed_tokens

    @property
    def is_online(self) -> bool:
        return self.task_type == TaskType.ONLINE

    def latency_budget(self, now: float) -> float:
        """§5.1: deadline slack for the *next* token of this request.

        Token i (0-based output index) must arrive by
        arrival + TTFT + i * TPOT. Returns remaining seconds (can be <0).
        """
        if self.slo is None:
            return float("inf")
        i = self.n_output
        deadline = self.arrival_time + self.slo.ttft + i * self.slo.tpot
        return deadline - now

    def record_token(self, tok: int, now: float) -> None:
        if self.first_token_time is None:
            self.first_token_time = now
        self.output_tokens.append(tok)
        self.token_times.append(now)
        if self.done:
            self.finish_time = now
            self.state = RequestState.FINISHED

    # metric accessors ----------------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tpot(self) -> Optional[float]:
        if self.n_output < 2:
            return None
        return (self.token_times[-1] - self.token_times[0]) / (self.n_output - 1)

    def queue_delay(self) -> Optional[float]:
        """Arrival to first batch admission (None if never scheduled)."""
        if self.first_scheduled_time is None:
            return None
        return self.first_scheduled_time - self.arrival_time
