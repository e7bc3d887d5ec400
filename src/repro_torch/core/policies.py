"""The evaluation ablation lattice (§7.1).

BS        : vLLM + priority scheduling (online preempts offline), FCFS
            offline order, plain-LRU free table, no SLO estimator.
BS+E      : + execution-time estimator gating batch growth by online SLOs.
BS+E+S    : + KV-cache-aware offline selection (prefix affinity, length
            regularity, last-batch incremental plan search).
Echo      : + task-aware KV cache manager (priority eviction + burst
            threshold from the memory predictor).
Echo+C    : + online calibration — the scheduler's time model is refit
            against the observed (ground-truth) clock when it drifts.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PolicyConfig:
    name: str
    use_estimator: bool      # SLO-aware admission (E)
    kv_aware_sched: bool     # prefix/regularity-aware offline selection (S)
    task_aware_kv: bool      # priority eviction + threshold (M)
    calibrate: bool = False  # online refit of the time model (C)


BS = PolicyConfig("BS", False, False, False)
BS_E = PolicyConfig("BS+E", True, False, False)
BS_E_S = PolicyConfig("BS+E+S", True, True, False)
ECHO = PolicyConfig("Echo", True, True, True)
ECHO_C = PolicyConfig("Echo+C", True, True, True, calibrate=True)

ALL_POLICIES = (BS, BS_E, BS_E_S, ECHO)
