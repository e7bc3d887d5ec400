"""Echo's primary contribution: scheduler + KV manager + estimators."""
from repro_torch.core.block_manager import BlockManager
from repro_torch.core.calibration import CalibrationSample, OnlineCalibrator
from repro_torch.core.engine import EchoEngine, EngineListener, EngineStats
from repro_torch.core.estimator import (MemoryPredictor, PerturbedTimeModel,
                                  RatePredictor, TimeModel)
from repro_torch.core.policies import (ALL_POLICIES, BS, BS_E, BS_E_S, ECHO,
                                 ECHO_C, PolicyConfig)
from repro_torch.core.radix_pool import OfflinePool
from repro_torch.core.request import SLO, Request, RequestState, TaskType
from repro_torch.core.scheduler import Plan, Scheduler

__all__ = [
    "ALL_POLICIES", "BS", "BS_E", "BS_E_S", "ECHO", "ECHO_C",
    "BlockManager", "CalibrationSample", "EchoEngine", "EngineListener",
    "EngineStats",
    "MemoryPredictor", "OfflinePool", "OnlineCalibrator",
    "PerturbedTimeModel", "Plan", "PolicyConfig", "RatePredictor", "Request",
    "RequestState", "SLO", "Scheduler", "TaskType", "TimeModel",
]
