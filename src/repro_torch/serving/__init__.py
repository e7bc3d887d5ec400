"""Online serving facade: request handles, streaming, cancellation, and
admission control over engine and cluster backends."""
from repro_torch.serving.admission import AdmissionConfig, AdmissionController
from repro_torch.serving.backends import ClusterBackend, EngineBackend, make_backend
from repro_torch.serving.events import (EventBus, LiveMetrics, OverlapEvent,
                                  SwapEvent)
from repro_torch.serving.handle import (TERMINAL_STATUSES, HandleStatus,
                                  RequestHandle, RequestResult, TokenEvent)
from repro_torch.serving.service import EchoService

__all__ = [
    "AdmissionConfig", "AdmissionController", "ClusterBackend", "EchoService",
    "EngineBackend", "EventBus", "HandleStatus", "LiveMetrics",
    "OverlapEvent", "RequestHandle", "RequestResult", "SwapEvent",
    "TERMINAL_STATUSES",
    "TokenEvent", "make_backend",
]
