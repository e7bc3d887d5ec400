"""Real-time serving layer: the asyncio front door over ``EchoService``.

``AsyncEchoEngine`` runs the continuous-batching loop as a background
task (``engine.step`` off-thread), stamps live arrivals with real times
for wall-clock admission, streams tokens to ``AsyncRequestHandle``
consumers, and drains gracefully. ``EchoServer`` puts a
newline-delimited-JSON TCP socket in front of it; ``calibrate_link``
refits the ``TimeModel``'s PCIe terms from timed host↔device copies on
the card at cold start.
"""
from repro_torch.rt.calibrate import (LinkCalibration, calibrate_link,
                                measure_link, measure_overlap)
from repro_torch.rt.clock import ManualClock, WallClock
from repro_torch.rt.engine_loop import AsyncEchoEngine, RTState, RTStats
from repro_torch.rt.handle import (AsyncRequestHandle, AsyncTokenEvent,
                             SubmitQueueFull)
from repro_torch.rt.server import EchoServer, request_once

__all__ = [
    "AsyncEchoEngine", "AsyncRequestHandle", "AsyncTokenEvent",
    "EchoServer", "LinkCalibration", "ManualClock", "RTState", "RTStats",
    "SubmitQueueFull", "WallClock", "calibrate_link", "measure_link",
    "measure_overlap", "request_once",
]
