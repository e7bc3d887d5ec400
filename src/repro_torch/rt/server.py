"""Newline-delimited-JSON TCP front end over ``AsyncEchoEngine``.

Stdlib-only (``asyncio.start_server``), so ``repro serve --serve`` listens
without pulling in an HTTP framework. Protocol, one JSON object per line:

  client -> server   {"prompt": [1, 2, 3], "max_new_tokens": 16,
                      "task_type": "online", "slo": [1.0, 0.1]}
  server -> client   {"token": 17, "index": 0, "t_wall": 0.012}   (streamed)
                     ...
                     {"done": true, "status": "finished",
                      "n_tokens": 16, "ttft_wall": 0.012,
                      "tpot_wall": 0.003}                         (terminal)

A malformed request line answers ``{"error": ...}`` and keeps the
connection; a client disconnect mid-stream aborts its in-flight request so
the engine releases KV blocks immediately. Each connection handles one
request at a time (pipeline by sending the next line after the ``done``).
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from repro_torch.core.request import SLO, TaskType
from repro_torch.rt.engine_loop import AsyncEchoEngine

logger = logging.getLogger(__name__)


def _parse_request(line: bytes) -> dict:
    obj = json.loads(line)
    if not isinstance(obj, dict) or "prompt" not in obj:
        raise ValueError("request must be a JSON object with a 'prompt'")
    prompt = obj["prompt"]
    if not isinstance(prompt, list) or not prompt \
            or not all(isinstance(t, int) for t in prompt):
        raise ValueError("'prompt' must be a non-empty list of ints")
    kwargs = {
        "task_type": TaskType(obj.get("task_type", "online")),
        "max_new_tokens": int(obj.get("max_new_tokens", 16)),
    }
    slo = obj.get("slo")
    if slo is not None:
        kwargs["slo"] = SLO(ttft=float(slo[0]), tpot=float(slo[1]))
    return {"prompt": prompt, **kwargs}


class EchoServer:
    """One listening socket bound to one ``AsyncEchoEngine``."""

    def __init__(self, rt: AsyncEchoEngine, *, host: str = "127.0.0.1",
                 port: int = 8631):
        self.rt = rt
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self.connections = 0
        self.requests_served = 0

    async def start(self) -> "EchoServer":
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        return self

    @property
    def address(self):
        sock = self._server.sockets[0]
        return sock.getsockname()[:2]

    async def close(self) -> None:
        """Stop accepting, then gracefully drain the engine."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.rt.drain()

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------ per-conn
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        handle = None
        try:
            while True:
                line = await reader.readline()
                if not line:           # EOF: client went away
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    spec = _parse_request(line)
                except (ValueError, KeyError, TypeError,
                        json.JSONDecodeError) as exc:
                    writer.write(json.dumps(
                        {"error": str(exc)}).encode() + b"\n")
                    await writer.drain()
                    continue
                handle = await self.rt.submit(**spec)
                async for ev in handle.tokens():
                    writer.write(json.dumps(
                        {"token": ev.token, "index": ev.index,
                         "t_wall": round(ev.t_wall, 6)}).encode() + b"\n")
                    await writer.drain()
                result = await handle.result()
                writer.write(json.dumps(
                    {"done": True, "status": result.status.value,
                     "n_tokens": len(result.tokens),
                     "ttft_wall": handle.wall_ttft(),
                     "tpot_wall": handle.wall_tpot()}).encode() + b"\n")
                await writer.drain()
                self.requests_served += 1
                handle = None
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            # disconnect mid-stream: release the in-flight request's KV now
            if handle is not None and not handle.done:
                try:
                    await handle.abort()
                except Exception:
                    logger.warning("abort on disconnect failed",
                                   exc_info=True)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass


async def request_once(host: str, port: int, prompt, *,
                       max_new_tokens: int = 16, task_type: str = "online",
                       slo=None) -> dict:
    """Minimal client: one request, collect the stream, return the summary
    dict (with ``tokens`` added). Used by the examples and smoke tests."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        spec = {"prompt": list(prompt), "max_new_tokens": max_new_tokens,
                "task_type": task_type}
        if slo is not None:
            spec["slo"] = [slo.ttft, slo.tpot]
        writer.write(json.dumps(spec).encode() + b"\n")
        await writer.drain()
        tokens = []
        while True:
            line = await reader.readline()
            if not line:
                raise ConnectionError("server closed mid-stream")
            obj = json.loads(line)
            if "error" in obj:
                raise ValueError(obj["error"])
            if obj.get("done"):
                obj["tokens"] = tokens
                return obj
            tokens.append(obj["token"])
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass
