"""Stdlib asyncio HTTP/1.1 front end for ``NodeService``.

One endpoint, JSON-RPC shaped: ``POST /rpc`` with a body of
``{"method": ..., "params": {...}, "id": ...}``; responses echo ``id``
and carry either ``result`` or ``error``.  ``GET /health`` answers
liveness probes.  No dependencies beyond asyncio + json on purpose —
the serving face must boot in the same minimal environments the rest of
the stack runs in.

Methods (the wire format, status codes and 429 rule of the JAX package's
``src/repro/serve/http.py``, byte for byte; docs/SERVING.md):

  submit        {fn, sender, fee?, at?}      -> {ref, status[, reason]}
  receipt       {ref}                        -> receipt record
  get_account   {address}                    -> AccountView fields
  state_root    {}                           -> {state_root}
  capabilities  {}                           -> {capabilities: [...]}
  events        {cursor?, kinds?, limit?}    -> {events, next_cursor,
                                                 dropped}
  flush         {}                           -> {status, flushed}
  metrics       {}                           -> live counters

Backpressure: an ``overloaded`` result (full writer queue, or a pool
rejection with reason ``overloaded``) is returned with HTTP status 429
so well-behaved clients can back off on the status code alone; every
other admission rejection is a 200 with the machine-readable reason —
the request was handled, the transaction was refused.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.serve.service import NodeService

_MAX_BODY = 1 << 20          # 1 MiB: no submit needs more
_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 413: "Payload Too Large",
                429: "Too Many Requests", 500: "Internal Server Error"}


def _overloaded(payload: Any) -> bool:
    return (isinstance(payload, dict)
            and (payload.get("error") == "overloaded"
                 or payload.get("reason") == "overloaded"))


class HttpNodeServer:
    """Serves one ``NodeService`` over HTTP (asyncio.start_server)."""

    def __init__(self, service: NodeService, host: Optional[str] = None,
                 port: Optional[int] = None):
        self.service = service
        self.host = host if host is not None else service.spec.host
        self.port = port if port is not None else service.spec.port
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> Tuple[str, int]:
        """Start service + listener; returns the bound (host, port)
        (pass ``port=0`` to bind an ephemeral port)."""
        await self.service.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]
        return self.host, self.port

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.service.close()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- one connection ---------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                method, path, headers, body = request
                status, payload = await self._route(method, path, body)
                keep = headers.get("connection", "keep-alive") != "close"
                await self._respond(writer, status, payload, keep)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        while True:
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            k, _, v = raw.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or "0")
        if n > _MAX_BODY:
            return method, path, headers, None
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    async def _route(self, method: str, path: str,
                     body: Optional[bytes]) -> Tuple[int, Any]:
        if body is None:
            return 413, {"error": "payload too large"}
        if method == "GET" and path == "/health":
            return 200, {"ok": True}
        if path != "/rpc":
            return 404, {"error": f"unknown path {path!r}"}
        if method != "POST":
            return 405, {"error": "POST /rpc only"}
        try:
            req = json.loads(body.decode("utf-8") or "{}")
            name = req["method"]
            params = req.get("params", {}) or {}
            if not isinstance(params, dict):
                raise TypeError("params must be an object")
        except (ValueError, KeyError, TypeError) as err:
            return 400, {"error": f"bad request: {err}"}
        try:
            result = await self._dispatch(name, params)
        except (TypeError, ValueError, KeyError) as err:
            return 400, {"id": req.get("id"),
                         "error": f"{type(err).__name__}: {err}"}
        status = 429 if _overloaded(result) else 200
        return status, {"id": req.get("id"), "result": result}

    async def _dispatch(self, name: str, p: Dict[str, Any]) -> Any:
        svc = self.service
        if name == "submit":
            return await svc.submit(p["fn"], p["sender"],
                                    fee=p.get("fee"), at=p.get("at"))
        if name == "receipt":
            return svc.receipt(int(p["ref"]))
        if name == "get_account":
            return svc.get_account(p["address"])
        if name == "state_root":
            return {"state_root": svc.state_root()}
        if name == "capabilities":
            return {"capabilities": svc.capabilities()}
        if name == "events":
            limit = p.get("limit")
            return svc.events(cursor=int(p.get("cursor", 0)),
                              kinds=p.get("kinds"),
                              limit=None if limit is None else int(limit))
        if name == "flush":
            return await svc.finalize()
        if name == "metrics":
            return svc.stats()
        raise ValueError(f"unknown method {name!r}")

    async def _respond(self, writer: asyncio.StreamWriter, status: int,
                       payload: Any, keep: bool) -> None:
        body = json.dumps(payload, default=str).encode("utf-8")
        head = (f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'OK')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                f"\r\n").encode("latin-1")
        writer.write(head + body)
        await writer.drain()


async def http_rpc(host: str, port: int, method: str,
                   params: Optional[Dict[str, Any]] = None,
                   req_id: int = 1) -> Tuple[int, Any]:
    """Minimal asyncio HTTP client for one RPC call — the tests and
    ``chip_smoke.py`` drive the real wire format with it.
    Returns ``(http_status, parsed_body)``."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps({"method": method, "params": params or {},
                           "id": req_id}).encode("utf-8")
        writer.write((f"POST /rpc HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Length: {len(body)}\r\n"
                      f"Connection: close\r\n\r\n").encode("latin-1")
                     + body)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass
    head, _, payload = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    return status, json.loads(payload.decode("utf-8"))
