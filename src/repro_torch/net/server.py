"""Asyncio HTTP/1.1 front end of :class:`repro_torch.serve.FederationService`.

Port of ``repro/net/server.py``: hand-written HTTP over
``asyncio.start_server``, stdlib only.  Concurrency model:

* **one aggregation worker.**  Every request that changes state (``POST
  /v1/upload``, ``/v1/shutdown``, ``GET /v1/status``) goes on a single
  ``asyncio.Queue`` and runs on a one-thread executor, so the FedBuff
  combine (kernel B2 on a CUDA device) and every ledger and buffer
  mutation stay serialized however many sockets upload.
* **concurrent readers.**  ``POST /v1/infer``, ``POST /v1/generate`` and
  ``GET /v1/model`` run on a reader thread pool with no synchronization
  against aggregation: each takes the service's atomic ``_live =
  (version, params)`` once and keeps that reference, so a rebind by the
  aggregation thread cannot free the parameters a queued kernel still
  reads.  Every thread launches on the default stream; the device runs
  their work in the order it was enqueued.

Endpoints (wire formats in :mod:`repro_torch.net.codec`):

    POST /v1/upload      codec frame kind="upload" -> receipt JSON
    GET  /v1/model       codec frame kind="model" (version + fp32 params)
    POST /v1/infer       JSON {"bow", ["contextual"]} -> {"theta", ...}
    POST /v1/generate    JSON {"prompts", ["max_new"]} -> {"tokens", ...}
    GET  /v1/status      counters + rejection totals JSON
    POST /v1/shutdown?drain=true|false   drain summary JSON, then stop

Parameters cross the wire in the reference's tree form (its nested dicts
and lists, keys sorted, host arrays), so either package's client talks
to either package's server.  Decode refusals never kill the connection:
a frame that does not parse is recorded on the service's rejection
ledger (``malformed`` / ``wire_version``) and answered with a 400
receipt.
"""
from __future__ import annotations

import asyncio
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.net.codec import (WireFormatError, WireVersionError,
                                   decode_message, encode_message,
                                   params_from_wire, params_to_wire)

MAX_BODY_BYTES = 1 << 28        # one upload frame
_JSON = "application/json"
_BINARY = "application/x-repro-wire"
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 503: "Service Unavailable"}


class _BadRequest(Exception):
    """Malformed HTTP framing (not a codec refusal): answered 400."""


def _json_bytes(obj: Any) -> bytes:
    return json.dumps(obj).encode("utf-8")


class NetServer:
    """The wire front end of one :class:`FederationService`.

    Async lifecycle: ``await start()`` binds (``port=0`` = ephemeral,
    the bound port lands back on :attr:`port`), ``await
    serve_forever()`` runs until ``/v1/shutdown`` or :meth:`stop`.
    Tests and the load driver use :class:`BackgroundServer` /
    :func:`run_server` instead of driving the loop by hand.
    """

    def __init__(self, service, *, host: Optional[str] = None,
                 port: Optional[int] = None,
                 wire_precision: Optional[str] = None,
                 reader_threads: int = 4):
        serving = service.spec.serving
        self.service = service
        self.host = host if host is not None else \
            (serving.host if serving is not None else "127.0.0.1")
        self.port = port if port is not None else \
            (serving.port if serving is not None else 0)
        # advertised in /v1/status so clients can discover the expected
        # delta payload format; the decoder accepts either regardless
        self.wire_precision = wire_precision if wire_precision is not None \
            else (serving.wire_precision if serving is not None else "fp32")
        self._read_pool = ThreadPoolExecutor(
            max_workers=max(1, int(reader_threads)),
            thread_name_prefix="net-read")
        self._agg_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="net-agg")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._agg_queue: Optional[asyncio.Queue] = None
        self._worker: Optional[asyncio.Task] = None
        self._stop_event: Optional[asyncio.Event] = None

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._agg_queue = asyncio.Queue()
        self._stop_event = asyncio.Event()
        self._worker = self._loop.create_task(self._agg_worker())
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        """Serve until shutdown, then drain the aggregation queue."""
        if self._server is None:
            raise RuntimeError("call start() first")
        await self._stop_event.wait()
        self._server.close()
        await self._server.wait_closed()
        # the poison pill goes in AFTER the listener closes: every
        # enqueued request still gets its answer before the worker exits
        await self._agg_queue.put((None, None))
        await self._worker
        self._agg_pool.shutdown(wait=True)
        self._read_pool.shutdown(wait=True)

    def stop(self) -> None:
        """Thread-safe stop (the non-wire path to shutdown); a no-op if
        a wire-side ``/v1/shutdown`` already tore the loop down."""
        if self._loop is not None and self._stop_event is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop_event.set)
            except RuntimeError:
                pass                    # loop already closed

    # -- the single aggregation worker -------------------------------------
    async def _agg_worker(self) -> None:
        while True:
            fn, fut = await self._agg_queue.get()
            if fn is None:
                return
            try:
                result = await self._loop.run_in_executor(self._agg_pool, fn)
            except Exception as e:      # answered per request, not fatal
                if not fut.cancelled():
                    fut.set_exception(e)
            else:
                if not fut.cancelled():
                    fut.set_result(result)

    async def _via_agg(self, fn):
        """Run ``fn`` on the (single) aggregation thread, in queue order."""
        fut = self._loop.create_future()
        await self._agg_queue.put((fn, fut))
        return await fut

    # -- HTTP framing ------------------------------------------------------
    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, path, query, body, keep = req
                status, ctype, payload = await self._dispatch(
                    method, path, query, body)
                await self._respond(writer, status, ctype, payload, keep)
                if not keep or self._stop_event.is_set():
                    break
        except _BadRequest as e:
            try:
                await self._respond(writer, 400, _JSON,
                                    _json_bytes({"error": str(e)}), False)
            except (ConnectionError, OSError):
                pass
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionError, OSError, asyncio.TimeoutError):
            pass                        # peer went away mid-request
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None             # clean close between requests
            raise _BadRequest("truncated request head") from None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise _BadRequest(f"malformed request line {lines[0]!r}")
        method, target, proto = parts
        path, _, query = target.partition("?")
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if not ln:
                continue
            key, sep, val = ln.partition(":")
            if not sep:
                raise _BadRequest(f"malformed header line {ln!r}")
            headers[key.strip().lower()] = val.strip()
        length_s = headers.get("content-length", "0")
        if not length_s.isdigit():
            raise _BadRequest(f"bad Content-Length {length_s!r}")
        length = int(length_s)
        if length > MAX_BODY_BYTES:
            raise _BadRequest(f"body of {length} bytes exceeds the "
                              f"{MAX_BODY_BYTES}-byte cap")
        body = await reader.readexactly(length) if length else b""
        default_conn = "keep-alive" if proto == "HTTP/1.1" else "close"
        keep = headers.get("connection", default_conn).lower() != "close"
        return method, path, query, body, keep

    async def _respond(self, writer: asyncio.StreamWriter, status: int,
                       ctype: str, payload: bytes, keep: bool) -> None:
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                "\r\n").encode("latin-1")
        writer.write(head + payload)
        await writer.drain()

    # -- routing -----------------------------------------------------------
    async def _dispatch(self, method: str, path: str, query: str,
                        body: bytes) -> Tuple[int, str, bytes]:
        routes = {"/v1/upload": ("POST", self._route_upload),
                  "/v1/model": ("GET", self._route_model),
                  "/v1/infer": ("POST", self._route_infer),
                  "/v1/generate": ("POST", self._route_generate),
                  "/v1/status": ("GET", self._route_status),
                  "/v1/shutdown": ("POST", self._route_shutdown)}
        if path not in routes:
            return 404, _JSON, _json_bytes(
                {"error": f"unknown endpoint {path!r}"})
        want, handler = routes[path]
        if method != want:
            return 405, _JSON, _json_bytes(
                {"error": f"{path} speaks {want}, got {method}"})
        try:
            return await handler(query, body)
        except ValueError as e:
            # service-level refusals (LM vs NTM surface, bad JSON shape,
            # a delta tree that is not the parameters')
            return 400, _JSON, _json_bytes({"error": str(e)})

    async def _route_upload(self, query: str, body: bytes):
        svc = self.service
        try:
            msg = await self._loop.run_in_executor(
                self._read_pool, decode_message, body)
            if msg["kind"] != "upload":
                raise WireFormatError(
                    f"expected an upload frame, got kind={msg['kind']!r}")
            meta = msg["meta"]
            client = meta.get("client")
            base_version = meta.get("base_version")
            weight = meta.get("weight")
            if not isinstance(client, int) or isinstance(client, bool):
                raise WireFormatError(f"meta.client {client!r} is not an int")
            if not isinstance(base_version, int) \
                    or isinstance(base_version, bool):
                raise WireFormatError(
                    f"meta.base_version {base_version!r} is not an int")
            if not isinstance(weight, (int, float)) \
                    or isinstance(weight, bool):
                raise WireFormatError(
                    f"meta.weight {weight!r} is not a number")
            tree = msg["tree"]
            if tree is None:
                raise WireFormatError("upload frame carries no delta tree")
        except WireVersionError as e:
            receipt = await self._via_agg(
                lambda: svc.record_rejection(-1, -1, "wire_version"))
            receipt["error"] = str(e)
            return 400, _JSON, _json_bytes(receipt)
        except WireFormatError as e:
            receipt = await self._via_agg(
                lambda: svc.record_rejection(-1, -1, "malformed"))
            receipt["error"] = str(e)
            return 400, _JSON, _json_bytes(receipt)

        receipt = await self._via_agg(lambda: svc.submit(
            client, _WireDelta(tree, svc.fetch_model()[1]), float(weight),
            base_version=base_version))
        status = 200 if receipt["accepted"] else 400
        return status, _JSON, _json_bytes(receipt)

    async def _route_model(self, query: str, body: bytes):
        def snapshot() -> bytes:
            # ONE dereference of the atomic swap: version and params are
            # the same published pair.  Always fp32: wire_precision
            # quantizes uploads, never the model clients train against
            version, params = self.service.fetch_model()
            host = params_to_wire(self.service._fed.engine, params)
            return encode_message("model", {"version": int(version)},
                                  tree=host, precision="fp32")
        payload = await self._loop.run_in_executor(self._read_pool, snapshot)
        return 200, _BINARY, payload

    async def _route_infer(self, query: str, body: bytes):
        req = _load_json(body)
        if "bow" not in req:
            raise ValueError("infer request needs a 'bow' field")
        contextual = req.get("contextual")

        def run():
            version = self.service.fetch_model()[0]
            theta = self.service.infer(
                np.asarray(req["bow"], np.float32),
                contextual=None if contextual is None
                else np.asarray(contextual, np.float32))
            return version, theta.cpu().numpy()
        version, theta = await self._loop.run_in_executor(
            self._read_pool, run)
        return 200, _JSON, _json_bytes(
            {"version": int(version), "theta": theta.tolist()})

    async def _route_generate(self, query: str, body: bytes):
        req = _load_json(body)
        if "prompts" not in req:
            raise ValueError("generate request needs a 'prompts' field")
        max_new = req.get("max_new", 16)
        if not isinstance(max_new, int) or isinstance(max_new, bool) \
                or max_new < 1:
            raise ValueError(f"max_new must be a positive int, got "
                             f"{max_new!r}")

        def run():
            version = self.service.fetch_model()[0]
            tokens = self.service.generate(
                np.asarray(req["prompts"], np.int32), max_new=max_new)
            return version, np.asarray(tokens)
        version, tokens = await self._loop.run_in_executor(
            self._read_pool, run)
        return 200, _JSON, _json_bytes(
            {"version": int(version), "tokens": tokens.tolist()})

    async def _route_status(self, query: str, body: bytes):
        # through the aggregation queue: the ledger/history snapshot is
        # taken between aggregations, never during one
        status = await self._via_agg(self.service.status)
        status["wire_precision"] = self.wire_precision
        return 200, _JSON, _json_bytes(status)

    async def _route_shutdown(self, query: str, body: bytes):
        drain = _parse_drain(query)
        summary = await self._via_agg(
            lambda: self.service.shutdown(drain=drain))
        self._stop_event.set()
        return 200, _JSON, _json_bytes(summary)


class _WireDelta(Mapping):
    """A decoded delta tree that becomes the engine's form on the
    service's device (against ``like``, the parameters live when the
    aggregation thread takes the upload) when the buffer first reads it:
    inside ``submit``, after its checks, where the reference's buffer
    insert converts the tree and refuses a bad one.  The whole tree
    converts at once, so a refusal leaves every slot as it was."""

    def __init__(self, tree: Any, like: Mapping[str, Any]):
        self._tree, self._like = tree, like
        self._flat: Optional[Dict[str, Any]] = None

    def __getitem__(self, name: str):
        if self._flat is None:
            self._flat = params_from_wire(self._tree, self._like)
        return self._flat[name]

    def __iter__(self):
        return iter(self._like)

    def __len__(self) -> int:
        return len(self._like)


def _load_json(body: bytes) -> Dict[str, Any]:
    try:
        req = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"request body is not JSON: {e}") from None
    if not isinstance(req, dict):
        raise ValueError("request body must be a JSON object")
    return req


def _parse_drain(query: str) -> bool:
    """``drain=true|false`` (default true); anything else is refused."""
    if not query:
        return True
    for part in query.split("&"):
        key, sep, val = part.partition("=")
        if key != "drain" or not sep or val not in ("true", "false"):
            raise ValueError(
                f"shutdown accepts ?drain=true|false, got {query!r}")
        return val == "true"
    return True


class BackgroundServer:
    """A :class:`NetServer` on its own event loop in a daemon thread, the
    in-process way to put a service on a real socket (tests, the card's
    smoke run).  A context manager: ``with BackgroundServer(svc) as bg:
    ... bg.port ...``."""

    def __init__(self, service, **kwargs):
        self.server = NetServer(service, **kwargs)
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="net-server")

    def _run(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        try:
            await self.server.start()
        except BaseException as e:      # bind failures surface in start()
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        await self.server.serve_forever()

    def start(self) -> "BackgroundServer":
        self._thread.start()
        if not self._ready.wait(timeout=60):
            raise RuntimeError("NetServer did not come up within 60s")
        if self._error is not None:
            raise self._error
        return self

    @property
    def host(self) -> str:
        return self.server.host

    @property
    def port(self) -> int:
        return self.server.port

    def stop(self, timeout: float = 30) -> None:
        self.server.stop()
        self._thread.join(timeout)

    def __enter__(self) -> "BackgroundServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def run_server(service, *, host: Optional[str] = None,
               port: Optional[int] = None,
               wire_precision: Optional[str] = None,
               on_bound=None) -> None:
    """Blocking entry point (the load driver's server process): serve
    until a ``/v1/shutdown`` arrives.  ``on_bound(host, port)`` fires
    once the ephemeral port is known."""
    async def main():
        server = NetServer(service, host=host, port=port,
                           wire_precision=wire_precision)
        await server.start()
        if on_bound is not None:
            on_bound(server.host, server.port)
        await server.serve_forever()
    asyncio.run(main())
