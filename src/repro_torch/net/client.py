"""Socket client for the federation wire.

Port of ``repro/net/client.py``.  Two layers:

* :class:`HttpClient`: a minimal blocking HTTP/1.1 connection with
  keep-alive, one reconnect, and the service's retry and backoff
  schedule (``backoff_s * 2**attempt``, as ``FederationService.upload``)
  for transient socket failures.
* :class:`ServiceClient`: the ``run_traffic``-compatible remote view of
  a :class:`FederationService`.  Local compute, remote aggregate: the
  client holds its own replica (``Federation.from_spec`` on
  ``sync_twin_spec(spec)``, on ``device``) and runs the engine's local
  update and its transform stage (one ``(1, D)`` B3 or B4 call per upload
  with ``dp`` or ``topk``) against the parameters fetched by ``GET
  /v1/model``, with the service's seed schedule (``round_seed = seed *
  100003 + t``, ``t`` the client's upload counter), so a wire replay of
  a ``run_traffic`` schedule reproduces the in-process run.  Only the
  delta crosses the wire, in the reference's tree form, encoded by
  :mod:`repro_torch.net.codec` at the spec's ``serving.wire_precision``.
"""
from __future__ import annotations

import json
import socket
import time
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api.federation import Federation
from repro_torch.api.spec import FederationSpec
from repro_torch.net.codec import (decode_message, encode_message,
                                   params_from_wire, params_to_wire)
from repro_torch.serve.service import sync_twin_spec

_JSON = "application/json"
_BINARY = "application/x-repro-wire"


class NetError(RuntimeError):
    """Transport failure that survived the retry budget."""


class HttpClient:
    """One keep-alive HTTP/1.1 connection (blocking sockets).

    ``request`` reconnects once on a dead reused connection (the server
    may have closed an idle socket); ``request_with_retry`` adds the
    exponential-backoff schedule on top for connect-refused windows
    (server still booting) and transient failures.
    """

    def __init__(self, host: str, port: int, *, timeout: float = 120.0):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self._sock: Optional[socket.socket] = None

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _connect(self) -> socket.socket:
        return socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)

    def request(self, method: str, path: str, body: bytes = b"", *,
                content_type: str = _JSON) -> Tuple[int, bytes]:
        head = (f"{method} {path} HTTP/1.1\r\n"
                f"Host: {self.host}:{self.port}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: keep-alive\r\n\r\n").encode("latin-1")
        reused = self._sock is not None
        for attempt in ("reuse", "fresh"):
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._sock.sendall(head + body)
                return self._read_response(self._sock)
            except (OSError, EOFError):
                self.close()
                # a dead REUSED socket is the keep-alive race, not a
                # server failure: retry once on a fresh connection; a
                # fresh connection failing is the caller's problem
                if attempt == "fresh" or not reused:
                    raise
        raise AssertionError("unreachable")

    def _read_response(self, sock: socket.socket) -> Tuple[int, bytes]:
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise EOFError("connection closed mid-response")
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ")[1])
        length = 0
        keep = True
        for ln in lines[1:]:
            key, _, val = ln.partition(":")
            key = key.strip().lower()
            if key == "content-length":
                length = int(val.strip())
            elif key == "connection":
                keep = val.strip().lower() != "close"
        chunks = [rest]
        got = len(rest)
        while got < length:
            chunk = sock.recv(min(1 << 20, length - got))
            if not chunk:
                raise EOFError("connection closed mid-body")
            chunks.append(chunk)
            got += len(chunk)
        if not keep:
            self.close()
        return status, b"".join(chunks)[:length]

    def request_with_retry(self, method: str, path: str, body: bytes = b"",
                           *, content_type: str = _JSON,
                           max_retries: int = 5, backoff_s: float = 0.05,
                           sleep_fn=None) -> Tuple[int, bytes]:
        sleep = sleep_fn if sleep_fn is not None else time.sleep
        attempt = 0
        while True:
            try:
                return self.request(method, path, body,
                                    content_type=content_type)
            except (OSError, EOFError) as e:
                attempt += 1
                if attempt > max_retries:
                    raise NetError(
                        f"{method} {path} failed after {attempt} "
                        f"attempts: {e}") from e
                sleep(backoff_s * (2 ** (attempt - 1)))


class ServiceClient:
    """Remote :class:`FederationService` with the ``run_traffic`` surface
    (module docstring), its replica on ``device`` (default ``cuda``;
    raises on a host without one).  One instance may drive any subset of
    the federation's client ids; the per-client upload counters live
    here, so processes that share the population must hold DISJOINT id
    sets."""

    def __init__(self, spec: Union[FederationSpec, Mapping, str],
                 host: str, port: int, *, corpus=None, device=None,
                 wire_precision: Optional[str] = None,
                 timeout: float = 120.0, max_retries: int = 5,
                 backoff_s: float = 0.05, sleep_fn=None):
        if isinstance(spec, str):
            from repro_torch.api.registry import scenario_spec
            spec = scenario_spec(spec)
        elif isinstance(spec, Mapping):
            spec = FederationSpec.from_dict(spec)
        spec.validate()
        if spec.schedule.mode != "buffered_async":
            raise ValueError(
                "ServiceClient talks to the buffered-async service; the "
                "spec must have schedule.mode='buffered_async' "
                "(docs/serving.md)")
        self.spec = spec
        self.wire_precision = wire_precision if wire_precision is not None \
            else (spec.serving.wire_precision
                  if spec.serving is not None else "fp32")
        # the local replica: the service's own construction path, so a
        # local update is the service's math over wire-fetched params
        self._fed = Federation.from_spec(sync_twin_spec(spec),
                                         corpus=corpus, device=device)
        self.client_rounds = [0] * spec.data.num_clients
        self.http = HttpClient(host, port, timeout=timeout)
        self._retry = {"max_retries": int(max_retries),
                       "backoff_s": float(backoff_s), "sleep_fn": sleep_fn}

    @property
    def device(self) -> torch.device:
        return self._fed.device

    def close(self) -> None:
        self.http.close()

    # -- raw wire ----------------------------------------------------------
    def _json_call(self, method: str, path: str,
                   payload: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        body = b"" if payload is None else json.dumps(payload).encode()
        status, resp = self.http.request_with_retry(
            method, path, body, **self._retry)
        try:
            out = json.loads(resp.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise NetError(f"{path} answered non-JSON ({status}): "
                           f"{resp[:200]!r}") from e
        if status != 200:
            raise NetError(f"{path} answered {status}: "
                           f"{out.get('error', out)}")
        return out

    # -- the train surface -------------------------------------------------
    def fetch_model(self):
        """``(version, params)`` from ``GET /v1/model``, the params in the
        engine's form on the replica's device: the remote analogue of the
        service's atomic-swap dereference."""
        status, resp = self.http.request_with_retry(
            "GET", "/v1/model", **self._retry)
        if status != 200:
            raise NetError(f"/v1/model answered {status}")
        msg = decode_message(resp)
        if msg["kind"] != "model":
            raise NetError(f"expected a model frame, got {msg['kind']!r}")
        params = params_from_wire(msg["tree"], self._fed.engine.params)
        return int(msg["meta"]["version"]), params

    def client_update(self, client: int):
        """One local update against the CURRENT remote model, then the
        engine's transform stage: the mirror of
        ``FederationService.client_update`` (same stages, same
        per-client seed schedule).  Returns ``(base_version, delta,
        weight)``."""
        L = self.spec.data.num_clients
        if not 0 <= int(client) < L:
            raise ValueError(f"unknown client {client!r}; this federation "
                             f"registers clients 0..{L - 1}")
        version, params = self.fetch_model()
        eng = self._fed.engine
        eng.params = params
        t = self.client_rounds[client]
        round_seed = self.spec.execution.seed * 100003 + t
        msg, n, _loss = eng._local_message(int(client), round_seed)
        msg = eng.transform_message(int(client), msg, n, round_seed)
        self.client_rounds[client] = t + 1
        return version, msg, float(n)

    def encode_upload(self, client: int, delta, weight: float, *,
                      base_version: int) -> bytes:
        """The upload frame of one engine-form delta."""
        return encode_message(
            "upload",
            {"client": int(client), "base_version": int(base_version),
             "weight": float(weight)},
            tree=params_to_wire(self._fed.engine, delta),
            precision=self.wire_precision)

    def submit(self, client: int, delta, weight: float, *,
               base_version: int) -> Dict[str, Any]:
        """Encode and POST one delta; returns the service's receipt
        (rejections come back as 400s WITH a receipt, the in-process
        ``submit``'s contract)."""
        frame = self.encode_upload(client, delta, weight,
                                   base_version=base_version)
        status, resp = self.http.request_with_retry(
            "POST", "/v1/upload", frame, content_type=_BINARY,
            **self._retry)
        try:
            receipt = json.loads(resp.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise NetError(f"/v1/upload answered non-JSON ({status}): "
                           f"{resp[:200]!r}") from e
        if status not in (200, 400) or "accepted" not in receipt:
            raise NetError(f"/v1/upload answered {status}: {receipt}")
        return receipt

    def upload(self, client: int) -> Dict[str, Any]:
        """``client_update`` + ``submit`` (the one-call convenience the
        load driver times end to end)."""
        base_version, delta, weight = self.client_update(client)
        return self.submit(client, delta, weight,
                           base_version=base_version)

    # -- the serve surface -------------------------------------------------
    def infer(self, bow, contextual=None) -> torch.Tensor:
        """``theta (B, K)`` from the live remote model, on the replica's
        device (the service's ``infer`` answers on its own)."""
        payload: Dict[str, Any] = {
            "bow": np.asarray(bow, np.float32).tolist()}
        if contextual is not None:
            payload["contextual"] = \
                np.asarray(contextual, np.float32).tolist()
        out = self._json_call("POST", "/v1/infer", payload)
        return torch.tensor(out["theta"], dtype=torch.float32,
                            device=self.device)

    def generate(self, prompts, max_new: int = 16) -> np.ndarray:
        out = self._json_call(
            "POST", "/v1/generate",
            {"prompts": np.asarray(prompts, np.int32).tolist(),
             "max_new": int(max_new)})
        return np.asarray(out["tokens"], np.int32)

    def status(self) -> Dict[str, Any]:
        return self._json_call("GET", "/v1/status")

    def shutdown(self, *, drain: bool = True) -> Dict[str, Any]:
        return self._json_call(
            "POST", f"/v1/shutdown?drain={'true' if drain else 'false'}")

    # -- run_traffic's read surface ----------------------------------------
    @property
    def version(self) -> int:
        return int(self.status()["version"])

    @property
    def agg_index(self) -> int:
        return int(self.status()["aggregations"])

    @property
    def draining(self) -> bool:
        return bool(self.status()["draining"])

    @property
    def history(self):
        return self.status()["history"]

    @property
    def rejection_counts(self) -> Dict[str, int]:
        return dict(self.status()["rejections"])
