"""`repro_torch.net`: the concurrent transport layer of the federation
service (port of ``repro.net``).

The wire counterpart of :mod:`repro_torch.serve`: a hand-written asyncio
HTTP/1.1 front end (:class:`repro_torch.net.server.NetServer`) puts the
buffered-async :class:`repro_torch.serve.FederationService` on real
sockets.  ``POST /v1/upload`` deltas funnel through ONE aggregation
worker (the FedBuff combine, kernel B2 on a CUDA device, stays
serialized) while ``POST /v1/infer`` / ``POST /v1/generate`` read the
atomic ``_live`` hot swap concurrently from a thread pool.  Payloads
cross in the versioned binary codec of :mod:`repro_torch.net.codec`,
byte for byte the reference's (fp32/bf16 delta arrays, strict decode
refusals recorded on the service's ledger as ``malformed`` /
``wire_version``).  :class:`repro_torch.net.client.ServiceClient` is the
``run_traffic``-compatible remote view (local updates on a replica, only
deltas on the wire), and ``launch/federate_load.py`` drives several of
them from separate processes.
"""
from repro_torch.net.codec import (WIRE_VERSION, WireError, WireFormatError,
                                   WireVersionError, decode_message,
                                   encode_message)
from repro_torch.net.client import HttpClient, NetError, ServiceClient
from repro_torch.net.server import BackgroundServer, NetServer, run_server

__all__ = ["WIRE_VERSION", "WireError", "WireFormatError",
           "WireVersionError", "decode_message", "encode_message",
           "HttpClient", "NetError", "ServiceClient",
           "BackgroundServer", "NetServer", "run_server"]
