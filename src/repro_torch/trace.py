"""The port's spans and its host-read counter: the only tracing code.

:func:`span` names a phase of the federated round on the profiler's
timeline.  While a ``torch.profiler`` records, it is
``torch.profiler.record_function(name)``, so the span lands on Kineto's
clock beside the device's operations; otherwise it is one shared no-op
context, and an untraced round pays one flag check a span.  Backward
kernels are launched by the autograd engine's device thread while the
caller waits inside :data:`GRAD`, so a reader gives a device operation
to the span around its launch on the host, on any thread.

:func:`host_read` is the one place where the engine brings a device
tensor to the host; :data:`host_reads` counts its calls, as the kernel
modules count their launches.

The names in :data:`SPANS` are frozen: the benchmark keeps its own copy.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.autograd import profiler as _profiler

ROUND = "repro_torch.round"              # FederationEngine.round
BATCHES = "repro_torch.batches"          # the cohort's draws and gathers
GRAD = "repro_torch.grad"                # a client's (or cohort's) gradient
FORWARD = "repro_torch.forward"          # the objective inside GRAD
UPDATE = "repro_torch.update"            # local SGD step and message build
TRANSFORMS = "repro_torch.transforms"    # the transform stage (B3, B4)
COMBINE = "repro_torch.combine"          # Eq. (2) (B2)
SERVER_STEP = "repro_torch.server_step"  # server optimizer, relative change
HOST_READ = "repro_torch.host_read"      # a blocking device -> host read
SPANS = (ROUND, BATCHES, GRAD, FORWARD, UPDATE, TRANSFORMS, COMBINE,
         SERVER_STEP, HOST_READ)

# calls of host_read in this process
host_reads = 0

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else the one
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str, fn):
    """``fn`` with each call inside :func:`span` ``(name)``."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


def host_read(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as a numpy array, counted in :data:`host_reads`
    and inside the :data:`HOST_READ` span."""
    global host_reads
    with span(HOST_READ):
        host_reads += 1
        return t.detach().cpu().numpy()
