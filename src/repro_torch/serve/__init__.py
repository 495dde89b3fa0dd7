"""Buffered-async federation service (port of ``repro.serve``)."""
from repro_torch.serve.buffer import DeltaBuffer  # noqa: F401
from repro_torch.serve.service import (REJECT_REASONS,  # noqa: F401
                                       FederationService, UploadTimeout,
                                       sync_twin_spec)
from repro_torch.serve.traffic import run_traffic  # noqa: F401
