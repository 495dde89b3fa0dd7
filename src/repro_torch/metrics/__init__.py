from repro_torch.metrics.coherence import npmi_coherence  # noqa: F401
from repro_torch.metrics.similarity import tss  # noqa: F401
