from repro_torch.metrics.coherence import npmi_coherence  # noqa: F401
from repro_torch.metrics.similarity import (  # noqa: F401
    dss, hellinger_affinity, tss, tss_baseline)
