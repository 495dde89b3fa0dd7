from repro_torch.metrics.coherence import (  # noqa: F401
    npmi_coherence, topic_diversity)
from repro_torch.metrics.similarity import (  # noqa: F401
    dss, hellinger_affinity, tss, tss_baseline)
from repro_torch.metrics.wmd import amwmd, topic_descriptions, wmd  # noqa: F401
