from repro_torch.configs.base import (NTM, FederatedConfig,  # noqa: F401
                                     ModelConfig, RoundConfig)
