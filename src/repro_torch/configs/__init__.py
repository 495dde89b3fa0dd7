"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Only the architectures whose layers the port has: ``hybrid``
(hymba-1.5b), ``ssm`` (mamba2-1.3b) and dense GQA without MoE, MLA or
M-RoPE (phi3-mini-3.8b).  The reference's other ids raise
``NotImplementedError`` naming ROADMAP.md A16 (the LM zoo).
"""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_KINDS, AUDIO, DENSE, HYBRID, MOE, NTM, SSM, VLM, FederatedConfig,
    ModelConfig, MoEConfig, RoundConfig, SSMConfig)
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3

ARCHS = {
    "hymba-1.5b": _hymba,
    "mamba2-1.3b": _mamba2,
    "phi3-mini-3.8b": _phi3,
}

# the reference registry's other ids, still to port
NOT_PORTED = ("granite-34b", "qwen2-vl-7b", "hubert-xlarge", "qwen1.5-110b",
              "llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b",
              "minicpm3-4b", "prodlda-synthetic", "ctm-s2orc")


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not in the port yet (ROADMAP.md A16); "
            f"ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
