"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Only the architectures whose layers the port has: ``hybrid``
(hymba-1.5b), ``ssm`` (mamba2-1.3b) and dense GQA without MoE, MLA or
M-RoPE (phi3-mini-3.8b).  :data:`ARCH_KIND_OF` keeps the kind of every
id of the reference's registry, so that a spec check can refuse an
unknown id or a modality kind with the reference's wording; the ids not
ported yet raise ``NotImplementedError`` naming ROADMAP.md A16b (the
rest of the LM zoo).
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

# every id of the reference's registry and its kind (the reference's
# ``configs/*.py``), the ported ones included
ARCH_KIND_OF = {
    "granite-34b": DENSE,
    "qwen2-vl-7b": VLM,
    "hubert-xlarge": AUDIO,
    "hymba-1.5b": HYBRID,
    "qwen1.5-110b": DENSE,
    "phi3-mini-3.8b": DENSE,
    "llama4-maverick-400b-a17b": MOE,
    "qwen3-moe-235b-a22b": MOE,
    "minicpm3-4b": DENSE,
    "mamba2-1.3b": SSM,
    "prodlda-synthetic": NTM,
    "ctm-s2orc": NTM,
}

# the reference registry's other ids, still to port
NOT_PORTED = tuple(a for a in ARCH_KIND_OF if a not in ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not in the port yet (ROADMAP.md A16b); "
            f"ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
