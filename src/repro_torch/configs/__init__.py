"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Every architecture whose layers the port has: ``hybrid`` (hymba-1.5b),
``ssm`` (mamba2-1.3b), dense GQA (phi3-mini-3.8b; granite-34b with one kv
head; qwen1.5-110b with q/k/v biases), dense MLA (minicpm3-4b), the VLM
backbone with M-RoPE (qwen2-vl-7b), the audio encoder (hubert-xlarge),
the mixtures of experts (qwen3-moe-235b-a22b, top-8 of 128 experts;
llama4-maverick-400b-a17b, top-1 with a shared expert, dense and MoE
layers interleaved), and the paper's own NTMs (prodlda-synthetic,
ctm-s2orc).  Every id of the reference's registry is here.
:data:`ARCH_KIND_OF` keeps the kind of every id, so that a spec check
can refuse an unknown id or a modality kind with the reference's
wording.
"""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_KINDS, AUDIO, DECODE_32K, DENSE, HYBRID, INPUT_SHAPES, LONG_500K,
    MOE, NTM, PREFILL_32K, SSM, TRAIN_4K, VLM, FederatedConfig, ModelConfig,
    MoEConfig, RoundConfig, RunConfig, ShapeConfig, SSMConfig)
from repro_torch.configs.ctm_s2orc import CONFIG as _ctm
from repro_torch.configs.granite_34b import CONFIG as _granite
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.prodlda_synthetic import CONFIG as _prodlda
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen15
from repro_torch.configs.qwen2_vl_7b import CONFIG as _qwen2vl
from repro_torch.configs.qwen3_moe_235b import CONFIG as _qwen3moe

# The 10 assigned architectures (public-pool ids, exact).
ASSIGNED_ARCHS = {
    "granite-34b": _granite,
    "qwen2-vl-7b": _qwen2vl,
    "hubert-xlarge": _hubert,
    "hymba-1.5b": _hymba,
    "qwen1.5-110b": _qwen15,
    "phi3-mini-3.8b": _phi3,
    "llama4-maverick-400b-a17b": _llama4,
    "qwen3-moe-235b-a22b": _qwen3moe,
    "minicpm3-4b": _minicpm3,
    "mamba2-1.3b": _mamba2,
}

# The paper's own models, selectable through the same registry.
PAPER_ARCHS = {
    "prodlda-synthetic": _prodlda,
    "ctm-s2orc": _ctm,
}

ARCHS = {**ASSIGNED_ARCHS, **PAPER_ARCHS}

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

# the reference registry's ids still to port: none since the MoE slice
NOT_PORTED = tuple(a for a in ARCH_KIND_OF if a not in ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    if name not in INPUT_SHAPES:
        raise KeyError(
            f"unknown input shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Which of the four assigned shapes apply to this arch."""
    shapes = ["train_4k", "prefill_32k"]
    if cfg.encoder_only:
        return shapes          # no autoregressive decode for encoder-only
    shapes.append("decode_32k")
    # long_500k needs a sub-quadratic path: SSM/hybrid natively; dense/moe/vlm
    # only via the sliding-window variant (applied by the launcher).
    shapes.append("long_500k")
    return shapes
