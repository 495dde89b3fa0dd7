"""Engine-level configuration: the fields of the reference's
``configs/base.py`` that the port's paths read.

Same names and defaults as the reference dataclasses.  ``ModelConfig``
carries the LM fields of the reference (every kind of its zoo) beside
the ProdLDA/CTM ones (``contextual_dim``, ``ntm_dropout``);
``num_params()``, ``num_active_params()`` and ``reduced()`` are the
reference's.  The four assigned input shapes (``ShapeConfig``,
``INPUT_SHAPES``) and the launcher's ``RunConfig`` are the reference's
too.  The reference's lowering knobs ``scan_layers`` / ``unroll_chunks``
choose how XLA lowers its layer and chunk loops; the port's loops are
Python loops and its chunk loops live in the kernels, so it has no such
knob.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Tuple

# architecture kinds (the reference's constants)
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"
NTM = "ntm"  # the paper's own models (ProdLDA)

ARCH_KINDS = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO, NTM)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (``models/layers/moe.py``):
    ``num_experts`` routed experts, ``top_k`` of them a token, each with
    ``capacity_factor`` x its even share of a routing group's slots
    (``num_groups`` groups along the batch, halved until they divide
    it); ``router_aux_weight`` weighs the load-balance term in the loss;
    ``moe_every=2`` interleaves dense and MoE layers (llama4);
    ``num_shared_experts`` run on every token."""

    num_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_every: int = 1
    num_shared_experts: int = 0
    num_groups: int = 16


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) configuration."""

    state_dim: int = 128          # N — SSM state size per head
    head_dim: int = 64            # P — channels per SSD head
    expand: int = 2               # d_inner = expand * d_model
    chunk_size: int = 256         # SSD block length
    conv_width: int = 4           # depthwise causal conv width


@dataclass(frozen=True)
class ModelConfig:
    """One architecture (LM zoo) or the paper's ProdLDA."""

    name: str = "unnamed"
    kind: str = DENSE
    citation: str = ""

    # transformer backbone
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    activation: str = "swiglu"    # "swiglu" | "gelu"

    # MLA (multi-head latent attention)
    use_mla: bool = False
    mla_kv_lora_rank: int = 256
    mla_q_lora_rank: int = 768
    mla_rope_head_dim: int = 32
    mla_absorb: bool = False

    sliding_window: int = 0       # 0 = full causal attention

    # M-RoPE (qwen2-vl)
    use_mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # encoder-only (audio)
    encoder_only: bool = False
    frontend_embed_dim: int = 0

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hymba: attention and mamba branches run in parallel, mean-fused
    hybrid_attn: bool = False

    # NTM-specific (ProdLDA / CTM)
    num_topics: int = 50
    ntm_hidden: Tuple[int, ...] = (100, 100)
    ntm_dropout: float = 0.2
    contextual_dim: int = 0       # CombinedTM: SBERT embedding size (0 = ProdLDA)
    learn_priors: bool = True

    dtype: str = "bfloat16"       # activation dtype on the target hardware
    param_dtype: str = "float32"

    # recompute each layer in the backward from its input
    # (``torch.utils.checkpoint``), so the saved activations are one
    # (B,S,D) residual per layer instead of every intermediate
    remat_layers: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def num_params(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        if self.kind == NTM:
            v, k = self.vocab_size, self.num_topics
            h = list(self.ntm_hidden)
            n = 0
            dims = [v + self.contextual_dim] + h
            for a, b in zip(dims[:-1], dims[1:]):
                n += a * b + b
            n += 2 * (h[-1] * k + k)        # mu and logvar heads
            n += k * v                      # beta decoder
            return n
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        n = self.vocab_size * d                      # embed
        if not self.tie_embeddings and not self.encoder_only:
            n += self.vocab_size * d                 # lm head
        per_layer = 0
        if self.kind == SSM:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            per_layer = d * (2 * d_in + 2 * nheads * s.state_dim) \
                + d_in * s.conv_width + d_in * d + nheads + nheads
        else:
            if self.use_mla:
                qr, kr, rr = self.mla_q_lora_rank, self.mla_kv_lora_rank, \
                    self.mla_rope_head_dim
                per_layer += d * qr + qr * nq * (hd + rr)
                per_layer += d * (kr + rr) + kr * nq * (hd + hd)
                per_layer += nq * hd * d
            else:
                per_layer += d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
                if self.qkv_bias:
                    per_layer += nq * hd + 2 * nkv * hd
            if self.kind == HYBRID:
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                per_layer += d * (2 * d_in + 2 * nheads * s.state_dim) \
                    + d_in * s.conv_width + d_in * d + 2 * nheads
            if self.kind == MOE and self.moe.num_experts:
                e = self.moe.num_experts + self.moe.num_shared_experts
                per_layer += e * 3 * d * self.d_ff \
                    + d * self.moe.num_experts   # + router
            else:
                mult = 3 if self.activation == "swiglu" else 2
                per_layer += mult * d * self.d_ff
            per_layer += 2 * d  # norms
        n += self.num_layers * per_layer + d
        return n

    def num_active_params(self) -> int:
        """Parameters a token reads (the reference's formula: every layer
        of a MoE config counted as MoE, ``moe_every`` aside, as
        :meth:`num_params` counts it)."""
        if self.kind != MOE or not self.moe.num_experts:
            return self.num_params()
        inactive = self.num_layers * (self.moe.num_experts - self.moe.top_k) \
            * 3 * self.d_model * self.d_ff
        return self.num_params() - inactive

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family, tiny dimensions (the
        reference's rule, field for field)."""
        d = min(self.d_model, 256)
        nh = min(self.num_heads, 4)
        # preserve the GQA flavour: kv=1 stays 1, kv==heads stays equal
        if self.num_kv_heads == self.num_heads:
            nkv = nh
        elif self.num_kv_heads == 1:
            nkv = 1
        else:
            nkv = max(1, nh // 2)
        kw = dict(
            num_layers=2,
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=d // nh if nh else 0,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=min(self.max_seq_len, 512),
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
        )
        if self.kind == MOE:
            kw["moe"] = replace(self.moe, num_experts=4,
                                top_k=min(self.moe.top_k, 2))
        if self.kind in (SSM, HYBRID):
            kw["ssm"] = replace(self.ssm,
                                state_dim=min(self.ssm.state_dim, 16),
                                head_dim=32, chunk_size=64)
        if self.use_mla:
            kw["mla_kv_lora_rank"] = 32
            kw["mla_q_lora_rank"] = 48
            kw["mla_rope_head_dim"] = 16
        if self.use_mrope:
            hd = d // nh
            kw["mrope_sections"] = (hd // 2 - 2 * (hd // 8), hd // 8,
                                    hd // 8)
        if self.frontend_embed_dim:
            kw["frontend_embed_dim"] = d
        if self.kind == NTM:
            kw = dict(vocab_size=min(self.vocab_size, 512),
                      num_topics=min(self.num_topics, 10),
                      ntm_hidden=(32, 32),
                      contextual_dim=32 if self.contextual_dim else 0)
        return replace(self, **kw)


@dataclass(frozen=True)
class FederatedConfig:
    """gFedNTM protocol knobs (paper Alg. 1 + the message transforms)."""

    num_clients: int = 5
    learning_rate: float = 2e-3     # lambda in Eq. (3)
    max_rounds: int = 100           # I in Alg. 1
    # Sync-Opt syncs every minibatch (paper); local_steps > 1 is the
    # FedAvg-style local-steps variant (FedAvgTrainer)
    local_steps: int = 1
    secure_aggregation: bool = False    # pairwise-mask secure agg simulation
    compression_topk: float = 0.0       # 0 = dense; else fraction kept
    dp_noise_multiplier: float = 0.0    # local DP Gaussian noise
    dp_clip_norm: float = 1.0
    # wire format of client messages for the "precision" transform:
    # "" = fp32, "bf16" = rounded to bfloat16, accumulated in fp32
    message_precision: str = ""
    rel_tol: float = 1e-5               # stopping criterion on weight change


@dataclass(frozen=True)
class RoundConfig:
    """Scenario knobs of the engine (reference ``RoundConfig``): the
    execution path, participation, local epochs, the server optimizer,
    stragglers and the transform stage."""

    exec_mode: str = "loop"         # "vmap": the batched cohort path
    clients_per_round: int = 0      # K of L per round (0 = all L)
    sampling: str = "uniform"       # "uniform" | "weighted" | "deterministic"
    sampling_seed: int = 0
    local_epochs: int = 1
    server_optimizer: str = "fedavg"
    server_lr: float = 1.0
    server_momentum: float = 0.9    # FedAvgM beta / FedAdam b1
    server_beta2: float = 0.999     # FedAdam b2
    server_eps: float = 1e-3        # FedAdam tau
    straggler_prob: float = 0.0
    max_staleness: int = 0
    staleness_decay: float = 0.5
    transforms: Tuple[str, ...] = ()    # core/transforms.py registry names
    # fixed-K cohorts: shrunken cohorts padded with zero-weight rows
    pad_cohorts: bool = True
    local_epochs_by_client: Tuple[int, ...] = ()
    client_join_round: Tuple[int, ...] = ()
    client_leave_round: Tuple[int, ...] = ()
    # kept so specs round-trip; the tensor's device picks kernel or plain
    kernel_backend: str = "xla"
    # the ("data",) mesh width of the batched cohort path (the spec's
    # execution.mesh.data): 0 = unsharded; N >= 1 shards the stacked
    # (K, ...) cohort, the (L, ...) per-client state and the straggler
    # ring over N shards (parallel/sharding.py fed_mesh).  K and L must
    # divide by N.  Inert under loop mode
    mesh_data: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclass(frozen=True)
class RunConfig:
    """Launcher-level configuration."""

    arch: str = "phi3-mini-3.8b"
    shape: str = "train_4k"
    multi_pod: bool = False
    optimizer: str = "sgd"          # paper Eq. (3); "adam" available
    learning_rate: float = 2e-3
    remat: str = "none"             # "none" | "layer" | "full" | "dots"
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    checkpoint_dir: str = ""
    federated: FederatedConfig = field(default_factory=FederatedConfig)
    rounds: RoundConfig = field(default_factory=RoundConfig)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
