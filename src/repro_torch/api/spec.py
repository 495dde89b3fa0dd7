"""`FederationSpec` — the declarative, serializable scenario tree.

Port of ``repro/api/spec.py`` with the same sections, field names,
defaults, validation messages and dict form, so a spec this slice
accepts round-trips to the identical dict in both packages:

    FederationSpec
      ├── model        ProdLDA or a registry LM (family, vocab, arch ...)
      ├── data         synthetic federation + partition sub-spec
      ├── schedule     rounds, participation, staleness, buffered-async
      ├── transforms   message transform stage
      ├── server_opt   server-side update rule on the combined delta
      ├── execution    exec mode, batch, client lr, seeds
      └── serving      optional wire front-end

Specs validate at construction, with the reference's messages.  What
the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP.md item: stragglers on the batched cohort path (the fused ring,
A10), a mesh (A17), an LM arch whose layers the port lacks (A16b) and
the ``serving`` section (A14).  The NTM's ``execution.stochastic_loss``
(the train-mode ELBO) runs.  Synchronous rounds of both families run
under both exec modes, and under ``exec_mode="loop"`` with stragglers
(the host pending list); the message transforms run under both exec
modes and in the buffered-async service; every partitioner of the
reference's registry runs.
``execution.kernel_backend`` is kept so dicts round-trip; it selects
nothing in the port, where the tensor's device picks kernel or plain.
Specs serialize to JSON files (:meth:`FederationSpec.save` /
:meth:`FederationSpec.load`), and :func:`parse_int_tuple` is the CLI's
strict int-list parser.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs import ARCH_KIND_OF, get_config
from repro_torch.configs.base import (AUDIO, NTM, VLM, FederatedConfig,
                                      ModelConfig, RoundConfig)
from repro_torch.core.aggregation import SERVER_OPTIMIZERS
from repro_torch.core.engine import EXEC_MODES, KERNEL_BACKENDS, \
    SAMPLING_MODES
from repro_torch.data.federated_split import parse_partition_spec

SPEC_VERSION = 1
SCHEDULE_MODES = ("sync", "buffered_async")
STALENESS_POLICIES = ("exponential", "polynomial")
# the reference's transform registry names (core/transforms.py)
TRANSFORM_NAMES = ("dp", "topk", "secure", "precision")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"invalid FederationSpec: {msg}")


def _not_ported(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item}); "
        "run it on the JAX reference package")


def _check_int(v, where: str, minimum: int, *,
               allow_none: bool = False) -> None:
    if v is None and allow_none:
        return
    _require(isinstance(v, int) and not isinstance(v, bool),
             f"{where} must be an int, got {v!r}")
    _require(v >= minimum, f"{where} must be >= {minimum}, got {v}")


def _check_float(v, where: str, minimum: Optional[float] = None,
                 maximum: Optional[float] = None, *,
                 exclusive_min: bool = False) -> None:
    _require(isinstance(v, (int, float)) and not isinstance(v, bool),
             f"{where} must be a number, got {v!r}")
    if minimum is not None:
        if exclusive_min:
            _require(v > minimum, f"{where} must be > {minimum}, got {v}")
        else:
            _require(v >= minimum,
                     f"{where} must be >= {minimum}, got {v}")
    if maximum is not None:
        _require(v <= maximum, f"{where} must be <= {maximum}, got {v}")


def _check_bool(v, where: str) -> None:
    _require(isinstance(v, bool), f"{where} must be true/false, got "
                                  f"{v!r}")


def _check_int_tuple(v, where: str, minimum: int = 0) -> None:
    _require(isinstance(v, tuple),
             f"{where} must be a tuple/list of ints, got "
             f"{type(v).__name__}")
    for i, x in enumerate(v):
        _require(isinstance(x, int) and not isinstance(x, bool),
                 f"{where}[{i}] must be an int, got {x!r}")
        _require(x >= minimum,
                 f"{where}[{i}] must be >= {minimum}, got {x}")


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelSpec:
    """``model`` section: what the federation trains.

    ``family="ntm"`` (default) is the paper's ProdLDA, sized by
    ``vocab``/``topics``/``hidden``; the LM-only fields stay at their
    zero defaults.  ``family="lm"`` is a language model of the
    architecture registry (``repro_torch.configs``) over the arch's
    ``reduced()`` config: ``arch`` picks it (a token-causal kind:
    dense/moe/ssm/hybrid), ``layers``/``width``/``seq_len`` override the
    reduced sizing (``0`` keeps it), and ``topics``/``hidden`` stay at
    their defaults.  A registered id whose layers the port lacks raises
    ``NotImplementedError`` naming ROADMAP.md A16b.
    """
    family: str = "ntm"
    vocab: int = 400
    topics: int = 10
    hidden: int = 64            # both encoder MLP widths
    arch: str = ""              # LM-only fields (family="lm")
    layers: int = 0             # 0 = the arch's reduced() layer count
    width: int = 0              # d_model override; 0 = reduced default
    seq_len: int = 0            # tokens per document; 0 = 32

    def _validate(self) -> None:
        _require(self.family in ("ntm", "lm"),
                 f"model.family {self.family!r} is not one of "
                 "('ntm', 'lm')")
        _check_int(self.vocab, "model.vocab", 2)
        _check_int(self.topics, "model.topics", 1)
        _check_int(self.hidden, "model.hidden", 1)
        _require(isinstance(self.arch, str),
                 f"model.arch must be a string, got {self.arch!r}")
        _check_int(self.layers, "model.layers", 0)
        _check_int(self.width, "model.width", 0)
        _check_int(self.seq_len, "model.seq_len", 0)
        if self.family == "ntm":
            _require(self.arch == "" and self.layers == 0
                     and self.width == 0 and self.seq_len == 0,
                     "model.arch/layers/width/seq_len are LM-only "
                     "fields — set model.family='lm' to use them; "
                     "fields are never silently dropped")
            return
        _require(self.arch in ARCH_KIND_OF,
                 f"model.arch {self.arch!r} is not a registered "
                 f"architecture; known: {sorted(ARCH_KIND_OF)}")
        kind = ARCH_KIND_OF[self.arch]
        _require(kind not in (NTM, AUDIO, VLM),
                 f"model.arch {self.arch!r} has kind {kind!r} — "
                 "model.family='lm' federates the token-causal "
                 "families (dense/moe/ssm/hybrid); audio and "
                 "vision-language archs need modality batch keys the "
                 "federated token pipeline does not carry, and NTM "
                 "archs go through model.family='ntm'")
        _require(self.topics == 10 and self.hidden == 64,
                 "model.topics/model.hidden are NTM-only fields — "
                 "leave them at their defaults under model.family='lm'; "
                 "fields are never silently dropped")
        if self.width:
            _require(self.width % 64 == 0,
                     f"model.width must be a multiple of 64 (the "
                     f"federated LM head size), got {self.width}")
        if self.seq_len:
            _require(self.seq_len >= 2,
                     f"model.seq_len must be >= 2, got {self.seq_len}")
        get_config(self.arch)       # A16b: the ids the port lacks raise


@dataclass(frozen=True)
class PartitionSpec:
    """``data.partition``: registry partitioner + alpha (or the CLI's
    string form, ``"dirichlet(0.3)"``)."""
    kind: str = "topic"
    alpha: Optional[float] = None

    @classmethod
    def from_value(cls, v, where: str = "data.partition") -> "PartitionSpec":
        if isinstance(v, cls):
            return v
        if isinstance(v, str):
            name, kw = parse_partition_spec(v)
            return cls(kind=name, alpha=kw.get("alpha"))
        if isinstance(v, Mapping):
            unknown = sorted(set(v) - {"kind", "alpha"})
            if unknown:
                raise ValueError(f"unknown key(s) {unknown} in {where}; "
                                 "known: ['alpha', 'kind']")
            return cls(kind=v.get("kind", "topic"), alpha=v.get("alpha"))
        raise ValueError(
            f"{where} must be a partition spec string (e.g. "
            f"'dirichlet(0.3)') or a {{kind, alpha}} mapping, got "
            f"{type(v).__name__}")

    def to_string(self) -> str:
        if self.alpha is None:
            return self.kind
        return f"{self.kind}({self.alpha!r})"

    def _validate(self) -> None:
        parse_partition_spec(self.to_string())


@dataclass(frozen=True)
class DataSpec:
    """``data`` section: the synthetic LDA federation + its partition."""
    num_clients: int = 5
    docs_per_node: int = 400
    val_docs_per_node: int = 80
    shared_topics: Optional[int] = None     # None -> max(topics // 5, 1)
    seed: Optional[int] = None              # None -> execution.seed
    partition: PartitionSpec = field(default_factory=PartitionSpec)

    def _validate(self) -> None:
        _check_int(self.num_clients, "data.num_clients", 1)
        _check_int(self.docs_per_node, "data.docs_per_node", 1)
        _check_int(self.val_docs_per_node, "data.val_docs_per_node", 0)
        _check_int(self.shared_topics, "data.shared_topics", 0,
                   allow_none=True)
        _check_int(self.seed, "data.seed", 0, allow_none=True)
        _require(isinstance(self.partition, PartitionSpec),
                 "data.partition must be a PartitionSpec (or the string/"
                 "mapping forms accepted by from_dict)")
        self.partition._validate()


@dataclass(frozen=True)
class ScheduleSpec:
    """``schedule`` section: rounds, participation, staleness and the
    buffered-async service knobs."""
    rounds: int = 100
    clients_per_round: int = 0          # 0 = all clients
    sampling: str = "uniform"
    sampling_seed: Optional[int] = None
    local_epochs: int = 1
    local_epochs_by_client: Tuple[int, ...] = ()
    client_join_round: Tuple[int, ...] = ()
    client_leave_round: Tuple[int, ...] = ()
    straggler_prob: float = 0.0
    max_staleness: int = 0
    staleness_decay: float = 0.5
    mode: str = "sync"
    buffer_size: int = 0                # M; 0 = the cohort width K
    staleness_policy: str = ""          # "" -> "exponential" under async

    def _validate(self) -> None:
        _check_int(self.rounds, "schedule.rounds", 1)
        _check_int(self.clients_per_round, "schedule.clients_per_round",
                   0)
        _check_int(self.sampling_seed, "schedule.sampling_seed", 0,
                   allow_none=True)
        _require(self.sampling in SAMPLING_MODES,
                 f"schedule.sampling {self.sampling!r} is not one of "
                 f"{SAMPLING_MODES}")
        _check_int(self.local_epochs, "schedule.local_epochs", 1)
        _check_int_tuple(self.local_epochs_by_client,
                         "schedule.local_epochs_by_client", minimum=1)
        _check_int_tuple(self.client_join_round,
                         "schedule.client_join_round")
        _check_int_tuple(self.client_leave_round,
                         "schedule.client_leave_round")
        _check_float(self.straggler_prob, "schedule.straggler_prob",
                     0.0, 1.0)
        _check_int(self.max_staleness, "schedule.max_staleness", 0)
        _check_float(self.staleness_decay, "schedule.staleness_decay",
                     0.0, 1.0)
        _require(self.mode in SCHEDULE_MODES,
                 f"schedule.mode {self.mode!r} is not one of "
                 f"{SCHEDULE_MODES}")
        _check_int(self.buffer_size, "schedule.buffer_size", 0)
        _require(self.staleness_policy in ("",) + STALENESS_POLICIES,
                 f"schedule.staleness_policy {self.staleness_policy!r} "
                 f"is not one of {STALENESS_POLICIES} (or '' for the "
                 "mode default)")
        if self.mode == "sync":
            _require(self.buffer_size == 0,
                     "schedule.buffer_size is a buffered-async knob but "
                     "schedule.mode is 'sync' — set "
                     "schedule.mode='buffered_async' (docs/serving.md); "
                     "async knobs are never silently dropped")
            _require(self.staleness_policy == "",
                     "schedule.staleness_policy is a buffered-async "
                     "knob but schedule.mode is 'sync' — set "
                     "schedule.mode='buffered_async' (docs/serving.md); "
                     "async knobs are never silently dropped")
        else:
            _require(self.straggler_prob == 0.0,
                     "schedule.straggler_prob simulates in-round delays "
                     "and needs a round barrier; under "
                     "schedule.mode='buffered_async' staleness is REAL "
                     "version lag (bounded by schedule.max_staleness) — "
                     "drop the straggler knob")


@dataclass(frozen=True)
class TransformsSpec:
    """``transforms`` section: the ordered message-transform stage."""
    names: Tuple[str, ...] = ()
    dp_noise_multiplier: float = 0.0
    dp_clip_norm: float = 1.0
    compression_topk: float = 0.0
    precision: str = ""

    def _validate(self) -> None:
        _require(isinstance(self.names, tuple),
                 "transforms.names must be a tuple/list of transform "
                 "names")
        for n in self.names:
            _require(n in TRANSFORM_NAMES,
                     f"transforms.names entry {n!r} is not a registered "
                     f"transform; known: {sorted(TRANSFORM_NAMES)}")
        _check_float(self.dp_noise_multiplier,
                     "transforms.dp_noise_multiplier", 0.0)
        _check_float(self.dp_clip_norm, "transforms.dp_clip_norm", 0.0,
                     exclusive_min=True)
        _check_float(self.compression_topk, "transforms.compression_topk",
                     0.0, 1.0)
        # the never-silently-dropped contract, both directions
        if "dp" in self.names:
            _require(self.dp_noise_multiplier > 0,
                     "the 'dp' transform needs "
                     "transforms.dp_noise_multiplier > 0 — with zero "
                     "noise it would silently degrade to clip-only "
                     "while claiming local DP")
        elif self.dp_noise_multiplier > 0:
            _require(False,
                     "transforms.dp_noise_multiplier > 0 but 'dp' is "
                     "not in transforms.names — declare the stage "
                     "explicitly (names=('dp', ...)); privacy knobs are "
                     "never silently dropped")
        if "topk" in self.names:
            _require(self.compression_topk > 0,
                     "the 'topk' transform needs "
                     "transforms.compression_topk > 0")
        elif self.compression_topk > 0:
            _require(False,
                     "transforms.compression_topk > 0 but 'topk' is "
                     "not in transforms.names — declare the stage "
                     "explicitly (names=('topk', ...)); compression "
                     "knobs are never silently dropped")
        _require(self.precision in ("", "bf16"),
                 f"transforms.precision {self.precision!r} is not a "
                 "supported wire format; one of ('', 'bf16')")
        if "precision" in self.names:
            _require(self.precision == "bf16",
                     "the 'precision' transform needs "
                     "transforms.precision = 'bf16' (the only wire "
                     "format implemented) — an empty precision with the "
                     "stage enabled would silently be a no-op cast")
        elif self.precision:
            _require(False,
                     "transforms.precision is set but 'precision' is "
                     "not in transforms.names — declare the stage "
                     "explicitly (names=('precision', ...)); wire-format "
                     "knobs are never silently dropped")


@dataclass(frozen=True)
class ServerOptSpec:
    """``server_opt`` section: the rule applied to the combined delta."""
    name: str = "fedavg"
    lr: float = 1.0
    momentum: float = 0.9       # FedAvgM beta / FedAdam b1
    beta2: float = 0.999        # FedAdam b2
    eps: float = 1e-3           # FedAdam tau

    def _validate(self) -> None:
        _require(self.name in SERVER_OPTIMIZERS,
                 f"server_opt.name {self.name!r} is not a registered "
                 f"server optimizer; known: {sorted(SERVER_OPTIMIZERS)}")
        _check_float(self.lr, "server_opt.lr", 0.0, exclusive_min=True)
        _check_float(self.momentum, "server_opt.momentum", 0.0)
        _require(self.momentum < 1.0,
                 f"server_opt.momentum must be in [0, 1), got "
                 f"{self.momentum}")
        _check_float(self.beta2, "server_opt.beta2", 0.0,
                     exclusive_min=True)
        _require(self.beta2 < 1.0,
                 f"server_opt.beta2 must be in (0, 1), got {self.beta2}")
        _check_float(self.eps, "server_opt.eps", 0.0, exclusive_min=True)


@dataclass(frozen=True)
class ExecutionSpec:
    """``execution`` section: how the spec runs.  ``mesh`` must stay
    None in the port (ROADMAP A17)."""
    exec_mode: str = "loop"
    batch_size: int = 64
    pad_cohorts: bool = True
    learning_rate: float = 2e-3     # client-side lambda of Eq. (3)
    rel_tol: float = 0.0
    stochastic_loss: bool = False
    seed: int = 0
    kernel_backend: str = "xla"     # round-trips; the device picks
    mesh: Optional[Any] = None

    def _validate(self) -> None:
        _require(self.exec_mode in EXEC_MODES,
                 f"execution.exec_mode {self.exec_mode!r} is not one of "
                 f"{EXEC_MODES}")
        _require(self.kernel_backend in KERNEL_BACKENDS,
                 f"execution.kernel_backend {self.kernel_backend!r} is "
                 f"not one of {KERNEL_BACKENDS}")
        _check_int(self.batch_size, "execution.batch_size", 1)
        _check_bool(self.pad_cohorts, "execution.pad_cohorts")
        _check_bool(self.stochastic_loss, "execution.stochastic_loss")
        _check_float(self.learning_rate, "execution.learning_rate", 0.0,
                     exclusive_min=True)
        _check_float(self.rel_tol, "execution.rel_tol", 0.0)
        _check_int(self.seed, "execution.seed", 0)
        if self.mesh is not None:
            _not_ported("execution.mesh (the sharded cohort path)", "A17")


_SECTIONS = {
    "model": ModelSpec,
    "data": DataSpec,
    "schedule": ScheduleSpec,
    "transforms": TransformsSpec,
    "server_opt": ServerOptSpec,
    "execution": ExecutionSpec,
}


# ---------------------------------------------------------------------------
# the spec tree
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FederationSpec:
    """One serializable federated scenario (module docstring); the
    all-defaults spec is the paper's Algorithm-1 regime."""
    version: int = SPEC_VERSION
    name: str = ""
    model: ModelSpec = field(default_factory=ModelSpec)
    data: DataSpec = field(default_factory=DataSpec)
    schedule: ScheduleSpec = field(default_factory=ScheduleSpec)
    transforms: TransformsSpec = field(default_factory=TransformsSpec)
    server_opt: ServerOptSpec = field(default_factory=ServerOptSpec)
    execution: ExecutionSpec = field(default_factory=ExecutionSpec)
    serving: Optional[Any] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Range-check every section + refuse cross-section incoherence
        (``ValueError``), and what the port does not run yet
        (``NotImplementedError``)."""
        _require(isinstance(self.version, int)
                 and not isinstance(self.version, bool)
                 and self.version == SPEC_VERSION,
                 f"version {self.version!r} is not supported by this "
                 f"build (expected {SPEC_VERSION}); migrate the spec or "
                 "update the repo")
        _require(isinstance(self.name, str), "name must be a string")
        for sect, cls in _SECTIONS.items():
            v = getattr(self, sect)
            _require(isinstance(v, cls),
                     f"section {sect!r} must be a {cls.__name__}, got "
                     f"{type(v).__name__}")
            v._validate()
        if self.serving is not None:
            _not_ported("the serving section (the wire front-end)", "A14")
        if "secure" in self.transforms.names:
            _require("precision" not in self.transforms.names,
                     "the 'secure' transform is incompatible with "
                     "'precision' (bf16 messages): pairwise masks cancel "
                     "BITWISE only on the fp32 dyadic grid — rounding "
                     "masked messages to bfloat16 destroys the "
                     "cancellation, a silent privacy downgrade, never a "
                     "tolerable approximation")
            sch, L = self.schedule, self.data.num_clients
            _require(not (sch.straggler_prob > 0 and sch.max_staleness > 0),
                     "the 'secure' transform is incompatible with the "
                     "straggler buffer (schedule.straggler_prob/"
                     "max_staleness): a stale masked message arrives in "
                     "a later combine than its pair partners, so the "
                     "pairwise masks no longer cancel")
            k = sch.clients_per_round or L
            _require(min(k, L) >= L
                     and not any(j > 0 for j in sch.client_join_round)
                     and not any(x > 0 for x in sch.client_leave_round),
                     "the 'secure' transform needs synchronous full "
                     "participation (clients_per_round = 0 or "
                     "num_clients, no client join/leave): pairwise "
                     "masks only cancel when every client's message "
                     "joins the same combine")
        if self.schedule.mode == "buffered_async":
            m, L = self.resolved_buffer_size, self.data.num_clients
            _require(m <= L,
                     f"schedule.buffer_size M={m} exceeds "
                     f"data.num_clients L={L} — the service holds at "
                     "most ONE in-flight delta per client (the newest "
                     "upload supersedes), so a buffer wider than the "
                     "population can never fill and aggregation would "
                     "never fire")
            _require("secure" not in self.transforms.names,
                     "the 'secure' transform is incompatible with "
                     "schedule.mode='buffered_async': pairwise masks "
                     "cancel only when a FIXED cohort's messages join "
                     "one combine — a buffered-async aggregation fires "
                     "on whichever M deltas arrive first, so mask "
                     "partners can land in different aggregations and "
                     "the dyadic-grid cancellation breaks (DESIGN.md §6)")
            _require(self.execution.exec_mode == "loop",
                     "execution.exec_mode='vmap' has no meaning under "
                     "schedule.mode='buffered_async': the fused graphs "
                     "stack a round's cohort, but the service has no "
                     "round barrier — each upload is an independent "
                     "per-client local update (the loop/reference "
                     "path); set exec_mode='loop'")
        if self.execution.stochastic_loss:
            _require(self.model.family != "lm",
                     "execution.stochastic_loss is the train-mode ELBO "
                     "(dropout + reparametrization) of the NTM family — "
                     "the federated LM objective is deterministic; drop "
                     "the flag under model.family='lm' instead of having "
                     "it silently ignored")
        # what the port runs: the batched cohort path without the
        # straggler ring
        vmap = self.execution.exec_mode == "vmap"
        if vmap and self.schedule.straggler_prob > 0 \
                and self.schedule.max_staleness > 0:
            _not_ported("stragglers on the batched cohort path (the fused "
                        "straggler ring)", "A10")

    # -- resolved (cross-section) defaults --------------------------------
    @property
    def resolved_data_seed(self) -> int:
        return self.data.seed if self.data.seed is not None \
            else self.execution.seed

    @property
    def resolved_sampling_seed(self) -> int:
        return self.schedule.sampling_seed \
            if self.schedule.sampling_seed is not None \
            else self.execution.seed

    @property
    def resolved_shared_topics(self) -> int:
        return self.data.shared_topics if self.data.shared_topics is not None \
            else max(self.model.topics // 5, 1)

    @property
    def resolved_seq_len(self) -> int:
        """Tokens per federated LM document (model.seq_len, default 32)."""
        return self.model.seq_len or 32

    @property
    def resolved_buffer_size(self) -> int:
        """Buffered-async aggregation threshold M (0 = the cohort width
        K — the M=K default is the sync-equivalence anchor)."""
        L = self.data.num_clients
        k = min(self.schedule.clients_per_round or L, L)
        return self.schedule.buffer_size or k

    @property
    def resolved_staleness_policy(self) -> str:
        return self.schedule.staleness_policy or "exponential"

    # -- compilation to the engine's config objects -----------------------
    def to_model_config(self) -> ModelConfig:
        if self.model.family == "lm":
            return self._to_lm_model_config()
        return ModelConfig(name=self.name or "federation-spec", kind=NTM,
                           vocab_size=self.model.vocab,
                           num_topics=self.model.topics,
                           ntm_hidden=(self.model.hidden, self.model.hidden))

    def _to_lm_model_config(self) -> ModelConfig:
        """The arch's ``reduced()`` config with the spec's size overrides
        (the reference's rule: the launcher's ``--reduced`` path)."""
        m = self.model
        cfg = get_config(m.arch).reduced()
        kw: Dict[str, Any] = {
            "name": self.name or f"fed-{m.arch}",
            "vocab_size": m.vocab,
            # documents are seq_len+1 tokens (inputs + shifted labels)
            "max_seq_len": max(cfg.max_seq_len, self.resolved_seq_len + 1),
        }
        if m.layers:
            kw["num_layers"] = m.layers
        if m.width:
            heads = max(m.width // 64, 1)
            kw.update(d_model=m.width, d_ff=m.width * 2, num_heads=heads,
                      head_dim=64,
                      num_kv_heads=heads
                      if cfg.num_kv_heads >= cfg.num_heads
                      else max(1, heads // 2))
        return dataclasses.replace(cfg, **kw)

    def to_federated_config(self) -> FederatedConfig:
        t = self.transforms
        return FederatedConfig(
            num_clients=self.data.num_clients,
            learning_rate=self.execution.learning_rate,
            max_rounds=self.schedule.rounds,
            rel_tol=self.execution.rel_tol,
            dp_noise_multiplier=t.dp_noise_multiplier,
            dp_clip_norm=t.dp_clip_norm,
            message_precision=t.precision,
            compression_topk=t.compression_topk)

    def to_round_config(self) -> RoundConfig:
        s = self.schedule
        return RoundConfig(
            exec_mode=self.execution.exec_mode,
            clients_per_round=s.clients_per_round,
            sampling=s.sampling,
            sampling_seed=self.resolved_sampling_seed,
            local_epochs=s.local_epochs,
            server_optimizer=self.server_opt.name,
            server_lr=self.server_opt.lr,
            server_momentum=self.server_opt.momentum,
            server_beta2=self.server_opt.beta2,
            server_eps=self.server_opt.eps,
            straggler_prob=s.straggler_prob,
            max_staleness=s.max_staleness,
            staleness_decay=s.staleness_decay,
            transforms=self.transforms.names,
            pad_cohorts=self.execution.pad_cohorts,
            local_epochs_by_client=s.local_epochs_by_client,
            client_join_round=s.client_join_round,
            client_leave_round=s.client_leave_round,
            kernel_backend=self.execution.kernel_backend)

    # -- dict round trip ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON-types dict (tuples become lists); the inverse of
        :meth:`from_dict`, and the reference's dict for the same spec."""
        return _jsonify(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FederationSpec":
        """STRICT inverse of :meth:`to_dict`: unknown sections/keys and
        unsupported versions raise; omitted ones take their defaults."""
        if not isinstance(d, Mapping):
            raise ValueError("FederationSpec.from_dict needs a mapping, "
                             f"got {type(d).__name__}")
        known = set(_SECTIONS) | {"version", "name", "serving"}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown top-level spec key(s) {unknown}; "
                             f"known: {sorted(known)}")
        version = d.get("version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(
                f"FederationSpec version {version!r} is not supported by "
                f"this build (expected {SPEC_VERSION}); migrate the spec "
                "or update the repo")
        kw: Dict[str, Any] = {"version": version, "name": d.get("name", ""),
                              "serving": d.get("serving")}
        for sect, sect_cls in _SECTIONS.items():
            if sect in d:
                kw[sect] = _section_from_dict(sect_cls, d[sect], sect)
        return cls(**kw)

    # -- JSON files ---------------------------------------------------------
    def to_json(self, *, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FederationSpec":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise ValueError(f"FederationSpec JSON does not parse: {e}") \
                from None
        return cls.from_dict(d)

    def save(self, path: str) -> str:
        """JSON write with a trailing newline, through a temporary file
        renamed over ``path`` (a reader never sees half a spec)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write(self.to_json() + "\n")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    @classmethod
    def load(cls, path: str) -> "FederationSpec":
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            raise ValueError(f"cannot read spec file {path!r}: {e}") \
                from None
        try:
            return cls.from_json(text)
        except ValueError as e:
            raise ValueError(f"spec file {path!r}: {e}") from None


def parse_int_tuple(s, *, what: str = "int list",
                    minimum: int = 0) -> Tuple[int, ...]:
    """Parse a comma-separated int list STRICTLY (the CLI front door):
    every empty, malformed or out-of-range element raises ``ValueError``
    naming its position, as the reference's parser does; a tuple or list
    of ints is checked the same way.  ``""`` and None give ``()``."""
    if s is None:
        return ()
    if isinstance(s, (tuple, list)):
        out = []
        for i, x in enumerate(s):
            if isinstance(x, bool) or not isinstance(x, int):
                raise ValueError(f"{what}: {x!r} at position {i} is not "
                                 "an integer")
            if x < minimum:
                raise ValueError(
                    f"{what}: {x} at position {i} is out of range "
                    f"(must be >= {minimum})")
            out.append(x)
        return tuple(out)
    toks = str(s).split(",")
    if len(toks) == 1 and not toks[0].strip():
        return ()
    out = []
    for pos, tok in enumerate(toks):
        t = tok.strip()
        if not t:
            raise ValueError(
                f"{what}: empty element at position {pos} in {s!r} — "
                "write an explicit integer for every comma-separated "
                "slot (e.g. '1,2,4'); elements are never silently "
                "dropped")
        try:
            v = int(t)
        except ValueError:
            raise ValueError(
                f"{what}: {t!r} at position {pos} in {s!r} is not an "
                "integer") from None
        if v < minimum:
            raise ValueError(
                f"{what}: {v} at position {pos} in {s!r} is out of "
                f"range (must be >= {minimum})")
        out.append(v)
    return tuple(out)


def _jsonify(v):
    if isinstance(v, dict):
        return {k: _jsonify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    return v


def _coerce(cls, fname: str, v):
    if cls is DataSpec and fname == "partition":
        return PartitionSpec.from_value(v)
    return tuple(v) if isinstance(v, list) else v


def _section_from_dict(cls, d, where: str):
    if isinstance(d, cls):
        return d
    if not isinstance(d, Mapping):
        raise ValueError(f"spec section {where!r} must be a mapping, got "
                         f"{type(d).__name__}")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(f"unknown key(s) {unknown} in spec section "
                         f"{where!r}; known: {sorted(fields)}")
    return cls(**{k: _coerce(cls, k, v) for k, v in d.items()})


def spec_replace(spec: FederationSpec,
                 overrides: Mapping[str, Any]) -> FederationSpec:
    """Dotted-path functional update over the spec tree
    (``{"schedule.buffer_size": 2, "name": "x"}``); the result
    re-validates, and unknown paths raise ``ValueError``."""
    top: Dict[str, Any] = {}
    by_section: Dict[str, Dict[str, Any]] = {}
    for key, v in overrides.items():
        if "." in key:
            sect, _, fname = key.partition(".")
            if sect == "serving" or key.startswith("execution.mesh."):
                _not_ported(f"override {key!r}",
                            "A14" if sect == "serving" else "A17")
            if sect not in _SECTIONS:
                raise ValueError(f"unknown spec section {sect!r} in "
                                 f"override {key!r}; known: "
                                 f"{sorted(set(_SECTIONS) | {'serving'})}")
            cls = _SECTIONS[sect]
            if fname not in {f.name for f in dataclasses.fields(cls)}:
                raise ValueError(
                    f"unknown key {fname!r} in spec section {sect!r}; "
                    f"known: {sorted(f.name for f in dataclasses.fields(cls))}")
            by_section.setdefault(sect, {})[fname] = _coerce(cls, fname, v)
        elif key in _SECTIONS or key in ("name", "version", "serving"):
            top[key] = v
        else:
            raise ValueError(f"unknown spec override {key!r}; use "
                             "'section.field' dotted paths or one of "
                             f"{sorted(set(_SECTIONS) | {'name', 'version', 'serving'})}")
    kw = dict(top)
    for sect, updates in by_section.items():
        kw[sect] = dataclasses.replace(kw.get(sect, getattr(spec, sect)),
                                       **updates)
    return dataclasses.replace(spec, **kw)
