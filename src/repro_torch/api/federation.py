"""`Federation` — spec -> wired engine, stepping and held-out evaluation.

Port of ``repro/api/federation.py`` for ProdLDA: the synthetic corpus,
the client corpora of the spec's partition (put on the device once), the
objective and init, ``step``/``run`` with the reference's per-round seed
schedule ``seed * 100003 + round`` and ``on_round_end`` hooks, and
``evaluate``.  Rounds run on the host loop (``exec_mode="loop"``, the
default: the paper's Algorithm 1, stragglers included) or on the batched
cohort path (``exec_mode="vmap"``).  Snapshots wait for A11.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.api.spec import FederationSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ClientState, FederationEngine
from repro_torch.core.ntm import prodlda
from repro_torch.data.federated_split import (parse_partition_spec,
                                              partition_corpus)
from repro_torch.data.synthetic_lda import SyntheticLDA, generate_lda_corpus
from repro_torch.kernels import ops
from repro_torch.metrics import npmi_coherence, tss


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another; a CUDA request on a host without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and this host has "
            "none; pass device='cpu' explicitly to run the plain PyTorch "
            "path on the CPU")
    return dev


def max_param_dev(a: Mapping[str, torch.Tensor],
                  b: Mapping[str, torch.Tensor]) -> float:
    """Max abs leafwise deviation between two parameter dicts."""
    if a.keys() != b.keys():
        raise ValueError(f"parameter dicts differ in names: "
                         f"{sorted(set(a) ^ set(b))}")
    return max(float(torch.max(torch.abs(a[k].detach().cpu()
                                         - b[k].detach().cpu())))
               for k in a)


def build_corpus(spec: FederationSpec) -> SyntheticLDA:
    """The synthetic LDA federation a spec's ``data`` section describes."""
    return generate_lda_corpus(
        vocab_size=spec.model.vocab, num_topics=spec.model.topics,
        num_nodes=spec.data.num_clients,
        shared_topics=spec.resolved_shared_topics,
        docs_per_node=spec.data.docs_per_node,
        val_docs_per_node=spec.data.val_docs_per_node,
        seed=spec.resolved_data_seed)


def build_clients(syn: SyntheticLDA, num_clients: int, partition: str, *,
                  device, seed: int = 0) -> List[ClientState]:
    """The spec's client corpora, each copied to ``device`` once
    (minibatches gather from it there): ``topic`` keeps the paper's
    per-node split; any other registry partition pools the nodes' corpora
    and re-partitions the documents (labels = each document's dominant
    ground-truth topic), as the reference does."""
    name, _ = parse_partition_spec(partition)
    if name in ("topic", "by_label"):
        if len(syn.node_bows) != num_clients:
            raise ValueError(f"corpus has {len(syn.node_bows)} nodes, the "
                             f"spec declares {num_clients} clients")
        parts = [(b, len(b)) for b in syn.node_bows]
    else:
        bows = syn.concat_bows()
        labels = np.concatenate(syn.node_thetas).argmax(axis=1)
        idx = partition_corpus(len(bows), num_clients, partition,
                               labels=labels, seed=seed)
        if any(len(p) == 0 for p in idx):
            raise ValueError(f"partition {partition!r} left a client with "
                             "no documents; raise alpha or shrink "
                             "num_clients")
        parts = [(bows[p], len(p)) for p in idx]
    return [ClientState(data={"bow": torch.from_numpy(b).to(device)},
                        num_docs=n) for b, n in parts]


def heldout_elbo_per_token(params: Mapping[str, torch.Tensor],
                           cfg: ModelConfig, val_bows: torch.Tensor,
                           batch: int = 256) -> float:
    """Negative ELBO per held-out token (log perplexity bound).

    The reconstruction term comes from the fused decoder
    (``ops.topic_decoder_loss``: kernel B1 on a CUDA tensor), the KL term
    from :func:`prodlda.kl_to_prior`; the (B, V) logits are never
    materialized.  Per-batch sums stay on the device and are added in
    float64 on the host once, as the reference adds Python floats.
    """
    sums, tokens = [], []
    with torch.no_grad():
        for i in range(0, len(val_bows), batch):
            bow = val_bows[i:i + batch]
            mu, lv = prodlda.encode(params, cfg, bow)
            recon = ops.topic_decoder_loss(torch.softmax(mu, dim=-1),
                                           params["beta"], bow,
                                           params["dec_scale"])
            kl = prodlda.kl_to_prior(params, cfg, mu, lv)
            sums.append(torch.sum(recon + kl))
            tokens.append(torch.sum(bow))
    if not sums:
        return 0.0
    tot = torch.stack(sums).double().sum().item()
    n = torch.stack(tokens).double().sum().item()
    return tot / max(n, 1.0)


class Federation:
    """A spec wired into an engine (construct via :meth:`from_spec`);
    ``.engine`` holds params, clients, the scheduler, the transform stage
    and the server optimizer."""

    def __init__(self, spec: FederationSpec, engine: FederationEngine, *,
                 model_cfg: ModelConfig, corpus: SyntheticLDA,
                 device: torch.device):
        self.spec = spec
        self.engine = engine
        self.model_cfg = model_cfg
        self.corpus = corpus
        self.device = device
        self._val: Optional[torch.Tensor] = None
        self._hooks: List[Callable[[Dict[str, float]], None]] = []

    @classmethod
    def from_spec(cls, spec: Union[FederationSpec, Mapping, str], *,
                  device=None, corpus: Optional[SyntheticLDA] = None,
                  init_params: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> "Federation":
        """Compile a synchronous spec (object, ``to_dict`` mapping, or
        registry name) into a wired federation on ``device`` (default
        ``cuda``).  ``corpus`` (shared across builds) and ``init_params``
        (e.g. weights carried from the reference) override the synthetic
        defaults, as in the reference."""
        if isinstance(spec, str):
            from repro_torch.api.registry import scenario_spec
            spec = scenario_spec(spec)
        elif isinstance(spec, Mapping):
            spec = FederationSpec.from_dict(spec)
        spec.validate()
        if spec.schedule.mode == "buffered_async":
            raise ValueError(
                "schedule.mode='buffered_async' describes the "
                "long-running federation service, not a "
                "round-synchronous simulation — build it with "
                "repro_torch.serve.FederationService.from_spec(spec); "
                "Federation runs sync specs only")
        dev = resolve_device(device)
        cfg = spec.to_model_config()
        if corpus is None:
            corpus = build_corpus(spec)
        elif tuple(np.shape(corpus.beta)) != (spec.model.topics,
                                              spec.model.vocab):
            raise ValueError(
                f"injected corpus was generated for (topics, vocab)="
                f"{tuple(np.shape(corpus.beta))} but the spec declares "
                f"{(spec.model.topics, spec.model.vocab)}")
        clients = build_clients(corpus, spec.data.num_clients,
                                spec.data.partition.to_string(), device=dev,
                                seed=spec.resolved_data_seed)
        if init_params is None:
            init_params = prodlda.init_params(
                torch.Generator().manual_seed(spec.execution.seed), cfg,
                device=dev)
        engine = FederationEngine(
            lambda p, b: prodlda.elbo_loss(p, cfg, b),
            {k: v.to(dev) for k, v in init_params.items()},
            clients, spec.to_federated_config(), spec.to_round_config(),
            batch_size=spec.execution.batch_size,
            # mask-aware (sum, count): padded cohort rows stay out of the
            # stacked objective
            loss_sum_fn=lambda p, b: prodlda.elbo_loss_sum(p, cfg, b))
        return cls(spec, engine, model_cfg=cfg, corpus=corpus, device=dev)

    # -- state --------------------------------------------------------------
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.engine.params

    @property
    def history(self) -> List[Dict[str, float]]:
        return self.engine.history

    @property
    def round_index(self) -> int:
        """Rounds completed so far (== the next round's index)."""
        return self.engine._round

    # -- stepping -------------------------------------------------------------
    def _round_seed(self, round_idx: int) -> int:
        return self.spec.execution.seed * 100003 + round_idx

    def on_round_end(self, fn: Callable[[Dict[str, float]], None]):
        """Register a hook called with every completed round's record;
        returns ``fn`` (decorator-friendly)."""
        self._hooks.append(fn)
        return fn

    def step(self) -> Dict[str, float]:
        """Run exactly one round; fire hooks; return the round record."""
        rec = self.engine.round(seed=self._round_seed(self.engine._round))
        for fn in self._hooks:
            fn(rec)
        return rec

    def run(self, rounds: Optional[int] = None, *,
            verbose: bool = False) -> Dict[str, torch.Tensor]:
        """Step until ``schedule.rounds`` total rounds have run (``rounds=N``:
        at most N more), honoring the rel-tol stopping criterion; on a
        fresh federation this is step-for-step ``FederationEngine.fit``."""
        total = self.spec.schedule.rounds if rounds is None \
            else self.engine._round + rounds
        while self.engine._round < total:
            rec = self.step()
            if verbose and rec["round"] % 10 == 0:
                print(f"[round {rec['round']:4d}] loss={rec['loss']:.4f} "
                      f"rel={rec['rel_change']:.2e} "
                      f"K={rec['participants']} "
                      f"arrived={rec['arrived']}")
            if self.engine.stop_criterion(rec, self.engine.fed.rel_tol):
                break
        return self.engine.params

    def evaluate(self, *, batch: int = 256) -> Dict[str, float]:
        """Held-out ELBO/perplexity, NPMI and TSS of ``engine.params``
        against the synthetic corpus's ground truth."""
        val_np = self.corpus.concat_val_bows()
        if self._val is None:
            self._val = torch.from_numpy(val_np).to(self.device)
        params = self.engine.params
        beta = prodlda.get_topics(params).detach().cpu().numpy()
        elbo = heldout_elbo_per_token(params, self.model_cfg, self._val,
                                      batch)
        with np.errstate(over="ignore"):
            ppl = float(np.exp(elbo))
        return {
            "heldout_elbo_per_token": elbo,
            "heldout_perplexity": ppl,
            "npmi_coherence": float(npmi_coherence(beta, val_np)),
            "tss": float(tss(self.corpus.beta, beta)),
        }
