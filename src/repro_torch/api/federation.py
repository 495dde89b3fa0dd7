"""`Federation` — spec -> wired engine, stepping and held-out evaluation.

Port of ``repro/api/federation.py``: the synthetic corpus (a topic
corpus for ``model.family="ntm"``, a token corpus for ``"lm"``), the
client corpora of the spec's partition (put on the device once), the
objective and init (ProdLDA, or the registry LM's bundle in fp32),
``step``/``run`` with the reference's per-round seed schedule ``seed *
100003 + round`` and ``on_round_end`` hooks, and ``evaluate`` (held-out
ELBO, NPMI and TSS; held-out cross-entropy for an LM).  Rounds run on
the host loop (``exec_mode="loop"``, the default: the paper's Algorithm
1, stragglers included) or on the batched cohort path
(``exec_mode="vmap"``).  ``clients=``, ``loss_fn=``/``loss_sum_fn=``,
``init_params=`` and ``corpus=`` override the synthetic defaults, as in
the reference.  The engine holds an LM's parameters as one flat dict of
the reference's leaves (``transformer.stack_layers``: per-layer leaves
stacked on a leading axis), so each message segment is a reference
leaf; ``Federation.params`` gives the model's tree.  Snapshots wait for
A11.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, \
    Sequence, Union

import numpy as np
import torch

from repro_torch.api.spec import FederationSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ClientState, FederationEngine
from repro_torch.core.ntm import prodlda
from repro_torch.data.federated_split import (parse_partition_spec,
                                              partition_corpus)
from repro_torch.data.lm_data import (LMCorpus, generate_lm_corpus,
                                      lm_client_data)
from repro_torch.data.synthetic_lda import SyntheticLDA, generate_lda_corpus
from repro_torch.kernels import ops
from repro_torch.metrics import npmi_coherence, tss
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import tree_leaves


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


def max_param_dev(a, b) -> float:
    """Max abs leafwise deviation between two parameter trees (dicts and
    lists of tensors, e.g. ProdLDA's dict or an LM's tree)."""
    if isinstance(a, Mapping) and a.keys() != b.keys():
        raise ValueError(f"parameter dicts differ in names: "
                         f"{sorted(set(a) ^ set(b))}")
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise ValueError(f"parameter trees have {len(la)} vs {len(lb)} "
                         "leaves")
    return max(float(torch.max(torch.abs(x.detach().cpu()
                                         - y.detach().cpu())))
               for x, y in zip(la, lb))


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


def build_lm_corpus(spec: FederationSpec) -> LMCorpus:
    """The synthetic federated token corpus a ``model.family='lm'`` spec's
    ``data`` section describes (docs = fixed-length sequences)."""
    return generate_lm_corpus(
        vocab_size=spec.model.vocab, num_nodes=spec.data.num_clients,
        docs_per_node=spec.data.docs_per_node,
        seq_len=spec.resolved_seq_len,
        val_docs_per_node=spec.data.val_docs_per_node,
        seed=spec.resolved_data_seed)


def build_lm_clients(corpus: LMCorpus, num_clients: int, partition: str, *,
                     device, seed: int = 0) -> List[ClientState]:
    """:func:`build_clients` for token corpora, each client's
    ``tokens``/``labels``/``loss_mask`` copied to ``device`` once:
    ``topic`` keeps the per-node vocabulary-window split; any other
    registry partition pools the documents and re-partitions them with
    origin-node labels, as the reference does."""
    name, _ = parse_partition_spec(partition)
    if name in ("topic", "by_label"):
        parts = list(corpus.node_tokens)
    else:
        toks = corpus.concat_tokens()
        labels = np.concatenate([np.full(len(t), node) for node, t
                                 in enumerate(corpus.node_tokens)])
        idx = partition_corpus(len(toks), num_clients, partition,
                               labels=labels, seed=seed)
        if any(len(p) == 0 for p in idx):
            raise ValueError(f"partition {partition!r} left a client with "
                             "no documents; raise alpha or shrink "
                             "num_clients")
        parts = [toks[p] for p in idx]
    return [ClientState(data={k: torch.from_numpy(np.ascontiguousarray(v))
                              .to(device)
                              for k, v in lm_client_data(t).items()},
                        num_docs=len(t)) for t in parts]


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


def heldout_perplexity(params: Mapping[str, torch.Tensor],
                       cfg: ModelConfig, val_bows: torch.Tensor,
                       batch: int = 256) -> float:
    """exp(negative ELBO per held-out token), the NTM perplexity bound;
    ``inf`` where it overflows (the log-space
    :func:`heldout_elbo_per_token` is always finite)."""
    with np.errstate(over="ignore"):
        return float(np.exp(heldout_elbo_per_token(params, cfg, val_bows,
                                                   batch)))


def heldout_xent_per_token(params, cfg: ModelConfig, val_tokens,
                           batch: int = 256) -> float:
    """Mean next-token cross-entropy (nats) of the LM tree ``params`` on
    held-out documents ``val_tokens`` (N, seq_len + 1), in ``cfg``'s
    activation dtype, as the reference evaluates.  Per-batch sums stay on
    the device and are added in float64 on the host once."""
    dev = params["embed"]["table"].device
    val = torch.as_tensor(val_tokens).to(dev)
    sums, counts = [], []
    with torch.no_grad():
        for i in range(0, len(val), batch):
            t = val[i:i + batch]
            logits, _ = tfm.forward_train(params, cfg, {"tokens": t[:, :-1]})
            s, n = tfm.xent_loss(logits, t[:, 1:])
            sums.append(s)
            counts.append(n)
    if not sums:
        return 0.0
    tot = torch.stack(sums).double().sum().item()
    n = torch.stack(counts).double().sum().item()
    return tot / max(n, 1.0)


def _on_stacked(fn):
    """An LM objective of the model's tree as one of the engine's flat
    dict of stacked leaves (None stays None)."""
    if fn is None:
        return None
    return lambda p, b: fn(tfm.unstack_layers(p), b)


class Federation:
    """A spec wired into an engine (construct via :meth:`from_spec`);
    ``.engine`` holds params, clients, the scheduler, the transform stage
    and the server optimizer."""

    def __init__(self, spec: FederationSpec, engine: FederationEngine, *,
                 model_cfg: ModelConfig, corpus=None, device: torch.device):
        self.spec = spec
        self.engine = engine
        self.model_cfg = model_cfg
        self.corpus = corpus
        self.device = device
        self._val: Optional[torch.Tensor] = None
        self._hooks: List[Callable[[Dict[str, float]], None]] = []

    @classmethod
    def from_spec(cls, spec: Union[FederationSpec, Mapping, str], *,
                  device=None, corpus=None,
                  clients: Optional[Sequence[ClientState]] = None,
                  loss_fn=None, loss_sum_fn=None,
                  init_params: Optional[Mapping[str, Any]] = None
                  ) -> "Federation":
        """Compile a synchronous spec (object, ``to_dict`` mapping, or
        registry name) into a wired federation on ``device`` (default
        ``cuda``).  ``corpus`` (shared across builds), ``clients`` (with
        their data on ``device``), ``loss_fn``/``loss_sum_fn`` and
        ``init_params`` (e.g. weights carried from the reference) override
        the synthetic defaults, as in the reference.  For an LM,
        ``loss_fn(params, batch)`` and ``init_params`` use the model's
        tree (``transformer.init_params``' layout)."""
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
        if spec.model.family == "lm":
            corpus, clients, loss_fn, loss_sum_fn, init_params = \
                cls._wire_lm(spec, cfg, dev, corpus, clients, loss_fn,
                             loss_sum_fn, init_params)
            # the engine differentiates the flat dict of stacked leaves
            loss_fn, loss_sum_fn = _on_stacked(loss_fn), \
                _on_stacked(loss_sum_fn)
            init_params = tfm.stack_layers(init_params)
        else:
            corpus, clients, loss_fn, loss_sum_fn, init_params = \
                cls._wire_ntm(spec, cfg, dev, corpus, clients, loss_fn,
                              loss_sum_fn, init_params)
        engine = FederationEngine(
            loss_fn, {k: v.to(dev) for k, v in init_params.items()},
            clients, spec.to_federated_config(), spec.to_round_config(),
            batch_size=spec.execution.batch_size, loss_sum_fn=loss_sum_fn)
        return cls(spec, engine, model_cfg=cfg, corpus=corpus, device=dev)

    @staticmethod
    def _wire_ntm(spec, cfg, dev, corpus, clients, loss_fn, loss_sum_fn,
                  init_params):
        """ProdLDA: the synthetic topic corpus and its clients, the ELBO
        (train mode — dropout and reparametrization from each batch's key
        — iff ``execution.stochastic_loss``) and the seeded init, each
        unless overridden."""
        if clients is None:
            if corpus is None:
                corpus = build_corpus(spec)
            elif tuple(np.shape(corpus.beta)) != (spec.model.topics,
                                                  spec.model.vocab):
                raise ValueError(
                    f"injected corpus was generated for (topics, vocab)="
                    f"{tuple(np.shape(corpus.beta))} but the spec declares "
                    f"{(spec.model.topics, spec.model.vocab)}")
            clients = build_clients(corpus, spec.data.num_clients,
                                    spec.data.partition.to_string(),
                                    device=dev, seed=spec.resolved_data_seed)
        if loss_fn is None:
            train = spec.execution.stochastic_loss

            def loss_fn(p, b):
                return prodlda.elbo_loss(p, cfg, b, train=train)
            if loss_sum_fn is None:
                # mask-aware (sum, count): padded cohort rows stay out of
                # the stacked objective
                def loss_sum_fn(p, b):
                    return prodlda.elbo_loss_sum(p, cfg, b, train=train)
        if init_params is None:
            init_params = prodlda.init_params(
                torch.Generator().manual_seed(spec.execution.seed), cfg,
                device=dev)
        return corpus, clients, loss_fn, loss_sum_fn, init_params

    @staticmethod
    def _wire_lm(spec, cfg, dev, corpus, clients, loss_fn, loss_sum_fn,
                 init_params):
        """``model.family='lm'``: the registry bundle in fp32 (as the
        reference federates) and the token corpus, with the NTM path's
        override surface and the reference's corpus checks."""
        from repro_torch.models.registry import build_model
        bundle = build_model(cfg, dtype=torch.float32)
        if clients is None:
            if corpus is None:
                corpus = build_lm_corpus(spec)
            else:
                if not isinstance(corpus, LMCorpus):
                    raise ValueError(
                        "model.family='lm' needs an LMCorpus (use "
                        "repro_torch.data.lm_data.generate_lm_corpus), got "
                        f"{type(corpus).__name__}")
                if corpus.num_nodes != spec.data.num_clients:
                    raise ValueError(
                        f"injected corpus has {corpus.num_nodes} nodes "
                        f"but the spec declares data.num_clients="
                        f"{spec.data.num_clients}")
                got = (corpus.vocab_size, corpus.seq_len)
                want = (spec.model.vocab, spec.resolved_seq_len)
                if got != want:
                    raise ValueError(
                        f"injected corpus was generated for (vocab, "
                        f"seq_len)={got} but the spec declares {want} — "
                        "a mismatched corpus would only fail later as "
                        "a shape error inside the loss")
            clients = build_lm_clients(corpus, spec.data.num_clients,
                                       spec.data.partition.to_string(),
                                       device=dev,
                                       seed=spec.resolved_data_seed)
        if loss_fn is None:
            loss_fn = bundle.loss
            if loss_sum_fn is None:
                # (sum, count): mask-aware, so zero-padded cohort rows
                # stay out of the stacked objective
                loss_sum_fn = bundle.loss_sum
        if init_params is None:
            init_params = bundle.init(
                torch.Generator().manual_seed(spec.execution.seed),
                device=dev)
        return corpus, clients, loss_fn, loss_sum_fn, init_params

    # -- state --------------------------------------------------------------
    @property
    def params(self) -> Dict[str, Any]:
        """The global model: ProdLDA's dict, or an LM's tree (views of
        the engine's stacked leaves)."""
        if self.spec.model.family == "lm":
            return tfm.unstack_layers(self.engine.params)
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
        """Held-out quality of the global model against the synthetic
        corpus: ELBO/perplexity, NPMI and TSS for ProdLDA; next-token
        cross-entropy and perplexity for an LM."""
        if self.corpus is None:
            raise ValueError(
                "evaluate() needs the synthetic corpus; this Federation "
                "was built over injected clients — score params with "
                "repro_torch.metrics directly instead")
        if isinstance(self.corpus, LMCorpus):
            if not len(self.corpus.val_tokens):
                raise ValueError(
                    "evaluate() needs held-out documents; set "
                    "data.val_docs_per_node > 0 in the spec")
            if self._val is None:
                self._val = torch.from_numpy(self.corpus.val_tokens) \
                    .to(self.device)
            xent = heldout_xent_per_token(self.params, self.model_cfg,
                                          self._val, batch)
            with np.errstate(over="ignore"):
                ppl = float(np.exp(xent))
            return {"heldout_xent_per_token": xent,
                    "heldout_perplexity": ppl}
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
