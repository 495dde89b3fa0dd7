"""gFedNTM federated training protocol (paper Algorithm 1).

Port of ``repro/core/protocol.py``:

* :class:`FederatedTrainer` — the literal Algorithm 1: a server object
  and L client objects in one process; the server sees vocabularies and
  gradients, never documents.  It is the ``message="grad"`` preset of
  :class:`~repro_torch.core.engine.FederationEngine` (E = 1, K = L,
  server = the wrapped client optimizer, Eq. (3)), on the host loop or
  the batched cohort path;
* :class:`FedAvgTrainer` — E = ``fed.local_steps`` local SGD steps and
  weight averaging (the ``message="delta"`` preset, loop only);
* :func:`weighted_global_loss` — ``sum_l sum-loss_l / sum_l n_l``, whose
  gradient is exactly the Eq. (2) weighted average;
* the paper's baselines: :func:`train_centralized` (scenario 2, a
  trusted server on the concatenated corpus) and
  :func:`train_non_collaborative` (scenario 1, one model per node).

Minibatches are drawn from seeded CPU ``torch.Generator``\\ s
(``data/federated_split.py``), so a card run and a CPU run see the same
documents.  The in-graph ``shard_map`` step waits for the mesh layer
(ROADMAP.md A17).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import FederatedConfig, RoundConfig
from repro_torch.core import aggregation as agg
from repro_torch.core.engine import ClientState, FederationEngine
from repro_torch.data.federated_split import seeded_generator
from repro_torch.optim.optimizers import Optimizer, sgd

Params = Dict[str, torch.Tensor]


def weighted_global_loss(loss_sum_fn: Callable[..., Tuple[torch.Tensor,
                                                          torch.Tensor]]):
    """Wrap a (sum_loss, count) fn into the Eq.-(2)-equivalent global mean."""
    def loss(params, batch, **kw):
        s, n = loss_sum_fn(params, batch, **kw)
        return s / torch.clamp(n, min=1.0)
    return loss


def make_federated_train_step(*args, **kwargs):
    """The in-graph federated step over a device mesh."""
    raise NotImplementedError(
        "make_federated_train_step (the shard_map protocol step over a "
        "device mesh) is not ported to repro_torch yet (ROADMAP.md A17); "
        "run FederatedTrainer, or the JAX reference package")


def _wrap_client_optimizer(optimizer: Optimizer) -> agg.ServerOptimizer:
    """Adapt a client-side Eq. (3) ``Optimizer`` to the engine's server
    stage: the combined message IS the Eq. (2) gradient average, and the
    server applies ``optimizer.update`` to it verbatim."""
    return agg.ServerOptimizer(
        "client-optimizer", optimizer.init,
        lambda params, gbar, state, round_idx=0:
            optimizer.update(params, gbar, state, round_idx))


class FederatedTrainer(FederationEngine):
    """The gFedNTM server loop (Alg. 1) over explicit client objects.

    ``loss_fn(params, batch) -> scalar mean loss`` is the client's local
    objective (its gradient is G_l of Eq. (2) for that minibatch).
    ``exec_mode="loop"`` (default) polls the clients one by one;
    ``"vmap"`` stacks all L minibatches and runs every client gradient,
    the transforms, the Eq. (2) combine and the Eq. (3) update in one
    batched round.  The ``FederatedConfig`` knobs ``dp_noise_multiplier``,
    ``compression_topk``, ``secure_aggregation`` and
    ``message_precision`` become the gradient transforms, in the
    reference's order (precision, dp, topk, secure), under both exec
    modes: one stage call over the round's ``(L, D)`` gradient slab.
    """

    def __init__(self, loss_fn, init_params: Mapping[str, torch.Tensor],
                 clients: Sequence[ClientState],
                 fed: FederatedConfig,
                 optimizer: Optional[Optimizer] = None,
                 batch_size: int = 64,
                 num_clients_for_masks: Optional[int] = None,
                 exec_mode: str = "loop",
                 loss_sum_fn=None):
        optimizer = optimizer or sgd(fed.learning_rate)
        names = []
        if fed.message_precision:
            names.append("precision")
        if fed.dp_noise_multiplier > 0:
            names.append("dp")
        if fed.compression_topk > 0:
            names.append("topk")
        if fed.secure_aggregation:
            names.append("secure")
        super().__init__(
            loss_fn, init_params, clients, fed, RoundConfig(),
            batch_size=batch_size, exec_mode=exec_mode,
            loss_sum_fn=loss_sum_fn, message="grad",
            server=_wrap_client_optimizer(optimizer),
            transforms=tuple(names),
            num_clients_for_masks=num_clients_for_masks)
        self.optimizer = optimizer

    # the reference's name for the server stage's state
    @property
    def opt_state(self):
        return self.server_state

    @opt_state.setter
    def opt_state(self, value):
        self.server_state = value

    def _client_grad(self, l: int, c: ClientState, round_seed: int):
        """GETCLIENTGRAD(N_l, W): ``(loss, grad, n)`` of client l's
        minibatch for the round seeded ``round_seed`` (Alg. 1), the grad
        through the transform stage as the client would send it."""
        msg, n, loss = self._local_message(l, round_seed)
        return loss, self.transform_message(l, msg, n, round_seed), n


class FedAvgTrainer(FederationEngine):
    """``fed.local_steps`` local SGD steps between synchronizations
    [McMahan et al. 2017]: the ``message="delta"`` preset with a
    FedAvg(server_lr=1) server, since the weighted average of client
    weights IS ``W +`` the weighted average of client deltas.
    Loop-only.  The update rule is plain local SGD at
    ``fed.learning_rate``, so a client ``optimizer`` is refused rather
    than ignored."""

    def __init__(self, loss_fn, init_params: Mapping[str, torch.Tensor],
                 clients: Sequence[ClientState],
                 fed: FederatedConfig,
                 optimizer: Optional[Optimizer] = None,
                 batch_size: int = 64,
                 exec_mode: str = "loop",
                 loss_sum_fn=None):
        if optimizer is not None:
            raise ValueError(
                "FedAvgTrainer runs plain local SGD at fed.learning_rate "
                "and takes no client optimizer; use FederatedTrainer for "
                "a wrapped client optimizer")
        if exec_mode != "loop":
            raise NotImplementedError(
                "FedAvgTrainer averages full client weights and is "
                "loop-only; RoundEngine(exec_mode='vmap') is the batched "
                "path for multi-local-step clients")
        super().__init__(
            loss_fn, init_params, clients, fed,
            RoundConfig(local_epochs=fed.local_steps),
            batch_size=batch_size, exec_mode="loop",
            loss_sum_fn=loss_sum_fn, message="delta")


# ---------------------------------------------------------------------------
# baselines: the paper's scenarios 1 and 2
# ---------------------------------------------------------------------------
def train_centralized(loss_fn, init_params: Mapping[str, torch.Tensor],
                      data: Mapping[str, torch.Tensor], *,
                      optimizer: Optimizer, batch_size: int,
                      steps: int, seed: int = 0,
                      verbose: bool = False) -> Params:
    """Scenario 2: a trusted server trains on the concatenated corpus C.
    Step e draws ``min(batch_size, n_docs)`` documents without
    replacement from the CPU generator of ``(seed, e)``; ``data`` lives
    on the parameters' device."""
    params = dict(init_params)
    opt_state = optimizer.init(params)
    grad_fn = torch.func.grad_and_value(loss_fn)
    n_docs = len(next(iter(data.values())))
    n = min(batch_size, n_docs)
    for e in range(steps):
        idx = torch.randperm(n_docs, generator=seeded_generator(seed, e))[:n]
        batch = {k: v[idx.to(v.device)] for k, v in data.items()}
        grads, loss = grad_fn(params, batch)
        params, opt_state = optimizer.update(params, grads, opt_state, e)
        if verbose and e % 50 == 0:
            print(f"[centralized {e:4d}] loss={float(loss):.4f}")
    return params


def train_non_collaborative(loss_fn, init_fn,
                            node_data: Sequence[Mapping[str, torch.Tensor]],
                            *, optimizer_factory, batch_size: int,
                            steps: int, seed: int = 0) -> List[Params]:
    """Scenario 1: every node trains its own model on its own corpus.
    ``init_fn(generator)`` makes node l's weights from the CPU generator
    seeded ``seed + 17 * l``; node l draws from ``seed + 31 * l``."""
    out = []
    for l, data in enumerate(node_data):
        params = init_fn(torch.Generator().manual_seed(seed + 17 * l))
        out.append(train_centralized(
            loss_fn, params, data, optimizer=optimizer_factory(),
            batch_size=batch_size, steps=steps, seed=seed + 31 * l))
    return out
