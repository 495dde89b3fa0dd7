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

Minibatches and the train-mode loss's keys follow the reference's
threefry schedule (``core/prng.py``, ``data/federated_split.py``), so a
card run, a CPU run and the reference see the same documents and draws.

:func:`make_federated_train_step` is the reference's in-graph
``shard_map`` step over a mesh of one or two client axes
(``parallel/sharding.py``, ``launch/mesh.py``): each client is one
shard, its gradient computed on its own device, and Eq. (2) is the
per-shard partials plus the port's ``psum``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import FederatedConfig, RoundConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import prng
from repro_torch.core.engine import ClientState, FederationEngine
from repro_torch.optim.optimizers import Optimizer, sgd

Params = Dict[str, torch.Tensor]


def weighted_global_loss(loss_sum_fn: Callable[..., Tuple[torch.Tensor,
                                                          torch.Tensor]]):
    """Wrap a (sum_loss, count) fn into the Eq.-(2)-equivalent global mean."""
    def loss(params, batch, **kw):
        s, n = loss_sum_fn(params, batch, **kw)
        return s / torch.clamp(n, min=1.0)
    return loss


def make_federated_train_step(loss_sum_fn, optimizer: Optimizer, mesh, *,
                               client_axes: Tuple[str, ...] = ("data",),
                               fed: Optional[FederatedConfig] = None):
    """The explicit federated step for replicated-parameter models over a
    mesh (``parallel.sharding.fed_mesh``, or ``launch.mesh.make_host_mesh``
    with axes ``("data", "model")``): each slice along ``client_axes`` is
    one client.

    ``step(params, opt_state, batch, step_idx, rng) -> (params,
    opt_state, mean_loss)``: every batch leaf's leading axis is split over
    the clients, numbered as the reference numbers them (row-major over
    ``client_axes``: ``cid * axis_size(ax) + index`` along each further
    axis), and client ``cid`` computes on the shard at its coordinates
    (index 0 along any other axis).  On its device the client folds its
    id into ``rng`` (the batch's ``"rng"``, if any, becomes that key),
    takes ``value_and_grad`` of its local mean loss ``loss_sum /
    max(count, 1)``, then, when ``fed`` asks, local DP (``dp_privatize``
    on ``fold_in(local_rng, 7)``) and the pairwise secure mask
    (``secure_mask_grads`` on ``fold_in(rng, step_idx)`` over all the
    clients).  The server side is Eq. (2) (:func:`aggregate.
    aggregate_psum`), the optimizer update and the sample-weighted mean
    loss, on the mesh's first device, where params and optimizer state
    live."""
    clients = mesh.client_mesh(tuple(client_axes))
    fed = fed or FederatedConfig()

    def step(params, opt_state, batch, step_idx, rng):
        blocks = {k: clients.split(v) for k, v in batch.items()}
        grads, counts, losses = [], [], []
        for cid, p in enumerate(clients.replicate(params)):
            dev = clients.devices[cid]
            local_rng = prng.fold_in(rng, cid)
            lbatch = {k: b[cid] for k, b in blocks.items()}
            if "rng" in lbatch:
                lbatch["rng"] = local_rng.to(dev)

            def local_mean_loss(q):
                s, n = loss_sum_fn(q, lbatch)
                loss = s / torch.clamp(n, min=1.0)
                return loss, (loss.detach(), n.detach())

            with clients.on(cid):
                g, (loss, n) = torch.func.grad(local_mean_loss,
                                               has_aux=True)(p)
                if fed.dp_noise_multiplier > 0:
                    g = agg.dp_privatize(
                        g, prng.fold_in(local_rng, 7),
                        clip_norm=fed.dp_clip_norm,
                        noise_multiplier=fed.dp_noise_multiplier)
                if fed.secure_aggregation:
                    g = agg.secure_mask_grads(
                        g, prng.fold_in(rng, int(step_idx)), cid,
                        clients.size, n)
            grads.append(g)
            counts.append(n)
            losses.append(loss)
        gbar = agg.aggregate_psum(grads, counts, clients)
        new_params, new_opt = optimizer.update(params, gbar, opt_state,
                                               step_idx)
        mean_loss = clients.psum([l * n for l, n in zip(losses, counts)]) \
            / clients.psum(counts)
        return new_params, new_opt, mean_loss

    return step


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
        minibatch for the round key ``PRNGKey(round_seed)`` (Alg. 1), the
        grad through the transform stage as the client would send it."""
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
    The reference's key schedule: ``key = PRNGKey(seed)``, and each step
    ``key, k1, k2 = split(key, 3)``, draws ``min(batch_size, n_docs)``
    documents without replacement from ``k1`` and gives the batch
    ``rng = k2``; ``data`` lives on the parameters' device."""
    params = dict(init_params)
    opt_state = optimizer.init(params)
    grad_fn = torch.func.grad_and_value(loss_fn)
    n_docs = len(next(iter(data.values())))
    n = min(batch_size, n_docs)
    dev = next(iter(data.values())).device
    key = prng.PRNGKey(seed)
    for e in range(steps):
        key, k1, k2 = prng.split(key, 3)
        idx = prng.choice(k1, n_docs, n, device=dev)
        batch = {k: v[idx] for k, v in data.items()}
        batch["rng"] = k2.to(dev)
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
    ``init_fn(key)`` makes node l's weights from the threefry key
    ``PRNGKey(seed + 17 * l)`` (on the node's data device), the
    reference's; node l's draws are :func:`train_centralized`'s
    with ``seed + 31 * l``."""
    out = []
    for l, data in enumerate(node_data):
        params = init_fn(prng.PRNGKey(
            seed + 17 * l, device=next(iter(data.values())).device))
        out.append(train_centralized(
            loss_fn, params, data, optimizer=optimizer_factory(),
            batch_size=batch_size, steps=steps, seed=seed + 31 * l))
    return out
