"""Plain federated rounds: what one round of federated LM training does.

Per round ``r`` (seed ``exec_seed * 100003 + r``) and client ``l``: the
documents of :func:`draws.client_draws`, ``local_epochs`` steps of SGD
on the mean token loss from the global weights, the message ``local -
global``; with top-k (``topk_frac``) the message plus the client's error
memory keeps exactly ``max(int(frac * size), 1)`` entries of each leaf
(layers stacked: one leaf per name), ranked by their magnitude rounded to
bfloat16, ties to the lower index, and the rest stays in the memory;
then the weighted mean of the messages by documents drawn (Eq. 2) and the
server step ``W += delta`` (FedAvg, server rate 1).  The round's loss is
the clients' mean losses weighted the same way.

Leaves are named by their dotted path, layers stacked on a leading axis
(``layers.mixer.attn.wq`` is ``(L, d, h)``).  ``fault`` plants one of the
faults the benchmark must catch, in the reference put in the program's
place: ``"half_batch"`` trains each client on the first half of its rows
only, ``"altered"`` adds 1% to the combined message as it is produced.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch

from reference import draws
from reference.lm import Products, mean_token_loss

FAULTS = ("half_batch", "altered")


def flat_leaves(tree: Mapping[str, Any], prefix: str = "") -> Dict[str,
                                                                    torch.Tensor]:
    """Dotted path -> leaf, the per-layer leaves stacked on axis 0."""
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(tree):
        node, name = tree[key], f"{prefix}{key}"
        if key == "layers" and not prefix:
            per = [flat_leaves(lp) for lp in node]
            for leaf in per[0]:
                out[f"layers.{leaf}"] = torch.stack([p[leaf] for p in per])
        elif isinstance(node, Mapping):
            out.update(flat_leaves(node, name + "."))
        else:
            out[name] = node
    return out


def tree_of(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The nested tree of :func:`flat_leaves`' dict, layers unstacked."""
    tree: Dict[str, Any] = {}
    n_layers = next(v.shape[0] for k, v in flat.items()
                    if k.startswith("layers."))
    tree["layers"] = [{} for _ in range(n_layers)]

    def put(node, path, value):
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for name, leaf in flat.items():
        path = name.split(".")
        if path[0] == "layers":
            for i, lp in enumerate(tree["layers"]):
                put(lp, path[1:], leaf[i])
        else:
            put(tree, path, leaf)
    return tree


def keep_mask(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly the ``k`` largest of ``mag`` (1-D) after rounding to
    bfloat16, ties to the lower index."""
    q = mag.to(torch.bfloat16).to(torch.float32)
    thresh = torch.topk(q, k).values[-1]
    greater = q > thresh
    tie = q == thresh
    room = k - int(greater.sum())
    return greater | (tie & (torch.cumsum(tie.to(torch.int64), 0) <= room))


def leaf_norms(a: Mapping[str, torch.Tensor],
               b: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf, the norm of ``a - b`` (the difference in float32, the
    norm in float64)."""
    return {k: float(torch.linalg.vector_norm((a[k] - b[k]).double()))
            for k in b}


def run_rounds(weights: Mapping[str, Any], cfg: Dict[str, Any],
               traffic: Dict[str, Any], docs: Sequence[torch.Tensor],
               exec_seed: int, rounds: int, *, precision: str = "fp32",
               fault: Optional[str] = None) -> Dict[str, Any]:
    """``rounds`` plain rounds from ``weights`` on the clients' documents
    ``docs`` (each ``(n_l, S + 1)``).  Returns the round losses and, per
    leaf, the norm of the weights' change after the first round and after
    the last."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r} is not one of {FAULTS}")
    dev = docs[0].device
    pr = Products(precision, dev)
    lr, batch = traffic["learning_rate"], traffic["batch_size"]
    epochs, frac = traffic["local_epochs"], traffic.get("topk_frac")
    start = {k: v.detach().clone() for k, v in flat_leaves(weights).items()}
    params = {k: v.clone() for k, v in start.items()}
    memory: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(docs)
    losses: List[float] = []
    first: Dict[str, float] = {}
    with pr.active():
        for r in range(rounds):
            seed = exec_seed * 100003 + r
            bar = {k: torch.zeros_like(v) for k, v in params.items()}
            total_w, loss_sum = 0.0, 0.0
            for cid, d in enumerate(docs):
                local = dict(params)
                client_loss = 0.0
                picks = draws.client_draws(seed, cid, d.shape[0], batch,
                                           epochs)
                for rows in picks:
                    if fault == "half_batch":
                        rows = rows[:max(1, len(rows) // 2)]
                    leaves = {k: v.detach().requires_grad_(True)
                              for k, v in local.items()}
                    loss = mean_token_loss(
                        tree_of(leaves), cfg,
                        d[torch.tensor(rows, device=dev)], pr)
                    grads = torch.autograd.grad(loss, list(leaves.values()))
                    local = {k: (v - lr * g).detach()
                             for (k, v), g in zip(leaves.items(), grads)}
                    client_loss += float(loss.detach())
                    del leaves, grads, loss
                n = float(len(picks[0]))
                msg = {k: local[k] - params[k] for k in params}
                del local
                if frac:
                    err = memory[cid] or {k: torch.zeros_like(v)
                                          for k, v in msg.items()}
                    for k in msg:
                        corrected = msg[k] + err[k]
                        flat = corrected.reshape(-1)
                        keep = keep_mask(flat.abs(),
                                         max(int(frac * flat.numel()), 1))
                        sent = torch.where(keep, flat, 0.0).view_as(corrected)
                        err[k] = corrected - sent
                        msg[k] = sent
                    memory[cid] = err
                for k in bar:
                    bar[k] += n * msg[k]
                total_w += n
                loss_sum += n * client_loss / len(picks)
                del msg
            for k in params:
                step = bar[k] / total_w
                if fault == "altered":
                    step = step * 1.01
                params[k] = params[k] + step
            losses.append(loss_sum / total_w)
            if r == 0:
                first = leaf_norms(params, start)
            del bar
    return {"losses": losses, "first": first,
            "change": leaf_norms(params, start)}
