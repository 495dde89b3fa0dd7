"""The partitioner registry, partition-spec parsing and the per-client
minibatch draws.

The registry maps ``(n_docs, num_clients, labels, seed, **kwargs)`` to
disjoint per-client index arrays covering ``[0, n_docs)``, as the
reference's does (``repro/data/federated_split.py``): ``iid`` (a uniform
equal-size split), ``by_label`` (alias ``topic``, distinct categories per
client), ``dirichlet`` (per-label Dirichlet(alpha) allocation) and
``quantity_skew`` (content-iid, Dirichlet(alpha) client sizes).  They are
numpy only, on ``np.random.default_rng(seed)``, so the index arrays are
the reference's bit for bit.  Specs are strings such as
``"dirichlet(0.3)"``, parsed by :func:`parse_partition_spec`.

Minibatch draws follow the reference's key schedule with its own
threefry draws (``core/prng.py``): client l's key in round t is
``fold_in(PRNGKey(seed * 100003 + t), l)``; epoch 0 draws from it and
epoch s > 0 from ``fold_in(key, s + 1)`` (:func:`_epoch_key`); a draw is
``choice(key, num_docs, min(batch_size, num_docs), replace=False)`` and
the batch carries ``rng = fold_in(key, 1)``, the key of the train-mode
loss's dropout and reparametrization noise.  So the port selects the
reference's documents at any ``batch_size``, and the same ones on a CPU
and a GPU run.  The keys are hashed on the host, the shuffle's sort keys
on the device of the client corpus, where the indices and the batch's
``rng`` go.  :func:`stacked_round_batches`
stacks a round's cohort draws for the batched path, with the same draws
as the per-client iterator.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.core import prng


# ---------------------------------------------------------------------------
# partitioner registry
# ---------------------------------------------------------------------------
def _partition_iid(n_docs: int, num_clients: int, *, labels=None,
                   seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_docs)
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def _partition_by_label(n_docs: int, num_clients: int, *, labels=None,
                        seed: int = 0) -> List[np.ndarray]:
    if labels is None:
        raise ValueError("by_label split needs labels")
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    groups = [np.where(np.isin(labels, u))[0]
              for u in np.array_split(uniq, num_clients)]
    return [np.sort(g) for g in groups]


def _partition_dirichlet(n_docs: int, num_clients: int, *, labels=None,
                         seed: int = 0,
                         alpha: float = 0.5) -> List[np.ndarray]:
    if labels is None:
        raise ValueError("dirichlet split needs labels")
    if alpha <= 0:
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    rng.permutation(n_docs)     # the reference's stream position
    out = [[] for _ in range(num_clients)]
    for u in np.unique(labels):
        members = rng.permutation(np.where(labels == u)[0])
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(members)).astype(int)
        for c, part in enumerate(np.split(members, cuts)):
            out[c].extend(part.tolist())
    return [np.sort(np.array(o, dtype=np.int64)) for o in out]


def _partition_quantity_skew(n_docs: int, num_clients: int, *, labels=None,
                             seed: int = 0,
                             alpha: float = 0.5) -> List[np.ndarray]:
    """Content-iid split with Dirichlet(alpha)-skewed client sizes; every
    client gets at least one document, the skew shares the rest."""
    if alpha <= 0:
        raise ValueError(f"quantity_skew alpha must be > 0, got {alpha}")
    if n_docs < num_clients:
        raise ValueError(f"cannot give {num_clients} clients >=1 of "
                         f"{n_docs} docs")
    rng = np.random.default_rng(seed)
    props = rng.dirichlet(np.full(num_clients, alpha))
    spare = n_docs - num_clients
    sizes = 1 + np.floor(props * spare).astype(np.int64)
    # the flooring remainder goes to the largest shares
    for c in np.argsort(-props)[: n_docs - int(sizes.sum())]:
        sizes[c] += 1
    idx = rng.permutation(n_docs)
    cuts = np.cumsum(sizes)[:-1]
    return [np.sort(part) for part in np.split(idx, cuts)]


PARTITIONERS: Dict[str, Callable[..., List[np.ndarray]]] = {
    "iid": _partition_iid,
    "by_label": _partition_by_label,
    "topic": _partition_by_label,        # the paper's name for the regime
    "dirichlet": _partition_dirichlet,
    "quantity_skew": _partition_quantity_skew,
}
# partitioners that accept an '(alpha)' argument; every other name must
# appear bare — 'iid(0.3)' is a user error, not a silently-ignored knob
_PARAMETRIC = frozenset({"dirichlet", "quantity_skew"})
_SPEC_RE = re.compile(r"^\s*([a-z_]+)\s*(?:\(\s*(.*?)\s*\))?\s*$")


def parse_partition_spec(spec: str) -> Tuple[str, Dict[str, float]]:
    """``"dirichlet(0.3)"`` -> ``("dirichlet", {"alpha": 0.3})``; the
    reference's parser, with its error messages."""
    m = _SPEC_RE.match(spec or "")
    if not m or m.group(1) not in PARTITIONERS:
        raise ValueError(f"unknown partition spec {spec!r}; known: "
                         f"{sorted(set(PARTITIONERS))} "
                         "(optionally with '(alpha)')")
    name, arg = m.group(1), m.group(2)
    if arg is None:
        return name, {}
    if name not in _PARAMETRIC:
        raise ValueError(f"partition spec {spec!r}: {name!r} takes no "
                         "argument — drop the parentheses")
    if arg == "":
        raise ValueError(f"partition spec {spec!r} has empty parentheses "
                         f"— give an explicit alpha, e.g. '{name}(0.3)', "
                         "or drop the parentheses for the default")
    try:
        alpha = float(arg)
    except ValueError:
        raise ValueError(f"partition spec {spec!r}: malformed alpha "
                         f"{arg!r} (expected a number, e.g. "
                         f"'{name}(0.3)')") from None
    if not alpha > 0:
        raise ValueError(f"partition spec {spec!r}: alpha must be > 0, "
                         f"got {alpha!r}")
    return name, {"alpha": alpha}


def partition_corpus(n_docs: int, num_clients: int, spec: str = "iid", *,
                     labels: Optional[Sequence[int]] = None,
                     seed: int = 0) -> List[np.ndarray]:
    """Spec string -> per-client document index arrays."""
    name, kw = parse_partition_spec(spec)
    return PARTITIONERS[name](n_docs, num_clients, labels=labels, seed=seed,
                              **kw)


def split_corpus_across_clients(
    n_docs: int,
    num_clients: int,
    *,
    mode: str = "iid",
    labels: Optional[Sequence[int]] = None,
    dirichlet_alpha: float = 0.5,
    seed: int = 0,
) -> List[np.ndarray]:
    """The reference's pre-registry entry point: ``mode`` is any
    registered name, ``dirichlet_alpha`` the alpha of the parametric
    ones."""
    if mode not in PARTITIONERS:
        raise ValueError(f"unknown split mode {mode!r}")
    kw = {"alpha": dirichlet_alpha} if mode in _PARAMETRIC else {}
    return PARTITIONERS[mode](n_docs, num_clients, labels=labels, seed=seed,
                              **kw)


def _draw_indices(rng: torch.Tensor, num_docs: int, batch_size: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The one place a client draw is made: ``min(batch_size, num_docs)``
    document indices without replacement, the in-batch model key and the
    draw size, on ``device``.  The per-client iterator and
    :func:`stacked_round_batches` both call it, so the two execution
    paths see the same documents and keys."""
    n = min(batch_size, int(num_docs))
    return (prng.choice(rng, int(num_docs), n, device=device),
            prng.fold_in(rng, 1).to(device), n)


def _epoch_key(round_rng: torch.Tensor, s: int) -> torch.Tensor:
    """Epoch-s draw key: epoch 0 reuses the client's round key (the draw
    Algorithm 1 makes), s > 0 folds in s + 1 — ``fold_in(key, 1)`` is
    epoch 0's model key."""
    return round_rng if s == 0 else prng.fold_in(round_rng, s + 1)


def sample_minibatch(data: Dict[str, torch.Tensor], num_docs: int,
                     rng: torch.Tensor, batch_size: int
                     ) -> Tuple[Dict[str, torch.Tensor], int]:
    """One client draw from key ``rng``, gathered on the device the
    client corpus lives on, with ``batch["rng"] = fold_in(rng, 1)``."""
    dev = next(iter(data.values())).device
    idx, model_rng, n = _draw_indices(rng, num_docs, batch_size, dev)
    batch = {k: v[idx] for k, v in data.items()}
    batch["rng"] = model_rng
    return batch, n


def round_minibatches(data: Dict[str, torch.Tensor], num_docs: int,
                      round_rng: torch.Tensor, *, batch_size: int,
                      local_epochs: int = 1
                      ) -> Iterator[Tuple[Dict[str, torch.Tensor], int]]:
    """Yield the E local-epoch minibatches of one client in one round
    (``round_rng`` is the client's round key)."""
    for s in range(local_epochs):
        yield sample_minibatch(data, num_docs, _epoch_key(round_rng, s),
                               batch_size)


def stacked_round_batches(datas: Sequence[Dict[str, torch.Tensor]],
                          num_docs: Sequence[int], round_key: torch.Tensor,
                          client_ids: Sequence[int], *, batch_size: int,
                          local_epochs: int = 1,
                          pad_to: Optional[int] = None,
                          shard_multiple: Optional[int] = None
                          ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """One round's cohort minibatches on a leading client axis.

    For cohort member ``i`` (global id ``client_ids[i]``, key
    ``fold_in(round_key, id)``) and epoch ``s`` the draw is exactly the
    one :func:`round_minibatches` makes, gathered on the device the
    client corpus lives on and stacked into fixed shapes:

      * every data key -> ``(K, E, P, ...)``, ``P = batch_size``, rows
        beyond a client's draw size zero;
      * ``"doc_mask"`` -> ``(K, E, P)`` float32, 1 for real rows — the
        mask-aware loss keeps padded rows out of the objective and its
        gradient;
      * ``"rng"`` -> ``(K, E, 2)`` int64, the in-batch model keys the
        loop path puts in ``batch["rng"]``.

    Returns ``(stacked, counts)``, ``counts`` the ``(K, E)`` float32 draw
    sizes on the host (the Eq. (2) weights are ``counts.sum(axis=1)``).
    ``pad_to`` (>= the cohort) widens the client axis to a fixed K with
    all-zero rows (data, mask, keys, counts): zero-weight padding, the
    real rows unchanged.  ``shard_multiple`` (the engine's mesh width)
    refuses a stacked width the mesh's data axis does not divide: cohorts
    are never silently repartitioned.
    """
    k_clients = len(datas)
    k_stack = k_clients if pad_to is None else int(pad_to)
    if k_stack < k_clients:
        raise ValueError(f"pad_to={pad_to} is smaller than the cohort "
                         f"({k_clients} clients); the stacked axis cannot "
                         "drop cohort members")
    if shard_multiple and k_stack % shard_multiple:
        raise ValueError(
            f"stacked cohort width {k_stack} is not divisible by the "
            f"device-mesh data axis ({shard_multiple}) — cohorts are "
            "never silently repartitioned; enable execution.pad_cohorts "
            "(fixed-K padding) or resize the cohort/mesh")
    if k_clients == 0:
        raise ValueError("stacked_round_batches needs at least one cohort "
                         "member (an empty round runs no local update)")
    e, p = local_epochs, batch_size
    stacked = {key: torch.zeros((k_stack, e, p) + tuple(v.shape[1:]),
                                dtype=v.dtype, device=v.device)
               for key, v in datas[0].items()}
    mask = np.zeros((k_stack, e, p), np.float32)
    dev = next(iter(stacked.values())).device
    keys = torch.zeros((k_stack, e, 2), dtype=torch.int64, device=dev)
    counts = np.zeros((k_stack, e), np.float32)
    for i, (data, nd, cid) in enumerate(zip(datas, num_docs, client_ids)):
        crng = prng.fold_in(round_key, int(cid))
        draws = [_draw_indices(_epoch_key(crng, s), nd, batch_size, dev)
                 for s in range(e)]
        n = draws[0][2]
        idx = torch.stack([d[0] for d in draws])        # (E, n)
        for key, v in data.items():
            stacked[key][i, :, :n] = v[idx]
        keys[i] = torch.stack([d[1] for d in draws])
        mask[i, :, :n] = 1.0
        counts[i, :] = n
    stacked["doc_mask"] = torch.from_numpy(mask).to(dev)
    stacked["rng"] = keys
    return stacked, counts
