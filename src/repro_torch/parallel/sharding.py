"""Sharding of the port: the federation's device mesh, and the LM
partition rules on DTensor.

The port of ``repro/parallel/sharding.py``, in two halves.

**The federation's mesh** (``fed_mesh``, and what ``shardings_for(mesh,
P("data"))`` does to the engine's client axes).  The reference is
single-controller SPMD: one process holds a mesh over the first ``data``
local devices, the stacked ``(K, ...)`` cohort, the ``(L, ...)``
per-client transform state and the ``(C, ...)`` straggler ring are split
into contiguous row blocks (shard ``d`` holds rows ``[d*R/data,
(d+1)*R/data)``), params and server state are replicated, per-row stages
run per shard and every cross-row sum is per-shard partials plus one
``psum``.  :class:`FedMesh` keeps that shape in one process with no
``torch.distributed`` job: a row-sharded slab is a list of tensors,
shard ``d``'s on ``devices[d]``; the port's ``psum`` brings the partials
to the first device and adds them in shard order; a replicated value
lives on the first device and is copied to a shard's device where that
shard needs it (a no-op on the same device).  On CUDA the mesh is the
first visible cards; on the CPU, which a caller asks for explicitly (the
tests do), it is logical shards of the one host device, the counterpart
of the reference's forced host device count.  ``data=1`` is a real
one-shard mesh: the sharded code path with no cross-device traffic.  A
mesh may have two named axes (``launch.mesh.make_host_mesh``,
``("data", "model")``): its shards are then numbered row-major over the
axes, as the reference numbers a client ``cid * axis_size(ax) + index``.

**The LM partition rules** (FSDP x TP, name-based over the parameter
paths, one table for every architecture): ``param_partition_specs``,
``batch_partition_spec`` and ``cache_partition_specs`` give a spec per
leaf (:class:`P`, a tuple of entries, each ``None``, an axis name or a
tuple of names, as the reference's ``PartitionSpec``), under the
``megatron``, ``fsdp`` or ``tp`` profile.  The port's layers are a list
of per-unit dicts, not one stacked leading axis, so a ``layers/<i>/...``
leaf takes the reference's ``layers/...`` spec without its leading
``None``; the decode cache is stacked over units, as the reference's.
``shardings_for`` turns specs into DTensor placements on a
``torch.distributed`` ``DeviceMesh``, and the ``constrain_*`` hooks the
model calls are ``DTensor.redistribute`` under the ambient mesh
(``use_abstract_mesh``), and the identity off-mesh or on a plain tensor.
"""
from __future__ import annotations

import contextlib
import contextvars
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

AXIS = "data"

Rows = Union[torch.Tensor, np.ndarray]


def fed_mesh(data: int, device=None) -> "FedMesh":
    """The federation's ``("data",)`` mesh of ``data`` shards on
    ``device``'s kind (default ``cuda``): the first ``data`` visible CUDA
    devices, or ``data`` logical shards of the CPU.  Raises
    ``ValueError`` when fewer CUDA devices are visible than the mesh
    needs."""
    if isinstance(data, bool) or not isinstance(data, int) or data < 1:
        raise ValueError(f"fed_mesh needs data >= 1, got {data}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        seen = torch.cuda.device_count()
        if seen < data:
            raise ValueError(
                f"execution.mesh data={data} needs {data} devices but only "
                f"{seen} are visible; each shard of the data axis is one "
                "CUDA device — run on a host with that many cards, or "
                "shrink the mesh")
        return FedMesh(tuple(torch.device("cuda", i) for i in range(data)))
    if dev.type == "cpu":
        return FedMesh((torch.device("cpu"),) * data)
    raise ValueError(f"fed_mesh has no shards for device {dev}")


@dataclass(frozen=True)
class FedMesh:
    """A ``("data",)`` mesh, or one of named axes ``axis_names`` of sizes
    ``axis_sizes`` (row-major): ``devices[d]`` holds shard ``d``."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (AXIS,)
    axis_sizes: Tuple[int, ...] = ()

    def __post_init__(self):
        sizes = self.axis_sizes or (len(self.devices),)
        if len(sizes) != len(self.axis_names) \
                or int(np.prod(sizes)) != len(self.devices):
            raise ValueError(f"axes {self.axis_names} of sizes {sizes} do "
                             f"not cover {len(self.devices)} shards")
        object.__setattr__(self, "axis_sizes", tuple(sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def client_mesh(self, client_axes: Sequence[str]) -> "FedMesh":
        """The one-axis mesh of the clients along ``client_axes``: client
        ``cid`` (numbered row-major over those axes, as the reference's
        ``cid * axis_size(ax) + axis_index(ax)``) on the shard at its
        coordinates, index 0 on every other axis."""
        for a in client_axes:
            if a not in self.axis_names:
                raise ValueError(f"client axis {a!r} is not an axis of the "
                                 f"mesh {self.axis_names}")
        grid = np.arange(self.size).reshape(self.axis_sizes)
        index = tuple(slice(None) if a in client_axes else 0
                      for a in self.axis_names)
        kept = [a for a in self.axis_names if a in client_axes]
        order = [kept.index(a) for a in client_axes]
        ids = np.transpose(grid[index], order).reshape(-1)
        return FedMesh(tuple(self.devices[i] for i in ids))

    @property
    def first(self) -> torch.device:
        """Where replicated results (params, server state, psums) live."""
        return self.devices[0]

    def on(self, d: int):
        """Context that makes shard ``d``'s card the current CUDA device
        (nothing on a CPU shard)."""
        dev = self.devices[d]
        return torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()

    def bounds(self, rows: int) -> List[Tuple[int, int]]:
        """``[lo, hi)`` of each shard's row block of a ``rows``-row axis."""
        if rows % self.size:
            raise ValueError(
                f"a {rows}-row axis does not divide the mesh's data axis "
                f"({self.size}) — rows are never silently repartitioned")
        r = rows // self.size
        return [(d * r, (d + 1) * r) for d in range(self.size)]

    def split(self, x: Rows) -> List[Rows]:
        """Shard ``d``'s row block of ``x``: a host array gives host
        slices, a tensor gives tensors on the shard devices (views where
        the device is the same)."""
        parts = [x[lo:hi] for lo, hi in self.bounds(x.shape[0])]
        if isinstance(x, np.ndarray):
            return parts
        return [p.to(dev) for p, dev in zip(parts, self.devices)]

    def rows(self, x) -> List[torch.Tensor]:
        """A row-sharded operand: a list of shards as it is, a whole
        tensor split."""
        if isinstance(x, (list, tuple)):
            if len(x) != self.size:
                raise ValueError(f"{len(x)} shards for a mesh of "
                                 f"{self.size}")
            return list(x)
        return self.split(torch.as_tensor(x))

    def merge(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The shards back in global row order, on the first device."""
        return torch.cat([p.to(self.first) for p in parts])

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The port's ``psum``: the per-shard partials on the first device,
        added in shard order."""
        acc = parts[0].to(self.first)
        for p in parts[1:]:
            acc = acc + p.to(self.first)
        return acc

    def replicate(self, tree: Mapping[str, torch.Tensor]
                  ) -> List[Dict[str, torch.Tensor]]:
        """A replicated dict on every shard's device (no copy where it
        already lives there)."""
        return [{k: v.to(dev) for k, v in tree.items()}
                for dev in self.devices]

    def zeros(self, rows: int, cols: int, dtype=torch.float32
              ) -> List[torch.Tensor]:
        """A row-sharded ``(rows, cols)`` zero slab, each shard its own
        storage on its device."""
        return [torch.zeros((hi - lo, cols), dtype=dtype, device=dev)
                for (lo, hi), dev in zip(self.bounds(rows), self.devices)]

    def assign(self, shards: Sequence[torch.Tensor], full: torch.Tensor
               ) -> None:
        """Write a whole slab's rows into the shards, in place."""
        for s, part in zip(shards, self.split(full)):
            s.copy_(part)

    @staticmethod
    def _index(rows: np.ndarray, device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows, np.int64)) \
            .to(device)

    def gather_rows(self, src: Sequence[torch.Tensor], ids
                    ) -> List[torch.Tensor]:
        """``merge(src)[ids]`` split over the mesh: the rows of a
        row-sharded slab picked by global row id, shard ``d`` of the
        result holding ``ids``' ``d``-th block on its own device (a copy
        across devices where a row lives in another shard)."""
        ids = np.asarray(ids, np.int64)
        per = src[0].shape[0]
        out = []
        for (lo, hi), dev in zip(self.bounds(len(ids)), self.devices):
            want = ids[lo:hi]
            owner = want // per
            owners = np.unique(owner)
            if len(owners) == 1:
                # every row in one shard (always so for data=1): one
                # gather, one index copy to the device
                o = int(owners[0])
                out.append(src[o].index_select(0, self._index(
                    want % per, src[o].device)).to(dev))
                continue
            got = torch.empty((hi - lo,) + tuple(src[0].shape[1:]),
                              dtype=src[0].dtype, device=dev)
            for o in owners:
                sel = np.flatnonzero(owner == o)
                got[self._index(sel, dev)] = src[o][self._index(
                    want[sel] % per, src[o].device)].to(dev)
            out.append(got)
        return out

    def scatter_rows(self, dst: Sequence[torch.Tensor], dst_ids,
                     src: Sequence[torch.Tensor], src_rows) -> None:
        """``merged(dst)[dst_ids] = merged(src)[src_rows]`` in place, for
        two row-sharded slabs, row by global id (copies across devices
        where the two rows live in different shards)."""
        dst_ids = np.asarray(dst_ids, np.int64)
        src_rows = np.asarray(src_rows, np.int64)
        dper, sper = dst[0].shape[0], src[0].shape[0]
        for o in range(self.size):
            for d in range(self.size):
                sel = np.flatnonzero((src_rows // sper == o)
                                     & (dst_ids // dper == d))
                if not len(sel):
                    continue
                dst[d][self._index(dst_ids[sel] % dper, dst[d].device)] = \
                    src[o][self._index(src_rows[sel] % sper,
                                       src[o].device)].to(dst[d].device)


# ---------------------------------------------------------------------------
# the LM partition rules
# ---------------------------------------------------------------------------
class P(tuple):
    """A partition spec: one entry per tensor dim from the first, each
    ``None`` (whole), a mesh axis name, or a tuple of names (the dim split
    over their product, the first name outermost); missing trailing
    entries are ``None``.  ``P("data", None) == ("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# "megatron" (baseline): batch over (pod, data); params TP over "model" on
#   the feature dim + ZeRO over "data" — per-layer activation all-reduces.
# "fsdp": batch over ALL axes; params fully sharded over the flattened
#   mesh and all-gathered per use — the per-layer wire volume is params,
#   not activations.  Requires global_batch >= total chips.
# "tp" (decode): params sharded over "model" ONLY (replicated across
#   data) — decode steps stop re-gathering the whole model every token;
#   batch/caches stay on the data axes.
PROFILES = ("megatron", "fsdp", "tp")
_PROFILE = "megatron"


def set_profile(name: str) -> None:
    global _PROFILE
    assert name in PROFILES, name
    _PROFILE = name


def get_profile() -> str:
    return _PROFILE


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or a :class:`FedMesh`."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axes(mesh):
    """(data-like axes, model axis name) for this mesh and profile."""
    names = _axis_names(mesh)
    if _PROFILE == "fsdp":
        flat = tuple(n for n in names if n in ("pod", "data", "model"))
        return (flat if len(flat) > 1 else flat[0]), None
    model = "model" if "model" in names else None
    data = tuple(n for n in names if n in ("pod", "data"))
    if len(data) == 1:
        return data[0], model
    return data, model


def _model_size(mesh) -> int:
    return _mesh_sizes(mesh).get("model", 1)


def _divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _tree_paths(node, fn, path=()):
    """``fn("/".join(path), leaf)`` over a tree of dicts and lists, into a
    tree of the same structure."""
    if isinstance(node, Mapping):
        return {k: _tree_paths(v, fn, path + (str(k),))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_paths(v, fn, path + (str(i),))
                for i, v in enumerate(node)]
    return fn("/".join(path), node)


def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _reference_path(path: str) -> str:
    """A port leaf's path in the reference's tree: a unit's list index
    dropped (``layers/3/ffn/w_up`` -> ``layers/ffn/w_up``)."""
    parts = path.split("/")
    if len(parts) > 1 and parts[0] == "layers" and parts[1].isdigit():
        parts = parts[:1] + parts[2:]
    return "/".join(parts)


def _leaf_spec(path: str, leaf, cfg, dp, tp, mesh) -> P:
    """Name-based rule table, the reference's.  ``path`` is the leaf's
    '/'-joined keys in the reference's tree (:func:`_reference_path`);
    the leaf is one unit's, so it carries no stacked layer axis."""
    from repro_torch.configs.base import NTM
    body = _ndim(leaf)
    name = path.rsplit("/", 1)[-1]
    parent = path.rsplit("/", 2)[-2] if path.count("/") >= 1 else ""
    spec = P

    # ---- NTM (small, replicated-data-parallel) --------------------------
    if cfg.kind == NTM:
        if name == "beta":
            return P(None, tp)          # (K, V): vocab over model
        if name == "w" and body == 2:
            return P(None, tp)
        return P()

    # ---- norms / scalar-ish --------------------------------------------
    if body <= 1:
        return spec() if body == 0 else spec(None)

    # ---- embeddings ------------------------------------------------------
    if path == "embed/table":
        return P(tp, dp)                # (V, D)
    if path == "pos_embed":
        return P(None, tp)
    if path in ("lm_head/w", "pred_head/w"):
        return P(dp, tp)                # (D, V)
    if path == "frontend_proj/w":
        return P(dp, tp)

    # ---- MoE experts -----------------------------------------------------
    if name == "router":
        return spec(dp, None)           # (D, E) — E small, replicate
    if parent in ("ffn", "moe_sub/ffn") or "/ffn/" in path or \
            path.endswith(("w_gate", "w_up", "w_down")):
        if body == 3:                   # (E, D, F) expert-parallel
            if name == "w_down":
                return spec(tp, None, dp)
            return spec(tp, dp, None)
        if name == "w_down":            # (F, D)
            return spec(tp, dp)
        return spec(dp, tp)             # (D, F)

    # ---- attention -------------------------------------------------------
    if name in ("wq", "wk", "wv", "w_uq", "w_ukv", "w_dq", "w_dkv", "w_kr",
                "in_proj"):
        return spec(dp, tp)
    if name in ("wo", "out_proj"):
        return spec(tp, dp)
    if name == "conv_w":                # (W, ch) depthwise
        return spec(None, tp)

    # ---- fallback: shard the biggest dim over model ----------------------
    if body == 2:
        shape = _shape(leaf)
        return spec(dp, tp) if shape[-1] >= shape[-2] else spec(tp, dp)
    return spec(*([None] * body))


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = _mesh_sizes(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for e in entry:
            n *= sizes[e]
        return n
    return sizes[entry]


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop spec axes whose size doesn't divide the dim (as the
    reference's jit input shardings require), and trailing ``None``s."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        if dim % _axis_size(mesh, entry) == 0:
            out.append(entry)
            continue
        # try the individual axes of a tuple entry before giving up
        if isinstance(entry, (tuple, list)):
            kept = None
            for e in entry:
                if dim % _axis_size(mesh, e) == 0:
                    kept = e
                    break
            out.append(kept)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def param_partition_specs(cfg, mesh, params_shape) -> Any:
    """A :class:`P` per leaf of ``params_shape`` (tensors of any device,
    ``meta`` included; the tree's dicts and lists kept).  An optimizer
    state tree works too: a moment's leaf takes its parameter's spec
    (its path read past the state's own keys)."""
    dp, tp = _axes(mesh)
    pdp = None if _PROFILE == "tp" else dp   # tp: no data-axis sharding
    #   of parameters (replicated across data, sharded over model only)

    def to_spec(path, leaf):
        ref = _reference_path(path)
        for moment in ("mu/", "m/", "v/"):
            if ref.startswith(moment) and (
                    ref[len(moment):].split("/")[0] in _PARAM_ROOTS):
                ref = _reference_path(ref[len(moment):])
                break
        return sanitize_spec(_leaf_spec(ref, leaf, cfg, pdp, tp, mesh),
                             _shape(leaf), mesh)

    return _tree_paths(params_shape, to_spec)


# the top-level keys of an LM parameter tree (``models/transformer.py``)
_PARAM_ROOTS = ("layers", "embed", "lm_head", "final_norm", "frontend_proj",
                "mask_embed", "pos_embed", "pred_head")


def batch_partition_spec(cfg, mesh, batch_shape) -> Any:
    dp, tp = _axes(mesh)

    def to_spec(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if name == "mrope_positions":       # (3, B, S)
            spec = P(None, dp, None)
        elif name == "rng":
            spec = P()
        else:
            # default: leading dim is batch
            spec = P(dp, *([None] * (_ndim(leaf) - 1)))
        return sanitize_spec(spec, _shape(leaf), mesh)

    return _tree_paths(batch_shape, to_spec)


def cache_partition_specs(cfg, mesh, cache_shape, *,
                          seq_over_model_threshold: bool = True) -> Any:
    dp, tp = _axes(mesh)
    tp_size = _model_size(mesh)
    kv_on_heads = _divisible(cfg.num_kv_heads, tp_size)

    def to_spec(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if name == "pos":
            return P()
        if name in ("k", "v", "k2", "v2"):   # (nu, B, C, Hkv, hd)
            if kv_on_heads:
                return P(None, dp, None, tp, None)
            return P(None, dp, tp, None, None)   # shard the sequence
        if name in ("ckv", "kr"):            # (nu, B, C, r)
            if cfg.mla_absorb:
                # absorbed decode contracts r on-device; keep the latent
                # whole and shard batch only
                return P(None, dp, None, None)
            return P(None, dp, None, tp)
        if name == "conv":                   # (nu, B, W-1, ch)
            return P(None, dp, None, tp)
        if name == "ssm":                    # (nu, B, H, P, N)
            d_in = cfg.ssm.expand * cfg.d_model
            nh = d_in // cfg.ssm.head_dim
            if _divisible(nh, tp_size):
                return P(None, dp, tp, None, None)
            return P(None, dp, None, None, None)
        return P(*([None] * _ndim(leaf)))

    def sanitized(path, leaf):
        return sanitize_spec(to_spec(path, leaf), _shape(leaf), mesh)

    return _tree_paths(cache_shape, sanitized)


def placements(mesh, spec) -> list:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    per mesh dim, ``Shard(d)`` where the dim's axis name is in entry
    ``d``, else ``Replicate()``.  A tuple entry shards its tensor dim on
    each of its axes' mesh dims; DTensor nests those splits in mesh-dim
    order (the first mesh dim outermost), which is the reference's order
    whenever the tuple lists its axes in mesh order, as every rule here
    does.  A tuple out of mesh order gives the same local shard sizes
    with the blocks dealt to other devices (the reference's order there
    is DTensor's ``_StridedShard``)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in _axis_names(mesh)]
    names = _axis_names(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            out[names.index(name)] = Shard(d)
    return out


def _index_add_rules(self, dim, index, source, alpha=1):
    """``index_add`` (the MoE dispatch's scatter) on DTensor: whole, or
    sharded along a dim other than the indexed one, the same dim of
    ``self``, ``source`` and the output (the index whole).  The port's
    own rule: torches differ in what they plan for it."""
    from torch.distributed.tensor import Replicate, Shard
    r = Replicate()
    ndim = len(self.tensor_meta.shape)
    d = dim % ndim
    rules = [([r], [r, None, r, r, None])]
    for k in range(ndim):
        if k != d:
            rules.append(([Shard(k)], [Shard(k), None, r, Shard(k), None]))
    return rules


_ATEN_RULES = []


def _register_aten_rules() -> None:
    """The port's sharding rules for the aten operators it plans itself,
    once."""
    if _ATEN_RULES:
        return
    from torch.distributed.tensor.experimental import register_sharding
    register_sharding(torch.ops.aten.index_add.default)(_index_add_rules)
    _ATEN_RULES.append(True)


def shardings_for(mesh, specs) -> Any:
    """A tree of :class:`P` -> the tree of their DTensor placements on
    ``mesh`` (a ``torch.distributed`` ``DeviceMesh``)."""
    from repro_torch.kernels.ops import register_dtensor_rules
    register_dtensor_rules()
    _register_aten_rules()
    if isinstance(specs, P):
        return placements(mesh, specs)
    if isinstance(specs, Mapping):
        return {k: shardings_for(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return [shardings_for(mesh, v) for v in specs]
    return specs


# ---------------------------------------------------------------------------
# the ambient mesh and the in-model constraints
# ---------------------------------------------------------------------------
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_ambient_mesh", default=None)


@contextlib.contextmanager
def use_abstract_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh that
    :func:`get_abstract_mesh`, :func:`axis_size` and the ``constrain_*``
    hooks read, for the block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def get_abstract_mesh():
    """The ambient mesh, or ``None`` when no mesh is active."""
    return _AMBIENT.get()


def axis_size(axis_name) -> int:
    """The size of ``axis_name`` (or the product over a tuple of names)
    on the ambient mesh; 1 off-mesh."""
    mesh = get_abstract_mesh()
    return 1 if mesh is None else _axis_size(mesh, axis_name)


def _ambient():
    """(dp axes, model axis, sizes) from the ambient mesh, or
    (None, None, {}) when no mesh is active.  Respects the profile."""
    mesh = get_abstract_mesh()
    if mesh is None:
        return None, None, {}
    sizes = _mesh_sizes(mesh)
    if _PROFILE == "fsdp":
        dp = tuple(n for n in ("pod", "data", "model") if n in sizes)
        tp = None
    else:
        dp = tuple(n for n in ("pod", "data") if n in sizes)
        tp = "model" if "model" in sizes else None
    if not dp:
        dp = None
    elif len(dp) == 1:
        dp = dp[0]
    return dp, tp, sizes


def _fits(dim: int, entry, sizes) -> bool:
    if entry is None:
        return True
    es = entry if isinstance(entry, (tuple, list)) else (entry,)
    n = 1
    for e in es:
        n *= sizes[e]
    return dim % n == 0


def _constrain(x, spec):
    """``x`` redistributed to ``spec`` on the ambient mesh: the
    counterpart of ``with_sharding_constraint``.  A plain tensor (every
    path that builds no DTensor) passes through untouched."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def _off_mesh(x) -> bool:
    return get_abstract_mesh() is None or type(x) is torch.Tensor


def constrain_batch(x):
    """Pin dim 0 (batch) to the client/data axes — keeps the activations
    batch-sharded when params are FSDP-sharded."""
    if _off_mesh(x):
        return x
    dp, _, sizes = _ambient()
    if dp is None or not _fits(x.shape[0], dp, sizes):
        return x
    return _constrain(x, P(dp, *([None] * (x.ndim - 1))))


def constrain_groups(x, groups: int):
    """Pin dim 0 (batch) to the longest leading run of the data axes
    whose size divides ``groups`` (the MoE routing groups), whole over
    the rest, so that splitting the batch into the groups keeps each
    group on its own shards.  Where every data axis fits, this is
    :func:`constrain_batch`.  The reference leaves a batch sharded past
    its groups to GSPMD; DTensor cannot split a dim sharded over two
    mesh dims into a smaller one."""
    if _off_mesh(x):
        return x
    dp, _, sizes = _ambient()
    if dp is None:
        return x
    axes = dp if isinstance(dp, tuple) else (dp,)
    kept = ()
    for a in axes:
        if not (_fits(groups, kept + (a,), sizes)
                and _fits(x.shape[0], kept + (a,), sizes)):
            break
        kept += (a,)
    if not kept:
        return x
    entry = kept if len(kept) > 1 else kept[0]
    return _constrain(x, P(entry, *([None] * (x.ndim - 1))))


def constrain_lookup(x):
    """The token embedding's lookup output: batch-sharded where the batch
    fits the data axes (:func:`constrain_batch`), and its partial sums
    reduced at once either way.  A vocab-sharded lookup leaves partial
    sums tied to the lookup's mask, which some torches' DTensor cannot
    carry into later operations."""
    from torch.distributed.tensor import Partial, Replicate
    if _off_mesh(x):
        return x
    x = constrain_batch(x)
    placed = getattr(x, "placements", ())
    if any(isinstance(p, Partial) for p in placed):
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p for p in placed])
    return x


def constrain_heads(x, head_axis: int):
    """Shard dim 0 (batch) on the data axes and ``head_axis`` on model —
    keeps the MLA-absorbed decode head-parallel."""
    if _off_mesh(x):
        return x
    dp, tp, sizes = _ambient()
    if dp is None:
        return x
    spec = [None] * x.ndim
    if _fits(x.shape[0], dp, sizes):
        spec[0] = dp
    if tp and _fits(x.shape[head_axis], tp, sizes):
        spec[head_axis] = tp
    if all(e is None for e in spec):
        return x
    return _constrain(x, P(*spec))


def constrain_expert_rows(x):
    """Shard dim 0 (the flattened expert*capacity rows of the MoE dispatch
    buffer) over the model axis — the scatter becomes the MoE all-to-all
    instead of a replicated buffer + all-reduce."""
    if _off_mesh(x):
        return x
    _, tp, sizes = _ambient()
    if tp is None or not _fits(x.shape[0], tp, sizes):
        return x
    return _constrain(x, P(tp, *([None] * (x.ndim - 1))))


def constrain_batch_and_last(x):
    """Batch on data axes, trailing (feature/vocab) dim on model."""
    if _off_mesh(x):
        return x
    dp, tp, sizes = _ambient()
    if dp is None:
        return x
    first = dp if _fits(x.shape[0], dp, sizes) else None
    last = tp if (tp and _fits(x.shape[-1], tp, sizes)) else None
    if first is None and last is None:
        return x
    return _constrain(x, P(first, *([None] * (x.ndim - 2)), last))


# ---------------------------------------------------------------------------
# resharding where DTensor refuses
# ---------------------------------------------------------------------------
def _fallback_placements(spec, keep: int):
    """``spec`` with its batch shards (``Shard(0)``) kept on at most
    ``keep`` mesh dims, the outermost first, and whole elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    new = []
    for p in spec.placements:
        batch = type(p) is Shard and p.dim == 0
        new.append(p if batch and keep > 0 else Replicate())
        keep -= batch
    return DTensorSpec(spec.mesh, tuple(new), tensor_meta=spec.tensor_meta)


def _map_specs(node, fn):
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    if isinstance(node, DTensorSpec):
        return fn(node)
    if isinstance(node, (list, tuple)):
        return type(node)(_map_specs(v, fn) for v in node)
    if isinstance(node, dict):
        return {k: _map_specs(v, fn) for k, v in node.items()}
    return node


def _first_spec(schema):
    """The first DTensor operand's spec of an operator's schema."""
    found = []
    _map_specs((schema.args_schema, schema.kwargs_schema),
               lambda s: found.append(s) or s)
    return found[0]


def _mesh_ndim(schema) -> int:
    return _first_spec(schema).mesh.ndim


_VIEWS = ("aten::view", "aten::_unsafe_view")


def _view_keeps_size(schema, out) -> bool:
    """False for a view DTensor plans with a local output of another size
    than its local input (it can split a dim sharded over two mesh dims
    into a smaller one as if the second split were not there)."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    if schema.op.name() not in _VIEWS \
            or not isinstance(out.output_spec, DTensorSpec):
        return True
    from torch.distributed.tensor import Replicate, Shard
    src = (out.redistribute_schema or schema).args_schema[0]
    dst = out.output_spec
    if any(type(p) not in (Shard, Replicate)
           for p in tuple(src.placements) + tuple(dst.placements)):
        return True     # strided or partial: DTensor's own sizes hold

    def local(spec):
        """Rank 0's local elements (``torch.chunk``'s split: the first
        shard is the largest)."""
        shape = list(spec.shape)
        for size, p in zip(spec.mesh.shape, spec.placements):
            if type(p) is Shard:
                shape[p.dim] = -(-shape[p.dim] // size)
        n = 1
        for d in shape:
            n *= d
        return n
    return local(src) == local(dst)


def _shard_to_partial(schema, out) -> bool:
    """True where the plan redistributes a sharded operand to partial
    sums, which some torches' DTensor cannot do (a tied embedding's two
    gradients meet so)."""
    from torch.distributed.tensor import Partial, Shard
    if out.redistribute_schema is None:
        return False
    src, dst = [], []
    _map_specs(schema.args_schema, lambda x: src.append(x) or x)
    _map_specs(out.redistribute_schema.args_schema,
               lambda x: dst.append(x) or x)
    return any(isinstance(a, Shard) and isinstance(b, Partial)
               for s_, d_ in zip(src, dst)
               for a, b in zip(s_.placements, d_.placements))


def _replicated(prop, schema):
    """The output sharding of an operator DTensor has no strategy for, run
    on whole (replicated) operands: its outputs whole too, with the
    metadata DTensor's own propagation computes.  None where it cannot."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._op_schema import OutputSharding
    try:
        meta = prop._propagate_tensor_meta_non_cached(schema)
    except Exception:   # noqa: BLE001
        return None
    mesh = _first_spec(schema).mesh
    whole = (Replicate(),) * mesh.ndim

    def spec(m):
        return None if m is None else DTensorSpec(mesh, whole, tensor_meta=m)
    out = type(meta)(spec(m) for m in meta) \
        if isinstance(meta, (list, tuple)) \
        and not isinstance(meta, TensorMeta) else spec(meta)
    return OutputSharding(out, redistribute_schema=schema,
                          needs_redistribute=True)


@contextlib.contextmanager
def reshard_on_refusal():
    """Within the block, an operation whose operands' placements DTensor
    has no rule for (a view that would split a sharded dim unevenly, an
    operator without a strategy) is not refused: its DTensor operands are
    redistributed, first to their batch shards only (``Shard(0)`` kept,
    every other placement replicated), then to the outermost batch shard,
    then whole, and the operation runs there (an operator with no
    strategy at all runs whole, its outputs whole).  A view DTensor plans
    with a local output of another size than its input counts as
    refused, and so does a plan that would redistribute a shard to
    partial sums.  GSPMD reshards so on its own; DTensor asks its caller
    to.  The
    redistributions are real collectives of the traced step (counted by
    ``launch.analysis.StepTrace``).  Yields ``{operator: the distinct
    operand placements resharded}`` (DTensor caches a decision, so a
    repeat is not seen again)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import OpSchema

    prop = DTensor._op_dispatcher.sharding_propagator
    saved = (prop.propagate_op_sharding, prop.propagate_op_sharding_non_cached)
    plain = saved[1]        # uncached: the C++ side caches the result
    refused: Dict[str, int] = {}

    def attempt(schema):
        out = plain(schema)
        if not _view_keeps_size(schema, out):
            raise ValueError("a view whose local sizes disagree")
        if _shard_to_partial(schema, out):
            raise ValueError("a shard redistributed to partial sums")
        return out

    def propagate(schema):
        try:
            return attempt(schema)
        except NotImplementedError:
            if torch._C._dispatch_has_kernel_for_dispatch_key(
                    schema.op.name(),
                    torch._C.DispatchKey.CompositeImplicitAutograd):
                raise       # DTensor decomposes these itself
            first = sys.exc_info()
        except Exception:   # noqa: BLE001 — any refusal: reshard, retry
            first = sys.exc_info()
        for keep in (_mesh_ndim(schema), 1, 0):
            moved = OpSchema(
                schema.op,
                _map_specs(schema.args_schema,
                           lambda s: _fallback_placements(s, keep)),
                _map_specs(schema.kwargs_schema,
                           lambda s: _fallback_placements(s, keep)))
            try:
                out = attempt(moved)
            except Exception:   # noqa: BLE001
                if keep:
                    continue
                # no strategy at all: run it on the whole operands
                out = _replicated(prop, moved)
                if out is None:
                    raise first[1].with_traceback(first[2]) from None
            if out.redistribute_schema is None:
                out.redistribute_schema = moved
            out.needs_redistribute = True
            name = str(schema.op)
            refused[name] = refused.get(name, 0) + 1
            return out
        raise first[1].with_traceback(first[2])

    prop.propagate_op_sharding = propagate
    prop.propagate_op_sharding_non_cached = propagate
    try:
        yield refused
    finally:
        prop.propagate_op_sharding, prop.propagate_op_sharding_non_cached = \
            saved
