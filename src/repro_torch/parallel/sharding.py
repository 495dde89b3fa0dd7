"""The federation's ``("data",)`` device mesh: row blocks, one per shard.

Port of the federation half of ``repro/parallel/sharding.py``
(``fed_mesh``, and what ``shardings_for(mesh, P("data"))`` does to the
engine's client axes).  The reference is single-controller SPMD: one
process holds a mesh over the first ``data`` local devices, the stacked
``(K, ...)`` cohort, the ``(L, ...)`` per-client transform state and the
``(C, ...)`` straggler ring are split into contiguous row blocks (shard
``d`` holds rows ``[d*R/data, (d+1)*R/data)``), params and server state
are replicated, per-row stages run per shard and every cross-row sum is
per-shard partials plus one ``psum``.  :class:`FedMesh` keeps that shape
in one process with no ``torch.distributed`` job: a row-sharded slab is
a list of ``data`` tensors, shard ``d``'s on ``devices[d]``; the port's
``psum`` brings the partials to the first device and adds them in shard
order; a replicated value lives on the first device and is copied to a
shard's device where that shard needs it (a no-op on the same device).

On CUDA the mesh is the first ``data`` visible cards.  On the CPU, which
a caller asks for explicitly (the tests do), it is ``data`` logical
shards of the one host device, the counterpart of the reference's forced
host device count.  ``data=1`` is a real one-shard mesh: the sharded code
path with no cross-device traffic.

The LM partition rules of the reference module (``param_partition_specs``,
``batch_partition_spec``, ``cache_partition_specs``, the ``constrain_*``
hooks) belong to the launch-sizing half of ROADMAP.md item A17 and are
not ported.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple, Union

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
    """A ``("data",)`` mesh: ``devices[d]`` holds shard ``d``."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS: self.size}

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
