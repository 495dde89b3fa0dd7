"""The buffered-async aggregation buffer (FedBuff), one flat slab.

Port of ``repro/serve/buffer.py``.  The M slots live in ONE ``(M, D)``
fp32 tensor on the device (``core/engine.py:init_delta_buffer``), each
parameter a column range of it, so the Eq. (2) combine over the slots
is a single kernel launch; :attr:`leaves` gives the per-leaf ``(M,
...)`` views of the reference's layout.  Per-slot weight, client and
base version are host arrays.

Invariants (the service's contract):

* one slot per client — a newer upload overwrites the client's occupied
  slot in place (the service records the displaced delta ``superseded``);
* slots fill densely (``0..count-1``) and reset together at aggregation;
* free slots carry weight 0 / client -1 and KEEP their stale payload —
  the combine's mask on ``weight > 0`` is what keeps them out.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import host, to_tree, tree_get
from repro_torch.core.engine import flat_layout, init_delta_buffer


class DeltaBuffer:
    """Fixed-capacity flat delta buffer (one slot per client)."""

    def __init__(self, params_template: Mapping[str, torch.Tensor],
                 capacity: int):
        self.capacity = int(capacity)
        self._buf = init_delta_buffer(params_template, self.capacity,
                                      int_fields={"base_version": -1})
        self._layout = flat_layout(params_template)
        flat = self._buf["delta"]
        self.leaves: Dict[str, torch.Tensor] = {
            name: flat[:, off:off + n].unflatten(1, shape)
            for name, shape, off, n in self._layout}
        self.count = 0

    @property
    def full(self) -> bool:
        return self.count >= self.capacity

    def slot_of(self, client: int) -> int:
        """Occupied slot holding this client's in-flight delta, or -1."""
        hits = np.nonzero(self._buf["client"][:self.count] == int(client))[0]
        return int(hits[0]) if hits.size else -1

    def insert(self, delta: Mapping[str, torch.Tensor], weight: float,
               client: int, base_version: int, *, slot: int = -1) -> int:
        """Write a delta into ``slot`` (-1 = next free), return the slot."""
        s = self.count if slot < 0 else int(slot)
        if s >= self.capacity:
            raise RuntimeError(
                f"DeltaBuffer overflow: slot {s} of capacity "
                f"{self.capacity} — the service must aggregate when the "
                "buffer fills, inserts past M are a control-flow bug")
        for name, view in self.leaves.items():
            view[s].copy_(delta[name])
        self._buf["weight"][s] = weight
        self._buf["client"][s] = client
        self._buf["base_version"][s] = base_version
        if slot < 0:
            self.count += 1
        return s

    def reset(self) -> None:
        """Free every slot (weight 0 / client -1); payloads stay."""
        self._buf["weight"][:] = 0.0
        self._buf["client"][:] = -1
        self._buf["base_version"][:] = -1
        self.count = 0

    def stacked(self) -> Tuple[torch.Tensor, np.ndarray, np.ndarray,
                               np.ndarray]:
        """``(deltas (M, D), weights, clients, base_versions)`` — all M
        slots, free ones weight-0-masked downstream."""
        b = self._buf
        return b["delta"], b["weight"], b["client"], b["base_version"]

    # -- snapshot ------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The reference's buffer snapshot: the slots' deltas as its tree
        of ``(M, ...)`` stacked leaves, the per-slot arrays as they
        are."""
        buf = {k: np.array(v) for k, v in self._buf.items() if k != "delta"}
        buf["delta"] = to_tree({name: host(v) for name, v
                                in self.leaves.items()})
        return {"capacity": self.capacity, "count": self.count, "buf": buf}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        if int(state["capacity"]) != self.capacity:
            raise ValueError(
                f"snapshot buffer capacity {state['capacity']} != this "
                f"buffer's {self.capacity}; rebuild the service from the "
                "snapshot's spec")
        buf = state["buf"]
        for name, view in self.leaves.items():
            view.copy_(torch.from_numpy(np.array(tree_get(buf["delta"], name),
                                                 np.float32)))
        for k in ("weight", "client", "base_version"):
            self._buf[k][:] = np.asarray(buf[k])
        self.count = int(state["count"])

    def unflatten(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A ``(D,)`` vector in the buffer's layout -> per-leaf views."""
        return {name: vec[off:off + n].view(shape)
                for name, shape, off, n in self._layout}
