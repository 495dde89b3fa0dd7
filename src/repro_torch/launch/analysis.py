"""What a traced step costs: collective bytes, memory, roofline terms.

The port's counterpart of the reference's ``launch/analysis.py``, which
reads the compiled XLA program (``cost_analysis``, the optimized HLO's
collectives, ``memory_analysis``).  The port compiles nothing: the dry
run (``launch/dryrun.py``) runs the step eagerly on fake DTensors over a
fake process group, and :class:`StepTrace`, a dispatch mode under
DTensor, sees every local operation and collective the step issues:

* collective bytes: each functional collective (``all_gather_into_tensor``,
  ``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single``, and
  their coalesced forms) priced by the reference's ring model
  (:func:`wire_bytes`) at its group's size;
* memory: the bytes of every storage the step allocates, live until
  Python frees it, and its peak (:meth:`StepTrace.memory_dict`).

Roofline terms (seconds), NVIDIA H100 constants from ``launch.mesh``:
    compute    = FLOPs       / 989.4e12
    memory     = HBM bytes   / 3.35e12
    collective = coll bytes  / 50e9
each per device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary, weakref

from repro_torch.launch.mesh import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collectives by name -> the reference's opcode
_OPCODE = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # DTensor's own, on one mesh dim
}


def wire_bytes(opcode: str, result_bytes: float, group: int) -> float:
    """Per-device wire bytes of one collective (ring algorithms), the
    reference's model over the result's bytes ``r``:

      all-reduce:          2 * r * (g-1)/g
      all-gather:          r * (g-1)/g      (r = gathered)
      reduce-scatter:      r * (g-1)        (r = the scattered shard)
      all-to-all:          r * (g-1)/g
      collective-permute:  r
    """
    g = max(int(group), 1)
    frac = (g - 1) / g
    if opcode == "all-reduce":
        return 2.0 * result_bytes * frac
    if opcode == "reduce-scatter":
        return result_bytes * (g - 1)
    if opcode == "collective-permute":
        return float(result_bytes)
    return result_bytes * frac


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace(TorchDispatchMode):
    """Counts the collectives and the storage of the local operations
    under DTensor (a DTensor operation returns ``NotImplemented`` here,
    so DTensor runs first and this mode sees what it lowers to, as
    ``CommDebugMode`` does).  ``collectives[opcode]`` is wire bytes per
    device, ``counts[opcode]`` calls; ``live``/``peak`` the bytes of the
    storages the traced operations made, while alive.  The storages of
    ``inputs`` (the step's arguments, local shards) were there before the
    step: a view of one makes no storage."""

    def __init__(self, inputs=None):
        super().__init__()
        self.collectives: Dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
        self.counts: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in _local_tensors(inputs):
            self._seen[t.untyped_storage()] = None
        self._quiet = 0
        self._saved = None

    def __enter__(self):
        # DTensor's sharding propagation runs each new operation once on
        # fake tensors of the GLOBAL shapes, for its output's metadata:
        # nothing the step allocates, so nothing this mode counts
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        self._saved = (prop.propagate_op_sharding,
                       prop.propagate_op_sharding_non_cached)

        def quiet(fn):
            def run(schema):
                self._quiet += 1
                try:
                    return fn(schema)
                finally:
                    self._quiet -= 1
            return run
        prop.propagate_op_sharding = quiet(self._saved[0])
        prop.propagate_op_sharding_non_cached = quiet(self._saved[1])
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        prop.propagate_op_sharding, prop.propagate_op_sharding_non_cached = \
            self._saved
        return super().__exit__(*exc)

    def _freed(self, nbytes, _ref):
        self.live -= nbytes

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = weakref.ref(st, lambda r, n=n: self._freed(n, r))
            self.live += n
        self.peak = max(self.peak, self.live)

    def _count(self, func, args, out) -> None:
        opcode = _OPCODE.get(func._overloadpacket.__name__)
        if opcode is None or func.namespace not in (
                "_c10d_functional", "c10d_functional", "_dtensor"):
            return
        group = _group_size(args[-1])
        result = sum(_nbytes(t) for t in _tensors(out))
        self.collectives[opcode] += wire_bytes(opcode, result, group)
        self.counts[opcode] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        self._count(func, args, out)
        self._track(out)
        return out

    def breakdown(self) -> Dict[str, int]:
        """The reference's ``parse_collective_bytes`` dict."""
        out = {c: int(self.collectives[c]) for c in _COLLECTIVES}
        out["total"] = sum(out[c] for c in _COLLECTIVES)
        return out

    def memory_dict(self, argument_bytes: float, output_bytes: float
                    ) -> Dict[str, float]:
        """The keys of the reference's ``memory_analysis_dict``: arguments
        (the local shards of params, optimizer state, batch or cache),
        outputs (the step's results, local shards), temp (the peak of the
        step's own live storage, less its outputs) and their total."""
        temp = max(float(self.peak) - output_bytes, 0.0)
        return {"argument_size_in_bytes": float(argument_bytes),
                "output_size_in_bytes": float(output_bytes),
                "temp_size_in_bytes": temp,
                "alias_size_in_bytes": 0.0,
                "total_bytes": float(argument_bytes) + output_bytes + temp}


def _local_tensors(tree) -> Iterable[torch.Tensor]:
    """A tree's tensors, a DTensor by its local shard."""
    from torch.distributed.tensor import DTensor
    return (t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree))


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors (a DTensor's local
    tensor, a plain tensor whole), each storage once."""
    seen, n = {}, 0      # the storages held, so that no id is reused
    for t in _local_tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen[id(st)] = st
            n += _nbytes(t)
    return n


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per-device FLOPs (the analytic model)
    hlo_bytes: float            # per-device HBM bytes (the analytic model)
    collective_bytes: float     # per-device wire bytes
    collective_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0    # 6*N*D (active params x tokens)
    memory_per_device: Dict[str, float] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / ICI_BW_PER_LINK

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs x chips) — remat/redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_device": self.hlo_flops,
            "hlo_bytes_per_device": self.hlo_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_breakdown": self.collective_breakdown,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "memory_per_device": self.memory_per_device,
        }
