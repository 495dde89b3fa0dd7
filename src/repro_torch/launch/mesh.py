"""Production and host meshes, and the roofline's hardware constants.

``make_production_mesh`` is a FUNCTION (never a module-level constant):
it builds the reference's production mesh, ``(16, 16)`` over
``("data", "model")`` or ``(2, 16, 16)`` over ``("pod", "data",
"model")``, as a ``torch.distributed`` ``DeviceMesh`` over the ``fake``
process-group backend (``FakeStore``): every collective returns at once
and moves nothing, so one host process can trace a step of 256 or 512
ranks on fake tensors (``launch/dryrun.py``).  The process group is the
process's own, so a process that calls it runs nothing else — the
counterpart of the reference's forced 512 host devices, which the
reference's dry run also keeps to its own process.

``make_host_mesh`` is the port's :class:`~repro_torch.parallel.sharding.
FedMesh` over two named axes: the visible cards, or logical CPU shards
when the caller asks for the CPU.

The constants are an NVIDIA H100 80GB HBM3 (SXM5, 700 W) card's, from
NVIDIA's datasheet — figures, not measurements:

* ``PEAK_FLOPS_BF16``: 989.4 TFLOP/s, dense bf16 on the tensor cores;
* ``HBM_BW``: 3.35 TB/s of HBM3;
* ``ICI_BW_PER_LINK``: the bytes a second each chip moves in a
  collective along a mesh axis, 50 GB/s: one 400 Gb/s NDR InfiniBand
  NIC a GPU.  A 16-wide axis leaves the 8-GPU NVLink domain, so the NIC
  bounds it.  One constant for every axis, as the reference's roofline
  has (its name kept, so that reports read alike); an NVLink tier is
  not modelled.
"""
from __future__ import annotations

import math

import torch

PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s, dense bf16 (H100 SXM5 datasheet)
HBM_BW = 3.35e12                # bytes/s, HBM3 (H100 SXM5 datasheet)
ICI_BW_PER_LINK = 50e9          # bytes/s/chip, one 400 Gb/s NDR NIC a GPU

CARD = "NVIDIA H100 80GB HBM3 (SXM5), 700 W"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16=256 ranks ("data","model").
    Multi-pod: 2x16x16=512 ranks ("pod","data","model") — the "pod" axis
    is the inter-pod federation tier.  Starts the process's ``fake``
    process group (rank 0 of 256 or 512) if none is running; a running
    group of another size is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    elif dist.get_world_size() != world:
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks is running; "
            f"the {shape} mesh needs {world}: build each production mesh "
            "in a process of its own")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 2, model: int = 2, device=None):
    """Small ``("data", "model")`` mesh (tests / examples): over the
    visible cards (``device`` None or ``cuda``), clipped as the
    reference clips to its devices, or ``data x model`` logical shards of
    the CPU (``device="cpu"``)."""
    from repro_torch.parallel.sharding import FedMesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return FedMesh((dev,) * (data * model), ("data", "model"),
                       (data, model))
    if dev.type != "cuda":
        raise ValueError(f"make_host_mesh has no shards for device {dev}")
    n = torch.cuda.device_count()
    if n < 1:
        raise ValueError("make_host_mesh: no CUDA device is visible; pass "
                         "device='cpu' for logical CPU shards")
    data = min(data, n)
    model = max(min(model, n // data), 1)
    return FedMesh(tuple(torch.device("cuda", i)
                         for i in range(data * model)),
                   ("data", "model"), (data, model))
