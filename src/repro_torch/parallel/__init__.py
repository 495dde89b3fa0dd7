"""Device layout of the federation: the ``("data",)`` mesh
(:mod:`repro_torch.parallel.sharding`)."""
from repro_torch.parallel.sharding import FedMesh, fed_mesh

__all__ = ["FedMesh", "fed_mesh"]
