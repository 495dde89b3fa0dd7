"""PyTorch + CUDA port of the federated neural topic model system.

A package of its own beside the JAX reference (``src/repro/``), mirroring
its layout module for module: ``repro_torch/serve/service.py`` is the
port of ``repro/serve/service.py``.  It imports ``torch``, numpy and the
standard library only — never ``jax`` and nothing of ``repro``.

Device rule: entry points take an explicit ``device`` and run on
``cuda`` unless the caller passes ``device="cpu"``.  Kernel dispatch
follows the tensor: a CUDA tensor runs the hand-written Hopper kernel
(``kernels/csrc/``), a CPU tensor runs its plain PyTorch version.
"""
