"""Build-at-first-use loader for the port's CUDA sources.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
to ``kernels/build/`` (listed in ``.gitignore``) under a name keyed on a
hash of the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edit of any of them triggers a rebuild.  The
first load builds every missing library at once, one ``nvcc`` process
per source, all started together.  A failed build raises; nothing falls
back to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
SOURCES = ("fed_aggregate", "topic_decoder", "fed_dp_secure", "fed_topk_ef",
           "flash_attention", "ssd_scan", "flash_attention_bwd",
           "ssd_scan_bwd")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of the parallel build, "log": nvcc output}
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from kernels/csrc/ at first use")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    # every header of csrc/ too, so an edited shared header rebuilds
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{key}.so"


def build(names=SOURCES) -> Dict[str, Dict[str, object]]:
    """Compile every library in ``names`` that is missing, in parallel;
    returns :data:`BUILD_LOG`.  Raises with nvcc's output on failure."""
    todo = [(n, *_target(n)) for n in names if not _target(n)[1].exists()]
    if not todo:
        return BUILD_LOG
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name, src, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib
