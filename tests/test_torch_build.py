"""The kernel loader under threads, with a fake compiler on the CPU.

``kernels/_build.py`` compiles every CUDA source at the first ``load``.
Threads of one process that reach their first kernel together (the wire
server's reader pool and its aggregation thread) must compile each
source once and share the result: without the loader's lock they would
all start ``nvcc`` into the same temporary file and one ``os.replace``
would fail.  ``nvcc``, ``subprocess.Popen`` and ``ctypes.CDLL`` are
stubbed, so the test runs where no CUDA toolkit is.
"""
import os
import threading
import time

import pytest
import torch

from repro_torch.kernels import _build

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))


class _FakeNvcc:
    """Stands in for one ``nvcc`` process: writes its ``-o`` target
    after a short compile, as the real one does."""
    calls = []
    lock = threading.Lock()

    def __init__(self, args, **_kw):
        self.out = args[args.index("-o") + 1]
        self.returncode = 0
        with self.lock:
            self.calls.append(os.path.basename(args[-1]))

    def communicate(self):
        time.sleep(0.02)
        with open(self.out, "wb") as f:
            f.write(b"\x7fELF fake")
        return "ptxas info: fake", None


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    _FakeNvcc.calls = []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/fake/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    return tmp_path / "build"


def test_load_from_8_threads_compiles_each_source_once(fake_toolchain):
    names = [_build.SOURCES[i % len(_build.SOURCES)] for i in range(8)]
    barrier = threading.Barrier(len(names))
    got, errors = {}, []

    def first_kernel(i, name):
        try:
            barrier.wait(timeout=30)
            got[i] = _build.load(name)
        except Exception as e:          # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_kernel, args=(i, n))
               for i, n in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert sorted(_FakeNvcc.calls) == sorted(f"{n}.cu"
                                             for n in _build.SOURCES)
    for i, name in enumerate(names):
        assert got[i] == ("lib", str(_build._target(name)[1]))
    built = sorted(p.name for p in fake_toolchain.iterdir())
    assert len(built) == len(_build.SOURCES)
    assert not any(n.endswith(".tmp") for n in built)
    # a second round of loads is served from the cache, nothing rebuilds
    assert _build.load(names[0]) is got[0]
    assert len(_FakeNvcc.calls) == len(_build.SOURCES)
