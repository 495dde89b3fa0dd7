"""The port's CUDA kernels and service on a card (skipped without one).

This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (the plain versions are held against the JAX reference by the
CPU tests), and a small service run on the card against the same run on
the CPU.  ``chip_smoke.py`` repeats these checks at the service's full
width.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import FederationSpec, max_param_dev, scenario_spec
from repro_torch.kernels import ref
from repro_torch.kernels.fed_aggregate import fed_weighted_sum_cuda
from repro_torch.kernels.topic_decoder import topic_decoder_cuda
from repro_torch.serve import FederationService, run_traffic

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py checks them on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(5, 300), (1, 7), (13, 1000), (3, 129),
                                 (2, 775_500)])
def test_weighted_sum_kernel_matches_plain(cuda_device, dtype, k, d, rng):
    x = rng.standard_normal((k, d)).astype(np.float32)
    w = rng.uniform(0, 2, k).astype(np.float32)
    w[rng.random(k) < 0.4] = 0.0
    x[w == 0.0] = np.nan          # zero-weight rows may hold garbage
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    wt = torch.from_numpy(w).to(cuda_device)
    total = max(float(w.sum()), 1e-12)
    got = fed_weighted_sum_cuda(xt, wt) / total
    want = ref.fed_weighted_sum_ref(xt, wt) / total
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("b,k,v", [(130, 8, 1100), (5, 4, 513), (2, 2, 17),
                                   (256, 50, 5000), (300, 512, 4999)])
def test_topic_decoder_kernel_matches_plain(cuda_device, b, k, v, rng):
    theta = torch.softmax(torch.from_numpy(
        rng.standard_normal((b, k)).astype(np.float32)), -1)
    beta = torch.from_numpy(rng.standard_normal((k, v)).astype(np.float32))
    bow = torch.from_numpy(rng.poisson(0.2, (b, v)).astype(np.float32))
    bow[0] = 0.0                  # a zero-bow document
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, v).astype(np.float32))
    theta, beta, bow, sc = (t.to(cuda_device) for t in (theta, beta, bow,
                                                        sc))
    got = topic_decoder_cuda(theta, beta, bow, sc)
    want = ref.topic_decoder_ref(theta, beta, bow, sc)
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-5)
    assert float(got[0]) == 0.0


def test_service_on_card_matches_cpu(cuda_device):
    base = FederationSpec.from_dict({
        "model": {"vocab": 64, "topics": 4, "hidden": 16},
        "data": {"num_clients": 3, "docs_per_node": 40,
                 "val_docs_per_node": 8},
        "execution": {"batch_size": 64, "learning_rate": 2e-4}})
    spec = scenario_spec("buffered_async", base)
    runs = []
    for dev in ("cpu", cuda_device):
        svc = FederationService.from_spec(spec, device=dev)
        stats = run_traffic(svc, sweeps=4, order_seed=1, hold_prob=0.3,
                            duplicate_prob=0.3, infer_every=2)
        svc.shutdown()
        runs.append((svc, stats["aggregations"], svc.rejections,
                     svc.evaluate()["heldout_elbo_per_token"]))
    (cpu, n_cpu, rej_cpu, e_cpu), (gpu, n_gpu, rej_gpu, e_gpu) = runs
    assert n_cpu == n_gpu >= 3 and rej_cpu == rej_gpu
    assert max_param_dev(cpu.fetch_model()[1], gpu.fetch_model()[1]) <= 1e-5
    assert abs(e_gpu - e_cpu) <= 1e-5 * abs(e_cpu)
