"""The port's CUDA kernels and service on a card (skipped without one).

This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (the plain versions are held against the JAX reference by the
CPU tests): B1, B2, B5 and B6 within their bounds, B3 and B4 bitwise; the backward
kernels of B5 and B6 against their plain backward passes, and bitwise
from call to call.
A small service run, small synchronous training runs (the
``pallas-topk``, ``pallas-secure`` and ``dp-transform`` specs on the
batched cohort path), Algorithm 1 on the host loop (the ``paper`` and
``straggler-heavy`` specs, ``FederatedTrainer``, and each message
transform on the loop and in the service), a reduced
hymba-1.5b prefill + decode and its ``train_loss`` gradients on the card
are held against the same runs on the CPU.  ``chip_smoke.py``
repeats these checks at the full ProdLDA and hymba-1.5b widths.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import (Federation, FederationSpec, max_param_dev,
                             scenario_spec)
from repro_torch.configs import get_config
from repro_torch.configs.base import FederatedConfig
from repro_torch.core.ntm import prodlda
from repro_torch.core.protocol import ClientState, FederatedTrainer
from repro_torch.kernels import (fed_aggregate, flash_attention, ops, ref,
                                 ssd_scan)
from repro_torch.optim import sgd
from repro_torch.kernels.fed_aggregate import (fed_dp_secure_apply_cuda,
                                               fed_topk_ef_cuda,
                                               fed_weighted_sum_cuda)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.topic_decoder import grid, topic_decoder_cuda
from repro_torch.models import transformer as tfm
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


# the evaluate shape, and the tile edges of the one-launch kernel (32
# documents x 128 words a block): B and V one past and one short of a
# tile, exact tiles, K = 1 and 512
@pytest.mark.parametrize("b,k,v", [(130, 8, 1100), (5, 4, 513), (2, 2, 17),
                                   (256, 50, 5000), (300, 512, 4999),
                                   (33, 1, 129), (95, 512, 383),
                                   (64, 50, 256), (1, 1, 1)])
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


def test_topic_decoder_kernel_repeats_bitwise(cuda_device, rng):
    """The last block of each document tile merges and resets its
    counter: back-to-back calls, and a larger batch between them, give
    the same bits."""
    theta = torch.softmax(torch.from_numpy(
        rng.standard_normal((100, 50)).astype(np.float32)), -1)
    beta = torch.from_numpy(rng.standard_normal((50, 700)).astype(
        np.float32))
    bow = torch.from_numpy(rng.poisson(0.2, (100, 700)).astype(np.float32))
    theta, beta, bow = (t.to(cuda_device) for t in (theta, beta, bow))
    first = topic_decoder_cuda(theta, beta, bow)
    big = topic_decoder_cuda(theta.repeat(40, 1), beta, bow.repeat(40, 1))
    again = topic_decoder_cuda(theta, beta, bow)
    assert torch.equal(first, again)
    assert torch.equal(big[:100], first)


def test_topic_decoder_kernel_two_streams_bitwise(cuda_device):
    """Two B1 calls in flight at once on two streams, on different
    inputs (different document- and vocabulary-tile counts): each result
    is bitwise the same call made alone, over many rounds, so a shared
    arrival counter (fault C2) would show as a tile merged before its
    partials exist, or never merged.

    Both calls are held behind one gate, a sleep kernel on the main
    stream that both streams wait on, so the two launches are pending
    together and start together; the two grids (160 and 105 blocks) fit
    on the card at once.  Before each call, NaN-filled blocks of the
    call's scratch and output sizes are freed on its stream, so the
    allocator hands the call poisoned memory rather than the identical
    partials and result of the round before, which would hide a wrong
    merge."""
    g = np.random.default_rng(17)

    def inputs(b, k, v):
        theta = torch.softmax(torch.from_numpy(
            g.standard_normal((b, k)).astype(np.float32)), -1)
        beta = torch.from_numpy(g.standard_normal((k, v)).astype(
            np.float32))
        bow = torch.from_numpy(g.poisson(0.2, (b, v)).astype(np.float32))
        return [t.to(cuda_device) for t in (theta, beta, bow)]
    runs = [inputs(128, 50, 5000), inputs(96, 50, 4400)]
    alone = [topic_decoder_cuda(*x) for x in runs]
    streams = [torch.cuda.Stream(cuda_device) for _ in runs]
    main = torch.cuda.current_stream(cuda_device)
    sizes = []                  # elements of the call's scratch and output
    for theta, beta, _ in runs:
        b = theta.shape[0]
        sizes.append((b * grid(b, beta.shape[1])[1] * 4, b))
    for _ in range(200):
        torch.cuda._sleep(5_000_000)          # the gate: ~2.5 ms
        outs = []
        for x, st, sz in zip(runs, streams, sizes):
            st.wait_stream(main)
            with torch.cuda.stream(st):
                for n in sz:            # made and freed on this stream
                    torch.full((n,), float("nan"), device=cuda_device)
                outs.append(topic_decoder_cuda(*x))
        for st in streams:
            main.wait_stream(st)
        assert all(torch.equal(o, a) for o, a in zip(outs, alone))


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


def _same_bits(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, zero, a.view(torch.int32)),
        torch.where(nb, zero, b.view(torch.int32))))


def _dp_secure_bitwise(x, rng):
    """B3 against its plain version on ``x``'s device for the dp, secure
    and all-terms variants, bitwise (a zero weight among the rows)."""
    k, d = x.shape
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        x.device)
    noise = t(rng.standard_normal((k, d)))
    masks = t(rng.integers(-4096, 4097, (k, d)) * 2.0 ** -10)
    coef, w = t(rng.uniform(0.01, 1.0, k)), t(rng.integers(0, 99, k))
    w[0] = 0.0
    for kw in (dict(noise=noise, clip_coef=coef),
               dict(masks=masks, weights=w),
               dict(noise=noise, masks=masks, clip_coef=coef, weights=w)):
        got = fed_dp_secure_apply_cuda(x, noise_scale=0.015, **kw)
        want = ref.fed_dp_secure_apply_ref(x, noise_scale=0.015, **kw)
        assert _same_bits(got, want)


# D = 775 501-775 503 (the path's width, D mod 4 = 1, 2, 3) put a float4
# across every row boundary of the flat stream
@pytest.mark.parametrize("k,d", [(1, 1), (3, 129), (5, 4097),
                                 (5, 775_500), (5, 775_501), (5, 775_502),
                                 (5, 775_503), (3, 2), (2, 7)])
def test_dp_secure_kernel_bitwise_plain(cuda_device, k, d, rng):
    x = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    _dp_secure_bitwise(x.to(cuda_device), rng)


def test_dp_secure_kernel_bitwise_plain_nonfinite(cuda_device, rng):
    """NaN, +inf and -inf in x pass through as the plain version's do."""
    x = rng.standard_normal((5, 4099)).astype(np.float32)
    x.flat[rng.choice(x.size, 300, replace=False)] = np.nan
    x.flat[rng.choice(x.size, 300, replace=False)] = np.inf
    x.flat[rng.choice(x.size, 300, replace=False)] = -np.inf
    _dp_secure_bitwise(torch.from_numpy(x).to(cuda_device), rng)


def test_dp_secure_kernel_bitwise_plain_unaligned(cuda_device, rng):
    """Operands that do not start on 16 bytes (views into a larger buffer)
    give the plain version's bits all the same."""
    flat = torch.from_numpy(rng.standard_normal(3 * 1001 + 1).astype(
        np.float32)).to(cuda_device)
    x = flat[1:].view(3, 1001)
    assert x.data_ptr() % 16
    _dp_secure_bitwise(x, rng)


def _topk_rows(rng, d):
    """B4's row kinds, one row each: Gaussian, tie-heavy, bf16 near-ties,
    tiny, all-equal (every key a tie across chunks), +-inf among
    Gaussians, -0.0 among Gaussians, scattered NaNs, an all-NaN padded
    row."""
    gauss = rng.standard_normal(d)
    inf = rng.standard_normal(d)
    inf[rng.random(d) < 0.05] = np.inf
    inf[rng.random(d) < 0.05] = -np.inf
    neg_zero = rng.standard_normal(d)
    neg_zero[rng.random(d) < 0.7] = -0.0
    some_nan = rng.standard_normal(d)
    some_nan[rng.random(d) < 0.05] = np.nan
    return np.stack([gauss, rng.integers(-3, 4, d) * 0.25,
                     1.0 + rng.integers(0, 8, d) * 2.0 ** -12,
                     1e-3 * rng.standard_normal(d), np.full(d, -0.375), inf,
                     neg_zero, some_nan, np.full(d, np.nan)]
                    ).astype(np.float32)


def _topk_inputs(rng, sizes, dev, k=None):
    """msgs (k rows of the kinds, cycled), an (L=5) error memory whose
    row 3 is -0.0 (so -0.0 messages stay -0.0), ids over it, and the
    segments of ``sizes``."""
    d = sum(sizes)
    kinds = _topk_rows(rng, d)
    k = len(kinds) if k is None else k
    msgs = kinds[np.arange(k) % len(kinds)]
    err = (0.1 * rng.standard_normal((5, d))).astype(np.float32)
    err[1:3] = 0.0
    err[3] = -0.0
    ids = np.asarray([(0, 1, 2, 4, 1, 0, 3, 2, 1)[i % 9] for i in range(k)],
                     np.int32)
    segs = list(zip(np.cumsum([0] + sizes[:-1]).tolist(), sizes))
    return (torch.from_numpy(msgs).to(dev), torch.from_numpy(err).to(dev),
            torch.from_numpy(ids).to(dev), segs)


def _topk_plain(msgs, err, ids, table):
    rows_err = err[ids.long()]
    sent, new = torch.empty_like(msgs), torch.empty_like(msgs)
    for o, n, kk in table:
        sent[:, o:o + n], new[:, o:o + n] = ref.fed_topk_ef_ref(
            msgs[:, o:o + n], rows_err[:, o:o + n], kk)
    return sent, new


# the path's leaf sizes in small, then the chunk edges (1, 4095, 4096,
# 4097, 8193 columns at offsets 2 mod 4); D is 1 mod 4, so error rows
# and message rows differ in their 16-byte phase
TOPK_SIZES = [500, 1, 2, 129, 4097, 9000, 1, 1, 3, 4095, 1, 4096, 4097,
              3, 8193, 2]


@pytest.mark.parametrize("frac", [0.01, 0.25, 1.0])
def test_topk_kernel_bitwise_plain(cuda_device, frac, rng):
    msgs, err, ids, segs = _topk_inputs(rng, TOPK_SIZES, cuda_device)
    edges = [segs[i] for i in (7, 9, 11, 12, 14)]
    assert [n for _, n in edges] == [1, 4095, 4096, 4097, 8193]
    assert [o % 4 for o, _ in edges] == [2] * 5
    table = ops.topk_segments(segs, frac)
    # also a message slab that starts off 16 bytes (a view), which the
    # wrapper copies to an aligned one
    flat = torch.empty(msgs.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(msgs.shape)
    shifted.copy_(msgs)
    assert shifted.data_ptr() % 16
    want = _topk_plain(msgs, err, ids, table)
    for m in (msgs, shifted):
        sent, new = fed_topk_ef_cuda(m, err, ids, table)
        assert _same_bits(sent, want[0]) and _same_bits(new, want[1])


def test_topk_kernel_repeats_and_streams_bitwise(cuda_device):
    """Two calls back to back with different K and tables, then one call
    on each of two streams at once: every result is bitwise its plain
    version (each call's scratch histograms are its own, zeroed on its
    stream)."""
    rng = np.random.default_rng(16)
    a = _topk_inputs(rng, [4097, 3, 8193, 1, 500], cuda_device, k=7)
    b = _topk_inputs(rng, [2, 9000, 4096, 129], cuda_device, k=3)
    ta, tb = ops.topk_segments(a[3], 0.25), ops.topk_segments(b[3], 0.01)
    runs = [(a, ta), (b, tb)]
    got = [fed_topk_ef_cuda(*x[:3], t) for x, t in runs]
    streams = [torch.cuda.Stream(cuda_device) for _ in runs]
    for (x, t), st in zip(runs, streams):
        st.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(st):
            got.append(fed_topk_ef_cuda(*x[:3], t))
    torch.cuda.synchronize(cuda_device)
    for (x, t), out in zip(runs + runs, got):
        want = _topk_plain(*x[:3], t)
        assert _same_bits(out[0], want[0]) and _same_bits(out[1], want[1])


@pytest.mark.parametrize("name", ["pallas-topk", "pallas-secure",
                                  "dp-transform"])
def test_training_on_card_matches_cpu(cuda_device, name):
    # the spec's default widths (V=400, K=10, hidden 64): at V=64 some
    # random inits start at a loss 300x the usual and diverge in a round
    base = FederationSpec.from_dict({
        "data": {"num_clients": 3, "docs_per_node": 40,
                 "val_docs_per_node": 8},
        "schedule": {"rounds": 3},
        "execution": {"batch_size": 64, "learning_rate": 2e-4,
                      "exec_mode": "vmap"}})
    spec = scenario_spec(name, base)
    cpu = Federation.from_spec(spec, device="cpu")
    gpu = Federation.from_spec(spec, device=cuda_device,
                               init_params=cpu.params)
    cpu.run()
    gpu.run()
    assert [h["participants"] for h in gpu.history] == [3, 3, 3]
    assert all(np.isfinite(h["loss"]) for h in cpu.history)
    assert max_param_dev(cpu.params, gpu.params) <= 1e-5


_LOOP_BASE = {"data": {"num_clients": 3, "docs_per_node": 40,
                       "val_docs_per_node": 8},
              "schedule": {"rounds": 3},
              "execution": {"batch_size": 64, "learning_rate": 2e-4}}


@pytest.mark.parametrize("name", ["paper", "straggler-heavy"])
def test_loop_federation_on_card_matches_cpu(cuda_device, name):
    """Algorithm 1's host loop (the spec's default widths V=400, K=10,
    hidden 64): 3 rounds on the card (B2 combines) and on the CPU, within
    1e-5, with the same round records."""
    spec = scenario_spec(name, FederationSpec.from_dict(_LOOP_BASE))
    cpu = Federation.from_spec(spec, device="cpu")
    gpu = Federation.from_spec(spec, device=cuda_device,
                               init_params=cpu.params)
    cpu.run()
    gpu.run()
    assert gpu.engine.exec_mode == "loop"
    keys = ("participants", "arrived", "superseded", "in_flight")
    assert [[h[k] for k in keys] for h in gpu.history] == \
        [[h[k] for k in keys] for h in cpu.history]
    assert max_param_dev(cpu.params, gpu.params) <= 1e-5


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_federated_trainer_on_card_matches_cpu(cuda_device, momentum):
    spec = FederationSpec.from_dict(_LOOP_BASE)
    cpu_fed = Federation.from_spec(spec, device="cpu")
    runs = []
    for dev in ("cpu", cuda_device):
        cfg = cpu_fed.model_cfg
        clients = [ClientState(data={"bow": c.data["bow"].to(dev)},
                               num_docs=c.num_docs)
                   for c in cpu_fed.engine.clients]
        tr = FederatedTrainer(
            lambda p, b: prodlda.elbo_loss(p, cfg, b),
            {k: v.to(dev) for k, v in cpu_fed.params.items()}, clients,
            FederatedConfig(learning_rate=2e-4, max_rounds=3, rel_tol=0.0),
            optimizer=sgd(2e-4, momentum=momentum), batch_size=64)
        tr.fit(seed=0)
        runs.append(tr)
    assert [h["arrived"] for h in runs[1].history] == [3, 3, 3]
    assert max_param_dev(runs[0].params, runs[1].params) <= 1e-5


def test_loop_round_launches_b2_once_per_arrival_round(cuda_device):
    """On the host loop every round with an arrival is one B2 launch (the
    arrivals laid out as rows of one slab), and a round where every
    message straggles launches none."""
    spec = scenario_spec("straggler-heavy",
                         FederationSpec.from_dict(_LOOP_BASE))
    fed = Federation.from_spec(spec, device=cuda_device)
    for _ in range(6):
        before = fed_aggregate.launches
        rec = fed.step()
        assert fed_aggregate.launches - before == (1 if rec["arrived"]
                                                   else 0)
    assert sum(h["superseded"] for h in fed.history) > 0


# the ProdLDA leaf sizes at prodlda_synthetic width (D = 775 500), and
# the same with one more column (odd D: rows off 16 bytes past row 0)
PRODLDA_SIZES = [500_000, 100, 10_000, 100, 5_000, 50, 5_000, 50, 250_000,
                 50, 50, 5_000, 50, 50]


@pytest.mark.parametrize("k,sizes", [(1, PRODLDA_SIZES),
                                     (3, PRODLDA_SIZES + [1]),
                                     (1, [3, 129, 1]), (3, [4097, 2])])
def test_transform_kernels_at_loop_and_service_shapes(cuda_device, k, sizes,
                                                      rng):
    """B3 and B4 through the ``ops`` wrappers the transform stage calls,
    at the service's (1, D) slab and a partial cohort's (3, D) slab of
    odd width, bitwise their plain versions on the same tensors."""
    d = sum(sizes)
    x = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    _dp_secure_bitwise(x.to(cuda_device), rng)
    msgs, err, ids, segs = _topk_inputs(rng, sizes, cuda_device, k=k)
    table = ops.topk_segments(segs, 0.25)
    before = fed_aggregate.topk_ef_launches
    sent, new = ops.fed_topk_ef(msgs, err, ids, frac=0.25, segments=segs)
    assert fed_aggregate.topk_ef_launches - before == 1
    want = _topk_plain(msgs, err, ids, table)
    assert _same_bits(sent, want[0]) and _same_bits(new, want[1])


def _launches():
    return fed_aggregate.dp_secure_launches, fed_aggregate.topk_ef_launches


@pytest.mark.parametrize("name", ["dp-transform", "topk-transform",
                                  "secure-transform", "precision-transform",
                                  "dp-straggler"])
def test_loop_transforms_on_card_match_cpu(cuda_device, name):
    """Each transform on Algorithm 1's host loop (V=400, K=10, hidden
    64), 3 rounds on the card and on the CPU from one init: within 1e-5,
    the same round records, and one B3 (dp, secure) or B4 (topk) launch
    per round on the card."""
    spec = scenario_spec(name, FederationSpec.from_dict(_LOOP_BASE))
    cpu = Federation.from_spec(spec, device="cpu")
    gpu = Federation.from_spec(spec, device=cuda_device,
                               init_params=cpu.params)
    cpu.run()
    for _ in range(3):
        before = _launches()
        gpu.step()
        got = tuple(a - b for a, b in zip(_launches(), before))
        assert got == {"topk-transform": (0, 1),
                       "precision-transform": (0, 0)}.get(name, (1, 0))
    assert gpu.engine.exec_mode == "loop"
    keys = ("participants", "arrived", "superseded", "in_flight")
    assert [[h[k] for k in keys] for h in gpu.history] == \
        [[h[k] for k in keys] for h in cpu.history]
    assert max_param_dev(cpu.params, gpu.params) <= 1e-5


@pytest.mark.parametrize("which", ["dp", "topk"])
def test_service_transforms_on_card_match_cpu(cuda_device, which):
    """The ``buffered_async`` service with dp or topk uploads on the card
    and on the CPU: the same events, parameters within 1e-5, and one B3
    or B4 launch per computed upload on the card."""
    base = FederationSpec.from_dict({
        "model": {"vocab": 64, "topics": 4, "hidden": 16},
        "data": {"num_clients": 3, "docs_per_node": 40,
                 "val_docs_per_node": 8},
        "transforms": {"names": [which], "dp_clip_norm": 0.05,
                       **({"dp_noise_multiplier": 0.3} if which == "dp"
                          else {"compression_topk": 0.25})},
        "execution": {"batch_size": 64, "learning_rate": 2e-4}})
    spec = scenario_spec("buffered_async", base)
    runs = []
    for dev in ("cpu", cuda_device):
        svc = FederationService.from_spec(spec, device=dev)
        before = _launches()
        stats = run_traffic(svc, sweeps=4, order_seed=1, hold_prob=0.3,
                            duplicate_prob=0.3, infer_every=2)
        svc.shutdown()
        launched = tuple(a - b for a, b in zip(_launches(), before))
        runs.append((svc, stats, launched))
    (cpu, st_cpu, _), (gpu, st_gpu, launched) = runs
    assert st_cpu["aggregations"] == st_gpu["aggregations"] >= 3
    assert cpu.rejections == gpu.rejections
    n = st_gpu["steps"]
    assert launched == ((n, 0) if which == "dp" else (0, n))
    assert max_param_dev(cpu.fetch_model()[1], gpu.fetch_model()[1]) <= 1e-5


# (b, hq, hkv, s, d, causal, window): the reference's grid, hymba's 5:1
# GQA with its window crossing tiles, every head dim the kernel takes
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, 0), (1, 4, 1, 128, 32, True, 0),
    (2, 2, 2, 256, 64, True, 64), (1, 4, 4, 128, 64, False, 0),
    (1, 8, 2, 100, 32, True, 0), (2, 10, 2, 300, 64, True, 100),
    (1, 4, 4, 193, 96, True, 0), (1, 2, 1, 129, 128, False, 33),
    (1, 25, 5, 2048, 64, True, 1024),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda_device, b, hq, hkv, s, d, causal,
                                    window, dtype, rng):
    """q, k, v as column slices of one fused projection (read through
    their strides); 2e-5 in fp32, 2e-2 in bf16 (the reference's
    bounds)."""
    fused = torch.from_numpy(rng.standard_normal(
        (b, s, hq + 2 * hkv, d)).astype(np.float32)).to(cuda_device, dtype)
    q, k, v = fused.split([hq, hkv, hkv], dim=2)
    before = flash_attention.launches
    got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=d ** -0.5)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("fault", ["pointer", "stride"])
def test_flash_kernel_bf16_refuses_misaligned(cuda_device, fault):
    """The tensor-core route takes 16-byte aligned operands with (b, s, h)
    strides that are multiples of 8; anything else raises, and nothing
    launches (no fp32 or plain fallback)."""
    if fault == "pointer":
        q = torch.zeros(2 * 64 * 2 * 64 + 1, device=cuda_device,
                        dtype=torch.bfloat16)[1:].view(2, 64, 2, 64)
    else:
        q = torch.zeros(2, 64, 2, 68, device=cuda_device,
                        dtype=torch.bfloat16)[..., :64]
    k = torch.zeros(2, 64, 1, 64, device=cuda_device, dtype=torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(q, k, k, causal=True, window=0, scale=0.125)
    assert flash_attention.launches == before


@pytest.mark.parametrize("fault", ["pointer", "stride"])
def test_flash_bwd_kernel_bf16_refuses_misaligned(cuda_device, fault):
    """The backward's tensor-core route reads its operands as the
    forward's does; a misaligned q raises before any launch (no fp32 or
    plain fallback)."""
    if fault == "pointer":
        q = torch.zeros(2 * 64 * 2 * 64 + 1, device=cuda_device,
                        dtype=torch.bfloat16)[1:].view(2, 64, 2, 64)
    else:
        q = torch.zeros(2, 64, 2, 68, device=cuda_device,
                        dtype=torch.bfloat16)[..., :64]
    k = torch.zeros(2, 64, 1, 64, device=cuda_device, dtype=torch.bfloat16)
    out = torch.zeros(2, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(2, 2, 64, device=cuda_device)
    before = flash_attention.bwd_launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd_cuda(q, k, k, out, lse, out, causal=True,
                                 window=0, scale=0.125)
    assert flash_attention.bwd_launches == before


# (b, s, h, p, n, chunk): the reference's grid, the hymba prefill's head
# and state at two chunks, a ragged tail, N > 16 (shared-memory path)
SSD_CASES = [(2, 256, 3, 32, 16, 64), (1, 100, 2, 16, 8, 32),
             (1, 64, 1, 64, 128, 64), (2, 512, 4, 64, 16, 256),
             (1, 300, 3, 64, 16, 256), (2, 96, 2, 32, 32, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk, dtype,
                                  rng):
    """x, B, C as column slices of one conv output (strided, as on the
    model path); 1e-4 of the output's scale in fp32, 2e-2 in bf16."""
    conv = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * n)).astype(np.float32)).to(cuda_device, dtype)
    xs, bb, cc = conv.split([h * p, n, n], dim=-1)
    x = xs.reshape(b, s, h, p)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, s, h)).astype(
        np.float32)).to(cuda_device)
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, h).astype(np.float32)).to(
        cuda_device)
    before = ssd_scan.launches
    y, h_last = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk)
    assert ssd_scan.launches == before + 1
    y_want, h_want = ref.ssd_scan_ref(x, dt, a, bb, cc, chunk)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((y, y_want), (h_last, h_want)):
        scale = max(float(want.float().abs().max()), 1.0)
        torch.testing.assert_close(got.float() / scale, want.float() / scale,
                                   rtol=0, atol=tol)
    assert y.dtype == dtype and h_last.dtype == torch.float32


# (b, s, h, p, n, chunk): the tensor-core route at chunk 256 with ragged
# tails, N = 32, 64 and mamba2-1.3b's 128 (the fp32 kernel has not the
# shared memory for N = 128 at chunk 256), and every head dim
SSD_TC_CASES = [(1, 300, 3, 64, 32, 256), (2, 600, 2, 32, 64, 256),
                (1, 520, 2, 64, 128, 256), (2, 270, 3, 16, 128, 256)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_TC_CASES)
def test_ssd_kernel_bf16_tensor_cores_matches_plain(cuda_device, b, s, h, p,
                                                    n, chunk, rng):
    """bf16 x, B, C as column slices of one conv output (strided): y and
    h_last within 2e-2 of the output's scale."""
    conv = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * n)).astype(np.float32)).to(cuda_device,
                                                      torch.bfloat16)
    xs, bb, cc = conv.split([h * p, n, n], dim=-1)
    x = xs.reshape(b, s, h, p)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, s, h)).astype(
        np.float32)).to(cuda_device)
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, h).astype(np.float32)).to(
        cuda_device)
    before = ssd_scan.launches
    y, h_last = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk)
    assert ssd_scan.launches == before + 1
    y_want, h_want = ref.ssd_scan_ref(x, dt, a, bb, cc, chunk)
    for got, want in ((y, y_want), (h_last, h_want)):
        scale = max(float(want.float().abs().max()), 1.0)
        torch.testing.assert_close(got.float() / scale, want.float() / scale,
                                   rtol=0, atol=2e-2)


@pytest.mark.parametrize("fault", ["pointer", "stride"])
def test_ssd_kernel_bf16_refuses_misaligned(cuda_device, fault):
    """The tensor-core route takes 16-byte aligned x, B, C with (b, s, h)
    strides that are multiples of 8; anything else raises, and nothing
    launches (no fp32 or plain fallback)."""
    bf16 = torch.bfloat16
    if fault == "pointer":
        x = torch.zeros(2 * 64 * 2 * 16 + 1, device=cuda_device,
                        dtype=bf16)[1:].view(2, 64, 2, 16)
    else:
        x = torch.zeros(2, 64, 2, 20, device=cuda_device,
                        dtype=bf16)[..., :16]
    bc = torch.zeros(2, 64, 16, device=cuda_device, dtype=bf16)
    dt = torch.full((2, 64, 2), 0.01, device=cuda_device)
    a = -torch.ones(2, device=cuda_device)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan_cuda(x, dt, a, bc, bc, chunk=32)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("fault", ["pointer", "stride"])
def test_ssd_bwd_kernel_bf16_refuses_misaligned(cuda_device, fault):
    """B6's backward on bf16 reads what the forward's tensor-core route
    reads: a misaligned x raises, and nothing launches (no fp32 or plain
    fallback)."""
    bf16 = torch.bfloat16
    if fault == "pointer":
        x = torch.zeros(2 * 64 * 2 * 16 + 1, device=cuda_device,
                        dtype=bf16)[1:].view(2, 64, 2, 16)
    else:
        x = torch.zeros(2, 64, 2, 20, device=cuda_device,
                        dtype=bf16)[..., :16]
    bc = torch.zeros(2, 64, 16, device=cuda_device, dtype=bf16)
    dt = torch.full((2, 64, 2), 0.01, device=cuda_device)
    a = -torch.ones(2, device=cuda_device)
    dy = torch.zeros(2, 64, 2, 16, device=cuda_device, dtype=bf16)
    states = torch.zeros(2, 2, 2, 16, 16, device=cuda_device)
    before = ssd_scan.bwd_launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan_bwd_cuda(x, dt, a, bc, bc, dy, states, None, chunk=32)
    assert ssd_scan.bwd_launches == before


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def rng_tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_lm_prefill_decode_on_card_matches_cpu(cuda_device):
    """Reduced hymba-1.5b in fp32, the same weights on both: prefill over
    96 tokens (past the window of 64, two SSD chunks) and 4 teacher-forced
    decode steps, logits within 2e-4; B5 and B6 launch once per layer of
    the prefill and never in decode."""
    cfg = get_config("hymba-1.5b").reduced()
    cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    gpu = _to(cpu, cuda_device)
    toks = torch.from_numpy(rng_tokens(cfg.vocab_size, 2, 100))
    runs = []
    for params, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        counts = (flash_attention.launches, ssd_scan.launches)
        logits, cache = tfm.prefill(params, cfg, {"tokens": toks[:, :96]
                                                  .to(dev)},
                                    dtype=torch.float32, max_len=100)
        out = [logits]
        mid = (flash_attention.launches, ssd_scan.launches)
        for i in range(4):
            step, cache = tfm.decode_step(params, cfg, cache,
                                          toks[:, 96 + i:97 + i].to(dev),
                                          dtype=torch.float32)
            out.append(step)
        after = (flash_attention.launches, ssd_scan.launches)
        runs.append((out, counts, mid, after))
    (cpu_out, c0, c1, c2), (gpu_out, g0, g1, g2) = runs
    assert c0 == c1 == c2
    assert g1 == (g0[0] + cfg.num_layers, g0[1] + cfg.num_layers) == g2
    for a, b in zip(cpu_out, gpu_out):
        scale = max(float(a.abs().max()), 1.0)
        assert float((b.cpu() - a).abs().max()) / scale <= 2e-4


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _grads_of_train_loss(params, cfg, batch, dtype):
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    loss = tfm.train_loss(params, cfg, batch, dtype=dtype)
    loss.backward()
    return float(loss.detach()), [leaf.grad for leaf in _leaves(params)]


def test_train_loss_grads_on_card_match_cpu(cuda_device):
    """Reduced hymba-1.5b in fp32 from the same weights: ``train_loss``
    and every gradient leaf through B5's and B6's backward kernels on
    the card against the plain backward passes on the CPU, within 1e-4
    of each leaf's scale; each backward kernel runs once per layer."""
    cfg = get_config("hymba-1.5b").reduced()
    cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    gpu = _to(cpu, cuda_device)
    toks = rng_tokens(cfg.vocab_size, 2, 97)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    want_loss, want = _grads_of_train_loss(cpu, cfg, batch, torch.float32)
    counts = (flash_attention.bwd_launches, ssd_scan.bwd_launches)
    got_loss, got = _grads_of_train_loss(
        gpu, cfg, {k: v.to(cuda_device) for k, v in batch.items()},
        torch.float32)
    assert (flash_attention.bwd_launches, ssd_scan.bwd_launches) == (
        counts[0] + cfg.num_layers, counts[1] + cfg.num_layers)
    assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.cpu() - w).abs().max()) / scale <= 1e-4


@pytest.mark.parametrize("call", ["topic_decoder"])
def test_forward_only_kernels_refuse_grad(cuda_device, call, rng):
    """``ops.topic_decoder_loss`` (B1, forward-only until A3) on CUDA
    tensors that require grad raises, naming the kernel; under
    ``torch.no_grad()`` the same call runs and agrees with the plain
    version.  (B5 and B6 have backward kernels: the tests below.)"""
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    args = [torch.softmax(t(64, 8), -1), t(8, 300),
            torch.from_numpy(rng.poisson(0.2, (64, 300)).astype(
                np.float32)), 0.5 + t(300).abs()]
    fn, tol = ops.topic_decoder_loss, 1e-5
    want = fn(*args)
    dev = [a.to(cuda_device).requires_grad_(True) for a in args]
    with pytest.raises(RuntimeError, match=f"{call}.*A3"):
        fn(*dev)
    with torch.no_grad():
        got = fn(*dev)
    scale = max(float(want.abs().max()), 1.0)
    assert float((got.cpu() - want).abs().max()) / scale <= tol


# (b, hq, hkv, s, d, causal, window): causal, windowed (causal and not)
# and full masks, GQA and MQA, ragged S, every head dim
FLASH_BWD_CASES = [
    (2, 4, 2, 70, 32, True, 16), (1, 5, 1, 130, 64, True, 0),
    (1, 3, 3, 100, 96, False, 0), (1, 4, 2, 77, 128, False, 20),
    (1, 25, 5, 300, 64, True, 128), (2, 2, 1, 64, 64, True, 64),
    (1, 4, 2, 256, 64, True, 40),   # the window's edge inside a 128-row tile
    (1, 5, 1, 129, 96, True, 0),    # a ragged tail of one row
]
# the LM training path's shape (hymba-1.5b, 1 x 4096)
FLASH_BWD_PATH = (1, 25, 5, 4096, 64, True, 1024)


def _flash_bwd_inputs(case, dtype, rng, dev):
    b, hq, hkv, s, d, causal, window = case
    fused = torch.from_numpy(rng.standard_normal(
        (b, s, hq + 2 * hkv, d)).astype(np.float32)).to(dev, dtype)
    q, k, v = fused.split([hq, hkv, hkv], dim=2)
    dout = torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(
        np.float32)).to(dev, dtype)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    out, lse = flash_attention_cuda(q, k, v, want_lse=True, **kw)
    return q, k, v, out, lse, dout, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda_device, case, dtype, rng):
    """B5's backward against ``ref.flash_attention_bwd_ref`` on the same
    (q, k, v, out, lse, dout), q/k/v strided slices of one projection:
    2e-5 (fp32) and 2e-2 (bf16) of each gradient's scale; the lse the
    forward writes against the plain one."""
    q, k, v, out, lse, dout, kw = _flash_bwd_inputs(case, dtype, rng,
                                                    cuda_device)
    _, lse_want = ref.flash_attention_fwd_ref(q, k, v, **kw)
    before = flash_attention.bwd_launches
    got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    assert flash_attention.bwd_launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(lse, lse_want, rtol=tol, atol=tol)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        scale = max(float(w.float().abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) / scale <= tol


# (b, s, h, p, n, chunk): chunk edges (one past, one short, exact), a
# ragged tail, N in 8, 16, 64, 128 and every head dim
SSD_BWD_CASES = [(2, 64, 3, 16, 16, 32), (1, 100, 2, 32, 16, 48),
                 (1, 257, 2, 64, 16, 256), (1, 255, 3, 64, 16, 64),
                 (1, 128, 2, 64, 64, 64), (1, 200, 2, 64, 128, 128),
                 (1, 96, 2, 32, 8, 64),
                 (2, 513, 2, 64, 16, 256),    # a one-step tail, 3 chunks
                 (1, 300, 2, 16, 128, 128)]   # P=16 at N=128
# bf16 only: chunk 256 at N=128 and 64 (the fp32 forward has not the
# shared memory for N=128 at chunk 256)
SSD_BWD_TC_CASES = [(1, 300, 2, 16, 128, 256), (2, 270, 3, 32, 64, 256)]
# the LM training path's shape (hymba-1.5b, sequence 4096)
SSD_BWD_PATH = (1, 4096, 50, 64, 16, 256)


def _ssd_bwd_inputs(case, dtype, rng, dev):
    b, s, h, p, n, chunk = case
    conv = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * n)).astype(np.float32)).to(dev, dtype)
    xs, bb, cc = conv.split([h * p, n, n], dim=-1)
    x = xs.reshape(b, s, h, p)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, s, h)).astype(
        np.float32)).to(dev)
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, h).astype(np.float32)).to(
        dev)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(
        np.float32)).to(dev, dtype)
    dh = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(
        np.float32)).to(dev)
    return x, dt, a, bb, cc, dy, dh


@pytest.mark.parametrize("with_h_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain(cuda_device, case, dtype, with_h_last,
                                      rng):
    """B6's backward against ``ref.ssd_scan_bwd_ref`` (autodiff through
    the plain scan) from the states the forward kept, with and without a
    cotangent on h_last: 1e-4 (fp32) and 2e-2 (bf16) of each gradient's
    scale."""
    _ssd_bwd_check(case, dtype, with_h_last, rng, cuda_device)


@pytest.mark.parametrize("with_h_last", [False, True])
@pytest.mark.parametrize("case", SSD_BWD_TC_CASES)
def test_ssd_bwd_kernel_bf16_tensor_cores_matches_plain(cuda_device, case,
                                                        with_h_last, rng):
    """B6's backward on its bf16 tensor-core route at chunk 256 with N=128
    (P=16) and N=64 (P=32, batch 2, ragged): 2e-2 of each gradient's
    scale."""
    _ssd_bwd_check(case, torch.bfloat16, with_h_last, rng, cuda_device)


def test_ssd_bwd_kernel_bf16_rising_cum_matches_plain(cuda_device, rng):
    """Heads whose cum rises (a > 0) take the tensor-core kernels' decay
    per entry instead of through its monotone factors: their gradients,
    beside decaying heads', within 2e-2 of each gradient's scale."""
    _ssd_bwd_check((1, 300, 4, 64, 16, 256), torch.bfloat16, True, rng,
                   cuda_device, a=[-1.0, 0.1, -0.5, 0.02])


def _ssd_bwd_check(case, dtype, with_h_last, rng, dev, a=None):
    b, s, h, p, n, chunk = case
    x, dt, a_drawn, bb, cc, dy, dh = _ssd_bwd_inputs(case, dtype, rng, dev)
    a = a_drawn if a is None else torch.tensor(a, device=dev)
    dh = dh if with_h_last else None
    _, _, states = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk,
                                 keep_states=True)
    before = ssd_scan.bwd_launches
    got = ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, states, dh, chunk=chunk)
    assert ssd_scan.bwd_launches == before + 1
    want = ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, dh, chunk)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = max(float(w.float().abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) / scale <= tol


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
def test_backward_kernels_repeat_bitwise(cuda_device, kernel, rng):
    """No atomics: two backward calls on the same inputs give the same
    bits (both also at the LM training path's shape, B6's on its
    tensor-core route)."""
    pairs = []
    if kernel == "flash_attention":
        for case in (FLASH_BWD_CASES[4], FLASH_BWD_PATH):
            q, k, v, out, lse, dout, kw = _flash_bwd_inputs(
                case, torch.bfloat16, rng, cuda_device)
            pairs.append([flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                   **kw) for _ in range(2)])
    else:
        for case in (SSD_BWD_CASES[3], SSD_BWD_PATH):
            x, dt, a, bb, cc, dy, dh = _ssd_bwd_inputs(case, torch.bfloat16,
                                                       rng, cuda_device)
            _, _, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=case[-1],
                                     keep_states=True)
            pairs.append([ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, dh,
                                            chunk=case[-1])
                          for _ in range(2)])
    for first, second in pairs:
        for g1, g2 in zip(first, second):
            assert torch.equal(g1, g2)


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
@pytest.mark.parametrize("mode", ["backward", "func_grad"])
def test_bf16_function_grads_on_card_match_plain(cuda_device, kernel, mode,
                                                 rng):
    """``ops.flash_attention`` and ``ops.ssd_scan`` on bf16 CUDA tensors,
    differentiated by ``loss.backward()`` and by ``torch.func.grad``: the
    backward kernels' gradients against autograd through the plain
    forward on the same tensors, within 2e-2 of each gradient's scale
    (dt's through its cast to fp32)."""
    if kernel == "flash_attention":
        fused = torch.from_numpy(rng.standard_normal(
            (1, 200, 35, 64)).astype(np.float32)).to(cuda_device,
                                                     torch.bfloat16)
        cot = torch.randn(1, 200, 25, 64, device=cuda_device)

        def run(fn, f):
            q, k, v = f.split([25, 5, 5], dim=2)
            return torch.sum(fn(q, k, v).float() * cot)
        fast = lambda q, k, v: ops.flash_attention(  # noqa: E731
            q, k, v, window=64)
        plain = lambda q, k, v: ref.flash_attention_ref(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            window=64).transpose(1, 2)
        args = (fused,)
    else:
        x, dt, a, bb, cc, dy, dh = _ssd_bwd_inputs(
            (1, 300, 4, 64, 16, 256), torch.bfloat16, rng, cuda_device)

        def run(fn, x, dt, a, bb, cc):
            y, hl = fn(x, dt, a, bb, cc)
            return torch.sum(y.float() * dy.float()) + torch.sum(hl * dh)
        fast = lambda *t: ops.ssd_scan(*t, chunk=256)  # noqa: E731
        plain = lambda *t: ref.ssd_scan_ref(*t, 256)  # noqa: E731
        args = (x.contiguous(), dt, a, bb.contiguous(), cc.contiguous())
    argnums = tuple(range(len(args)))
    want = torch.func.grad(lambda *t: run(plain, *t), argnums=argnums)(*args)
    if mode == "func_grad":
        got = torch.func.grad(lambda *t: run(fast, *t),
                              argnums=argnums)(*args)
    else:
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        run(fast, *leaves).backward()
        got = [t.grad for t in leaves]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        scale = max(float(w.float().abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) / scale <= 2e-2


def test_train_step_launches_each_kernel_once_per_layer(cuda_device):
    """One ``make_train_step`` step of reduced hymba-1.5b on the card:
    B5 and B6 forward and backward each launch once per layer, B1-B4
    never; the step's loss and parameters are finite."""
    from repro_torch.launch.steps import make_train_step
    cfg = get_config("hymba-1.5b").reduced()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device=cuda_device)
    toks = torch.from_numpy(rng_tokens(cfg.vocab_size, 2, 129)).to(
        cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, sgd(2e-3), dtype=torch.float32)
    before = (flash_attention.launches, flash_attention.bwd_launches,
              ssd_scan.launches, ssd_scan.bwd_launches,
              fed_aggregate.launches)
    new, _, loss = step(params, {}, batch, 0)
    torch.cuda.synchronize()
    after = (flash_attention.launches, flash_attention.bwd_launches,
             ssd_scan.launches, ssd_scan.bwd_launches,
             fed_aggregate.launches)
    assert [y - x for x, y in zip(before, after)] == [cfg.num_layers] * 4 \
        + [0]
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(t).all()) for t in _leaves(new))


# ---------------------------------------------------------------------------
# the batched cohort path's vmap rules, and LM federation on the card
# ---------------------------------------------------------------------------
def _vmap_case(kernel, dtype, rng, dev):
    """(f, args, in_dims) of a per-client loss through ``ops``: 3 clients,
    an operand without the client axis (v, or B), a batched decay ``a``."""
    def t(*shape, lo=None, hi=None, dt=dtype):
        x = rng.standard_normal(shape) if lo is None \
            else rng.uniform(lo, hi, shape)
        return torch.from_numpy(x.astype(np.float32)).to(dev, dt)
    kc = 3
    if kernel == "flash_attention":
        args = (t(kc, 2, 200, 25, 64), t(kc, 2, 200, 5, 64),
                t(2, 200, 5, 64), t(kc, 2, 200, 25, 64, dt=torch.float32))

        def f(q, k, v, w):
            return torch.sum(ops.flash_attention(q, k, v, window=64).float()
                             * w)
        return f, args, (0, 0, None, 0), 3
    args = (t(kc, 2, 300, 4, 64), t(kc, 2, 300, 4, lo=0.001, hi=0.1,
                                    dt=torch.float32),
            t(kc, 4, lo=-2.0, hi=-0.5, dt=torch.float32), t(2, 300, 16),
            t(kc, 2, 300, 16), t(kc, 2, 300, 4, 64, dt=torch.float32),
            t(kc, 2, 4, 64, 16, dt=torch.float32))

    def f(x, dt, a, b, c, wy, wh):
        y, h_last = ops.ssd_scan(x, dt, a, b, c, chunk=256)
        return torch.sum(y.float() * wy) + torch.sum(h_last * wh)
    return f, args, (0, 0, 0, None, 0, 0, 0), 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
def test_vmap_grad_kernels_match_a_loop(cuda_device, kernel, dtype, rng):
    """``vmap(grad)`` through B5 and B6 on the card (the batched cohort
    path's rule) against a loop of per-client ``torch.func.grad`` through
    the same kernels, within 1e-6 of each gradient's scale; B5 and its
    backward launch once for the cohort, B6 and its backward once per
    client."""
    f, args, in_dims, n = _vmap_case(kernel, dtype, rng, cuda_device)
    kc = args[0].shape[0]
    argnums = tuple(range(n))
    mod = flash_attention if kernel == "flash_attention" else ssd_scan
    before = (mod.launches, mod.bwd_launches)
    got = torch.func.vmap(torch.func.grad(f, argnums=argnums),
                          in_dims=in_dims)(*args)
    torch.cuda.synchronize()
    per = 1 if kernel == "flash_attention" else kc
    assert (mod.launches - before[0], mod.bwd_launches - before[1]) \
        == (per, per)
    for i in range(kc):
        one = [a if d is None else a[i] for a, d in zip(args, in_dims)]
        want = torch.func.grad(f, argnums=argnums)(*one)
        for g, w in zip(got, want):
            assert g[i].dtype == w.dtype
            scale = max(float(w.float().abs().max()), 1e-30)
            assert float((g[i].float() - w.float()).abs().max()) / scale \
                <= 1e-6


def test_backward_operator_batching_rules_on_card(cuda_device, rng):
    """``repro_torch::flash_attention_bwd`` and ``repro_torch::ssd_scan_bwd``
    under ``torch.func.vmap`` on CUDA tensors (an unbatched operand
    each) against a loop of calls, within 1e-6 of each gradient's
    scale."""
    dev = cuda_device

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    kc, b, s, h, hkv, d = 3, 2, 130, 4, 2, 64
    q, k, v, dout = t(kc, b, s, h, d), t(kc, b, s, hkv, d), \
        t(b, s, hkv, d), t(kc, b, s, h, d)
    fw = [flash_attention_cuda(q[i], k[i], v, causal=True, window=32,
                               scale=d ** -0.5, want_lse=True)
          for i in range(kc)]
    out, lse = torch.stack([o for o, _ in fw]), torch.stack([x for _, x in fw])
    op = torch.ops.repro_torch.flash_attention_bwd
    checks = [(torch.func.vmap(lambda *a: op(*a, True, 32, d ** -0.5),
                               in_dims=(0, 0, None, 0, 0, 0))(
        q, k, v, out, lse, dout),
        [op(q[i], k[i], v, out[i], lse[i], dout[i], True, 32, d ** -0.5)
         for i in range(kc)])]
    hs, p, n = 3, 64, 16
    x, dy = t(kc, b, s, hs, p), t(kc, b, s, hs, p)
    dt = torch.rand((kc, b, s, hs), device=dev) * 0.1
    a = -torch.rand((hs,), device=dev) - 0.5
    bb, cc, dh = t(kc, b, s, n), t(b, s, n), t(kc, b, hs, p, n)
    st = torch.stack([ssd_scan_cuda(x[i], dt[i], a, bb[i], cc, chunk=64,
                                    keep_states=True)[2] for i in range(kc)])
    op = torch.ops.repro_torch.ssd_scan_bwd
    checks.append((torch.func.vmap(lambda *z: op(*z, 64),
                                   in_dims=(0, 0, None, 0, None, 0, 0, 0))(
        x, dt, a, bb, cc, dy, st, dh),
        [op(x[i], dt[i], a, bb[i], cc, dy[i], st[i], dh[i], 64)
         for i in range(kc)]))
    for got, want in checks:
        for i, w in enumerate(want):
            for g, e in zip(got, w):
                scale = max(float(e.abs().max()), 1e-30)
                assert float((g[i] - e).abs().max()) / scale <= 1e-6


def _flips_within(devs: np.ndarray, bound: float) -> bool:
    """Every entry within ``bound`` but top-k's support flips: at most
    1e-4 of the entries beyond it, and those within 1e-3 (see
    tests/test_torch_lm_federation.py)."""
    return int(np.sum(devs > bound)) <= 1e-4 * devs.size \
        and float(devs.max()) <= 1e-3


def test_lm_dirichlet_topk_round_on_card_matches_cpu(cuda_device):
    """One reduced ``lm_dirichlet_topk`` round (phi3 family, the batched
    cohort path, top-k deltas) on the card and on the CPU from one init:
    every parameter within 1e-4 (top-k's support flips aside), the same
    round record, and one B2 and one B4 launch, B5 and its backward once
    per layer (the cohort folded)."""
    from repro_torch.api import spec_replace
    spec = spec_replace(scenario_spec("lm_dirichlet_topk"), {
        "model.vocab": 128, "model.seq_len": 16, "data.num_clients": 3,
        "data.docs_per_node": 24, "data.val_docs_per_node": 8,
        "schedule.rounds": 1})
    cpu = Federation.from_spec(spec, device="cpu")
    gpu = Federation.from_spec(spec, device=cuda_device,
                               init_params=cpu.params)
    cpu.run()
    counts = (fed_aggregate.launches, fed_aggregate.topk_ef_launches,
              flash_attention.launches, flash_attention.bwd_launches)
    gpu.run()
    torch.cuda.synchronize()
    got = [b - a for a, b in zip(counts, (
        fed_aggregate.launches, fed_aggregate.topk_ef_launches,
        flash_attention.launches, flash_attention.bwd_launches))]
    layers = gpu.model_cfg.num_layers
    assert got == [1, 1, layers, layers]
    assert abs(cpu.history[0]["loss"] - gpu.history[0]["loss"]) <= 1e-4
    assert cpu.history[0]["participants"] == gpu.history[0]["participants"]
    devs = np.concatenate([(c - g.cpu()).abs().numpy().ravel()
                           for c, g in zip(_leaves(cpu.params),
                                           _leaves(gpu.params))])
    assert _flips_within(devs, 1e-4)


def test_topk_kernel_bitwise_at_a_51m_segment(cuda_device, rng):
    """B4 at the LM slab's widest segment (hymba-1.5b's embedding, 32 001 x
    1600 = 51 201 600 entries), two rows over an error memory of three:
    bitwise its plain version."""
    d = 32_001 * 1600
    g = torch.Generator(device=cuda_device).manual_seed(0)
    msgs = torch.randn((2, d), generator=g, device=cuda_device) * 1e-3
    err = torch.randn((3, d), generator=g, device=cuda_device) * 1e-4
    ids = torch.tensor([2, 0], dtype=torch.int32, device=cuda_device)
    table = ops.topk_segments([(0, d)], 0.25)
    got = fed_topk_ef_cuda(msgs, err, ids, table)
    want = _topk_plain(msgs, err, ids, table)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    assert int((got[0] != 0).sum(1).max()) <= table[0][2]
