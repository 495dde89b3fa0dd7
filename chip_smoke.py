#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches and carries on):

1. device: the card's name and power limit;
2. build: every CUDA kernel of the port from ``kernels/csrc/`` (one
   ``nvcc`` per source, in parallel), with each kernel's registers,
   shared memory and spills from ptxas' report;
3. kernels: each kernel against its plain PyTorch version on the card,
   over a shape grid (B3 and B4 bitwise; B5 and B6 at the hymba-1.5b
   prefill's shapes in bf16 and fp32, B5's bf16 route at every head
   dim, B6's bf16 route also at mamba2-1.3b's width), and timed at the shapes its path gives it beside its plain
   version, a library call (or, for B4, a yardstick) where one exists
   (B3 and its library call also with the L2 evicted before each call;
   B4 also over its chunk edges and edge rows, with the device time of
   each of its device operations),
   and its bound (bytes over 3.35 TB/s, or
   flops over 67 TFLOP/s fp32 for B1-B4 and 989 TFLOP/s bf16 for B5-B6,
   whichever is larger: the H100 SXM data-sheet peaks at its 700 W power
   limit); then the backward kernels of B5 and B6 against their plain
   backward passes over a grid (B5: causal, windowed and full masks, GQA,
   ragged S, D = 32, 64, 96, 128, fp32 and bf16, bf16 on the tensor
   cores; B6: chunk edges, a ragged tail, N = 16, 64, 128, a cotangent
   on h_last, fp32 and bf16, bf16 on the tensor cores)
   and timed at the LM training path's shapes (B5's beside the backward
   of ``F.scaled_dot_product_attention``), each fp32 route at its grid
   case; then B5, B6 and their backward kernels on their fp32 routes,
   and B2 and B4 over the (4, D) message slab, at the federated LM
   path's full-width shapes (B5 forward and backward beside the fp32
   library attention; B4 bitwise on three of its leaves, the 51 M-entry
   embedding among them);
4. service path: the buffered-async service at the full width of
   ``configs/prodlda_synthetic.py`` (V=5000, K=50, encoder 100-100,
   learned priors, L=5 clients, the ``buffered_async`` preset) — a few
   sweeps of ``run_traffic`` with inference, ``shutdown`` and
   ``evaluate``;
5. training path: synchronous training on the batched cohort path at the
   same width, ``Federation.from_spec(...).run()`` then ``evaluate`` for
   the ``pallas-topk``, ``pallas-secure`` and ``dp-transform`` specs, a
   few rounds each; the last secure round's masks must sum to exactly
   +0.0 on the card;
6. Algorithm 1 path: the paper's own system on the host loop
   (``execution.exec_mode="loop"``) at the same width — the default spec
   through ``Federation.from_spec(...).run()`` (20 rounds),
   ``FederatedTrainer`` with adam (20 rounds; DSS and TSS against the
   synthetic ground truth) and ``straggler-heavy`` through the host
   pending list (10 rounds); B2 once per round with an arrival; one
   traced loop round; loop against batched on the card and card against
   CPU, 3 rounds each, within 1e-5;
7. loop transforms: the message transforms on the host loop and in the
   service at the same width — the ``dp-transform``, ``topk-transform``,
   ``secure-transform`` and ``precision-transform`` specs (5 rounds
   each), ``dp-straggler`` and ``dirichlet-noniid`` (10 rounds each),
   ``FederatedTrainer`` with top-k and secure grads (5 rounds), and the
   ``buffered_async`` service with dp and with top-k uploads (8 sweeps);
   B3 or B4 exactly once per round with a transform (one ``(n, D)`` slab
   a round) and once per computed upload; one traced loop round each of
   dp and secure; B3 and B4 bitwise at the (1, D) and (3, D) slabs; card
   against CPU and loop against batched on the card for each loop
   transform (the spec's default widths, 3 rounds), within 1e-5;
8. NTM train mode (``phase_ntm_train_mode``): the train-mode ELBO
   (dropout and reparametrization on the reference's threefry keys) at
   the same width, ``execution.stochastic_loss=True`` through
   ``Federation.from_spec(...).run()`` on the host loop and the batched
   path (10 rounds each, then ``evaluate``; B2 once a round, B1 once a
   held-out batch; one traced loop round), ``launch.train.main --arch
   prodlda-synthetic --ntm`` (20 rounds, every loss finite), card
   against CPU and loop against batched (3 rounds, within 1e-5); then
   gFedNTM-CTM at the width of ``configs/ctm_s2orc.py`` (V=10000, K=25,
   C=768, D = 1 352 150) as ``benchmarks/bench_wmd.py`` runs it: 5 nodes
   with ``fake_contextual_embeddings``, ``FederatedTrainer`` with adam
   (20 rounds, B2 once a round), five node CTMs by
   ``train_centralized``, the AMWMD table (finite; its host time),
   ZeroShotTM (3 rounds) and CombinedTM card against CPU within 1e-5;
9. LM serve path: ``repro_torch.launch.serve`` with hymba-1.5b at full
   width (bf16 activations, the port's seeded init), batch 4 x 2048-token
   prompts and 32 greedy tokens, after one warm-up call: prefill time,
   decode tokens/s, peak memory; B5 and B6 must launch 32 times each
   (once per layer of the prefill); then one traced prefill (busy share,
   finite logits), 8 timed decode steps and one traced;
   LM train path: ``repro_torch.launch.train.main`` with hymba-1.5b at
   full width (bf16 activations over the serve phase's fp32 masters,
   sgd lr 2e-3), 4 steps of 1 x 4096 tokens (the reference's
   ``train_4k`` shape, its global batch of 256 cut to 1 for one card):
   every loss finite; per step, B5 and B6 forward and their backward
   kernels 32 launches each (one per layer), nothing else; step time
   after the warm-up step, peak memory, and the last step traced (busy
   share, device time by kernel);
   LM federation path (``phase_lm_federation``): the registry's
   ``lm_fedavg`` (host loop) and ``lm_dirichlet_topk`` (batched cohort
   path, top-k deltas; also over hymba-1.5b) at the reduced sizes of
   ``tests/test_federated_lm.py``, 3 rounds each, card against CPU
   within 1e-4 (top-k's support flips aside) and loop against batched
   within 1e-5; then hymba-1.5b at full width, 2 of its 32 layers, fp32,
   4 clients of 4 x 2048-token documents through ``Federation.from_spec``
   with the bundle's loss and init: ``lm_dirichlet_topk`` on the batched
   path and ``lm_fedavg`` on the host loop, 3 rounds each (round wall
   time, the traced third round's busy share, peak memory, falling
   losses, the held-out cross-entropy per token); per round B2 once, B4
   once under top-k, B5 and its backward once per layer on the batched
   path (the clients folded into the batch axis) and once per layer and
   client on the loop, B6 and its backward once per layer and client;
   on every path each kernel's launch count is zeroed just before each
   run and read just after; each kernel must have launched once per
   aggregation / round / held-out batch / layer, and params, the
   held-out ELBO and the logits must be finite;
10. profiles: a second service, and one round of each training spec,
   under ``torch.profiler`` — the device's busy share and its top
   kernels;
11. agreement: small service and training runs on the card and on the
    CPU (the plain path the CPU tests hold against the JAX reference)
    from the same weights, within the repo's 1e-5 bound; reduced
    hymba-1.5b prefill + 4 decode steps in fp32, within 2e-4, and its
    ``train_loss`` gradients (every leaf, through the backward kernels)
    within 1e-4.

The line before the last is the ``{"kernels": [...]}`` JSON; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when no CUDA device is visible or the port's sources are not beside it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

# H100 SXM data-sheet peaks at the 700 W power limit
H100_BYTES_PER_S = 3.35e12        # HBM3
H100_FP32_FLOPS = 67e12           # fp32 outside the tensor cores
H100_BF16_FLOPS = 989e12          # bf16 on the tensor cores, dense

# the paper's corpus depth (10 000 train + 1 000 validation docs per
# node); training depth is cut to a few traffic sweeps; widths never are
DOCS_PER_NODE, VAL_DOCS_PER_NODE, SWEEPS = 10_000, 1_000, 8
# the training path: three registry specs on the batched cohort path,
# cut in depth to a few synchronous rounds each
TRAIN_SPECS, TRAIN_ROUNDS = ("pallas-topk", "pallas-secure",
                             "dp-transform"), 5
# Algorithm 1 on the host loop: the default spec and FederatedTrainer cut
# to 20 rounds, straggler-heavy to 10, the two comparisons to 3
ALG1_ROUNDS, STRAGGLER_ROUNDS, COMPARE_ROUNDS = 20, 10, 3
# ProdLDA at prodlda_synthetic width (V=5000, K=50, encoder 100-100,
# learned priors): the 14 leaf sizes, in the port's parameter order
PRODLDA_SEGMENTS = [500_000, 100, 10_000, 100, 5_000, 50, 5_000, 50,
                    250_000, 50, 50, 5_000, 50, 50]
D_MODEL = sum(PRODLDA_SEGMENTS)         # 775 500 parameters


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one call by CUDA events around ``iters`` back-to-back
    calls: device time plus any gap the host leaves between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _trace(run, attempts: int = 3, cpu: bool = False):
    """The device events of one ``torch.profiler`` trace around ``run()``
    (host activity traced too when ``cpu``).  A trace with no device
    event was dropped by the profiler (seen once in about ten runs on the
    card), not a zero: it is taken again, at most ``attempts`` times, and
    then fails."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            return events
    raise AssertionError(f"torch.profiler recorded no device time in "
                         f"{attempts} traces")


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call: the durations of every kernel, copy
    and fill it ran, from a ``torch.profiler`` trace of ``iters`` calls.
    A trace with no device time is a failure, not a zero."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    us = sum(e.time_range.elapsed_us() for e in _trace(run))
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / iters / 1e3


def device_ms_cold(fn, iters: int = 20) -> float:
    """Mean device time of one call with a cold L2: before each call a
    128 MB write evicts the card's 50 MB L2, and only the write's own
    kernels are left out of the sum."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    flush.fill_(0.0)
    torch.cuda.synchronize()
    evict = {e.name for e in _trace(lambda: flush.fill_(1.0))}

    def run():
        for i in range(iters):
            flush.fill_(float(i))
            fn()
    us = sum(e.time_range.elapsed_us() for e in _trace(run)
             if e.name not in evict)
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / iters / 1e3


def bound_ms(nbytes: float, flops: float, peak: float = H100_FP32_FLOPS):
    t_b, t_f = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase_device():
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e})"
    log(f"device: {name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    # IEEE fp32 everywhere: the 1e-5 anchors assume no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{', '.join(_build.SOURCES)} (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, entry in logs.items():
        for fn, regs, spill, smem in ptxas_resources(str(entry["log"])):
            log(f"  ptxas {name}: {fn}: {regs} registers, {smem} bytes "
                f"static smem, spill stores/loads {spill[0]}/{spill[1]} "
                f"bytes")
    smem = _build.load("flash_attention").flash_attention_tc_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    log("  flash_fwd_tc_kernel dynamic shared memory a block: " + ", ".join(
        f"D={d} {smem(d)} bytes" for d in (32, 64, 96, 128)))
    log("  ssd_scan bf16 route dynamic shared memory a block (the larger of "
        "its kernels): " + ", ".join(
            f"P={p} N={n} chunk {q} {b} bytes" for (p, n, q), b in
            zip(((64, 16, 256), (64, 128, 256)),
                _ssd_smem({"a": (64, 16, 256, 1),
                           "b": (64, 128, 256, 1)}).values())))


def ptxas_resources(text: str):
    """(kernel, registers, (spill stores, spill loads), static smem bytes)
    for every entry function in an ``nvcc -Xptxas -v`` log."""
    out, fn, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((_demangle(fn), int(m.group(1)), spill,
                        int(smem.group(1)) if smem else 0))
            fn = None
    return out


def _short_name(name: str) -> str:
    """A profiler event's kernel name without namespace, return type,
    template or call arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split(
        "<")[0].split(" ")[-1]


def _demangle(name: str) -> str:
    try:
        name = subprocess.run(["c++filt", name], capture_output=True,
                              text=True, timeout=30).stdout.strip() or name
    except (OSError, subprocess.TimeoutExpired):
        return name
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def phase_kernels():
    """Kernel vs plain on the card over the grid; timings at the service's
    shapes.  Returns the per-kernel records (launches filled in later)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_aggregate import fed_weighted_sum_cuda
    from repro_torch.kernels.topic_decoder import topic_decoder_cuda
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    # -- B2: Eq. (2) numerator -------------------------------------------
    err_b2 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 2, 5, 16):
            for d in (1, 129, 4097, 775_500):
                x = torch.randn(k, d, generator=g)
                w = torch.rand(k, generator=g) * 2.0
                w[torch.rand(k, generator=g) < 0.4] = 0.0
                x[w == 0.0] = float("nan")     # masked rows may hold NaN
                x, w = x.to(dev, dtype), w.to(dev)
                total = torch.clamp(w.sum(), min=1e-12)
                got = fed_weighted_sum_cuda(x, w) / total
                want = ref.fed_weighted_sum_ref(x, w) / total
                torch.cuda.synchronize()
                e = float(torch.max(torch.abs(got - want)))
                if not e <= 2e-6:
                    raise AssertionError(f"B2 K={k} D={d} {dtype}: "
                                         f"|kernel - plain| {e} > 2e-6")
                err_b2 = max(err_b2, e)
    zero = fed_weighted_sum_cuda(torch.full((4, 17), float("nan"),
                                            device=dev),
                                 torch.zeros(4, device=dev))
    empty = fed_weighted_sum_cuda(torch.zeros(0, 9, device=dev),
                                  torch.zeros(0, device=dev))
    if not (bool((zero == 0).all()) and empty.shape == (9,)
            and bool((empty == 0).all())):
        raise AssertionError("B2: all-zero weights / K=0 must give zeros")
    log(f"B2 fed_weighted_sum: 32 shapes (K in 1,2,5,16 x D in 1,129,4097,"
        f"775500 x fp32,bf16; NaN in zero-weight rows) + all-zero + K=0: "
        f"max |kernel - plain| of the combine {err_b2:.3e} (bound 2e-6)")

    # -- B1: fused decoder forward ---------------------------------------
    err_b1 = 0.0
    for b in (1, 256, 300):
        for k in (1, 50, 512):
            for v in (4999, 5000):
                theta = torch.softmax(torch.randn(b, k, generator=g), -1)
                beta = torch.randn(k, v, generator=g)
                bow = torch.poisson(torch.full((b, v), 0.04), generator=g)
                bow[0] = 0.0                   # zero-bow rows
                bow[-1] = 0.0
                sc = 0.5 + torch.rand(v, generator=g)
                theta, beta, bow, sc = (t.to(dev) for t in
                                        (theta, beta, bow, sc))
                got = topic_decoder_cuda(theta, beta, bow, sc)
                want = ref.topic_decoder_ref(theta, beta, bow, sc)
                torch.cuda.synchronize()
                scale = max(float(torch.max(torch.abs(want))), 1.0)
                e = float(torch.max(torch.abs(got - want))) / scale
                if not e <= 1e-5 or float(got[0]) != 0.0:
                    raise AssertionError(f"B1 B={b} K={k} V={v}: scaled "
                                         f"|kernel - plain| {e} > 1e-5 or "
                                         f"zero-bow row {float(got[0])}")
                err_b1 = max(err_b1, e)
    log(f"B1 topic_decoder: 18 shapes (B in 1,256,300 x K in 1,50,512 x V "
        f"in 4999,5000; zero-bow rows): max |kernel - plain| / max|plain| "
        f"{err_b1:.3e} (bound 1e-5)")

    # -- timings at the service's shapes -----------------------------------
    d_model = D_MODEL
    x = torch.randn(2, d_model, generator=g).to(dev)
    w = torch.tensor([2000.0, 2000.0], device=dev)
    bb, kk, vv = 256, 50, 5000
    theta = torch.softmax(torch.randn(bb, kk, generator=g), -1).to(dev)
    beta = torch.randn(kk, vv, generator=g).to(dev)
    bow = torch.poisson(torch.full((bb, vv), 0.04), generator=g).to(dev)
    sc = 0.5 + torch.rand(vv, generator=g).to(dev)
    calls = {
        "fed_weighted_sum": (lambda: fed_weighted_sum_cuda(x, w),
                             lambda: ref.fed_weighted_sum_ref(x, w),
                             lambda: torch.matmul(w, x)),
        "topic_decoder": (lambda: topic_decoder_cuda(theta, beta, bow, sc),
                          lambda: ref.topic_decoder_ref(theta, beta, bow,
                                                        sc),
                          None)}
    b2 = {"name": "fed_weighted_sum", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/fed_aggregate.cu",
          "replaces": "src/repro/kernels/fed_aggregate.py:97",
          "max_abs_err": err_b2}
    b2["bound_ms"], b2["bound_by"] = bound_ms(
        (2 * d_model + 2 + d_model) * 4, 2 * 2 * d_model)
    b1 = {"name": "topic_decoder", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/topic_decoder.cu",
          "replaces": "src/repro/kernels/topic_decoder.py:75",
          "max_abs_err": err_b1}
    # per (doc, word): the K-term dot (2K flops) + scale, max, exp,
    # sum-exp, bow*logit, bow sum (about 8 more)
    b1["bound_ms"], b1["bound_by"] = bound_ms(
        (bb * kk + kk * vv + bb * vv + vv + bb) * 4,
        bb * vv * (2 * kk + 8))
    for r in (b2, b1):
        kern, plain, lib = calls[r["name"]]
        _time_record(r, kern, plain, lib)
    # B2 also combines the training path's (K=5, D) message slab
    x5 = torch.randn(5, d_model, generator=g).to(dev)
    w5 = torch.full((5,), 10_000.0, device=dev)
    b2k5 = {"name": "fed_weighted_sum (K=5 training slab)"}
    b2k5["bound_ms"], b2k5["bound_by"] = bound_ms(
        (5 * d_model + 5 + d_model) * 4, 2 * 5 * d_model)
    _time_record(b2k5, lambda: fed_weighted_sum_cuda(x5, w5),
                 lambda: ref.fed_weighted_sum_ref(x5, w5),
                 lambda: torch.matmul(w5, x5))
    b2["k5"] = {k: b2k5[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms")}
    records = [b2, b1, _kernel_b3(g, dev), _kernel_b4(g, dev),
               _kernel_b5(g, dev), _kernel_b6(g, dev),
               _kernel_b5_bwd(g, dev), _kernel_b6_bwd(g, dev)]
    _kernel_fed_lm(g, dev, records)
    return records


def _time_record(r, kern, plain, lib, lib_label="library"):
    """Device time of kernel, plain version and library call (or
    yardstick) at the path's shapes, into the record ``r``."""
    r["ms"], r["plain_ms"] = device_ms(kern), device_ms(plain)
    lib_ms = None if lib is None else device_ms(lib)
    r["library_ms" if lib_label == "library" else "yardstick_ms"] = lib_ms
    r.setdefault("library_ms", None)
    per_call = ", ".join(f"{event_ms(f) * 1e3:.2f}"
                         for f in (kern, plain, lib) if f)
    lib_us = "none" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
    log(f"{r['name']}: device {r['ms'] * 1e3:.2f} us/call, plain "
        f"{r['plain_ms'] * 1e3:.2f} us, {lib_label} {lib_us}, bound "
        f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); back-to-back "
        f"calls incl. host gaps (events, kernel/plain/{lib_label}) "
        f"{per_call} us")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two fp32 tensors (every NaN equal to every
    NaN; +0.0 and -0.0 told apart)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, zero, a.view(torch.int32)),
        torch.where(nb, zero, b.view(torch.int32))))


def _kernel_b3(g, dev):
    """B3 (dp / secure apply): bitwise against the plain version over the
    grid; timed at the training path's shape (K=5 clients, D=775 500)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_aggregate import fed_dp_secure_apply_cuda
    scale = 0.3 * 0.05                  # the dp-transform preset's knobs
    n = 0
    for k in (1, 2, 5, 16):
        for d in (1, 129, 4097, D_MODEL):
            x = torch.randn(k, d, generator=g)
            noise = torch.randn(k, d, generator=g)
            masks = torch.randint(-4096, 4097, (k, d), generator=g) \
                .to(torch.float32) * 2.0 ** -10      # the dyadic grid
            coef = torch.rand(k, generator=g) + 1e-3
            w = torch.randint(1, 5000, (k,), generator=g).to(torch.float32)
            w[-1] = 0.0                 # max(w, 1e-9) guards a zero weight
            x, noise, masks, coef, w = (t.to(dev) for t in
                                        (x, noise, masks, coef, w))
            for name, kw in (("dp", dict(noise=noise, clip_coef=coef)),
                             ("secure", dict(masks=masks, weights=w)),
                             ("all", dict(noise=noise, masks=masks,
                                          clip_coef=coef, weights=w))):
                got = fed_dp_secure_apply_cuda(x, noise_scale=scale, **kw)
                want = ref.fed_dp_secure_apply_ref(x, noise_scale=scale,
                                                   **kw)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    e = float(torch.nan_to_num(got - want).abs().max())
                    raise AssertionError(f"B3 {name} K={k} D={d}: kernel "
                                         f"!= plain bitwise (max {e})")
                n += 1
    log(f"B3 fed_dp_secure_apply: {n} cases (K in 1,2,5,16 x D in 1,129,"
        f"4097,{D_MODEL} x dp,secure,all terms; a zero weight among them): "
        f"bitwise equal to the plain version")
    k, d = 5, D_MODEL
    x, noise = torch.randn(k, d, generator=g), torch.randn(k, d, generator=g)
    masks = torch.randint(-4096, 4097, (k, d), generator=g) \
        .to(torch.float32) * 2.0 ** -10
    coef, w = torch.rand(k, generator=g), torch.full((k,), 2000.0)
    x, noise, masks, coef, w = (t.to(dev) for t in (x, noise, masks, coef,
                                                    w))
    rec = {"name": "fed_dp_secure_apply", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/fed_dp_secure.cu",
           "replaces": "src/repro/kernels/fed_aggregate.py:199",
           "max_abs_err": 0.0, "variant": "secure (masks, weights)"}
    # x and masks read, out written; the (K,) weights; add + divide
    rec["bound_ms"], rec["bound_by"] = bound_ms((3 * k * d + k) * 4,
                                                2 * k * d)
    _time_record(rec,
                 lambda: fed_dp_secure_apply_cuda(x, masks=masks, weights=w),
                 lambda: ref.fed_dp_secure_apply_ref(x, masks=masks,
                                                     weights=w),
                 lambda: torch.addcdiv(x, masks, w.clamp_min(1e-9)[:, None]))
    dp = {"name": "fed_dp_secure_apply (dp variant)"}
    dp["bound_ms"], dp["bound_by"] = bound_ms((3 * k * d + k) * 4, 3 * k * d)
    _time_record(dp,
                 lambda: fed_dp_secure_apply_cuda(x, noise=noise,
                                                  clip_coef=coef,
                                                  noise_scale=scale),
                 lambda: ref.fed_dp_secure_apply_ref(x, noise=noise,
                                                     clip_coef=coef,
                                                     noise_scale=scale),
                 None)
    rec.update(dp_ms=dp["ms"], dp_plain_ms=dp["plain_ms"],
               dp_bound_ms=dp["bound_ms"], dp_library_ms=None)
    # the same calls with the L2 evicted before each (the inputs, 46.5 MB,
    # nearly fit the 50 MB L2, so back-to-back calls may find them there)
    rec["cold_ms"] = device_ms_cold(
        lambda: fed_dp_secure_apply_cuda(x, masks=masks, weights=w))
    rec["library_cold_ms"] = device_ms_cold(
        lambda: torch.addcdiv(x, masks, w.clamp_min(1e-9)[:, None]))
    rec["dp_cold_ms"] = device_ms_cold(
        lambda: fed_dp_secure_apply_cuda(x, noise=noise, clip_coef=coef,
                                         noise_scale=scale))
    log(f"fed_dp_secure_apply warm / cold L2 (device us/call): secure "
        f"{rec['ms'] * 1e3:.2f} / {rec['cold_ms'] * 1e3:.2f}, torch.addcdiv "
        f"{rec['library_ms'] * 1e3:.2f} / {rec['library_cold_ms'] * 1e3:.2f}"
        f", dp {rec['dp_ms'] * 1e3:.2f} / {rec['dp_cold_ms'] * 1e3:.2f}; "
        f"bound {rec['bound_ms'] * 1e3:.2f}")
    return rec


def topk_plain(msgs, err_state, ids, table):
    """The plain B4 on whatever device the tensors are on, segment by
    segment (``ops.fed_topk_ef`` takes it only for CPU tensors)."""
    from repro_torch.kernels import ref
    rows = err_state[ids.to(torch.int64)]
    sent, new = torch.empty_like(msgs), torch.empty_like(msgs)
    for off, n, k_keep in table:
        s, e = ref.fed_topk_ef_ref(msgs[:, off:off + n],
                                   rows[:, off:off + n], k_keep)
        sent[:, off:off + n], new[:, off:off + n] = s, e
    return sent, new


def _segments(sizes):
    """``(offset, size)`` of consecutive segments of the given sizes."""
    out, off = [], 0
    for n in sizes:
        out.append((off, n))
        off += n
    return out


def _topk_rows(g, k, d):
    """Message rows for B4: Gaussian, tie-heavy (a few exact values),
    bf16 near-ties (values inside one bf16 step), tiny, and a NaN
    (padded) row, cycled over ``k`` rows."""
    kinds = [torch.randn(d, generator=g),
             torch.randint(-3, 4, (d,), generator=g).to(torch.float32) * 0.25,
             (1.0 + torch.randint(0, 8, (d,), generator=g) * 2.0 ** -12)
             * torch.sign(torch.randn(d, generator=g)),
             torch.randn(d, generator=g) * 1e-3,
             torch.full((d,), float("nan"))]
    return torch.stack([kinds[i % len(kinds)] for i in range(k)])


# the chunk edges of B4's passes (4096 columns a block): segments of 1,
# 4095, 4096, 4097 and 8193 columns at offsets 2 mod 4, between fillers;
# D is 1 mod 4, so message rows and error rows differ in 16-byte phase
B4_EDGE_SIZES = [500, 1, 2, 129, 4097, 9000, 1, 1, 3, 4095, 1, 4096, 4097,
                 3, 8193, 2]


def _topk_edge_rows(g, k, d):
    """The edge rows of B4, cycled over ``k`` rows: all-equal (every key
    a tie across chunks), +-inf and -0.0 among Gaussians, scattered NaNs,
    and an all-NaN row."""
    def sprinkle(value, p):
        x = torch.randn(d, generator=g)
        x[torch.rand(d, generator=g) < p] = value
        return x
    inf = sprinkle(float("inf"), 0.05)
    inf[torch.rand(d, generator=g) < 0.05] = float("-inf")
    kinds = [torch.full((d,), -0.375), inf, sprinkle(-0.0, 0.7),
             sprinkle(float("nan"), 0.05), torch.full((d,), float("nan"))]
    return torch.stack([kinds[i % len(kinds)] for i in range(k)])


def _b4_bitwise(got, want, what):
    for a, b, out in zip(got, want, ("sent", "new_err")):
        if not same_bits(a, b):
            raise AssertionError(f"B4 {what}: {out} kernel != plain bitwise")


def _kernel_b4(g, dev):
    """B4 (top-k with error feedback per leaf segment): bitwise against
    the plain version over the grid, then over the chunk edges, edge rows
    and a misaligned message slab; timed at the training path's shape
    (K=5 rows, the ProdLDA segment table, frac 0.25), with the device
    time of each of its device operations."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fed_aggregate import fed_topk_ef_cuda
    sizes = PRODLDA_SEGMENTS + [1, 2, 129, 4097]
    segs, d = _segments(sizes), sum(sizes)
    cases = 0
    for k in (1, 5, 16):
        msgs = _topk_rows(g, k, d).to(dev)
        err = torch.cat([torch.randn(1, d, generator=g) * 0.1,
                         torch.zeros(3, d),
                         torch.randn(1, d, generator=g) * 1e-4]).to(dev)
        ids = torch.tensor([(0, 1, 1, 4, 2)[i % 5] for i in range(k)],
                           dtype=torch.int32, device=dev)
        for frac in (0.01, 0.25, 0.5, 1.0):
            table = ops.topk_segments(segs, frac)
            got = fed_topk_ef_cuda(msgs, err, ids, table)
            want = topk_plain(msgs, err, ids, table)
            torch.cuda.synchronize()
            _b4_bitwise(got, want, f"K={k} frac={frac}")
            kept = [int((got[0][:, o:o + n] != 0).sum(1).max())
                    for o, n, _ in table]
            if any(c > kk for c, (_, _, kk) in zip(kept, table)):
                raise AssertionError(f"B4 K={k} frac={frac}: kept more "
                                     f"than k_keep in a segment")
            cases += 1
    # the edges, on a generator of their own (the timing input below keeps
    # the draws of g it always had)
    ge = torch.Generator().manual_seed(16)
    segs_e, d_e = _segments(B4_EDGE_SIZES), sum(B4_EDGE_SIZES)
    edge = 0
    rows_e = torch.cat([_topk_edge_rows(ge, 5, d_e),
                        _topk_rows(ge, 4, d_e)])
    err = torch.randn(5, d_e, generator=ge) * 0.1
    err[3] = -0.0                      # the -0.0 row's error row: stays -0.0
    err = err.to(dev)
    for k in (3, 9):
        msgs = rows_e[:k].to(dev)
        ids = torch.tensor((0, 1, 3, 4, 2, 0, 1, 2, 4)[:k], dtype=torch.int32,
                           device=dev)
        shifted = torch.empty(msgs.numel() + 1, device=dev)[1:].view(
            msgs.shape)
        shifted.copy_(msgs)
        for frac in (0.01, 0.25, 1.0):
            table = ops.topk_segments(segs_e, frac)
            want = topk_plain(msgs, err, ids, table)
            for m in (msgs, shifted):
                _b4_bitwise(fed_topk_ef_cuda(m, err, ids, table), want,
                            f"edges K={k} frac={frac}")
                edge += 1
    torch.cuda.synchronize()
    log(f"B4 fed_topk_ef: {cases} cases (K in 1,5,16 rows over L=5 with "
        f"repeated ids; {len(sizes)} segments = the ProdLDA table + 1,2,129,"
        f"4097; frac in 0.01,0.25,0.5,1.0; Gaussian, tie-heavy, bf16 "
        f"near-tie, tiny and NaN rows) + {edge} edge cases (segments of 1, "
        f"4095, 4096, 4097, 8193 columns at offsets 2 mod 4, D = 1 mod 4; "
        f"all-equal, +-inf, -0.0, scattered-NaN and NaN rows; frac in 0.01,"
        f"0.25,1.0; K in 3,9; the slab also off 16 bytes): sent and "
        f"new_err bitwise equal to the plain version")
    k = 5
    table = ops.topk_segments(_segments(PRODLDA_SEGMENTS), 0.25)
    msgs = torch.randn(k, D_MODEL, generator=g).to(dev) * 1e-3
    err = torch.randn(k, D_MODEL, generator=g).to(dev) * 1e-4
    ids = torch.arange(k, dtype=torch.int32, device=dev)
    magq = (msgs + err).abs().to(torch.bfloat16).to(torch.float32)
    rec = {"name": "fed_topk_ef", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/fed_topk_ef.cu",
           "replaces": "src/repro/kernels/fed_aggregate.py:141",
           "max_abs_err": 0.0,
           "yardstick": "torch.topk on the bf16 keys, per segment "
                        "(selection only; keeps an arbitrary tie)"}
    # msgs, the (L, D) error memory and the ids read; sent, new_err written
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (4 * k * D_MODEL + k) * 4, 2 * k * D_MODEL)
    _time_record(rec, lambda: fed_topk_ef_cuda(msgs, err, ids, table),
                 lambda: topk_plain(msgs, err, ids, table),
                 lambda: [torch.topk(magq[:, o:o + n], kk, dim=1)
                          for o, n, kk in table], lib_label="yardstick")
    # each device operation of one call (kernels and the memset)
    calls, by = 10, {}
    events = _trace(lambda: [fed_topk_ef_cuda(msgs, err, ids, table)
                             for _ in range(calls)])
    for e in events:
        name = _short_name(e.name) or e.name
        by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / calls
    rec["launch_us"] = by
    rec["device_ops_per_call"] = len(events) / calls
    log(f"  fed_topk_ef at the path's shape: {rec['device_ops_per_call']:g} "
        f"device operations a call; device us/call by operation: "
        + ", ".join(f"{n} {us:.2f}" for n, us in by.items())
        + f" (sum {sum(by.values()):.2f}; bound {rec['bound_ms'] * 1e3:.2f})")
    return rec


# hymba-1.5b prefill at the serve phase's shape: batch 4 x 2048 tokens,
# 25 query / 5 kv heads of 64, window 1024; 50 SSD heads of P=64, N=16,
# chunk 256
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
B5_CASES = [  # (b, hq, hkv, s, d, causal, window, dtype)
    (LM_BATCH, 25, 5, LM_PROMPT, 64, True, 1024, torch.bfloat16),  # path
    (1, 25, 5, LM_PROMPT, 64, True, 1024, torch.float32),
    (2, 4, 2, 96, 64, True, 64, torch.float32),     # reduced hymba
    (1, 8, 2, 100, 32, True, 0, torch.bfloat16),    # ragged, no window
    (1, 4, 4, 193, 96, False, 0, torch.float32),    # bidirectional
    # every head dim of the bf16 tensor-core route, and its non-causal
    # window
    (1, 4, 4, 193, 96, False, 0, torch.bfloat16),
    (2, 10, 2, 300, 128, True, 100, torch.bfloat16),
    (1, 6, 2, 257, 64, False, 64, torch.bfloat16),
]
B6_CASES = [  # (b, s, h, p, n, chunk, dtype)
    (LM_BATCH, LM_PROMPT, 50, 64, 16, 256, torch.bfloat16),       # path
    (2, LM_PROMPT, 50, 64, 16, 256, torch.float32),
    (2, 96, 16, 32, 16, 64, torch.float32),         # reduced hymba
    (1, 100, 2, 16, 8, 32, torch.float32),          # ragged tail
    (1, 64, 1, 64, 128, 64, torch.bfloat16),        # N > 16
    # mamba2-1.3b's width (64 heads of P=64, N=128, chunk 256): the
    # tensor-core route only (the fp32 kernel has not the shared memory)
    (1, LM_PROMPT, 64, 64, 128, 256, torch.bfloat16),
]
# hymba-1.5b training at the reference's train_4k shape (sequence 4096),
# its global batch of 256 cut to 1 for one card; 4 sgd steps
TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_STEPS = 1, 4096, 4
BF16, FP32 = torch.bfloat16, torch.float32
B5_BWD_CASES = [  # (b, hq, hkv, s, d, causal, window, dtype)
    (TRAIN_LM_BATCH, 25, 5, TRAIN_LM_SEQ, 64, True, 1024, BF16),  # path
    (1, 25, 5, 1024, 64, True, 256, FP32),
    *[(b, hq, hkv, s, d, causal, window, dt)
      for b, hq, hkv, s, d, causal, window in (
          (2, 4, 2, 70, 32, True, 16),      # GQA, window, ragged
          (1, 5, 1, 130, 64, True, 0),      # MQA, causal
          (1, 3, 3, 100, 96, False, 0),     # full
          (1, 4, 2, 77, 128, False, 20),    # bidirectional window
          (1, 4, 2, 256, 64, True, 40),     # window edge inside a tile
          (1, 5, 1, 129, 96, True, 0))      # a ragged tail of one row
      for dt in (FP32, BF16)],
]
B6_BWD_CASES = [  # (b, s, h, p, n, chunk, dtype); h_last gets a cotangent
    (TRAIN_LM_BATCH, TRAIN_LM_SEQ, 50, 64, 16, 256, BF16),  # path
    (1, 1024, 50, 64, 16, 256, FP32),
    (2, 64, 3, 16, 16, 32, FP32), (2, 64, 3, 16, 16, 32, BF16),
    (1, 100, 2, 32, 16, 48, FP32), (1, 100, 2, 32, 16, 48, BF16),
    (1, 257, 2, 64, 16, 256, BF16),     # one past a chunk edge
    (1, 255, 3, 64, 16, 64, FP32),      # one short of one
    (1, 128, 2, 64, 64, 64, FP32), (1, 128, 2, 64, 64, 64, BF16),
    (1, 200, 2, 64, 128, 128, BF16),
    (1, LM_PROMPT, 64, 64, 128, 256, BF16),   # mamba2-1.3b's width
]


def _window_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask allows over one (batch, head)."""
    q = torch.arange(s, dtype=torch.int64)
    hi = q if causal else torch.full_like(q, s - 1)
    lo = (q - window + 1).clamp(min=0) if window else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def _kernel_b5(g, dev):
    """B5 (flash attention): against the plain version on the card over
    the grid (q, k, v as slices of one fused projection, read in place);
    timed at the hymba prefill's shape in bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.layers.attention import make_mask
    errs = {}
    for b, hq, hkv, s, d, causal, window, dtype in B5_CASES:
        fused = torch.randn(b, s, hq + 2 * hkv, d, generator=g).to(dev,
                                                                   dtype)
        q, k, v = fused.split([hq, hkv, hkv], dim=2)
        got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   scale=d ** -0.5).float()
        want = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2).float()
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        e = float((got - want).abs().max())
        if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
            raise AssertionError(f"B5 {(b, hq, hkv, s, d, causal, window)} "
                                 f"{dtype}: |kernel - plain| {e} beyond "
                                 f"{tol} + {tol}|plain|")
        key = str(dtype).replace("torch.", "")
        errs[key] = max(errs.get(key, 0.0), e)
        del fused, q, k, v, got, want
    log(f"B5 flash_attention: {len(B5_CASES)} shapes (the hymba prefill's "
        f"(4, 2048, 25/5 heads, 64, window 1024) in bf16 and fp32, reduced "
        f"hymba, ragged, bidirectional D=96 in both dtypes; bf16 at D=32, "
        f"64, 96, 128, non-causal with a window): max |kernel - plain| "
        f"{errs} (bounds 2e-5 fp32, 2e-2 bf16, abs + rel)")
    b, hq, hkv, s, d, causal, window, dtype = B5_CASES[0]
    q = torch.randn(b, s, hq, d, generator=g).to(dev, dtype)
    k = torch.randn(b, s, hkv, d, generator=g).to(dev, dtype)
    v = torch.randn(b, s, hkv, d, generator=g).to(dev, dtype)
    # the library call takes (B, H, S, D) and a boolean mask
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pos = torch.arange(s, device=dev)
    mask = make_mask(pos, pos, causal=causal, window=window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = b * hq * _window_pairs(s, causal, window)
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:79",
           "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
           "pairs": pairs,
           "library": "F.scaled_dot_product_attention(boolean window mask, "
                      "enable_gqa=True) on (B,H,S,D) copies"}
    # q, k, v read once, out written once (bf16); QK^T and PV over the
    # (q, k) pairs the window reaches, at the bf16 tensor-core peak
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        2 * (2 * b * s * hq * d + 2 * b * s * hkv * d), 4 * d * pairs,
        H100_BF16_FLOPS)
    _time_record(rec,
                 lambda: flash_attention_cuda(q, k, v, causal=causal,
                                              window=window,
                                              scale=d ** -0.5),
                 lambda: ref.flash_attention_ref(
                     q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), causal=causal, window=window),
                 lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    return rec


def _ssd_inputs(g, dev, b, s, h, p, n, dtype):
    """x, B, C as column slices of one conv output (strided, as the
    model path gives them), dt and a as mamba2_apply makes them."""
    conv = torch.randn(b, s, h * p + 2 * n, generator=g).to(dev, dtype)
    xs, bb, cc = conv.split([h * p, n, n], dim=-1)
    dt = (0.001 + 0.099 * torch.rand(b, s, h, generator=g)).to(dev)
    a = -torch.arange(1, h + 1, dtype=torch.float32).to(dev)
    return xs.reshape(b, s, h, p), dt, a, bb, cc


def _kernel_b6(g, dev):
    """B6 (SSD scan): against the plain version on the card over the
    grid; timed at the hymba prefill's shape in bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    errs = {}
    for b, s, h, p, n, chunk, dtype in B6_CASES:
        x, dt, a, bb, cc = _ssd_inputs(g, dev, b, s, h, p, n, dtype)
        y, hl = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk)
        y_w, hl_w = ref.ssd_scan_ref(x, dt, a, bb, cc, chunk)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        key = str(dtype).replace("torch.", "")
        for got, want, what in ((y, y_w, "y"), (hl, hl_w, "h_last")):
            scale = max(float(want.float().abs().max()), 1.0)
            e = float((got.float() - want.float()).abs().max())
            if not e <= tol * scale:
                raise AssertionError(f"B6 {(b, s, h, p, n, chunk)} {dtype} "
                                     f"{what}: |kernel - plain| {e} > "
                                     f"{tol} x {scale:.3g}")
            errs[key] = max(errs.get(key, 0.0), e)
        del x, dt, a, bb, cc, y, hl, y_w, hl_w
    log(f"B6 ssd_scan: {len(B6_CASES)} shapes (the hymba prefill's (4, 2048, "
        f"50 heads, P=64, N=16, chunk 256) in bf16 and fp32, reduced hymba, "
        f"ragged, N=128, mamba2-1.3b's (2048, 64 heads, P=64, N=128, chunk "
        f"256) in bf16; x/B/C strided; bf16 on the tensor cores, fp32 on "
        f"the CUDA cores): max |kernel - plain| {errs} (bounds 1e-4 fp32, "
        f"2e-2 bf16, of max|plain|)")
    b, s, h, p, n, chunk, dtype = B6_CASES[0]
    x, dt, a, bb, cc = _ssd_inputs(g, dev, b, s, h, p, n, dtype)
    rec = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:80",
           "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
           "design": "bf16: wgmma in three launches (ssd_chunk_state_kernel,"
                     " ssd_state_pass_kernel, ssd_chunk_scan_kernel); fp32: "
                     "ssd_scan_kernel on the CUDA cores",
           "ptxas": _ptxas_record("ssd_scan", ("ssd_chunk_", "ssd_state_")),
           "smem_bytes": _ssd_smem({"hymba": (p, n, chunk, 1),
                                    "mamba2": (64, 128, 256, 1)}),
           "library": "none: no single PyTorch call computes the SSD scan"}
    # x, B, C (bf16) and dt, a (fp32) read once, y (bf16) and h_last (fp32)
    # written once; per (batch, head, chunk) the lower triangle of C B^T
    # (2N) and of the weighted X product (2P) plus the decay and dt
    # products (2), the carried-state term and the state update (2 x 2PN
    # per step), at the bf16 tensor-core peak
    tri = chunk * (chunk + 1) // 2
    flops = b * h * (s // chunk) * (tri * (2 * n + 2 * p + 2)
                                    + chunk * 4 * p * n)
    nbytes = 2 * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h) \
        + 4 * b * h * p * n
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops,
                                                H100_BF16_FLOPS)
    _time_record(rec, lambda: ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk),
                 lambda: ref.ssd_scan_ref(x, dt, a, bb, cc, chunk), None)
    # the bf16 route's three launches, one by one
    by = _device_ops(lambda: ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk),
                     10)
    rec["launch_us"] = by
    log(f"  ssd_scan bf16 launches at the path's shape (device us/call): "
        + ", ".join(f"{k} {v:.2f}" for k, v in by.items()))
    del x, dt, a, bb, cc
    x, dt, a, bb, cc = _ssd_inputs(g, dev, 1, LM_PROMPT, 64, 64, 128,
                                   torch.bfloat16)
    rec["mamba2_ms"] = device_ms(lambda: ssd_scan_cuda(x, dt, a, bb, cc,
                                                       chunk=256))
    log(f"  ssd_scan at mamba2-1.3b's width (1, 2048, 64 heads, P=64, "
        f"N=128, chunk 256, bf16): device {rec['mamba2_ms'] * 1e3:.2f} "
        f"us/call")
    return rec


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| (in fp32)."""
    want = want.float()
    return float((got.float() - want).abs().max()) \
        / max(float(want.abs().max()), 1e-30)


def _device_ops(fn, calls: int = 5) -> dict:
    """Device time per call (us) of each device operation of ``fn``."""
    by = {}
    for e in _trace(lambda: [fn() for _ in range(calls)]):
        name = _short_name(e.name)
        by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return by


def _kernel_b5_bwd(g, dev):
    """B5's backward kernel against ``ref.flash_attention_bwd_ref`` on the
    card over the grid (q, k, v strided slices of one fused projection;
    out and lse from the forward kernel); timed at the LM training path's
    shape in bf16 beside the backward of the library's attention."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.models.layers.attention import make_mask
    errs, worst = {}, 0.0

    def inputs(b, hq, hkv, s, d, causal, window, dtype):
        fused = torch.randn(b, s, hq + 2 * hkv, d, generator=g).to(dev,
                                                                   dtype)
        q, k, v = fused.split([hq, hkv, hkv], dim=2)
        dout = torch.randn(b, s, hq, d, generator=g).to(dev, dtype)
        kw = dict(causal=causal, window=window, scale=d ** -0.5)
        out, lse = flash_attention_cuda(q, k, v, want_lse=True, **kw)
        return q, k, v, out, lse, dout, kw
    for case in B5_BWD_CASES:
        dtype = case[-1]
        q, k, v, out, lse, dout, kw = inputs(*case)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        _, lse_w = ref.flash_attention_fwd_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == FP32 else 2e-2
        rel = [_rel_err(a, w) for a, w in zip(got, want)]
        e_lse = float((lse - lse_w).abs().max())
        if not (max(rel) <= tol and e_lse <= tol * max(
                float(lse_w.abs().max()), 1.0)):
            raise AssertionError(f"B5 backward {case[:-1]} {dtype}: (dq, dk, "
                                 f"dv) |kernel - plain| / max|plain| {rel}, "
                                 f"lse {e_lse}; bound {tol}")
        key = str(dtype).replace("torch.", "")
        errs[key] = max([errs.get(key, 0.0)]
                        + [float((a.float() - w.float()).abs().max())
                           for a, w in zip(got, want)])
        worst = max(worst, max(rel))
        del q, k, v, out, lse, dout, got, want
    log(f"B5 flash_attention backward: {len(B5_BWD_CASES)} shapes (the "
        f"training path's (1, 4096, 25/5 heads, 64, window 1024) bf16, "
        f"(1, 1024, 25/5, 64, window 256) fp32; causal, windowed and full "
        f"masks, GQA and MQA, ragged S down to a one-row tail, a window "
        f"edge inside a tile, D=32, 64, 96, 128 in both dtypes; bf16 on "
        f"the tensor cores, fp32 on the CUDA cores): max |kernel - plain| "
        f"{errs}, of max|plain| {worst:.3e} (bounds 2e-5 fp32, 2e-2 bf16, "
        f"of each gradient's max|plain|)")
    b, hq, hkv, s, d, causal, window, dtype = B5_BWD_CASES[0]
    q, k, v, out, lse, dout, kw = inputs(*B5_BWD_CASES[0])
    pairs = b * hq * _window_pairs(s, causal, window)
    rec = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/layers/attention.py:143",
           "replaces_note": "no TPU kernel: the reference's jnp VJP "
                            "_flash_vjp_bwd of B5",
           "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
           "pairs": pairs,
           "routes": {"bfloat16": "wgmma", "float32": "simt"},
           "design": "bf16: wgmma in three launches (flash_bwd_dq_tc_kernel"
                     ", flash_bwd_dkdv_tc_kernel per query head, "
                     "flash_bwd_group_sum_kernel); fp32: flash_bwd_dq_kernel"
                     " and flash_bwd_dkdv_kernel on the CUDA cores",
           "ptxas": _ptxas_record("flash_attention_bwd", ("flash_bwd_",)),
           "library": "backward of F.scaled_dot_product_attention(boolean "
                      "window mask, enable_gqa=True) on (B,H,S,D) copies"}
    # q, k, v, out, dout (bf16) and lse (fp32) read once, dq, dk, dv
    # (bf16) written once; 10 D flops per (q, k) pair the window reaches
    # (s and dout.v recomputed, dv, dq, dk) at the bf16 tensor-core peak
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        2 * (3 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * hq * s
        + 2 * (b * s * hq * d + 2 * b * s * hkv * d), 10 * d * pairs,
        H100_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    pos = torch.arange(s, device=dev)
    mask = make_mask(pos, pos, causal=causal, window=window)
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    dout_t = dout.transpose(1, 2).contiguous()
    _time_record(rec,
                 lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                  **kw),
                 lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                     **kw),
                 lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,
                                             retain_graph=True))
    rec["launch_us"] = _device_ops(
        lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw))
    rec["device_ops_per_call"] = len(rec["launch_us"])
    rec["fwd_lse_ms"] = device_ms(
        lambda: flash_attention_cuda(q, k, v, want_lse=True, **kw))
    rec["fwd_ms"] = device_ms(lambda: flash_attention_cuda(q, k, v, **kw))
    log(f"  flash_attention backward launches at the path's shape (device "
        f"us/call): " + ", ".join(f"{k_} {v_:.2f}" for k_, v_ in
                                  rec["launch_us"].items())
        + f"; the forward at the same shape {rec['fwd_ms'] * 1e3:.2f} us, "
        f"{rec['fwd_lse_ms'] * 1e3:.2f} us when it also writes lse")
    del q, k, v, out, lse, dout, qt, kt, vt, lib_out, dout_t
    # the fp32 route at its grid case
    case = B5_BWD_CASES[1]
    q, k, v, out, lse, dout, kw = inputs(*case)
    rec["fp32_case"] = list(case[:-1])
    rec["fp32_ms"] = device_ms(
        lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw))
    log(f"  flash_attention backward fp32 (CUDA cores) at {case[:-1]}: "
        f"device {rec['fp32_ms'] * 1e3:.2f} us/call")
    del q, k, v, out, lse, dout
    return rec


def _kernel_b6_bwd(g, dev):
    """B6's backward kernel against ``ref.ssd_scan_bwd_ref`` on the card
    over the grid (x, B, C strided slices of one conv output, states kept
    by the forward kernel, a cotangent on h_last); timed at the LM
    training path's shape in bf16 (h_last unused there, as in the
    model)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    errs, worst = {}, 0.0
    for i, (b, s, h, p, n, chunk, dtype) in enumerate(B6_BWD_CASES):
        x, dt, a, bb, cc = _ssd_inputs(g, dev, b, s, h, p, n, dtype)
        dy = torch.randn(b, s, h, p, generator=g).to(dev, dtype)
        dh = None if i == 0 else torch.randn(b, h, p, n, generator=g).to(dev)
        _, _, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk,
                                 keep_states=True)
        got = ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, dh, chunk=chunk)
        want = ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, dh, chunk)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == FP32 else 2e-2
        rel = [_rel_err(u, w) for u, w in zip(got, want)]
        if not max(rel) <= tol:
            raise AssertionError(f"B6 backward {(b, s, h, p, n, chunk)} "
                                 f"{dtype}: (dx, ddt, da, db, dc) |kernel - "
                                 f"plain| / max|plain| {rel}; bound {tol}")
        key = str(dtype).replace("torch.", "")
        errs[key] = max([errs.get(key, 0.0)]
                        + [float((u.float() - w.float()).abs().max())
                           for u, w in zip(got, want)])
        worst = max(worst, max(rel))
        del x, dt, a, bb, cc, dy, dh, st, got, want
    log(f"B6 ssd_scan backward: {len(B6_BWD_CASES)} shapes (the training "
        f"path's (1, 4096, 50 heads, P=64, N=16, chunk 256) bf16, its 1024 "
        f"steps in fp32; chunk edges, ragged tails, N=16, 64, 128, "
        f"mamba2-1.3b's width; a cotangent on h_last but at the path's "
        f"shape): max |kernel - plain| {errs}, of max|plain| {worst:.3e} "
        f"(bounds 1e-4 fp32, 2e-2 bf16, of each gradient's max|plain|)")
    b, s, h, p, n, chunk, dtype = B6_BWD_CASES[0]
    x, dt, a, bb, cc = _ssd_inputs(g, dev, b, s, h, p, n, dtype)
    dy = torch.randn(b, s, h, p, generator=g).to(dev, dtype)
    _, _, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk, keep_states=True)
    nc = s // chunk
    rec = {"name": "ssd_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
           "replaces": "src/repro/models/layers/mamba2.py:75",
           "replaces_note": "no TPU kernel: jax.grad of the reference's "
                            "ssd_chunked (B6's backward)",
           "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
           "routes": {"bfloat16": "wgmma", "float32": "simt"},
           "design": "bf16: wgmma in four launches (ssd_bwd_rows_tc_kernel, "
                     "ssd_bwd_state_pass_kernel, ssd_bwd_cols_tc_kernel, "
                     "ssd_bwd_reduce_kernel); fp32: ssd_bwd_rows_kernel and "
                     "ssd_bwd_cols_kernel on the CUDA cores, with the same "
                     "state pass and head sums",
           "ptxas": _ptxas_record("ssd_scan_bwd", ("ssd_bwd_rows_tc",
                                                   "ssd_bwd_cols_tc")),
           "smem_bytes": _ssd_smem({"hymba": (p, n, chunk, 1),
                                    "mamba2": (64, 128, 256, 1),
                                    "fp32_hymba": (p, n, chunk, 0)},
                                   backward=True),
           "library": "none: no single PyTorch call computes the SSD scan's "
                      "gradient"}
    # x, B, C, dy (bf16), dt, a and the kept states (fp32) read once; dx,
    # dB, dC (bf16), ddt, da (fp32) written once; per (batch, head, chunk)
    # the pairs j <= i take G, D and the dx, dB, dC updates (6N + 4P
    # flops) and every step the carried-state terms (8PN), at the bf16
    # tensor-core peak
    tri = chunk * (chunk + 1) // 2
    flops = b * h * nc * (tri * (6 * n + 4 * p) + chunk * 8 * p * n)
    nbytes = 2 * (3 * b * s * h * p + 4 * b * s * n) \
        + 4 * (2 * b * s * h + 2 * h + b * h * nc * p * n)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops,
                                                H100_BF16_FLOPS)
    _time_record(rec, lambda: ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st,
                                                None, chunk=chunk),
                 lambda: ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, None,
                                              chunk), None)
    rec["launch_us"] = _device_ops(
        lambda: ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, None,
                                  chunk=chunk))
    rec["device_ops_per_call"] = len(rec["launch_us"])
    rec["fwd_states_ms"] = device_ms(
        lambda: ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk,
                              keep_states=True))
    log(f"  ssd_scan backward launches at the path's shape (device "
        f"us/call): " + ", ".join(f"{k_} {v_:.2f}" for k_, v_ in
                                  rec["launch_us"].items())
        + f"; the forward at the same shape {rec['fwd_states_ms'] * 1e3:.2f}"
        f" us; shared memory a block {rec['smem_bytes']}")
    del x, dt, a, bb, cc, dy, st
    # the fp32 route at its grid case
    case = B6_BWD_CASES[1]
    b, s, h, p, n, chunk, dtype = case
    x, dt, a, bb, cc = _ssd_inputs(g, dev, b, s, h, p, n, dtype)
    dy = torch.randn(b, s, h, p, generator=g).to(dev, dtype)
    _, _, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk, keep_states=True)
    rec["fp32_case"] = list(case[:-1])
    rec["fp32_ms"] = device_ms(
        lambda: ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, None,
                                  chunk=chunk))
    log(f"  ssd_scan backward fp32 (CUDA cores) at {case[:-1]}: device "
        f"{rec['fp32_ms'] * 1e3:.2f} us/call")
    del x, dt, a, bb, cc, dy, st
    return rec


# federated LM training at hymba-1.5b's full width (2 of its 32 layers):
# 4 clients of 4 x 2048-token documents, fp32 as the reference federates
FED_LM_LAYERS, FED_LM_CLIENTS, FED_LM_BATCH, FED_LM_SEQ = 2, 4, 4, 2048
# documents per node: dirichlet(0.3) over 4 nodes leaves no client empty
# at 8 (3, 5, 14 and 10 documents; one client ragged under the batch of 4)
FED_LM_DOCS, FED_LM_VAL_DOCS, FED_LM_ROUNDS = 8, 1, 3
# client sgd lr: the registry's 0.1 is sized for the reduced configs; at
# full width sgd at 0.1 overshoots by the third top-k round (losses 10.81,
# 8.56, 11.18 on an H100)
FED_LM_LR = 0.02


def _fed_lm_config():
    from repro_torch.configs import get_config
    import dataclasses
    return dataclasses.replace(get_config("hymba-1.5b"),
                               num_layers=FED_LM_LAYERS)


def _fed_lm_leaf_sizes(cfg) -> dict:
    """Entries of each leaf of the engine's flat LM dict (the reference's
    leaves, layers stacked), by name in its order: one layer at vocabulary
    1 is
    drawn on the CPU for the shapes, the rest is arithmetic."""
    import dataclasses
    from repro_torch.models import transformer as tfm
    one = tfm.stack_layers(tfm.init_params(
        torch.Generator().manual_seed(0),
        dataclasses.replace(cfg, num_layers=1, vocab_size=1), device="cpu"))
    sizes = {}
    for name, t in one.items():
        n = t.numel()
        if name.startswith("layers."):
            n *= cfg.num_layers
        elif name in ("embed.table", "lm_head.w"):
            n *= cfg.vocab_size
        sizes[name] = n
    return sizes


def _fed_lm_time(rec, kern, plain, lib, plain_iters=3):
    """Device time of kernel, plain version and library call at the
    federated LM path's shapes (fewer plain calls: they take up to a
    second each here)."""
    rec["ms"] = device_ms(kern, 10)
    rec["plain_ms"] = device_ms(plain, plain_iters)
    rec["library_ms"] = None if lib is None else device_ms(lib, 10)


def _kernel_fed_lm(g, dev, records):
    """The kernels at the federated LM path's full-width shapes (phase
    ``lm_federation``): B5 and its backward in fp32 on the batched cohort
    path's folded batch (4 clients x 4 documents), beside the fp32
    library attention with the same window mask, forward and backward;
    B6 and its backward in fp32 at one client's batch (the rule runs one
    call per client); B2 and B4 over the (4, D) message slab of the 2-layer
    hymba-1.5b (D = 203 403 400, one B4 segment per leaf, the embedding
    51 201 600), B4 bitwise against its plain version on three leaves.
    Each record of ``records`` gains a ``fed_lm`` entry."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fed_aggregate import (fed_topk_ef_cuda,
                                                   fed_weighted_sum_cuda)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    from repro_torch.models.layers.attention import make_mask
    from repro_torch.models.layers.mamba2 import mamba2_dims
    t_start = time.perf_counter()
    cfg = _fed_lm_config()
    by_name = {r["name"]: r for r in records}
    out = {}
    # -- B5 and its backward, fp32, the folded cohort ----------------------
    b = FED_LM_CLIENTS * FED_LM_BATCH
    s, hq, hkv, d = FED_LM_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.sliding_window
    kw = dict(causal=True, window=window, scale=d ** -0.5)
    q = torch.randn(b, s, hq, d, generator=g).to(dev)
    k = torch.randn(b, s, hkv, d, generator=g).to(dev)
    v = torch.randn(b, s, hkv, d, generator=g).to(dev)
    dout = torch.randn(b, s, hq, d, generator=g).to(dev)
    o, lse = flash_attention_cuda(q, k, v, want_lse=True, **kw)
    o_w, lse_w = ref.flash_attention_fwd_ref(q, k, v, **kw)
    grads = flash_attention_bwd_cuda(q, k, v, o, lse, dout, **kw)
    grads_w = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, **kw)
    torch.cuda.synchronize()
    e5 = _rel_err(o, o_w)
    e5b = max(_rel_err(a, w) for a, w in zip(grads, grads_w))
    if not (e5 <= 2e-5 and e5b <= 2e-5):
        raise AssertionError(f"B5 fp32 at the federated LM shape: |kernel - "
                             f"plain| / max|plain| out {e5}, grads {e5b} > "
                             f"2e-5")
    del o_w, lse_w, grads, grads_w
    pairs = b * hq * _window_pairs(s, True, window)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    pos = torch.arange(s, device=dev)
    mask = make_mask(pos, pos, causal=True, window=window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = {"shape": [b, s, hq, hkv, d, window], "dtype": "float32",
           "route": "simt", "max_rel_err": e5}
    # q, k, v read and out written once (fp32); QK^T and PV over the
    # pairs the window reaches, at the fp32 CUDA-core peak
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        4 * (2 * b * s * hq * d + 2 * b * s * hkv * d), 4 * d * pairs)
    _fed_lm_time(rec, lambda: flash_attention_cuda(q, k, v, **kw),
                 lambda: ref.flash_attention_fwd_ref(q, k, v, **kw),
                 lambda: sdpa(qt.detach(), kt.detach(), vt.detach(),
                              attn_mask=mask, enable_gqa=True))
    out["flash_attention"] = rec
    lib_out = sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    dout_t = dout.transpose(1, 2).contiguous()
    rec = {"shape": [b, s, hq, hkv, d, window], "dtype": "float32",
           "route": "simt", "max_rel_err": e5b}
    # q, k, v, out, dout, lse read and dq, dk, dv written once (fp32); 10 D
    # flops a pair, at the fp32 CUDA-core peak
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        4 * (3 * b * s * hq * d + 2 * b * s * hkv * d + b * hq * s
             + b * s * hq * d + 2 * b * s * hkv * d), 10 * d * pairs)
    _fed_lm_time(rec, lambda: flash_attention_bwd_cuda(q, k, v, o, lse, dout,
                                                       **kw),
                 lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                                     **kw),
                 lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,
                                             retain_graph=True))
    out["flash_attention_bwd"] = rec
    del q, k, v, dout, o, lse, qt, kt, vt, lib_out, dout_t
    # -- B6 and its backward, fp32, one client's batch ---------------------
    _, h, _ = mamba2_dims(cfg)
    bs, p, n, chunk = FED_LM_BATCH, cfg.ssm.head_dim, cfg.ssm.state_dim, \
        cfg.ssm.chunk_size
    x, dt, a, bb, cc = _ssd_inputs(g, dev, bs, s, h, p, n, torch.float32)
    dy = torch.randn(bs, s, h, p, generator=g).to(dev)
    y, hl, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk,
                              keep_states=True)
    y_w, hl_w = ref.ssd_scan_ref(x, dt, a, bb, cc, chunk)
    grads = ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, None, chunk=chunk)
    grads_w = ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, None, chunk)
    torch.cuda.synchronize()
    e6 = max(_rel_err(y, y_w), _rel_err(hl, hl_w))
    e6b = max(_rel_err(u, w) for u, w in zip(grads, grads_w))
    if not (e6 <= 1e-4 and e6b <= 1e-4):
        raise AssertionError(f"B6 fp32 at the federated LM shape: |kernel - "
                             f"plain| / max|plain| forward {e6}, backward "
                             f"{e6b} > 1e-4")
    del y, hl, y_w, hl_w, grads, grads_w
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    rec = {"shape": [bs, s, h, p, n, chunk], "dtype": "float32",
           "route": "simt", "max_rel_err": e6}
    # x, B, C, dt, a read, y and h_last written once (fp32); the scan's
    # products as B6's record counts them, at the fp32 CUDA-core peak
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        4 * (2 * bs * s * h * p + 2 * bs * s * n + bs * s * h + h
             + bs * h * p * n),
        bs * h * nc * (tri * (2 * n + 2 * p + 2) + chunk * 4 * p * n))
    _fed_lm_time(rec, lambda: ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk,
                                            keep_states=True),
                 lambda: ref.ssd_scan_ref(x, dt, a, bb, cc, chunk), None)
    out["ssd_scan"] = rec
    rec = {"shape": [bs, s, h, p, n, chunk], "dtype": "float32",
           "route": "simt", "max_rel_err": e6b}
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        4 * (3 * bs * s * h * p + 4 * bs * s * n + 2 * bs * s * h + 2 * h
             + bs * h * nc * p * n),
        bs * h * nc * (tri * (6 * n + 4 * p) + chunk * 8 * p * n))
    _fed_lm_time(rec, lambda: ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st,
                                                None, chunk=chunk),
                 lambda: ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, None,
                                              chunk), None)
    out["ssd_scan_bwd"] = rec
    del x, dt, a, bb, cc, dy, st
    # -- B2 and B4 over the (4, D) message slab -------------------------
    leaves = _fed_lm_leaf_sizes(cfg)
    sizes, names = list(leaves.values()), list(leaves)
    dm, kc = sum(sizes), FED_LM_CLIENTS
    msgs = torch.randn(kc, dm, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev) * 1e-3
    w = torch.tensor([3.0, 5.0, 14.0, 10.0], device=dev)
    rec = {"shape": [kc, dm], "dtype": "float32"}
    rec["bound_ms"], rec["bound_by"] = bound_ms((kc * dm + kc + dm) * 4,
                                                2 * kc * dm)
    _fed_lm_time(rec, lambda: fed_weighted_sum_cuda(msgs, w),
                 lambda: ref.fed_weighted_sum_ref(msgs, w),
                 lambda: torch.matmul(w, msgs), plain_iters=10)
    got = fed_weighted_sum_cuda(msgs, w)
    rec["max_abs_err"] = float((got - ref.fed_weighted_sum_ref(msgs, w))
                               .abs().max())
    if not rec["max_abs_err"] <= 2e-6 * float(w.sum()):
        raise AssertionError(f"B2 at (4, {dm}): |kernel - plain| "
                             f"{rec['max_abs_err']}")
    out["fed_weighted_sum"] = rec
    del got
    err = torch.randn(kc, dm, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev) * 1e-4
    ids = torch.arange(kc, dtype=torch.int32, device=dev)
    table = ops.topk_segments(_segments(sizes), 0.25)
    sent, new = fed_topk_ef_cuda(msgs, err, ids, table)
    # bitwise on three leaves: the embedding (51.2 M), the widest stacked
    # layer leaf and the smallest leaf
    layer = [i for i, nm in enumerate(names) if nm.startswith("layers.")]
    pick = [names.index("embed.table"),
            max(layer, key=lambda i: sizes[i]),
            min(range(len(sizes)), key=lambda i: sizes[i])]
    for i in pick:
        off, nn, kk = table[i]
        want = topk_plain(msgs[:, off:off + nn], err[:, off:off + nn], ids,
                          [(0, nn, kk)])
        if not (same_bits(sent[:, off:off + nn], want[0])
                and same_bits(new[:, off:off + nn], want[1])):
            raise AssertionError(f"B4 at (4, {dm}): segment {i} ({nn} "
                                 f"entries) differs from the plain version")
    del sent, new, want
    rec = {"shape": [kc, dm], "dtype": "float32", "segments": len(table),
           "bitwise_segments": {names[i]: table[i][1] for i in pick}}
    rec["bound_ms"], rec["bound_by"] = bound_ms((4 * kc * dm + kc) * 4,
                                                2 * kc * dm)
    _fed_lm_time(rec, lambda: fed_topk_ef_cuda(msgs, err, ids, table),
                 lambda: topk_plain(msgs, err, ids, table), None,
                 plain_iters=2)
    out["fed_topk_ef"] = rec
    del msgs, err
    torch.cuda.empty_cache()
    for name, rec in out.items():
        by_name[name]["fed_lm"] = rec
        lib = "none" if rec["library_ms"] is None \
            else f"{rec['library_ms'] * 1e3:.2f} us"
        log(f"{name} at the federated LM path's shape {rec['shape']} "
            f"{rec['dtype']}: device {rec['ms'] * 1e3:.2f} us/call, plain "
            f"{rec['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']})")
    log(f"  fed LM kernels against their plain versions: B5 fp32 {e5:.3e}, "
        f"B5-bwd {e5b:.3e} (bound 2e-5), B6 {e6:.3e}, B6-bwd {e6b:.3e} "
        f"(bound 1e-4), of max|plain|; B2 "
        f"{out['fed_weighted_sum']['max_abs_err']:.3e}; "
        f"B4 bitwise on segments of {out['fed_topk_ef']['bitwise_segments']}"
        f"; {time.perf_counter() - t_start:.1f} s for these checks")


def _ptxas_record(lib: str, prefixes) -> list:
    """Registers, spills and static shared memory from ptxas' report for
    the kernels of ``lib`` whose names start with one of ``prefixes``."""
    from repro_torch.kernels import _build
    out = []
    for fn, regs, spill, smem in ptxas_resources(
            str(_build.BUILD_LOG.get(lib, {}).get("log", ""))):
        short = fn[len("void "):] if fn.startswith("void ") else fn
        if short.startswith(tuple(prefixes)):
            out.append({"kernel": short, "registers": regs,
                        "spill_stores": spill[0], "spill_loads": spill[1],
                        "static_smem": smem})
    return out


def _ssd_smem(shapes: dict, backward: bool = False) -> dict:
    """Dynamic shared memory a block of B6 (or of its backward) asks for,
    the larger of its kernels, at each (P, N, chunk, is_bf16)."""
    from repro_torch.kernels import ssd_scan
    smem = (ssd_scan._bwd_kernels if backward else ssd_scan._kernels)()[1]
    return {k: int(smem(*shape)) for k, shape in shapes.items()}


def _async_spec(vocab, topics, hidden, clients, docs, val_docs, **execution):
    from repro_torch.api import (DataSpec, ExecutionSpec, FederationSpec,
                                 ModelSpec, scenario_spec)
    base = FederationSpec(
        model=ModelSpec(vocab=vocab, topics=topics, hidden=hidden),
        data=DataSpec(num_clients=clients, docs_per_node=docs,
                      val_docs_per_node=val_docs),
        execution=ExecutionSpec(**execution))
    return scenario_spec("buffered_async", base)


def zero_counts() -> None:
    from repro_torch.kernels import (fed_aggregate, flash_attention,
                                     ssd_scan, topic_decoder)
    fed_aggregate.launches = fed_aggregate.dp_secure_launches = 0
    fed_aggregate.topk_ef_launches = topic_decoder.launches = 0
    flash_attention.launches = ssd_scan.launches = 0
    flash_attention.bwd_launches = ssd_scan.bwd_launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import (fed_aggregate, flash_attention,
                                     ssd_scan, topic_decoder)
    return {"fed_weighted_sum": fed_aggregate.launches,
            "topic_decoder": topic_decoder.launches,
            "fed_dp_secure_apply": fed_aggregate.dp_secure_launches,
            "fed_topk_ef": fed_aggregate.topk_ef_launches,
            "flash_attention": flash_attention.launches,
            "ssd_scan": ssd_scan.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "ssd_scan_bwd": ssd_scan.bwd_launches}


def phase_main_path(records):
    """The service at full ProdLDA-synthetic width, through its entry
    points; every kernel of the path must launch."""
    from repro_torch.serve import FederationService, run_traffic
    spec = _async_spec(5000, 50, 100, 5, DOCS_PER_NODE, VAL_DOCS_PER_NODE)
    log(f"main path: buffered_async (M={spec.resolved_buffer_size}, "
        f"max_staleness={spec.schedule.max_staleness}, "
        f"{spec.resolved_staleness_policy}), V=5000 K=50 hidden 100-100, "
        f"L=5, batch {spec.execution.batch_size}, {DOCS_PER_NODE} train + "
        f"{VAL_DOCS_PER_NODE} val docs per node (the paper's depth); cut: "
        f"training to {SWEEPS} traffic sweeps")
    t0 = time.perf_counter()
    svc = FederationService.from_spec(spec, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    stats = run_traffic(svc, sweeps=SWEEPS, order_seed=0, hold_prob=0.2,
                        duplicate_prob=0.1, infer_every=3, infer_batch=8)
    summary = svc.shutdown()
    torch.cuda.synchronize()
    t_traffic = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = svc.evaluate()
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = read_counts()
    for r in records:
        r["launches_by_path"] = {"service": launches[r["name"]]}
    log(f"  set-up (corpus + clients on the card) {t_build:.1f} s; "
        f"traffic + drain {t_traffic:.2f} s; evaluate {t_eval:.2f} s")
    log(f"  aggregations {stats['aggregations']} -> version {svc.version}, "
        f"uploads {stats['accepted']}/{stats['uploads']} accepted, "
        f"rejections {stats['rejections']}, flushed {summary['flushed']}, "
        f"infer calls {stats['infer_calls']} (p50 "
        f"{stats.get('infer_latency_p50_s', float('nan')) * 1e3:.2f} ms)")
    log(f"  evaluate {json.dumps(metrics)}")
    log(f"  launches on the path: {json.dumps(launches)}")
    n_val = 5 * VAL_DOCS_PER_NODE
    want = {"fed_weighted_sum": svc.agg_index,
            "topic_decoder": math.ceil(n_val / 256),
            "fed_dp_secure_apply": 0, "fed_topk_ef": 0,
            "flash_attention": 0, "ssd_scan": 0, "flash_attention_bwd": 0,
            "ssd_scan_bwd": 0}
    if stats["aggregations"] < 1 or stats["infer_calls"] < 1:
        raise AssertionError("main path ran no aggregation or no inference")
    if launches != want:
        raise AssertionError(f"kernel launches on the main path {launches} "
                             f"!= one per aggregation / eval batch {want}")
    params = svc.fetch_model()[1]
    bad = [k for k, v in params.items() if not bool(torch.isfinite(v).all())]
    if bad or not math.isfinite(metrics["heldout_elbo_per_token"]):
        raise AssertionError(f"non-finite params {bad} or held-out ELBO "
                             f"{metrics['heldout_elbo_per_token']}")
    return spec, svc._fed.corpus


def _train_spec(name, vocab, topics, hidden, clients, docs, val_docs,
                rounds, **execution):
    """A registry scenario over a synchronous base, on the batched cohort
    path (``execution.exec_mode="vmap"``) unless ``execution`` says
    otherwise."""
    from repro_torch.api import (DataSpec, ExecutionSpec, FederationSpec,
                                 ModelSpec, ScheduleSpec, scenario_spec)
    base = FederationSpec(
        model=ModelSpec(vocab=vocab, topics=topics, hidden=hidden),
        data=DataSpec(num_clients=clients, docs_per_node=docs,
                      val_docs_per_node=val_docs),
        schedule=ScheduleSpec(rounds=rounds),
        execution=ExecutionSpec(**{"exec_mode": "vmap", **execution}))
    return scenario_spec(name, base)


def phase_training(records, corpus):
    """Synchronous federated training at full ProdLDA-synthetic width on
    the batched cohort path, one run per spec through
    ``Federation.from_spec(...).run()`` and ``evaluate``; each run's
    kernel counts are zeroed before it and read after it."""
    from repro_torch.api import Federation
    from repro_torch.core.transforms import pairwise_mask_stack
    n_eval = math.ceil(5 * VAL_DOCS_PER_NODE / 256)
    expect = {"pallas-topk": {"fed_weighted_sum": TRAIN_ROUNDS,
                              "fed_topk_ef": TRAIN_ROUNDS},
              "pallas-secure": {"fed_weighted_sum": TRAIN_ROUNDS,
                                "fed_dp_secure_apply": TRAIN_ROUNDS},
              "dp-transform": {"fed_weighted_sum": TRAIN_ROUNDS,
                               "fed_dp_secure_apply": TRAIN_ROUNDS}}
    log(f"training path: V=5000 K=50 hidden 100-100, L=5 clients (K=L), "
        f"batch 64, lr 2e-3, {DOCS_PER_NODE} train + {VAL_DOCS_PER_NODE} "
        f"val docs per node; specs {', '.join(TRAIN_SPECS)} (dp-transform "
        f"over the vmap base); cut: training to {TRAIN_ROUNDS} rounds")
    for name in TRAIN_SPECS:
        spec = _train_spec(name, 5000, 50, 100, 5, DOCS_PER_NODE,
                           VAL_DOCS_PER_NODE, TRAIN_ROUNDS)
        t0 = time.perf_counter()
        fed = Federation.from_spec(spec, device="cuda", corpus=corpus)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        ends = []
        fed.on_round_end(lambda rec: ends.append(time.perf_counter()))
        zero_counts()
        t0 = time.perf_counter()
        fed.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        t1 = time.perf_counter()
        metrics = fed.evaluate()
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t1
        counts = read_counts()
        per_round = [b - a for a, b in zip([t0] + ends[:-1], ends)]
        log(f"  {name}: set-up {t_build:.2f} s; {len(fed.history)} rounds "
            f"in {t_run:.3f} s, per round "
            + ", ".join(f"{x * 1e3:.1f}" for x in per_round)
            + f" ms; evaluate {t_eval:.2f} s; losses "
            + ", ".join(f"{h['loss']:.3f}" for h in fed.history))
        log(f"    evaluate {json.dumps(metrics)}")
        log(f"    launches: {json.dumps(counts)}")
        want = {k: 0 for k in counts}
        want.update(expect[name], topic_decoder=n_eval)
        if counts != want:
            raise AssertionError(f"{name}: kernel launches {counts} != "
                                 f"{want}")
        for r in records:
            r["launches_by_path"][name] = counts[r["name"]]
        bad = [k for k, v in fed.params.items()
               if not bool(torch.isfinite(v).all())]
        if bad or len(fed.history) != TRAIN_ROUNDS \
                or not math.isfinite(metrics["heldout_elbo_per_token"]):
            raise AssertionError(f"{name}: non-finite params {bad}, "
                                 f"{len(fed.history)} rounds or held-out "
                                 f"ELBO {metrics['heldout_elbo_per_token']}")
        if name == "pallas-secure":
            last = spec.execution.seed * 100003 + TRAIN_ROUNDS - 1
            stack = pairwise_mask_stack(
                last, [(o, n) for _, _, o, n in fed.engine.layout],
                5).to("cuda")
            total = torch.sum(stack, dim=0)
            if not same_bits(total, torch.zeros_like(total)):
                raise AssertionError("secure masks of the last round do not "
                                     "sum to exactly +0.0 on the card")
            log(f"    last round's mask stack ({tuple(stack.shape)}, max "
                f"|mask| {float(stack.abs().max()):.3f}) sums to exactly "
                f"+0.0 on the card")


def _alg1_run(label, run, history, evaluate, records, rounds, extra=None):
    """One main-path run of Algorithm 1 (``rounds`` of them): kernel
    counts zeroed before it and read after it, per-round wall times; B2
    must launch once per round with an arrival, B1 once per 256 held-out
    documents, the kernels of ``extra`` (name -> count) as it says, and
    every other kernel never."""
    ends = []
    zero_counts()
    t0 = time.perf_counter()
    run(lambda rec: ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    t1 = time.perf_counter()
    metrics = evaluate()
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t1
    counts = read_counts()
    later = [b - a for a, b in zip([t0] + ends[:-1], ends)][1:]
    log(f"  {label}: {len(history)} rounds in {t_run:.3f} s; rounds 2-"
        f"{len(history)} " + ", ".join(f"{x * 1e3:.1f}" for x in later)
        + f" ms (median {sorted(later)[len(later) // 2] * 1e3:.1f} ms); "
        f"evaluate {t_eval:.2f} s")
    log(f"    losses " + ", ".join(f"{h['loss']:.3f}" for h in history))
    log(f"    evaluate {json.dumps(metrics)}")
    log(f"    launches: {json.dumps(counts)}")
    want = {k: 0 for k in counts}
    want.update(fed_weighted_sum=sum(1 for h in history if h["arrived"]),
                topic_decoder=math.ceil(5 * VAL_DOCS_PER_NODE / 256),
                **(extra or {}))
    if counts != want or len(history) != rounds:
        raise AssertionError(f"{label}: {len(history)} rounds of {rounds}, "
                             f"kernel launches {counts} != {want}")
    if not all(math.isfinite(h["loss"]) for h in history if h["arrived"]) \
            or not math.isfinite(metrics["heldout_elbo_per_token"]):
        raise AssertionError(f"{label}: non-finite loss or held-out ELBO")
    for r in records:
        r["launches_by_path"][label] = counts[r["name"]]
    return metrics


def _traced_loop_round(label, fed):
    """One loop round of ``fed`` under ``torch.profiler`` after a warm
    round: its wall time, the device's busy share and the largest device
    items."""
    fed.step()
    torch.cuda.synchronize()
    timed = {}

    def traced_round():
        t0 = time.perf_counter()
        fed.step()
        torch.cuda.synchronize()
        timed["wall"] = time.perf_counter() - t0
    by_name = {}
    for e in _trace(traced_round, cpu=True):
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us()
    busy, wall = sum(by_name.values()) / 1e6, timed["wall"]
    log(f"profile {label} (one loop round, traced): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.2f} ms = "
        f"{100 * busy / wall:.1f}% of wall")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {us / 1e3:9.3f} ms  {kname[:90]}")


def phase_algorithm1(records, corpus):
    """The paper's Algorithm 1 on the host loop (``exec_mode="loop"``) at
    full ProdLDA-synthetic width: (a) the default spec through
    ``Federation.from_spec(...).run()``; (b) ``FederatedTrainer`` with
    adam(2e-3) and its DSS/TSS against the synthetic ground truth; (c)
    ``straggler-heavy`` through the host pending list.  Each run's kernel
    counts are zeroed before it and read after it: B2 once per round with
    an arrival, B1 once per held-out batch, nothing else.  Then one loop
    round traced for the device's busy share; (d) loop against batched
    on the card and (e) card against CPU, within 1e-5."""
    import numpy as np
    from repro_torch.api import Federation, build_clients, max_param_dev
    from repro_torch.api.federation import heldout_elbo_per_token
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core.ntm import prodlda
    from repro_torch.core.protocol import FederatedTrainer
    from repro_torch.metrics import dss, tss, tss_baseline
    from repro_torch.optim import adam, sgd
    log(f"Algorithm 1 path (exec_mode='loop'): V=5000 K=50 hidden 100-100, "
        f"L=5 clients, batch 64, lr 2e-3, {DOCS_PER_NODE} train + "
        f"{VAL_DOCS_PER_NODE} val docs per node; cut: the default spec and "
        f"FederatedTrainer to {ALG1_ROUNDS} rounds, straggler-heavy to "
        f"{STRAGGLER_ROUNDS}, the comparisons to {COMPARE_ROUNDS}")

    def loop_fed(name, rounds):
        spec = _train_spec(name, 5000, 50, 100, 5, DOCS_PER_NODE,
                           VAL_DOCS_PER_NODE, rounds, exec_mode="loop")
        return Federation.from_spec(spec, device="cuda", corpus=corpus)

    # (a) the default spec
    fed = loop_fed("paper", ALG1_ROUNDS)
    if fed.engine.exec_mode != "loop" or fed.spec.execution.exec_mode \
            != "loop":
        raise AssertionError("the default spec did not run on the host loop")

    def run_fed(f):
        def run(hook):
            f.on_round_end(hook)
            f.run()
        return run
    _alg1_run("alg1-paper", run_fed(fed), fed.history, fed.evaluate,
              records, ALG1_ROUNDS)
    if any(h["arrived"] != 5 for h in fed.history):
        raise AssertionError("alg1-paper: a synchronous round lost a client")

    # (b) the literal Algorithm 1: FederatedTrainer + adam
    cfg = fed.model_cfg
    clients = build_clients(corpus, 5, "topic", device="cuda")
    init = prodlda.init_params(torch.Generator().manual_seed(1), cfg,
                               device="cuda")
    loss = lambda p, b: prodlda.elbo_loss(p, cfg, b)  # noqa: E731
    tr = FederatedTrainer(loss, init, clients,
                          FederatedConfig(learning_rate=2e-3,
                                          max_rounds=ALG1_ROUNDS,
                                          rel_tol=0.0),
                          optimizer=adam(2e-3), batch_size=64)
    val = torch.from_numpy(corpus.concat_val_bows()).to("cuda")

    def run_trainer(hook):
        for e in range(ALG1_ROUNDS):
            hook(tr.round(seed=e))

    def eval_trainer():
        with torch.no_grad():
            theta = prodlda.infer_theta(tr.params, cfg, val)
        beta = prodlda.get_topics(tr.params)
        return {"heldout_elbo_per_token": heldout_elbo_per_token(
                    tr.params, cfg, val),
                "dss": dss(torch.from_numpy(np.concatenate(
                    corpus.node_val_thetas)).to("cuda"), theta),
                "tss": tss(torch.from_numpy(corpus.beta).to("cuda"), beta)}
    m = _alg1_run("alg1-trainer", run_trainer, tr.history, eval_trainer,
                  records, ALG1_ROUNDS)
    log(f"    TSS {m['tss']:.3f} of K=50 (prior baseline "
        f"{tss_baseline(5000, 50, corpus.eta, runs=2):.3f}); DSS "
        f"{m['dss']:.2f} (lower is better)")
    if not math.isfinite(m["dss"]) or tr.history[-1]["loss"] \
            >= tr.history[0]["loss"]:
        raise AssertionError("FederatedTrainer: DSS not finite or the loss "
                             "did not fall")

    # (c) stragglers through the host pending list
    strag = loop_fed("straggler-heavy", STRAGGLER_ROUNDS)
    sp = strag.spec.schedule
    log(f"  straggler-heavy: p={sp.straggler_prob}, max staleness "
        f"{sp.max_staleness}, decay {sp.staleness_decay}")

    _alg1_run("alg1-straggler-heavy", run_fed(strag), strag.history,
              strag.evaluate, records, STRAGGLER_ROUNDS)
    log("    (arrived, superseded, in_flight) per round: " + ", ".join(
        str((h["arrived"], h["superseded"], h["in_flight"]))
        for h in strag.history))
    if not any(h["in_flight"] for h in strag.history) or sum(
            h["superseded"] for h in strag.history) == 0:
        raise AssertionError("straggler-heavy: nothing was delayed or "
                             "superseded")

    # one traced loop round of the default spec (after a warm round)
    _traced_loop_round("alg1-paper", loop_fed("paper", 2))

    # (d) loop against batched on the card, from one init
    pair = [loop_fed("sync", COMPARE_ROUNDS)]
    pair.append(Federation.from_spec(
        _train_spec("sync", 5000, 50, 100, 5, DOCS_PER_NODE,
                    VAL_DOCS_PER_NODE, COMPARE_ROUNDS),
        device="cuda", corpus=corpus, init_params=dict(pair[0].params)))
    for f in pair:
        f.run()
    dev_d = max_param_dev(pair[0].params, pair[1].params)
    log(f"agreement alg1 loop vs vmap on the card (sync, "
        f"{COMPARE_ROUNDS} rounds): max_param_dev {dev_d:.3e} (bound 1e-5)")
    if not dev_d <= 1e-5:
        raise AssertionError("loop and batched paths disagree beyond 1e-5")

    # (e) FederatedTrainer + sgd on the card against the CPU
    runs = []
    for dev in ("cuda", "cpu"):
        t = FederatedTrainer(
            loss, {k: v.to(dev) for k, v in init.items()},
            build_clients(corpus, 5, "topic", device=dev),
            FederatedConfig(learning_rate=2e-3, max_rounds=COMPARE_ROUNDS,
                            rel_tol=0.0),
            optimizer=sgd(2e-3), batch_size=64)
        t.fit(seed=0)
        runs.append(t)
    dev_e = max_param_dev(runs[0].params, runs[1].params)
    log(f"agreement alg1 FederatedTrainer+sgd card vs CPU ("
        f"{COMPARE_ROUNDS} rounds, full width): max_param_dev {dev_e:.3e} "
        f"(bound 1e-5)")
    if not dev_e <= 1e-5:
        raise AssertionError("card and CPU Algorithm 1 disagree beyond 1e-5")


# the message transforms on the host loop and in the service: each loop
# transform spec cut to 5 rounds, dp-straggler and dirichlet-noniid to
# 10, FederatedTrainer (topk + secure) to 5, each service to SWEEPS
LOOP_TRANSFORM_SPECS = ("dp-transform", "topk-transform",
                        "secure-transform", "precision-transform")
LOOP_TRANSFORM_ROUNDS, LOOP_SCENARIO_ROUNDS = 5, 10
# the kernel each transform launches once per round (or upload)
TRANSFORM_KERNEL = {"dp": "fed_dp_secure_apply", "secure":
                    "fed_dp_secure_apply", "topk": "fed_topk_ef"}


def _transform_kernels(names, calls):
    """Expected launches of B3 and B4 for a transform stage ``names``
    that ran ``calls`` times (one B3 call covers dp and secure each)."""
    want = {}
    for n in names:
        if n in TRANSFORM_KERNEL:
            k = TRANSFORM_KERNEL[n]
            want[k] = want.get(k, 0) + calls
    return want


def _transform_kernels_bitwise(g, dev):
    """B3 and B4 at the new shapes of this path: the service's (1, D) and
    a partial cohort's (3, D) slab, bitwise their plain versions (these
    launches are comparisons, outside every counted run)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fed_aggregate import (fed_dp_secure_apply_cuda,
                                                   fed_topk_ef_cuda)
    table = ops.topk_segments(_segments(PRODLDA_SEGMENTS), 0.25)
    err = (torch.randn(5, D_MODEL, generator=g) * 1e-4).to(dev)
    for k in (1, 3):
        x = (torch.randn(k, D_MODEL, generator=g) * 1e-3).to(dev)
        noise = torch.randn(k, D_MODEL, generator=g).to(dev)
        masks = (torch.randint(-4096, 4097, (k, D_MODEL), generator=g)
                 .to(torch.float32) * 2.0 ** -10).to(dev)
        coef = (torch.rand(k, generator=g) + 1e-3).to(dev)
        w = torch.full((k,), 10_000.0, device=dev)
        for name, kw in (("dp", dict(noise=noise, clip_coef=coef,
                                     noise_scale=0.015)),
                         ("secure", dict(masks=masks, weights=w))):
            if not same_bits(fed_dp_secure_apply_cuda(x, **kw),
                             ref.fed_dp_secure_apply_ref(x, **kw)):
                raise AssertionError(f"B3 {name} ({k}, {D_MODEL}): kernel "
                                     f"!= plain bitwise")
        ids = torch.tensor((3, 0, 4)[:k], dtype=torch.int32, device=dev)
        _b4_bitwise(fed_topk_ef_cuda(x, err, ids, table),
                    topk_plain(x, err, ids, table), f"({k}, {D_MODEL})")
    torch.cuda.synchronize()
    log(f"B3 (dp, secure) and B4 (frac 0.25, the ProdLDA table) at (1, "
        f"{D_MODEL}) and (3, {D_MODEL}): bitwise equal to the plain "
        f"versions")


def phase_loop_transforms(records, corpus):
    """The message transforms on Algorithm 1's host loop and in the
    buffered-async service at full ProdLDA-synthetic width: (a) the loop
    dp, topk, secure and precision specs; (b) dp-straggler and
    dirichlet-noniid; (c) FederatedTrainer with topk and secure grads;
    (d) the service with dp and with topk uploads.  Each run's counts are
    zeroed before it and read after it: B3 or B4 exactly once per round
    with a transform (one (n, D) slab a round) and once per computed
    upload.  Then one traced loop round each of dp and secure, B3 and B4
    bitwise at the new shapes, card against CPU for each loop transform
    and loop against batched on the card, within 1e-5."""
    from repro_torch.api import (Federation, build_clients, max_param_dev,
                                 spec_replace)
    from repro_torch.api.federation import heldout_elbo_per_token
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core.ntm import prodlda
    from repro_torch.core.protocol import FederatedTrainer
    from repro_torch.optim import sgd
    from repro_torch.serve import FederationService, run_traffic
    log(f"loop transforms (exec_mode='loop'): V=5000 K=50 hidden 100-100, "
        f"L=5 clients, batch 64, lr 2e-3, {DOCS_PER_NODE} train + "
        f"{VAL_DOCS_PER_NODE} val docs per node; cut: "
        f"{', '.join(LOOP_TRANSFORM_SPECS)} to {LOOP_TRANSFORM_ROUNDS} "
        f"rounds, dp-straggler and dirichlet-noniid to "
        f"{LOOP_SCENARIO_ROUNDS}, FederatedTrainer (topk 0.25 + secure) to "
        f"{LOOP_TRANSFORM_ROUNDS}, the services (dp, topk) to {SWEEPS} "
        f"sweeps, the comparisons to {COMPARE_ROUNDS} rounds")

    def loop_fed(name, rounds):
        spec = _train_spec(name, 5000, 50, 100, 5, DOCS_PER_NODE,
                           VAL_DOCS_PER_NODE, rounds, exec_mode="loop")
        return Federation.from_spec(spec, device="cuda", corpus=corpus)

    def run_fed(f):
        def run(hook):
            f.on_round_end(hook)
            f.run()
        return run

    # (a) and (b): the registry specs through Federation.from_spec
    for name, rounds in ([(n, LOOP_TRANSFORM_ROUNDS)
                          for n in LOOP_TRANSFORM_SPECS]
                         + [("dp-straggler", LOOP_SCENARIO_ROUNDS),
                            ("dirichlet-noniid", LOOP_SCENARIO_ROUNDS)]):
        t0 = time.perf_counter()
        fed = loop_fed(name, rounds)
        torch.cuda.synchronize()
        log(f"  {name}: set-up {time.perf_counter() - t0:.2f} s; client "
            f"corpora {[c.num_docs for c in fed.engine.clients]}")
        if fed.engine.exec_mode != "loop":
            raise AssertionError(f"{name} did not run on the host loop")
        _alg1_run(f"loop-{name}", run_fed(fed), fed.history, fed.evaluate,
                  records, rounds,
                  _transform_kernels(fed.spec.transforms.names, rounds))
        if name == "dp-straggler":
            log("    (arrived, superseded, in_flight) per round: "
                + ", ".join(str((h["arrived"], h["superseded"],
                                 h["in_flight"])) for h in fed.history))
            if not any(h["in_flight"] for h in fed.history):
                raise AssertionError("dp-straggler: nothing was delayed")
        if name == "topk-transform":
            kept = float((fed.engine._tstate["topk"] != 0).float().mean())
            log(f"    topk error memory (5, {D_MODEL}): {kept:.3f} of its "
                f"entries nonzero")

    # (c) FederatedTrainer: topk then secure grads every round
    cfg = fed.model_cfg
    init = prodlda.init_params(torch.Generator().manual_seed(2), cfg,
                               device="cuda")
    tr = FederatedTrainer(lambda p, b: prodlda.elbo_loss(p, cfg, b), init,
                          build_clients(corpus, 5, "topic", device="cuda"),
                          FederatedConfig(learning_rate=2e-3,
                                          compression_topk=0.25,
                                          secure_aggregation=True,
                                          max_rounds=LOOP_TRANSFORM_ROUNDS,
                                          rel_tol=0.0),
                          optimizer=sgd(2e-3), batch_size=64)
    if [n for n, _ in tr._transforms] != ["topk", "secure"]:
        raise AssertionError(f"FederatedTrainer transforms "
                             f"{[n for n, _ in tr._transforms]}")
    val = torch.from_numpy(corpus.concat_val_bows()).to("cuda")

    def run_trainer(hook):
        for e in range(LOOP_TRANSFORM_ROUNDS):
            hook(tr.round(seed=e))
    _alg1_run("loop-trainer-topk-secure", run_trainer, tr.history,
              lambda: {"heldout_elbo_per_token": heldout_elbo_per_token(
                  tr.params, cfg, val)}, records, LOOP_TRANSFORM_ROUNDS,
              _transform_kernels(("topk", "secure"), LOOP_TRANSFORM_ROUNDS))

    # (d) the buffered-async service with transformed uploads
    for which, knobs in (("dp", {"transforms.names": ("dp",),
                                 "transforms.dp_noise_multiplier": 0.3,
                                 "transforms.dp_clip_norm": 0.05}),
                         ("topk", {"transforms.names": ("topk",),
                                   "transforms.compression_topk": 0.25})):
        spec = spec_replace(_async_spec(5000, 50, 100, 5, DOCS_PER_NODE,
                                        VAL_DOCS_PER_NODE), knobs)
        svc = FederationService.from_spec(spec, device="cuda", corpus=corpus)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        stats = run_traffic(svc, sweeps=SWEEPS, order_seed=0, hold_prob=0.2,
                            duplicate_prob=0.1, infer_every=3, infer_batch=8)
        svc.shutdown()
        torch.cuda.synchronize()
        t_traffic = time.perf_counter() - t0
        metrics = svc.evaluate()
        torch.cuda.synchronize()
        counts = read_counts()
        label = f"service-{which}"
        log(f"  {label}: {stats['steps']} computed uploads, traffic + drain "
            f"{t_traffic:.2f} s ({t_traffic / stats['steps'] * 1e3:.1f} ms "
            f"an upload); aggregations {stats['aggregations']}, uploads "
            f"{stats['accepted']}/{stats['uploads']} accepted, rejections "
            f"{stats['rejections']}")
        log(f"    evaluate {json.dumps(metrics)}")
        log(f"    launches: {json.dumps(counts)}")
        want = {k: 0 for k in counts}
        want.update(fed_weighted_sum=svc.agg_index,
                    topic_decoder=math.ceil(5 * VAL_DOCS_PER_NODE / 256),
                    **_transform_kernels((which,), stats["steps"]))
        if counts != want:
            raise AssertionError(f"{label}: kernel launches {counts} != one "
                                 f"{TRANSFORM_KERNEL[which]} per computed "
                                 f"upload {want}")
        if not math.isfinite(metrics["heldout_elbo_per_token"]):
            raise AssertionError(f"{label}: non-finite held-out ELBO")
        for r in records:
            r["launches_by_path"][label] = counts[r["name"]]

    # one traced loop round each of dp and secure
    for name in ("dp-transform", "secure-transform"):
        _traced_loop_round(f"loop-{name}", loop_fed(name, 2))

    _transform_kernels_bitwise(torch.Generator().manual_seed(18), "cuda")

    # card against CPU, and loop against batched on the card, at the
    # spec's default widths (V=400, K=10, hidden 64) with whole-corpus
    # draws: at full width a top-k selection can flip on an fp32 ulp
    # between two paths' gradients
    for name in LOOP_TRANSFORM_SPECS + ("dp-straggler",):
        spec = _train_spec(name, 400, 10, 64, 3, 40, 8, COMPARE_ROUNDS,
                           exec_mode="loop", batch_size=64,
                           learning_rate=2e-4)
        cpu = Federation.from_spec(spec, device="cpu")
        gpu = Federation.from_spec(spec, device="cuda",
                                   init_params=cpu.params)
        runs = [cpu, gpu]
        if name != "dp-straggler":
            runs.append(Federation.from_spec(
                spec_replace(spec, {"execution.exec_mode": "vmap"}),
                device="cuda", init_params=cpu.params))
        for f in runs:
            f.run()
        dev_c = max_param_dev(cpu.params, gpu.params)
        dev_v = max_param_dev(gpu.params, runs[2].params) \
            if len(runs) > 2 else None
        log(f"agreement loop {name} (V=400 K=10, 3 clients, "
            f"{COMPARE_ROUNDS} rounds): card vs CPU max_param_dev "
            f"{dev_c:.3e}" + ("" if dev_v is None else
                              f", loop vs batched on the card {dev_v:.3e}")
            + " (bound 1e-5)")
        ints = [[h[k] for k in ("participants", "arrived", "in_flight")]
                for h in gpu.history]
        if not dev_c <= 1e-5 or (dev_v is not None and not dev_v <= 1e-5) \
                or ints != [[h[k] for k in ("participants", "arrived",
                                            "in_flight")]
                            for h in cpu.history]:
            raise AssertionError(f"loop {name}: card, CPU and batched "
                                 f"paths disagree beyond 1e-5")


# the paper's training mode: prodlda-synthetic through Federation on both
# paths cut to 10 rounds, the --ntm launcher to 20 rounds; gFedNTM-CTM at
# ctm-s2orc width (V=10000, K=25, C=768, encoder 100-100) over 5 nodes of
# CTM_DOCS documents (bench_wmd.py's 600, raised so batch 64 is a tenth),
# cut to 20 rounds, the five node CTMs to 20 steps, ZeroShotTM to 3 rounds
NTM_ROUNDS, NTM_LAUNCH_ROUNDS, CTM_ROUNDS, CTM_DOCS = 10, 20, 20, 640


def _expect_counts(label, counts, want, records):
    """Fail unless the run's launches are exactly ``want`` (every other
    kernel 0); record them under ``label``."""
    full = {k: 0 for k in counts}
    full.update(want)
    log(f"    launches: {json.dumps(counts)}")
    if counts != full:
        raise AssertionError(f"{label}: kernel launches {counts} != {full}")
    for r in records:
        r["launches_by_path"][label] = counts[r["name"]]


def _ctm_corpus():
    """bench_wmd.py's five-discipline corpus at ctm-s2orc's vocabulary,
    its topic-local word embeddings, and each node's {bow, contextual}
    (fake_contextual_embeddings, C=768)."""
    import numpy as np
    from repro_torch.data.synthetic_lda import (fake_contextual_embeddings,
                                                generate_lda_corpus)
    syn = generate_lda_corpus(vocab_size=10000, num_topics=25, num_nodes=5,
                              shared_topics=6, eta=0.02,
                              docs_per_node=CTM_DOCS, val_docs_per_node=50,
                              seed=0)
    rng = np.random.default_rng(0)
    axes = rng.standard_normal((25, 16)).astype(np.float32)
    emb = (syn.beta.T / syn.beta.T.sum(1, keepdims=True)) @ axes
    emb += 0.05 * rng.standard_normal(emb.shape).astype(np.float32)
    datas = [{"bow": b, "contextual": fake_contextual_embeddings(b, 768,
                                                                 seed=1)}
             for b in syn.node_bows]
    return datas, emb


def phase_ntm_train_mode(records, corpus):
    """The paper's training mode on the card: the train-mode ELBO
    (dropout and reparametrization on the reference's threefry keys) and
    CombinedTM/ZeroShotTM through Algorithm 1.  (a) prodlda-synthetic at
    full width, ``execution.stochastic_loss=True``, batch 64 of 10 000
    documents a client, through ``Federation.from_spec(...).run()`` on
    the host loop and on the batched path, then ``evaluate``: B2 once a
    round, B1 once a held-out batch; one traced loop round; card against
    CPU and loop against batched, 3 rounds each, within 1e-5.  (b)
    ``launch.train.main`` with ``--arch prodlda-synthetic --ntm``: every
    loss finite, B2 once a round.  (c) gFedNTM-CTM at ctm-s2orc width as
    ``benchmarks/bench_wmd.py`` runs it: FederatedTrainer with adam(2e-3)
    and batch 64 (B2 once a round), five node CTMs by
    ``train_centralized``, the AMWMD table (finite), ZeroShotTM, and
    CombinedTM card against CPU within 1e-5."""
    import numpy as np
    from repro_torch.api import Federation, max_param_dev
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core.engine import ClientState
    from repro_torch.core.ntm import ctm, prodlda
    from repro_torch.core.protocol import FederatedTrainer, train_centralized
    from repro_torch.launch import train as launch_train
    from repro_torch.metrics import amwmd
    from repro_torch.optim import adam, sgd
    n_eval = math.ceil(5 * VAL_DOCS_PER_NODE / 256)
    log(f"NTM train mode: prodlda-synthetic V=5000 K=50 hidden 100-100 "
        f"dropout 0.2, L=5 clients, batch 64, lr 2e-3, "
        f"stochastic_loss=True, {DOCS_PER_NODE} train + {VAL_DOCS_PER_NODE} "
        f"val docs per node; cut: {NTM_ROUNDS} rounds a path, the launcher "
        f"to {NTM_LAUNCH_ROUNDS}, the comparisons to {COMPARE_ROUNDS}")

    def ntm_fed(mode, rounds, dev="cuda", init=None):
        spec = _train_spec("sync", 5000, 50, 100, 5, DOCS_PER_NODE,
                           VAL_DOCS_PER_NODE, rounds, exec_mode=mode,
                           stochastic_loss=True)
        return Federation.from_spec(spec, device=dev, corpus=corpus,
                                    init_params=init)

    # (a) both paths, 10 rounds each, then evaluate
    walls = {}
    for mode in ("loop", "vmap"):
        fed = ntm_fed(mode, NTM_ROUNDS)
        ends = []
        fed.on_round_end(lambda rec: ends.append(time.perf_counter()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        fed.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        t1 = time.perf_counter()
        metrics = fed.evaluate()
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        later = [b - a for a, b in zip([t0] + ends[:-1], ends)][1:]
        walls[mode] = sorted(later)[len(later) // 2]
        log(f"  ntm-train-{mode}: {len(fed.history)} rounds in {t_run:.3f} "
            f"s; rounds 2-{len(fed.history)} "
            + ", ".join(f"{x * 1e3:.1f}" for x in later)
            + f" ms (median {walls[mode] * 1e3:.1f} ms); evaluate "
            f"{t_eval:.2f} s; peak memory {peak / 2**30:.2f} GiB")
        log(f"    losses " + ", ".join(f"{h['loss']:.3f}"
                                      for h in fed.history))
        log(f"    evaluate {json.dumps(metrics)}")
        _expect_counts(f"ntm-train-{mode}", read_counts(),
                       {"fed_weighted_sum": NTM_ROUNDS,
                        "topic_decoder": n_eval}, records)
        bad = [k for k, v in fed.params.items()
               if not bool(torch.isfinite(v).all())]
        if bad or len(fed.history) != NTM_ROUNDS or not all(
                math.isfinite(h["loss"]) for h in fed.history) \
                or not math.isfinite(metrics["heldout_elbo_per_token"]):
            raise AssertionError(f"ntm-train-{mode}: non-finite params "
                                 f"{bad}, loss or held-out ELBO")
    _traced_loop_round("ntm-train-loop", ntm_fed("loop", 2))

    # card against CPU, and loop against batched on the card, 3 rounds
    ref = ntm_fed("loop", COMPARE_ROUNDS)
    init = {k: v.detach().clone() for k, v in ref.params.items()}
    ref.run()
    cpu = ntm_fed("loop", COMPARE_ROUNDS, "cpu",
                  {k: v.cpu() for k, v in init.items()})
    cpu.run()
    vm = ntm_fed("vmap", COMPARE_ROUNDS, init=init)
    vm.run()
    dev_cpu = max_param_dev(ref.params, cpu.params)
    dev_vm = max_param_dev(ref.params, vm.params)
    log(f"agreement ntm train mode ({COMPARE_ROUNDS} rounds, full width): "
        f"card vs CPU max_param_dev {dev_cpu:.3e}, loop vs vmap on the card "
        f"{dev_vm:.3e} (bound 1e-5)")
    if not (dev_cpu <= 1e-5 and dev_vm <= 1e-5):
        raise AssertionError("train-mode runs disagree beyond 1e-5")

    # where a client's host time goes: one minibatch draw (its shuffle
    # hashed and sorted on the card, or on the host) and one client
    # gradient step in train and in eval mode, each timed to a sync
    from repro_torch.core import prng
    from repro_torch.data.federated_split import (_draw_indices,
                                                  sample_minibatch)

    def host_ms(fn, reps=20):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i + 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    key = prng.PRNGKey(7)
    costs = {f"draw n={n} on {dev}": host_ms(
        lambda i, n=n, dev=dev: _draw_indices(prng.fold_in(key, i), n, 64,
                                              dev))
             for n in (DOCS_PER_NODE, CTM_DOCS) for dev in ("cuda", "cpu")}
    client = ref.engine.clients[0]
    batch, _ = sample_minibatch(client.data, client.num_docs, key, 64)
    for train in (True, False):
        step = torch.func.grad_and_value(
            lambda p, b, train=train: prodlda.elbo_loss(p, ref.model_cfg, b,
                                                        train=train))
        costs[f"client step train={train}"] = host_ms(
            lambda i, step=step: step(ref.params, batch))
    log("  host time (ms, mean of 20, to a sync): " + ", ".join(
        f"{k} {v:.3f}" for k, v in costs.items()))

    # (b) the --ntm launcher
    losses = []
    zero_counts()
    t0 = time.perf_counter()
    final = launch_train.main(
        ["--arch", "prodlda-synthetic", "--ntm", "--steps",
         str(NTM_LAUNCH_ROUNDS), "--batch", "64", "--log-every", "10"],
        on_step=lambda r, loss: losses.append(loss))
    torch.cuda.synchronize()
    t_launch = time.perf_counter() - t0
    log(f"  launch.train --ntm (prodlda-synthetic, 4 clients x 500 docs, "
        f"batch 64, sgd 2e-3): {len(losses)} rounds in {t_launch:.2f} s "
        f"(corpus and set-up included); losses "
        + ", ".join(f"{x:.3f}" for x in losses))
    _expect_counts("ntm-launch", read_counts(),
                   {"fed_weighted_sum": NTM_LAUNCH_ROUNDS}, records)
    if len(losses) != NTM_LAUNCH_ROUNDS or not all(
            math.isfinite(x) for x in losses) or final != losses[-1]:
        raise AssertionError("launch.train --ntm: a loss is not finite")

    # (c) gFedNTM-CTM at ctm-s2orc width
    t0 = time.perf_counter()
    datas, word_emb = _ctm_corpus()
    t_corpus = time.perf_counter() - t0
    cfg = get_config("ctm-s2orc")
    node_cfg = dataclasses.replace(cfg, num_topics=max(25 // 5 + 2, 4))

    def clients(dev):
        return [ClientState(data={k: torch.from_numpy(v).to(dev)
                                  for k, v in d.items()},
                            num_docs=CTM_DOCS) for d in datas]

    def trainer(loss, init, rounds, dev="cuda", opt=None):
        return FederatedTrainer(
            loss, {k: v.to(dev) for k, v in init.items()}, clients(dev),
            FederatedConfig(num_clients=5, learning_rate=2e-3,
                            max_rounds=rounds, rel_tol=0.0),
            optimizer=opt or adam(2e-3), batch_size=64)

    combined = lambda p, b: ctm.loss_combined(p, cfg, b)  # noqa: E731
    init = ctm.init_combined(torch.Generator().manual_seed(100), cfg,
                             device="cuda")
    d_msg = sum(v.numel() for v in init.values())
    log(f"gFedNTM-CTM (bench_wmd.py's pipeline): ctm-s2orc V=10000 K=25 "
        f"C=768 hidden 100-100 dropout 0.2, message D = {d_msg}, 5 nodes "
        f"x {CTM_DOCS} docs (corpus + embeddings {t_corpus:.1f} s), adam "
        f"2e-3, batch 64; cut: {CTM_ROUNDS} rounds, node CTMs (K="
        f"{node_cfg.num_topics}) {CTM_ROUNDS} steps, ZeroShotTM 3 rounds")
    if d_msg != 1_352_150:
        raise AssertionError(f"CombinedTM message D = {d_msg}")
    tr = trainer(combined, init, CTM_ROUNDS)
    ends = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    tr.fit(seed=0, on_round=lambda rec: ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    t_fed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    later = [b - a for a, b in zip([t0] + ends[:-1], ends)][1:]
    log(f"  ctm-federated: {len(tr.history)} rounds in {t_fed:.3f} s; "
        f"rounds 2-{len(tr.history)} median "
        f"{sorted(later)[len(later) // 2] * 1e3:.1f} ms (min "
        f"{min(later) * 1e3:.1f}, max {max(later) * 1e3:.1f}); peak memory "
        f"{peak / 2**30:.2f} GiB; losses "
        + ", ".join(f"{h['loss']:.2f}" for h in tr.history))
    _expect_counts("ctm-federated", read_counts(),
                   {"fed_weighted_sum": CTM_ROUNDS}, records)
    if not all(math.isfinite(h["loss"]) for h in tr.history):
        raise AssertionError("gFedNTM-CTM: a loss is not finite")

    # the non-collaborative CTMs, one per node (scenario 1)
    node_loss = lambda p, b: ctm.loss_combined(p, node_cfg, b)  # noqa: E731
    t0 = time.perf_counter()
    nodes = []
    for l, d in enumerate(datas):
        nodes.append(train_centralized(
            node_loss, ctm.init_combined(torch.Generator().manual_seed(l),
                                         node_cfg, device="cuda"),
            {k: torch.from_numpy(v).to("cuda") for k, v in d.items()},
            optimizer=adam(2e-3), batch_size=64, steps=CTM_ROUNDS, seed=l))
    torch.cuda.synchronize()
    log(f"  node CTMs: 5 x {CTM_ROUNDS} steps in "
        f"{time.perf_counter() - t0:.2f} s")

    # AMWMD (Eq. 7) of the federated model and each node model against
    # every node's topics, on the host
    node_betas = [prodlda.get_topics(p).cpu().numpy() for p in nodes]
    evals = {f"node:{l}": b for l, b in enumerate(node_betas)}
    evals["federated:K=25"] = prodlda.get_topics(tr.params).cpu().numpy()
    t0 = time.perf_counter()
    table = {name: [0.0 if name == f"node:{l}" else
                    amwmd(node_betas[l], beta, word_emb, top_n=8)
                    for l in range(5)] for name, beta in evals.items()}
    t_amwmd = time.perf_counter() - t0
    log(f"  AMWMD (top 8 words, host time {t_amwmd:.2f} s), rows: the "
        f"evaluated model, columns: node 0-4")
    for name, row in table.items():
        log(f"    {name:16s} " + " ".join(f"{v:7.3f}" for v in row)
            + f"   avg {float(np.mean(row)):.3f}")
    if not all(math.isfinite(v) for row in table.values() for v in row):
        raise AssertionError("AMWMD table is not finite")

    # ZeroShotTM, 3 rounds
    zs = trainer(lambda p, b: ctm.loss_zeroshot(p, cfg, b),
                 ctm.init_zeroshot(torch.Generator().manual_seed(101), cfg,
                                   device="cuda"), 3)
    zero_counts()
    zs.fit(seed=0)
    torch.cuda.synchronize()
    log("  ZeroShotTM: 3 rounds, losses "
        + ", ".join(f"{h['loss']:.3f}" for h in zs.history))
    _expect_counts("ctm-zeroshot", read_counts(), {"fed_weighted_sum": 3},
                   records)
    if not all(math.isfinite(h["loss"]) for h in zs.history):
        raise AssertionError("ZeroShotTM: a loss is not finite")

    # CombinedTM card against CPU, 3 rounds of sgd from one init
    runs = []
    for dev in ("cuda", "cpu"):
        t = trainer(combined, init, COMPARE_ROUNDS, dev, sgd(2e-3))
        t.fit(seed=0)
        runs.append(t)
    dev_ctm = max_param_dev(runs[0].params, runs[1].params)
    log(f"agreement CombinedTM FederatedTrainer+sgd card vs CPU "
        f"({COMPARE_ROUNDS} rounds, ctm-s2orc width): max_param_dev "
        f"{dev_ctm:.3e} (bound 1e-5)")
    if not dev_ctm <= 1e-5:
        raise AssertionError("card and CPU CombinedTM disagree beyond 1e-5")


def phase_training_profile(corpus):
    """Where the training time goes: two rounds of each spec on a fresh
    federation under ``torch.profiler``; the device's busy share of the
    wall time and the kernels that fill it."""
    from torch.autograd import DeviceType
    from repro_torch.api import Federation
    for name in TRAIN_SPECS:
        spec = _train_spec(name, 5000, 50, 100, 5, DOCS_PER_NODE,
                           VAL_DOCS_PER_NODE, 2)
        fed = Federation.from_spec(spec, device="cuda", corpus=corpus)
        fed.step()                       # warm: first-call allocations
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fed.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) \
                    + e.time_range.elapsed_us()
        busy = sum(by_name.values()) / 1e6
        log(f"profile {name} (one round, traced): wall {wall * 1e3:.1f} ms, "
            f"device busy {busy * 1e3:.2f} ms = {100 * busy / wall:.1f}% "
            f"of wall")
        for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"  {us / 1e3:9.3f} ms  {kname[:90]}")


def phase_profile(spec, corpus):
    """Where the time goes: a fresh service on the same corpus, two
    sweeps of traffic + evaluate under ``torch.profiler``; the device's
    busy share of the wall time and the kernels that fill it."""
    from torch.autograd import DeviceType
    from repro_torch.serve import FederationService, run_traffic
    svc = FederationService.from_spec(spec, device="cuda", corpus=corpus)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_traffic(svc, sweeps=2, order_seed=5, hold_prob=0.2,
                    infer_every=3)
        svc.shutdown()
        t_traffic = time.perf_counter() - t0
        svc.evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    log(f"profile (2 sweeps + drain + evaluate, traced): wall {wall:.3f} s "
        f"(traffic {t_traffic:.3f} s), device busy {busy:.4f} s = "
        f"{100 * busy / wall:.1f}% of wall; {svc.agg_index} aggregations")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:9.3f} ms  {name[:90]}")


def phase_agreement():
    """A small service on the card and on the CPU from the same weights:
    the kernels' path against the plain path, end to end."""
    from repro_torch.api import max_param_dev
    from repro_torch.serve import FederationService, run_traffic
    spec = _async_spec(64, 4, 16, 3, 40, 8, batch_size=64,
                       learning_rate=2e-4)
    runs = {}
    for dev in ("cpu", "cuda"):
        svc = FederationService.from_spec(spec, device=dev)
        stats = run_traffic(svc, sweeps=4, order_seed=1, hold_prob=0.3,
                            duplicate_prob=0.3, infer_every=2)
        svc.shutdown()
        stats = {k: v for k, v in stats.items() if "latency" not in k
                 and "throughput" not in k}
        runs[dev] = (svc, stats, svc.evaluate())
    (s_cpu, st_cpu, m_cpu), (s_gpu, st_gpu, m_gpu) = runs["cpu"], \
        runs["cuda"]
    dev_p = max_param_dev(s_cpu.fetch_model()[1], s_gpu.fetch_model()[1])
    rel = abs(m_gpu["heldout_elbo_per_token"]
              - m_cpu["heldout_elbo_per_token"]) \
        / abs(m_cpu["heldout_elbo_per_token"])
    log(f"agreement (V=64 K=4, 3 clients, M=2): card vs CPU plain path "
        f"max_param_dev {dev_p:.3e}, held-out ELBO rel {rel:.3e} "
        f"(bounds 1e-5), {st_gpu['aggregations']} aggregations")
    if st_cpu != st_gpu or s_cpu.rejections != s_gpu.rejections:
        raise AssertionError(f"event ledgers differ: {st_cpu} vs {st_gpu}")
    if not (dev_p <= 1e-5 and rel <= 1e-5):
        raise AssertionError("card and CPU paths disagree beyond 1e-5")
    from repro_torch.api import Federation
    # the spec's default widths (V=400, K=10, hidden 64): at V=64 some
    # random inits start at a loss 300x the usual and diverge in a round
    for name in TRAIN_SPECS:
        spec = _train_spec(name, 400, 10, 64, 3, 40, 8, 3, batch_size=64,
                           learning_rate=2e-4)
        cpu = Federation.from_spec(spec, device="cpu")
        gpu = Federation.from_spec(spec, device="cuda",
                                   init_params=cpu.params)
        cpu.run()
        gpu.run()
        dev_t = max_param_dev(cpu.params, gpu.params)
        log(f"agreement {name} (V=400 K=10, 3 clients, 3 rounds): card vs CPU "
            f"max_param_dev {dev_t:.3e} (bound 1e-5)")
        if not dev_t <= 1e-5 or [h["participants"] for h in gpu.history] \
                != [h["participants"] for h in cpu.history]:
            raise AssertionError(f"{name}: card and CPU training disagree")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def phase_lm_serve(records):
    """hymba-1.5b at full width through ``repro_torch.launch.serve``:
    batch 4 x 2048-token prompts (past the window of 1024, so the ring
    buffer's roll and the window mask both run; 8 SSD chunks), 32 greedy
    tokens, after one warm-up call of the same entry point; B5 and B6 must
    launch once per layer of the one prefill and nothing else may launch.
    Then one traced prefill of the same prompts for the device's busy
    share, with finite logits, 8 timed decode steps and one traced."""
    import argparse
    import numpy as np
    from torch.autograd import DeviceType
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers.mamba2 import mamba2_dims
    cfg = get_config("hymba-1.5b")
    _, nh, _ = mamba2_dims(cfg)
    log(f"LM serve path: hymba-1.5b at full width ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, window {cfg.sliding_window}, {nh} SSD heads of "
        f"P={cfg.ssm.head_dim} N={cfg.ssm.state_dim} chunk "
        f"{cfg.ssm.chunk_size}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.num_params()} parameters), bf16 activations over fp32 "
        f"masters, the port's seeded init; batch {LM_BATCH} x prompt "
        f"{LM_PROMPT}, {LM_NEW} new tokens; cut: none (serving has no depth "
        f"to cut)")
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    args = argparse.Namespace(arch="hymba-1.5b", reduced=False,
                              batch=LM_BATCH, prompt_len=LM_PROMPT,
                              max_new=LM_NEW, seed=0, device="cuda")
    # warm-up through the same entry point, 2 new tokens: cuBLAS handles
    # and the first (lazily loaded) launch of every kernel and shape
    t0 = time.perf_counter()
    lm_serve.serve(argparse.Namespace(**{**vars(args), "max_new": 2}),
                   params=params)
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = lm_serve.serve(args, params=params)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    gen = out["generated"]
    log(f"  init (CPU draws of {cfg.num_params()} weights, to the card) "
        f"{t_init:.1f} s; cold warm-up serve (2 new tokens) {t_warm:.2f} s")
    log(f"  serve (warm): prefill {out['prefill_s']:.4f} s; decode "
        f"{LM_NEW - 1} steps in {out['decode_s']:.4f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  launches on the path: {json.dumps(counts)}")
    want = {k: 0 for k in counts}
    want.update(flash_attention=cfg.num_layers, ssd_scan=cfg.num_layers)
    if counts != want:
        raise AssertionError(f"LM serve: kernel launches {counts} != one "
                             f"B5 and one B6 per layer of the prefill "
                             f"{want}")
    if gen.shape != (LM_BATCH, LM_NEW) or gen.min() < 0 \
            or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"LM serve: generated {gen.shape} tokens in "
                             f"[{gen.min()}, {gen.max()}], vocabulary "
                             f"{cfg.vocab_size}")
    log(f"  first generations: {gen[:, :8].tolist()}")
    for r in records:
        r["launches_by_path"]["lm_serve"] = counts[r["name"]]

    act = tfm.activation_copy(params, cfg, torch.bfloat16)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to("cuda")
    torch.cuda.synchronize()
    traced = {}

    def traced_prefill():
        t0 = time.perf_counter()
        traced["out"] = tfm.prefill(act, cfg, {"tokens": prompts},
                                    max_len=LM_PROMPT + LM_NEW)
        torch.cuda.synchronize()
        traced["wall"] = time.perf_counter() - t0
    by_name = {}
    for e in _trace(traced_prefill, cpu=True):
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us()
    (logits, cache), wall = traced.pop("out"), traced["wall"]
    busy = sum(by_name.values()) / 1e6
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time in "
                             "the LM prefill")
    log(f"profile LM prefill (traced, warm): wall {wall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.1f} ms = {100 * busy / wall:.1f}% of "
        f"wall")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3:9.3f} ms  {kname[:90]}")
    for label, keys in (("B5 flash_attention", ("flash_fwd",)),
                        ("B6 ssd_scan", ("ssd_chunk_", "ssd_state_pass",
                                         "ssd_scan_kernel"))):
        part = {k: us for k, us in by_name.items()
                if any(key in k for key in keys)}
        log(f"  {label} in this prefill: {sum(part.values()) / 1e3:.3f} ms "
            f"of device time (" + ", ".join(
                f"{_short_name(k)} {us / 1e3:.3f} ms"
                for k, us in part.items()) + ")")
    if logits.shape != (LM_BATCH, LM_PROMPT, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"LM prefill logits {tuple(logits.shape)} not "
                             f"finite")
    tok = torch.argmax(logits[:, -1:], dim=-1)
    del logits
    # decode: 8 timed steps, then one traced step
    steps = []
    for _ in range(8):
        t0 = time.perf_counter()
        step, cache = tfm.decode_step(act, cfg, cache, tok)
        tok = torch.argmax(step[:, -1:], dim=-1)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step, cache = tfm.decode_step(act, cfg, cache, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    n_launch = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not bool(torch.isfinite(step).all()):
        raise AssertionError("LM decode logits not finite")
    med = sorted(steps)[len(steps) // 2]
    log(f"  decode steps (warm, batch {LM_BATCH}): "
        + ", ".join(f"{x * 1e3:.1f}" for x in steps)
        + f" ms (median {med * 1e3:.1f} ms = {LM_BATCH / med:.1f} "
        f"tokens/s); one traced step: wall {wall * 1e3:.1f} ms, device busy "
        f"{dev_us / 1e3:.2f} ms = {100 * dev_us / 1e3 / (wall * 1e3):.1f}% "
        f"in {n_launch} device operations; prefill and decode logits finite")
    del act, cache, step
    torch.cuda.empty_cache()
    return params


def phase_lm_train(records, masters):
    """hymba-1.5b training at full width through the launcher's
    ``main`` with its own flags (bf16 activations over the serve
    phase's fp32 masters, popped from ``masters`` so that the first
    update frees them; sgd lr 2e-3): 4 steps of
    1 x 4096 tokens.  Every loss finite; per step, the counts zeroed
    just before and read just after: B5 and B6 forward and their
    backward kernels once per layer each, nothing else.  Step time after
    the warm-up step (host clock around each step, batch draw included),
    peak memory over the timed steps, and the last step traced."""
    from torch.autograd import DeviceType
    from repro_torch.configs import get_config
    from repro_torch.launch import train as lm_train
    cfg = get_config("hymba-1.5b")
    argv = ["--arch", "hymba-1.5b", "--steps", str(TRAIN_LM_STEPS),
            "--batch", str(TRAIN_LM_BATCH), "--seq", str(TRAIN_LM_SEQ),
            "--num-clients", "1", "--log-every", "1"]
    log(f"LM train path: repro_torch.launch.train "
        f"{' '.join(argv)} (full width, bf16 activations over fp32 "
        f"masters, sgd lr 2e-3; the reference's train_4k shape with its "
        f"global batch of 256 cut to {TRAIN_LM_BATCH}; depth cut to "
        f"{TRAIN_LM_STEPS} steps)")
    want = {k: 0 for k in read_counts()}
    want.update(flash_attention=cfg.num_layers, ssd_scan=cfg.num_layers,
                flash_attention_bwd=cfg.num_layers,
                ssd_scan_bwd=cfg.num_layers)
    st = {"losses": [], "times": [], "counts": [], "prof": None}

    def on_step(step, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        st["counts"].append(read_counts())
        st["losses"].append(float(loss))
        if step == 0:        # after the warm-up step
            torch.cuda.reset_peak_memory_stats()
        else:
            st["times"].append(now - st["t"])
        if step == TRAIN_LM_STEPS - 1:
            st["prof"].__exit__(None, None, None)
            st["traced_wall"] = now - st["t"]
        if step == TRAIN_LM_STEPS - 2:
            st["prof"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            st["prof"].__enter__()
        zero_counts()
        st["t"] = time.perf_counter()

    zero_counts()
    st["t"] = time.perf_counter()
    final = lm_train.main(argv, init=masters.pop, on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    counts = {k: sum(c[k] for c in st["counts"]) for k in want}
    for i, c in enumerate(st["counts"]):
        if c != want:
            raise AssertionError(f"LM train step {i}: kernel launches {c} != "
                                 f"one B5 and one B6, forward and backward, "
                                 f"per layer {want}")
    if len(st["losses"]) != TRAIN_LM_STEPS or not all(
            math.isfinite(x) for x in st["losses"] + [final]):
        raise AssertionError(f"LM train losses {st['losses']}")
    by_name = {}
    for e in st["prof"].events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time in "
                             "the traced LM train step")
    untraced = sorted(st["times"][:-1])
    med = untraced[len(untraced) // 2]
    log(f"  losses {st['losses']}; steps 1-{TRAIN_LM_STEPS - 1} after the "
        f"warm-up step " + ", ".join(f"{x:.4f}" for x in st["times"])
        + f" s (the last traced; untraced median {med:.4f} s = "
        f"{TRAIN_LM_BATCH * TRAIN_LM_SEQ / med:.0f} tokens/s); peak device "
        f"memory over them {peak / 2**30:.2f} GiB")
    log(f"  launches per step: {json.dumps(st['counts'][0])}")
    wall = st["traced_wall"]
    log(f"profile LM train step (traced, the last): wall {wall * 1e3:.1f} "
        f"ms, device busy {busy * 1e3:.1f} ms = {100 * busy / wall:.1f}% of "
        f"wall")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {us / 1e3:9.3f} ms  {kname[:90]}")
    for label, keys in (("B5 flash_attention forward", ("flash_fwd",)),
                        ("B5 backward", ("flash_bwd",)),
                        ("B6 ssd_scan forward", ("ssd_chunk_",
                                                 "ssd_state_pass",
                                                 "ssd_scan_kernel")),
                        ("B6 backward", ("ssd_bwd",))):
        part = {k: us for k, us in by_name.items()
                if any(key in k for key in keys)}
        log(f"  {label} in this step: {sum(part.values()) / 1e3:.3f} ms of "
            f"device time (" + ", ".join(
                f"{_short_name(k)} {us / 1e3:.3f} ms"
                for k, us in part.items()) + ")")
    for r in records:
        r["launches_by_path"]["lm_train"] = counts[r["name"]]
    torch.cuda.empty_cache()


def _fed_lm_want(fed) -> dict:
    """Launches of one round: B2 once, B4 once under top-k; B5 and its
    backward once per layer and local step on the batched path (the
    cohort folded into the batch axis) and once per layer, client and
    step on the host loop; B6 and its backward once per layer, client and
    step on both (one call per client)."""
    from repro_torch.configs.base import HYBRID, SSM
    cfg, spec = fed.model_cfg, fed.spec
    layers, steps = cfg.num_layers, spec.schedule.local_epochs
    k = len(fed.engine.scheduler.select(fed.round_index))
    vmap = spec.execution.exec_mode == "vmap"
    b5 = 0 if cfg.kind == SSM else layers * steps * (1 if vmap else k)
    b6 = layers * steps * k if cfg.kind in (SSM, HYBRID) else 0
    want = {name: 0 for name in read_counts()}
    want.update(fed_weighted_sum=1,
                fed_topk_ef=int("topk" in spec.transforms.names),
                flash_attention=b5, flash_attention_bwd=b5, ssd_scan=b6,
                ssd_scan_bwd=b6)
    return want


def _fed_lm_rounds(fed, rounds, label, traced_last=False):
    """``rounds`` steps of ``fed`` on the card, each with the counts zeroed
    just before and read just after, its host-clock wall time and its
    launches checked against :func:`_fed_lm_want`; the last one traced
    when ``traced_last`` (device time by kernel)."""
    from torch.autograd import DeviceType
    walls, counts, by_name = [], [], {}
    for i in range(rounds):
        want = _fed_lm_want(fed)
        prof = None
        if traced_last and i == rounds - 1:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        fed.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = read_counts()
        if prof is not None:
            prof.__exit__(None, None, None)
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) \
                        + e.time_range.elapsed_us()
        counts.append(got)
        if got != want:
            raise AssertionError(f"{label} round {i}: kernel launches {got} "
                                 f"!= {want}")
    return walls, counts, by_name


def _short_counts(c: dict) -> str:
    keys = (("B2", "fed_weighted_sum"), ("B4", "fed_topk_ef"),
            ("B5", "flash_attention"), ("B5-bwd", "flash_attention_bwd"),
            ("B6", "ssd_scan"), ("B6-bwd", "ssd_scan_bwd"))
    return ", ".join(f"{k} {c[n]}" for k, n in keys)


def _fed_lm_devs(a, b) -> "numpy.ndarray":
    import numpy as np
    from repro_torch.optim.optimizers import tree_leaves
    return np.concatenate([(x.detach().cpu() - y.detach().cpu()).abs()
                           .numpy().ravel()
                           for x, y in zip(tree_leaves(a), tree_leaves(b))])


def _within(devs, bound: float, topk: bool) -> bool:
    """Every parameter within ``bound``; under top-k, as the CPU tests
    hold it, all but at most 1e-4 of the entries (the kept set's support
    flips under fp32 summation-order differences), those within 1e-3."""
    if not topk:
        return float(devs.max()) <= bound
    return int((devs > bound).sum()) <= 1e-4 * devs.size \
        and float(devs.max()) <= 1e-3


def phase_lm_federation(records):
    """Federated LM training (``model.family="lm"``) on the card, through
    ``Federation.from_spec``.

    (a) The registry's ``lm_fedavg`` (host loop) and ``lm_dirichlet_topk``
    (batched cohort path, top-k deltas), and the latter over hymba-1.5b
    (B6), at the reduced sizes of ``tests/test_federated_lm.py``, 3
    rounds each: card against CPU from the same init within 1e-4 (top-k's
    support flips aside), ``lm_fedavg`` loop against vmap on the card
    within 1e-5, the launches of every round as :func:`_fed_lm_want`
    counts them.
    (b) hymba-1.5b at full width, 2 of its 32 layers (the bundle's fp32
    ``init``, ``loss`` and ``loss_sum`` through ``from_spec``'s
    overrides), 4 clients of 4 x 2048-token documents, client lr
    :data:`FED_LM_LR`:
    ``lm_dirichlet_topk`` on the batched path and ``lm_fedavg`` on the
    host loop, 3 rounds each (the third traced): wall time, busy share,
    peak memory, losses (they must fall), launches per round, and the
    held-out cross-entropy per token of the trained model."""
    import numpy as np
    from repro_torch.api import (Federation, heldout_xent_per_token,
                                 scenario_spec, spec_replace)
    from repro_torch.models.registry import build_model
    t_start = time.perf_counter()
    tiny = {"model.vocab": 128, "model.seq_len": 16, "data.num_clients": 3,
            "data.docs_per_node": 24, "data.val_docs_per_node": 8,
            "schedule.rounds": 3}
    log("LM federation (a): the registry's LM scenarios at the reduced "
        "sizes of tests/test_federated_lm.py (vocab 128, 16 tokens a "
        "document, 3 clients of 24 documents, 3 rounds), card vs CPU")
    totals = {name: 0 for name in read_counts()}
    feds = {}
    for label, name, extra in (
            ("lm_fedavg", "lm_fedavg", {}),
            ("lm_fedavg on vmap", "lm_fedavg",
             {"execution.exec_mode": "vmap"}),
            ("lm_dirichlet_topk", "lm_dirichlet_topk", {}),
            ("lm_dirichlet_topk over hymba-1.5b", "lm_dirichlet_topk",
             {"model.arch": "hymba-1.5b"})):
        spec = spec_replace(scenario_spec(name), {**tiny, **extra})
        cpu = Federation.from_spec(spec, device="cpu")
        gpu = Federation.from_spec(spec, device="cuda",
                                   init_params=cpu.params)
        cpu.run()
        walls, counts, _ = _fed_lm_rounds(gpu, 3, label)
        for c in counts:
            for k_, v_ in c.items():
                totals[k_] += v_
        devs = _fed_lm_devs(cpu.params, gpu.params)
        topk = "topk" in spec.transforms.names
        losses = [h["loss"] for h in gpu.history]
        ldev = max(abs(a["loss"] - b["loss"])
                   for a, b in zip(cpu.history, gpu.history))
        log(f"  {label} ({spec.model.arch}, {spec.execution.exec_mode}): "
            f"card vs CPU max |diff| {devs.max():.3e}, "
            f"{int((devs > 1e-4).sum())} of {devs.size} entries beyond 1e-4, "
            f"losses {ldev:.3e}; losses {[round(x, 4) for x in losses]}; "
            f"rounds " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
            + f" ms; launches a round: {_short_counts(counts[0])}")
        if not (_within(devs, 1e-4, topk) and ldev <= 1e-4):
            raise AssertionError(f"{label}: card and CPU disagree beyond "
                                 f"1e-4")
        feds[label] = gpu
    dev_lv = float(_fed_lm_devs(feds["lm_fedavg"].params,
                                feds["lm_fedavg on vmap"].params).max())
    log(f"  lm_fedavg loop vs vmap on the card: max |diff| {dev_lv:.3e} "
        f"(bound 1e-5)")
    if not dev_lv <= 1e-5:
        raise AssertionError("LM federation: loop and vmap disagree on the "
                             "card beyond 1e-5")
    del feds

    # (b) full width
    cfg = _fed_lm_config()
    bundle = build_model(cfg, dtype=torch.float32)
    t0 = time.perf_counter()
    init = bundle.init(torch.Generator().manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sizes = {"model.arch": "hymba-1.5b", "model.vocab": cfg.vocab_size,
             "model.seq_len": FED_LM_SEQ,
             "data.num_clients": FED_LM_CLIENTS,
             "data.docs_per_node": FED_LM_DOCS,
             "data.val_docs_per_node": FED_LM_VAL_DOCS,
             "schedule.rounds": FED_LM_ROUNDS,
             "execution.batch_size": FED_LM_BATCH,
             "execution.learning_rate": FED_LM_LR}
    log(f"LM federation (b): hymba-1.5b at full width (d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, window {cfg.sliding_window}, SSD heads of P="
        f"{cfg.ssm.head_dim} N={cfg.ssm.state_dim} chunk "
        f"{cfg.ssm.chunk_size}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"fp32 as the reference federates, the port's seeded init "
        f"({t_init:.1f} s); {FED_LM_CLIENTS} clients, batch {FED_LM_BATCH} x "
        f"{FED_LM_SEQ} tokens, {FED_LM_DOCS} documents a node, client sgd lr "
        f"{FED_LM_LR} (the registry's 0.1 is sized for the reduced "
        f"configs); reduced: "
        f"depth {FED_LM_LAYERS} of 32 layers ({cfg.num_params()} "
        f"parameters by num_params), {FED_LM_ROUNDS} rounds")
    for name in ("lm_dirichlet_topk", "lm_fedavg"):
        spec = spec_replace(scenario_spec(name), sizes)
        fed = Federation.from_spec(spec, device="cuda", loss_fn=bundle.loss,
                                   loss_sum_fn=bundle.loss_sum,
                                   init_params=init)
        d = sum(p.numel() for p in fed.engine.params.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, counts, by_name = _fed_lm_rounds(fed, FED_LM_ROUNDS, name,
                                                traced_last=True)
        peak = torch.cuda.max_memory_allocated()
        for c in counts:
            for k_, v_ in c.items():
                totals[k_] += v_
        losses = [h["loss"] for h in fed.history]
        busy = sum(by_name.values()) / 1e6
        if busy <= 0:
            raise AssertionError(f"{name}: torch.profiler recorded no "
                                 f"device time in the traced round")
        part_spec = spec.data.partition.to_string()
        log(f"  {name} ({spec.execution.exec_mode}, {part_spec}, "
            f"transforms {list(spec.transforms.names)}; "
            f"clients {[c.num_docs for c in fed.engine.clients]} documents; "
            f"D = {d} parameters): rounds "
            + ", ".join(f"{w:.4f}" for w in walls)
            + f" s (the last traced: device busy {busy:.4f} s = "
            f"{100 * busy / walls[-1]:.1f}% of its wall); peak device "
            f"memory {peak / 2**30:.2f} GiB; losses {losses}; launches a "
            f"round: {_short_counts(counts[0])}")
        for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            log(f"    {us / 1e3:9.3f} ms  {kname[:90]}")
        for label, keys in (("B5", ("flash_fwd",)),
                            ("B5-bwd", ("flash_bwd",)),
                            ("B6", ("ssd_chunk_", "ssd_state_pass",
                                    "ssd_scan_kernel")),
                            ("B6-bwd", ("ssd_bwd",)),
                            ("B2", ("weighted_sum",)),
                            ("B4", ("key_pass", "low_pass", "write_pass"))):
            part = sum(us for k_, us in by_name.items()
                       if any(key in k_ for key in keys))
            log(f"    {label} in the traced round: {part / 1e3:.3f} ms")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"{name} at full width: losses {losses} "
                                 f"do not fall")
        zero_counts()
        t0 = time.perf_counter()
        xent = heldout_xent_per_token(fed.params, cfg,
                                      fed.corpus.val_tokens, batch=4)
        torch.cuda.synchronize()
        c = read_counts()
        log(f"    held-out cross-entropy per token (heldout_xent_per_token, "
            f"{len(fed.corpus.val_tokens)} documents, bf16 activations as "
            f"cfg.dtype says): {xent:.4f} (ln V = "
            f"{math.log(cfg.vocab_size):.4f}) in "
            f"{time.perf_counter() - t0:.2f} s; launches "
            f"{_short_counts(c)}")
        if not math.isfinite(xent):
            raise AssertionError(f"{name}: held-out cross-entropy {xent}")
        del fed
        torch.cuda.empty_cache()
    del init
    torch.cuda.empty_cache()
    log(f"  launches on the LM federation path: {json.dumps(totals)}; the "
        f"phase took {time.perf_counter() - t_start:.1f} s")
    for r in records:
        r["launches_by_path"]["lm_federation"] = totals[r["name"]]


def phase_lm_agreement():
    """Reduced hymba-1.5b in fp32 from the same weights on the card
    (kernels B5 and B6) and on the CPU (their plain versions): prefill
    over 96 tokens, past the window of 64 and over two SSD chunks of 64,
    then 4 teacher-forced decode steps; logits within 2e-4, the repo's
    bound for this path."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import transformer as tfm
    cfg = get_config("hymba-1.5b").reduced()
    cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 100)))
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", _tree_to(cpu, "cuda"))):
        before = (flash_attention.launches, ssd_scan.launches)
        logits, cache = tfm.prefill(params, cfg,
                                    {"tokens": toks[:, :96].to(dev)},
                                    dtype=torch.float32, max_len=100)
        outs = [logits]
        for i in range(4):
            step, cache = tfm.decode_step(params, cfg, cache,
                                          toks[:, 96 + i:97 + i].to(dev),
                                          dtype=torch.float32)
            outs.append(step)
        launched = (flash_attention.launches - before[0],
                    ssd_scan.launches - before[1])
        runs[dev] = ([o.cpu() for o in outs], launched)
    devs = [float((g - c).abs().max()) / max(float(c.abs().max()), 1.0)
            for c, g in zip(runs["cpu"][0], runs["cuda"][0])]
    log(f"agreement LM (reduced hymba-1.5b, fp32, 2 x 96 + 4 decode "
        f"steps): card vs CPU logits, max |diff| / max(|cpu|, 1): prefill "
        f"{devs[0]:.3e}, decode " + ", ".join(f"{d:.3e}" for d in devs[1:])
        + " (bound 2e-4)")
    if runs["cpu"][1] != (0, 0) \
            or runs["cuda"][1] != (cfg.num_layers, cfg.num_layers):
        raise AssertionError(f"LM agreement: B5/B6 launches CPU "
                             f"{runs['cpu'][1]}, card {runs['cuda'][1]}; "
                             f"want none and one per layer")
    if not max(devs) <= 2e-4:
        raise AssertionError("card and CPU LM paths disagree beyond 2e-4")
    # train_loss and every gradient leaf, through the backward kernels on
    # the card and the plain backward passes on the CPU
    from repro_torch.optim.optimizers import tree_leaves
    batch = {"tokens": toks[:, :96], "labels": toks[:, 1:97]}
    grads = {}
    for dev, params in (("cpu", cpu), ("cuda", _tree_to(cpu, "cuda"))):
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = tfm.train_loss(params, cfg, {k: v.to(dev) for k, v in
                                            batch.items()},
                              dtype=torch.float32)
        loss.backward()
        grads[dev] = (float(loss.detach()), [x.grad.cpu() for x in leaves])
    gdev = max(float((g - c).abs().max()) / max(float(c.abs().max()), 1e-30)
               for c, g in zip(grads["cpu"][1], grads["cuda"][1]))
    ldev = abs(grads["cuda"][0] - grads["cpu"][0]) / abs(grads["cpu"][0])
    log(f"agreement LM train (reduced hymba-1.5b, fp32, 2 x 96): card vs "
        f"CPU train_loss {ldev:.3e}, gradients max |diff| / max|cpu| over "
        f"{len(grads['cpu'][1])} leaves {gdev:.3e} (bound 1e-4)")
    if not (gdev <= 1e-4 and ldev <= 1e-4):
        raise AssertionError("card and CPU LM gradients disagree beyond "
                             "1e-4")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs the "
              "port on the card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(here, "src"))
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    records = phase_kernels()
    spec, corpus = phase_main_path(records)
    phase_training(records, corpus)
    phase_algorithm1(records, corpus)
    phase_loop_transforms(records, corpus)
    phase_ntm_train_mode(records, corpus)
    phase_lm_train(records, [phase_lm_serve(records)])
    phase_lm_federation(records)
    for r in records:
        r["launches"] = sum(r["launches_by_path"].values())
    phase_profile(spec, corpus)
    phase_training_profile(corpus)
    phase_agreement()
    phase_lm_agreement()
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("launches_by_path", "k5", "variant", "dp_ms", "dp_plain_ms",
             "dp_bound_ms", "dp_library_ms", "cold_ms", "library_cold_ms",
             "dp_cold_ms", "yardstick", "yardstick_ms",
             "max_abs_err_by_dtype", "pairs", "library", "design", "ptxas",
             "smem_bytes", "launch_us", "mamba2_ms", "device_ops_per_call",
             "replaces_note", "fwd_ms", "fwd_lse_ms", "fwd_states_ms",
             "routes", "fp32_case", "fp32_ms", "fed_lm")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                for r in records]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
