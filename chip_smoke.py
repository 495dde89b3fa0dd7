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
   dim, B6's bf16 route also at mamba2-1.3b's width; B5 also at the
   dense zoo's head-dim pairs (80, 80), (96, 64), (80, 64) and the MoE
   archs' GQA groups in both dtypes, timed in bf16 at the minicpm3-4b,
   hubert-xlarge, qwen2-vl-7b, granite-34b, qwen3-moe-235b-a22b and
   llama4-maverick-400b-a17b prefill shapes beside the library call),
   and timed
   at the shapes its path gives it beside its plain version, a library
   call (or, for B4, a yardstick) where one exists
   (B3 and its library call also with the L2 evicted before each call;
   B4 also over its chunk edges and edge rows, with the device time of
   each of its device operations),
   and its bound (bytes over 3.35 TB/s, or
   flops over 67 TFLOP/s fp32 for B1-B4 and 989 TFLOP/s bf16 for B5-B6,
   whichever is larger: the H100 SXM data-sheet peaks at its 700 W power
   limit; B5's and B5-bwd's fp32 routes, split TF32 on the tensor cores,
   at three TF32 products an fp32 product over 494.7 TFLOP/s, with the
   67 TFLOP/s fp32 bound beside); B5's fp32 route also at (32, 32),
   misaligned fp32 operands refused, and the forward timed at the
   minicpm3-4b round's fp32 shape; then the backward kernels of B5 and
   B6 against their plain
   backward passes over a grid (B5: causal, windowed and full masks, GQA,
   ragged S, D = 32, 64, 96, 128, fp32 and bf16, both on the tensor
   cores, two fp32 calls bitwise over several flushes of dK and dV, and
   at the zoo's pairs (80, 80), (96, 64), (80, 64) in both
   dtypes, timed at minicpm3-4b's and hubert-xlarge's 1 x 4096 training
   shapes and at the minicpm3-4b round's fp32 one beside the library's
   backward; B6: chunk edges, a ragged tail, N = 16, 64, 128, a cotangent
   on h_last, fp32 and bf16, bf16 on the tensor cores, and its ragged
   bf16 case on the saved draw where ``da`` once left its bound, beside a
   float64 plain backward, and over 40 draws of its own)
   and timed at the LM training path's shapes (B5's beside the backward
   of ``F.scaled_dot_product_attention``), each fp32 route at its grid
   case; then B5, B6 and their backward kernels on their fp32 routes,
   and B2 and B4 over the (4, D) message slab, at the federated LM
   path's full-width shapes (B5 forward and backward beside the fp32
   library attention; B4 bitwise on three of its leaves, the 51 M-entry
   embedding among them); B2 also at the straggler ring's (15, D) slab
   beside ``torch.matmul``;
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
   straggler ring (``phase_ring_and_resume``): ``straggler_ring`` at the
   same width on the batched path, 20 rounds, B2 at most twice a round,
   held every round against the host pending list within 1e-5; a
   snapshot after round 10 resumed in a fresh ``Federation`` bitwise,
   and the service's likewise; secure masks card == CPU bitwise, dp
   noise, normals and the ProdLDA init card against CPU within 4 ulps;
   the wire (``phase_wire``): ``buffered_async_net`` at the same width
   behind a ``BackgroundServer``, ``ServiceClient`` replicas on the
   card: the anchor over TCP (M=K=5, 3 sweeps) equal to the sync twin
   within 1e-5 with B2 once per aggregation, and its upload and
   ``GET /v1/model`` round trips of the 3.10 MB frame; ``run_traffic``
   with holds and duplicates in process and over the wire, ledgers
   equal; a bf16 upload bitwise the round trip and half the payload;
   topk and dp uploads (B4 or B3 once per upload); a malformed and a
   foreign-version frame answered 400 and recorded; ``federate_load``
   with a server process and 4 client processes on the card (their
   corpora cut to 2 000 + 200 docs a node), 2 sweeps, round-trip
   percentiles and rates; one ``/v1/generate`` of reduced hymba-1.5b
   (B5 and B6 once per layer);
9. LM serve path: ``repro_torch.launch.serve`` with hymba-1.5b at full
   width (bf16 activations, the reference's init from seed 0, drawn on
   the card and timed), batch 4 x 2048-token
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
   LM zoo (``phase_lm_zoo``): ``repro_torch.launch.serve`` at full width
   (bf16 over the reference's init from seed 0, drawn on the card; 4 x
   2048-token prompts, 32 greedy tokens, after a warm-up call) for
   minicpm3-4b (MLA) and qwen2-vl-7b whole, then minicpm3-4b with the
   absorbed decode (its tokens against the expanded decode's, or its
   teacher-forced logits within a stated bound) and qwen2-vl-7b's
   prefill of a VLM batch; hubert-xlarge's whole 48-layer encoder over 4
   x 2048 frames; granite-34b at 8 of its 88 layers and qwen1.5-110b at
   2 of 80 (full width, cut in depth for one card); B5 once per layer of
   each prefill or forward, nothing else, never in decode; the five
   reduced configs card against CPU in fp32 within 2e-4;
   LM MoE (``phase_lm_moe``): ``repro_torch.launch.serve`` at full width
   (the weights read through a cast drawn straight into bf16 on the card
   from seed 0; 4 x 2048-token prompts, 32 greedy tokens, after a
   warm-up call) for qwen3-moe-235b-a22b at 8 of its 94 layers and
   llama4-maverick-400b-a17b at 2 of 48 (one dense + MoE unit), with
   the share of routed (token, slot) pairs the capacity dropped in the
   prefill; B5 once per layer of each prefill, nothing else, never in
   decode; one full-width qwen3-moe MoE layer in fp32 over 1 x 256
   tokens at capacity factor 64 against the plain dense top-k mixture;
   the two reduced MoE configs card against CPU in fp32 (expert sets
   first: a differing set is a counted flip only at a near-tie of the
   k-th and (k+1)-th probabilities, its row then left out; logits within
   2e-4);
   LM zoo training (``phase_lm_zoo_train``): ``repro_torch.launch.train``'s
   ``main`` at full width, 3 sgd steps of 1 x 4096 from the seeded init
   on the card (bf16 activations over fp32 masters): hubert-xlarge and
   minicpm3-4b (``remat="layer"``) whole, qwen2-vl-7b at 8 of 28 layers,
   granite-34b at 4 of 88, qwen1.5-110b at 1 of 80, qwen3-moe-235b-a22b
   at 1 of 94; per step B5 once per layer (twice under remat) and its
   backward once per layer, nothing else; step times, peak memory, the
   last step traced (busy share, B5 and B5-bwd device time; the MoE
   dispatch's backward by autograd node); then one minicpm3-4b federated
   round on each exec mode (``lm_fedavg``, fp32, 2 of 62 layers, 4
   clients x 2 x 2048 tokens; B5-bwd's fp32 route at (96, 64) folded
   over the cohort); then the seven reduced zoo configs' ``train_loss``
   and every gradient leaf card against CPU within 2e-4;
   LM positions (``phase_lm_positions``): phi3-mini-3.8b whole in bf16,
   a 4 x 2048 prefill of left-padded prompts (pads 0, 1, 129, 1500,
   ``positions = arange(S) - pad``; B5 once a layer through its position
   instances) whose real tokens' logits hold within 2e-2 of the same
   tokens prefilled left-aligned without positions, then 32 decode steps;
   hymba-1.5b's left-padded prefill and a 1 x 4096 sgd step with a pad of
   1000 (B5, B5-bwd, B6, B6-bwd once a layer); mamba2-1.3b's scan at its
   width (4 x 4096, N=128, chunk 256) in two halves chained through
   h_last (B6 from h0) against one call, its ``vjp`` through B6-bwd's
   dh0 too, in bf16 and fp32; B5/B5-bwd with positions and B6/B6-bwd
   from h0 against their plain versions at those shapes, timed; the
   reduced configs left-padded and mamba2's layer from a carried state
   card against CPU within 2e-4;
   launch sizing (``phase_launch_sizing``): hymba-1.5b at full width, a
   1 x 4096 train step of ``launch.steps.make_train_step`` under remat
   ``"none"``, ``"dots"`` and ``"full"``, each policy's loss and every
   gradient leaf within 2e-4 of ``"none"``'s; step time, peak memory,
   busy share and launches per policy (B5 and B6 twice a layer under
   ``"dots"`` and ``"full"``, their backwards once); meanwhile on the
   host the dry run (``repro_torch.launch.dryrun``) of hymba-1.5b
   ``train_4k``, llama4-maverick-400b-a17b ``train_4k`` (fsdp) and
   qwen3-moe-235b-a22b ``decode_32k`` on the fake 16 x 16 mesh, each
   report's per-device memory against the card's and its roofline;
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
from typing import Optional

import torch

# H100 SXM data-sheet peaks at the 700 W power limit
H100_BYTES_PER_S = 3.35e12        # HBM3
H100_FP32_FLOPS = 67e12           # fp32 outside the tensor cores
H100_BF16_FLOPS = 989e12          # bf16 on the tensor cores, dense
H100_TF32_FLOPS = 494.7e12        # TF32 on the tensor cores, dense

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
# the straggler ring at full width: straggler_ring on the batched path,
# cut to 20 rounds, the mid-run snapshot after 10; the service's resume
# after 10 uploads, 10 more on each side
RING_ROUNDS, RING_SNAPSHOT, SERVICE_UPLOADS = 20, 10, 10
# the wire: the anchor and the parity runs at full width and depth, 3
# sweeps; the load run's spawned server and client processes each build
# their own corpus, cut in depth to LOAD_DOCS train + LOAD_VAL_DOCS
# validation docs a node (widths never are), 4 client processes, 2 sweeps
WIRE_SWEEPS, LOAD_PROCS, LOAD_SWEEPS = 3, 4, 2
LOAD_DOCS, LOAD_VAL_DOCS = 2_000, 200
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


def _trace(run, attempts: int = 3, cpu: bool = False,
           want: Optional[int] = None):
    """The device events of one ``torch.profiler`` trace around ``run()``
    (host activity traced too when ``cpu``).  ``want`` is the number of
    device operations ``run()`` launches (the calls times what one call
    launches, :func:`launches_per_call`).  Late in a process the profiler
    misses the first kernels launched in a trace (on the card, after the
    kernel phase's earlier traces: B6-bwd's first kernel counted n - 1
    times in every trace of n calls, one large B2 call missing from
    every one-call trace; in a fresh process none was missed), so each
    trace first runs 16 spin kernels to a synchronize and leaves them
    out, and a trace may hold one event fewer than ``want``; a trace
    short by more lost events (a partial trace, seen as a short sum), and
    a trace with no device event was dropped (seen once in about ten
    runs).  Either is taken again, at most ``attempts`` times, and then
    fails; a partial trace is never summed."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    seen = []
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            for _ in range(16):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        if events and (want is None or want - 1 <= len(events) <= want):
            return events
        seen.append(len(events))
    raise AssertionError(f"torch.profiler recorded {seen} device events in "
                         f"{attempts} traces, want "
                         f"{'some' if want is None else want}")


def per_call_ops(events, calls: int) -> dict:
    """``{name: (launches a call, mean device us a launch)}`` of a trace
    of ``calls`` calls: a name's launches a call are its events over the
    calls, rounded, so the one event a trace may miss biases neither."""
    by = {}
    for e in events:
        by.setdefault(_short_name(e.name) or e.name, []).append(
            e.time_range.elapsed_us())
    return {n: (round(len(v) / calls), sum(v) / len(v))
            for n, v in by.items()}


def launches_per_call(fn) -> int:
    """Device operations (kernels, copies, fills) one call of ``fn``
    launches: the larger count of two traces of 3 calls
    (:func:`per_call_ops`), since a trace may lose events but never gains
    one (a count from one partial trace once left every later trace of
    the plain B4 at the federated LM shape 4 events over it).  While both
    read 0 (two traces of 3 large B2 calls at the federated LM shape
    each kept one event on an H100, so that the trace of 10 calls was
    held to 0), up to two more traces are taken: every call measured
    here launches something."""
    counts = []
    while len(counts) < 2 or (max(counts) == 0 and len(counts) < 4):
        counts.append(sum(k for k, _ in per_call_ops(
            _trace(lambda: [fn(), fn(), fn()]), 3).values()))
    return max(counts)


def traced_ops(fn, calls: int, exclude=()) -> dict:
    """:func:`per_call_ops` of a trace of ``calls`` calls of ``fn`` that
    holds their launches (:func:`_trace`), names in ``exclude`` left
    out of the result."""
    per_call = launches_per_call(fn)
    ops = per_call_ops(_trace(lambda: [fn() for _ in range(calls)],
                              want=calls * per_call), calls)
    return {n: v for n, v in ops.items() if n not in exclude}


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call: the durations of every kernel, copy
    and fill it ran, from a ``torch.profiler`` trace of ``iters`` calls
    that holds the operations the calls launch (a partial trace is taken
    again, then fails), each operation's mean time times its launches a
    call.  A trace with no device time is a failure, not a zero."""
    fn()
    torch.cuda.synchronize()
    us = sum(k * mean for k, mean in traced_ops(fn, iters).values())
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3


def device_ms_cold(fn, iters: int = 20) -> float:
    """Mean device time of one call with a cold L2: before each call a
    128 MB write evicts the card's 50 MB L2, and only the write's own
    kernels are left out of the sum."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    flush.fill_(0.0)
    torch.cuda.synchronize()
    evict = set(per_call_ops(_trace(
        lambda: [flush.fill_(1.0) for _ in range(3)]), 3))
    step = [0]

    def call():
        step[0] += 1
        flush.fill_(float(step[0]))
        fn()
    us = sum(k * mean for k, mean in
             traced_ops(call, iters, exclude=evict).values())
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3


def bound_ms(nbytes: float, flops: float, peak: float = H100_FP32_FLOPS):
    t_b, t_f = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def split_tf32_bounds(rec: dict, nbytes: float, flops: float) -> None:
    """An fp32 route of B5 or B5-bwd: ``bound_ms`` at the split-TF32
    rate (three TF32 products an fp32 product, at the TF32 tensor-core
    peak), and beside it the bound at the fp32 CUDA-core peak."""
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 3 * flops,
                                                H100_TF32_FLOPS)
    rec["bound_cuda_core_ms"], rec["bound_cuda_core_by"] = bound_ms(
        nbytes, flops)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def phase_device():
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi_line())
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
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
    for is_bf16, fwd, bwd in ((1, "flash_fwd_tc_kernel",
                               "flash_bwd_dq_tc_kernel / "
                               "flash_bwd_dkdv_tc_kernel"),
                              (0, "flash_fwd_f32_kernel",
                               "flash_bwd_dq_f32_kernel / "
                               "flash_bwd_dkdv_f32_kernel")):
        log(f"  {fwd} dynamic shared memory a block: " + ", ".join(
            f"(Dqk, Dv)=({dq}, {dv}) {smem(dq, dv, is_bf16)} bytes"
            for dq, dv in ((32, 32), (64, 64), (80, 80), (96, 96),
                           (128, 128), (96, 64), (80, 64))))
        log(f"  {bwd} dynamic shared memory a block: " + ", ".join(
            f"(Dqk, Dv)={pair} {dq} / {kv} bytes"
            for pair, (dq, kv) in _b5_bwd_smem(is_bf16).items()))
    log("  ssd_scan bf16 route dynamic shared memory a block (the larger of "
        "its kernels): " + ", ".join(
            f"P={p} N={n} chunk {q} {b} bytes" for (p, n, q), b in
            zip(((64, 16, 256), (64, 128, 256)),
                _ssd_smem({"a": (64, 16, 256, 1),
                           "b": (64, 128, 256, 1)}).values())))


def _b5_bwd_smem(is_bf16: int = 1) -> dict:
    """Dynamic shared memory a block of B5-bwd's dq and dk/dv kernels of
    the bf16 (or fp32) route asks for, at each head-dim pair."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import HEAD_DIM_PAIRS
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_tc_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    return {str(p): [fn(*p, 0, is_bf16), fn(*p, 1, is_bf16)]
            for p in HEAD_DIM_PAIRS}


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
    # and the straggler ring's (C, D) slab, C = K * max_staleness = 15,
    # every slot due (the most a round reads)
    c_ring = 5 * 3
    xr = torch.randn(c_ring, d_model, generator=g).to(dev)
    wr = (torch.rand(c_ring, generator=g) * 40.0 + 1.0).to(dev)
    b2ring = {"name": f"fed_weighted_sum (C={c_ring} ring slab)"}
    b2ring["bound_ms"], b2ring["bound_by"] = bound_ms(
        (c_ring * d_model + c_ring + d_model) * 4, 2 * c_ring * d_model)
    e_ring = float(torch.max(torch.abs(fed_weighted_sum_cuda(xr, wr)
                                       - ref.fed_weighted_sum_ref(xr, wr))))
    if not e_ring <= 2e-6 * float(wr.sum()):
        raise AssertionError(f"B2 at the ring's shape: |kernel - plain| "
                             f"{e_ring}")
    _time_record(b2ring, lambda: fed_weighted_sum_cuda(xr, wr),
                 lambda: ref.fed_weighted_sum_ref(xr, wr),
                 lambda: torch.matmul(wr, xr))
    b2["ring"] = {k: b2ring[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}
    b2["ring"].update(shape=[c_ring, d_model], max_abs_err=e_ring)
    records = [b2, b1, _kernel_b3(g, dev), _kernel_b4(g, dev),
               _kernel_b5(g, dev), _kernel_b6(g, dev),
               _kernel_b5_bwd(g, dev), _kernel_b6_bwd(g, dev)]
    _kernel_fed_lm(g, dev, records)
    # a stream of its own, so that the checks above draw their inputs as
    # they did before these cases were added
    _kernel_b5_zoo(torch.Generator().manual_seed(27), dev, records[4])
    _kernel_b5_bwd_zoo(torch.Generator().manual_seed(29), dev, records[6])
    _kernel_b5_f32(torch.Generator().manual_seed(30), dev, records[4],
                   records[6])
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
    ops = traced_ops(lambda: fed_topk_ef_cuda(msgs, err, ids, table), 10)
    by = {n: k * mean for n, (k, mean) in ops.items()}
    rec["launch_us"] = by
    rec["device_ops_per_call"] = sum(k for k, _ in ops.values())
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
    # mamba2-1.3b's width (64 heads of P=64, N=128, chunk 256) on both
    # routes, and N=128 at chunk 256 with a ragged tail in fp32
    (1, LM_PROMPT, 64, 64, 128, 256, torch.bfloat16),
    (1, LM_PROMPT, 64, 64, 128, 256, torch.float32),
    (2, 520, 8, 32, 128, 256, torch.float32),
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
    (1, LM_PROMPT, 64, 64, 128, 256, FP32),
    (2, 520, 8, 16, 128, 256, FP32),          # N=128 at chunk 256, ragged
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
           "routes": {"bfloat16": "wgmma", "float32": "split_tf32_wgmma"},
           "ptxas": _ptxas_record("flash_attention", ("flash_fwd_",)),
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


# B5 at the dense zoo's head dims: (b, hq, hkv, s, dqk, dv, causal, window)
# in both dtypes; hubert's 80 (full mask), MLA's (96, 64) and reduced
# (80, 64), GQA 7:1 (qwen2-vl's 28/4) and MQA 48:1 (granite's 48/1)
B5_ZOO_CASES = [
    (2, 4, 4, 300, 80, 80, False, 0), (1, 7, 1, 257, 80, 80, True, 0),
    (1, 4, 2, 200, 80, 80, True, 64),
    (2, 8, 8, 257, 96, 64, True, 0), (1, 48, 1, 130, 96, 64, True, 40),
    (1, 4, 4, 193, 96, 64, False, 0),
    (2, 4, 4, 100, 80, 64, True, 0), (1, 7, 1, 200, 80, 64, False, 24),
    (1, 28, 4, 160, 128, 128, True, 0), (1, 48, 1, 160, 128, 128, True, 0),
    # the MoE archs' GQA 16:1 (qwen3-moe's 64/4) and 5:1 (llama4's 40/8)
    (1, 64, 4, 160, 128, 128, True, 0), (1, 40, 8, 200, 128, 128, True, 0),
]
# the zoo's bf16 prefill shapes, timed: (label, b, hq, hkv, s, dqk, dv,
# causal); launches a prefill (one per layer) beside each
B5_ZOO_TIMED = [
    ("minicpm3-4b", LM_BATCH, 40, 40, LM_PROMPT, 96, 64, True, 62),
    ("hubert-xlarge", LM_BATCH, 16, 16, LM_PROMPT, 80, 80, False, 48),
    ("qwen2-vl-7b", LM_BATCH, 28, 4, LM_PROMPT, 128, 128, True, 28),
    ("granite-34b", LM_BATCH, 48, 1, LM_PROMPT, 128, 128, True, 88),
    # the MoE phase's depth cuts: 8 of 94 layers, 2 of 48
    ("qwen3-moe-235b-a22b", LM_BATCH, 64, 4, LM_PROMPT, 128, 128, True, 8),
    ("llama4-maverick-400b-a17b", LM_BATCH, 40, 8, LM_PROMPT, 128, 128,
     True, 2),
]


def _kernel_b5_zoo(g, dev, rec):
    """B5 at head dim 80 and with a value head dim of its own: against the
    plain version over :data:`B5_ZOO_CASES` (k and v the column slices of
    one projection, v the strided view MLA gives), then the bf16 route
    timed at the zoo's prefill shapes beside the plain version and
    ``F.scaled_dot_product_attention`` (which takes Dv != Dqk), with
    each shape's bound; into ``rec["zoo"]``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    errs = {}
    for b, hq, hkv, s, dqk, dv, causal, window in B5_ZOO_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, s, hq, dqk, generator=g).to(dev, dtype)
            kv = torch.randn(b, s, hkv, dqk + dv, generator=g).to(dev, dtype)
            k, v = kv[..., :dqk], kv[..., dqk:]
            got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       scale=dqk ** -0.5).float()
            want = ref.flash_attention_fwd_ref(
                q, k, v, causal=causal, window=window)[0].float()
            torch.cuda.synchronize()
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            e = float((got - want).abs().max())
            if got.shape != (b, s, hq, dv) or not bool(
                    ((got - want).abs() <= tol + tol * want.abs()).all()):
                raise AssertionError(
                    f"B5 {(b, hq, hkv, s, dqk, dv, causal, window)} {dtype}: "
                    f"{tuple(got.shape)}, |kernel - plain| {e} beyond {tol} "
                    f"+ {tol}|plain|")
            key = str(dtype).replace("torch.", "")
            errs[key] = max(errs.get(key, 0.0), e)
            del q, kv, k, v, got, want
    log(f"B5 flash_attention at the zoo's head dims: {len(B5_ZOO_CASES)} "
        f"shapes x fp32, bf16 ((Dqk, Dv) = (80, 80), (96, 64), (80, 64), "
        f"(128, 128); causal, window, full; GQA 7:1, 16:1, 5:1, MQA 48:1; "
        f"v the strided view of a fused projection): max |kernel - plain| "
        f"{errs} (bounds 2e-5 fp32, 2e-2 bf16, abs + rel)")
    rec["max_abs_err"] = max(rec["max_abs_err"], *errs.values())
    for key, e in errs.items():
        rec["max_abs_err_by_dtype"][key] = max(
            rec["max_abs_err_by_dtype"].get(key, 0.0), e)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec["zoo"] = {}
    for label, b, hq, hkv, s, dqk, dv, causal, per_prefill in B5_ZOO_TIMED:
        q = torch.randn(b, s, hq, dqk, generator=g).to(dev, torch.bfloat16)
        kv = torch.randn(b, s, hkv, dqk + dv, generator=g).to(dev,
                                                             torch.bfloat16)
        k, v = kv[..., :dqk], kv[..., dqk:]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pairs = b * hq * _window_pairs(s, causal, 0)
        r = {"name": f"flash_attention ({label} prefill, ({dqk}, {dv}))",
             "shape": [b, s, hq, hkv, dqk, dv], "causal": causal,
             "launches_per_prefill": per_prefill}
        r["bound_ms"], r["bound_by"] = bound_ms(
            2 * b * s * (hq * dqk + hkv * dqk + hkv * dv + hq * dv),
            2 * (dqk + dv) * pairs, H100_BF16_FLOPS)
        _time_record(r,
                     lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                  window=0,
                                                  scale=dqk ** -0.5),
                     lambda: ref.flash_attention_ref(
                         q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=0),
                     lambda: sdpa(qt, kt, vt, is_causal=causal,
                                  enable_gqa=hkv != hq))
        rec["zoo"][label] = {x: r[x] for x in (
            "shape", "causal", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "launches_per_prefill")}
        del q, kv, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def _kernel_b5_f32(g, dev, rec, rec_bwd):
    """B5's and B5-bwd's fp32 routes (split TF32 on the tensor cores) past
    the grids above: the forward at (Dqk, Dv) = (32, 32), so that the
    kernel phase holds every pair in fp32; two backward calls bitwise over
    key tiles whose dK and dV leave the accumulators more than once;
    misaligned fp32 operands refused before any launch; the forward timed
    at the minicpm3-4b federated round's folded batch beside the plain
    version and ``F.scaled_dot_product_attention`` (fp32), with its
    split-TF32 and CUDA-core bounds; into ``rec["zoo"]`` and
    ``rec_bwd["fp32_repeat"]``."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    b, hq, hkv, s, d = 1, 8, 2, 100, 32
    fused = torch.randn(b, s, hq + 2 * hkv, d, generator=g).to(dev)
    q, k, v = fused.split([hq, hkv, hkv], dim=2)
    got = flash_attention_cuda(q, k, v, causal=True, window=0,
                               scale=d ** -0.5)
    want = ref.flash_attention_fwd_ref(q, k, v, causal=True, window=0)[0]
    e32 = float((got - want).abs().max())
    if not bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()):
        raise AssertionError(f"B5 fp32 at (32, 32): |kernel - plain| {e32}")
    # two backward calls, bitwise, over four flushes of dK and dV
    case = (1, 4, 4, 1100, 96, 64, True, 0)
    q, k, v, out, lse, dout, kw = _b5_bwd_pair_inputs(g, dev, *case, FP32)
    first, second = (flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
                     for _ in range(2))
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    rel = [_rel_err(a, w) for a, w in zip(first, want)]
    same = all(same_bits(a, c) for a, c in zip(first, second))
    if not (same and max(rel) <= 2e-5):
        raise AssertionError(f"B5 backward fp32 {case}: repeat bitwise "
                             f"{same}, (dq, dk, dv) |kernel - plain| / "
                             f"max|plain| {rel}")
    rec_bwd["fp32_repeat"] = {"case": list(case), "bitwise": same,
                              "max_rel_err": max(rel)}
    del q, k, v, out, lse, dout, first, second, want
    # misaligned fp32 operands: a q 4 bytes off 16, (b, s, h) strides of
    # 66 elements; nothing launches
    refused, before = 0, (flash_attention.launches,
                          flash_attention.bwd_launches)
    kk = torch.zeros(2, 64, 1, 64, device=dev)
    out = torch.zeros(2, 64, 2, 64, device=dev)
    lse = torch.zeros(2, 2, 64, device=dev)
    for qq in (torch.zeros(2 * 64 * 2 * 64 + 1, device=dev)[1:].view(
            2, 64, 2, 64),
               torch.zeros(2, 64, 2, 66, device=dev)[..., :64]):
        for call in (lambda: flash_attention_cuda(
                qq, kk, kk, causal=True, window=0, scale=0.125),
                     lambda: flash_attention_bwd_cuda(
                qq, kk, kk, out, lse, out, causal=True, window=0,
                scale=0.125)):
            try:
                call()
            except ValueError as e:
                refused += "16-byte aligned" in str(e)
    after = (flash_attention.launches, flash_attention.bwd_launches)
    if refused != 4 or after != before:
        raise AssertionError(f"B5 fp32: {refused} of 4 misaligned calls "
                             f"refused, launches {before} -> {after}")
    log(f"B5 fp32 (split TF32): (32, 32) |kernel - plain| {e32:.3e} (bound "
        f"2e-5 abs + rel); backward at {case} two calls bitwise {same}, "
        f"{max(rel):.3e} of max|plain|; misaligned fp32 operands refused "
        f"by the forward and the backward ({refused} of 4), no launch")
    # the forward at the minicpm3-4b round's folded batch
    b, s, hq, hkv, dqk, dv = (ZOO_FED_CLIENTS * ZOO_FED_BATCH, ZOO_FED_SEQ,
                              40, 40, 96, 64)
    q = torch.randn(b, s, hq, dqk, generator=g).to(dev)
    kv = torch.randn(b, s, hkv, dqk + dv, generator=g).to(dev)
    k, v = kv[..., :dqk], kv[..., dqk:]
    got = flash_attention_cuda(q, k, v, causal=True, window=0,
                               scale=dqk ** -0.5)
    want = ref.flash_attention_fwd_ref(q, k, v, causal=True, window=0)[0]
    e_fed = _rel_err(got, want)
    if not e_fed <= 2e-5:
        raise AssertionError(f"B5 fp32 at the minicpm3-4b round's shape: "
                             f"|kernel - plain| / max|plain| {e_fed}")
    del got, want
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = b * hq * _window_pairs(s, True, 0)
    label = "minicpm3-4b federated round (fp32, clients folded)"
    r = {"name": f"flash_attention ({label}, ({dqk}, {dv}))"}
    # q, k, v read and out written once (fp32); QK^T over Dqk and PV over
    # Dv, in split TF32 (the fp32 CUDA-core bound beside)
    split_tf32_bounds(r, 4 * b * s * (hq * dqk + hkv * dqk + hkv * dv
                                      + hq * dv), 2 * (dqk + dv) * pairs)
    kern = lambda: flash_attention_cuda(  # noqa: E731
        q, k, v, causal=True, window=0, scale=dqk ** -0.5)
    _time_record(r, kern,
                 lambda: ref.flash_attention_ref(
                     q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), causal=True, window=0),
                 lambda: sdpa(qt, kt, vt, is_causal=True))
    rec.setdefault("zoo", {})[label] = {
        "shape": [b, s, hq, hkv, dqk, dv], "causal": True,
        "dtype": "float32", "max_rel_err": e_fed,
        "launches_per_call": launches_per_call(kern),
        "launches_on_path": ZOO_FED_LAYERS,
        **{x: r[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by", "bound_cuda_core_ms")}}
    log(f"  {r['name']}: |kernel - plain| / max|plain| {e_fed:.3e}; "
        f"{rec['zoo'][label]['launches_per_call']} device operations a "
        f"call, {ZOO_FED_LAYERS} a round (batched); CUDA-core bound "
        f"{r['bound_cuda_core_ms'] * 1e3:.2f} us")
    del q, kv, k, v, qt, kt, vt
    torch.cuda.empty_cache()


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
        f"256) in both; x/B/C strided; bf16 on the tensor cores, fp32 on "
        f"them in split TF32): max |kernel - plain| {errs} (bounds 1e-4 "
        f"fp32, 2e-2 bf16, of max|plain|)")
    b, s, h, p, n, chunk, dtype = B6_CASES[0]
    x, dt, a, bb, cc = _ssd_inputs(g, dev, b, s, h, p, n, dtype)
    rec = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:80",
           "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
           "design": "bf16: wgmma in three launches (ssd_chunk_state_kernel,"
                     " ssd_state_pass_kernel, ssd_chunk_scan_kernel); fp32: "
                     "split TF32 on wgmma in three launches "
                     "(ssd_chunk_state_f32_kernel, ssd_state_pass_kernel, "
                     "ssd_chunk_scan_f32_kernel)",
           "ptxas": _ptxas_record("ssd_scan", ("ssd_chunk_", "ssd_state_")),
           "smem_bytes": _ssd_smem({"hymba": (p, n, chunk, 1),
                                    "mamba2": (64, 128, 256, 1),
                                    "fp32_hymba": (p, n, chunk, 0),
                                    "fp32_mamba2": (64, 128, 256, 0)}),
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
    for key, dtype in (("mamba2_ms", BF16), ("mamba2_fp32_ms", FP32)):
        x, dt, a, bb, cc = _ssd_inputs(g, dev, 1, LM_PROMPT, 64, 64, 128,
                                       dtype)
        rec[key] = device_ms(lambda: ssd_scan_cuda(x, dt, a, bb, cc,
                                                   chunk=256))
        log(f"  ssd_scan at mamba2-1.3b's width (1, 2048, 64 heads, P=64, "
            f"N=128, chunk 256, {str(dtype).replace('torch.', '')}): device "
            f"{rec[key] * 1e3:.2f} us/call")
        del x, dt, a, bb, cc
    return rec


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| (in fp32)."""
    want = want.float()
    return float((got.float() - want).abs().max()) \
        / max(float(want.abs().max()), 1e-30)


def _device_ops(fn, calls: int = 5) -> dict:
    """Device time per call (us) of each device operation of ``fn``."""
    return {n: k * mean for n, (k, mean) in traced_ops(fn, calls).items()}


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
        f"the tensor cores, fp32 on them in split TF32): max |kernel - "
        f"plain| {errs}, of max|plain| {worst:.3e} (bounds 2e-5 fp32, 2e-2 "
        f"bf16, of each gradient's max|plain|)")
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
           "routes": {"bfloat16": "wgmma", "float32": "split_tf32_wgmma"},
           "design": "bf16: wgmma in three launches (flash_bwd_dq_tc_kernel"
                     ", flash_bwd_dkdv_tc_kernel per query head, "
                     "flash_bwd_group_sum_kernel); fp32: split-TF32 wgmma "
                     "in two launches (flash_bwd_dq_f32_kernel, "
                     "flash_bwd_dkdv_f32_kernel summing the GQA group in "
                     "registers), two warpgroups a block sharing the own "
                     "tiles; both templated on the forward's (Dqk, Dv) "
                     "pairs",
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
    log(f"  flash_attention backward fp32 (split TF32) at {case[:-1]}: "
        f"device {rec['fp32_ms'] * 1e3:.2f} us/call")
    del q, k, v, out, lse, dout
    return rec


# B5's backward at the zoo's head-dim pairs: (b, hq, hkv, s, dqk, dv,
# causal, window), each in both dtypes: hubert's (80, 80) with a full
# mask, MLA's (96, 64) and its reduced config's (80, 64) causal; causal
# and non-causal windows, GQA, MQA 7:1 and 48:1, ragged tails
B5_BWD_ZOO_CASES = [
    (2, 4, 4, 200, 80, 80, False, 0), (1, 7, 1, 257, 80, 80, True, 0),
    (1, 4, 2, 130, 80, 80, True, 40),
    (2, 8, 8, 257, 96, 64, True, 0), (1, 48, 1, 130, 96, 64, True, 40),
    (1, 4, 4, 193, 96, 64, False, 0),
    (2, 4, 4, 100, 80, 64, True, 0), (1, 7, 1, 200, 80, 64, False, 24),
    (1, 4, 2, 129, 80, 64, True, 0),
]
# the zoo's training shapes (1 x 4096, the launcher's sgd step), timed:
# (label, b, hq, hkv, s, dqk, dv, causal, dtype, launches a step or a
# round on the training or federation path, None where no path takes
# the shape); the fp32 row is the minicpm3-4b federated round's folded
# batch (ZOO_FED_CLIENTS x ZOO_FED_BATCH documents of ZOO_FED_SEQ tokens)
ZOO_FED_LAYERS, ZOO_FED_CLIENTS, ZOO_FED_BATCH, ZOO_FED_SEQ = 2, 4, 2, 2048
B5_BWD_ZOO_TIMED = [
    ("minicpm3-4b train step", 1, 40, 40, TRAIN_LM_SEQ, 96, 64, True, BF16,
     62),
    ("hubert-xlarge train step", 1, 16, 16, TRAIN_LM_SEQ, 80, 80, False,
     BF16, 48),
    ("(80, 64) at minicpm3-4b's shape (the reduced config's pair)", 1, 40,
     40, TRAIN_LM_SEQ, 80, 64, True, BF16, None),
    ("minicpm3-4b federated round (fp32, clients folded)",
     ZOO_FED_CLIENTS * ZOO_FED_BATCH, 40, 40, ZOO_FED_SEQ, 96, 64, True,
     FP32, ZOO_FED_LAYERS),
]


def _b5_bwd_pair_inputs(g, dev, b, hq, hkv, s, dqk, dv, causal, window,
                        dtype):
    """q (B,S,H,Dqk), k and v the column slices of one (B,S,Hkv,Dqk+Dv)
    projection (v the strided view MLA's expansion gives), dout, and the
    forward kernel's out and lse."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.randn(b, s, hq, dqk, generator=g).to(dev, dtype)
    kv = torch.randn(b, s, hkv, dqk + dv, generator=g).to(dev, dtype)
    k, v = kv[..., :dqk], kv[..., dqk:]
    dout = torch.randn(b, s, hq, dv, generator=g).to(dev, dtype)
    kw = dict(causal=causal, window=window, scale=dqk ** -0.5)
    out, lse = flash_attention_cuda(q, k, v, want_lse=True, **kw)
    return q, k, v, out, lse, dout, kw


def _kernel_b5_bwd_zoo(g, dev, rec):
    """B5's backward at the zoo's head-dim pairs (80, 80), (96, 64) and
    (80, 64): against ``ref.flash_attention_bwd_ref`` over
    :data:`B5_BWD_ZOO_CASES` in both dtypes (both on the tensor cores,
    fp32 in split TF32), then timed at the training and federation
    paths' shapes (:data:`B5_BWD_ZOO_TIMED`) beside the plain backward
    and the backward of ``F.scaled_dot_product_attention`` (which takes
    Dv != Dqk), with each shape's bound (6 Dqk + 4 Dv flops a (q, k)
    pair) and the device operations a call; into ``rec["zoo"]``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    errs, worst = {}, 0.0
    for case in B5_BWD_ZOO_CASES:
        for dtype in (FP32, BF16):
            q, k, v, out, lse, dout, kw = _b5_bwd_pair_inputs(
                g, dev, *case, dtype)
            got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
            _, lse_w = ref.flash_attention_fwd_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = 2e-5 if dtype == FP32 else 2e-2
            rel = [_rel_err(a, w) for a, w in zip(got, want)]
            e_lse = float((lse - lse_w).abs().max())
            shapes = [tuple(a.shape) for a in got] == \
                [tuple(w.shape) for w in want]
            if not (shapes and max(rel) <= tol and e_lse <= tol * max(
                    float(lse_w.abs().max()), 1.0)):
                raise AssertionError(
                    f"B5 backward {case} {dtype}: shapes "
                    f"{[tuple(a.shape) for a in got]}, (dq, dk, dv) |kernel "
                    f"- plain| / max|plain| {rel}, lse {e_lse}; bound {tol}")
            key = str(dtype).replace("torch.", "")
            errs[key] = max([errs.get(key, 0.0)]
                            + [float((a.float() - w.float()).abs().max())
                               for a, w in zip(got, want)])
            worst = max(worst, max(rel))
            del q, k, v, out, lse, dout, got, want
    log(f"B5 flash_attention backward at the zoo's head dims: "
        f"{len(B5_BWD_ZOO_CASES)} shapes x fp32, bf16 ((Dqk, Dv) = (80, 80), "
        f"(96, 64), (80, 64); causal, full, causal and non-causal windows; "
        f"GQA, MQA 7:1 and 48:1; ragged S down to a one-row tail; v the "
        f"strided view of a fused projection): max |kernel - plain| "
        f"{errs}, of max|plain| {worst:.3e} (bounds 2e-5 fp32, 2e-2 bf16, "
        f"of each gradient's max|plain|)")
    rec["max_abs_err"] = max(rec["max_abs_err"], *errs.values())
    for key, e in errs.items():
        rec["max_abs_err_by_dtype"][key] = max(
            rec["max_abs_err_by_dtype"].get(key, 0.0), e)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec["smem_bytes"] = {"bfloat16": _b5_bwd_smem(1),
                         "float32": _b5_bwd_smem(0)}
    rec["zoo"] = {}
    for label, b, hq, hkv, s, dqk, dv, causal, dtype, per_path in \
            B5_BWD_ZOO_TIMED:
        q, k, v, out, lse, dout, kw = _b5_bwd_pair_inputs(
            g, dev, b, hq, hkv, s, dqk, dv, causal, 0, dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=hkv != hq)
        dout_t = dout.transpose(1, 2).contiguous()
        pairs = b * hq * _window_pairs(s, causal, 0)
        isz = 2 if dtype == BF16 else 4
        r = {"name": f"flash_attention_bwd ({label}, ({dqk}, {dv}), "
                     f"{str(dtype).replace('torch.', '')})",
             "shape": [b, s, hq, hkv, dqk, dv], "causal": causal,
             "dtype": str(dtype).replace("torch.", ""),
             "launches_on_path": per_path}
        # q, k, v, out, dout read once and dq, dk, dv written once in the
        # operands' dtype, lse read (fp32); 6 Dqk + 4 Dv flops a pair at
        # the bf16 peak, or in split TF32 (with the CUDA-core bound beside)
        nbytes = isz * (2 * b * s * (hq * dqk + hkv * dqk + hkv * dv)
                        + 2 * b * s * hq * dv) + 4 * b * hq * s
        if dtype == BF16:
            r["bound_ms"], r["bound_by"] = bound_ms(
                nbytes, (6 * dqk + 4 * dv) * pairs, H100_BF16_FLOPS)
        else:
            split_tf32_bounds(r, nbytes, (6 * dqk + 4 * dv) * pairs)
        kern = lambda: flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, out, lse, dout, **kw)
        _time_record(r, kern,
                     lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse,
                                                         dout, **kw),
                     lambda: torch.autograd.grad(lib_out, (qt, kt, vt),
                                                 dout_t, retain_graph=True))
        r["launches_per_call"] = launches_per_call(kern)
        log(f"  {r['name']}: {r['launches_per_call']} device operations a "
            f"call; {per_path} calls a step or round on its path")
        rec["zoo"][label] = {x: r[x] for x in (
            "shape", "causal", "dtype", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "launches_per_call", "launches_on_path")}
        if "bound_cuda_core_ms" in r:
            rec["zoo"][label]["bound_cuda_core_ms"] = r["bound_cuda_core_ms"]
        del q, k, v, out, lse, dout, qt, kt, vt, lib_out, dout_t
        torch.cuda.empty_cache()


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
    # the ragged bf16 case on the saved draw where ``da`` (one sum a head
    # over terms that cancel) read 0.106 of max|plain| before its state
    # values became hi + lo pairs, and over 40 draws of its own (seeds
    # 0-39)
    saved = _b6_bwd_saved_draw(dev)
    if not max(saved["kernel_vs_plain"]) <= 2e-2:
        raise AssertionError(f"B6 backward on the saved draw: (dx, ddt, da, "
                             f"db, dc) {saved['kernel_vs_plain']}; bound "
                             f"2e-2")
    da = {}
    for dtype, tol in ((BF16, 2e-2), (FP32, 1e-4)):
        key = str(dtype).replace("torch.", "")
        da[key] = []
        for seed in range(40):
            gs = torch.Generator().manual_seed(seed)
            x, dt, a, bb, cc = _ssd_inputs(gs, dev, 1, 100, 2, 32, 16, dtype)
            dy = torch.randn(1, 100, 2, 32, generator=gs).to(dev, dtype)
            dh = torch.randn(1, 2, 32, 16, generator=gs).to(dev)
            _, _, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=48,
                                     keep_states=True)
            rel = [_rel_err(u, w) for u, w in zip(
                ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, dh, chunk=48),
                ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, dh, 48))]
            if not max(rel) <= tol:
                raise AssertionError(f"B6 backward (1, 100, 2, 32, 16, 48) "
                                     f"{key} draw {seed}: (dx, ddt, da, db, "
                                     f"dc) {rel}; bound {tol}")
            da[key].append(rel[2])
        da[key].sort()
        log(f"  B6 backward (1, 100, 2, 32, 16, 48) {key} over 40 draws: da "
            f"of max|plain| min {da[key][0]:.3e}, median {da[key][20]:.3e}, "
            f"max {da[key][-1]:.3e} (bound {tol})")
    # the saved draw read in fp32, against a float64 plain backward
    saved32 = _b6_bwd_saved_draw(dev, FP32)
    if not max(saved32["kernel_vs_fp64"]) <= 1e-4:
        raise AssertionError(f"B6 backward fp32 on the saved draw: (dx, ddt,"
                             f" da, db, dc) of max|fp64| "
                             f"{saved32['kernel_vs_fp64']}; bound 1e-4")
    rec_saved = {"da_of_max_plain": saved["kernel_vs_plain"][2],
                 "da_of_max_fp64": saved["kernel_vs_fp64"][2],
                 "plain_da_of_max_fp64": saved["plain_vs_fp64"][2],
                 "draws_40_da_max": da["bfloat16"][-1],
                 "fp32_of_max_fp64": saved32["kernel_vs_fp64"],
                 "fp32_draws_40_da_max": da["float32"][-1]}
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
           "routes": {"bfloat16": "wgmma", "float32": "split_tf32_wgmma"},
           "design": "bf16: wgmma in four launches (ssd_bwd_rows_tc_kernel, "
                     "ssd_bwd_state_pass_kernel, ssd_bwd_cols_tc_kernel, "
                     "ssd_bwd_reduce_kernel); fp32: split TF32 on wgmma, "
                     "ssd_bwd_rows_f32_kernel and ssd_bwd_cols_f32_kernel "
                     "with the same state pass and head sums",
           "ptxas": _ptxas_record("ssd_scan_bwd", ("ssd_bwd_rows_",
                                                   "ssd_bwd_cols_")),
           "smem_bytes": _ssd_smem({"hymba": (p, n, chunk, 1),
                                    "mamba2": (64, 128, 256, 1),
                                    "fp32_hymba": (p, n, chunk, 0),
                                    "fp32_mamba2": (64, 128, 256, 0)},
                                   backward=True),
           "library": "none: no single PyTorch call computes the SSD scan's "
                      "gradient", "saved_draw": rec_saved}
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
    log(f"  ssd_scan backward fp32 (split TF32) at {case[:-1]}: device "
        f"{rec['fp32_ms'] * 1e3:.2f} us/call")
    del x, dt, a, bb, cc, dy, st
    return rec


# B6-bwd's grid case (1, 100, 2, 32, 16, 48) in bf16 on the one draw known
# to have put its ``da`` at 0.106 of max|plain|, replayed and saved by
# tools/replay_b6_bwd_draw.py
B6_BWD_DRAW = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "ssd_scan_bwd_da_draw.pt")


def _b6_bwd_saved_draw(dev, dtype=BF16) -> dict:
    """B6-bwd on the saved draw (its bf16 inputs, or read in ``dtype``)
    against the fp32 plain backward and a
    float64 plain backward of the same inputs: per gradient (dx,
    ddt, da, db, dc) the max |difference| of kernel and plain, kernel and
    float64, plain and float64, each over the latter's max |value|; and
    the two heads' da from all three."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    d = torch.load(B6_BWD_DRAW, weights_only=True)
    b, s, h, p, n = d["shape"]
    chunk = d["chunk"]
    xs, bb, cc = d["conv"].to(dev, dtype).split([h * p, n, n], dim=-1)
    x = xs.reshape(b, s, h, p)
    dt, dy, dh = d["dt"].to(dev), d["dy"].to(dev, dtype), d["dh"].to(dev)
    a = -torch.arange(1, h + 1, dtype=torch.float32).to(dev)
    _, _, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk, keep_states=True)
    got = ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, dh, chunk=chunk)
    plain = ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, dh, chunk)
    exact = ref.ssd_scan_bwd_ref(*(t.double() for t in (x, dt, a, bb, cc,
                                                        dy, dh)), chunk)

    def rel(u, w):
        return float((u.double() - w).abs().max()) \
            / max(float(w.abs().max()), 1e-300)
    out = {"kernel_vs_plain": [_rel_err(u, w) for u, w in zip(got, plain)],
           "kernel_vs_fp64": [rel(u, w) for u, w in zip(got, exact)],
           "plain_vs_fp64": [rel(u, w) for u, w in zip(plain, exact)],
           "da": {"kernel": got[2].tolist(), "plain": plain[2].tolist(),
                  "fp64": exact[2].tolist()}}
    log(f"  B6 backward on the saved draw {(b, s, h, p, n, chunk)} "
        f"{str(dtype).replace('torch.', '')}: (dx, ddt, da, db, dc) of "
        f"max|.|: {json.dumps(out)}")
    return out


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
    from repro_torch.core import prng
    import dataclasses
    from repro_torch.models import transformer as tfm
    one = tfm.stack_layers(tfm.init_params(
        prng.PRNGKey(0), dataclasses.replace(cfg, num_layers=1,
                                             vocab_size=1)))
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
           "route": "split_tf32_wgmma", "max_rel_err": e5}
    # q, k, v read and out written once (fp32); QK^T and PV over the
    # pairs the window reaches, in split TF32 (the fp32 CUDA-core bound
    # beside)
    split_tf32_bounds(rec, 4 * (2 * b * s * hq * d + 2 * b * s * hkv * d),
                      4 * d * pairs)
    _fed_lm_time(rec, lambda: flash_attention_cuda(q, k, v, **kw),
                 lambda: ref.flash_attention_fwd_ref(q, k, v, **kw),
                 lambda: sdpa(qt.detach(), kt.detach(), vt.detach(),
                              attn_mask=mask, enable_gqa=True))
    out["fed_lm"] = {"flash_attention": rec}
    lib_out = sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    dout_t = dout.transpose(1, 2).contiguous()
    rec = {"shape": [b, s, hq, hkv, d, window], "dtype": "float32",
           "route": "split_tf32_wgmma", "max_rel_err": e5b}
    # q, k, v, out, dout, lse read and dq, dk, dv written once (fp32); 10 D
    # flops a pair, in split TF32 (the fp32 CUDA-core bound beside)
    split_tf32_bounds(rec, 4 * (3 * b * s * hq * d + 2 * b * s * hkv * d
                                + b * hq * s + b * s * hq * d
                                + 2 * b * s * hkv * d), 10 * d * pairs)
    _fed_lm_time(rec, lambda: flash_attention_bwd_cuda(q, k, v, o, lse, dout,
                                                       **kw),
                 lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                                     **kw),
                 lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,
                                             retain_graph=True))
    out["fed_lm"]["flash_attention_bwd"] = rec
    del q, k, v, dout, o, lse, qt, kt, vt, lib_out, dout_t
    # -- B6 and its backward, fp32, one client's batch: hymba's, and a
    # mamba2-1.3b round's at its full width (N=128) ---------------------
    from repro_torch.configs import get_config
    _, h, _ = mamba2_dims(cfg)
    m2 = get_config("mamba2-1.3b")
    _, h2, _ = mamba2_dims(m2)
    e6s = {}
    for key, (bs, h, cfg_) in (("fed_lm", (FED_LM_BATCH, h, cfg)),
                               ("fed_lm_mamba2", (ZOO_FED_BATCH, h2, m2))):
        p, n, chunk = cfg_.ssm.head_dim, cfg_.ssm.state_dim, \
            cfg_.ssm.chunk_size
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
        e6s[key] = (e6, e6b)
        if not (e6 <= 1e-4 and e6b <= 1e-4):
            raise AssertionError(f"B6 fp32 at {key}'s shape: |kernel - "
                                 f"plain| / max|plain| forward {e6}, "
                                 f"backward {e6b} > 1e-4")
        del y, hl, y_w, hl_w, grads, grads_w
        nc = s // chunk
        tri = chunk * (chunk + 1) // 2
        rec = {"shape": [bs, s, h, p, n, chunk], "dtype": "float32",
               "route": "split_tf32_wgmma", "max_rel_err": e6}
        # x, B, C, dt, a read, y and h_last written once (fp32); the scan's
        # products as B6's record counts them, in split TF32 (the fp32
        # CUDA-core bound beside)
        split_tf32_bounds(
            rec, 4 * (2 * bs * s * h * p + 2 * bs * s * n + bs * s * h + h
                      + bs * h * p * n),
            bs * h * nc * (tri * (2 * n + 2 * p + 2) + chunk * 4 * p * n))
        _fed_lm_time(rec, lambda: ssd_scan_cuda(x, dt, a, bb, cc,
                                                chunk=chunk,
                                                keep_states=True),
                     lambda: ref.ssd_scan_ref(x, dt, a, bb, cc, chunk), None)
        rec["launch_us"] = _device_ops(
            lambda: ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk,
                                  keep_states=True))
        out.setdefault(key, {})["ssd_scan"] = rec
        rec = {"shape": [bs, s, h, p, n, chunk], "dtype": "float32",
               "route": "split_tf32_wgmma", "max_rel_err": e6b}
        # x, dy, dx, B, C, dB, dC, dt, ddt, a, da and the kept states once;
        # the products as B6-bwd's record counts them, in split TF32
        split_tf32_bounds(
            rec, 4 * (3 * bs * s * h * p + 4 * bs * s * n + 2 * bs * s * h
                      + 2 * h + bs * h * nc * p * n),
            bs * h * nc * (tri * (6 * n + 4 * p) + chunk * 8 * p * n))
        _fed_lm_time(rec, lambda: ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st,
                                                    None, chunk=chunk),
                     lambda: ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, None,
                                                  chunk), None)
        rec["launch_us"] = _device_ops(
            lambda: ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, None,
                                      chunk=chunk))
        out[key]["ssd_scan_bwd"] = rec
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
    out["fed_lm"]["fed_weighted_sum"] = rec
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
    out["fed_lm"]["fed_topk_ef"] = rec
    del msgs, err
    torch.cuda.empty_cache()
    for key, recs in out.items():
        where = "the federated LM path's shape" if key == "fed_lm" \
            else "a mamba2-1.3b round's client shape"
        for name, rec in recs.items():
            by_name[name][key] = rec
            lib = "none" if rec["library_ms"] is None \
                else f"{rec['library_ms'] * 1e3:.2f} us"
            core = "" if "bound_cuda_core_ms" not in rec else \
                f", CUDA-core bound {rec['bound_cuda_core_ms'] * 1e3:.2f} us"
            by = "" if "launch_us" not in rec else "; device us/call by " \
                "launch: " + ", ".join(f"{k_} {v_:.2f}" for k_, v_ in
                                      rec["launch_us"].items())
            log(f"{name} at {where} {rec['shape']} {rec['dtype']}: device "
                f"{rec['ms'] * 1e3:.2f} us/call, plain "
                f"{rec['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
                f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}){core}"
                f"{by}")
    log(f"  fed LM kernels against their plain versions: B5 fp32 {e5:.3e}, "
        f"B5-bwd {e5b:.3e} (bound 2e-5); B6, B6-bwd fp32 "
        + ", ".join(f"{k} {f:.3e}, {b_:.3e}" for k, (f, b_) in e6s.items())
        + f" (bound 1e-4), of max|plain|; B2 "
        f"{out['fed_lm']['fed_weighted_sum']['max_abs_err']:.3e}; "
        f"B4 bitwise on segments of "
        f"{out['fed_lm']['fed_topk_ef']['bitwise_segments']}"
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
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("ssd_scan_bwd" if backward else "ssd_scan")
    smem = lib.ssd_scan_bwd_smem_bytes if backward \
        else lib.ssd_scan_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_int64
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
            stack = pairwise_mask_stack(last, fed.engine.layout, 5, "cuda")
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
    from repro_torch.core import prng
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
    init = prodlda.init_params(prng.PRNGKey(1, device="cuda"), cfg)
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
    from repro_torch.core import prng
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
    init = prodlda.init_params(prng.PRNGKey(2, device="cuda"), cfg)
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
    init = ctm.init_combined(prng.PRNGKey(100, device="cuda"), cfg)
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
            node_loss, ctm.init_combined(prng.PRNGKey(l, device="cuda"),
                                         node_cfg),
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
                 ctm.init_zeroshot(prng.PRNGKey(101, device="cuda"), cfg), 3)
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


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place between two fp32 tensors (one device)."""
    return torch.abs(a.view(torch.int32).to(torch.int64)
                     - b.view(torch.int32).to(torch.int64))


def phase_ring_and_resume(records, corpus):
    """(a) ``straggler_ring`` at full ProdLDA-synthetic width on the
    batched cohort path, 20 rounds through ``Federation.step``, each
    round's kernel counts zeroed before it and read after it (B2 at most
    twice a round, once per slab with a positive coefficient; nothing
    else), held every round against the host pending list (the same spec
    on the loop) within 1e-5; (b) a snapshot after round 10 loaded into a
    fresh ``Federation`` continues bitwise, and the service's snapshot
    likewise; (c) the threefry draws card against CPU: secure masks
    bitwise, dp noise, normals and the full ProdLDA init within 4 ulps."""
    import pickle
    import numpy as np
    from repro_torch.api import Federation, max_param_dev, spec_replace
    from repro_torch.core import prng
    from repro_torch.core.ntm import prodlda
    from repro_torch.core.transforms import dp_noise, pairwise_mask_stack
    from repro_torch.serve import FederationService
    t_phase = time.perf_counter()
    spec = _train_spec("straggler_ring", 5000, 50, 100, 5, DOCS_PER_NODE,
                       VAL_DOCS_PER_NODE, RING_ROUNDS)
    sc = spec.schedule
    log(f"straggler ring (batched path): straggler_ring at V=5000 K=50 "
        f"hidden 100-100, L=K=5, p={sc.straggler_prob}, max staleness "
        f"{sc.max_staleness}, decay {sc.staleness_decay}, ring C = "
        f"{5 * sc.max_staleness} x D = {D_MODEL}; cut: {RING_ROUNDS} rounds,"
        f" snapshot after {RING_SNAPSHOT}")
    fed = Federation.from_spec(spec, device="cuda", corpus=corpus)
    host = Federation.from_spec(spec_replace(
        spec, {"execution.exec_mode": "loop"}), device="cuda",
        corpus=corpus)
    totals = {k: 0 for k in read_counts()}
    per_round, walls, devs, snap = [], [], [], None
    for r in range(RING_ROUNDS):
        if r == RING_SNAPSHOT:
            t0 = time.perf_counter()
            snap = pickle.dumps(fed.state_dict())
            t_snap = time.perf_counter() - t0
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        rec = fed.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        host.step()
        devs.append(max_param_dev(fed.params, host.params))
        n_b2 = counts["fed_weighted_sum"]
        if n_b2 > 2 or (n_b2 > 0) != (rec["arrived"] > 0) or any(
                v for k, v in counts.items() if k != "fed_weighted_sum"):
            raise AssertionError(f"ring round {r}: launches {counts} with "
                                 f"{rec['arrived']} arrivals")
        per_round.append(n_b2)
        for k, v in counts.items():
            totals[k] += v
    zero_counts()
    metrics = fed.evaluate()
    torch.cuda.synchronize()
    totals["topic_decoder"] += read_counts()["topic_decoder"]
    ints = ("participants", "arrived", "superseded", "in_flight")
    same = [{k: h[k] for k in ints} for h in fed.history] == \
        [{k: h[k] for k in ints} for h in host.history]
    log("  (arrived, superseded, in_flight) per round: " + ", ".join(
        str((h["arrived"], h["superseded"], h["in_flight"]))
        for h in fed.history))
    log(f"  B2 launches per round {per_round}; rounds 2-{RING_ROUNDS} "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls[1:]) + " ms (median "
        f"{sorted(walls[1:])[len(walls) // 2 - 1] * 1e3:.1f} ms); evaluate "
        f"{json.dumps(metrics)}")
    log(f"  batched ring vs host pending list: max |param diff| per round "
        f"max {max(devs):.3e} (bound 1e-5), records equal {same}")
    if not same or max(devs) > 1e-5 or not any(
            h["in_flight"] for h in fed.history) or max(per_round) < 1:
        raise AssertionError("straggler ring: off the host pending list, "
                             "or nothing in flight")
    for r in records:
        r["launches_by_path"]["straggler_ring"] = totals[r["name"]]

    # (b) resume bitwise on the card
    t0 = time.perf_counter()
    again = Federation.from_spec(spec, device="cuda", corpus=corpus)
    again.load_state_dict(pickle.loads(snap))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    again.run()
    bitwise = all(same_bits(v, again.params[k]) for k, v in
                  fed.params.items()) and again.history == fed.history
    log(f"  snapshot after round {RING_SNAPSHOT}: state_dict + pickle "
        f"{t_snap * 1e3:.1f} ms ({len(snap) / 2**20:.1f} MiB, the ring "
        f"{len(fed.engine._ring['weight'])} x {D_MODEL}); a fresh "
        f"Federation + load {t_load:.2f} s; resumed run bitwise the "
        f"uninterrupted one: {bitwise}")
    if not bitwise:
        raise AssertionError("ring resume on the card is not bitwise")
    sspec = _async_spec(5000, 50, 100, 5, DOCS_PER_NODE, VAL_DOCS_PER_NODE)
    order = [int(c) for c in np.random.default_rng(5).integers(
        0, 5, 2 * SERVICE_UPLOADS)]
    a = FederationService.from_spec(sspec, device="cuda", corpus=corpus)
    for c in order[:SERVICE_UPLOADS]:
        a.upload(c)
    t0 = time.perf_counter()
    ssnap = pickle.dumps(a.state_dict())
    t_ssnap = time.perf_counter() - t0
    for c in order[SERVICE_UPLOADS:]:
        a.upload(c)
    b = FederationService.from_spec(sspec, device="cuda", corpus=corpus)
    b.load_state_dict(pickle.loads(ssnap))
    for c in order[SERVICE_UPLOADS:]:
        b.upload(c)
    sbit = all(same_bits(v, b._live[1][k]) for k, v in a._live[1].items()) \
        and a.history == b.history and a.rejections == b.rejections
    log(f"  service snapshot after {SERVICE_UPLOADS} uploads "
        f"({t_ssnap * 1e3:.1f} ms, {len(ssnap) / 2**20:.1f} MiB), "
        f"{SERVICE_UPLOADS} more on each side: version {a.version}, "
        f"bitwise {sbit}")
    if not sbit:
        raise AssertionError("service resume on the card is not bitwise")

    # (c) threefry draws, card against CPU
    layout = fed.engine.layout
    seed = spec.execution.seed * 100003 + 7
    masks = [pairwise_mask_stack(seed, layout, 5, d) for d in ("cuda",
                                                              "cpu")]
    if not torch.equal(masks[0].cpu(), masks[1]):
        raise AssertionError("secure masks: card != CPU")
    ids, valid = np.arange(5), np.ones(5, bool)
    noise = [dp_noise(seed, ids, valid, layout, d) for d in ("cuda", "cpu")]
    u_dp = _ulps(noise[0].cpu(), noise[1])
    z = [prng.normal(prng.PRNGKey(3, device=d), (10_000_000,))
         for d in ("cuda", "cpu")]
    u_n = _ulps(z[0].cpu(), z[1])
    tz = [prng.truncated_normal(prng.PRNGKey(4, device=d), -2.0, 2.0,
                                (10_000_000,)) for d in ("cuda", "cpu")]
    u_t = _ulps(tz[0].cpu(), tz[1])
    inits = [prodlda.init_params(prng.PRNGKey(0, device=d),
                                 fed.model_cfg) for d in ("cuda", "cpu")]
    u_i = max(int(_ulps(v.cpu(), inits[1][k]).max())
              for k, v in inits[0].items())
    log(f"  threefry card vs CPU: secure masks (5 x {D_MODEL}) bitwise; "
        f"dp noise (5 x {D_MODEL}) max {int(u_dp.max())} ulps "
        f"({float((u_dp == 0).double().mean()):.4f} bitwise); normals "
        f"(1e7) max {int(u_n.max())} ulps "
        f"({float((u_n == 0).double().mean()):.4f} bitwise); truncated "
        f"normals (1e7) max {int(u_t.max())} ulps; ProdLDA init "
        f"(prodlda-synthetic) max {u_i} ulps")
    if max(int(u_dp.max()), int(u_n.max()), int(u_t.max()), u_i) > 4:
        raise AssertionError("threefry normals: card vs CPU beyond 4 ulps")
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")


MESH_SPECS, MESH_ROUNDS, MESH_STEPS = ("mesh-sync", "mesh-straggler",
                                      "mesh-topk", "mesh-pallas"), 5, 3


def _round_device_ms(fed) -> float:
    """Device time of one round: every kernel, copy and fill of one
    ``Federation.step`` from a ``torch.profiler`` trace."""
    # one attempt: a retaken trace would run one more round
    return sum(e.time_range.elapsed_us()
               for e in _trace(fed.step, attempts=1)) / 1e3


def phase_mesh(records, corpus):
    """The batched cohort path over the ``("data",)`` mesh
    (``execution.mesh``): the four ``mesh-*`` scenarios over the training
    phase's full-width base (V=5000, K=50, hidden 100-100, L = K = 5, so
    ``_mesh_overrides`` resolves the data axis to one shard: the sharded
    code path on the one card), 5 rounds each through
    ``Federation.step`` and then ``evaluate``.  Each round's kernel counts
    are zeroed before it and read after it: B2 once per shard a round (at
    most twice in a ``mesh-straggler`` round, once per slab with a
    positive coefficient), B4 once per shard a ``mesh-topk`` round, B3
    never, B1 once per held-out batch.  Each run is held against the same
    spec unsharded on the card (bitwise expected, 1e-5 required) and
    against the same mesh spec on the CPU (1e-5, the training bound);
    median round wall and device time, mesh against unsharded.  Then a
    mesh wider than the visible cards is refused, and
    ``make_federated_train_step`` takes 3 steps on a one-card mesh at the
    same width with dp and with secure, held against the CPU."""
    from repro_torch.api import (Federation, max_param_dev, spec_replace)
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import prng
    from repro_torch.core.ntm import prodlda
    from repro_torch.core.protocol import make_federated_train_step
    from repro_torch.optim import sgd
    from repro_torch.parallel import fed_mesh
    t_phase = time.perf_counter()
    n_eval = math.ceil(5 * VAL_DOCS_PER_NODE / 256)
    log(f"mesh (execution.mesh): {', '.join(MESH_SPECS)} at V=5000 K=50 "
        f"hidden 100-100, L=K=5 (data=1: one shard on the one card), "
        f"batch 64; cut: {MESH_ROUNDS} rounds")
    totals = {}
    for name in MESH_SPECS:
        spec = _train_spec(name, 5000, 50, 100, 5, DOCS_PER_NODE,
                           VAL_DOCS_PER_NODE, MESH_ROUNDS)
        data = spec.execution.mesh.data
        runs = {"mesh": Federation.from_spec(spec, device="cuda",
                                             corpus=corpus),
                "plain": Federation.from_spec(spec_replace(
                    spec, {"execution.mesh": None}), device="cuda",
                    corpus=corpus)}
        if runs["mesh"].mesh_shape != {"data": data} \
                or runs["plain"].mesh_shape is not None:
            raise AssertionError(f"{name}: mesh shapes {runs['mesh'].mesh_shape}"
                                 f", {runs['plain'].mesh_shape}")
        walls = {k: [] for k in runs}
        dev_ms = {}
        counts_total = {k: 0 for k in read_counts()}
        per_round = []
        for r in range(MESH_ROUNDS):
            for key, fed in runs.items():
                if r == MESH_ROUNDS - 1:
                    # the last round traced: its device time
                    zero_counts()
                    dev_ms[key] = _round_device_ms(fed)
                    rec, counts = fed.history[-1], read_counts()
                else:
                    torch.cuda.synchronize()
                    zero_counts()
                    t0 = time.perf_counter()
                    rec = fed.step()
                    torch.cuda.synchronize()
                    walls[key].append(time.perf_counter() - t0)
                    counts = read_counts()
                if key != "mesh":
                    continue
                per_round.append((counts["fed_weighted_sum"],
                                  counts["fed_topk_ef"]))
                n_b2 = counts["fed_weighted_sum"]
                want_b4 = data if name == "mesh-topk" else 0
                if name == "mesh-straggler":
                    ok_b2 = n_b2 <= 2 * data \
                        and (n_b2 > 0) == (rec["arrived"] > 0)
                else:
                    ok_b2 = n_b2 == data
                others = {k: v for k, v in counts.items()
                          if k not in ("fed_weighted_sum", "fed_topk_ef")}
                if not ok_b2 or counts["fed_topk_ef"] != want_b4 \
                        or any(others.values()):
                    raise AssertionError(f"{name} round {r}: launches "
                                         f"{counts} on a {data}-shard mesh")
                for k, v in counts.items():
                    counts_total[k] += v
        zero_counts()
        metrics = runs["mesh"].evaluate()
        torch.cuda.synchronize()
        n_b1 = read_counts()["topic_decoder"]
        if n_b1 != n_eval or not math.isfinite(
                metrics["heldout_elbo_per_token"]):
            raise AssertionError(f"{name}: evaluate launched B1 {n_b1} "
                                 f"times, held-out ELBO {metrics}")
        counts_total["topic_decoder"] += n_b1
        totals[name] = counts_total
        for rr in records:
            rr["launches_by_path"][name] = counts_total[rr["name"]]
        mesh, plain = runs["mesh"], runs["plain"]
        bitwise = all(same_bits(v, plain.params[k])
                      for k, v in mesh.params.items()) \
            and mesh.history == plain.history
        dev_plain = max_param_dev(mesh.params, plain.params)
        cpu = Federation.from_spec(spec, device="cpu", corpus=corpus)
        cpu.run()
        dev_cpu = max_param_dev(mesh.params, cpu.params)
        ints = ("participants", "arrived", "superseded", "in_flight")
        same = [{k: h[k] for k in ints} for h in mesh.history] == \
            [{k: h[k] for k in ints} for h in cpu.history]
        med = {k: sorted(v[1:])[len(v[1:]) // 2] * 1e3
               for k, v in walls.items()}
        log(f"  {name} (data={data}): mesh vs unsharded on the card "
            f"bitwise {bitwise} (max |param diff| {dev_plain:.3e}); card vs "
            f"CPU {dev_cpu:.3e} (bound 1e-5), records equal {same}; "
            f"(B2, B4) launches per round {per_round}; median round wall "
            f"mesh {med['mesh']:.2f} ms / unsharded {med['plain']:.2f} ms "
            f"(rounds 2-{MESH_ROUNDS - 1}); device time of the traced last "
            f"round mesh {dev_ms['mesh']:.3f} ms / unsharded "
            f"{dev_ms['plain']:.3f} ms; evaluate {json.dumps(metrics)}")
        if not dev_plain <= 1e-5 or not dev_cpu <= 1e-5 or not same:
            raise AssertionError(f"{name}: mesh run off the unsharded run "
                                 f"({dev_plain}) or the CPU ({dev_cpu}), "
                                 f"records equal {same}")
    log(f"  launches on the mesh paths: {json.dumps(totals)}")

    # a mesh wider than the visible cards is refused
    n = torch.cuda.device_count()
    wide = _train_spec("sync", 64, 4, 16, 2 * (n + 1), 40, 8, 1)
    wide = spec_replace(wide, {"execution.mesh": {"data": n + 1}})
    want = f"needs {n + 1} devices but only {n} are visible"
    try:
        Federation.from_spec(wide, device="cuda")
    except ValueError as e:
        if want not in str(e):
            raise
        log(f"  L=K={2 * (n + 1)} at data={n + 1} on {n} card(s) refused: "
            f"{e}")
    else:
        raise AssertionError(f"a {n + 1}-shard mesh on {n} card(s) was not "
                             "refused")

    # the mesh protocol step, one card against the CPU, at the same width
    cfg = runs["mesh"].model_cfg
    bow = torch.from_numpy(corpus.node_bows[0][:64])
    for label, fed in (("dp", {"dp_noise_multiplier": 0.3,
                               "dp_clip_norm": 1.0}),
                       ("secure", {"secure_aggregation": True})):
        out = {}
        for dev in ("cuda", "cpu"):
            params = prodlda.init_params(prng.PRNGKey(0, device=dev), cfg)
            step = make_federated_train_step(
                lambda p, b: prodlda.elbo_loss_sum(p, cfg, b, train=False),
                sgd(2e-3), fed_mesh(1, dev), fed=FederatedConfig(**fed))
            state, losses = {}, []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(MESH_STEPS):
                params, state, loss = step(params, state,
                                           {"bow": bow.to(dev)}, i,
                                           prng.PRNGKey(1))
                losses.append(float(loss))
            torch.cuda.synchronize()
            out[dev] = (params, losses, time.perf_counter() - t0)
        dev_p = max_param_dev(out["cuda"][0], out["cpu"][0])
        dev_l = max(abs(a - b) / abs(b) for a, b in
                    zip(out["cuda"][1], out["cpu"][1]))
        log(f"  make_federated_train_step ({label}, data=1, 1 x 64 docs at "
            f"full width, {MESH_STEPS} steps): card {out['cuda'][2]:.3f} s; "
            f"card vs CPU params {dev_p:.3e} (bound 1e-5), losses rel "
            f"{dev_l:.3e}; losses "
            + ", ".join(f"{x:.3f}" for x in out["cuda"][1]))
        if not dev_p <= 1e-5 or not dev_l <= 1e-5 \
                or not all(math.isfinite(x) for x in out["cuda"][1]):
            raise AssertionError(f"mesh protocol step ({label}): card vs CPU "
                                 f"{dev_p}, losses {dev_l}")
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")


def _net_spec(docs=DOCS_PER_NODE, val_docs=VAL_DOCS_PER_NODE, **overrides):
    """``buffered_async_net`` at prodlda-synthetic width (V=5000, K=50,
    encoder 100-100, L=5), with ``overrides``."""
    from repro_torch.api import (DataSpec, FederationSpec, ModelSpec,
                                 scenario_spec, spec_replace)
    base = FederationSpec(
        model=ModelSpec(vocab=5000, topics=50, hidden=100),
        data=DataSpec(num_clients=5, docs_per_node=docs,
                      val_docs_per_node=val_docs))
    spec = scenario_spec("buffered_async_net", base)
    return spec_replace(spec, overrides) if overrides else spec


def _pcts(xs) -> str:
    import numpy as np
    a = np.asarray(xs) * 1e3
    return (f"p50 {np.percentile(a, 50):.2f} / p95 "
            f"{np.percentile(a, 95):.2f} / p99 {np.percentile(a, 99):.2f} ms")


def _payload_bytes(frame: bytes) -> int:
    """The array bytes of a wire frame: all but its prefix and header."""
    return len(frame) - 9 - int.from_bytes(frame[5:9], "big")


def phase_wire(records, corpus):
    """The wire (``repro_torch.net``) at prodlda-synthetic width, every
    service and client replica on the card, each step fatal:
    (a) the anchor over TCP: a ``BackgroundServer`` over the service, a
    ``ServiceClient``, M=K=5, staleness 0, 3 in-order sweeps, equal to the
    sync twin's ``Federation.run()`` on the card within 1e-5, B2 once per
    aggregation (counts zeroed just before, read just after); upload and
    ``GET /v1/model`` round trips of the 3.10 MB fp32 frame;
    (b) ``run_traffic`` with holds and duplicates (``max_staleness=0``:
    real ``stale`` and ``superseded`` rejections) in process and over the
    wire: the ledgers equal reason for reason, params within 1e-5;
    (c) ``wire_precision="bf16"``: half the payload, and the delta the
    server buffers bitwise the bf16 round trip of the client's;
    (d) topk and dp uploads over the wire: B4 or B3 once per computed
    upload, B2 once per aggregation, params equal to the in-process
    service's within 1e-5;
    (e) a malformed frame and a frame of a foreign version: 400 and a
    ledger entry for client -1 each;
    (f) ``federate_load.run_load``: a server process and 4 client
    processes on the card, 2 sweeps: every upload answered, every
    rejection reason a known one; round-trip percentiles and rates;
    (g) one ``/v1/generate`` from an LM service (reduced hymba-1.5b):
    B5 and B6 once per layer of the prefill."""
    import numpy as np
    from repro_torch.api import (Federation, max_param_dev, scenario_spec,
                                 spec_replace)
    from repro_torch.launch import federate_load
    from repro_torch.net import BackgroundServer, HttpClient, ServiceClient
    from repro_torch.serve import (REJECT_REASONS, FederationService,
                                   run_traffic, sync_twin_spec)
    t_phase = time.perf_counter()

    # (a) the anchor over TCP
    spec = _net_spec(**{"schedule.buffer_size": 0,
                        "schedule.max_staleness": 0,
                        "schedule.rounds": WIRE_SWEEPS})
    twin = Federation.from_spec(sync_twin_spec(spec), device="cuda",
                                corpus=corpus)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin.run()
    torch.cuda.synchronize()
    t_twin = time.perf_counter() - t0
    svc = FederationService.from_spec(spec, device="cuda", corpus=corpus)
    rtts, fetches = [], []
    with BackgroundServer(svc) as bg:
        cl = ServiceClient(spec, bg.host, bg.port, corpus=corpus,
                           device="cuda")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(WIRE_SWEEPS):
            for c in range(5):
                bv, delta, w = cl.client_update(c)
                t1 = time.perf_counter()
                if not cl.submit(c, delta, w, base_version=bv)["accepted"]:
                    raise AssertionError(f"wire anchor: upload of client "
                                         f"{c} refused")
                rtts.append(time.perf_counter() - t1)
        version, params = cl.fetch_model()
        torch.cuda.synchronize()
        t_wire = time.perf_counter() - t0
        counts = read_counts()
        for _ in range(10):
            t1 = time.perf_counter()
            cl.fetch_model()
            fetches.append(time.perf_counter() - t1)
        frame = cl.encode_upload(0, delta, w, base_version=bv)
        cl.close()
    dev = max_param_dev(twin.params, params)
    log(f"wire (a) anchor over TCP: M=K=5, staleness 0, {WIRE_SWEEPS} "
        f"in-order sweeps at V=5000 K=50 hidden 100-100, "
        f"{DOCS_PER_NODE} docs a node; upload frame {len(frame)} bytes "
        f"({_payload_bytes(frame)} of fp32 payload, D = {D_MODEL}); the "
        f"sync twin's run {t_twin:.3f} s in process, the wire's "
        f"{t_wire:.3f} s ({len(rtts)} fetches, local updates and "
        f"uploads); upload round trip {_pcts(rtts)}; GET /v1/model "
        f"{_pcts(fetches)}; version {version}; max |wire - twin| "
        f"{dev:.3e} (bound 1e-5)")
    _expect_counts("wire_anchor", counts, {"fed_weighted_sum": WIRE_SWEEPS},
                   records)
    if version != WIRE_SWEEPS or not dev <= 1e-5 \
            or _payload_bytes(frame) != 4 * D_MODEL:
        raise AssertionError("wire anchor: off the sync twin")
    del twin, svc

    # (b) run_traffic in process and over the wire
    tspec = _net_spec(**{"schedule.max_staleness": 0})
    knobs = dict(sweeps=WIRE_SWEEPS, order_seed=7, hold_prob=0.5,
                 duplicate_prob=0.5, infer_every=3, infer_batch=8)
    local = FederationService.from_spec(tspec, device="cuda", corpus=corpus)
    lstats = run_traffic(local, **knobs)
    svc = FederationService.from_spec(tspec, device="cuda", corpus=corpus)
    with BackgroundServer(svc) as bg:
        cl = ServiceClient(tspec, bg.host, bg.port, corpus=corpus,
                           device="cuda")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        wstats = run_traffic(cl, **knobs)
        torch.cuda.synchronize()
        t_traffic = time.perf_counter() - t0
        counts = read_counts()
        _, wparams = cl.fetch_model()
        bow = np.random.default_rng(3).poisson(
            1.0, (8, tspec.model.vocab)).astype(np.float32)
        infers = []
        for _ in range(8):
            t1 = time.perf_counter()
            cl.infer(bow).cpu()
            infers.append(time.perf_counter() - t1)
        cl.close()
    dev = max_param_dev(local.fetch_model()[1], wparams)
    keys = ("steps", "uploads", "accepted", "held", "duplicates",
            "aggregations", "version", "infer_calls")
    log(f"wire (b) run_traffic ({knobs}): in process "
        f"{json.dumps({k: lstats[k] for k in keys})} rejections "
        f"{lstats['rejections']}, infer p50 "
        f"{lstats['infer_latency_p50_s'] * 1e3:.2f} ms; over the wire "
        f"{t_traffic:.2f} s, rejections {wstats['rejections']}, infer "
        f"round trip p50 {wstats['infer_latency_p50_s'] * 1e3:.2f} ms "
        f"(8 x {tspec.model.vocab} counts as JSON); ledgers equal "
        f"{svc.rejections == local.rejections}; max |wire - in process| "
        f"{dev:.3e} (bound 1e-5)")
    log(f"  8 more infer round trips over the wire, in order: "
        + ", ".join(f"{x * 1e3:.2f}" for x in infers) + " ms")
    _expect_counts("wire_traffic", counts,
                   {"fed_weighted_sum": wstats["aggregations"]}, records)
    if not ({"stale", "superseded"} <= set(lstats["rejections"])
            and svc.rejections == local.rejections
            and wstats["rejections"] == lstats["rejections"]
            and all(wstats[k] == lstats[k] for k in keys)
            and dev <= 1e-5):
        raise AssertionError("wire run_traffic: off the in-process run")
    del local, svc

    # (c) bf16 deltas on the wire
    bspec = _net_spec(**{"serving.wire_precision": "bf16"})
    svc = FederationService.from_spec(bspec, device="cuda", corpus=corpus)
    brtts = []
    with BackgroundServer(svc) as bg:
        cl = ServiceClient(bspec, bg.host, bg.port, corpus=corpus,
                           device="cuda")
        bv, delta, w = cl.client_update(0)
        cl.submit(0, delta, w, base_version=bv)
        slot = svc.buffer.slot_of(0)
        exact = all(same_bits(view[slot], delta[name].to(torch.bfloat16)
                              .to(torch.float32))
                    for name, view in svc.buffer.leaves.items())
        half = cl.encode_upload(0, delta, w, base_version=bv)
        for c in range(1, 5):
            bv, delta, w = cl.client_update(c)
            t1 = time.perf_counter()
            cl.submit(c, delta, w, base_version=bv)
            brtts.append(time.perf_counter() - t1)
        cl.close()
    log(f"wire (c) bf16: payload {_payload_bytes(half)} bytes against "
        f"{_payload_bytes(frame)} fp32; the buffered delta the bf16 round "
        f"trip of the client's, bitwise: {exact}; upload round trip "
        f"{', '.join(f'{x * 1e3:.2f}' for x in brtts)} ms")
    if not exact or 2 * _payload_bytes(half) != _payload_bytes(frame):
        raise AssertionError("wire bf16: not half the payload, or not the "
                             "bf16 round trip")
    del svc

    # (d) transformed uploads over the wire
    for name, kname, extra in (
            ("topk", "fed_topk_ef", {"transforms.compression_topk": 0.25}),
            ("dp", "fed_dp_secure_apply",
             {"transforms.dp_noise_multiplier": 0.3,
              "transforms.dp_clip_norm": 0.05})):
        xspec = _net_spec(**{"transforms.names": (name,), **extra})
        local = FederationService.from_spec(xspec, device="cuda",
                                            corpus=corpus)
        svc = FederationService.from_spec(xspec, device="cuda",
                                          corpus=corpus)
        with BackgroundServer(svc) as bg:
            cl = ServiceClient(xspec, bg.host, bg.port, corpus=corpus,
                               device="cuda")
            torch.cuda.synchronize()
            zero_counts()
            for _ in range(2):
                for c in range(5):
                    if not cl.upload(c)["accepted"]:
                        raise AssertionError(f"wire {name}: upload refused")
            torch.cuda.synchronize()
            counts = read_counts()
            cl.close()
        for _ in range(2):
            for c in range(5):
                local.upload(c)
        dev = max_param_dev(local.fetch_model()[1], svc.fetch_model()[1])
        log(f"wire (d) {name} uploads: 10 over the wire, "
            f"{svc.agg_index} aggregations; max |wire - in process| "
            f"{dev:.3e} (bound 1e-5)")
        _expect_counts(f"wire_{name}", counts,
                       {kname: 10, "fed_weighted_sum": svc.agg_index},
                       records)
        if not dev <= 1e-5:
            raise AssertionError(f"wire {name}: off the in-process service")
        del local, svc

    # (e) refusals
    svc = FederationService.from_spec(_net_spec(), device="cuda",
                                      corpus=corpus)
    with BackgroundServer(svc) as bg:
        http = HttpClient(bg.host, bg.port)
        binary = "application/x-repro-wire"
        answers = [http.request("POST", "/v1/upload", b"not a frame",
                                content_type=binary)]
        answers.append(http.request("POST", "/v1/upload",
                                    frame[:4] + bytes([99]) + frame[5:],
                                    content_type=binary))
        http.close()
    got = [(status, json.loads(body)["reason"], json.loads(body)["client"])
           for status, body in answers]
    log(f"wire (e) refusals: {got}; ledger {svc.rejections}")
    if got != [(400, "malformed", -1), (400, "wire_version", -1)] \
            or [(r["client"], r["reason"]) for r in svc.rejections] != \
            [(-1, "malformed"), (-1, "wire_version")]:
        raise AssertionError("wire refusals: not answered 400 and recorded")
    del svc

    # (f) the load run: separate processes, one card
    lspec = _net_spec(LOAD_DOCS, LOAD_VAL_DOCS)
    cell = federate_load.run_load(lspec, procs=LOAD_PROCS,
                                  sweeps=LOAD_SWEEPS, infer_every=2,
                                  infer_batch=8, device="cuda")
    answered = cell["accepted"] + sum(cell["receipt_reasons"].values())
    log(f"wire (f) load: a server process and {LOAD_PROCS} client "
        f"processes on the card ({smi_line()}), {LOAD_SWEEPS} sweeps over "
        f"L=5 clients; cut: {LOAD_DOCS} train + {LOAD_VAL_DOCS} val docs "
        f"a node in the spawned processes; {cell['uploads']} uploads "
        f"({cell['accepted']} accepted), {cell['aggregations']} "
        f"aggregations, rejections {cell['rejections']}; wall "
        f"{cell['wall_s']:.2f} s (process start-up included): "
        f"{cell['uploads_per_s']:.3f} uploads/s, {cell['aggs_per_s']:.3f} "
        f"aggregations/s; upload round trip p50 "
        f"{cell['upload_p50_s'] * 1e3:.2f} / p95 "
        f"{cell['upload_p95_s'] * 1e3:.2f} / p99 "
        f"{cell['upload_p99_s'] * 1e3:.2f} ms; infer round trip p50 "
        f"{cell['infer_p50_s'] * 1e3:.2f} / p95 "
        f"{cell['infer_p95_s'] * 1e3:.2f} / p99 "
        f"{cell['infer_p99_s'] * 1e3:.2f} ms ({cell['infer_calls']} calls)")
    if cell["uploads"] != 5 * LOAD_SWEEPS or answered != cell["uploads"] \
            or not set(cell["rejections"]) <= set(REJECT_REASONS) \
            or cell["aggregations"] < 1:
        raise AssertionError(f"wire load run: {cell}")

    # (g) an LM service generates over the wire
    lm = spec_replace(scenario_spec("lm_fedavg"), {
        "model.arch": "hymba-1.5b", "model.vocab": 128, "model.seq_len": 16,
        "data.num_clients": 3, "data.docs_per_node": 24,
        "data.val_docs_per_node": 8, "schedule.mode": "buffered_async",
        "schedule.max_staleness": 0, "execution.exec_mode": "loop",
        "serving.port": 0})
    svc = FederationService.from_spec(lm, device="cuda")
    cfg = svc._fed.model_cfg
    prompts = np.random.default_rng(0).integers(0, 128, (2, 8)) \
        .astype(np.int32)
    with BackgroundServer(svc) as bg:
        cl = ServiceClient(lm, bg.host, bg.port, corpus=svc._fed.corpus,
                           device="cuda")
        for c in range(3):
            if not cl.upload(c)["accepted"]:
                raise AssertionError("wire LM: upload refused")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        tokens = cl.generate(prompts, max_new=8)
        t_gen = time.perf_counter() - t0
        counts = read_counts()
        cl.close()
    same = bool(np.array_equal(tokens, svc.generate(prompts, max_new=8)))
    log(f"wire (g) LM generate (reduced hymba-1.5b, {cfg.num_layers} "
        f"layers, version {svc.version} after 3 wire uploads): 2 x 8 "
        f"prompt tokens, 8 new, {t_gen * 1e3:.1f} ms over the wire (the "
        f"first generate builds the bundle); tokens equal in process: "
        f"{same}")
    _expect_counts("wire_generate", counts,
                   {"flash_attention": cfg.num_layers,
                    "ssd_scan": cfg.num_layers}, records)
    if not same or svc.version != 1:
        raise AssertionError("wire LM generate: tokens differ in process")
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")


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


def phase_lm_serve(records):
    """hymba-1.5b at full width through ``repro_torch.launch.serve``:
    batch 4 x 2048-token prompts (past the window of 1024, so the ring
    buffer's roll and the window mask both run; 8 SSD chunks), 32 greedy
    tokens, after one warm-up call of the same entry point; B5 and B6 must
    launch once per layer of the one prefill and nothing else may launch.
    Then one traced prefill of the same prompts for the device's busy
    share, with finite logits, 8 timed decode steps and one traced."""
    from repro_torch.core import prng
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
        f"masters, the reference's init from seed 0; batch {LM_BATCH} x "
        f"prompt {LM_PROMPT}, {LM_NEW} new tokens; cut: none (serving has no "
        f"depth to cut)")
    t0 = time.perf_counter()
    params = tfm.init_params(prng.PRNGKey(0, device="cuda"), cfg)
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
    log(f"  init (threefry draws of {cfg.num_params()} weights on the card, "
        f"the reference's key tree, leaf by leaf) {t_init:.2f} s; cold "
        f"warm-up serve (2 new tokens) {t_warm:.2f} s")
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
    from repro_torch.core import prng
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
    init = bundle.init(prng.PRNGKey(0, device="cuda"))
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


# the dense zoo on one card: served whole where the fp32 masters, their
# bf16 copy, the cache and the fp32 logits fit in 80 GB, cut in depth
# (full width) where they do not
ZOO_WHOLE = ("minicpm3-4b", "qwen2-vl-7b")
ZOO_DEPTH = {"granite-34b": 8, "qwen1.5-110b": 2}
# teacher-forced steps of the absorbed-vs-expanded MLA decode check, and
# its bound on |logits difference| / max |logits| in bf16
MLA_TF_STEPS, MLA_TF_BOUND = 8, 5e-2


def _zoo_serve(records, arch, cfg, cut: str, path: str = "lm_zoo",
               dtype=None):
    """``repro_torch.launch.serve`` at full width (bf16 activations over
    the reference's init from seed 0, drawn on the card: fp32 masters, or
    with ``dtype`` the weights the layers read through a cast drawn
    straight into it), after a warm-up call: prefill time, decode
    tokens/s, peak memory, and for a MoE config the share of the
    prefill's routed (token, slot) pairs that capacity dropped; B5 once
    per layer of the prefill and nothing else, counted under ``path``.
    Returns the weights and the serve's output."""
    import argparse
    from repro_torch.core import prng
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import moe
    label = "LM MoE" if cfg.kind == "moe" else "LM zoo"
    log(f"{label}: {arch} ({cfg.kind}, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}"
        + (f", MLA kv rank {cfg.mla_kv_lora_rank}, q rank "
           f"{cfg.mla_q_lora_rank}, rope {cfg.mla_rope_head_dim}"
           if cfg.use_mla else "")
        + (f", M-RoPE {cfg.mrope_sections}" if cfg.use_mrope else "")
        + (", q/k/v biases" if cfg.qkv_bias else "")
        + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} (capacity "
           f"factor {cfg.moe.capacity_factor}), {cfg.moe.num_shared_experts}"
           f" shared, MoE every {cfg.moe.moe_every} layers"
           if cfg.kind == "moe" else "")
        + f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_params()} "
        f"parameters), batch {LM_BATCH} x prompt {LM_PROMPT}, {LM_NEW} new "
        f"tokens; cut: {cut}")
    t0 = time.perf_counter()
    params = tfm.init_params(prng.PRNGKey(0, device="cuda"), cfg,
                             dtype=dtype)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    args = argparse.Namespace(arch=arch, reduced=False, batch=LM_BATCH,
                              prompt_len=LM_PROMPT, max_new=LM_NEW, seed=0,
                              device="cuda")
    t0 = time.perf_counter()
    lm_serve.serve(argparse.Namespace(**{**vars(args), "max_new": 2}),
                   params=params, cfg=cfg)
    t_warm = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with moe.record_routes() as routes:
        out = lm_serve.serve(args, params=params, cfg=cfg)
        torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    gen = out["generated"]
    # the prefill's MoE calls: one a MoE layer, over all the prompt tokens
    kept = [float(r["kept"].float().mean()) for r in routes
            if r["kept"].shape[1] == LM_PROMPT]
    dropped = "" if not kept else (
        f"; capacity dropped {1 - sum(kept) / len(kept):.4%} of the "
        f"prefill's routed (token, slot) pairs ({len(kept)} MoE layers; by "
        f"layer " + ", ".join(f"{1 - k:.2%}" for k in kept) + ")")
    log(f"  init {t_init:.2f} s; warm-up serve (2 new tokens) {t_warm:.2f} "
        f"s; serve (warm): prefill {out['prefill_s']:.4f} s; decode "
        f"{LM_NEW - 1} steps in {out['decode_s']:.4f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(counts)}{dropped}")
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.num_layers
    if counts != want:
        raise AssertionError(f"{label} {arch}: kernel launches {counts} != "
                             f"one B5 per layer of the prefill {want}")
    if gen.shape != (LM_BATCH, LM_NEW) or gen.min() < 0 \
            or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"{label} {arch}: generated {gen.shape} "
                             f"tokens in [{gen.min()}, {gen.max()}]")
    if cfg.kind == "moe" and len(kept) != cfg.num_layers \
            // cfg.moe.moe_every:
        raise AssertionError(f"{label} {arch}: {len(kept)} MoE calls in "
                             f"the prefill")
    for r in records:
        r["launches_by_path"][path] = \
            r["launches_by_path"].get(path, 0) + counts[r["name"]]
    return params, out


def _mla_absorbed_check(params, cfg, gen):
    """minicpm3-4b with ``mla_absorb``: the serve's greedy tokens beside
    the expanded decode's, and the logits of MLA_TF_STEPS teacher-forced
    decode steps (the expanded run's tokens fed to both) within
    MLA_TF_BOUND of the logits' scale."""
    import dataclasses
    import argparse
    import numpy as np
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import transformer as tfm
    absorbed = dataclasses.replace(cfg, mla_absorb=True)
    args = argparse.Namespace(arch=cfg.name, reduced=False, batch=LM_BATCH,
                              prompt_len=LM_PROMPT, max_new=LM_NEW, seed=0,
                              device="cuda")
    zero_counts()
    out = lm_serve.serve(args, params=params, cfg=absorbed)
    if read_counts()["flash_attention"] != cfg.num_layers:
        raise AssertionError("LM zoo absorbed MLA: B5 launches != layers")
    same = int((out["generated"] == gen).sum())
    act = tfm.activation_copy(params, cfg, torch.bfloat16)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to("cuda")
    feed = torch.from_numpy(gen).to("cuda", torch.int64)
    devs = []
    with torch.no_grad():
        caches = [tfm.prefill(act, c, {"tokens": prompts},
                              max_len=LM_PROMPT + MLA_TF_STEPS)[1]
                  for c in (cfg, absorbed)]
        for i in range(MLA_TF_STEPS):
            le, caches[0] = tfm.decode_step(act, cfg, caches[0],
                                            feed[:, i:i + 1])
            la, caches[1] = tfm.decode_step(act, absorbed, caches[1],
                                            feed[:, i:i + 1])
            devs.append(float((la - le).abs().max())
                        / float(le.abs().max()))
    log(f"  mla_absorb=True: prefill {out['prefill_s']:.4f} s, decode "
        f"{out['tokens_per_s']:.1f} tokens/s; greedy tokens equal to the "
        f"expanded decode's: {same}/{gen.size}; teacher-forced logits "
        f"max |absorbed - expanded| / max |expanded| over {MLA_TF_STEPS} "
        f"steps: " + ", ".join(f"{d:.2e}" for d in devs)
        + f" (bound {MLA_TF_BOUND})")
    if same != gen.size and not max(devs) <= MLA_TF_BOUND:
        raise AssertionError("absorbed MLA decode: tokens differ and the "
                             "logits break their bound")
    del act, caches


def _zoo_vlm_prefill(params, cfg):
    """qwen2-vl-7b's prefill with a ``synthetic_lm_batch`` VLM batch (one
    patch per 16 tokens, merged at its positions, and the M-RoPE
    streams): B5 once per layer, finite logits, its time."""
    from repro_torch.data.lm_data import synthetic_lm_batch
    from repro_torch.models import transformer as tfm
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             synthetic_lm_batch(cfg, LM_BATCH, LM_PROMPT, seed=0).items()}
    act = tfm.activation_copy(params, cfg, torch.bfloat16)
    walls = []
    with torch.no_grad():
        for _ in range(2):      # the first call warms up
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = tfm.prefill(act, cfg, batch,
                                    max_len=LM_PROMPT + LM_NEW)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    counts = read_counts()
    ok = bool(torch.isfinite(logits).all())
    log(f"  VLM batch prefill ({batch['patch_embeds'].shape[1]} patches a "
        f"row merged, M-RoPE streams): {walls[1]:.4f} s warm; logits "
        f"{tuple(logits.shape)} finite {ok}; launches "
        f"{json.dumps(counts)}")
    if not ok or counts["flash_attention"] != cfg.num_layers \
            or sum(counts.values()) != cfg.num_layers:
        raise AssertionError(f"LM zoo VLM prefill: finite {ok}, launches "
                             f"{counts}")
    del act, logits


def _zoo_encoder(records, cfg):
    """hubert-xlarge's encoder forward at full width (bf16 activations)
    over LM_BATCH x LM_PROMPT stub frames with 8% masked: finite logits,
    B5 once per layer (bidirectional), its time and peak memory."""
    from repro_torch.core import prng
    from repro_torch.data.lm_data import synthetic_lm_batch
    from repro_torch.models import transformer as tfm
    log(f"LM zoo: hubert-xlarge ({cfg.kind}, encoder-only, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff} GELU, "
        f"LayerNorm, vocab {cfg.vocab_size}, {cfg.num_params()} "
        f"parameters), forward over {LM_BATCH} x {LM_PROMPT} frames; cut: "
        f"none")
    t0 = time.perf_counter()
    params = tfm.init_params(prng.PRNGKey(0, device="cuda"), cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    act = tfm.activation_copy(params, cfg, torch.bfloat16)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             synthetic_lm_batch(cfg, LM_BATCH, LM_PROMPT, seed=0).items()}
    walls = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = tfm.forward_train(act, cfg, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    ok = bool(torch.isfinite(logits).all())
    log(f"  init {t_init:.2f} s; forward {walls[0]:.4f} s cold, "
        f"{walls[1]:.4f} s warm; logits {tuple(logits.shape)} finite {ok}; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches "
        f"{json.dumps(counts)}")
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.num_layers
    if not ok or counts != want \
            or logits.shape != (LM_BATCH, LM_PROMPT, cfg.vocab_size):
        raise AssertionError(f"LM zoo hubert: finite {ok}, launches "
                             f"{counts}, logits {tuple(logits.shape)}")
    for r in records:
        r["launches_by_path"]["lm_zoo"] = \
            r["launches_by_path"].get("lm_zoo", 0) + counts[r["name"]]
    del params, act, logits


def _zoo_agreement():
    """Each of the five reduced configs in fp32 from the same weights on
    the card (B5) and on the CPU (its plain version), through
    ``repro_torch.models.agreement.card_vs_cpu``: prefill over 96 tokens
    and 4 teacher-forced decode steps (hubert: the forward over 96
    frames), logits within 2e-4; B5 launches once per layer of the
    prefill or forward on the card, never in decode, and never on the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.agreement import card_vs_cpu
    report = {}
    for arch in ("granite-34b", "qwen1.5-110b", "qwen2-vl-7b",
                 "minicpm3-4b", "hubert-xlarge"):
        cfg = get_config(arch).reduced()
        got = card_vs_cpu(cfg, "cuda")
        devs, n = got["devs"], got["launches"]
        report[arch] = max(devs)
        if n["cpu"] != (0, 0) or n["dev"] != (cfg.num_layers, 0):
            raise AssertionError(f"LM zoo agreement {arch}: B5 launches "
                                 f"(prefill, decode) CPU {n['cpu']}, card "
                                 f"{n['dev']}; want none and "
                                 f"({cfg.num_layers}, 0)")
        if not max(devs) <= 2e-4:
            raise AssertionError(f"LM zoo agreement {arch}: card vs CPU "
                                 f"{devs} beyond 2e-4")
    log("agreement LM zoo (reduced, fp32, 2 x 96 + 4 decode steps; hubert "
        "the forward over 96 frames): card vs CPU logits, max |diff| / "
        "max(|cpu|, 1): " + ", ".join(f"{a} {d:.3e}"
                                      for a, d in report.items())
        + " (bound 2e-4); B5 once per layer of each prefill, 0 in decode")


def phase_lm_zoo(records):
    """The dense half of the LM zoo on the card: minicpm3-4b (MLA, then
    again with the absorbed decode) and qwen2-vl-7b (M-RoPE, q/k/v
    biases, then a VLM-batch prefill) served whole through
    ``repro_torch.launch.serve``; hubert-xlarge's whole encoder forward;
    granite-34b (MQA) and qwen1.5-110b (q/k/v biases) served at full
    width, cut in depth for one card's 80 GB; then the five reduced
    configs card against CPU.  Every run zeroes the launch counts just
    before and reads them just after."""
    import dataclasses
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    for arch in ZOO_WHOLE:
        cfg = get_config(arch)
        params, out = _zoo_serve(records, arch, cfg, "none (served whole)")
        if cfg.use_mla:
            _mla_absorbed_check(params, cfg, out["generated"])
        if cfg.use_mrope:
            _zoo_vlm_prefill(params, cfg)
        del params
        torch.cuda.empty_cache()
    _zoo_encoder(records, get_config("hubert-xlarge"))
    torch.cuda.empty_cache()
    for arch, depth in ZOO_DEPTH.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth)
        params, _ = _zoo_serve(
            records, arch, cfg,
            f"depth {depth} of {full.num_layers} layers (full width; "
            f"{full.num_params()} parameters whole, beyond one card's 80 GB "
            f"in fp32 masters)")
        del params
        torch.cuda.empty_cache()
    _zoo_agreement()
    log(f"LM zoo phase: {time.perf_counter() - t_phase:.1f} s")


# the MoE archs on one card: full width, cut in depth (layers kept)
MOE_DEPTH = {"qwen3-moe-235b-a22b": 8, "llama4-maverick-400b-a17b": 2}
# a routing flip, card against CPU: the token's k-th and (k+1)-th
# probabilities within this of each other
MOE_FLIP_GAP = 1e-5
# the full-width MoE layer against its plain version: 1 x 256 tokens in
# fp32 at capacity factor 64 (nothing drops), |layer - plain| within
# this of max |plain|
MOE_LAYER_TOKENS, MOE_LAYER_BOUND = 256, 1e-5


def _moe_layer_check():
    """One qwen3-moe-235b-a22b MoE layer at full width (128 experts of
    4096 x 1536, top-8; drawn on the card from seed 0) in fp32 over 1 x
    MOE_LAYER_TOKENS tokens at capacity factor 64: the grouped capacity
    dispatch against ``agreement.dense_mixture``, every expert on every
    token weighted by the renormalized gates (one routing group, so the
    router's product is the plain version's, bit for bit)."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models.agreement import dense_mixture
    from repro_torch.models.layers import moe
    cfg = get_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=64.0))
    params = moe.moe_init(prng.PRNGKey(0, device="cuda"), cfg)
    x = torch.randn(1, MOE_LAYER_TOKENS, cfg.d_model,
                    generator=torch.Generator().manual_seed(28)).to("cuda")
    with torch.no_grad(), moe.record_routes() as routes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_apply(params, cfg, x)
        torch.cuda.synchronize()
        t_layer = time.perf_counter() - t0
        plain = dense_mixture(params, cfg, x)
    dev = float((y - plain).abs().max()) / max(float(plain.abs().max()), 1.0)
    kept = bool(routes[0]["kept"].all())
    log(f"  one qwen3-moe MoE layer at full width, fp32, 1 x "
        f"{MOE_LAYER_TOKENS} tokens, capacity factor 64 "
        f"({'none' if kept else 'some'} dropped; {t_layer * 1e3:.2f} ms, "
        f"first call): max |dispatch - "
        f"dense top-k mixture| / max |mixture| {dev:.3e} (bound "
        f"{MOE_LAYER_BOUND}); aux {float(aux):.6f}")
    if not (kept and dev <= MOE_LAYER_BOUND and torch.isfinite(aux)):
        raise AssertionError(f"MoE layer: all kept {kept}, dev {dev}, aux "
                             f"{float(aux)}")
    del params, x, y, plain


def _moe_profile(params, cfg):
    """One traced prefill of the serve's prompts and one traced decode
    step after it (bf16, the serve's weights): wall, device busy share
    and the device operations that take the most time."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to("cuda")
    traced = {}

    def prefill():
        t0 = time.perf_counter()
        traced["out"] = tfm.prefill(params, cfg, {"tokens": prompts},
                                    max_len=LM_PROMPT + 2)
        torch.cuda.synchronize()
        traced["wall"] = time.perf_counter() - t0

    def decode():
        t0 = time.perf_counter()
        tfm.decode_step(params, cfg, traced["cache"], traced["tok"])
        torch.cuda.synchronize()
        traced["wall"] = time.perf_counter() - t0
    with torch.no_grad():
        for label, run in (("prefill", prefill), ("decode step", decode)):
            by_name, n = {}, 0
            for e in _trace(run, cpu=True):
                by_name[e.name] = by_name.get(e.name, 0.0) \
                    + e.time_range.elapsed_us()
                n += 1
            if "out" in traced:
                logits, traced["cache"] = traced.pop("out")
                traced["tok"] = torch.argmax(logits[:, -1:], dim=-1)
                del logits
            busy, wall = sum(by_name.values()) / 1e6, traced["wall"]
            log(f"  profile {cfg.name} {label} (traced, warm): wall "
                f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms = "
                f"{100 * busy / wall:.1f}% of wall, {n} device operations; "
                f"top: " + "; ".join(
                    f"{us / 1e3:.3f} ms {(_short_name(k) or k)[:48]}"
                    for k, us in sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:6]))
    del traced


def _bf16_init_check():
    """``init_params(key, cfg, dtype=bf16)`` on the card, bitwise
    ``activation_copy`` of the fp32 init, for every reduced LM config,
    with the hash's chunk cut to 4096 entries so every weight is drawn
    and cast in several chunks."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import prng
    from repro_torch.models import transformer as tfm
    chunk, prng._CHUNK = prng._CHUNK, 4096
    try:
        n = 0
        for arch, full in ARCHS.items():
            if full.kind == "ntm":
                continue
            cfg = full.reduced()
            key = prng.PRNGKey(3, device="cuda")
            want = tfm.stack_layers(tfm.activation_copy(
                tfm.init_params(key, cfg), cfg, torch.bfloat16))
            got = tfm.stack_layers(tfm.init_params(key, cfg,
                                                   dtype=torch.bfloat16))
            bad = [k for k in want if got[k].dtype != want[k].dtype
                   or not torch.equal(got[k], want[k])]
            if list(got) != list(want) or bad:
                raise AssertionError(f"bf16 init {arch}: leaves {bad} differ "
                                     f"from the cast of the fp32 init")
            n += 1
    finally:
        prng._CHUNK = chunk
    log(f"  bf16 init on the card: bitwise the cast of the fp32 init for "
        f"the {n} reduced LM configs (chunks of 4096 entries)")


def _moe_agreement():
    """Both reduced MoE configs in fp32 from the same weights on the card
    and on the CPU (``agreement.card_vs_cpu``): prefill over 96
    tokens and 4 teacher-forced decode steps.  Expert sets compared
    first: a token whose set differs counts as a flip only where its
    k-th and (k+1)-th probabilities are within MOE_FLIP_GAP, and its row
    leaves the logits bound from there on; any other difference fails.
    The other rows' logits within 2e-4; B5 once per layer of the
    prefill, never in decode, never on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.agreement import card_vs_cpu
    for arch in MOE_DEPTH:
        cfg = get_config(arch).reduced()
        got = card_vs_cpu(cfg, "cuda", seed=0, gap_tol=MOE_FLIP_GAP)
        n = got["launches"]
        log(f"agreement LM MoE {arch} (reduced, fp32, 2 x 96 + 4 decode "
            f"steps): routing flips {got['flips']} (gap <= {MOE_FLIP_GAP}; "
            f"rows left out {got['rows_left_out']}), other differing "
            f"expert sets {len(got['strays'])}; card vs CPU logits, max "
            f"|diff| / max(|cpu|, 1): " + (", ".join(
                f"{d:.3e}" for d in got["devs"]) or "no row left")
            + f" (bound 2e-4); B5 (prefill, decode) card {n['dev']}, CPU "
            f"{n['cpu']}")
        if got["strays"]:
            raise AssertionError(f"LM MoE agreement {arch}: expert sets "
                                 f"differ without a near-tie: "
                                 f"{got['strays'][:5]}")
        if n["cpu"] != (0, 0) or n["dev"] != (cfg.num_layers, 0):
            raise AssertionError(f"LM MoE agreement {arch}: B5 launches "
                                 f"{n}")
        if not all(d <= 2e-4 for d in got["devs"]):
            raise AssertionError(f"LM MoE agreement {arch}: card vs CPU "
                                 f"{got['devs']} beyond 2e-4")


def phase_lm_moe(records):
    """The MoE half of the zoo on the card: qwen3-moe-235b-a22b (8 of
    94 layers) and llama4-maverick-400b-a17b (2 of 48: one dense + MoE
    unit) served at full width through ``repro_torch.launch.serve``, the
    cast weights drawn straight into bf16 on the card; one full-width
    MoE layer against its plain version; the two reduced configs card
    against CPU with routing flips counted.  Every serve zeroes the
    launch counts just before and reads them just after."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    for arch, depth in MOE_DEPTH.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth)
        params, _ = _zoo_serve(
            records, arch, cfg,
            f"depth {depth} of {full.num_layers} layers (full width; "
            f"{full.num_params()} parameters whole by the reference's count, "
            f"{full.num_params() * 2 / 1e9:.0f} GB even in bf16, beyond one "
            f"card's 80 GB)", path="lm_moe", dtype=torch.bfloat16)
        _moe_profile(params, cfg)
        del params
        torch.cuda.empty_cache()
    _moe_layer_check()
    torch.cuda.empty_cache()
    _bf16_init_check()
    _moe_agreement()
    log(f"LM MoE phase: {time.perf_counter() - t_phase:.1f} s")


# the zoo's training on one card: the launcher's sgd steps at 1 x 4096
# (the reference's train_4k shape, its global batch of 256 cut to 1) at
# full width, bf16 activations over fp32 masters; (arch, layers kept or
# None for the whole model, remat="layer").  Cut in depth where the fp32
# masters, their gradients and the update's new leaves (12 bytes a
# weight) and the activations pass 80 GB; minicpm3-4b whole (4.26 G
# weights) recomputes each layer in the backward.
ZOO_TRAIN = (("hubert-xlarge", None, False), ("minicpm3-4b", None, True),
             ("qwen2-vl-7b", 8, False), ("granite-34b", 4, False),
             ("qwen1.5-110b", 1, False), ("qwen3-moe-235b-a22b", 1, False))
ZOO_TRAIN_STEPS = 3
# the minicpm3-4b federated round (lm_fedavg on both exec modes, fp32, 2
# of 62 layers at full width): documents a node and rounds a mode
ZOO_FED_DOCS, ZOO_FED_ROUNDS = 8, 2
# the MoE grouped dispatch's autograd nodes: the scatter into the expert
# buffer (out-of-place index_add), the gather of the experts' outputs
# (``expert_out[dest]``), the router's top-k sort
MOE_DISPATCH_NODES = ("IndexAddBackward0", "IndexBackward0",
                      "SortBackward0")
# the seven reduced zoo configs whose train_loss gradients are held card
# against CPU
ZOO_TRAIN_AGREE = ("granite-34b", "qwen1.5-110b", "qwen2-vl-7b",
                   "minicpm3-4b", "hubert-xlarge", "qwen3-moe-235b-a22b",
                   "llama4-maverick-400b-a17b")


def _node_device_us(prof) -> dict:
    """Device time by autograd node in a trace of host and device
    activity: ``{node: (calls, device us, {kernel: device us})}`` from
    the host events ``autograd::engine::evaluate_function: <node>``, the
    kernels named from the ops under each."""
    tag = "autograd::engine::evaluate_function: "
    out = {}
    for e in prof.events():
        if not e.name.startswith(tag):
            continue
        node = e.name[len(tag):]
        calls, us, kern = out.get(node, (0, 0.0, {}))
        stack = [e]
        while stack:
            x = stack.pop()
            for k in getattr(x, "kernels", None) or []:
                name = _short_name(k.name) or k.name
                kern[name] = kern.get(name, 0.0) + k.duration
            stack.extend(x.cpu_children)
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = e.cuda_time_total
        out[node] = (calls + 1, us + total, kern)
    return out


def _zoo_train(records, arch, depth, remat, totals):
    """``repro_torch.launch.train.main`` for ``arch`` at full width (cut
    to ``depth`` layers, each recomputed in the backward with ``remat``):
    ZOO_TRAIN_STEPS sgd steps of 1 x 4096 from the launcher's seeded init
    on the card.  Per step, the counts zeroed just before and read just
    after: B5 once per layer (twice with ``remat``: the recomputation)
    and its backward once per layer, nothing else; every loss finite.
    Step times (the first is the warm-up), peak memory over the later
    steps, the last step traced (busy share, device time by kernel; for
    a MoE config also by autograd node, the grouped dispatch's
    backward named)."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch import train as lm_train
    from repro_torch.models import transformer as tfm
    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full,
                                                         num_layers=depth)
    if remat:
        cfg = dataclasses.replace(cfg, remat_layers=True)
    layers = cfg.num_layers
    cut = f"{layers}/{full.num_layers} layers" + (
        ", remat=\"layer\"" if remat else "")
    argv = ["--arch", arch, "--steps", str(ZOO_TRAIN_STEPS), "--batch",
            str(TRAIN_LM_BATCH), "--seq", str(TRAIN_LM_SEQ),
            "--num-clients", "1", "--log-every", str(ZOO_TRAIN_STEPS)]
    dv = cfg.resolved_head_dim
    dqk = dv + (cfg.mla_rope_head_dim if cfg.use_mla else 0)
    log(f"LM zoo train: {arch} ({cfg.kind}, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, B5 at (Dqk, Dv) = "
        f"({dqk}, {dv}), {cfg.num_params()} weights kept of "
        f"{full.num_params()}); repro_torch.launch.train {' '.join(argv)}; "
        f"cut: {cut}")
    want = {k: 0 for k in read_counts()}
    want.update(flash_attention=layers * (2 if remat else 1),
                flash_attention_bwd=layers)
    moe = cfg.kind == "moe"
    st = {"losses": [], "walls": [], "counts": [], "prof": None}

    def init():
        t0 = time.perf_counter()
        params = tfm.init_params(prng.PRNGKey(0, device="cuda"), cfg)
        torch.cuda.synchronize()
        st["init_s"] = time.perf_counter() - t0
        zero_counts()
        st["t"] = time.perf_counter()
        return params

    def on_step(step, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        st["counts"].append(read_counts())
        st["losses"].append(float(loss))
        st["walls"].append(now - st["t"])
        if step == 0:        # after the warm-up step
            torch.cuda.reset_peak_memory_stats()
        if step == ZOO_TRAIN_STEPS - 1:
            st["prof"].__exit__(None, None, None)
        if step == ZOO_TRAIN_STEPS - 2:
            acts = [torch.profiler.ProfilerActivity.CUDA]
            if moe:
                acts.append(torch.profiler.ProfilerActivity.CPU)
            st["prof"] = torch.profiler.profile(activities=acts)
            st["prof"].__enter__()
        zero_counts()
        st["t"] = time.perf_counter()

    torch.cuda.empty_cache()
    final = lm_train.main(argv, init=init, on_step=on_step, cfg=cfg)
    peak = torch.cuda.max_memory_allocated()
    for i, c in enumerate(st["counts"]):
        if c != want:
            raise AssertionError(f"LM zoo train {arch} step {i}: kernel "
                                 f"launches {c} != {want}")
    if len(st["losses"]) != ZOO_TRAIN_STEPS or not all(
            math.isfinite(x) for x in st["losses"] + [final]):
        raise AssertionError(f"LM zoo train {arch}: losses {st['losses']}")
    from torch.autograd import DeviceType
    prof = st["prof"]
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy, wall = sum(by_name.values()) / 1e6, st["walls"][-1]
    if busy <= 0:
        raise AssertionError(f"LM zoo train {arch}: torch.profiler recorded "
                             f"no device time in the traced step")
    b5 = {lab: sum(us for k, us in by_name.items() if key in k) / 1e3
          for lab, key in (("B5", "flash_fwd"), ("B5-bwd", "flash_bwd"))}
    log(f"  init {st['init_s']:.2f} s; losses "
        + ", ".join(f"{x:.4f}" for x in st["losses"])
        + "; steps " + ", ".join(f"{w:.4f}" for w in st["walls"])
        + f" s (the first warms up, the last traced: device busy "
        f"{busy:.4f} s = {100 * busy / wall:.1f}% of its wall, B5 "
        f"{b5['B5']:.3f} ms, B5-bwd {b5['B5-bwd']:.3f} ms of device time); "
        f"peak device memory over steps 1-{ZOO_TRAIN_STEPS - 1} "
        f"{peak / 2**30:.2f} GiB; launches a step: B5 "
        f"{st['counts'][0]['flash_attention']}, B5-bwd "
        f"{st['counts'][0]['flash_attention_bwd']}, others 0")
    log("    top device operations of the traced step: " + "; ".join(
        f"{us / 1e3:.3f} ms {(_short_name(k) or k)[:60]}"
        for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))
    if moe:
        nodes = _node_device_us(prof)
        disp = {n: v for n, v in nodes.items() if n in MOE_DISPATCH_NODES}
        log(f"    MoE grouped dispatch backward in the traced step "
            f"(plain PyTorch): {sum(v[1] for v in disp.values()) / 1e3:.3f} "
            f"ms of device time over " + "; ".join(
                f"{n} x{c} {us / 1e3:.3f} ms ("
                + ", ".join(f"{k} {t / 1e3:.3f} ms" for k, t in sorted(
                    kern.items(), key=lambda kv: -kv[1])[:3]) + ")"
                for n, (c, us, kern) in sorted(disp.items())))
        log("    autograd nodes by device time in the traced step: "
            + "; ".join(f"{n} x{c} {us / 1e3:.3f} ms" for n, (c, us, _)
                        in sorted(nodes.items(),
                                  key=lambda kv: -kv[1][1])[:10]))
    for c in st["counts"]:
        for k_, v_ in c.items():
            totals[k_] += v_
    del prof, st


def _arch_fed_round(arch, what, kernels, totals, bound=None):
    """One ``arch`` federated round on each exec mode at full width, fp32,
    cut in depth to ZOO_FED_LAYERS layers (the bundle's ``init``, ``loss``
    and ``loss_sum`` through ``from_spec``'s overrides): ``lm_fedavg``
    with ZOO_FED_CLIENTS clients of ZOO_FED_BATCH x ZOO_FED_SEQ-token
    documents, on the batched path and on the host loop; ZOO_FED_ROUNDS
    rounds each, the last traced: wall, busy share, peak memory, finite
    losses, the device ms of each of ``kernels`` ((label, fragments of
    its kernels' names)), and the two paths' parameters after the rounds
    (within ``bound`` where one is given)."""
    from repro_torch.api import Federation, scenario_spec, spec_replace
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models.registry import build_model
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=ZOO_FED_LAYERS)
    bundle = build_model(cfg, dtype=torch.float32)
    t0 = time.perf_counter()
    init = bundle.init(prng.PRNGKey(0, device="cuda"))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sizes = {"model.arch": arch, "model.vocab": cfg.vocab_size,
             "model.layers": ZOO_FED_LAYERS, "model.seq_len": ZOO_FED_SEQ,
             "data.num_clients": ZOO_FED_CLIENTS,
             "data.docs_per_node": ZOO_FED_DOCS,
             "data.val_docs_per_node": 1,
             "schedule.rounds": ZOO_FED_ROUNDS,
             "execution.batch_size": ZOO_FED_BATCH,
             "execution.learning_rate": FED_LM_LR}
    log(f"LM federated round: {arch} at full width ({what}), fp32 as the "
        f"reference federates, the seeded init ({t_init:.1f} s); "
        f"lm_fedavg, {ZOO_FED_CLIENTS} clients of {ZOO_FED_DOCS} documents,"
        f" batch {ZOO_FED_BATCH} x {ZOO_FED_SEQ} tokens, client sgd lr "
        f"{FED_LM_LR}; cut: {ZOO_FED_LAYERS}/{full.num_layers} layers "
        f"({cfg.num_params()} parameters), {ZOO_FED_ROUNDS} rounds a mode")
    feds, out = {}, {}
    for mode in ("vmap", "loop"):
        spec = spec_replace(scenario_spec("lm_fedavg"),
                            {**sizes, "execution.exec_mode": mode})
        fed = Federation.from_spec(spec, device="cuda", loss_fn=bundle.loss,
                                   loss_sum_fn=bundle.loss_sum,
                                   init_params=init)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, counts, by_name = _fed_lm_rounds(
            fed, ZOO_FED_ROUNDS, f"{arch} lm_fedavg {mode}",
            traced_last=True)
        peak = torch.cuda.max_memory_allocated()
        for c in counts:
            for k_, v_ in c.items():
                totals[k_] += v_
        losses = [h["loss"] for h in fed.history]
        busy = sum(by_name.values()) / 1e6
        if busy <= 0 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{arch} federated {mode}: busy {busy}, "
                                 f"losses {losses}")
        ms = {lab: sum(us for k, us in by_name.items()
                       if any(f in k for f in frags)) / 1e3
              for lab, frags in kernels}
        log(f"  {mode}: clients {[c.num_docs for c in fed.engine.clients]} "
            f"documents; rounds " + ", ".join(f"{w:.4f}" for w in walls)
            + f" s (the last traced: device busy {busy:.4f} s = "
            f"{100 * busy / walls[-1]:.1f}% of its wall; "
            + ", ".join(f"{lab} {v:.3f} ms" for lab, v in ms.items())
            + f"); peak device memory {peak / 2**30:.2f} GiB; losses "
            f"{losses}; launches a round: {_short_counts(counts[0])}")
        out[mode] = {"walls_s": walls, "busy_s": busy, "peak_gib":
                     peak / 2**30, "kernel_ms": ms, "losses": losses}
        feds[mode] = fed
    devs = _fed_lm_devs(feds["loop"].params, feds["vmap"].params)
    log(f"  loop vs vmap after {ZOO_FED_ROUNDS} rounds: max |diff| "
        f"{devs.max():.3e} over {devs.size} parameters"
        + ("" if bound is None else f" (bound {bound})"))
    if bound is not None and not devs.max() <= bound:
        raise AssertionError(f"{arch} federated: loop and vmap differ by "
                             f"{devs.max()} > {bound}")
    del feds, init
    torch.cuda.empty_cache()
    return out


def _zoo_fed_round(totals):
    """The minicpm3-4b round (:func:`_arch_fed_round`): B5 and its fp32
    backward at (96, 64) once per layer on the batched path (the clients
    folded into the batch axis), once per layer and client on the loop."""
    _arch_fed_round("minicpm3-4b", "MLA, B5 and its fp32 backward at "
                    "(96, 64)", (("B5", ("flash_fwd",)),
                                 ("B5-bwd", ("flash_bwd",)),
                                 ("B2", ("weighted_sum",))), totals)


def _mamba2_fed_round(totals):
    """The mamba2-1.3b round at its full width (d_model 2048, 64 heads of
    P=64, N=128, chunk 256, vocab 50 280; :func:`_arch_fed_round`): B6 and
    its fp32 backward (split TF32 on the tensor cores) once per layer and
    client on both paths, B2 once a round; loop and vmap within 1e-5
    after the rounds."""
    return _arch_fed_round(
        "mamba2-1.3b", "B6 and its fp32 backward at N=128, chunk 256",
        (("B6", ("ssd_chunk_", "ssd_state_pass")), ("B6-bwd", ("ssd_bwd_",)),
         ("B2", ("weighted_sum",))), totals, bound=1e-5)


def _mamba2_agreement():
    """A narrow mamba2-1.3b at its real state width and chunk (N=128,
    chunk 256; 2 layers at d_model 256, 8 heads of P=64) in fp32 from the
    same weights on the card and on the CPU
    (``agreement.grads_card_vs_cpu``, 2 x 96 tokens): ``train_loss`` and
    every gradient leaf within 2e-4; B6 and its backward once per layer
    on the card, never on the CPU.  A check's launches, not counted."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models.agreement import grads_card_vs_cpu
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2,
                              d_model=256)
    c0 = (ssd_scan.launches, ssd_scan.bwd_launches)
    got = grads_card_vs_cpu(cfg, "cuda")
    launched = (ssd_scan.launches - c0[0], ssd_scan.bwd_launches - c0[1])
    worst = max(got["grad_devs"].values())
    log(f"agreement LM train mamba2-1.3b (2 layers, d_model 256, N=128, "
        f"chunk 256, fp32, 2 x 96): card vs CPU train_loss "
        f"{got['loss_dev']:.3e}, gradients max |diff| / max|cpu| over "
        f"{len(got['grad_devs'])} leaves {worst:.3e} (bound 2e-4); B6, "
        f"B6-bwd launches {launched}")
    if launched != (2 * cfg.num_layers, cfg.num_layers):
        raise AssertionError(f"mamba2 agreement: B6 launches {launched}, "
                             f"want a forward per layer on each of two "
                             f"passes and a backward per layer")
    if not (got["loss_dev"] <= 2e-4 and worst <= 2e-4):
        raise AssertionError("mamba2 agreement: card vs CPU beyond 2e-4")


def _zoo_train_agreement():
    """Each reduced zoo config in fp32 from the same weights on the card
    and on the CPU (``agreement.grads_card_vs_cpu``): ``train_loss`` and
    every gradient leaf within 2e-4 (of |loss| and of each leaf's
    max|cpu|), over 2 x 96 tokens or frames; B5 and its backward once per
    layer on the card, never on the CPU; a MoE row a routing flip at a
    near-tie reached is left out on both, any other differing expert set
    fails, and so does a batch left with no row.  These launches are a
    check's, not the training paths', and are not counted."""
    from repro_torch.configs import get_config
    from repro_torch.models.agreement import grads_card_vs_cpu
    for arch in ZOO_TRAIN_AGREE:
        cfg = get_config(arch).reduced()
        got = grads_card_vs_cpu(cfg, "cuda", gap_tol=MOE_FLIP_GAP)
        worst = max(got["grad_devs"].values()) if got["grad_devs"] else None
        log(f"agreement LM zoo train {arch} (reduced, fp32, 2 x 96): card "
            f"vs CPU train_loss "
            + ("-" if got["loss_dev"] is None else f"{got['loss_dev']:.3e}")
            + f", gradients max |diff| / max|cpu| over "
            f"{len(got['grad_devs'])} leaves "
            + ("-" if worst is None else f"{worst:.3e}")
            + f" (bound 2e-4); routing flips {got['flips']}, rows left out "
            f"{got['rows_left_out']}; B5, B5-bwd launches {got['launches']}")
        if got["strays"]:
            raise AssertionError(f"LM zoo train agreement {arch}: expert "
                                 f"sets differ without a near-tie: "
                                 f"{got['strays'][:5]}")
        if got["loss_dev"] is None:
            raise AssertionError(f"LM zoo train agreement {arch}: routing "
                                 f"flips left no row of the batch")
        n = got["launches"]
        if n["cpu"] != (0, 0) or n["dev"] != (cfg.num_layers,
                                              cfg.num_layers):
            raise AssertionError(f"LM zoo train agreement {arch}: B5 "
                                 f"launches {n}")
        if not (got["loss_dev"] <= 2e-4 and worst <= 2e-4):
            raise AssertionError(f"LM zoo train agreement {arch}: card vs "
                                 f"CPU beyond 2e-4")


def phase_lm_zoo_train(records):
    """The zoo trains on the card: every arch of :data:`ZOO_TRAIN`
    through the training launcher (:func:`_zoo_train`), the minicpm3-4b
    and mamba2-1.3b federated rounds on both exec modes
    (:func:`_zoo_fed_round`, :func:`_mamba2_fed_round`), then the seven
    reduced configs' gradients card against CPU
    (:func:`_zoo_train_agreement`) and a narrow mamba2-1.3b's at N=128,
    chunk 256 (:func:`_mamba2_agreement`)."""
    t_phase = time.perf_counter()
    totals = {name: 0 for name in read_counts()}
    for arch, depth, remat in ZOO_TRAIN:
        _zoo_train(records, arch, depth, remat, totals)
        torch.cuda.empty_cache()
    _zoo_fed_round(totals)
    _mamba2_fed_round(totals)
    _zoo_train_agreement()
    _mamba2_agreement()
    for r in records:
        r["launches_by_path"]["lm_zoo_train"] = totals[r["name"]]
    log(f"  launches on the zoo's training paths: {json.dumps(totals)}")
    log(f"LM zoo train phase: {time.perf_counter() - t_phase:.1f} s")


# explicit positions and a carried state (phase_lm_positions): the left
# pads of the 4 x 2048 prompts, and the 1 x 4096 training row's
POS_PADS, POS_TRAIN_PAD = (0, 1, 129, 1500), 1000
# mamba2-1.3b's split scan: (b, s, h, p, n, chunk) at its full width
POS_SSD = (4, 4096, 64, 64, 128, 256)
# the reduced configs run card against CPU with left pads (one row of two
# unpadded); mamba2's layer from a carried state
POS_REDUCED = ("phi3-mini-3.8b", "hymba-1.5b", "minicpm3-4b", "qwen2-vl-7b",
               "qwen3-moe-235b-a22b", "hubert-xlarge")
POS_REDUCED_PADS = (0, 37)


def _left_padded_batch(cfg, seed, pads=POS_PADS, s=LM_PROMPT):
    """Real tokens of each row (S - pad of them, drawn from ``seed``) as
    (left-padded tokens with pad id 0 first, their positions arange(S) -
    pad, the same real tokens left-aligned with the pads after them), all
    (B, S) on the card."""
    rng = torch.Generator().manual_seed(seed)
    real = torch.randint(1, cfg.vocab_size, (len(pads), s), generator=rng)
    padded, aligned = torch.zeros_like(real), torch.zeros_like(real)
    for i, pad in enumerate(pads):
        padded[i, pad:] = real[i, :s - pad]
        aligned[i, :s - pad] = real[i, :s - pad]
    pos = torch.arange(s)[None] - torch.tensor(pads)[:, None]
    return padded.cuda(), pos.cuda(), aligned.cuda()


def _time_row(row, label, kern, plain, lib):
    """A positions or h0 row's times: the kernel's device time by the
    profiler (one launch a call, or B6's three and B6-bwd's four), the
    plain version's and the library call's by CUDA events (the plain
    versions with positions launch a count of operations that varies by
    a few from call to call, which a counted trace cannot hold)."""
    row["ms"] = device_ms(kern)
    row["plain_ms"] = event_ms(plain, iters=5, warmup=1)
    row["library_ms"] = None if lib is None else event_ms(lib, iters=20)
    lib_us = "none" if lib is None else f"{row['library_ms'] * 1e3:.2f} us"
    log(f"  {label}: device {row['ms'] * 1e3:.2f} us/call, plain "
        f"{row['plain_ms'] * 1e3:.2f} us, library {lib_us} (both by CUDA "
        f"events), bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")


def _b5_positions_rows(g, dev, rec_fwd, rec_bwd, totals_launches):
    """B5 at the left-padded prefills' shapes (phi3-mini-3.8b's 4 x 2048,
    32 heads of 96, causal; hymba-1.5b's 4 x 2048, 25/5 heads of 64,
    window 1024; pads 0, 1, 129, 1500) and B5-bwd at hymba's 1 x 4096
    training row (pad 1000), bf16: kernel against plain (out, lse, dq,
    dk, dv within 2e-2 of each one's scale), then timed beside the plain
    version and the library call with the positions' boolean mask; the
    bounds count the pairs the positions allow.  Launches on the path
    from ``totals_launches`` (the phase's counts)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = (("phi3-mini-3.8b prefill", LM_BATCH, 32, 32, LM_PROMPT, 96,
              True, 0, POS_PADS, "fwd"),
             ("hymba-1.5b prefill", LM_BATCH, 25, 5, LM_PROMPT, 64, True,
              1024, POS_PADS, "fwd"),
             ("hymba-1.5b train step", TRAIN_LM_BATCH, 25, 5, TRAIN_LM_SEQ,
              64, True, 1024, (POS_TRAIN_PAD,), "bwd"))
    for label, b, hq, hkv, s, d, causal, window, pads, which in cases:
        pos = (torch.arange(s)[None] - torch.tensor(pads)[:, None]).to(
            dev, torch.int32)
        q = torch.randn(b, s, hq, d, generator=g).to(dev, BF16)
        k = torch.randn(b, s, hkv, d, generator=g).to(dev, BF16)
        v = torch.randn(b, s, hkv, d, generator=g).to(dev, BF16)
        kw = dict(causal=causal, window=window, scale=d ** -0.5, q_pos=pos,
                  k_pos=pos)
        # the library's boolean (B, 1, S, S) mask of the positions
        mask = ref._attention_mask(pos, pos, causal, window)[:, None]
        pairs = hq * int(mask.sum())
        out, lse = flash_attention_cuda(q, k, v, want_lse=True, **kw)
        out_w, lse_w = ref.flash_attention_fwd_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        live = lse_w > -5e29
        err = {"out": _rel_err(out, out_w),
               "lse": float((lse[live] - lse_w[live]).abs().max())}
        dead_ok = bool((lse[~live] == -1e30).all()) and bool(
            (out[(~live).any(dim=1)] == 0).all())
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row = {"shape": [b, s, hq, hkv, d, d], "causal": causal,
               "window": window, "pads": list(pads), "pairs": pairs,
               "fully_masked_rows": int((~live).sum())}
        if which == "fwd":
            # q, k, v read once, out written once (bf16), positions read;
            # QK^T and PV over the pairs the positions allow
            row["bound_ms"], row["bound_by"] = bound_ms(
                2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
                + 8 * b * s, 4 * d * pairs, H100_BF16_FLOPS)
            _time_row(row, f"B5 with positions at {label}",
                      lambda: flash_attention_cuda(q, k, v, **kw),
                      lambda: ref.flash_attention_fwd_ref(q, k, v, **kw),
                      lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                   enable_gqa=True))
            row["launches"] = totals_launches.get(label, 0)
            rec_fwd.setdefault("positions", {})[label] = row
        else:
            dout = torch.randn(b, s, hq, d, generator=g).to(dev, BF16)
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
            torch.cuda.synchronize()
            err.update({n_: _rel_err(u, w) for n_, u, w in
                        zip(("dq", "dk", "dv"), grads, want)})
            dead_ok = dead_ok and bool((grads[0][(~live).any(dim=1)]
                                        == 0).all())
            del grads, want
            row["bound_ms"], row["bound_by"] = bound_ms(
                2 * (3 * b * s * hq * d + 2 * b * s * hkv * d)
                + 4 * b * hq * s + 8 * b * s
                + 2 * (b * s * hq * d + 2 * b * s * hkv * d),
                10 * d * pairs, H100_BF16_FLOPS)
            qg, kg, vg = (t.requires_grad_(True) for t in (qt, kt, vt))
            lib_out = sdpa(qg, kg, vg, attn_mask=mask, enable_gqa=True)
            dout_t = dout.transpose(1, 2).contiguous()
            _time_row(row, f"B5-bwd with positions at {label}",
                      lambda: flash_attention_bwd_cuda(q, k, v, out, lse,
                                                       dout, **kw),
                      lambda: ref.flash_attention_bwd_ref(
                          q, k, v, out, lse, dout, **kw),
                      lambda: torch.autograd.grad(
                          lib_out, (qg, kg, vg), dout_t, retain_graph=True))
            row["launches"] = totals_launches.get(label, 0)
            rec_bwd.setdefault("positions", {})[label] = row
            del lib_out, dout, dout_t
        row["max_abs_err"] = err
        log(f"  B5{'' if which == 'fwd' else '-bwd'} with positions at "
            f"{label} {row['shape']} pads {list(pads)}: kernel vs plain "
            f"(of max|plain|; lse abs) {json.dumps(err)}; "
            f"{row['fully_masked_rows']} fully masked rows 0 and -1e30: "
            f"{dead_ok}; {row['launches']} launches on the path")
        if not (max(err.values()) <= 2e-2 and dead_ok):
            raise AssertionError(f"B5 with positions at {label}: kernel vs "
                                 f"plain {err} beyond 2e-2, or a fully "
                                 f"masked row not 0 / -1e30")
        del q, k, v, qt, kt, vt, out, lse, out_w, lse_w, mask
        torch.cuda.empty_cache()


def _b6_h0_rows(g, dev, rec_fwd, rec_bwd, launches):
    """B6 and B6-bwd from a carried state at mamba2-1.3b's width (the
    split scan's second call: (4, 2048, 64 heads, P=64, N=128, chunk
    256), h0 drawn), bf16 and fp32: kernel against plain (y, h_last, dx,
    ddt, da, db, dc, dh0 within 2e-2 / 1e-4 of each one's scale), timed
    beside the plain version; no library call computes the scan."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    b, s, h, p, n, chunk = POS_SSD
    s //= 2
    nc = s // chunk
    for dtype in (BF16, FP32):
        key = str(dtype).replace("torch.", "")
        x, dt, a, bb, cc = _ssd_inputs(g, dev, b, s, h, p, n, dtype)
        h0 = torch.randn(b, h, p, n, generator=g).to(dev)
        dy = torch.randn(b, s, h, p, generator=g).to(dev, dtype)
        y, hl, st = ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk, h0=h0,
                                  keep_states=True)
        got = ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, None, chunk=chunk)
        y_w, hl_w = ref.ssd_scan_ref(x, dt, a, bb, cc, chunk, h0)
        want = ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, None, chunk, h0)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == BF16 else 1e-4
        err_f = {"y": _rel_err(y, y_w), "h_last": _rel_err(hl, hl_w)}
        err_b = {n_: _rel_err(u, w) for n_, u, w in zip(
            ("dx", "ddt", "da", "db", "dc", "dh0"), got, want)}
        log(f"  B6 / B6-bwd from h0 at {[b, s, h, p, n, chunk]} {key}: "
            f"kernel vs plain (of max|plain|) {json.dumps(err_f)}, "
            f"{json.dumps(err_b)} (bound {tol})")
        if not max(list(err_f.values()) + list(err_b.values())) <= tol:
            raise AssertionError(f"B6 from h0 {key}: kernel vs plain beyond "
                                 f"{tol}")
        del got, want, y_w, hl_w
        esz = 2 if dtype == BF16 else 4
        tri = chunk * (chunk + 1) // 2
        flops_f = b * h * nc * (tri * (2 * n + 2 * p + 2) + chunk * 4 * p * n)
        bytes_f = esz * (2 * b * s * h * p + 2 * b * s * n) \
            + 4 * (b * s * h + h) + 2 * 4 * b * h * p * n
        flops_b = b * h * nc * (tri * (6 * n + 4 * p) + chunk * 8 * p * n)
        bytes_b = esz * (3 * b * s * h * p + 4 * b * s * n) \
            + 4 * (2 * b * s * h + 2 * h + b * h * nc * p * n
                   + b * h * p * n)
        for rec, flops, nbytes, kern, plain in (
                (rec_fwd, flops_f, bytes_f,
                 lambda: ssd_scan_cuda(x, dt, a, bb, cc, chunk=chunk, h0=h0),
                 lambda: ref.ssd_scan_ref(x, dt, a, bb, cc, chunk, h0)),
                (rec_bwd, flops_b, bytes_b,
                 lambda: ssd_scan_bwd_cuda(x, dt, a, bb, cc, dy, st, None,
                                           chunk=chunk),
                 lambda: ref.ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, None,
                                              chunk, h0))):
            row = {"shape": [b, s, h, p, n, chunk], "dtype": key}
            if dtype == BF16:
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, flops, H100_BF16_FLOPS)
            else:
                split_tf32_bounds(row, nbytes, flops)
            _time_row(row, f"{rec['name']} from h0 {key}", kern, plain,
                      None)
            row["max_abs_err"] = err_f if rec is rec_fwd else err_b
            row["launches"] = launches[rec["name"]].get(key, 0)
            rec.setdefault("h0", {})[key] = row
        del x, dt, a, bb, cc, h0, dy, y, hl, st
        torch.cuda.empty_cache()


def _positions_phi3(totals, by_shape):
    """phi3-mini-3.8b whole (32 layers, full causal) in bf16 from seed 0:
    the 4 x 2048 left-padded prefill (pads 0, 1, 129, 1500, ``positions =
    arange(S) - pad``) then 32 greedy decode steps; the real tokens'
    logits against the same tokens prefilled left-aligned without
    positions (so with the pad keys masked and rope at the same positions
    the two differ only by B5's tiling: bound 2e-2 of the logits' max,
    the serve phase's bf16 bound); B5 once per layer of the padded
    prefill, nothing else, none in decode."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import transformer as tfm
    cfg = get_config("phi3-mini-3.8b")
    t0 = time.perf_counter()
    params = tfm.init_params(prng.PRNGKey(0, device="cuda"), cfg,
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    padded, pos, aligned = _left_padded_batch(cfg, 3)
    max_len = LM_PROMPT + LM_NEW
    # the left-aligned prefill first: it also warms cuBLAS at these shapes
    t0 = time.perf_counter()
    ref_logits, _ = tfm.prefill(params, cfg, {"tokens": aligned},
                                max_len=max_len)
    torch.cuda.synchronize()
    t_aligned = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    logits, cache = tfm.prefill(params, cfg, {"tokens": padded,
                                              "positions": pos},
                                max_len=max_len)
    torch.cuda.synchronize()
    t_padded = time.perf_counter() - t0
    counts = read_counts()
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.num_layers
    if counts != want:
        raise AssertionError(f"phi3 left-padded prefill: launches {counts} "
                             f"!= one B5 with positions a layer {want}")
    by_shape["phi3-mini-3.8b prefill"] = counts["flash_attention"]
    for k_ in totals:
        totals[k_] += counts[k_]
    devs, scale = [], 0.0
    for i, pad in enumerate(POS_PADS):
        real = LM_PROMPT - pad
        a_, b_ = logits[i, pad:].float(), ref_logits[i, :real].float()
        devs.append(float((a_ - b_).abs().max()))
        scale = max(scale, float(b_.abs().max()))
    row0 = torch.equal(logits[0], ref_logits[0])
    rel = max(devs) / scale
    del ref_logits
    tok = torch.argmax(logits[:, -1:], dim=-1)
    finite = bool(torch.isfinite(logits).all())
    del logits
    zero_counts()
    steps = []
    for _ in range(LM_NEW):
        t0 = time.perf_counter()
        step, cache = tfm.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(step[:, -1:], dim=-1)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(step).all())
    decode_counts = read_counts()
    med = sorted(steps)[len(steps) // 2]
    log(f"  phi3-mini-3.8b (32 layers, 32 heads of 96, full causal, bf16, "
        f"init {t_init:.2f} s on the card): left-padded prefill {LM_BATCH} "
        f"x {LM_PROMPT} pads {list(POS_PADS)} {t_padded:.4f} s, the "
        f"left-aligned one without positions {t_aligned:.4f} s (cold, "
        f"first); real tokens' logits max |padded - aligned| per row "
        f"{['%.3e' % d for d in devs]}, over max|logit| {scale:.3f} = "
        f"{rel:.3e} (bound 2e-2); the unpadded row bitwise equal: {row0}; "
        f"{LM_NEW} decode steps median {med * 1e3:.2f} ms "
        f"({LM_BATCH / med:.1f} tokens/s); logits finite {finite}; decode "
        f"launches {json.dumps(decode_counts)}")
    if not (rel <= 2e-2 and finite) or any(decode_counts.values()):
        raise AssertionError(f"phi3 left-padded prefill: logits vs the "
                             f"aligned run {rel} beyond 2e-2, not finite, "
                             f"or a kernel launched in decode")
    del params, cache, step
    torch.cuda.empty_cache()


def _positions_hymba(totals, by_shape):
    """hymba-1.5b whole (32 layers, window 1024) from seed 0: the same
    left-padded 4 x 2048 prefill in bf16 (B5 and B6 once a layer; the
    SSM half scans the pad tokens too, as the reference's does, so there
    is no unpadded twin), then one sgd step of ``launch.steps``'
    train step over a 1 x 4096 row with a pad of 1000 (positions and a
    loss mask on the pads): B5, B5-bwd, B6 and B6-bwd once a layer each,
    a finite loss."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.optimizers import sgd
    cfg = get_config("hymba-1.5b")
    masters = tfm.init_params(prng.PRNGKey(0, device="cuda"), cfg)
    act = tfm.activation_copy(masters, cfg, torch.bfloat16)
    padded, pos, _ = _left_padded_batch(cfg, 4)
    zero_counts()
    t0 = time.perf_counter()
    logits, _ = tfm.prefill(act, cfg, {"tokens": padded, "positions": pos},
                            max_len=LM_PROMPT + LM_NEW)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts = read_counts()
    want = {k: 0 for k in counts}
    want.update(flash_attention=cfg.num_layers, ssd_scan=cfg.num_layers)
    finite = bool(torch.isfinite(logits).all())
    del logits, act
    if counts != want or not finite:
        raise AssertionError(f"hymba left-padded prefill: launches {counts}"
                             f" != {want}, or logits not finite")
    by_shape["hymba-1.5b prefill"] = counts["flash_attention"]
    for k_ in totals:
        totals[k_] += counts[k_]
    torch.cuda.empty_cache()
    rng = torch.Generator().manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (1, TRAIN_LM_SEQ + 1),
                         generator=rng)
    toks[:, :POS_TRAIN_PAD] = 0
    mask = torch.ones(1, TRAIN_LM_SEQ)
    mask[:, :POS_TRAIN_PAD] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": mask,
             "positions": torch.arange(TRAIN_LM_SEQ)[None] - POS_TRAIN_PAD}
    batch = {k_: v.cuda() for k_, v in batch.items()}
    opt = sgd(2e-3)
    step = make_train_step(cfg, opt, dtype=torch.bfloat16)
    state = opt.init(masters)
    times, losses, step_counts = [], [], []
    for i in range(2):          # the first also warms the backward's shapes
        zero_counts()
        t0 = time.perf_counter()
        masters, state, loss = step(masters, state, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        step_counts.append(read_counts())
    want = {k: 0 for k in counts}
    want.update(flash_attention=cfg.num_layers, ssd_scan=cfg.num_layers,
                flash_attention_bwd=cfg.num_layers,
                ssd_scan_bwd=cfg.num_layers)
    log(f"  hymba-1.5b (32 layers, window 1024): left-padded bf16 prefill "
        f"{LM_BATCH} x {LM_PROMPT} pads {list(POS_PADS)} {t_prefill:.4f} s "
        f"(logits finite); sgd steps of 1 x {TRAIN_LM_SEQ} with pad "
        f"{POS_TRAIN_PAD}: {', '.join('%.4f' % t for t in times)} s, losses "
        f"{losses}; launches a step {json.dumps(step_counts[-1])}")
    if any(c != want for c in step_counts) or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"hymba left-padded train step: launches "
                             f"{step_counts} != {want} or a loss not finite")
    by_shape["hymba-1.5b train step"] = sum(
        c["flash_attention_bwd"] for c in step_counts)
    for c in step_counts:
        for k_ in totals:
            totals[k_] += c[k_]
    del masters, state, batch
    torch.cuda.empty_cache()


def _positions_mamba2(totals, b6_launches):
    """mamba2-1.3b's scan at its full width (4 x 4096 steps, 64 heads of
    P=64, N=128, chunk 256) in bf16 and fp32 through ``ops.ssd_scan``:
    the first half, then the second from its h_last (B6 from h0), against
    the whole sequence in one call: y and h_last, then the gradients of
    the split chain (through B6-bwd's dh0) against the whole call's, each
    within 2e-2 (bf16) / 1e-4 (fp32) of its scale; B6 and B6-bwd three
    launches each (whole, first half, second half)."""
    from repro_torch.kernels import ops
    b, s, h, p, n, chunk = POS_SSD
    half = s // 2
    g = torch.Generator().manual_seed(41)
    for dtype in (BF16, FP32):
        key = str(dtype).replace("torch.", "")
        x, dt, a, bb, cc = _ssd_inputs(g, "cuda", b, s, h, p, n, dtype)
        x, bb, cc = (u.contiguous().requires_grad_(True) for u in (x, bb, cc))
        dt = dt.requires_grad_(True)
        wy = torch.randn(b, s, h, p, generator=g).to("cuda", dtype)
        wh = torch.randn(b, h, p, n, generator=g).to("cuda")
        zero_counts()
        t0 = time.perf_counter()
        y, hl = ops.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
        gw = torch.autograd.grad(
            torch.sum(y.float() * wy.float()) + torch.sum(hl * wh),
            (x, dt, bb, cc))
        y1, h1 = ops.ssd_scan(x[:, :half], dt[:, :half], a, bb[:, :half],
                              cc[:, :half], chunk=chunk)
        y2, h2 = ops.ssd_scan(x[:, half:], dt[:, half:], a, bb[:, half:],
                              cc[:, half:], chunk=chunk, h0=h1)
        ys = torch.cat([y1, y2], dim=1)
        gs = torch.autograd.grad(
            torch.sum(ys.float() * wy.float()) + torch.sum(h2 * wh),
            (x, dt, bb, cc))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        tol = 2e-2 if dtype == BF16 else 1e-4
        devs = {"y": _rel_err(ys.detach(), y.detach()),
                "h_last": _rel_err(h2.detach(), hl.detach())}
        devs.update({f"d{n_}": _rel_err(u, w) for n_, u, w in
                     zip(("x", "dt", "b", "c"), gs, gw)})
        log(f"  mamba2-1.3b split scan {key} {list(POS_SSD)}: halves "
            f"chained through h_last against the whole call (of max|whole|) "
            f"{json.dumps(devs)} (bound {tol}); launches "
            f"{json.dumps(counts)}; {wall:.3f} s with the two backward "
            f"passes")
        want = {k_: 0 for k_ in counts}
        want.update(ssd_scan=3, ssd_scan_bwd=3)
        if counts != want or not max(devs.values()) <= tol:
            raise AssertionError(f"mamba2 split scan {key}: {devs} beyond "
                                 f"{tol} or launches {counts} != {want}")
        for k_ in totals:
            totals[k_] += counts[k_]
        b6_launches["ssd_scan"][key] = counts["ssd_scan"]
        b6_launches["ssd_scan_bwd"][key] = counts["ssd_scan_bwd"]
        del x, dt, a, bb, cc, y, hl, y1, h1, y2, h2, ys, gw, gs, wy, wh
        torch.cuda.empty_cache()


def _positions_agreement():
    """The reduced configs with left pads (0 and 37 of 96), fp32, card
    against CPU (``agreement.card_vs_cpu`` and ``grads_card_vs_cpu`` with
    ``pads``): the prefill and 4 decode steps (hubert: the forward) and
    ``train_loss`` with every gradient leaf within 2e-4; reduced
    mamba2-1.3b's layer from a carried ``ssm_state``
    (``ssm_state_card_vs_cpu``), y, state and the gradient with respect
    to the state within 2e-4.  A check's launches, not counted."""
    from repro_torch.configs import get_config
    from repro_torch.models import agreement
    worst = {}
    for arch in POS_REDUCED:
        cfg = get_config(arch).reduced()
        r = agreement.card_vs_cpu(cfg, pads=POS_REDUCED_PADS)
        gr = agreement.grads_card_vs_cpu(cfg, pads=POS_REDUCED_PADS)
        if r["strays"] or gr["strays"] or not r["devs"] \
                or gr["loss_dev"] is None:
            raise AssertionError(f"{arch} left-padded: expert sets differ "
                                 f"without a near-tie, or no row left")
        gdev = max(gr["grad_devs"].values())
        worst[arch] = (max(r["devs"]), gr["loss_dev"], gdev)
        if not (max(r["devs"]) <= 2e-4 and gr["loss_dev"] <= 2e-4
                and gdev <= 2e-4):
            raise AssertionError(f"{arch} left-padded card vs CPU "
                                 f"{worst[arch]} beyond 2e-4")
    m = agreement.ssm_state_card_vs_cpu(get_config("mamba2-1.3b").reduced())
    log(f"  reduced configs left-padded {list(POS_REDUCED_PADS)}, fp32 card "
        f"vs CPU (logits, train_loss, worst gradient leaf): "
        + "; ".join(f"{a_} {v[0]:.2e}, {v[1]:.2e}, {v[2]:.2e}"
                    for a_, v in worst.items())
        + f" (bound 2e-4); reduced mamba2-1.3b from ssm_state (y, state, "
        f"d ssm_state) {['%.2e' % d for d in m['devs']]}, B6/B6-bwd "
        f"launches {m['launches']}")
    if not max(m["devs"]) <= 2e-4 or m["launches"] != (1, 1):
        raise AssertionError("mamba2 from ssm_state: card vs CPU beyond "
                             "2e-4, or B6 not once each way")


def phase_lm_positions(records):
    """Explicit positions and a carried SSM state on the card: phi3-mini-
    3.8b and hymba-1.5b left-padded at full width
    (:func:`_positions_phi3`, :func:`_positions_hymba`), mamba2-1.3b's
    scan split and continued (:func:`_positions_mamba2`), each kernel
    with positions or h0 against its plain version and timed at those
    shapes (:func:`_b5_positions_rows`, :func:`_b6_h0_rows`), and the
    reduced configs card against CPU (:func:`_positions_agreement`).
    Every run's launches are zeroed just before it and read just after."""
    t_phase = time.perf_counter()
    log("LM positions phase: left-padded prompts (positions = arange(S) - "
        "pad) and a carried SSM state through B5, B5-bwd, B6 and B6-bwd")
    by_name = {r["name"]: r for r in records}
    totals = {name: 0 for name in read_counts()}
    by_shape = {}
    b6_launches = {"ssd_scan": {}, "ssd_scan_bwd": {}}
    _positions_phi3(totals, by_shape)
    _positions_hymba(totals, by_shape)
    _positions_mamba2(totals, b6_launches)
    g = torch.Generator().manual_seed(32)
    _b5_positions_rows(g, torch.device("cuda"), by_name["flash_attention"],
                       by_name["flash_attention_bwd"], by_shape)
    _b6_h0_rows(g, torch.device("cuda"), by_name["ssd_scan"],
                by_name["ssd_scan_bwd"], b6_launches)
    _positions_agreement()
    for r in records:
        r["launches_by_path"]["lm_positions"] = totals[r["name"]]
    log(f"  launches on the positions paths: {json.dumps(totals)}")
    if not all(totals[k_] > 0 for k_ in ("flash_attention",
                                         "flash_attention_bwd", "ssd_scan",
                                         "ssd_scan_bwd")):
        raise AssertionError(f"positions phase: a kernel of the path never "
                             f"launched {totals}")
    log(f"LM positions phase: {time.perf_counter() - t_phase:.1f} s")


LAUNCH_REMAT = ("none", "dots", "full")
LAUNCH_REMAT_STEPS = 3          # a warm-up step, then two timed
LAUNCH_DRYRUN = (("hymba-1.5b", "train_4k", "megatron"),
                 ("llama4-maverick-400b-a17b", "train_4k", "fsdp"),
                 ("qwen3-moe-235b-a22b", "decode_32k", "megatron"))
LAUNCH_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_scan",
                  "ssd_scan_bwd")
# the dry run's memory tracker against the card's allocator, relative
LAUNCH_MEMORY_BOUND = 0.10


def _dryrun_procs(out_dir):
    """The dry run of each pair in :data:`LAUNCH_DRYRUN`, one process
    each (a process's fake process group is its own), started together
    once the card's timed steps are done, so that they hold no step's
    time or busy share back."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"),
        OMP_NUM_THREADS="2")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for arch, shape, profile in LAUNCH_DRYRUN:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--profile", profile,
               "--out", out_dir]
        out = open(os.path.join(out_dir, f"{arch}__{shape}.log"), "w+")
        procs.append(((arch, shape, profile), out, subprocess.Popen(
            cmd, stdout=out, stderr=subprocess.STDOUT, text=True, env=env)))
    return procs


def _gradient_optimizer():
    """An ``Optimizer`` whose update returns the gradient itself, so that
    a train step hands back every leaf's exact gradient."""
    from repro_torch.optim.optimizers import Optimizer
    return Optimizer(lambda p: {}, lambda p, g, s, i=0: (g, s))


def _remat_steps(cfg, params, batch, remat):
    """``LAUNCH_REMAT_STEPS`` steps of ``make_train_step(remat=)``: the
    gradients and loss of the last, the step times after the first, the
    peak memory over them, every step's launches (each zeroed just before
    it and read just after; all equal) and one traced step's device busy
    share."""
    from torch.autograd import DeviceType
    from repro_torch.launch import steps as lm_steps
    step = lm_steps.make_train_step(cfg, _gradient_optimizer(), remat=remat)
    times, counts = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(LAUNCH_REMAT_STEPS):
        zero_counts()
        t0 = time.perf_counter()
        grads, _, loss = step(params, {}, batch, i)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        counts.append(read_counts())
        if i < LAUNCH_REMAT_STEPS - 1:
            del grads
    peak = torch.cuda.max_memory_allocated()
    # the profiler's first step is a warm-up (its set-up stalls the host);
    # the second is traced and timed.  A trace with no device event (the
    # profiler's known drop, ``_trace``) is taken again, at most twice
    busy = 0.0
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                 active=1, repeat=1)) as prof:
            for i in range(2):
                zero_counts()
                t0 = time.perf_counter()
                step(params, {}, batch, LAUNCH_REMAT_STEPS + i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts.append(read_counts())
                prof.step()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e6
        if busy > 0:
            break
    if busy <= 0:
        raise AssertionError(f"remat={remat}: torch.profiler recorded no "
                             f"device time in 3 traces")
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"remat={remat}: launches differ between "
                             f"steps {counts}")
    return grads, float(loss), times, peak, counts, busy / wall


def _report_line(rep: dict, card_bytes: int) -> str:
    mem = rep["memory_per_device"]
    total = mem["total_bytes"]
    return (f"{rep['arch']} x {rep['shape']} on {rep['mesh']}: per device "
            f"args {mem['argument_size_in_bytes'] / 2**30:.2f} GiB + temp "
            f"{mem['temp_size_in_bytes'] / 2**30:.2f} GiB + out "
            f"{mem['output_size_in_bytes'] / 2**30:.2f} GiB = "
            f"{total / 2**30:.2f} GiB against the card's "
            f"{card_bytes / 2**30:.2f} GiB ("
            f"{'fits' if total <= card_bytes else 'does not fit'}); "
            f"roofline compute {rep['compute_s'] * 1e3:.3f} ms, memory "
            f"{rep['memory_s'] * 1e3:.3f} ms, collective "
            f"{rep['collective_s'] * 1e3:.3f} ms -> {rep['bottleneck']}-bound"
            f" (collective bytes/device {rep['collective_bytes_per_device']:.4e}"
            f", flops/device {rep['hlo_flops_per_device']:.4e})")


def _launch_inputs():
    """hymba-1.5b at full width, its fp32 masters drawn on the card from
    seed 0, and a 1 x 4096 batch."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data import lm_data
    from repro_torch.models import transformer as tfm
    cfg = get_config("hymba-1.5b")
    params = tfm.init_params(prng.PRNGKey(0, device="cuda"), cfg)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             lm_data.synthetic_lm_batch(cfg, 1, 4096, seed=33).items()}
    return cfg, params, batch


def _launch_remat(records, cfg, params, batch):
    """Part (a) of :func:`phase_launch_sizing`: the three policies'
    steps on the card, each policy's loss and gradients bitwise
    ``"none"``'s (the same kernels on the same inputs, recomputed)."""
    from repro_torch.optim.optimizers import tree_leaves
    layers = cfg.num_layers
    totals = {name: 0 for name in read_counts()}
    base = None
    for remat in LAUNCH_REMAT:
        grads, loss, times, peak, all_counts, share = _remat_steps(
            cfg, params, batch, remat)
        counts = all_counts[0]
        fwd = layers if remat == "none" else 2 * layers
        want = {k: 0 for k in counts}
        want.update(flash_attention=fwd, ssd_scan=fwd,
                    flash_attention_bwd=layers, ssd_scan_bwd=layers)
        if counts != want:
            raise AssertionError(f"remat={remat}: launches a step {counts} "
                                 f"!= {want}")
        if not math.isfinite(loss):
            raise AssertionError(f"remat={remat}: loss {loss}")
        for k in totals:
            totals[k] += sum(c[k] for c in all_counts)
        log(f"  remat={remat}: loss {loss!r}; steps "
            + ", ".join(f"{t:.4f}" for t in times) + f" s; peak device "
            f"memory {peak / 2**30:.2f} GiB; device busy "
            f"{100 * share:.1f}% of a traced step's wall; launches a step "
            + json.dumps({k: counts[k] for k in LAUNCH_KERNELS}))
        if base is None:
            # "none"'s gradients wait on the host, so that no policy's
            # peak holds another's
            base = ([g.cpu() for g in tree_leaves(grads)], loss)
        else:
            leaves = tree_leaves(grads)
            off = [i for i, (g, b) in enumerate(zip(leaves, base[0]))
                   if not torch.equal(g, b.to(g.device))]
            log(f"    against none: loss {loss!r} vs {base[1]!r}, "
                f"{len(leaves)} gradient leaves, {len(off)} not bitwise "
                f"equal")
            if loss != base[1] or off or len(leaves) != len(base[0]):
                raise AssertionError(f"remat={remat}: loss or gradient "
                                     f"leaves {off[:8]} differ from none's")
            del leaves      # no policy's gradients outlive its steps
        del grads
    for r in records:
        r["launches_by_path"]["launch_sizing"] = totals[r["name"]]


def _launch_memory(cfg, params, batch):
    """The dry run's memory tracker held to the card's allocator: one sgd
    step (remat ``"none"``) of the same 1 x 4096 hymba-1.5b on the card,
    its arguments' bytes plus the peak the step adds over what the card
    held before it (``max_memory_allocated``, after a warm-up step),
    against ``dryrun.size_step``'s args + temp + out for the same step on
    fake tensors, within :data:`LAUNCH_MEMORY_BOUND`."""
    from repro_torch.configs import get_shape
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch import steps as lm_steps
    from repro_torch.optim.optimizers import get_optimizer
    opt = get_optimizer("sgd", 1e-3)
    step = lm_steps.make_train_step(cfg, opt)
    state = opt.init(params)
    args = analysis.local_bytes((params, state, batch))
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = step(params, state, batch, i)
        torch.cuda.synchronize()
        card = args + torch.cuda.max_memory_allocated() - before
        del out
    b, s = batch["tokens"].shape
    t0 = time.perf_counter()
    fake = dryrun.size_step(cfg, dataclasses.replace(
        get_shape("train_4k"), global_batch=b, seq_len=s))
    rel = fake["total_bytes"] / card - 1.0
    log(f"  memory of one sgd step ({b} x {s}, remat none): the card's "
        f"args {args / 2**30:.4f} GiB + peak over its resident "
        f"{(card - args) / 2**30:.4f} GiB = {card / 2**30:.4f} GiB; the "
        f"dry run's tracker, unsharded on fake tensors "
        f"({time.perf_counter() - t0:.1f} s on the host): args "
        f"{fake['argument_size_in_bytes'] / 2**30:.4f} + temp "
        f"{fake['temp_size_in_bytes'] / 2**30:.4f} + out "
        f"{fake['output_size_in_bytes'] / 2**30:.4f} = "
        f"{fake['total_bytes'] / 2**30:.4f} GiB ({100 * rel:+.2f}%, bound "
        f"{100 * LAUNCH_MEMORY_BOUND:.0f}%)")
    if abs(rel) > LAUNCH_MEMORY_BOUND:
        raise AssertionError(f"the dry run's memory {fake['total_bytes']} "
                             f"is {100 * rel:+.2f}% off the card's {card}")
    # a reading: one data shard of train_4k on the 16 x 16 mesh (256 / 16
    # sequences) on one device unsharded, beside the mesh's dry run
    shard = dryrun.size_step(cfg, dataclasses.replace(
        get_shape("train_4k"), global_batch=256 // 16))
    log(f"  the same tracker, unsharded, 16 x 4096 (train_4k's sequences "
        f"on one of the 16 data shards): {shard['total_bytes'] / 2**30:.2f}"
        f" GiB")


def phase_launch_sizing(records):
    """The remat policies and the dry run.  (a) hymba-1.5b at full width
    (bf16 activations over fp32 masters drawn on the card from seed 0), a
    1 x 4096 step of ``launch.steps.make_train_step`` under ``"none"``,
    ``"dots"`` and ``"full"``: loss and every gradient leaf of each
    policy bitwise ``"none"``'s; per policy the step time (two steps
    after a warm-up), peak memory, a traced step's device busy share and
    one step's launches: B5-bwd and B6-bwd once a layer, B5 and B6 once a
    layer under ``"none"`` and twice under ``"dots"`` and ``"full"`` (the
    backward's recomputation: the policy keeps products, and the kernels
    are not products).  (b) once the timed steps are done, the dry run
    (``python -m repro_torch.launch.dryrun``) of hymba-1.5b ``train_4k``,
    llama4-maverick-400b-a17b ``train_4k`` under ``fsdp`` and
    qwen3-moe-235b-a22b ``decode_32k`` on the fake 16 x 16 mesh, in host
    processes: each report's per-device memory against the card's and its
    roofline terms.  Meanwhile the dry run's memory tracker is held to
    the card's allocator on one sgd step (:func:`_launch_memory`)."""
    t_phase = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "experiments", "dryrun_torch")
    log("launch sizing phase: hymba-1.5b at full width, a 1 x 4096 train "
        "step under remat none / dots / full; then the dry run of "
        + ", ".join(f"{a} {s} ({p})" for a, s, p in LAUNCH_DRYRUN)
        + " on the fake 16 x 16 mesh on the host, and its memory tracker "
        "against the card's on one sgd step")
    cfg, params, batch = _launch_inputs()
    _launch_remat(records, cfg, params, batch)
    t_card = time.perf_counter() - t_phase
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    procs = _dryrun_procs(out_dir)
    try:
        _launch_memory(cfg, params, batch)
        del params, batch
        torch.cuda.empty_cache()
        for (arch, shape, profile), out, proc in procs:
            proc.wait(timeout=600)
            out.seek(0)
            text = out.read()
            if proc.returncode:
                raise AssertionError(f"dry run of {arch} {shape} "
                                     f"({profile}) failed:\n{text[-3000:]}")
            tag = f"{arch}__{shape}__16x16" + (
                "" if profile == "megatron" else f"__sgd_none_{profile}")
            with open(os.path.join(out_dir, tag + ".json")) as f:
                rep = json.load(f)
            refused = [ln.strip() for ln in text.splitlines()
                       if "resharded where DTensor refused" in ln]
            log(f"  dry run ({profile}) {_report_line(rep, card_bytes)}; "
                + "; ".join(refused))
    finally:
        for _, out, proc in procs:       # no process outlives the script
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            out.close()
    log(f"launch sizing phase: {time.perf_counter() - t_phase:.1f} s "
        f"(the timed steps {t_card:.1f} s)")


def phase_lm_agreement():
    """Reduced hymba-1.5b in fp32 from the same weights on the card
    (kernels B5 and B6) and on the CPU (their plain versions): prefill
    over 96 tokens, past the window of 64 and over two SSD chunks of 64,
    then 4 teacher-forced decode steps; logits within 2e-4, the repo's
    bound for this path."""
    from repro_torch.core import prng
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import transformer as tfm
    from repro_torch.models.agreement import tree_to
    cfg = get_config("hymba-1.5b").reduced()
    cpu = tfm.init_params(prng.PRNGKey(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 100)))
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", tree_to(cpu, "cuda"))):
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
    for dev, params in (("cpu", cpu), ("cuda", tree_to(cpu, "cuda"))):
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
    phase_ring_and_resume(records, corpus)
    phase_mesh(records, corpus)
    phase_wire(records, corpus)
    phase_lm_train(records, [phase_lm_serve(records)])
    phase_lm_federation(records)
    phase_lm_zoo(records)
    phase_lm_moe(records)
    phase_lm_zoo_train(records)
    phase_lm_positions(records)
    phase_launch_sizing(records)
    for r in records:
        r["launches"] = sum(r["launches_by_path"].values())
    phase_profile(spec, corpus)
    phase_training_profile(corpus)
    phase_agreement()
    phase_lm_agreement()
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("launches_by_path", "k5", "ring", "variant", "dp_ms",
             "dp_plain_ms", "dp_bound_ms", "dp_library_ms", "cold_ms",
             "library_cold_ms", "dp_cold_ms", "yardstick", "yardstick_ms",
             "max_abs_err_by_dtype", "pairs", "library", "design", "ptxas",
             "smem_bytes", "launch_us", "mamba2_ms", "device_ops_per_call",
             "replaces_note", "fwd_ms", "fwd_lse_ms", "fwd_states_ms",
             "routes", "fp32_case", "fp32_ms", "fed_lm", "fed_lm_mamba2",
             "zoo", "saved_draw", "fp32_repeat", "mamba2_fp32_ms",
             "positions", "h0")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                for r in records]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
