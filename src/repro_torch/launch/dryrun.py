"""Multi-node dry run: does every (arch x shape) fit the production mesh,
and where would its time go — on fake tensors, with no card.

For each selected pair the dry run:
  1. resolves the architecture variant for the shape (sliding window for
     long_500k on quadratic archs),
  2. builds params, optimizer state and batch (decode: tokens and cache)
     as DTensors of fake tensors on the production mesh
     (``launch.mesh.make_production_mesh``: 16x16, or 2x16x16 with
     --multi-pod, over the ``fake`` process group), placed by the
     partition rules of ``parallel/sharding.py``,
  3. runs the step eagerly under ``FakeTensorMode`` (train: loss,
     backward, update; prefill; decode), the card's code path with the
     kernels' fake implementations, counting collectives and live
     storage (``launch.analysis.StepTrace``),
  4. prints and writes the reference's roofline JSON, over the
     NVIDIA H100 constants of ``launch.mesh``.

The fake process group is the process's own, so one process runs one
sweep (one mesh) and nothing else.  No card is needed.

Usage:
  python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import (ARCHS, ASSIGNED_ARCHS, INPUT_SHAPES,
                                 ModelConfig, applicable_shapes, get_config,
                                 get_shape)
from repro_torch.launch import analysis, analytic
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (input_specs, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      resolve_arch_for_shape)
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.parallel.sharding import (batch_partition_spec,
                                           cache_partition_specs,
                                           get_profile,
                                           param_partition_specs,
                                           reshard_on_refusal, set_profile,
                                           shardings_for,
                                           use_abstract_mesh)

DOC = __doc__


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N_active*D (training) or 2*N_active*D (fwd only)."""
    n = cfg.num_active_params()
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.mode in ("train", "prefill")
                                   else 1)
    mult = 6 if shape.mode == "train" else 2
    return float(mult) * n * tokens


def _mesh_name(mesh) -> str:
    return "x".join(str(d) for d in mesh.mesh.shape)


def _distribute(tree, placements, mesh):
    """Meta tensors -> DTensors of fake tensors on the mesh's device type,
    each rank's shard cut locally (no collective); with no mesh, whole
    fake tensors on the CPU device (one device's unsharded step)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: _distribute(v, placements and placements[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_distribute(v, placements and placements[i], mesh)
                for i, v in enumerate(tree)]
    if not isinstance(tree, torch.Tensor):
        return tree
    full = torch.empty(tree.shape, dtype=tree.dtype,
                       device="cpu" if mesh is None else mesh.device_type)
    if mesh is None:
        return full
    return distribute_tensor(full, mesh, placements, src_data_rank=None)


@contextlib.contextmanager
def _nccl_all_to_all():
    """DTensor turns an all-to-all on a CPU mesh into an all-gather and a
    chunk (gloo has no all-to-all).  The dry run's mesh is a CPU mesh
    only because its fake tensors live on the CPU device; the card's
    NCCL has the all-to-all, so within the block DTensor issues it."""
    from torch.distributed.tensor import placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    saved = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = saved


@contextlib.contextmanager
def _real_index_math():
    """DTensor gathers an unevenly strided shard (``_StridedShard``) by
    index arithmetic on ``torch.arange`` tensors it reads back with
    ``tolist()``; under ``FakeTensorMode`` those would be fake and have
    no values.  Within the block that arithmetic runs on real tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    saved = getattr(_StridedShard, "local_shard_size_and_offset", None)
    if saved is None:       # a torch whose strided shards do no such math
        yield
        return

    def real(self, *args, **kwargs):
        with unset_fake_temporarily():
            return saved(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = real
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = saved


def _run_step(cfg, shape, mesh, *, optimizer="sgd", remat="none",
              cast_params=False):
    """One step of ``shape``'s mode on fake DTensors (on fake tensors,
    unsharded, with no ``mesh``): the trace, the argument bytes and the
    output bytes (local shards, per device)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    def place(tree, partition_specs):
        if mesh is None:
            return _distribute(tree, None, None)
        return _distribute(tree, shardings_for(
            mesh, partition_specs(cfg, mesh, tree)), mesh)

    specs = input_specs(cfg, shape)
    params_shape = tfm.init_param_shapes(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = place(params_shape, param_partition_specs)
        if shape.mode == "train":
            opt = get_optimizer(optimizer, 1e-3)
            opt_state = opt.init(params)
            batch = place(specs, batch_partition_spec)
            step = make_train_step(cfg, opt, remat=remat,
                                   cast_params=cast_params)
            args = (params, opt_state, batch, 0)
        elif shape.mode == "prefill":
            batch = place(specs, batch_partition_spec)
            step = make_prefill_step(cfg)
            args = (params, batch)
        else:
            cache = place(specs["cache"], cache_partition_specs)
            tokens = place({"tokens": specs["tokens"]}, batch_partition_spec)
            step = make_decode_step(cfg)
            args = (params, cache, tokens["tokens"])
        arg_bytes = analysis.local_bytes(args)
        trace = analysis.StepTrace(inputs=args)
        with trace, implicit_replication(), _nccl_all_to_all(), \
                _real_index_math(), reshard_on_refusal() as moved:
            out = step(*args)
        trace.resharded = moved
        out_bytes = analysis.local_bytes(out)
    return trace, arg_bytes, out_bytes


def size_step(cfg: ModelConfig, shape, *, optimizer="sgd",
              remat="none", cast_params=False) -> dict:
    """One device's memory for one step of ``shape`` (a ``ShapeConfig``,
    its whole batch on the device), unsharded on fake tensors: the
    report's ``memory_per_device`` keys, by the tracker ``lower_pair``
    sizes the production mesh with.  What a card that runs the same step
    should reach in ``max_memory_allocated`` over what it held before."""
    cfg = resolve_arch_for_shape(cfg, shape)
    trace, arg_bytes, out_bytes = _run_step(
        cfg, shape, None, optimizer=optimizer, remat=remat,
        cast_params=cast_params)
    return trace.memory_dict(arg_bytes, out_bytes)


def lower_pair(arch: str, shape_name: str, mesh, *, optimizer="sgd",
               remat="none", cast_params=False, mla_absorb=False,
               verbose=True, analysis_layers=True,
               cfg: Optional[ModelConfig] = None):
    """Trace one (arch, shape) on ``mesh``; return the report.

    Report sources, the reference's:
      * FULL-depth run — the proof that the step runs sharded, and the
        per-device memory ("does it fit");
      * FLOPs + HBM bytes — the closed-form model in launch/analytic.py;
      * collective bytes — two SHALLOW runs (1 and 2 units), extrapolated
        linearly to the real depth.
    ``cfg`` replaces ``get_config(arch)`` (a reduced config, in tests)."""
    with use_abstract_mesh(mesh):
        shape = get_shape(shape_name)
        cfg = resolve_arch_for_shape(cfg or get_config(arch), shape)
        if mla_absorb:
            cfg = dataclasses.replace(cfg, mla_absorb=True)
        per_unit = 2 if (cfg.kind == "moe" and cfg.moe.moe_every > 1) else 1
        nu = cfg.num_layers // per_unit
        chips = mesh.size()
        kw = dict(optimizer=optimizer, remat=remat, cast_params=cast_params)

        t0 = time.time()
        trace_full, arg_bytes, out_bytes = _run_step(cfg, shape, mesh, **kw)
        dt_full = time.time() - t0

        model_ways = dict(zip(mesh.mesh_dim_names,
                              mesh.mesh.shape)).get("model", 1)
        param_ways = chips
        if shape.mode == "decode" and get_profile() in ("megatron", "tp"):
            # params replicate across data under these profiles' decode
            param_ways = model_ways if get_profile() == "tp" else chips
        if get_profile() == "tp":
            param_ways = model_ways
        est = analytic.estimate(cfg, shape).per_device(
            chips, param_ways=param_ways)

        if analysis_layers and nu > 2:
            t1 = time.time()
            cfg1 = dataclasses.replace(cfg, num_layers=per_unit)
            cfg2 = dataclasses.replace(cfg, num_layers=2 * per_unit)
            c1 = _run_step(cfg1, shape, mesh, **kw)[0].breakdown()
            coll2 = _run_step(cfg2, shape, mesh, **kw)[0].breakdown()
            dt_an = time.time() - t1
            coll = c1["total"] + (coll2["total"] - c1["total"]) * (nu - 1)
            breakdown = {k: int(v * nu) for k, v in coll2.items()
                         if k != "total"}
        else:
            breakdown = trace_full.breakdown()
            coll = breakdown["total"]
            dt_an = 0.0

        report = analysis.RooflineReport(
            arch=arch, shape=shape_name, mesh=_mesh_name(mesh), chips=chips,
            hlo_flops=est.flops, hlo_bytes=est.bytes,
            collective_bytes=float(coll), collective_breakdown=breakdown,
            model_flops=_model_flops(cfg, shape),
            memory_per_device=trace_full.memory_dict(arg_bytes, out_bytes))
    if verbose:
        mem = report.memory_per_device
        print(f"  resharded where DTensor refused: {trace_full.resharded}")
        print(f"  traced full in {dt_full:.1f}s (+{dt_an:.1f}s analysis) | "
              f"per-device: args={mem['argument_size_in_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_size_in_bytes']/2**30:.2f}GiB")
        print(f"  flops/dev={report.hlo_flops:.3e} "
              f"bytes/dev={report.hlo_bytes:.3e} "
              f"coll_bytes/dev={report.collective_bytes:.3e}")
        print(f"  roofline: compute={report.compute_s*1e3:.2f}ms "
              f"memory={report.memory_s*1e3:.2f}ms "
              f"collective={report.collective_s*1e3:.2f}ms "
              f"-> {report.bottleneck}-bound "
              f"(useful-flops ratio {report.useful_flops_ratio:.3f})")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=DOC)
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every assigned (arch x applicable shape)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 ranks) instead of 16x16")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots", "layer"])
    ap.add_argument("--mla-absorb", action="store_true",
                    help="MLA decode weight absorption")
    ap.add_argument("--cast-params", action="store_true",
                    help="bf16 parameter all-gathers (mixed precision)")
    ap.add_argument("--profile", default="megatron",
                    choices=["megatron", "fsdp", "tp"],
                    help="sharding profile")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    set_profile(args.profile)
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type="cpu")
    mesh_name = _mesh_name(mesh)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        pairs = [(a, s) for a in ASSIGNED_ARCHS
                 for s in applicable_shapes(get_config(a))]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]

    failures = []
    for arch, shape in pairs:
        tag = f"{arch}__{shape}__{mesh_name}"
        if args.optimizer != "sgd" or args.remat != "none" \
                or args.profile != "megatron" or args.cast_params \
                or args.mla_absorb:
            tag += f"__{args.optimizer}_{args.remat}_{args.profile}" \
                + ("_bf16agg" if args.cast_params else "") \
                + ("_mlaabsorb" if args.mla_absorb else "")
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {tag}")
            continue
        print(f"[dryrun] {arch} x {shape} on {mesh_name} "
              f"({mesh.size()} ranks)")
        try:
            report = lower_pair(arch, shape, mesh,
                                optimizer=args.optimizer, remat=args.remat,
                                cast_params=args.cast_params,
                                mla_absorb=args.mla_absorb)
            with open(path, "w") as f:
                json.dump(report.to_dict(), f, indent=2)
        except Exception as e:  # noqa: BLE001 — record, keep sweeping
            failures.append((arch, shape, repr(e)))
            print(f"  FAILED: {e}")
            traceback.print_exc()
    print(f"\n{len(pairs) - len(failures)}/{len(pairs)} combinations "
          f"traced on {mesh_name}")
    if failures:
        for a, s, e in failures:
            print(f"  FAIL {a} x {s}: {e}")
        sys.exit(1)


if __name__ == "__main__":
    main()
