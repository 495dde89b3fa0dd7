"""Launch sizing in the port against the JAX package, on the CPU: the shape
table, the analytic cost model, the partition rules on every assigned
arch at full width, DTensor placements on a fake 16x16 mesh, the ring
byte model of the collectives, FLOPs counted on a traced step, and the
dry run's ``lower_pair`` on a fake 2x2 mesh.

Full-width trees cost nothing here: the reference's come from
``jax.eval_shape``, the port's are meta tensors
(``transformer.init_param_shapes``, ``launch.steps.input_specs``).  A
process's fake process group is its own, so the tests that build a
``DeviceMesh`` run in a subprocess each.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import analysis as janalysis
from repro.launch import analytic as janalytic
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.parallel import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.kernels import ops
from repro_torch.launch import analysis, analytic, steps
from repro_torch.models import transformer as ttfm
from repro_torch.parallel import sharding

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

ARCHS = list(jconfigs.ASSIGNED_ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _run(code: str) -> dict:
    """``code`` in a fresh interpreter (its own fake process group); the
    JSON object its last line prints."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the shape table and the registry
# ---------------------------------------------------------------------------
def test_shape_table_equals_reference():
    assert list(tconfigs.INPUT_SHAPES) == list(jconfigs.INPUT_SHAPES)
    for name, js in jconfigs.INPUT_SHAPES.items():
        ts = tconfigs.get_shape(name)
        assert (ts.name, ts.seq_len, ts.global_batch, ts.mode) == \
            (js.name, js.seq_len, js.global_batch, js.mode)
    for const in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert getattr(tconfigs, const) == tconfigs.get_shape(
            getattr(jconfigs, const).name)
    assert list(tconfigs.ASSIGNED_ARCHS) == list(jconfigs.ASSIGNED_ARCHS)
    assert list(tconfigs.PAPER_ARCHS) == list(jconfigs.PAPER_ARCHS)
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    for arch in jconfigs.ARCHS:
        assert tconfigs.applicable_shapes(tconfigs.get_config(arch)) == \
            jconfigs.applicable_shapes(jconfigs.get_config(arch))
    with pytest.raises(KeyError, match="unknown input shape"):
        tconfigs.get_shape("train_8k")
    run = {k: v for k, v in tbase.asdict(tconfigs.RunConfig()).items()
           if k not in ("federated", "rounds")}
    want = {k: v for k, v in jconfigs.base.asdict(
        jconfigs.RunConfig()).items() if k not in ("federated", "rounds")}
    assert run == want
    assert steps.LONG_CONTEXT_WINDOW == jsteps.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_and_input_specs_equal_reference(arch):
    """``resolve_arch_for_shape`` field for field, and ``input_specs``'
    shapes and dtypes (the decode cache's too) leaf for leaf."""
    for name in jconfigs.applicable_shapes(jconfigs.get_config(arch)):
        jcfg = jsteps.resolve_arch_for_shape(jconfigs.get_config(arch),
                                             jconfigs.get_shape(name))
        tcfg = steps.resolve_arch_for_shape(tconfigs.get_config(arch),
                                            tconfigs.get_shape(name))
        assert (tcfg.sliding_window, tcfg.max_seq_len) == \
            (jcfg.sliding_window, jcfg.max_seq_len)
        want = _flat_ref(jsteps.input_specs(jcfg, jconfigs.get_shape(name)))
        got = _flat_port(steps.input_specs(tcfg, tconfigs.get_shape(name)))
        assert set(got) == set(want), name
        for path, leaf in got.items():
            ref = want[path]
            if path.endswith("pos"):
                continue       # the reference's int32 scalar; the port's int
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(ref.shape), (name, path)
            assert str(leaf.dtype).split(".")[-1] == \
                {"bool": "bool"}.get(str(ref.dtype), str(ref.dtype)), path


# ---------------------------------------------------------------------------
# the analytic model: the reference's numbers exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_estimate_equals_reference(arch):
    for name in jconfigs.applicable_shapes(jconfigs.get_config(arch)):
        jshape, tshape = jconfigs.get_shape(name), tconfigs.get_shape(name)
        for absorb in (False, True):
            jcfg = jsteps.resolve_arch_for_shape(jconfigs.get_config(arch),
                                                 jshape)
            tcfg = steps.resolve_arch_for_shape(tconfigs.get_config(arch),
                                                tshape)
            if absorb:
                jcfg = dataclasses.replace(jcfg, mla_absorb=True)
                tcfg = dataclasses.replace(tcfg, mla_absorb=True)
            want = janalytic.estimate(jcfg, jshape)
            got = analytic.estimate(tcfg, tshape)
            assert (got.flops, got.bytes, got.param_bytes) == \
                (want.flops, want.bytes, want.param_bytes), (name, absorb)
            for chips, ways in ((256, None), (256, 16), (512, None)):
                w, g = want.per_device(chips, param_ways=ways), \
                    got.per_device(chips, param_ways=ways)
                assert (g.flops, g.bytes, g.param_bytes) == \
                    (w.flops, w.bytes, w.param_bytes)


# ---------------------------------------------------------------------------
# partition specs: every assigned arch at full width, leaf for leaf
# ---------------------------------------------------------------------------
def _path_str(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _flat_ref(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_path_str(p): v for p, v in leaves}


def _flat_port(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, prefix + (str(k),)))
        return out
    if isinstance(tree, list) and not isinstance(tree, sharding.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_port(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _unit_free(port_specs: dict) -> dict:
    """Port paths ``layers/<i>/...`` -> the reference's ``layers/...``;
    every unit must carry the same spec."""
    out = {}
    for path, spec in port_specs.items():
        ref = sharding._reference_path(path)
        assert out.setdefault(ref, tuple(spec)) == tuple(spec), path
    return out


def _ref_param_specs(jspecs: dict) -> dict:
    """The reference's specs with a stacked leaf's leading ``None``
    dropped (the port keeps a unit's leaves unstacked)."""
    return {p: tuple(s)[1:] if p.startswith("layers/") else tuple(s)
            for p, s in jspecs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_equal_reference(arch):
    """Params, batch (train, prefill) and decode cache, on the 16x16 and
    2x16x16 meshes under every profile."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jparams = jax.eval_shape(
        lambda: jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = ttfm.init_param_shapes(tcfg)
    checked = 0
    try:
        for sizes, names in MESHES.values():
            jmesh = AbstractMesh(sizes, names)
            tmesh = sharding.FedMesh((torch.device("cpu"),)
                                     * int(np.prod(sizes)), names, sizes)
            for profile in sharding.PROFILES:
                jsharding.set_profile(profile)
                sharding.set_profile(profile)
                want = _ref_param_specs(_flat_ref(
                    jsharding.param_partition_specs(jcfg, jmesh, jparams)))
                got = _unit_free(_flat_port(
                    sharding.param_partition_specs(tcfg, tmesh, tparams)))
                assert got == want, (names, profile)
                for name in jconfigs.applicable_shapes(jcfg):
                    jshape = jconfigs.get_shape(name)
                    jc = jsteps.resolve_arch_for_shape(jcfg, jshape)
                    tc = steps.resolve_arch_for_shape(
                        tcfg, tconfigs.get_shape(name))
                    jspec = jsteps.input_specs(jc, jshape)
                    tspec = steps.input_specs(tc, tconfigs.get_shape(name))
                    if jshape.mode == "decode":
                        want = {p: tuple(s) for p, s in _flat_ref(
                            jsharding.cache_partition_specs(
                                jc, jmesh, jspec["cache"])).items()}
                        got = {p: tuple(s) for p, s in _flat_port(
                            sharding.cache_partition_specs(
                                tc, tmesh, tspec["cache"])).items()}
                    else:
                        want = {p: tuple(s) for p, s in _flat_ref(
                            jsharding.batch_partition_spec(
                                jc, jmesh, jspec)).items()}
                        got = {p: tuple(s) for p, s in _flat_port(
                            sharding.batch_partition_spec(
                                tc, tmesh, tspec)).items()}
                    assert got == want, (names, profile, name)
                    checked += 1
    finally:
        jsharding.set_profile("megatron")
        sharding.set_profile("megatron")
    assert checked == 2 * 3 * len(jconfigs.applicable_shapes(jcfg))


def test_init_param_shapes_match_init_params():
    """The dry run's shape-only tree is ``init_params``' tree (reduced
    configs, both dtypes): the same leaves, shapes and dtypes."""
    from repro_torch.core import prng
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch).reduced()
        for dtype in (None, torch.bfloat16):
            real = _flat_port(ttfm.init_params(prng.PRNGKey(0), cfg,
                                               dtype=dtype))
            meta = _flat_port(ttfm.init_param_shapes(cfg, dtype=dtype))
            assert list(real) == list(meta)
            for k in real:
                assert (real[k].shape, real[k].dtype) == \
                    (meta[k].shape, meta[k].dtype), (arch, k)
                assert meta[k].device.type == "meta"


# ---------------------------------------------------------------------------
# DTensor placements on a fake 16x16 mesh: local shards are shape / ways
# ---------------------------------------------------------------------------
def test_shardings_for_local_shards_on_a_fake_mesh():
    got = _run("""
        import dataclasses, json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import distribute_tensor
        from repro_torch import configs
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import transformer as tfm
        from repro_torch.parallel import sharding

        mesh = make_production_mesh(device_type="cpu")
        sizes = {"data": 16, "model": 16}
        bad, n = [], 0

        def ways(entry):
            if entry is None:
                return 1
            names = entry if isinstance(entry, tuple) else (entry,)
            out = 1
            for a in names:
                out *= sizes[a]
            return out

        def check(path, leaf, spec):
            global n
            pl = sharding.placements(mesh, spec)
            with FakeTensorMode():
                full = torch.empty(leaf.shape, dtype=leaf.dtype)
                local = distribute_tensor(full, mesh, pl,
                                          src_data_rank=None).to_local()
            want = [d // ways(e) for d, e in zip(
                leaf.shape, list(spec) + [None] * leaf.ndim)]
            n += 1
            if list(local.shape) != want:
                bad.append([path, list(local.shape), want])

        for profile in ("megatron", "fsdp", "tp"):
            sharding.set_profile(profile)
            for arch in ("hymba-1.5b", "qwen3-moe-235b-a22b"):
                # full width; two layers stand for the rest
                cfg = dataclasses.replace(configs.get_config(arch),
                                          num_layers=2)
                tree = tfm.init_param_shapes(cfg)
                specs = sharding.param_partition_specs(cfg, mesh, tree)
                leaves, sp = [], []
                def walk(t, s, p=""):
                    if isinstance(t, dict):
                        for k in t:
                            walk(t[k], s[k], p + "/" + k)
                    elif isinstance(t, list):
                        for i, (a, b) in enumerate(zip(t, s)):
                            walk(a, b, p + "/" + str(i))
                    else:
                        check(arch + p, t, s)
                walk(tree, specs)
        # a tuple entry out of mesh order: DTensor nests the splits in mesh
        # order, the local sizes are the same
        leaf = torch.empty((4096, 64), device="meta")
        check("reversed", leaf, sharding.P(("model", "data")))
        check("in order", leaf, sharding.P(("data", "model")))
        print(json.dumps({"bad": bad, "n": n}))
        """)
    assert got["n"] > 100
    assert got["bad"] == []


# ---------------------------------------------------------------------------
# collectives: the ring byte model, on hand-built HLO and on a traced step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opcode", ["all-reduce", "all-gather",
                                    "reduce-scatter", "all-to-all",
                                    "collective-permute"])
@pytest.mark.parametrize("group", [2, 4, 16])
def test_ring_byte_model_equals_reference(opcode, group):
    line = (f"  %c = bf16[64,48]{{1,0}} {opcode}(bf16[64,48]{{1,0}} %p), "
            f"replica_groups=[{512 // group},{group}]<=[512]")
    want = janalysis.parse_collective_bytes(line)
    assert want[opcode] > 0
    assert int(analysis.wire_bytes(opcode, 64 * 48 * 2, group)) == \
        want[opcode]


def test_step_trace_counts_collectives_and_storage():
    got = _run("""
        import json, torch
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch import analysis
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        group = dist.group.WORLD
        x = torch.ones(8, 16)
        trace = analysis.StepTrace(inputs={"x": x})
        with trace:
            view = x.t()[1:]        # an input's view: no storage of its own
            a = funcol.all_gather_tensor(x, 0, group).wait()   # (32, 16)
            r = funcol.all_reduce(x, "sum", group).wait()
            s = funcol.reduce_scatter_tensor(x, "sum", 0, group).wait()
            t = funcol.all_to_all_single(x, None, None, group).wait()
            keep = torch.empty(1024)
            del a, r, s, t
        print(json.dumps({"bytes": trace.breakdown(),
                          "counts": trace.counts, "peak": trace.peak,
                          "live": trace.live}))
        """)
    b = 8 * 16 * 4
    want = {"all-gather": int(4 * b * 3 / 4), "all-reduce": int(2 * b * 3 / 4),
            "reduce-scatter": int(b / 4 * 3), "all-to-all": int(b * 3 / 4)}
    for op, v in want.items():
        assert got["bytes"][op] == v, op
        assert got["counts"][op] == 1
    assert got["bytes"]["total"] == sum(want.values())
    # the four results and the kept 4 KiB buffer were live at once; the
    # input's view, still alive, counts nothing
    assert got["peak"] >= 4 * b + 2 * b + b // 4 + 4096
    assert got["live"] == 4096


# ---------------------------------------------------------------------------
# FLOPs: the analytic model within the reference's band of a counted step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,mode", [
    ("phi3-mini-3.8b", "train"),
    ("phi3-mini-3.8b", "prefill"),
    ("granite-34b", "train"),
    ("minicpm3-4b", "prefill"),
])
def test_analytic_flops_close_to_flop_counter(arch, mode):
    """``tests/test_analytic.py``'s pairs: the closed form over the FLOPs
    ``FlopCounterMode`` counts on the port's step (B5 and B6 by their
    registered formulas), within 0.65-1.6."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.optim import optimizers
    ops.register_flop_formulas()
    cfg = tconfigs.get_config(arch).reduced()
    shape = tbase.ShapeConfig("tiny", seq_len=128, global_batch=2, mode=mode)
    params = ttfm.init_param_shapes(cfg, device="cpu")
    params = optimizers.tree_map(torch.zeros_like, params)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in steps.input_specs(cfg, shape).items()}
    counter = FlopCounterMode(display=False)
    with counter:
        if mode == "train":
            steps.make_train_step(cfg, optimizers.sgd(1e-2))(params, {},
                                                              batch, 0)
        else:
            steps.make_prefill_step(cfg)(params, batch)
    counted = counter.get_total_flops()
    est = analytic.estimate(cfg, shape).flops
    print(f"{arch} {mode}: analytic {est:.4e}, counted {counted:.4e}, "
          f"ratio {est / counted:.3f}")
    assert 0.65 < est / counted < 1.6


# ---------------------------------------------------------------------------
# the dry run on a fake 2x2 mesh
# ---------------------------------------------------------------------------
def test_lower_pair_on_a_fake_mesh():
    """A dense and a MoE arch, reduced, through ``lower_pair`` on a fake
    (2, 2) mesh: every key of the reference's report, finite terms, the
    memory of the full-depth run, collectives counted; and the two-unit
    extrapolation equal to the full depth's own count (linear in depth)."""
    got = _run("""
        import dataclasses, json
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch import configs
        from repro_torch.launch import dryrun
        from repro_torch.parallel import sharding
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {}
        for arch, shape in (("phi3-mini-3.8b", "train_4k"),
                            ("qwen3-moe-235b-a22b", "decode_32k")):
            cfg = configs.get_config(arch).reduced()
            rep = dryrun.lower_pair(arch, shape, mesh, cfg=cfg,
                                    verbose=False)
            out[arch] = rep.to_dict()
        # four units: the extrapolation from one and two against the run
        deep = dataclasses.replace(
            configs.get_config("phi3-mini-3.8b").reduced(), num_layers=4)
        rep = dryrun.lower_pair("phi3-mini-3.8b", "train_4k", mesh,
                                cfg=deep, verbose=False)
        with sharding.use_abstract_mesh(mesh):
            full = dryrun._run_step(deep, configs.get_shape("train_4k"),
                                    mesh)[0].breakdown()["total"]
        out["extrapolated"] = [rep.collective_bytes, full]
        print(json.dumps(out))
        """)
    keys = {"arch", "shape", "mesh", "chips", "hlo_flops_per_device",
            "hlo_bytes_per_device", "collective_bytes_per_device",
            "collective_breakdown", "model_flops", "compute_s", "memory_s",
            "collective_s", "bottleneck", "useful_flops_ratio",
            "memory_per_device"}
    for arch in ("phi3-mini-3.8b", "qwen3-moe-235b-a22b"):
        rep = got[arch]
        assert keys <= set(rep), arch
        assert rep["mesh"] == "2x2" and rep["chips"] == 4
        for k in ("compute_s", "memory_s", "collective_s"):
            assert np.isfinite(rep[k]) and rep[k] > 0, (arch, k)
        mem = rep["memory_per_device"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["total_bytes"] >= mem["argument_size_in_bytes"]
        assert rep["collective_breakdown"]["total"] > 0
    est, full = got["extrapolated"]
    assert est == pytest.approx(full, rel=1e-9)


def test_size_step_sizes_one_device_unsharded():
    """``dryrun.size_step``: one device's whole step on fake tensors, no
    mesh.  Its arguments are the real tree's bytes and the batch's, its
    outputs the new parameters and the loss, and its temp the step's own
    peak over them: the arguments' views (the parameters' storages)
    count nothing.  ``chip_smoke.py`` holds the total to a card's
    ``max_memory_allocated`` for the same step at full width."""
    from repro_torch.core import prng
    from repro_torch.launch import dryrun
    cfg = tconfigs.get_config("hymba-1.5b").reduced()
    shape = dataclasses.replace(tconfigs.get_shape("train_4k"),
                                global_batch=2, seq_len=64)
    mem = dryrun.size_step(cfg, shape)
    params = analysis.local_bytes(ttfm.init_params(prng.PRNGKey(0), cfg))
    # tokens and labels int32, loss_mask fp32: (2, 64) each
    assert mem["argument_size_in_bytes"] == params + 3 * 2 * 64 * 4
    assert mem["output_size_in_bytes"] == params + 4
    # at the peak the gradients (one more copy of the parameters) and
    # the activations the backward reads are live, and no view of an
    # argument: the peak is under one copy of the arguments more
    assert params < mem["temp_size_in_bytes"] < 2 * params
    assert mem["total_bytes"] == sum(mem[k] for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"))
