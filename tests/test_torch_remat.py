"""The ``"full"`` and ``"dots"`` remat policies of the training step, and
B5's and B6's forwards as ``torch.library`` operators, against ``"none"``
and the JAX package on the CPU.

Reduced hymba-1.5b and phi3-mini-3.8b in fp32 from the reference's init:
one sgd step at lr 1 gives each leaf's gradient; under ``"full"`` and
``"dots"`` it is held within 1e-6 of ``"none"``'s (of each leaf's scale)
and within the LM path's 2e-4 of the reference's same-policy
``make_train_step``.  Under ``"dots"`` the products are kept and B5 and B6
run again in the backward, as the reference keeps only products
(``launch/steps.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.data import lm_data as jdata
from repro.launch import steps as jsteps
from repro.optim import optimizers as joptim
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tsteps
from repro_torch.optim import optimizers as toptim
from torch_lm_zoo_common import batch_j, batch_t, dev, model, pairs

ARCHS = ["hymba-1.5b", "phi3-mini-3.8b"]


@functools.lru_cache(maxsize=None)
def _case(arch):
    jc, tc, jp, tp = model(arch, seed=4)
    batch = jdata.synthetic_lm_batch(jc, 2, 40, seed=5)
    return jc, tc, jp, tp, batch


def _port_grads(arch, remat):
    """Each leaf's gradient (one sgd step at lr 1) and the loss."""
    _, tc, _, tp, batch = _case(arch)
    step = tsteps.make_train_step(tc, toptim.sgd(1.0), dtype=torch.float32,
                                  remat=remat)
    new, _, loss = step(tp, {}, batch_t(batch), 0)
    return toptim.tree_map(lambda p, n: p - n, tp, new), loss


@functools.lru_cache(maxsize=None)
def _none_grads(arch):
    return _port_grads(arch, "none")


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_none_and_reference(arch, policy):
    jc, _, jp, _, batch = _case(arch)
    grads, loss = _port_grads(arch, policy)
    none, none_loss = _none_grads(arch)
    to_none = max(dev(g, n) for g, n in zip(toptim.tree_leaves(grads),
                                           toptim.tree_leaves(none)))
    jstep = jax.jit(jsteps.make_train_step(jc, joptim.sgd(1.0),
                                           dtype=jnp.float32, remat=policy))
    jnew, _, jloss = jstep(jp, {}, batch_j(batch), 0)
    jgrads = jax.tree_util.tree_map(lambda p, n: p - n, jp, jnew)
    to_ref = {path: dev(g, w) for path, w, g in pairs(jgrads, grads)}
    worst = max(to_ref, key=to_ref.get)
    print(f"{arch} remat={policy}: loss {float(loss)} (none "
          f"{float(none_loss)}, reference {float(jloss)}); gradients "
          f"{to_none:.3e} of none's, {to_ref[worst]:.3e} of the "
          f"reference's ({worst})")
    assert abs(float(loss) - float(none_loss)) <= 1e-6 * abs(float(loss))
    assert to_none <= 1e-6
    assert len(to_ref) == len(toptim.tree_leaves(grads))
    assert max(to_ref.values()) <= 2e-4
    assert abs(float(loss) - float(jloss)) <= 2e-4 * abs(float(jloss))


class _Calls(TorchDispatchMode):
    """Counts the operators a step runs (replayed saved outputs do not
    run, so they are not counted)."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_products_and_runs_the_kernels_again():
    """Reduced phi3 (2 layers): without remat B5 runs once a layer forward
    and its backward once; ``"full"`` and ``"dots"`` run the forward
    twice (the backward's recomputation).  ``"full"`` runs every product
    of the forward again, ``"dots"`` none of them."""
    _, tc, _, tp, batch = _case("phi3-mini-3.8b")
    calls = {}
    for remat in ("none", "full", "dots"):
        step = tsteps.make_train_step(tc, toptim.sgd(1.0),
                                      dtype=torch.float32, remat=remat)
        with _Calls() as mode:
            step(tp, {}, batch_t(batch), 0)
        calls[remat] = mode.n
    layers = tc.num_layers
    for remat, fwd in (("none", layers), ("full", 2 * layers),
                       ("dots", 2 * layers)):
        assert calls[remat]["repro_torch.flash_attention"] == fwd, remat
        assert calls[remat]["repro_torch.flash_attention_bwd"] == layers
    products = ("aten.mm", "aten.bmm", "aten.addmm")

    def count(remat):
        return sum(calls[remat].get(p, 0) for p in products)
    print({r: count(r) for r in calls})
    assert count("dots") == count("none") < count("full")


def test_remat_runs_the_ssd_scan_again(monkeypatch):
    """Reduced hymba (2 layers): B6's forward runs once a layer without
    remat and twice under ``"full"`` and ``"dots"``.  Counted at its plain
    version's calls from the operator (a Python dispatch mode cannot watch
    the plain backward, a ``torch.func.vjp``; its own calls of the plain
    scan see functorch-wrapped tensors and are left out)."""
    _, tc, _, tp, batch = _case("hymba-1.5b")
    plain = ref.ssd_scan_ref
    runs = []

    def counted(x, *args, **kwargs):
        if not torch._C._functorch.is_functorch_wrapped_tensor(x):
            runs.append(1)
        return plain(x, *args, **kwargs)
    monkeypatch.setattr(ref, "ssd_scan_ref", counted)
    for remat, fwd in (("none", 1), ("full", 2), ("dots", 2)):
        runs.clear()
        step = tsteps.make_train_step(tc, toptim.sgd(1.0),
                                      dtype=torch.float32, remat=remat)
        step(tp, {}, batch_t(batch), 0)
        assert len(runs) == fwd * tc.num_layers, remat


# ---------------------------------------------------------------------------
# the forward operators: fake implementations and unchanged bits
# ---------------------------------------------------------------------------
def _attention_inputs(g, b=2, s=40, h=4, hkv=2, d=16, dv=16):
    def r(*shape):
        return torch.tensor(g.standard_normal(shape), dtype=torch.float32)
    return r(b, s, h, d), r(b, s, hkv, d), r(b, s, hkv, dv)


def _ssd_inputs(g, b=2, s=40, h=3, p=8, n=4):
    def r(*shape, lo=None, hi=None):
        x = g.standard_normal(shape) if lo is None \
            else g.uniform(lo, hi, shape)
        return torch.tensor(x, dtype=torch.float32)
    return (r(b, s, h, p), r(b, s, h, lo=0.01, hi=0.2), r(h, lo=-2, hi=-0.5),
            r(b, s, n), r(b, s, n), r(b, h, p, n))


@pytest.mark.parametrize("want_lse", [True, False])
@pytest.mark.parametrize("dims", [(16, 16), (24, 16)])
def test_flash_operator_fake_and_autograd(dims, want_lse):
    g = np.random.default_rng(1)
    q, k, v = _attention_inputs(g, d=dims[0], dv=dims[1])
    pos = torch.arange(40)[None].expand(2, 40) - torch.tensor([[0], [7]])
    for q_pos in (None, pos):
        args = (q, k, v, True, 8, 0.25, q_pos, q_pos, want_lse)
        torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                              args, test_utils=("test_schema",
                                                "test_faketensor"))
        out, lse = torch.ops.repro_torch.flash_attention(*args)
        want = ref.flash_attention_fwd_ref(q, k, v, causal=True, window=8,
                                           scale=0.25, q_pos=q_pos,
                                           k_pos=q_pos)
        assert torch.equal(out, want[0])
        assert torch.equal(lse, want[1]) if want_lse else lse.numel() == 0
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal=True, scale=0.25)
    dout = torch.randn_like(out)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_bwd.default,
                          (q, k, v, out, lse, dout, True, 0, 0.25),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("keep_states", [True, False])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_operator_fake_and_autograd(chunk, keep_states):
    g = np.random.default_rng(2)
    x, dt, a, b, c, h0 = _ssd_inputs(g)
    for start in (None, h0):
        args = (x, dt, a, b, c, chunk, start, keep_states)
        torch.library.opcheck(torch.ops.repro_torch.ssd_scan.default, args,
                              test_utils=("test_schema", "test_faketensor"))
        y, h_last, states = torch.ops.repro_torch.ssd_scan(*args)
        want = ref.ssd_scan_ref(x, dt, a, b, c, chunk, start)
        assert torch.equal(y, want[0]) and torch.equal(h_last, want[1])
        nc = -(-40 // chunk)
        assert tuple(states.shape) == ((2, 3, nc, 8, 4) if keep_states
                                       else (0,))
        if keep_states:
            # the state entering each chunk: chunk 0's is the start
            first = torch.zeros_like(h_last) if start is None else start
            assert torch.equal(states[:, :, 0], first)
    # the plain backward differentiates the plain scan with torch.func,
    # which opcheck's dispatch modes would break: its fake implementation
    # is held to it by hand
    from torch._subclasses.fake_tensor import FakeTensorMode
    args = (x, dt, a, b, c, torch.randn_like(x), x.new_empty((0,)), None,
            chunk, h0)
    real = torch.ops.repro_torch.ssd_scan_bwd(*args)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = torch.ops.repro_torch.ssd_scan_bwd(*args)
    assert [(t.shape, t.dtype, t.stride()) for t in real] == \
        [(t.shape, t.dtype, t.stride()) for t in fake]


def test_wrappers_give_the_operators_the_kernels_operands():
    """Whatever the device, the public wrappers hand B5's and B6's
    operators the operands the kernels read (int32 positions, fp32
    ``dt``/``a``/``h0``, B6's chunk states kept when a gradient is
    needed), so that a dry run of fake CPU tensors sizes the card's
    calls; the plain versions give the same bits on them."""
    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "repro_torch":
                self.calls.append((func.__name__, args))
            return func(*args, **(kwargs or {}))

    g = np.random.default_rng(3)
    q, k, v = _attention_inputs(g)
    pos = torch.arange(40)[None].expand(2, 40) - torch.tensor([[0], [7]])
    x, dt, a, b, c, h0 = _ssd_inputs(g)
    bf = torch.bfloat16
    for grad in (False, True):
        qs = [t.clone().requires_grad_(grad) for t in (q, k, v)]
        xs = [t.clone().requires_grad_(grad) for t in (x, b, c)]
        with Seen() as seen:
            out = ops.flash_attention(*qs, causal=True, window=8, scale=0.25,
                                      q_pos=pos, k_pos=pos)
            y, h_last = ops.ssd_scan(xs[0], dt.to(bf), a.to(bf), *xs[1:],
                                     chunk=8, h0=h0.to(bf))
        (_, fa), (_, sa) = seen.calls
        assert [t.dtype for t in fa[6:8]] == [torch.int32] * 2
        assert [t.dtype for t in (sa[1], sa[2], sa[6])] == [torch.float32] * 3
        # the dispatcher drops an argument left at its default
        assert (sa[7] if len(sa) > 7 else False) is grad
        want = ref.flash_attention_fwd_ref(q, k, v, causal=True, window=8,
                                           scale=0.25, q_pos=pos, k_pos=pos)
        assert torch.equal(out, want[0])
        want = ref.ssd_scan_ref(x, dt.to(bf), a.to(bf), b, c, 8, h0.to(bf))
        assert torch.equal(y, want[0]) and torch.equal(h_last, want[1])
