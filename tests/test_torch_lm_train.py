"""The port's LM training slice against the JAX package, at reduced width.

The same numpy inputs go through the reference and the port in fp32:
the synthetic token pipeline (bitwise), the losses (1e-6), the plain
backward passes of B5 and B6 against ``jax.vjp`` of the reference's
``chunked_attention`` and ``ssd_chunked`` (2e-5 and 1e-4, abs + rel),
the two autograd Functions on CPU tensors against autograd through the
plain forwards, ``train_loss`` and every gradient leaf against
``jax.value_and_grad`` on the three reduced configs (2e-4 of each
leaf's scale, the ROADMAP anchor), three ``make_train_step`` steps of
sgd and adam (2e-4), and the launcher.  The reference's init trees are
carried into the port with ``params_from_reference``.  Run with ``-s``
to print every measured deviation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import lm_data as jdata
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro.models.layers import attention as jattn
from repro.models.layers import mamba2 as jmamba
from repro.optim import optimizers as joptim
from repro_torch import configs as tconfigs
from repro_torch.data import lm_data as tdata
from repro_torch.kernels import flash_attention, ops, ref, ssd_scan
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as toptim

ARCHS = ["hymba-1.5b", "mamba2-1.3b", "phi3-mini-3.8b"]


def _reduced(arch):
    return jget_config(arch).reduced(), tconfigs.get_config(arch).reduced()


def _model(arch, seed=1):
    jc, tc = _reduced(arch)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jc)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jc, tc, jp, ttfm.params_from_reference(tree, tc)


def _dev(got, want) -> float:
    """max |got - want| / max(max |want|, 1)."""
    got = got.detach().to(torch.float32).numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1.0))


def _close(got, want, tol):
    """|got - want| <= tol + tol |want| elementwise."""
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return bool(np.all(np.abs(got - want) <= tol + tol * np.abs(want)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch_t(batch):
    return {k: _t(v) for k, v in batch.items()}


def _batch_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pairs(jtree, ttree, path=""):
    """(path, reference leaf, port leaf) over the reference tree, whose
    ``layers`` are stacked on a leading axis and the port's a list."""
    out = []
    for k, v in jtree.items():
        if k == "layers":
            for i, lp in enumerate(ttree["layers"]):
                sub = jax.tree_util.tree_map(lambda a: a[i], v)
                out += _pairs(sub, lp, f"{path}layers[{i}].")
        elif isinstance(v, dict):
            out += _pairs(v, ttree[k], f"{path}{k}.")
        else:
            out.append((path + k, v, ttree[k]))
    return out


# ---------------------------------------------------------------------------
# data: bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,client_id,num_clients",
                         [(0, 0, 1), (3, 1, 4), (7, 3, 4), (11, 0, 2)])
def test_synthetic_lm_batch_bitwise(arch, seed, client_id, num_clients):
    jc, tc = _reduced(arch)
    want = jdata.synthetic_lm_batch(jc, 3, 33, seed=seed,
                                    client_id=client_id,
                                    num_clients=num_clients)
    got = tdata.synthetic_lm_batch(tc, 3, 33, seed=seed,
                                   client_id=client_id,
                                   num_clients=num_clients)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("num_clients", [1, 2, 4])
def test_synthetic_lm_stream_bitwise(num_clients):
    jc, tc = jget_config("hymba-1.5b"), tconfigs.get_config("hymba-1.5b")
    js = jdata.SyntheticLMStream(jc, 4, 40, num_clients=num_clients, seed=5)
    ts = tdata.SyntheticLMStream(tc, 4, 40, num_clients=num_clients, seed=5)
    for _ in range(3):
        want, got = next(js), next(ts)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,nodes", [(0, 1), (2, 3), (9, 5)])
def test_lm_corpus_bitwise(seed, nodes):
    want = jdata.generate_lm_corpus(300, nodes, 6, 17, val_docs_per_node=2,
                                    seed=seed)
    got = tdata.generate_lm_corpus(300, nodes, 6, 17, val_docs_per_node=2,
                                   seed=seed)
    assert got.num_nodes == want.num_nodes == nodes
    for a, b in zip(got.node_tokens, want.node_tokens):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.val_tokens, want.val_tokens)
    np.testing.assert_array_equal(got.concat_tokens(), want.concat_tokens())
    for k, v in jdata.lm_client_data(want.node_tokens[0]).items():
        np.testing.assert_array_equal(
            tdata.lm_client_data(got.node_tokens[0])[k], v)


def test_lm_batch_for_audio_or_vlm_raises():
    import dataclasses
    tc = dataclasses.replace(tconfigs.get_config("hymba-1.5b").reduced(),
                             kind="vlm")
    with pytest.raises(NotImplementedError, match="A16b"):
        tdata.synthetic_lm_batch(tc, 1, 8)


# ---------------------------------------------------------------------------
# losses: 1e-6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_xent_loss_matches_reference(masked, rng):
    logits = (3 * rng.standard_normal((3, 17, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    mask = (rng.random((3, 17)) < 0.7).astype(np.float32) if masked else None
    js, jn = jtfm.xent_loss(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    ts, tn = ttfm.xent_loss(_t(logits), _t(labels),
                            None if mask is None else _t(mask))
    print(f"xent_loss masked={masked}: sum {float(ts)} vs {float(js)}")
    assert float(tn) == float(jn)
    assert abs(float(ts) - float(js)) <= 1e-6 * max(abs(float(js)), 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_sum_with_doc_mask_matches_reference(arch, rng):
    jc, tc, jp, tp = _model(arch)
    batch = jdata.synthetic_lm_batch(jc, 3, 40, seed=2)
    batch["loss_mask"] = (rng.random((3, 40)) < 0.8).astype(np.float32)
    batch["doc_mask"] = np.array([1.0, 0.0, 1.0], np.float32)
    js, jn = jtfm.train_loss_sum(jp, jc, _batch_j(batch), dtype=jnp.float32)
    ts, tn = ttfm.train_loss_sum(tp, tc, _batch_t(batch),
                                 dtype=torch.float32)
    jl = jtfm.train_loss(jp, jc, _batch_j(batch), dtype=jnp.float32)
    tl = ttfm.train_loss(tp, tc, _batch_t(batch), dtype=torch.float32)
    print(f"train_loss_sum {arch}: {float(ts)} vs {float(js)}, n "
          f"{float(tn)}; train_loss {float(tl)} vs {float(jl)}")
    assert float(tn) == float(jn)
    assert abs(float(ts) - float(js)) <= 1e-6 * abs(float(js))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))


# ---------------------------------------------------------------------------
# the plain backward passes against jax.vjp of the reference
# ---------------------------------------------------------------------------
B5_BWD = [  # (b, s, hq, hkv, d, causal, window)
    (2, 70, 4, 2, 32, True, 16),     # GQA, window, ragged over chunks
    (1, 64, 4, 4, 16, True, 0),      # causal
    (1, 37, 3, 1, 16, False, 0),     # full, MQA, ragged
    (2, 50, 6, 2, 32, False, 8),     # bidirectional window
    (1, 65, 5, 5, 32, True, 64),     # one past a chunk, window = chunk
]


@pytest.mark.parametrize("case", B5_BWD)
def test_flash_attention_bwd_ref_matches_jax_vjp(case, rng):
    b, s, hq, hkv, d, causal, window = case
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def f(q, k, v):
        return jattn.chunked_attention(q, k, v, pos, pos, causal=causal,
                                       window=window, scale=d ** -0.5,
                                       chunk=16)
    out, vjp = jax.vjp(f, q, k, v)
    want = vjp(jnp.asarray(dout))
    o, lse = ref.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal=causal,
                                         window=window)
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(dout),
                                      causal=causal, window=window, chunk=16)
    devs = [_dev(g, w) for g, w in zip(got, want)]
    print(f"B5 backward plain vs jax.vjp {case}: dq, dk, dv {devs}")
    assert _close(o, out, 2e-5)
    for g, w in zip(got, want):
        assert _close(g, w, 2e-5)


@pytest.mark.parametrize("case", B5_BWD[:3])
def test_flash_attention_fwd_ref_lse(case, rng):
    """The row log-sum-exp the backward recomputes from: the logsumexp
    of each row's masked scaled scores (B, H, S)."""
    b, s, hq, hkv, d, causal, window = case
    q = _t(rng.standard_normal((b, s, hq, d)).astype(np.float32))
    k = _t(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    v = _t(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    _, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                         window=window)
    kr = k.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr) * d ** -0.5
    pos = torch.arange(s)
    mask = torch.ones(s, s, dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    want = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), -1)
    assert lse.shape == (b, hq, s)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


SSD_BWD = [  # (b, s, h, p, n, chunk)
    (2, 64, 3, 8, 4, 16),     # exact chunks
    (1, 40, 2, 16, 8, 16),    # ragged tail (padded with dt = 0 steps)
    (1, 48, 2, 8, 16, 48),    # one chunk
    (1, 17, 2, 8, 4, 8),      # one past a chunk edge
    (2, 31, 1, 4, 2, 8),      # one short of a chunk edge
]


@pytest.mark.parametrize("case", SSD_BWD)
@pytest.mark.parametrize("with_h_last", [False, True])
def test_ssd_scan_bwd_ref_matches_jax_vjp(case, with_h_last, rng):
    b, s, h, p, n, chunk = case
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.01 + 0.5 * rng.random((b, s, h))).astype(np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32) * 0.5
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dh = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_h_last else np.zeros((b, h, p, n), np.float32)
    pad = -s % chunk

    def f(x, dt, a, bm, cm):
        # the reference pads a ragged tail with zero steps (mamba2_apply)
        padt = lambda t: jnp.pad(t, [(0, 0), (0, pad)]  # noqa: E731
                                 + [(0, 0)] * (t.ndim - 2))
        y, hl = jmamba.ssd_chunked(padt(x), padt(dt), a, padt(bm), padt(cm),
                                   chunk)
        return y[:, :s], hl
    _, vjp = jax.vjp(f, x, dt, a, bm, cm)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ref.ssd_scan_bwd_ref(_t(x), _t(dt), _t(a), _t(bm), _t(cm), _t(dy),
                               _t(dh) if with_h_last else None, chunk)
    devs = [_dev(g, w) for g, w in zip(got, want)]
    print(f"B6 backward plain vs jax.vjp {case} h_last={with_h_last}: dx, "
          f"ddt, da, db, dc {devs}")
    for g, w in zip(got, want):
        assert _close(g, w, 1e-4)


# ---------------------------------------------------------------------------
# the autograd Functions on CPU tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["backward", "func_grad"])
@pytest.mark.parametrize("case", B5_BWD[:3])
def test_flash_attention_function_grads_on_cpu(case, mode, rng):
    b, s, hq, hkv, d, causal, window = case
    # q, k, v as strided slices of one fused projection, as on the model
    # path
    fused = _t(rng.standard_normal((b, s, hq + 2 * hkv, d))
               .astype(np.float32))
    cot = _t(rng.standard_normal((b, s, hq, d)).astype(np.float32))

    def kernel(f):
        q, k, v = f.split([hq, hkv, hkv], dim=2)
        return torch.sum(ops.flash_attention(q, k, v, causal=causal,
                                             window=window) * cot)

    def plain(f):
        q, k, v = (t.transpose(1, 2) for t in f.split([hq, hkv, hkv], dim=2))
        out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        return torch.sum(out.transpose(1, 2) * cot)
    want = torch.func.grad(plain)(fused)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    if mode == "func_grad":
        got = torch.func.grad(kernel)(fused)
    else:
        leaf = fused.clone().requires_grad_(True)
        kernel(leaf).backward()
        got = leaf.grad
    assert (flash_attention.launches, flash_attention.bwd_launches) == before
    print(f"_FlashAttention {mode} {case}: {_dev(got, want.numpy())}")
    assert _close(got, want.numpy(), 2e-5)


@pytest.mark.parametrize("mode", ["backward", "func_grad"])
@pytest.mark.parametrize("case", SSD_BWD[:2])
def test_ssd_scan_function_grads_on_cpu(case, mode, rng):
    b, s, h, p, n, chunk = case
    conv = _t(rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32))
    dt = _t((0.01 + 0.5 * rng.random((b, s, h))).astype(np.float64))
    a = -torch.arange(1.0, h + 1.0)
    cy = _t(rng.standard_normal((b, s, h, p)).astype(np.float32))
    ch = _t(rng.standard_normal((b, h, p, n)).astype(np.float32))

    def run(fn, conv, dt, a):
        xs, bm, cm = conv.split([h * p, n, n], dim=-1)
        y, hl = fn(xs.reshape(b, s, h, p), dt, a, bm, cm)
        return torch.sum(y * cy) + torch.sum(hl * ch)

    def kernel(*args):
        return run(lambda *t: ops.ssd_scan(*t, chunk=chunk), *args)

    def plain(conv, dt, a):
        return run(lambda x, d, aa, bm, cm: ref.ssd_scan_ref(
            x, d.to(torch.float32), aa, bm, cm, chunk), conv, dt, a)
    want = torch.func.grad(plain, argnums=(0, 1, 2))(conv, dt, a)
    before = (ssd_scan.launches, ssd_scan.bwd_launches)
    if mode == "func_grad":
        got = torch.func.grad(kernel, argnums=(0, 1, 2))(conv, dt, a)
    else:
        leaves = [t.clone().requires_grad_(True) for t in (conv, dt, a)]
        kernel(*leaves).backward()
        got = [t.grad for t in leaves]
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == before
    # dt reaches the Function through its cast to fp32: its gradient
    # comes back in dt's own dtype (fp64 here)
    assert got[1].dtype == torch.float64
    print(f"_SSDScan {mode} {case}: "
          f"{[_dev(g, w.numpy()) for g, w in zip(got, want)]}")
    for g, w in zip(got, want):
        assert _close(g, w.numpy(), 1e-4)


def test_ssd_scan_function_with_unused_h_last(rng):
    """Only y reaches the loss (the model path drops h_last): the
    backward takes a zero cotangent for it."""
    x, bm, cm = (_t(rng.standard_normal(s).astype(np.float32))
                 for s in ((1, 24, 2, 8), (1, 24, 4), (1, 24, 4)))
    dt = _t((0.01 + 0.5 * rng.random((1, 24, 2))).astype(np.float32))
    a = -torch.arange(1.0, 3.0)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm)]
    y, _ = ops.ssd_scan(*leaves, chunk=8)
    y.sum().backward()
    want = torch.func.grad(lambda *t: ref.ssd_scan_ref(*t, 8)[0].sum(),
                           argnums=(0, 1, 2, 3, 4))(x, dt, a, bm, cm)
    for leaf, w in zip(leaves, want):
        assert _close(leaf.grad, w.numpy(), 1e-4)


# ---------------------------------------------------------------------------
# train_loss and its gradients: 2e-4 of each leaf's scale
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    jc, tc, jp, tp = _model(arch, seed=3)
    batch = jdata.synthetic_lm_batch(jc, 2, 70, seed=4)  # ragged chunks
    jl, jg = jax.value_and_grad(
        lambda p: jtfm.train_loss(p, jc, _batch_j(batch),
                                  dtype=jnp.float32))(jp)
    for leaf in toptim.tree_leaves(tp):
        leaf.requires_grad_(True)
    tl = ttfm.train_loss(tp, tc, _batch_t(batch), dtype=torch.float32)
    tl.backward()
    tl = tl.detach()
    devs = {path: _dev(t.grad, w) for path, w, t in _pairs(jg, tp)}
    worst = max(devs, key=devs.get)
    print(f"train_loss {arch}: {float(tl)} vs {float(jl)}; {len(devs)} "
          f"gradient leaves, worst {worst} {devs[worst]:.3e}")
    assert abs(float(tl) - float(jl)) <= 2e-4 * abs(float(jl))
    assert len(devs) == len(toptim.tree_leaves(tp))
    assert max(devs.values()) <= 2e-4


def test_remat_layers_gives_the_same_gradients():
    _, tc, _, tp = _model("hymba-1.5b", seed=3)
    batch = _batch_t(tdata.synthetic_lm_batch(tc, 2, 40, seed=1))
    grads = []
    for remat in ("none", "layer"):
        step = tsteps.make_train_step(tc, toptim.sgd(1.0),
                                      dtype=torch.float32, remat=remat)
        new, _, loss = step(tp, {}, batch, 0)
        grads.append([p - n for p, n in zip(toptim.tree_leaves(tp),
                                            toptim.tree_leaves(new))])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="A16b"):
        tsteps.make_train_step(tc, toptim.sgd(1.0), remat="dots")


# ---------------------------------------------------------------------------
# make_train_step: three steps against the reference's
# ---------------------------------------------------------------------------
def _ill_conditioned(grads, eps):
    """Per reference leaf, the entries whose gradient lies in (0, eps)."""
    return jax.tree_util.tree_map(
        lambda g: np.asarray((jnp.abs(g) > 0) & (jnp.abs(g) < eps)), grads)


def _masked_dev(got, want, skip) -> float:
    """``_dev`` over the entries not in ``skip`` (0 if all are)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    keep = ~skip
    if not keep.any():
        return 0.0
    return float(np.max(np.abs(got - want)[keep])
                 / max(float(np.max(np.abs(want))), 1.0))


@pytest.mark.parametrize("opt", ["sgd", "adam", "adam-eps1e-6"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "phi3-mini-3.8b"])
def test_train_steps_match_reference(arch, opt):
    """The reference's jit-ed step and the port's, from the same weights
    over the same batches: loss and every parameter within 2e-4 after
    each step.

    ``adam`` runs at the default eps = 1e-8, as the launcher does.
    Where a gradient entry lies in (0, eps), ``g / (sqrt(v) + eps)``
    turns a difference d in g into one of up to ``lr d / eps`` in the
    update, and fp32 summation order alone puts d near 1e-7 of the
    leaf's scale.  So that case holds every other entry to 2e-4 (exact
    zeros stay in), counts the entries it leaves out (at most 1e-4 of
    all; 35 of 2 262 688 for hymba and 14 of 1 574 144 for phi3), and,
    as a witness, runs the reference against itself with its gradients
    perturbed by 1e-7 of each leaf's scale: on the left-out entries the
    reference too moves by more than 2e-4.  ``adam-eps1e-6`` holds every
    entry."""
    jc, tc, jp, tp = _model(arch, seed=5)
    name, _, eps = opt.partition("-eps")
    lr = 2e-3 if name == "sgd" else 1e-3
    kw = {"eps": float(eps)} if eps else {}
    jopt = joptim.get_optimizer(name, lr, **kw)
    topt = toptim.get_optimizer(name, lr, **kw)
    jstep = jax.jit(jsteps.make_train_step(jc, jopt, dtype=jnp.float32))
    tstep = tsteps.make_train_step(tc, topt, dtype=torch.float32)
    jst, tst = jopt.init(jp), topt.init(tp)
    skip = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, bool), jp)
    witness = opt == "adam"
    if witness:
        grad = jax.jit(jax.value_and_grad(
            lambda p, b: jtfm.train_loss(p, jc, b, dtype=jnp.float32)))
        update = jax.jit(jopt.update)
        wp, wst = jp, jopt.init(jp)
        key = jax.random.PRNGKey(9)
    stream = jdata.SyntheticLMStream(jc, 2, 48, num_clients=2, seed=6)
    for i, batch in zip(range(3), stream):
        if witness:
            _, g = grad(jp, _batch_j(batch))
            skip = jax.tree_util.tree_map(
                np.logical_or, skip, _ill_conditioned(g, 1e-8))
            _, wg = grad(wp, _batch_j(batch))
            leaves, tdef = jax.tree_util.tree_flatten(wg)
            keys = jax.random.split(jax.random.fold_in(key, i), len(leaves))
            wg = tdef.unflatten([
                g_ + jnp.where(g_ != 0, 1e-7 * jnp.max(jnp.abs(g_))
                               * jax.random.normal(k, g_.shape), 0.0)
                for g_, k in zip(leaves, keys)])
            wp, wst = update(wp, wg, wst, i)
        jp, jst, jl = jstep(jp, jst, _batch_j(batch), i)
        tp, tst, tl = tstep(tp, tst, _batch_t(batch), i)
        pairs = [(w, t, m) for (_, w, t), (_, m, _)
                 in zip(_pairs(jp, tp), _pairs(skip, tp))]
        devs = [_masked_dev(t, w, m) for w, t, m in pairs]
        print(f"{arch} {opt} step {i}: loss {float(tl)} vs {float(jl)}, "
              f"max param dev {max(devs):.3e}")
        assert abs(float(tl) - float(jl)) <= 2e-4 * abs(float(jl))
        assert max(devs) <= 2e-4
    if witness:
        n_skip = sum(int(m.sum()) for _, _, m in pairs)
        n_all = sum(m.size for _, _, m in pairs)
        port = max(_masked_dev(t, w, ~m) for w, t, m in pairs)
        ref = max(_masked_dev(v, w, ~m) for (w, _, m), (_, v, _)
                  in zip(pairs, _pairs(wp, tp)))
        print(f"{arch} adam eps 1e-8: {n_skip} of {n_all} entries with a "
              f"reference gradient in (0, eps) left out; there the port "
              f"deviates by {port:.3e} and the reference under 1e-7 "
              f"gradient noise by {ref:.3e}")
        assert n_skip <= 1e-4 * n_all
        assert n_skip == 0 or ref > 2e-4


# ---------------------------------------------------------------------------
# the launcher (twin of tests/test_system.py's LM launcher test)
# ---------------------------------------------------------------------------
LAUNCH = ["--arch", "mamba2-1.3b", "--reduced", "--steps", "3", "--batch",
          "2", "--seq", "64", "--num-clients", "2", "--log-every", "2"]


def test_launcher_train_lm_runs():
    loss = ttrain.main(LAUNCH + ["--device", "cpu"])
    assert np.isfinite(loss)


def test_launcher_train_lm_matches_reference(monkeypatch):
    """With the reference's init carried in, the port's launcher ends at
    the reference launcher's final loss."""
    jc, tc = _reduced("mamba2-1.3b")
    tree = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jc))
    monkeypatch.setattr(ttfm, "init_params",
                        lambda g, cfg, device: ttfm.params_from_reference(
                            tree, cfg, device=device))
    want = jtrain.main(LAUNCH)
    got = ttrain.main(LAUNCH + ["--device", "cpu"])
    print(f"launcher final loss: port {got} vs reference {want}")
    assert abs(got - want) <= 2e-4 * abs(want)


@pytest.mark.parametrize("flag,label", [("--ntm", "A3"),
                                        ("--checkpoint-dir=ck", "A11")])
def test_launcher_refusals(flag, label):
    with pytest.raises(NotImplementedError, match=label):
        ttrain.main(LAUNCH + ["--device", "cpu", flag])


def test_train_lm_on_step_hook_and_params():
    """``main`` from given weights calls ``on_step`` after every step."""
    _, tc, _, tp = _model("hymba-1.5b")
    seen = []
    loss = ttrain.main(["--arch", "hymba-1.5b", "--reduced", "--steps", "2",
                        "--batch", "2", "--seq", "24", "--num-clients", "1",
                        "--log-every", "1", "--device", "cpu"],
                       init=lambda: tp,
                       on_step=lambda i, l: seen.append((i, float(l))))
    assert [i for i, _ in seen] == [0, 1] and seen[-1][1] == loss


@pytest.mark.parametrize("flag", ["--topk=0.25", "--secure-agg",
                                  "--local-steps=2", "--docs-per-node=9"])
def test_launcher_rejects_ntm_only_flags(flag):
    """The reference's NTM-only flags are not accepted without the NTM
    trainer, so none is silently ignored."""
    with pytest.raises(SystemExit):
        ttrain.main(LAUNCH + ["--device", "cpu", flag])


def test_train_step_cast_params_matches_reference():
    """``cast_params``: the loss differentiated with respect to bf16
    copies of the fp32 masters, the gradients cast back before the sgd
    update, against the reference's step with the same flag, on reduced
    phi3 with bf16 activations: the loss within 2e-2 (bf16 rounding in
    both, in different places) and every parameter within 2e-4 of its
    scale (the update is lr times a bf16 gradient)."""
    jc, tc, jp, tp = _model("phi3-mini-3.8b", seed=7)
    batch = jdata.synthetic_lm_batch(jc, 2, 40, seed=8)
    jstep = jax.jit(jsteps.make_train_step(
        jc, joptim.get_optimizer("sgd", 2e-3), dtype=jnp.bfloat16,
        cast_params=True))
    tstep = tsteps.make_train_step(tc, toptim.get_optimizer("sgd", 2e-3),
                                   dtype=torch.bfloat16, cast_params=True)
    jp2, _, jl = jstep(jp, {}, _batch_j(batch), 0)
    tp2, _, tl = tstep(tp, {}, _batch_t(batch), 0)
    devs = [_dev(t, w) for _, w, t in _pairs(jp2, tp2)]
    print(f"cast_params bf16 step: loss {float(tl)} vs {float(jl)}, max "
          f"param dev {max(devs):.3e}")
    assert all(t.dtype == torch.float32 for t in toptim.tree_leaves(tp2))
    assert abs(float(tl) - float(jl)) <= 2e-2 * abs(float(jl))
    assert max(devs) <= 2e-4


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-1.3b"])
def test_prefill_and_decode_steps_match_reference(arch):
    jc, tc, jp, tp = _model(arch)
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 71))
    jl, jcache = jsteps.make_prefill_step(jc, dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(toks[:, :70], jnp.int32)})
    tl, tcache = tsteps.make_prefill_step(tc, dtype=torch.float32)(
        tp, {"tokens": _t(toks[:, :70])})
    assert tl.shape == (2, 1, jc.vocab_size) and _dev(tl, jl) <= 2e-4
    jd, _ = jsteps.make_decode_step(jc, dtype=jnp.float32)(
        jp, jcache, jnp.asarray(toks[:, 70:], jnp.int32))
    td, _ = tsteps.make_decode_step(tc, dtype=torch.float32)(
        tp, tcache, _t(toks[:, 70:]))
    print(f"{arch} prefill/decode steps: {_dev(tl, jl):.3e}, "
          f"{_dev(td, jd):.3e}")
    assert _dev(td, jd) <= 2e-4
