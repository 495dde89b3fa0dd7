"""The port's message transforms against the JAX package.

Selection rules and the precision cast are held bitwise; ``dp`` runs on
the reference's own noise (drawn here with the reference's key schedule)
and stays within 1e-6; the secure masks cancel to exactly +0.0 at every
K up to 1024; the secure refusals raise the reference's errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FederatedConfig as JFed
from repro.configs.base import RoundConfig as JRound
from repro.core import aggregation as jagg
from repro.core import transforms as jtr
from repro.core.engine import ClientState as JClient
from repro.core.engine import FederationEngine as JEngine
from repro.api import FederationSpec as JSpec
from repro.api import spec_replace as jspec_replace
from repro_torch.api import FederationSpec, spec_replace
from repro_torch.configs.base import FederatedConfig, RoundConfig
from repro_torch.core import aggregation as tagg
from repro_torch.core import transforms as ttr
from repro_torch.core.engine import ClientState, FederationEngine
from repro_torch.kernels import ops

SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}   # jax's (sorted) order


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _tree(rng, lead=()):
    return {n: rng.standard_normal(lead + s).astype(np.float32)
            for n, s in SHAPES.items()}


def _layout():
    out, off = [], 0
    for n, s in SHAPES.items():
        size = int(np.prod(s))
        out.append((n, torch.Size(s), off, size))
        off += size
    return out


def _slab(tree, k):
    return torch.from_numpy(np.concatenate(
        [np.asarray(tree[n]).reshape(k, -1) for n in SHAPES], axis=1))


# ---------------------------------------------------------------------------
# topk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 7, 60, 120])
def test_topk_keep_mask_bitwise(k, rng):
    mags = [np.abs(rng.standard_normal((3, 120))),
            np.abs(rng.integers(-3, 4, (3, 120)) * 0.25),
            1.0 + rng.integers(0, 8, (3, 120)) * 2.0 ** -12]
    for mag in mags:
        mag = mag.astype(np.float32)
        want = np.asarray(jagg.topk_keep_mask(jnp.asarray(mag), k))
        got = tagg.topk_keep_mask(torch.from_numpy(mag), k).numpy()
        assert np.array_equal(got, want)
        assert (got.sum(-1) == k).all()


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_compress_with_error_feedback_bitwise(frac, rng):
    g, e = _tree(rng), _tree(rng)
    g["b"][:] = 0.5                                # exact ties
    for err in (None, e):
        want = jagg.compress_with_error_feedback(
            {n: jnp.asarray(v) for n, v in g.items()},
            None if err is None else {n: jnp.asarray(v)
                                      for n, v in err.items()}, frac)
        got = tagg.compress_with_error_feedback(
            {n: torch.from_numpy(v) for n, v in g.items()},
            None if err is None else {n: torch.from_numpy(v)
                                      for n, v in err.items()}, frac)
        for w_tree, g_tree in zip(want, got):
            for n in SHAPES:
                assert np.array_equal(_bits(g_tree[n].numpy()),
                                      _bits(w_tree[n])), n


def test_topk_transform_scatters_valid_rows_only(rng):
    """The (L, D) error memory is gathered by client id, and written back
    only for real rows (a padded row never touches it)."""
    fed = FederatedConfig(compression_topk=0.25)
    (_, t), = ttr.build_transforms(("topk",), fed)
    layout = _layout()
    state = t.init_state(layout, 4, "cpu")
    msgs = _slab(_tree(rng, (3,)), 3)
    ctx = ttr.StackedTransformCtx(5, np.array([2, 0, 0]),
                                  np.array([True, True, False]),
                                  torch.tensor([10.0, 4.0, 0.0]), 4, layout)
    sent, state = t.stacked(msgs, ctx, state)
    want_sent, want_err = ops.fed_topk_ef(
        msgs, torch.zeros(4, msgs.shape[1]), torch.tensor([2, 0, 0]),
        frac=0.25, segments=ctx.segments)
    assert torch.equal(sent, want_sent)
    assert torch.equal(state[2], want_err[0])
    assert torch.equal(state[0], want_err[1])       # not the padded row
    assert not state[1].any() and not state[3].any()


# ---------------------------------------------------------------------------
# dp
# ---------------------------------------------------------------------------
def _reference_noise(round_key, ids, template):
    """The reference's stacked dp noise (transforms.py:185-194): per row
    fold_in(fold_in(round_key, cid), 7), split over the leaves."""
    keys = jax.vmap(lambda c: jax.random.fold_in(
        jax.random.fold_in(round_key, c), 7))(ids)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    leaf_keys = jax.vmap(lambda k: jax.random.split(k, len(leaves)))(keys)
    return jax.tree_util.tree_unflatten(treedef, [
        np.array(jax.vmap(lambda k, l=l: jax.random.normal(
            k, l.shape[1:], jnp.float32))(leaf_keys[:, i]))
        for i, l in enumerate(leaves)])


@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_dp_stacked_matches_reference_on_its_noise(clip, rng):
    k, mult = 3, 0.3
    msgs = _tree(rng, (k,))
    ids = jnp.asarray([0, 2, 1], jnp.int32)
    key = jax.random.PRNGKey(11)
    ctx = jtr.StackedTransformCtx(
        round_key=key, client_ids=ids, valid=jnp.ones(k, bool),
        weights=jnp.ones(k), num_clients=3, kernel_backend="pallas")
    fed = JFed(dp_noise_multiplier=mult, dp_clip_norm=clip)
    (_, jt), = jtr.build_transforms(("dp",), fed)
    jm = {n: jnp.asarray(v) for n, v in msgs.items()}
    want, _ = jt.stacked(jm, ctx, None)
    noise = _reference_noise(key, ids, jm)
    got = ttr.dp_apply(_slab(msgs, k), _layout(), _slab(noise, k),
                       clip=clip, mult=mult)
    dev = np.max(np.abs(got.numpy() - _slab(want, k).numpy()))
    print(f"dp stacked vs reference (its noise) clip={clip}: {dev:.3e}")
    assert dev <= 1e-6


def test_dp_privatize_matches_reference_on_its_noise(rng):
    tree = _tree(rng)
    key = jax.random.PRNGKey(3)
    want = jagg.dp_privatize({n: jnp.asarray(v) for n, v in tree.items()},
                             key, clip_norm=0.5, noise_multiplier=0.3)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    noise = jax.tree_util.tree_unflatten(treedef, [
        np.array(jax.random.normal(kk, l.shape, jnp.float32))
        for l, kk in zip(leaves, jax.random.split(key, len(leaves)))])
    got = tagg.dp_privatize({n: torch.from_numpy(v) for n, v in tree.items()},
                            {n: torch.from_numpy(v) for n, v in noise.items()},
                            clip_norm=0.5, noise_multiplier=0.3)
    for n in SHAPES:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=0, atol=1e-6)


def test_dp_transform_draws_its_noise_per_client(rng):
    """The registry's dp draws from (round_seed, client id): the same
    client gets the same noise in any row, padded rows get none."""
    fed = FederatedConfig(dp_noise_multiplier=0.3, dp_clip_norm=0.05)
    (_, t), = ttr.build_transforms(("dp",), fed)
    layout = _layout()
    msgs = _slab(_tree(rng, (3,)), 3)
    ids, valid = np.array([1, 2, 0]), np.array([True, True, False])
    ctx = ttr.StackedTransformCtx(9, ids, valid, torch.ones(3), 3, layout)
    out, _ = t.stacked(msgs, ctx, None)
    noise = ttr.dp_noise(9, ids, valid, msgs.shape[1])
    assert torch.equal(out, ttr.dp_apply(msgs, layout, noise, clip=0.05,
                                         mult=0.3))
    assert not noise[2].any()
    swapped = ttr.dp_noise(9, ids[::-1].copy(), valid[::-1].copy(),
                           msgs.shape[1])
    assert torch.equal(swapped[1], noise[1]) and \
        not torch.equal(noise[0], noise[1])
    assert not torch.equal(noise, ttr.dp_noise(10, ids, valid,
                                               msgs.shape[1]))


# ---------------------------------------------------------------------------
# secure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [2, 3, 5, 16, 64, 1024])
def test_secure_masks_cancel_to_exact_zero(k):
    """sum_l mask_l is exactly +0.0 per column under torch.sum, a
    sequential fp32 sum and three shuffled orders."""
    stack = ttr.pairwise_mask_stack(k, [(0, 36), (36, 7)], k)
    arr = stack.numpy()
    assert arr.shape == (k, 43) and arr.std() > 0
    zero = np.zeros(43, np.float32)
    assert np.array_equal(_bits(torch.sum(stack, dim=0).numpy()),
                          _bits(zero))
    acc = np.zeros(43, np.float32)
    for row in arr:
        acc = acc + row
    assert np.array_equal(_bits(acc), _bits(zero))
    rng = np.random.default_rng(k)
    for _ in range(3):
        shuffled = arr[rng.permutation(k)]
        assert np.array_equal(_bits(np.add.reduce(shuffled, axis=0)),
                              _bits(zero))


def test_secure_mask_population_cap():
    with pytest.raises(ValueError, match="1024"):
        ttr.pairwise_mask_stack(0, [(0, 2)], 2000)
    assert ttr._mask_grid_bits(1024) == jtr._mask_grid_bits(1024)
    assert [ttr._mask_grid_bits(k) for k in (2, 5, 64)] == \
        [jtr._mask_grid_bits(k) for k in (2, 5, 64)]


def test_secure_combine_lands_on_the_unmasked_combine(rng):
    """Masked messages, combined by Eq. (2), equal the unmasked combine
    up to the rounding of msg + mask/n."""
    fed = FederatedConfig()
    (_, t), = ttr.build_transforms(("secure",), fed)
    layout = _layout()
    msgs = _slab(_tree(rng, (3,)), 3) * 1e-3
    w = torch.tensor([40.0, 25.0, 31.0])
    ctx = ttr.StackedTransformCtx(4, np.arange(3), np.ones(3, bool), w, 3,
                                  layout)
    masked, _ = t.stacked(msgs, ctx, None)
    assert not torch.equal(masked, msgs)
    dev = float(torch.max(torch.abs(ops.fed_weighted_combine(masked, w)
                                    - ops.fed_weighted_combine(msgs, w))))
    print(f"secure combine vs unmasked: {dev:.3e}")
    assert dev <= 1e-6


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------
def test_precision_bitwise(rng):
    msgs = _tree(rng, (3,))
    (_, jt), = jtr.build_transforms(("precision",),
                                    JFed(message_precision="bf16"))
    want, _ = jt.stacked({n: jnp.asarray(v) for n, v in msgs.items()},
                         None, None)
    (_, t), = ttr.build_transforms(("precision",),
                                   FederatedConfig(message_precision="bf16"))
    got, _ = t.stacked(_slab(msgs, 3), None, None)
    assert np.array_equal(_bits(got.numpy()), _bits(_slab(want, 3).numpy()))
    with pytest.raises(ValueError, match="bf16"):
        ttr.build_transforms(("precision",), FederatedConfig())


# ---------------------------------------------------------------------------
# the three secure refusals, with the reference's error types
# ---------------------------------------------------------------------------
_SPEC = {"model": {"vocab": 64, "topics": 4, "hidden": 16},
         "data": {"num_clients": 3, "docs_per_node": 40,
                  "val_docs_per_node": 8},
         "execution": {"batch_size": 64, "exec_mode": "vmap"}}
_REFUSALS = {
    "precision": ({"transforms.names": ("secure", "precision"),
                   "transforms.precision": "bf16"},
                  dict(transforms=("secure", "precision"))),
    "stragglers": ({"transforms.names": ("secure",),
                    "schedule.straggler_prob": 0.3,
                    "schedule.max_staleness": 2},
                   dict(transforms=("secure",), straggler_prob=0.3,
                        max_staleness=2)),
    "partial": ({"transforms.names": ("secure",),
                 "schedule.clients_per_round": 2},
                dict(transforms=("secure",), clients_per_round=2)),
}


@pytest.mark.parametrize("which", sorted(_REFUSALS))
def test_secure_refusals_match_reference(which):
    overrides, round_kw = _REFUSALS[which]
    with pytest.raises(ValueError) as want:
        jspec_replace(JSpec.from_dict(_SPEC), overrides)
    with pytest.raises(ValueError) as got:
        spec_replace(FederationSpec.from_dict(_SPEC), overrides)
    assert str(got.value) == str(want.value)
    # the engine refuses the same configurations on its own
    fed_kw = dict(num_clients=3, message_precision="bf16")
    rc_kw = dict(exec_mode="vmap", **round_kw)
    bow = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError) as want:
        JEngine(lambda p, b: 0.0, {"w": jnp.zeros(2)},
                [JClient(data={"bow": bow}, num_docs=4) for _ in range(3)],
                JFed(**fed_kw), JRound(**rc_kw),
                loss_sum_fn=lambda p, b: (0.0, 1.0))
    with pytest.raises(ValueError) as got:
        FederationEngine(lambda p, b: 0.0, {"w": torch.zeros(2)},
                         [ClientState({"bow": torch.from_numpy(bow)}, 4)
                          for _ in range(3)], FederatedConfig(**fed_kw),
                         RoundConfig(**rc_kw),
                         loss_sum_fn=lambda p, b: (0.0, 1.0))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("overrides", [
    {"transforms.names": ("dp",)},
    {"transforms.dp_noise_multiplier": 0.3},
    {"transforms.names": ("topk",)},
    {"transforms.compression_topk": 0.25},
    {"transforms.names": ("precision",)},
    {"transforms.precision": "bf16"},
    {"transforms.names": ("nope",)},
])
def test_transform_knobs_are_never_silently_dropped(overrides):
    """The spec's transform validation, message for message."""
    with pytest.raises(ValueError) as want:
        jspec_replace(JSpec.from_dict(_SPEC), overrides)
    with pytest.raises(ValueError) as got:
        spec_replace(FederationSpec.from_dict(_SPEC), overrides)
    assert str(got.value) == str(want.value)
