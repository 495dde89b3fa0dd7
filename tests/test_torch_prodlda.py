"""Port ProdLDA against the JAX reference, from carried weights.

The reference's init tree (``prodlda.init_params``, numpy leaves) is
carried into the port with ``params_from_reference``; the same numpy
batches go through both, in evaluation mode (``train=False`` on both
sides: no dropout, the posterior mean), and every output, loss and
gradient must agree within 1e-5.  The train mode and the other input
modes are held against the reference in ``tests/test_torch_ctm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import NTM, ModelConfig as JConfig
from repro.core.ntm import prodlda as jp
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core.ntm import prodlda as tp


def _cfgs(learn_priors=True):
    kw = dict(vocab_size=64, num_topics=4, ntm_hidden=(16, 16),
              learn_priors=learn_priors)
    return JConfig(name="t", kind=NTM, **kw), TConfig(name="t", **kw)


def _setup(seed=0, learn_priors=True, docs=8):
    jcfg, tcfg = _cfgs(learn_priors)
    jparams = jp.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    bow = np.random.default_rng(seed).poisson(0.3, (docs, 64)) \
        .astype(np.float32)
    return jcfg, tcfg, jparams, tp.params_from_reference(tree), bow


def _close(got, want, tol=1e-5):
    """|got - want| / max(max|want|, 1) <= tol; returns that deviation."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)
    return float(np.max(np.abs(got - want))) / scale


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_outputs_match(seed):
    jcfg, tcfg, jparams, tparams, bow = _setup(seed)
    want = jp.forward(jparams, jcfg, {"bow": jnp.asarray(bow)}, train=False)
    got = tp.forward(tparams, tcfg, {"bow": torch.from_numpy(bow)},
                     train=False)
    dev = max(_close(got[key], want[key])
              for key in ("theta", "mu", "logvar", "log_recon"))
    print(f"forward (seed {seed}): max scaled deviation {dev:.3e}")


@pytest.mark.parametrize("learn_priors", [True, False])
def test_elbo_loss_and_sum_match(learn_priors):
    jcfg, tcfg, jparams, tparams, bow = _setup(learn_priors=learn_priors)
    mask = np.asarray([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    jb = {"bow": jnp.asarray(bow)}
    tb = {"bow": torch.from_numpy(bow)}
    _close(tp.elbo_loss(tparams, tcfg, tb, train=False),
           jp.elbo_loss(jparams, jcfg, jb, train=False))
    for b_j, b_t in ((jb, tb), ({**jb, "doc_mask": jnp.asarray(mask)},
                                {**tb, "doc_mask": torch.from_numpy(mask)})):
        s_j, n_j = jp.elbo_loss_sum(jparams, jcfg, b_j, train=False)
        s_t, n_t = tp.elbo_loss_sum(tparams, tcfg, b_t, train=False)
        _close(s_t, s_j)
        assert float(n_t) == float(n_j)


def test_every_gradient_matches_jax_grad():
    """torch.func.grad of the port's loss (through functional_call on the
    module) against jax.grad of the reference's, leaf by leaf."""
    jcfg, tcfg, jparams, tparams, bow = _setup()
    jg = jax.grad(lambda q: jp.elbo_loss(q, jcfg, {"bow": jnp.asarray(bow)},
                                         train=False))(jparams)
    want = tp.params_from_reference(jax.tree_util.tree_map(np.asarray, jg))
    got, _ = torch.func.grad_and_value(
        lambda q: tp.elbo_loss(q, tcfg, {"bow": torch.from_numpy(bow)},
                               train=False))(
            tparams)
    assert list(got) == list(want)
    dev = max(_close(got[name], want[name].numpy()) for name in want)
    print(f"gradients: max scaled deviation {dev:.3e}")


def test_infer_theta_and_topics_match():
    jcfg, tcfg, jparams, tparams, bow = _setup(seed=2)
    _close(tp.infer_theta(tparams, tcfg, torch.from_numpy(bow)),
           jp.infer_theta(jparams, jcfg, jnp.asarray(bow)))
    _close(tp.get_topics(tparams), jp.get_topics(jparams))


def test_module_names_and_forward():
    """ProdLDA registers its parameters under the reference tree's paths;
    its forward is the per-document negative ELBO."""
    jcfg, tcfg, jparams, tparams, bow = _setup()
    model = tp.ProdLDA(tcfg, tparams)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(tparams)
    assert list(tparams)[:2] == ["encoder.0.w", "encoder.0.b"]
    recon, kl = jp.elbo_parts(jparams, jcfg, {"bow": jnp.asarray(bow)},
                              train=False)
    with torch.no_grad():
        _close(model(torch.from_numpy(bow), train=False), recon + kl)


def test_weight_carrier_round_trips_bitwise():
    _, _, jparams, tparams, _ = _setup(seed=3)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = tp.params_to_reference(tparams)
    leaves_a, def_a = jax.tree_util.tree_flatten(tree)
    leaves_b, def_b = jax.tree_util.tree_flatten(back)
    assert def_a == def_b
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_init_respects_two_sigma_truncation():
    """The reference truncates a standard normal at ±2 and scales it; the
    port's bounds are therefore ±2·std in absolute units."""
    _, tcfg = _cfgs()
    params = tp.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    ref_tree = jp.init_params(jax.random.PRNGKey(0), _cfgs()[0])
    ref_flat = tp.params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_tree))
    assert {k: v.shape for k, v in params.items()} == \
        {k: v.shape for k, v in ref_flat.items()}
    for name, w in params.items():
        if name.endswith(".w") or name == "beta":
            std = w.shape[0] ** -0.5
            assert float(w.abs().max()) <= 2.0 * std * (1 + 1e-6)
            assert float(w.abs().max()) > 1.5 * std
            # a N(0,1) truncated at ±2 has std 0.8796
            assert abs(float(w.std()) / std - 0.8796) < 0.1
        else:
            _close(w, ref_flat[name].numpy(), tol=1e-6)
