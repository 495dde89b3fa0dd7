"""The mesh protocol step (``core/protocol.py`` ``make_federated_train_step``)
and its aggregation pieces against the JAX package.

The reference's step is a ``shard_map`` over its ``("data",)`` mesh: each
device one client, the gradient of the client's local mean loss, optional
local DP and the pairwise secure mask, then the Eq. (2) ``psum``, the
optimizer update and the sample-weighted mean loss.  This process sees
one JAX device, so the reference's step runs here on a one-device mesh
(``data=1``), and the port's steps over 4 and 8 CPU shards are held to
the reference's host formula instead: per-client JAX gradients at the
same ``fold_in`` keys, the reference's ``pairwise_mask``, its
``aggregate_host`` and one SGD step.  ProdLDA in evaluation mode from
the reference's init; bounds 1e-5 on parameters and loss, normals (the
masks' draws) within the port's few-ulp bound.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import FederatedConfig as JFed
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import aggregation as jagg
from repro.core.ntm import prodlda as jprodlda
from repro.core.protocol import make_federated_train_step as jmake_step
from repro.optim import sgd as jsgd
from repro_torch.api import max_param_dev
from repro_torch.configs.base import NTM, FederatedConfig, ModelConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import prng
from repro_torch.core.ntm import prodlda
from repro_torch.core.ntm.prodlda import params_from_reference
from repro_torch.core.protocol import make_federated_train_step
from repro_torch.optim import sgd
from repro_torch.parallel import fed_mesh

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

TOL = 1e-5
V, K, H, B = 64, 4, 16, 32
LR = 1e-2
FEDS = {"plain": {}, "dp": {"dp_noise_multiplier": 0.3, "dp_clip_norm": 1.0},
        "secure": {"secure_aggregation": True}}


# the module's set-up by id, for the cached per-client reference gradients
_SETUPS = {}


def _host(tree):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(name="t", kind=NTM, vocab_size=V, num_topics=K,
                        ntm_hidden=(H, H))
    cfg = ModelConfig(name="t", kind=NTM, vocab_size=V, num_topics=K,
                      ntm_hidden=(H, H))
    jinit = jprodlda.init_params(jax.random.PRNGKey(0), jcfg)
    bow = np.random.default_rng(0).poisson(0.5, (B, V)).astype(np.float32)
    out = {"jcfg": jcfg, "cfg": cfg, "jinit": jinit, "init": _host(jinit),
           "bow": bow}
    _SETUPS[id(out)] = out
    return out


def _port_step(setup, data, fed):
    cfg = setup["cfg"]
    step = make_federated_train_step(
        lambda p, b: prodlda.elbo_loss_sum(p, cfg, b, train=False), sgd(LR),
        fed_mesh(data, "cpu"), fed=FederatedConfig(**fed))
    return step(setup["init"], {}, {"bow": torch.from_numpy(setup["bow"])},
                3, prng.PRNGKey(1))


@pytest.mark.parametrize("fed", sorted(FEDS))
def test_data1_matches_reference_step(setup, fed):
    """One client on a one-device mesh in both packages: params within
    1e-5 of the reference's ``shard_map`` step, the loss within 1e-5 of
    it relative (an ELBO of ~1e2 a document, where fp32's spacing is
    ~1e-5)."""
    jcfg = setup["jcfg"]
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jstep = jax.jit(jmake_step(
        lambda p, b: jprodlda.elbo_loss_sum(p, jcfg, b, train=False),
        jsgd(LR), mesh, fed=JFed(**FEDS[fed])))
    jp, _, jloss = jstep(setup["jinit"], {}, {"bow": jnp.asarray(
        setup["bow"])}, 3, jax.random.PRNGKey(1))
    tp_, _, tloss = _port_step(setup, 1, FEDS[fed])
    dev = max_param_dev(_host(jp), tp_)
    print(f"data=1 {fed}: params {dev:.3e}, loss "
          f"{abs(float(tloss) - float(jloss)):.3e}")
    assert dev <= TOL
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    assert max_param_dev(tp_, setup["init"]) > 0


@functools.lru_cache(maxsize=None)
def _grad_fn(setup_id):
    """The reference's jitted ``value_and_grad`` of a client's mean loss
    (one compile a batch shape)."""
    jcfg = _SETUPS[setup_id]["jcfg"]

    def mean_loss(p, bow):
        s, n = jprodlda.elbo_loss_sum(p, jcfg, {"bow": bow}, train=False)
        return s / jnp.maximum(n, 1.0), n
    return jax.jit(jax.value_and_grad(mean_loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def _client_grad(setup_id, data: int, c: int):
    """Client ``c``'s loss, count and plain gradient in the reference, at
    ``data`` clients (rows ``[c*B/data, (c+1)*B/data)`` of the batch)."""
    setup = _SETUPS[setup_id]
    rows = np.split(setup["bow"], data)[c]
    (loss, n), g = _grad_fn(setup_id)(setup["jinit"], jnp.asarray(rows))
    return float(loss), float(n), g


@functools.partial(jax.jit, static_argnums=(2, 3))
def _dp_privatize(g, key, clip_norm, noise_multiplier):
    return jagg.dp_privatize(g, key, clip_norm=clip_norm,
                             noise_multiplier=noise_multiplier)


def _reference_host_formula(setup, data, fed):
    """The step by hand in the reference: client ``c`` holds rows
    ``[c*B/data, (c+1)*B/data)``, its key ``fold_in(rng, c)``, DP on
    ``fold_in(key, 7)``, the mask ``pairwise_mask(g, fold_in(rng, step),
    c, data)`` over ``n_c``; ``aggregate_host`` and one SGD step."""
    fcfg = JFed(**FEDS[fed])
    rng, step_idx = jax.random.PRNGKey(1), 3
    grads, ns, losses = [], [], []
    for c in range(data):
        loss, n, g = _client_grad(id(setup), data, c)
        local = jax.random.fold_in(rng, c)
        if fcfg.dp_noise_multiplier > 0:
            g = _dp_privatize(g, jax.random.fold_in(local, 7),
                              fcfg.dp_clip_norm, fcfg.dp_noise_multiplier)
        if fcfg.secure_aggregation:
            g = jagg.secure_mask_grads(g, jax.random.fold_in(rng, step_idx),
                                       c, data, n)
        grads.append(g)
        ns.append(n)
        losses.append(loss)
    gbar = jagg.aggregate_host(grads, ns)
    new = jax.tree_util.tree_map(lambda p, g: p - LR * g, setup["jinit"],
                                 gbar)
    return _host(new), float(np.dot(losses, ns) / np.sum(ns))


@pytest.mark.parametrize("fed", sorted(FEDS))
@pytest.mark.parametrize("data", [4, 8])
def test_sharded_step_matches_reference_host_formula(setup, data, fed):
    want, want_loss = _reference_host_formula(setup, data, fed)
    got, _, loss = _port_step(setup, data, FEDS[fed])
    dev = max_param_dev(want, got)
    print(f"data={data} {fed}: params {dev:.3e}")
    assert dev <= TOL
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)


def test_secure_step_equals_plain_step(setup):
    """The masks cancel in the Eq. (2) numerator: the secure step lands
    on the plain step up to fp32 rounding of the masked terms."""
    plain, _, _ = _port_step(setup, 4, {})
    sec, _, _ = _port_step(setup, 4, FEDS["secure"])
    assert max_param_dev(plain, sec) <= TOL


@pytest.mark.parametrize("num_clients", [2, 5])
def test_pairwise_mask_matches_reference(num_clients):
    """Each client's mask over a two-leaf dict against the reference's, in
    its tree order (leaf j of the sorted keys draws from ``fold_in(...,
    j)``).  A mask entry adds ``num_clients`` signed terms ``scale *
    normal`` (|normal| < 6), each draw within the port's 4-ulp bound of
    the reference's; an entry is held within 4 ulps of the largest term
    ``scale * 6`` (measured: at most 2)."""
    tree = {"w": np.zeros((16, 8), np.float32), "b": np.zeros((5,),
                                                              np.float32)}
    key, scale = jax.random.PRNGKey(3), 2.0
    unit = np.spacing(np.float32(scale * 6.0))
    for c in range(num_clients):
        want = jagg.pairwise_mask({k: jnp.asarray(v) for k, v in
                                   tree.items()}, key, c, num_clients,
                                  scale=scale)
        got = agg.pairwise_mask({k: torch.from_numpy(v) for k, v in
                                 tree.items()}, prng.PRNGKey(3), c,
                                num_clients, scale=scale)
        assert list(got) == list(tree)
        for k in tree:
            dev = np.abs(got[k].numpy() - np.asarray(want[k]))
            print(f"client {c} {k}: {np.mean(dev == 0):.3f} bitwise, max "
                  f"{dev.max() / unit:.2f} ulps of the largest term")
            assert dev.max() <= 4 * unit
    total = sum(agg.pairwise_mask({"w": torch.zeros(6, 3)}, prng.PRNGKey(3),
                                  c, 3)["w"] for c in range(3))
    assert float(total.abs().max()) <= 1e-5


def test_aggregate_psum_matches_aggregate_host():
    rng = np.random.default_rng(2)
    grads = [{"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
             for _ in range(4)]
    n = [3.0, 7.0, 1.0, 5.0]
    want = jagg.aggregate_host([{k: jnp.asarray(v) for k, v in g.items()}
                                for g in grads], n)
    got = agg.aggregate_psum([{k: torch.from_numpy(v) for k, v in g.items()}
                              for g in grads],
                             [torch.tensor(x) for x in n],
                             fed_mesh(4, "cpu"))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)


def test_second_client_axis_refused():
    # a second client axis the ("data",) mesh does not have
    mesh = fed_mesh(2, "cpu")
    with pytest.raises(ValueError, match="'model' is not an axis"):
        make_federated_train_step(None, sgd(LR), mesh,
                                  client_axes=("data", "model"))
    with pytest.raises(ValueError, match="not an axis"):
        make_federated_train_step(None, sgd(LR), mesh,
                                  client_axes=("model",))
