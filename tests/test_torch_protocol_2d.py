"""The protocol step (``core/protocol.py`` ``make_federated_train_step``)
over two client axes against the JAX package on the CPU.

The reference's step is a ``shard_map`` over its ``("data", "model")``
mesh of 4 forced host devices, run in a subprocess (JAX fixes its device
count when it starts); the port's runs over ``launch.mesh.make_host_mesh
(2, 2, "cpu")``, its clients numbered as the reference numbers them
(``cid * axis_size(ax) + axis_index(ax)``).  ProdLDA in evaluation mode
from the reference's init, plain, with local DP and with the pairwise
secure mask over all four clients, and with the axes in the other order;
params and loss within 1e-5.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.ntm import prodlda as jprodlda
from repro_torch.configs.base import NTM, FederatedConfig, ModelConfig
from repro_torch.core import prng
from repro_torch.core.ntm import prodlda
from repro_torch.core.ntm.prodlda import params_from_reference
from repro_torch.core.protocol import make_federated_train_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import optimizers as toptim

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

V, K, H, B, LR = 64, 4, 16, 32, 1e-2
FEDS = {"plain": {}, "dp": {"dp_noise_multiplier": 0.3, "dp_clip_norm": 1.0},
        "secure": {"secure_aggregation": True}}
CASES = [("plain", ("data", "model")), ("dp", ("data", "model")),
         ("secure", ("data", "model")), ("plain", ("model", "data"))]


@pytest.fixture(scope="module")
def reference_2d(tmp_path_factory):
    """The reference's step on a (2, 2) mesh of 4 forced host devices, one
    subprocess for every case: params and loss by case."""
    out = tmp_path_factory.mktemp("ref2d") / "steps.pkl"
    code = f"""
        import os, pickle
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro.configs.base import FederatedConfig, ModelConfig
        from repro.core.ntm import prodlda
        from repro.core.protocol import make_federated_train_step
        from repro.optim import sgd
        cfg = ModelConfig(name="t", kind="ntm", vocab_size={V},
                          num_topics={K}, ntm_hidden=({H}, {H}))
        init = prodlda.init_params(jax.random.PRNGKey(0), cfg)
        bow = np.random.default_rng(0).poisson(0.5, ({B}, {V})).astype(
            np.float32)
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("data", "model"))
        saved = []
        for fed, axes in {CASES!r}:
            step = jax.jit(make_federated_train_step(
                lambda p, b: prodlda.elbo_loss_sum(p, cfg, b, train=False),
                sgd({LR}), mesh, client_axes=axes,
                fed=FederatedConfig(**{FEDS!r}[fed])))
            p, _, loss = step(init, {{}}, {{"bow": jnp.asarray(bow)}}, 3,
                              jax.random.PRNGKey(1))
            saved.append((jax.tree_util.tree_map(np.asarray, p),
                          float(loss)))
        with open({str(out)!r}, "wb") as f:
            pickle.dump(saved, f)
        print("ok")
        """
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_two_client_axes_match_reference(reference_2d, case):
    """``make_federated_train_step`` over ``client_axes`` of the (2, 2)
    host mesh (``make_host_mesh(2, 2, "cpu")``), clients numbered as the
    reference numbers them: params and loss within 1e-5 of its
    ``shard_map`` step, with local DP and the secure mask over all four
    clients."""
    fed, axes = CASES[case]
    jcfg = JModelConfig(name="t", kind=NTM, vocab_size=V, num_topics=K,
                        ntm_hidden=(H, H))
    cfg = ModelConfig(name="t", kind=NTM, vocab_size=V, num_topics=K,
                      ntm_hidden=(H, H))
    init = params_from_reference(jax.tree_util.tree_map(
        np.asarray, jprodlda.init_params(jax.random.PRNGKey(0), jcfg)))
    bow = np.random.default_rng(0).poisson(0.5, (B, V)).astype(np.float32)
    mesh = make_host_mesh(2, 2, device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}
    step = make_federated_train_step(
        lambda p, b: prodlda.elbo_loss_sum(p, cfg, b, train=False),
        toptim.sgd(LR), mesh, client_axes=axes,
        fed=FederatedConfig(**FEDS[fed]))
    got, _, loss = step(init, {}, {"bow": torch.from_numpy(bow)}, 3,
                        prng.PRNGKey(1))
    tree, want_loss = reference_2d[case]
    want = params_from_reference(tree)
    devs = {k: float(np.max(np.abs(got[k].numpy() - want[k].numpy())))
            for k in want}
    print(f"{fed} over {axes}: params {max(devs.values()):.3e}, loss "
          f"{abs(float(loss) - want_loss):.3e}")
    assert set(devs) == set(got)
    assert max(devs.values()) <= 1e-5
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
