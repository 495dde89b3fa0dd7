"""The two MoE archs on the port's federated LM path and its training
launcher, against the JAX package on the CPU (the set-up of
``torch_lm_federation_common.py``, reduced configs through the spec's
``model.family="lm"``): one round of ``Federation.run()`` from the
reference's init, every parameter within 2e-4 and the round's loss
within 1e-5 (qwen3-moe on the host loop and on the batched path, which
runs the MoE block under ``torch.func.vmap(grad)``; llama4's units on
the batched path).  The two paths are not held to each other: the
batched path pads every client to the cohort's largest batch, and the
routing groups and capacities follow the padded batch, in the
reference as here.  Then one step of ``launch.train --arch
qwen3-moe-235b-a22b --reduced`` from the seed against the reference
launcher's loss."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.api.federation import Federation as JFederation
from repro.launch import train as jtrain
from repro_torch.api import Federation
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tfm

from torch_lm_federation_common import _WHOLE, _devs_to_ref, _specs

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))


def _round(arch, mode):
    """One round of the arch's reduced LM spec in ``mode`` in both
    packages, the port from the reference's init."""
    js, ts = _specs({**_WHOLE, "model.arch": arch, "schedule.rounds": 1,
                     "execution.exec_mode": mode})
    jf = JFederation.from_spec(js)
    init = tfm.params_from_reference(
        jax.tree_util.tree_map(np.asarray, jf.engine.params), jf.model_cfg)
    tf = Federation.from_spec(ts, device="cpu", init_params=init)
    tf.run()
    jf.run()
    return jf, tf


@pytest.mark.parametrize("arch,mode", [
    ("qwen3-moe-235b-a22b", "loop"), ("qwen3-moe-235b-a22b", "vmap"),
    ("llama4-maverick-400b-a17b", "vmap")])
def test_moe_federated_round_matches_reference(arch, mode):
    jf, tf = _round(arch, mode)
    devs = _devs_to_ref(jf.engine.params, tf.engine.params)
    loss = abs(tf.history[0]["loss"] - jf.history[0]["loss"])
    print(f"{arch} {mode}: params {devs.max():.3e}, loss {loss:.3e}")
    assert tf.model_cfg.kind == "moe" and len(tf.history) == 1
    assert tf.history[0]["participants"] == jf.history[0]["participants"]
    assert devs.max() <= 2e-4 and loss <= 1e-5


def test_moe_launcher_step_matches_reference():
    """One sgd step of the training launcher from seed 0 in both
    packages (the port's init is the reference's within 4 ulps)."""
    argv = ["--arch", "qwen3-moe-235b-a22b", "--reduced", "--steps", "1",
            "--batch", "2", "--seq", "64", "--num-clients", "2"]
    want = jtrain.main(argv)
    got = ttrain.main(argv + ["--device", "cpu"])
    print(f"launcher loss: port {got} vs reference {want}")
    assert abs(got - want) <= 1e-5
