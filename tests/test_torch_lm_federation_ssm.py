"""The port's federated LM training against the JAX reference: the SSM
(reduced mamba2-1.3b, kernel B6) and hybrid (reduced hymba-1.5b, B5 and
B6) families on the batched path, the port's host loop against its
batched path for both (the set-up of ``test_torch_lm_federation.py``,
from ``torch_lm_federation_common.py``), and an LM spec on the batched
path over a two-shard mesh (``execution.mesh``)."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import FederationSpec as JSpec
from repro.api import spec_replace as jspec_replace
from repro_torch.api import Federation, FederationSpec, spec_replace
from repro_torch.models import transformer as tfm

from torch_lm_federation_common import (  # noqa: F401
    _REF_MODES, check_port_loop_equals_port_vmap,
    check_port_matches_reference, runs)

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))


@pytest.mark.parametrize("case,mode", [
    pytest.param(c, m, id=f"{c}-{m}") for c in ("mamba2", "hymba",)
    for m in _REF_MODES[c]])
def test_port_matches_reference(runs, case, mode):
    """Every parameter within 2e-4 and every round's loss within 1e-5
    (top-k: as ``check_port_matches_reference`` says)."""
    check_port_matches_reference(runs, case, mode)


@pytest.mark.parametrize("case", ["mamba2", "hymba"])
def test_port_loop_equals_port_vmap(runs, case):
    """The port's two execution paths agree, delta messages."""
    check_port_loop_equals_port_vmap(runs, case)


def test_lm_family_runs_under_the_mesh():
    """The reference runs a ``model.family="lm"`` vmap spec under the mesh
    (its one-device mesh here), so the port does too: reduced phi3 at one
    layer, the port's two CPU shards from the reference's init, every
    parameter within the LM bound 2e-4 and each round's loss within
    1e-5."""
    ov = {"model.family": "lm", "model.arch": "phi3-mini-3.8b",
          "model.layers": 1, "model.vocab": 128, "model.seq_len": 16,
          "data.num_clients": 2,
          "data.docs_per_node": 8, "data.val_docs_per_node": 4,
          "schedule.rounds": 2, "execution.batch_size": 8,
          "execution.learning_rate": 0.1, "execution.exec_mode": "vmap"}
    js = jspec_replace(jspec_replace(JSpec(), ov),
                       {"execution.mesh": {"data": 1}})
    jf = JFederation.from_spec(js)
    init = tfm.params_from_reference(
        jax.tree_util.tree_map(np.asarray, jf.engine.params), jf.model_cfg)
    jf.run()
    tf = Federation.from_spec(spec_replace(
        FederationSpec.from_dict(js.to_dict()),
        {"execution.mesh.data": 2}), device="cpu", init_params=init)
    tf.run()
    assert tf.mesh_shape == {"data": 2}
    want = {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jf.engine.params)[0]}
    assert list(want) == list(tf.engine.params)
    dev = max(float(np.abs(tf.engine.params[k].numpy() - v).max())
              for k, v in want.items())
    assert dev <= 2e-4
    assert len(tf.history) == len(jf.history) == 2
    for a, b in zip(tf.history, jf.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-5
