"""The port's federated LM training against the JAX reference: the
top-k case (reduced phi3, 3 rounds, ``compression_topk=0.25``) on the
host loop and the batched path, the error memory, and join/leave churn
on both paths (the set-up of ``test_torch_lm_federation.py``, from
``torch_lm_federation_common.py``)."""
import os

import numpy as np
import pytest
import torch

from repro_torch.api import Federation, build_lm_corpus, max_param_dev
from repro_torch.core import engine as tengine
from torch_lm_federation_common import (  # noqa: F401
    _REF_MODES, _WHOLE, _lm_spec, check_port_matches_reference, runs)

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))


@pytest.mark.parametrize("case,mode", [
    pytest.param(c, m, id=f"{c}-{m}") for c in ("phi3-topk",)
    for m in _REF_MODES[c]])
def test_port_matches_reference(runs, case, mode):
    """Every parameter within 2e-4 and every round's loss within 1e-5
    (top-k: as ``check_port_matches_reference`` says)."""
    check_port_matches_reference(runs, case, mode)


def test_loop_equals_vmap_under_churn(monkeypatch):
    """Join/leave churn shrinks and grows the cohort; fixed-K padding
    holds the stacked client axis at K every round (the port runs eagerly,
    so this takes the place of the reference's ``trace_counts`` pin), and
    the batched path still equals the loop."""
    widths = []
    real = tengine.stacked_round_batches

    def spy(*args, **kw):
        stacked, counts = real(*args, **kw)
        widths.append(stacked["tokens"].shape[0])
        return stacked, counts
    monkeypatch.setattr(tengine, "stacked_round_batches", spy)
    ov = {"schedule.rounds": 4, "schedule.clients_per_round": 3,
          "schedule.client_join_round": (0, 1, 2),
          "schedule.client_leave_round": (3, 0, 0), **_WHOLE}
    corpus = build_lm_corpus(_lm_spec())
    feds = {mode: Federation.from_spec(
        _lm_spec(**{**ov, "execution.exec_mode": mode}), device="cpu",
        corpus=corpus) for mode in ("loop", "vmap")}
    for fed in feds.values():
        fed.run()
    ks = [h["participants"] for h in feds["vmap"].history]
    assert len(set(ks)) > 1, f"churn schedule produced no churn: {ks}"
    assert widths == [3] * 4
    assert max_param_dev(feds["loop"].params, feds["vmap"].params) <= 1e-5
    for a, b in zip(feds["loop"].history, feds["vmap"].history):
        assert a["participants"] == b["participants"]
        assert abs(a["loss"] - b["loss"]) <= 1e-5


def test_topk_error_memory_engages():
    """Top-k sparsified LM deltas on the batched path: the error memory
    keeps non-zero residuals and the loss falls."""
    fed = Federation.from_spec(
        _lm_spec(**{"schedule.rounds": 3, "transforms.names": ("topk",),
                    "transforms.compression_topk": 0.25,
                    "execution.exec_mode": "vmap"}), device="cpu")
    fed.run()
    losses = [h["loss"] for h in fed.history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    err = fed.engine._tstate["topk"]
    assert float(err.abs().max()) > 0, "error feedback never engaged"
