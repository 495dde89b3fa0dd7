"""The paper's metrics in the port against the JAX package: WMD and
AMWMD (Eq. 7, ``repro_torch/metrics/wmd.py``) and topic diversity.

Twins of ``tests/test_metrics.py:65-109`` on the port's functions, and
the port's numbers against the reference's on the same seeded inputs
within 1e-9 (both are the same float64 numpy).
"""
import os

import numpy as np
import pytest
import torch

from repro.metrics import amwmd as jamwmd
from repro.metrics import topic_diversity as jdiversity
from repro.metrics import wmd as jwmd
from repro_torch.metrics import (amwmd, npmi_coherence, topic_descriptions,
                                 topic_diversity, wmd)

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_wmd_zero_for_identical_sets(rng):
    emb = rng.standard_normal((20, 8)).astype(np.float32)
    w = np.full(5, 0.2, np.float32)
    ids = np.arange(5)
    assert wmd(w, emb[ids], w, emb[ids]) < 1e-3


def test_wmd_symmetry_and_positivity(rng):
    emb = rng.standard_normal((30, 8)).astype(np.float32)
    wa = rng.dirichlet(np.ones(6)).astype(np.float32)
    wb = rng.dirichlet(np.ones(6)).astype(np.float32)
    a, b = emb[:6], emb[6:12]
    d1, d2 = wmd(wa, a, wb, b), wmd(wb, b, wa, a)
    assert d1 > 0
    np.testing.assert_allclose(d1, d2, rtol=1e-2)


def test_amwmd_zero_against_self(rng):
    beta = rng.dirichlet(np.full(50, 0.1), size=5).astype(np.float32)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    assert amwmd(beta, beta, emb, top_n=5) < 1e-2


def test_amwmd_federated_covers_better(rng):
    """The Fig.-4 mechanism: a model containing BOTH nodes' topics has
    lower AMWMD to each node than the other node's model."""
    emb = rng.standard_normal((100, 16)).astype(np.float32)
    node_a = rng.dirichlet(np.full(100, 0.05), size=4).astype(np.float32)
    node_b = rng.dirichlet(np.full(100, 0.05), size=4).astype(np.float32)
    fed = np.concatenate([node_a, node_b])
    assert amwmd(node_a, fed, emb, top_n=5) < \
        amwmd(node_a, node_b, emb, top_n=5)


def test_npmi_and_diversity(rng):
    v, d = 60, 200
    beta = rng.dirichlet(np.full(v, 0.05), size=5).astype(np.float32)
    bows = rng.poisson(0.5, (d, v)).astype(np.float32)
    c = npmi_coherence(beta, bows, top_n=5)
    assert -1.0 <= c <= 1.0
    td = topic_diversity(beta, top_n=10)
    assert 0.0 < td <= 1.0
    # fully distinct topics -> diversity 1
    distinct = np.eye(5, v, dtype=np.float32) + 1e-8
    assert topic_diversity(distinct, top_n=1) == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wmd_and_amwmd_equal_reference(seed):
    r = np.random.default_rng(seed)
    emb = r.standard_normal((80, 16)).astype(np.float32)
    for n in (3, 8):
        wa = r.dirichlet(np.ones(n)).astype(np.float32)
        wb = r.dirichlet(np.ones(n)).astype(np.float32)
        ia, ib = r.choice(80, n, replace=False), r.choice(80, n,
                                                          replace=False)
        assert abs(wmd(wa, emb[ia], wb, emb[ib])
                   - jwmd(wa, emb[ia], wb, emb[ib])) <= 1e-9
    ref = r.dirichlet(np.full(80, 0.05), size=6).astype(np.float32)
    ev = r.dirichlet(np.full(80, 0.05), size=9).astype(np.float32)
    for top_n in (5, 8):
        got, want = amwmd(ref, ev, emb, top_n=top_n), \
            jamwmd(ref, ev, emb, top_n=top_n)
        assert np.isfinite(got) and abs(got - want) <= 1e-9
    assert topic_diversity(ev, top_n=10) == jdiversity(ev, top_n=10)
    ids, w = topic_descriptions(ev, 5)[0]
    assert len(ids) == 5 and abs(float(w.sum()) - 1.0) < 1e-6
