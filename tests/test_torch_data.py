"""Port data layer against the JAX package: corpora, split, draws."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.api.federation import build_clients as jbuild_clients
from repro.data.federated_split import parse_partition_spec as jparse
from repro.data.federated_split import partition_corpus as jpartition
from repro.data.federated_split import \
    round_minibatches as jround_minibatches
from repro.data.federated_split import \
    split_corpus_across_clients as jsplit
from repro.data.synthetic_lda import generate_lda_corpus as jgen
from repro_torch.api.federation import build_clients as tbuild_clients
from repro_torch.core import prng
from repro_torch.data.federated_split import (PARTITIONERS,
                                              parse_partition_spec,
                                              partition_corpus,
                                              round_minibatches,
                                              split_corpus_across_clients)
from repro_torch.data.synthetic_lda import generate_lda_corpus as tgen

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

_SIZE = dict(vocab_size=80, num_topics=6, num_nodes=3, shared_topics=2,
             docs_per_node=20, val_docs_per_node=5)


@pytest.mark.parametrize("seed", [0, 7])
def test_corpus_and_topic_split_bitwise_equal(seed):
    a, b = jgen(seed=seed, **_SIZE), tgen(seed=seed, **_SIZE)
    assert np.array_equal(a.beta, b.beta) and a.beta.dtype == b.beta.dtype
    assert np.array_equal(a.shared_topics, b.shared_topics)
    for field in ("node_thetas", "node_bows", "node_val_thetas",
                  "node_val_bows", "node_topics"):
        for x, y in zip(getattr(a, field), getattr(b, field)):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert (a.alpha, a.eta) == (b.alpha, b.eta)
    assert np.array_equal(a.concat_val_bows(), b.concat_val_bows())
    # the per-node 'topic' client corpora, the port's on the device given
    jc = jbuild_clients(a, 3, "topic")
    tc = tbuild_clients(b, 3, "topic", device="cpu")
    for x, y in zip(jc, tc):
        assert x.num_docs == y.num_docs
        assert np.array_equal(x.data["bow"], y.data["bow"].numpy())


@pytest.mark.parametrize("spec", ["topic", "by_label", "iid",
                                  "dirichlet(0.3)", "quantity_skew",
                                  "iid(0.3)", "dirichlet()", "nope",
                                  "dirichlet(-1)", "dirichlet(x)"])
def test_partition_spec_parser_matches(spec):
    try:
        want = jparse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_partition_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_partition_spec(spec) == want


def test_non_topic_partition_is_refused():
    """Non-``topic`` partitions now run: the pooled corpus re-split into
    client corpora equal to the reference's, and a split that leaves a
    client empty raises the reference's error."""
    a, b = jgen(seed=0, **_SIZE), tgen(seed=0, **_SIZE)
    for spec in ("iid", "dirichlet(0.3)", "quantity_skew(0.5)"):
        jc = jbuild_clients(a, 3, spec, seed=4)
        tc = tbuild_clients(b, 3, spec, device="cpu", seed=4)
        assert [c.num_docs for c in tc] == [c.num_docs for c in jc]
        for x, y in zip(jc, tc):
            assert np.array_equal(x.data["bow"], y.data["bow"].numpy())
    with pytest.raises(ValueError) as want:
        jbuild_clients(a, 30, "dirichlet(0.01)")
    with pytest.raises(ValueError) as got:
        tbuild_clients(b, 30, "dirichlet(0.01)", device="cpu")
    assert str(got.value) == str(want.value)


_LABELS = np.random.default_rng(11).integers(0, 7, 500)


@pytest.mark.parametrize("seed", [0, 3, 12345])
@pytest.mark.parametrize("spec", ["iid", "dirichlet(0.1)", "dirichlet(0.5)",
                                  "dirichlet(10.0)", "quantity_skew(0.5)",
                                  "topic"])
def test_partitioner_indices_bitwise(spec, seed):
    """Every registry partitioner's per-client index arrays equal the
    reference's bit for bit (dtype included), and cover the corpus
    disjointly."""
    want = jpartition(500, 5, spec, labels=_LABELS, seed=seed)
    got = partition_corpus(500, 5, spec, labels=_LABELS, seed=seed)
    assert len(got) == len(want)
    for x, y in zip(want, got):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(np.sort(np.concatenate(got)), np.arange(500))


@pytest.mark.parametrize("mode", sorted(PARTITIONERS))
def test_split_corpus_across_clients_matches(mode):
    kw = dict(labels=_LABELS, dirichlet_alpha=0.7, seed=5)
    for x, y in zip(jsplit(500, 4, mode=mode, **kw),
                    split_corpus_across_clients(500, 4, mode=mode, **kw)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for call in (jsplit, split_corpus_across_clients):
        with pytest.raises(ValueError, match="unknown split mode"):
            call(10, 2, mode="nope")


def test_draws_are_seeded_and_full_batches_cover_the_corpus():
    """The per-client iterator draws the reference's documents and
    in-batch keys (``round_minibatches`` in both packages, the client
    key ``fold_in(PRNGKey(4), 2)``), deterministically, epoch by
    epoch."""
    data = {"bow": torch.arange(30, dtype=torch.float32)[:, None]}
    key = prng.fold_in(prng.PRNGKey(4), 2)
    draws = [[(b["bow"][:, 0].tolist(), b["rng"].tolist())
              for b, _ in round_minibatches(data, 30, key, batch_size=8,
                                            local_epochs=2)]
             for _ in range(2)]
    assert draws[0] == draws[1]                     # deterministic
    assert draws[0][0] != draws[0][1]               # epochs differ
    jkey = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    want = [(np.asarray(b["bow"])[:, 0].tolist(),
             np.asarray(b["rng"]).astype(np.int64).tolist())
            for b, _ in jround_minibatches(
                {"bow": data["bow"].numpy()}, 30, jkey, batch_size=8,
                local_epochs=2)]
    assert draws[0] == want
    (full, n), = round_minibatches(data, 30, key, batch_size=64)
    assert n == 30 and sorted(full["bow"][:, 0].tolist()) == \
        list(range(30))
