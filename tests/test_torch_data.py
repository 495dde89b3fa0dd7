"""Port data layer against the JAX package: corpora, split, draws."""
import numpy as np
import pytest
import torch

from repro.api.federation import build_clients as jbuild_clients
from repro.data.federated_split import parse_partition_spec as jparse
from repro.data.synthetic_lda import generate_lda_corpus as jgen
from repro_torch.api.federation import build_clients as tbuild_clients
from repro_torch.data.federated_split import (draw_generator,
                                              parse_partition_spec,
                                              round_minibatches)
from repro_torch.data.synthetic_lda import generate_lda_corpus as tgen

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
    with pytest.raises(NotImplementedError, match="A2"):
        tbuild_clients(tgen(seed=0, **_SIZE), 3, "iid", device="cpu")


def test_draws_are_seeded_and_full_batches_cover_the_corpus():
    data = {"bow": torch.arange(30, dtype=torch.float32)[:, None]}
    draws = [[b["bow"][:, 0].tolist() for b, _ in round_minibatches(
        data, 30, 100003 * 0 + 4, 2, batch_size=8, local_epochs=2)]
        for _ in range(2)]
    assert draws[0] == draws[1]                     # deterministic
    assert draws[0][0] != draws[0][1]               # epochs differ
    (full, n), = round_minibatches(data, 30, 5, 1, batch_size=64)
    assert n == 30 and sorted(full["bow"][:, 0].tolist()) == \
        list(range(30))
    g1 = draw_generator(5, 1, 0).initial_seed()
    assert g1 != draw_generator(5, 2, 0).initial_seed()
