"""The frozen counts: the model FLOPs equal the program's closed form, the
message width equals the weights' entries, and each kernel family's
operations and bytes match a count by hand at one shape."""
import dataclasses

import pytest

from counts import fed_aggregate, flash_attention, ssd_scan
from counts.model_flops import train_flops
from counts.peaks import bound_s
from counts.work import param_count, rows
from fedbench import cells, program


@pytest.mark.parametrize("name", cells.names("configs"))
@pytest.mark.parametrize("depth,batch,seq", [(2, 15, 2048), (1, 3, 512)])
def test_model_flops_equal_the_programs_analytic_estimate(name, depth,
                                                          batch, seq):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.analytic import estimate
    cfg = {**cells.load("configs", name), "num_layers": depth}
    model, recompute = train_flops(cfg, batch, seq)
    want = estimate(program.port_config(cfg),
                    ShapeConfig("t", seq, batch, "train")).flops
    assert model + recompute == want
    assert recompute == (0.0 if cfg["kind"] == "ssm" else
                         depth * 2 * batch * seq * min(seq, 1024) * 25 * 64
                         * 2)


@pytest.mark.parametrize("name", cells.names("configs"))
def test_message_width_is_the_weights_entries(name):
    cfg = cells.load("configs", name)
    shapes = program.param_shapes(cfg)
    from reference.federated import flat_leaves
    n = sum(t.numel() for t in flat_leaves(shapes).values())
    assert param_count(cfg) == n
    assert dataclasses.replace(program.port_config(cfg)).num_params() > 0


def test_causal_window_pairs_by_hand():
    # S = 6, window 3: keys seen by queries 0..5 are 1, 2, 3, 3, 3, 3
    assert flash_attention.pairs(6, 3) == 15
    assert flash_attention.pairs(6, 0) == 21
    assert flash_attention.pairs(2048, 1024) == 1573376


def test_flash_attention_counts_by_hand():
    # B=1, S=4 causal, Hq=2, Hkv=1, D=8, fp32: 10 pairs
    f, n = flash_attention.forward(1, 4, 2, 1, 8, 0, 4)
    assert f == 2 * 2 * 10 * 2 * 8              # QK^T and PV, 2 heads
    assert n == 4 * (4 * 2 * 8 * 2 + 4 * 1 * 8 * 2) + 4 * 2 * 4
    fb, nb = flash_attention.backward(1, 4, 2, 1, 8, 0, 4)
    assert fb == 2 * f
    assert nb == 4 * (4 * 2 * 8 * 4 + 4 * 1 * 8 * 4) + 4 * 2 * 4


def test_ssd_counts_by_hand():
    # S=4 in chunks of Q=2 (2 chunks), H=1, P=2, N=3
    per_chunk = 2 * 3 * 3 + 2 * 3 * 1 * 2 + 4 * 2 * 1 * 2 * 3
    assert ssd_scan.forward_flops(4, 1, 2, 3, 2) == 2 * per_chunk \
        + 2 * 2 * 1 * 2 * 3
    f, n = ssd_scan.forward(1, 4, 1, 2, 3, 2, 4)
    assert n == 4 * 4 * (2 * 2 + 2 * 3) + 4 * (4 + 2 * 3) + 4
    fb, nb = ssd_scan.backward(1, 4, 1, 2, 3, 2, 4)
    assert fb == 2 * f
    assert nb == 4 * 4 * (3 * 2 + 4 * 3) + 4 * 4 * 2 + 8


def test_federated_slab_counts_by_hand():
    assert fed_aggregate.weighted_sum(4, 10) == (80.0, 4.0 * (40 + 10 + 4))
    assert fed_aggregate.topk_ef(4, 10) == (0.0, 640.0)
    c = cells.cell("fedlm-hymba-topk-vmap")
    assert rows(c["traffic"]) == 15
    flops, nbytes = fed_aggregate.round_work("fed_topk_ef", c["config"],
                                             c["traffic"])
    assert bound_s(flops, nbytes, "float32") == nbytes / 3.35e12
