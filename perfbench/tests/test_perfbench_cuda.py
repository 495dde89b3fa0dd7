"""On the card (skips on a host without one): a short run of each cell at
small widths through the program's CUDA kernels comes out correct, and
the control in the card's own TF32 fails the cell's limits.  The widths
are the smallest the kernels take: heads of 64, chunks of 256."""
from types import SimpleNamespace

import pytest
import torch

import run
from conftest import tiny_cell
from fedbench import check, inputs, program

SMALL = {
    "hybrid": dict(d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
                   d_ff=512, vocab_size=1000, sliding_window=256,
                   ssm_state_dim=16, ssm_head_dim=64, ssm_chunk_size=256),
    "ssm": dict(d_model=256, vocab_size=1000, ssm_state_dim=128,
                ssm_head_dim=64, ssm_chunk_size=256),
}


@pytest.fixture(params=["fedlm-hymba-topk-vmap", "fedlm-mamba2-fedavg-vmap"])
def small(request):
    c = tiny_cell(request.param, seq_len=512)
    c["config"] = {**c["config"], **SMALL[c["config"]["kind"]]}
    return c


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(small):
    dev = _card()
    out = run.run_cell(small, seed=2 ** 31 + 5, seconds=1.0, traced=True,
                       device=dev)
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0 and "breakdown" in out
    assert out["metrics"]["port_calls_per_round"]["value"] > 0


@pytest.mark.cuda
def test_the_control_on_the_card_fails(small):
    dev = _card()
    cfg, traffic = small["config"], small["traffic"]
    st = SimpleNamespace(shapes=program.param_shapes(cfg), exec_seed=9,
                         docs=inputs.make_docs(traffic, cfg["vocab_size"], 9,
                                               dev))
    ref = run.reference(small, 9, st, dev)
    control = run.reference(small, 9, st, dev, precision="tf32")
    ok, checks = check.judge(check.numbers(control, ref), small["limits"])
    assert not ok, checks
