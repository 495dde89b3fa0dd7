"""Shared set-up of the benchmark's CPU tests: the harness's folder and the
program's ``src`` on the path, few threads, and the cells cut to a size a
CPU runs in seconds (widths cut here only; the committed cells run at the
published widths on the card)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent / "src"))

import torch  # noqa: E402

torch.set_num_threads(2)

TINY = {
    "hybrid": dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                   d_ff=128, vocab_size=97, sliding_window=24,
                   ssm_state_dim=8, ssm_head_dim=16, ssm_chunk_size=16),
    "ssm": dict(d_model=64, vocab_size=97, ssm_state_dim=16,
                ssm_head_dim=16, ssm_chunk_size=16),
}


def tiny_cell(name: str, seq_len: int = 48):
    """Cell ``name`` at tiny widths and 48-token documents (two SSD chunks
    and more, the attention window crossed), its traffic otherwise as
    committed."""
    from fedbench import cells
    c = cells.cell(name)
    c["config"] = {**c["config"], **TINY[c["config"]["kind"]]}
    c["traffic"] = {**c["traffic"], "seq_len": seq_len}
    return c


@pytest.fixture(params=["fedlm-hymba-topk-vmap", "fedlm-mamba2-fedavg-vmap"])
def tiny(request):
    return tiny_cell(request.param)
