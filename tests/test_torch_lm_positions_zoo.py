"""Explicit positions through whole models, left-padded: minicpm3-4b and qwen2-vl-7b
against the reference on the CPU (``torch_lm_positions_common``), one of
the files the whole-model cases of ``tests/test_torch_lm_positions.py``
are split over so that each runs in well under a minute."""
import pytest
from torch_lm_positions_common import check_left_padded_model


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen2-vl-7b"])
def test_left_padded_models_match_reference(arch):
    check_left_padded_model(arch)
