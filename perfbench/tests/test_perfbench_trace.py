"""The trace's arithmetic on hand-built intervals: busy time as a union,
overlaps counted once, idle gaps named by the harness's spans."""
import pytest

from fedbench.trace import (STEP, SYNC, WINDOW, Trace, covered, family_of,
                            gaps, kernel_families, union)


def test_union_merges_overlaps_and_touching():
    assert union([(3, 4), (0, 2), (1, 2.5), (2.5, 2.7), (5, 5)]) == \
        [(0, 2.7), (3, 4)]


def test_covered_counts_overlaps_once_and_clips():
    iv = [(0, 2), (1, 3), (1.5, 1.7), (8, 12)]
    assert covered(iv, 0, 10) == pytest.approx(3 + 2)
    assert covered(iv, 2.5, 9) == pytest.approx(0.5 + 1)


def test_gaps_are_the_holes_inside_the_window():
    assert gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == \
        [(0, 1), (3, 4), (5, 6)]


def _trace():
    spans = [(WINDOW, 0.0, 10.0), (STEP, 0.0, 4.0), (SYNC, 4.0, 5.0),
             (STEP, 5.0, 9.0), (SYNC, 9.0, 10.0), ("other", 0.0, 10.0)]
    ops = [("void flash_fwd_f32_kernel<64>(float*)", 0.5, 2.0),
           ("ampere_sgemm_128x64_nn", 1.0, 3.5),
           ("Memcpy DtoH (Device -> Pageable)", 4.2, 4.3),
           ("weighted_sum_kernel", 6.0, 9.5),
           ("ampere_sgemm_128x64_nn", 9.6, 11.0),    # ends past the window
           (WINDOW, 0.0, 10.0)]                      # a span's annotation
    return Trace(ops, spans)


def test_trace_busy_idle_and_breakdown():
    t = _trace()
    assert t.window_s == 10.0
    assert t.busy_s == pytest.approx(3.0 + 0.1 + 3.5 + 0.4)
    assert [o[0] for o in t.kernels()] == [
        "void flash_fwd_f32_kernel<64>(float*)", "ampere_sgemm_128x64_nn",
        "weighted_sum_kernel", "ampere_sgemm_128x64_nn"]
    b = t.breakdown()
    assert b["device_ops"][0] == ["weighted_sum_kernel", 3.5]
    assert b["device_ops"][1][0] == "ampere_sgemm_128x64_nn"
    assert b["device_ops"][1][1] == pytest.approx(2.5 + 0.4)
    # holes 4.3-6.0, 3.5-4.2 and 0-0.5 inside a step, 9.5-9.6 in a sync
    assert [g[0] for g in b["idle_gaps"]] == [STEP, STEP, STEP, SYNC]
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx([1.7, 0.7, 0.5,
                                                           0.1])


def test_trace_refuses_a_window_it_cannot_find():
    with pytest.raises(ValueError):
        Trace([], [(STEP, 0.0, 1.0)])


def test_kernel_names_match_whole_words_only():
    fam = kernel_families()
    assert family_of("void ssd_chunk_scan_f32_kernel<64, 128>(...)",
                     fam) == "ssd_scan"
    assert family_of("ssd_bwd_rows_f32_kernel", fam) == "ssd_scan_bwd"
    assert family_of("flash_bwd_dkdv_f32_kernel<64,64,true>", fam) == \
        "flash_attention_bwd"
    assert family_of("key_pass_kernel", fam) == "fed_topk_ef"
    assert family_of("my_weighted_sum_kernel_v2", fam) is None
    assert family_of("ampere_sgemm_128x64_nn", fam) is None
