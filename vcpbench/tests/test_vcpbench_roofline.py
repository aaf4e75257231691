"""Operation and byte counts of the kernels' least times."""

import pytest
import torch

from vcpbench import roofline


def test_motion_search_1080p_sr8():
    nbytes, ops = roofline.motion_search((1088, 1920), 8, True)
    assert ops == 8160 * 17 ** 2 * 256 == 603_709_440
    assert nbytes == 3 * 4 * 1088 * 1920 + 8 * 8160
    # operations bound it: ~9.0 us against ~7.5 us of bytes
    assert roofline.least_s(nbytes, ops) == pytest.approx(ops / 67e12)
    assert roofline.least_s(nbytes, ops) == pytest.approx(9.01e-6, rel=1e-3)


def test_deblock_fast_counts_filtered_lines():
    h, w = 32, 48
    bs_v = torch.zeros((w // 4 - 1, h // 4), dtype=torch.int32)
    bs_h = torch.zeros((h // 4 - 1, w // 4), dtype=torch.int32)
    bs_v[1, 2] = 2          # an 8-sample edge: 4 luma, 2 x 2 chroma lines
    bs_v[2, 0] = 1          # a 4-sample edge: luma only
    bs_h[3, 5] = 3          # an 8-sample edge
    nbytes, ops = roofline.deblock_fast((h, w), bs_v, bs_h)
    luma, chroma = 4 * 3, 2 * 2 * 2
    assert ops == luma * 35 + chroma * 20
    planes = 2 * 4 * (h * w + 2 * (h // 2) * (w // 2))
    assert nbytes == planes + 4 * (bs_v.numel() + bs_h.numel())


def test_deblock_general_strong_lines():
    h, w = 32, 48
    vthr = torch.zeros((4, h, w // 4), dtype=torch.int32)
    hthr = torch.zeros((4, h // 4, w), dtype=torch.int32)
    cvthr = torch.zeros((4, h // 2, w // 8), dtype=torch.int32)
    chthr = torch.zeros((4, h // 8, w // 2), dtype=torch.int32)
    vthr[0, :16, 4] = 4     # 16 strong lines
    hthr[0, 2, :8] = 3      # 8 normal lines
    cvthr[0, :8, 2] = 4     # 8 chroma lines a plane
    _, ops = roofline.deblock_general((h, w), vthr, hthr, cvthr, chthr,
                                      strong=True)
    assert ops == 16 * 50 + 8 * 35 + 2 * 8 * 20
    _, ops = roofline.deblock_general((h, w), vthr, hthr, cvthr, chthr,
                                      strong=False)
    assert ops == 24 * 35 + 2 * 8 * 20


def test_least_total_sums_calls():
    calls = [((1088, 1920), 8, True), ((1088, 1920), 8, False)]
    want = sum(roofline.least_s(*roofline.motion_search(*c)) for c in calls)
    assert roofline.least_total_s(calls, "motion_search") == want
