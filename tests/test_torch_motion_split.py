"""The schedule of the ``motion_search`` kernel, on the CPU.

``vcp_tpu_torch.ops.motion.full_search_split`` models how the kernel
splits an MB's search (items of one dy and a run of dx, SADs summed over
words of four samples, the first minimum of each run) and merges it (the
lexicographic minimum of (cost, offset index) keys). It is held exactly
against vcp_tpu's search: the XLA ``full_search`` and the Pallas kernel
in interpret mode, with and without its fused prediction. A hypothesis
test checks the merge rule itself: any partition of the offsets into
runs, merged in any order, gives the first minimum."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vcp_tpu.ops import motion as jm
from vcp_tpu.ops.motion_pallas import full_search_pallas
from vcp_tpu_torch.ops import motion as tm

RUNS = (4, 12, 16, 20, 28)     # the kernel's run lengths, and a short one


def _planes(content, h, w, seed):
    rng = np.random.default_rng(seed)
    if content == "flat":           # every SAD ties
        cur = np.full((h, w), 77)
        ref = cur.copy()
    elif content == "saturated":    # 0/255 checkerboard: the widest sums
        yy, xx = np.mgrid[0:h, 0:w]
        cur = 255 * ((yy + xx) % 2)
        ref = np.where(rng.random((h, w)) < 0.5, 255 - cur, 255)
    else:                           # shifted noise: one clear minimum
        cur = rng.integers(0, 256, (h, w))
        ref = np.clip(np.roll(cur, (2, -3), (0, 1))
                      + rng.integers(-3, 4, (h, w)), 0, 255)
    return cur.astype(np.int32), ref.astype(np.int32)


@pytest.mark.parametrize("content", ["flat", "saturated", "random"])
@pytest.mark.parametrize("lam", [0, 8])
@pytest.mark.parametrize("sr", [0, 4, 8, 12])
@pytest.mark.parametrize("shape", [(64, 80), (16, 16)])
def test_split_matches_xla_full_search(shape, sr, lam, content):
    cur, ref = _planes(content, *shape, seed=sr + lam)
    mv_j, cost_j = jm.full_search(cur, ref, sr, lam)
    for run in RUNS:
        mv, cost = tm.full_search_split(torch.from_numpy(cur),
                                        torch.from_numpy(ref), sr, lam, run)
        np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_j))
        np.testing.assert_array_equal(cost.numpy(), np.asarray(cost_j))


@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("content", ["saturated", "random"])
@pytest.mark.parametrize("sr", [0, 4, 8, 12])
def test_split_matches_pallas_kernel(sr, content, with_pred):
    """Against the TPU kernel itself, interpret mode; with the fused
    prediction the model's vectors gather it through ``mc_luma``."""
    cur, ref = _planes(content, 64, 80, seed=40 + sr)
    out = full_search_pallas(cur, ref, sr, 8, interpret=True,
                             with_pred=with_pred)
    mv_p = out[0] if with_pred else out
    ref_t = torch.from_numpy(ref)
    for run in (12, 20):
        mv, _ = tm.full_search_split(torch.from_numpy(cur), ref_t, sr, 8,
                                     run)
        np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_p))
        if with_pred:
            np.testing.assert_array_equal(tm.mc_luma(ref_t, mv, sr).numpy(),
                                          np.asarray(out[1]))


@pytest.mark.parametrize("sr", [16, 24, 32])
@pytest.mark.parametrize("shape", [(16, 16), (32, 48)])
def test_split_wide_ranges(shape, sr):
    """The ladder's wide ranges and the wrapper's limit, wider than the
    frame, against the plain search (held against vcp_tpu in
    test_torch_motion.py); the merge order reversed."""
    cur, ref = _planes("random", *shape, seed=sr)
    cur_t, ref_t = torch.from_numpy(cur), torch.from_numpy(ref)
    want = tm.full_search(cur_t, ref_t, sr, 3)
    for run in (16, 28):
        n_items = (2 * sr + 1) * -(-(2 * sr + 1) // run)
        got = tm.full_search_split(cur_t, ref_t, sr, 3, run,
                                   order=range(n_items - 1, -1, -1))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_split_merge_order_does_not_matter():
    """Flat content (every cost ties at lam 0): any merge order keeps the
    first offset."""
    cur, ref = _planes("flat", 32, 32, seed=0)
    rng = np.random.default_rng(1)
    for _ in range(5):
        got, _ = tm.full_search_split(torch.from_numpy(cur),
                                      torch.from_numpy(ref), 8, 0, 12,
                                      order=rng.permutation(17 * 2))
        assert (got.numpy() == -8).all()


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(-3, 3), min_size=1, max_size=48), st.data())
def test_any_partition_any_order_gives_first_minimum(costs, data):
    n = len(costs)
    run_of = np.array(data.draw(st.lists(st.integers(0, 6), min_size=n,
                                         max_size=n)))
    order = data.draw(st.permutations(sorted(set(run_of.tolist()))))
    keys = tm.sad_keys(torch.tensor(costs), torch.arange(n))
    best = None
    for r in order:
        run_best = keys[torch.from_numpy(run_of == r)].min()
        best = run_best if best is None else torch.minimum(best, run_best)
    cost, index = tm.key_cost_index(best)
    assert (int(cost), int(index)) == (min(costs), costs.index(min(costs)))
