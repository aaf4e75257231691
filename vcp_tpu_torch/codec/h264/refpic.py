"""Reference-picture machinery of the host H.264 decoder; copy of
``vcp_tpu/codec/h264/refpic.py``.

The spec processes beyond a single reference: FrameNumWrap/PicNum
(8.2.4.1), P/B reference list initialisation (8.2.4.2),
ref_pic_list_modification (8.2.4.3), the sliding-window + adaptive
(MMCO) decoded reference picture marking (8.2.5), the pred_weight_table
syntax (7.3.3.2) and explicit/implicit weighted-prediction factors
(8.4.2.3). libx264 medium emits multi-reference, weighted, B-pyramid
streams, so ingesting real inputs needs all of this."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RefPic:
    """One DPB entry (decoded reference picture, frame coding only)."""
    poc: int
    frame_num: int
    planes: tuple                      # (y, u, v) uint8, MB-aligned
    # colocated motion for B direct derivation: list-0-preferred MV per
    # 8x8 block, whether that block's refIdx was 0, and whether it was
    # intra (treated as moving for colZero purposes)
    col_mv8: np.ndarray | None = None  # (2nMBy, 2nMBx, 2) quarter-pel
    col_ref0: np.ndarray | None = None  # (2nMBy, 2nMBx) bool
    long_term: bool = False            # never set by this decoder
    _planes_i32: tuple | None = None   # memoized int32 planes (MC path)

    def planes_i32(self) -> tuple:
        """int32 copies of the planes, converted once per picture (the
        recon MC paths read every reference each slice)."""
        if self._planes_i32 is None:
            self._planes_i32 = tuple(
                np.ascontiguousarray(p, np.int32) for p in self.planes)
        return self._planes_i32


def frame_num_wrap(fn: int, cur_fn: int, max_fn: int) -> int:
    """8.2.4.1 FrameNumWrap for a short-term reference frame."""
    return fn - max_fn if fn > cur_fn else fn


def init_list_p(dpb: list[RefPic], cur_fn: int, max_fn: int) -> list[RefPic]:
    """8.2.4.2.1: P list0 = short-term refs by descending PicNum."""
    return sorted(dpb, key=lambda r: -frame_num_wrap(r.frame_num, cur_fn,
                                                     max_fn))


def init_lists_b(dpb: list[RefPic], cur_poc: int) -> tuple[list[RefPic],
                                                           list[RefPic]]:
    """8.2.4.2.3: B list0/list1 from POC ordering (frame coding,
    short-term only)."""
    past = sorted((r for r in dpb if r.poc < cur_poc), key=lambda r: -r.poc)
    fut = sorted((r for r in dpb if r.poc > cur_poc), key=lambda r: r.poc)
    l0 = past + fut
    l1 = fut + past
    if len(l1) > 1 and l0 == l1:
        l1 = [l1[1], l1[0]] + l1[2:]
    return l0, l1


def parse_ref_list_modification(br, is_b: bool) -> tuple[list, list]:
    """7.3.3.1: per-list modification op lists [(op, value), ...]."""
    ops0: list = []
    ops1: list = []
    for ops, present in ((ops0, True), (ops1, is_b)):
        if not present:
            continue
        if not br.u(1):                # ref_pic_list_modification_flag
            continue
        while True:
            op = br.ue()
            if op == 3:
                break
            if op == 2:
                raise ValueError("long-term ref list modification "
                                 "unsupported")
            ops.append((op, br.ue()))  # abs_diff_pic_num_minus1
    return ops0, ops1


def apply_modification(init: list[RefPic], ops: list, cur_fn: int,
                       max_fn: int, num_active: int) -> list[RefPic]:
    """8.2.4.3.1: reorder short-term references by abs_diff_pic_num.

    ``init`` is the initialised list; returns the modified list truncated
    to ``num_active`` entries.
    """
    lst = list(init)
    # pad to num_active so the insertion indices exist (entries past the
    # end are dropped by the final truncation)
    while len(lst) < num_active and lst:
        lst.append(lst[-1])
    pred = cur_fn
    by_fn = {}
    for r in init:
        by_fn[r.frame_num] = r
    idx = 0
    for op, abs_diff_m1 in ops:
        abs_diff = abs_diff_m1 + 1
        if op == 0:
            pic_num_no_wrap = pred - abs_diff
            if pic_num_no_wrap < 0:
                pic_num_no_wrap += max_fn
        else:
            pic_num_no_wrap = pred + abs_diff
            if pic_num_no_wrap >= max_fn:
                pic_num_no_wrap -= max_fn
        pred = pic_num_no_wrap
        # PicNum = pic_num_no_wrap possibly wrapped down
        pic_num = pic_num_no_wrap
        if pic_num > cur_fn:
            pic_num -= max_fn
        # find the short-term pic whose PicNum matches
        target = None
        for r in init:
            if frame_num_wrap(r.frame_num, cur_fn, max_fn) == pic_num:
                target = r
                break
        if target is None:
            raise ValueError(f"ref list modification: PicNum {pic_num} "
                             "not in DPB")
        # 8.2.4.3.1-1: shift and insert at idx, removing a later duplicate
        lst.insert(idx, target)
        # remove the first later entry that is the same picture
        for j in range(idx + 1, len(lst)):
            if lst[j] is target:
                lst.pop(j)
                break
        idx += 1
    return lst[:num_active]


# ---------------------------------------------------------------------------
# Weighted prediction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WeightTable:
    """Explicit per-reference weights (7.3.3.2), identity by default."""
    luma_log2: int = 0
    chroma_log2: int = 0
    # arrays indexed [refIdx]: (weight, offset); chroma [refIdx][component]
    luma: list = dataclasses.field(default_factory=list)
    chroma: list = dataclasses.field(default_factory=list)

    def identity(self, ref: int) -> bool:
        lw, lo = self.luma[ref]
        ident = lw == (1 << self.luma_log2) and lo == 0
        for cw, co in self.chroma[ref]:
            ident = ident and cw == (1 << self.chroma_log2) and co == 0
        return ident


def parse_pred_weight_table(br, n0: int, n1: int) -> tuple[WeightTable,
                                                           WeightTable]:
    """7.3.3.2 pred_weight_table (4:2:0). ``n1`` 0 for P slices."""
    luma_log2 = br.ue()
    chroma_log2 = br.ue()
    tables = []
    for n in (n0, n1):
        t = WeightTable(luma_log2=luma_log2, chroma_log2=chroma_log2)
        for _ in range(n):
            if br.u(1):                       # luma_weight_flag
                t.luma.append((br.se(), br.se()))
            else:
                t.luma.append((1 << luma_log2, 0))
            if br.u(1):                       # chroma_weight_flag
                t.chroma.append([(br.se(), br.se()) for _ in range(2)])
            else:
                t.chroma.append([(1 << chroma_log2, 0)] * 2)
        tables.append(t)
    return tables[0], tables[1]


def _div_to_zero(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def implicit_weights(poc_cur: int, poc0: int, poc1: int) -> tuple[int, int]:
    """8.4.2.3.1 implicit bipred (w0, w1) with logWD 5 (>>6 with both)."""
    if poc1 == poc0:
        return 32, 32
    tb = max(-128, min(127, poc_cur - poc0))
    td = max(-128, min(127, poc1 - poc0))
    tx = _div_to_zero(16384 + abs(_div_to_zero(td, 2)), td)
    dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
    w1 = dsf >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1


def dist_scale_factor(poc_cur: int, poc0: int, poc1: int) -> int:
    """8.4.1.2.3 DistScaleFactor for temporal direct MV scaling."""
    tb = max(-128, min(127, poc_cur - poc0))
    td = max(-128, min(127, poc1 - poc0))
    if td == 0:
        return 256
    tx = _div_to_zero(16384 + abs(_div_to_zero(td, 2)), td)
    return max(-1024, min(1023, (tb * tx + 32) >> 6))


# ---------------------------------------------------------------------------
# Decoded reference picture marking (8.2.5)
# ---------------------------------------------------------------------------

def parse_dec_ref_pic_marking(br, is_idr: bool) -> list:
    """7.3.3.3 → list of (mmco, args...) ops; [] = sliding window."""
    if is_idr:
        br.u(1)                               # no_output_of_prior_pics
        if br.u(1):                           # long_term_reference_flag
            raise ValueError("long-term IDR marking unsupported")
        return []
    ops = []
    if br.u(1):                               # adaptive marking
        while True:
            op = br.ue()
            if op == 0:
                break
            if op == 1:
                ops.append((1, br.ue()))      # difference_of_pic_nums_m1
            elif op == 5:
                ops.append((5,))
            else:
                raise ValueError(f"MMCO {op} unsupported")
    return ops


def apply_marking(dpb: list[RefPic], ops: list, cur_fn: int,
                  max_fn: int, num_ref_frames: int) -> None:
    """Apply MMCO ops (or the sliding window when none) in place."""
    if ops:
        for op in ops:
            if op[0] == 1:
                pic_num = cur_fn - (op[1] + 1)
                # PicNum of short-term refs is FrameNumWrap here
                for i, r in enumerate(dpb):
                    if frame_num_wrap(r.frame_num, cur_fn,
                                      max_fn) == pic_num:
                        dpb.pop(i)
                        break
            elif op[0] == 5:
                dpb.clear()
        return
    while len(dpb) > max(1, num_ref_frames):
        i = min(range(len(dpb)),
                key=lambda j: frame_num_wrap(dpb[j].frame_num, cur_fn,
                                             max_fn))
        dpb.pop(i)


def ref_id_grids(ctx):
    """Per-8x8-block reference PICTURE ids for the deblock bS test
    (8.7.2.1 compares pictures, not indices — list modification can
    alias one picture under several refIdx values). Returns (id0, id1)
    int64 POC grids, -1 where the list is unused; id1 is None for P."""
    def grid(pics, ref8):
        poc = np.asarray([r.poc for r in pics], np.int64) \
            if pics else np.zeros(1, np.int64)
        return np.where(ref8 >= 0, poc[np.clip(ref8, 0, None)], -1)
    id0 = grid(ctx["list0_pics"], ctx["ref8_l0"])
    if ctx.get("list1") is None:
        return id0, None
    return id0, grid(ctx["list1_pics"], ctx["ref8_l1"])
