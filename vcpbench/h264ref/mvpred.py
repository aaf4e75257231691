"""General decoder-side motion-vector prediction (spec 8.4.1); copy of
``vcp_tpu/codec/h264/mvpred.py``.

Operates on the 8x8-block-grid state the decoder keeps per picture:
``mv8``    (2nMBy, 2nMBx, 2) quarter-pel (x, y)
``ref8``   (2nMBy, 2nMBx)   int8 refIdx, -1 = intra or list unused
``dec8``   (2nMBy, 2nMBx)   bool, block already decoded (partition
                            order inside the current MB included)

Sub-8x8 partitions are not represented (libx264's medium preset never
emits them); parsers raise on sub_mb_type below 8x8.

Every function is refIdx-aware per 8.4.1.3.2: a neighbor only
contributes its MV to the "exactly one match" rule when its refIdx
equals the current partition's; intra / other-list neighbors enter the
median as (0,0)."""

from __future__ import annotations


def _get(mv8, ref8, dec8, by, bx, nbx2):
    """Neighbor block -> ((mvx, mvy), refIdx) or None when the block is
    outside the picture / not yet decoded (MB-availability per 6.4.9)."""
    if by < 0 or bx < 0 or bx >= nbx2:
        return None
    if not dec8[by, bx]:
        return None
    return ((int(mv8[by, bx, 0]), int(mv8[by, bx, 1])), int(ref8[by, bx]))


def neighbors(mv8, ref8, dec8, by, bx, pw, nbx2):
    """A/B/C neighbor partitions of the partition whose top-left 8x8
    block is (by, bx) and whose width is ``pw`` blocks. C falls back to
    D (above-left) when above-right is unavailable (6.4.11.7)."""
    a = _get(mv8, ref8, dec8, by, bx - 1, nbx2)
    b = _get(mv8, ref8, dec8, by - 1, bx, nbx2)
    c = _get(mv8, ref8, dec8, by - 1, bx + pw, nbx2)
    if c is None:
        c = _get(mv8, ref8, dec8, by - 1, bx - 1, nbx2)
    return a, b, c


def mv_pred(mv8, ref8, dec8, by, bx, pw, ph, ref_idx, nbx2,
            part_idx: int = 0, mb_pw: int = 2):
    """8.4.1.3 luma MV prediction for one partition.

    (by, bx): top-left 8x8 block; (pw, ph) partition size in blocks;
    ``part_idx`` the partition's index inside its MB (for the 16x8/8x16
    directional rules); ``mb_pw`` unused placeholder for clarity.
    """
    a, b, c = neighbors(mv8, ref8, dec8, by, bx, pw, nbx2)

    # directional rules (8.4.1.3.1) for the two-partition MB shapes
    if (pw, ph) == (2, 1):                       # 16x8
        if part_idx == 0 and b is not None and b[1] == ref_idx:
            return b[0]
        if part_idx == 1 and a is not None and a[1] == ref_idx:
            return a[0]
    elif (pw, ph) == (1, 2):                     # 8x16
        if part_idx == 0 and a is not None and a[1] == ref_idx:
            return a[0]
        if part_idx == 1 and c is not None and c[1] == ref_idx:
            return c[0]

    # B and C both unavailable as MBs -> use A outright
    if b is None and c is None and a is not None:
        return a[0]

    matches = [n for n in (a, b, c) if n is not None and n[1] == ref_idx]
    if len(matches) == 1:
        return matches[0][0]

    def mv_of(n):
        # unavailable, intra, or other-list neighbors contribute (0,0)
        return n[0] if n is not None and n[1] >= 0 else (0, 0)

    vals = [mv_of(n) for n in (a, b, c)]
    return tuple(sorted(v[k] for v in vals)[1] for k in range(2))


def p_skip_mv(mv8, ref8, dec8, mby, mbx, nbx2):
    """8.4.1.1 P_Skip: refIdx 0; zero MV when either edge neighbor is
    missing or is a zero-motion ref-0 block, else the 16x16 median."""
    by, bx = 2 * mby, 2 * mbx
    a = _get(mv8, ref8, dec8, by, bx - 1, nbx2)
    b = _get(mv8, ref8, dec8, by - 1, bx, nbx2)
    if a is None or b is None:
        return (0, 0)
    if a[1] == 0 and a[0] == (0, 0):
        return (0, 0)
    if b[1] == 0 and b[0] == (0, 0):
        return (0, 0)
    return mv_pred(mv8, ref8, dec8, by, bx, 2, 2, 0, nbx2)


def direct_spatial_refs(st0, st1, mby, mbx, nbx2):
    """8.4.1.2.2 step 1: the direct-mode (refIdxL0, refIdxL1, mvL0,
    mvL1) for a whole MB. ``st0``/``st1`` are (mv8, ref8, dec8) tuples
    for list 0 / list 1. Returns (ref0, ref1, mv0, mv1) with ref -1 for
    an unused list; the per-block colZero override is applied by the
    caller (it needs the colocated picture)."""
    by, bx = 2 * mby, 2 * mbx
    refs = []
    for mv8, ref8, dec8 in (st0, st1):
        a, b, c = neighbors(mv8, ref8, dec8, by, bx, 2, nbx2)
        cand = [n[1] for n in (a, b, c) if n is not None and n[1] >= 0]
        refs.append(min(cand) if cand else -1)
    ref0, ref1 = refs
    if ref0 < 0 and ref1 < 0:                    # directZeroPredictionFlag
        return 0, 0, (0, 0), (0, 0), True
    mv0 = mv_pred(*st0, by, bx, 2, 2, ref0, nbx2) if ref0 >= 0 else (0, 0)
    mv1 = mv_pred(*st1, by, bx, 2, 2, ref1, nbx2) if ref1 >= 0 else (0, 0)
    return ref0, ref1, mv0, mv1, False
