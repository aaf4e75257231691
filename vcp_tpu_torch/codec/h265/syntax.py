"""HEVC slice_segment_data syntax (spec 7.3.8) — encode and decode.

Copy of ``vcp_tpu/codec/h265/syntax.py`` (host code): the slice
writer of every HEVC preset, pure-Python CABAC.
"""

from __future__ import annotations

import numpy as np

from ..cabac import CabacDecoder, CabacEncoder
from .ctx import HevcContexts
from .residual import decode_residual, encode_residual

MODE_DC = 1
MODE_VER = 26


def luma_mpm(cand_a: int, cand_b: int):
    """Most-probable-mode list (spec 8.4.2)."""
    if cand_a == cand_b:
        if cand_a < 2:
            return [0, 1, 26]
        return [cand_a,
                2 + ((cand_a + 29) % 32),
                2 + ((cand_a - 2 + 1) % 32)]
    if cand_a != 0 and cand_b != 0:
        m2 = 0
    elif cand_a != 1 and cand_b != 1:
        m2 = 1
    else:
        m2 = 26
    return [cand_a, cand_b, m2]


def amvp_candidates(mvq, by: int, bx: int, nbx: int):
    """AMVP candidate list for the uniform 32x32 inter-PU grid, in
    quarter-pel units. ``mvq`` holds final MVs of already-processed PUs
    (raster order). Spatial A = A1 (left; A0 below-left is undecoded),
    spatial B = first of B0 (above-right), B1 (above); duplicate pruned,
    zero-filled to two candidates. No scaling (single ref, same POC)."""
    cands = []
    if bx > 0:
        cands.append((int(mvq[by][bx - 1][0]), int(mvq[by][bx - 1][1])))
    if by > 0:
        if bx + 1 < nbx:
            b = mvq[by - 1][bx + 1]
        else:
            b = mvq[by - 1][bx]
        b = (int(b[0]), int(b[1]))
        if not (cands and cands[0] == b):
            cands.append(b)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]


def _write_egk(enc: CabacEncoder, v: int, k: int) -> None:
    while v >= (1 << k):
        enc.encode_bypass(1)
        v -= 1 << k
        k += 1
    enc.encode_bypass(0)
    if k:
        enc.encode_bypass_bits(v, k)


def _read_egk(dec: CabacDecoder, k: int) -> int:
    v = 0
    while dec.decode_bypass():
        v += 1 << k
        k += 1
    if k:
        v += dec.decode_bypass_bits(k)
    return v


def _encode_mvd(enc: CabacEncoder, cx: HevcContexts, dx: int, dy: int):
    """mvd_coding (spec 7.3.8.9); components ordered x then y."""
    gr0 = [1 if dx != 0 else 0, 1 if dy != 0 else 0]
    gr1 = [1 if abs(dx) > 1 else 0, 1 if abs(dy) > 1 else 0]
    enc.encode(cx["mvd_gr0", 0], gr0[0])
    enc.encode(cx["mvd_gr0", 0], gr0[1])
    if gr0[0]:
        enc.encode(cx["mvd_gr1", 0], gr1[0])
    if gr0[1]:
        enc.encode(cx["mvd_gr1", 0], gr1[1])
    for comp, g0, g1 in ((dx, gr0[0], gr1[0]), (dy, gr0[1], gr1[1])):
        if g0:
            if g1:
                _write_egk(enc, abs(comp) - 2, 1)
            enc.encode_bypass(1 if comp < 0 else 0)


def _decode_mvd(dec: CabacDecoder, cx: HevcContexts):
    gr0 = [dec.decode(cx["mvd_gr0", 0]), dec.decode(cx["mvd_gr0", 0])]
    gr1 = [0, 0]
    if gr0[0]:
        gr1[0] = dec.decode(cx["mvd_gr1", 0])
    if gr0[1]:
        gr1[1] = dec.decode(cx["mvd_gr1", 0])
    out = []
    for g0, g1 in zip(gr0, gr1):
        if not g0:
            out.append(0)
            continue
        mag = (_read_egk(dec, 1) + 2) if g1 else 1
        sign = dec.decode_bypass()
        out.append(-mag if sign else mag)
    return out[0], out[1]  # (dx, dy)


# ---------------------------------------------------------------------------
# Slice data
# ---------------------------------------------------------------------------

def encode_slice_data(slice_qp: int, is_idr: bool, levels_y, levels_u,
                      levels_v, mv=None, modes=None) -> bytes:
    """CABAC payload for one single-slice frame. levels_* are
    (nby, nbx, N, N) int arrays; mv is (nby, nbx, 2) QUARTER-pel
    (dy, dx) for P slices; ``modes`` the per-CTU luma intra mode for I
    slices (None = the row0-DC/rows-V legacy scheme)."""
    nby, nbx = levels_y.shape[:2]
    enc = CabacEncoder()
    cx = HevcContexts(slice_qp, init_type=0 if is_idr else 1)
    lmode = np.full((nby, nbx), MODE_DC, np.int32)
    mvq = np.zeros((nby, nbx, 2), np.int32)  # (x, y) quarter-pel

    for by in range(nby):
        for bx in range(nbx):
            enc.encode(cx["split_cu", 0], 0)
            zy = np.asarray(levels_y[by, bx], np.int32)
            zu = np.asarray(levels_u[by, bx], np.int32)
            zv = np.asarray(levels_v[by, bx], np.int32)
            cbf_y = bool(np.any(zy))
            cbf_u = bool(np.any(zu))
            cbf_v = bool(np.any(zv))

            if is_idr:
                if modes is not None:
                    mode = int(modes[by, bx])
                else:
                    mode = MODE_DC if by == 0 else MODE_VER
                cand_a = int(lmode[by, bx - 1]) if bx > 0 else MODE_DC
                cand_b = MODE_DC  # above PU is in another CTB row
                mpm = luma_mpm(cand_a, cand_b)
                if mode in mpm:
                    idx = mpm.index(mode)
                    enc.encode(cx["prev_intra", 0], 1)
                    enc.encode_bypass(1 if idx else 0)
                    if idx:
                        enc.encode_bypass(idx - 1)
                else:
                    rem = mode - sum(1 for m in mpm if m < mode)
                    enc.encode(cx["prev_intra", 0], 0)
                    enc.encode_bypass_bits(rem, 5)
                lmode[by, bx] = mode
                # chroma: DM when the luma mode IS the chroma prediction
                # we run (DC on row 0, Vertical elsewhere); explicit
                # Vertical from the candidate list otherwise
                chroma_pred = MODE_DC if by == 0 else MODE_VER
                if mode == chroma_pred:
                    enc.encode(cx["intra_chroma", 0], 0)   # DM
                else:
                    enc.encode(cx["intra_chroma", 0], 1)
                    # candModeList [planar, vertical, horiz, DC] with the
                    # luma-mode entry substituted by 34 (7.4.9.11)
                    cand = [0, 26, 10, 1]
                    if mode in cand:
                        cand[cand.index(mode)] = 34
                    ci = cand.index(chroma_pred)
                    enc.encode_bypass(ci >> 1)
                    enc.encode_bypass(ci & 1)
                enc.encode(cx["cbf_chroma", 0], 1 if cbf_u else 0)
                enc.encode(cx["cbf_chroma", 0], 1 if cbf_v else 0)
                enc.encode(cx["cbf_luma", 1], 1 if cbf_y else 0)
                if cbf_y:
                    encode_residual(enc, cx, zy, 5, 0)
                if cbf_u:
                    encode_residual(enc, cx, zu, 4, 1)
                if cbf_v:
                    encode_residual(enc, cx, zv, 4, 2)
            else:
                enc.encode(cx["cu_skip", 0], 0)
                enc.encode(cx["pred_mode", 0], 0)   # inter
                enc.encode(cx["part_mode", 0], 1)   # 2Nx2N
                enc.encode(cx["merge_flag", 0], 0)
                # quarter-pel MV as (x, y); device mv is quarter (dy,dx)
                mx = int(mv[by, bx, 1])
                my = int(mv[by, bx, 0])
                cands = amvp_candidates(mvq, by, bx, nbx)
                costs = [abs(mx - c[0]) + abs(my - c[1]) for c in cands]
                flag = 1 if costs[1] < costs[0] else 0
                _encode_mvd(enc, cx, mx - cands[flag][0],
                            my - cands[flag][1])
                enc.encode(cx["mvp_flag", 0], flag)
                mvq[by, bx] = (mx, my)
                rqt = cbf_y or cbf_u or cbf_v
                enc.encode(cx["rqt_root_cbf", 0], 1 if rqt else 0)
                if rqt:
                    enc.encode(cx["cbf_chroma", 0], 1 if cbf_u else 0)
                    enc.encode(cx["cbf_chroma", 0], 1 if cbf_v else 0)
                    if cbf_u or cbf_v:
                        enc.encode(cx["cbf_luma", 1], 1 if cbf_y else 0)
                    else:
                        assert cbf_y  # inferred 1 when chroma is clean
                    if cbf_y:
                        encode_residual(enc, cx, zy, 5, 0)
                    if cbf_u:
                        encode_residual(enc, cx, zu, 4, 1)
                    if cbf_v:
                        encode_residual(enc, cx, zv, 4, 2)

            last = by == nby - 1 and bx == nbx - 1
            enc.encode_terminate(1 if last else 0)
    return enc.flush()


def decode_slice_data(data: bytes, slice_qp: int, is_idr: bool,
                      nby: int, nbx: int):
    """Parse one slice's CABAC payload. Returns (levels_y, levels_u,
    levels_v, modes, mv) where modes is the per-CTU intra mode (I) and
    mv the full-pel (dy, dx) field (P)."""
    dec = CabacDecoder(data)
    cx = HevcContexts(slice_qp, init_type=0 if is_idr else 1)
    levels_y = np.zeros((nby, nbx, 32, 32), np.int32)
    levels_u = np.zeros((nby, nbx, 16, 16), np.int32)
    levels_v = np.zeros((nby, nbx, 16, 16), np.int32)
    modes = np.full((nby, nbx), MODE_DC, np.int32)
    cmodes = np.full((nby, nbx), -1, np.int32)   # -1 = DM
    mvq = np.zeros((nby, nbx, 2), np.int32)
    mv = np.zeros((nby, nbx, 2), np.int32)

    for by in range(nby):
        for bx in range(nbx):
            assert dec.decode(cx["split_cu", 0]) == 0
            if is_idr:
                prev = dec.decode(cx["prev_intra", 0])
                if prev:
                    idx = dec.decode_bypass()
                    if idx:
                        idx += dec.decode_bypass()
                else:
                    idx = None
                    rem = dec.decode_bypass_bits(5)
                cand_a = int(modes[by, bx - 1]) if bx > 0 else MODE_DC
                mpm = luma_mpm(cand_a, MODE_DC)
                if idx is not None:
                    mode = mpm[idx]
                else:
                    mode = rem
                    for m in sorted(mpm):
                        if mode >= m:
                            mode += 1
                modes[by, bx] = mode
                if dec.decode(cx["intra_chroma", 0]) == 0:
                    cmodes[by, bx] = -1        # DM (= luma mode)
                else:
                    ci = (dec.decode_bypass() << 1) | dec.decode_bypass()
                    cand = [0, 26, 10, 1]
                    if mode in cand:
                        cand[cand.index(mode)] = 34
                    cmodes[by, bx] = cand[ci]
                cbf_u = dec.decode(cx["cbf_chroma", 0])
                cbf_v = dec.decode(cx["cbf_chroma", 0])
                cbf_y = dec.decode(cx["cbf_luma", 1])
                if cbf_y:
                    levels_y[by, bx] = decode_residual(dec, cx, 5, 0)
                if cbf_u:
                    levels_u[by, bx] = decode_residual(dec, cx, 4, 1)
                if cbf_v:
                    levels_v[by, bx] = decode_residual(dec, cx, 4, 2)
            else:
                assert dec.decode(cx["cu_skip", 0]) == 0
                assert dec.decode(cx["pred_mode", 0]) == 0
                assert dec.decode(cx["part_mode", 0]) == 1
                assert dec.decode(cx["merge_flag", 0]) == 0
                dx, dy = _decode_mvd(dec, cx)
                flag = dec.decode(cx["mvp_flag", 0])
                cands = amvp_candidates(mvq, by, bx, nbx)
                mx = cands[flag][0] + dx
                my = cands[flag][1] + dy
                mvq[by, bx] = (mx, my)
                mv[by, bx] = (my, mx)           # quarter-pel (dy, dx)
                if dec.decode(cx["rqt_root_cbf", 0]):
                    cbf_u = dec.decode(cx["cbf_chroma", 0])
                    cbf_v = dec.decode(cx["cbf_chroma", 0])
                    if cbf_u or cbf_v:
                        cbf_y = dec.decode(cx["cbf_luma", 1])
                    else:
                        cbf_y = 1
                    if cbf_y:
                        levels_y[by, bx] = decode_residual(dec, cx, 5, 0)
                    if cbf_u:
                        levels_u[by, bx] = decode_residual(dec, cx, 4, 1)
                    if cbf_v:
                        levels_v[by, bx] = decode_residual(dec, cx, 4, 2)

            last = by == nby - 1 and bx == nbx - 1
            term = dec.decode_terminate()
            assert term == (1 if last else 0), "slice CTU count mismatch"
    return levels_y, levels_u, levels_v, (modes, cmodes), mv
