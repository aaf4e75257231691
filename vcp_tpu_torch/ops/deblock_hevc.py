"""HEVC in-loop deblocking filter (spec 8.7.2): torch passes and a numpy
entry point for the host decoders.

Port of ``vcp_tpu/ops/deblock_hevc.py``. HEVC deblocking is parallel by
construction: all vertical edges of the picture filter first (reading
unfiltered samples), then all horizontal edges (reading the vertical
pass's output), on the 8x8 luma grid with per-4-line-segment decisions,
so each direction is a few whole-frame elementwise passes.

The edge filters ``_luma_edge_filter`` / ``_chroma_edge_filter`` take an
array namespace ``xp`` (``numpy`` or ``torch``), as in ``vcp_tpu``: the
foreign decoder calls them with numpy and per-segment thresholds. The
frame passes are torch; :func:`deblock_frame_hevc_np` runs them on CPU
tensors for the validation decoder (int32 arithmetic, the same on every
device).

Scope of the encoder's streams: uniform slice QP, bS 2 on the CTU grid of
intra pictures, bS from the nz / mv grids of P pictures, 4:2:0.
"""

from __future__ import annotations

import numpy as np
import torch

# Table 8-12: beta' and tc' by Q.
BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22,
                24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50,
                52, 54, 56, 58, 60, 62, 64], np.int32)      # Q 0..51
TC_TABLE = np.array(
    [0] * 18 + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
                4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
                22, 24], np.int32)                           # Q 0..53


def _clip1(x, xp):
    return xp.clip(x, 0, 255)


def _luma_edge_filter(p, q, bs_seg, beta, tc_e, xp):
    """Filter one direction's luma edges.

    p, q: (..., n_seg, 4 lines, 4 samples) int32 — p[..., :, 3] is p0
    (adjacent to the edge), q[..., :, 0] is q0. bs_seg: (..., n_seg)
    per-segment boundary strength; beta a scalar or per segment; tc_e
    (..., n_seg) per-segment tc (already bS-indexed). Returns filtered
    (p, q).
    """
    p3 = p[..., 0]
    p2 = p[..., 1]
    p1 = p[..., 2]
    p0 = p[..., 3]
    q0 = q[..., 0]
    q1 = q[..., 1]
    q2 = q[..., 2]
    q3 = q[..., 3]
    # segment decisions from lines 0 and 3 (spec 8.7.2.5.3)
    dpl = xp.abs(p2 - 2 * p1 + p0)            # (..., n_seg, 4)
    dql = xp.abs(q2 - 2 * q1 + q0)
    dp0, dp3 = dpl[..., 0], dpl[..., 3]
    dq0, dq3 = dql[..., 0], dql[..., 3]
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    d = dpq0 + dpq3
    tc = tc_e
    filt = (bs_seg > 0) & (d < beta)

    def strong_line(i):
        return ((2 * (dpl[..., i] + dql[..., i]) < (beta >> 2))
                & (xp.abs(p3[..., i] - p0[..., i])
                   + xp.abs(q0[..., i] - q3[..., i]) < (beta >> 3))
                & (xp.abs(p0[..., i] - q0[..., i])
                   < ((5 * tc + 1) >> 1)))

    strong = strong_line(0) & strong_line(3)
    dep1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    deq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    tc4 = tc[..., None]
    filt4 = filt[..., None]
    strong4 = (strong & filt)[..., None]
    # --- normal filter
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    small = xp.abs(delta) < 10 * tc4
    delta = xp.clip(delta, -tc4, tc4)
    np0 = _clip1(p0 + delta, xp)
    nq0 = _clip1(q0 - delta, xp)
    tc2 = tc4 >> 1
    dp1v = xp.clip((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tc2, tc2)
    dq1v = xp.clip((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tc2, tc2)
    np1 = _clip1(p1 + dp1v, xp)
    nq1 = _clip1(q1 + dq1v, xp)
    normal = filt4 & ~strong4 & small
    dep14 = dep1[..., None]
    deq14 = deq1[..., None]
    # --- strong filter (clips to +-2tc around the original sample)
    t2 = 2 * tc4

    def near(v, orig):
        return xp.clip(v, orig - t2, orig + t2)

    sp0 = near((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = near((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = near((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = near((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, q0)
    sq1 = near((q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = near((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    out_p0 = xp.where(strong4, sp0, xp.where(normal, np0, p0))
    out_p1 = xp.where(strong4, sp1,
                      xp.where(normal & dep14, np1, p1))
    out_p2 = xp.where(strong4, sp2, p2)
    out_q0 = xp.where(strong4, sq0, xp.where(normal, nq0, q0))
    out_q1 = xp.where(strong4, sq1,
                      xp.where(normal & deq14, nq1, q1))
    out_q2 = xp.where(strong4, sq2, q2)

    pf = xp.stack([p3, out_p2, out_p1, out_p0], axis=-1)
    qf = xp.stack([out_q0, out_q1, out_q2, q3], axis=-1)
    return pf, qf


def _chroma_edge_filter(p, q, bs_seg, tc_e, xp):
    """Chroma edges filter only at bS==2 (intra): p (..., n, 2) cols
    [p1 p0], q (..., n, 2) cols [q0 q1]; per-line tc."""
    p1, p0 = p[..., 0], p[..., 1]
    q0, q1 = q[..., 0], q[..., 1]
    tc = tc_e
    delta = xp.clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc)
    on = bs_seg == 2
    out_p0 = xp.where(on, _clip1(p0 + delta, xp), p0)
    out_q0 = xp.where(on, _clip1(q0 - delta, xp), q0)
    return (xp.stack([p1, out_p0], axis=-1),
            xp.stack([out_q0, q1], axis=-1))


def _vertical_pass_luma(y: torch.Tensor, bs_v: torch.Tensor,
                        qp: int) -> torch.Tensor:
    """Vertical edges at x = 8*(e+1); bs_v (ne, H/4) per edge per 4-line
    segment. y: (H, W)."""
    h, w = y.shape
    ne = w // 8 - 1
    beta = int(BETA_TABLE[min(max(qp, 0), 51)])
    blocks = y.reshape(h, w // 8, 8)
    # group rows by 4 -> segments: (H/4, 4, ne, 4) -> (ne, H/4, 4, 4)
    p = blocks[:, :-1, 4:8].reshape(h // 4, 4, ne, 4).permute(2, 0, 1, 3)
    q = blocks[:, 1:, 0:4].reshape(h // 4, 4, ne, 4).permute(2, 0, 1, 3)
    tc1 = int(TC_TABLE[min(qp + 0, 53)])           # bS=1
    tc2 = int(TC_TABLE[min(qp + 2, 53)])           # bS=2
    tc_e = torch.where(bs_v == 2, tc2, tc1).to(torch.int32)
    pf, qf = _luma_edge_filter(p, q, bs_v, beta, tc_e, torch)
    out = blocks.clone()
    out[:, :-1, 4:8] = pf.permute(1, 2, 0, 3).reshape(h, ne, 4)
    out[:, 1:, 0:4] = qf.permute(1, 2, 0, 3).reshape(h, ne, 4)
    return out.reshape(h, w)


def _vertical_pass_chroma(c: torch.Tensor, bs_v: torch.Tensor,
                          qpc: int) -> torch.Tensor:
    """Chroma vertical edges on the 8-chroma-sample grid (16 luma px).
    bs_v: (ne_c, Hc) per chroma edge per line."""
    hc, wc = c.shape
    blocks = c.reshape(hc, wc // 8, 8)
    p = blocks[:, :-1, 6:8].permute(1, 0, 2)      # (ne, Hc, 2)
    q = blocks[:, 1:, 0:2].permute(1, 0, 2)
    tc = int(TC_TABLE[min(qpc + 2, 53)])
    tc_e = torch.full(bs_v.shape, tc, dtype=torch.int32, device=c.device)
    pf, qf = _chroma_edge_filter(p, q, bs_v, tc_e, torch)
    out = blocks.clone()
    out[:, :-1, 6:8] = pf.permute(1, 0, 2)
    out[:, 1:, 0:2] = qf.permute(1, 0, 2)
    return out.reshape(hc, wc)


def _bs_grids(intra: bool, nz32, mv, h: int, w: int, device):
    """(bs_v (ne, H/4), bs_h (ne_h, W/4)) luma boundary strengths.

    One 32x32 CU / TU and one MV per CTU. Intra: bS 2 on the CTU-boundary
    edges (the TU boundaries). P: bS 1 on CTU boundaries where the MVs
    differ by >= 4 quarter-pel or either side has coded coefficients;
    edges inside a CTU are no TU/PU boundary (bS 0).
    """
    if intra:
        bs_v = torch.zeros((w // 8 - 1, h // 4), dtype=torch.int32,
                           device=device)
        bs_h = torch.zeros((h // 8 - 1, w // 4), dtype=torch.int32,
                           device=device)
        bs_v[3::4] = 2
        bs_h[3::4] = 2
        return bs_v, bs_h

    def one_dir(nz, mvg, hh, ww):
        # vertical edges between CTU columns; every 4th 8-edge
        # (e = 4k+3, x = 32(k+1)) is a CTU boundary
        diff = ((mvg[:, :-1] - mvg[:, 1:]).abs() >= 4).any(dim=-1)
        nz_e = nz[:, :-1] | nz[:, 1:]
        bs_ctu = (diff | nz_e).to(torch.int32)    # (hh/32, ww/32-1)
        bs = torch.zeros((hh // 4, ww // 8 - 1), dtype=torch.int32,
                         device=device)
        bs[:, 3::4] = torch.repeat_interleave(bs_ctu, 8, dim=0)
        return bs.T

    return (one_dir(nz32, mv, h, w),
            one_dir(nz32.T, mv.transpose(0, 1), w, h))


def deblock_frame_hevc(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       qp: int, qpc: int, intra: bool, nz32=None, mv=None):
    """Deblock one reconstructed picture on its tensors' device.

    y (H, W) int32 (H, W multiples of 32); u/v (H/2, W/2); ``nz32``
    (H/32, W/32) bool per-CTU any-coeff flags and ``mv`` (H/32, W/32, 2)
    quarter-pel MVs for P pictures (ignored for intra).
    """
    h, w = y.shape
    if not intra and (nz32 is None or mv is None):
        raise ValueError("P-picture deblock needs nz32 + mv grids")
    bs_v, bs_h = _bs_grids(intra, nz32, mv, h, w, y.device)
    y = _vertical_pass_luma(y, bs_v, qp)
    y = _vertical_pass_luma(y.T, bs_h, qp).T

    # chroma: edges on the 16-luma-px grid AND on a TU boundary: with
    # 16x16 chroma TUs, the chroma 16-grid edges (e = 2k+1); bS=2
    # (intra) only
    if intra:
        hc, wc = u.shape
        bs_cv = torch.zeros((wc // 8 - 1, hc), dtype=torch.int32,
                            device=y.device)
        bs_ch = torch.zeros((hc // 8 - 1, wc), dtype=torch.int32,
                            device=y.device)
        bs_cv[1::2] = 2
        bs_ch[1::2] = 2
        u = _vertical_pass_chroma(u, bs_cv, qpc)
        v = _vertical_pass_chroma(v, bs_cv, qpc)
        u = _vertical_pass_chroma(u.T, bs_ch, qpc).T
        v = _vertical_pass_chroma(v.T, bs_ch, qpc).T
    return y, u, v


def deblock_frame_hevc_np(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                          qp: int, qpc: int, intra: bool, nz32=None,
                          mv=None):
    """:func:`deblock_frame_hevc` on numpy planes (host decoders):
    returns int32 numpy planes."""
    def t(a, dtype):
        return None if a is None else torch.from_numpy(np.asarray(a, dtype))

    out = deblock_frame_hevc(*(t(p, np.int32) for p in (y, u, v)), qp, qpc,
                             intra, nz32=t(nz32, bool), mv=t(mv, np.int32))
    return tuple(p.contiguous().numpy() for p in out)
