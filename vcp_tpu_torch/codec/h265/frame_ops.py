"""HEVC device frame pipeline: CTU intra / inter prediction, transform,
quantization and reconstruction, on the planes' device.

Port of ``vcp_tpu/codec/h265/frame_ops.py``:

* 32x32 CTUs, one CU per CTU, one TU per plane (luma 32, chroma 16);
  the transforms are batched float64 matrix products
  (``ops.transform_hevc``), exact.
* Intra frames (:func:`encode_iframe`): CTU row 0 predicts DC from the
  left neighbour's reconstructed right column, a loop along x; each row
  >= 1 chooses per CTU among the nine top-only modes (Vertical 26 and
  the angular 27..34), which read only the final row above, so a row is
  one batched step of a loop over rows.
* Inter (P) frames (:func:`encode_pframe`): exhaustive full-pel SAD
  search per 32x32 PU over +-sr (the offsets of one dy at a time, the
  first minimum in offset order as ``vcp_tpu``'s strict ``<`` loop
  keeps it), then half- and quarter-pel refinement over the normative
  8-tap planes and 1/8-pel chroma MC.

Every cost decision is device-independent: SADs and SSDs are integer
sums, level bits come from a host table summed exactly in float64
(``h264.rdcost``), lambda is rounded to float32 once on the host
(:func:`lam2_hevc`), and argmins take the first minimum. The numpy twins
of the MC and prediction math (``mc_*_np``, ``top_mode_preds_np``) serve
the validation decoder.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...device import constant
from ...ops import transform_hevc as th
from ...ops.deblock_hevc import deblock_frame_hevc
from ...ops.motion import pad_edge
from ..h264.rdcost import first_argmin, level_bits, ssd

CTU = 32
LOG2_CTU = 5
# HEVC levels clip at 32767 (``transform_hevc.quant``): the level-bits
# table covers all of them. A 32x32 block's bit sum (1,024 terms, each a
# float32 >= 3.7 and so a multiple of 2^-22, total < 2^15) fits in 37
# bits, so the float64 sum stays exact.
MAX_LEVEL = 32767

# normative 4:2:0 chroma interpolation taps for phases 0 and 1/2
_TAPS0 = (0, 64, 0, 0)
_TAPS4 = (-4, 36, 36, -4)

# normative luma 8-tap interpolation filters per quarter phase
# (spec 8.5.4.2.2.1) and chroma 4-tap per 1/8 phase.
LUMA_TAPS = (
    (0, 0, 0, 64, 0, 0, 0, 0),
    (-1, 4, -10, 58, 17, -5, 1, 0),
    (-1, 4, -11, 40, 40, -11, 4, -1),
    (0, 1, -5, 17, 58, -10, 4, -1),
)
CHROMA_TAPS = (
    (0, 64, 0, 0),
    (-2, 58, 10, -2),
    (-4, 54, 16, -2),
    (-6, 46, 28, -4),
    (-4, 36, 36, -4),
    (-4, 28, 46, -6),
    (-2, 16, 54, -4),
    (-2, 10, 58, -2),
)

# intraPredAngle for the positive vertical family (spec Table 8-5).
ANG_MODES = (26, 27, 28, 29, 30, 31, 32, 33, 34)
ANG_ANGLE = (0, 2, 5, 9, 13, 17, 21, 26, 32)


def lam2_hevc(qp: int, lam_mult: float = 1.0) -> float:
    """HEVC's lambda2, 0.9 * 2^((qp-12)/3) (* ``lam_mult``) in Python
    float64, rounded once to float32 as ``vcp_tpu`` hands it to XLA. Not
    H.264's ``rdcost.lam2_for_qp``, which reproduces a float32 ``pow``:
    the two differ at 26 of the 52 QPs."""
    return float(np.float32(0.9 * 2.0 ** ((qp - 12) / 3.0) * lam_mult))


def hevc_level_bits(levels: torch.Tensor, dims) -> torch.Tensor:
    """Bit proxy 2*log2(|z|+1)+1.7 per nonzero level, summed over
    ``dims`` (float32, exact), over the whole HEVC level range."""
    return level_bits(levels, dims, max_level=MAX_LEVEL)


def _tq(res: torch.Tensor, qp: int, log2: int, intra: bool):
    """Transform + quant + recon of batched residual blocks.
    Returns (levels, recon_residual)."""
    z = th.quant(th.fwd(res, log2), qp, log2, intra)
    r = th.inv(th.dequant(z, qp, log2), log2)
    return z, r


def encode_iframe(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  qp: int, qpc: int) -> dict:
    """Row-pattern intra frame, deblocked. Planes are int32, padded to
    CTU multiples. Returns levels (int16), modes and recon planes
    (int32), all on the planes' device."""
    out = _encode_iframe_core(y, u, v, qp, qpc)
    out["recon_y"], out["recon_u"], out["recon_v"] = deblock_frame_hevc(
        out["recon_y"], out["recon_u"], out["recon_v"], qp, qpc,
        intra=True)
    return out


def _dc_of(left: torch.Tensor, first: bool, log2n: int):
    """DC of a block from its left column; the top row substitutes to
    left[0] (spec 8.4.4.2.2); the frame's first block predicts 128."""
    if first:
        return 128
    n = 1 << log2n
    s = left.sum(dtype=torch.int32) + n * left[0] + n
    return s >> (log2n + 1)


def _encode_iframe_core(y, u, v, qp: int, qpc: int) -> dict:
    h, w = y.shape
    nby, nbx = h // CTU, w // CTU
    wc = w // 2
    dev = y.device

    # ---- CTU row 0: DC mode, sequential along x ----
    zs, rec0 = [], []
    ly = lu = lv = None
    for bx in range(nbx):
        blocks = (y[:32, 32 * bx:32 * bx + 32],
                  u[:16, 16 * bx:16 * bx + 16],
                  v[:16, 16 * bx:16 * bx + 16])
        outs = []
        for blk, left, log2n, q in zip(blocks, (ly, lu, lv), (5, 4, 4),
                                       (qp, qpc, qpc)):
            dc = _dc_of(left, bx == 0, log2n)
            z, r = _tq(blk - dc, q, log2n, True)
            outs.append((z, (dc + r).clamp(0, 255)))
        zs.append([o[0] for o in outs])
        rec0.append([o[1] for o in outs])
        ly, lu, lv = (o[1][:, -1] for o in outs)
    levels = [torch.stack([z[k] for z in zs])[None] for k in range(3)]
    rec = [torch.cat([r[k] for r in rec0], dim=1) for k in range(3)]
    modes = [torch.ones((1, nbx), dtype=torch.int32, device=dev)]  # DC

    # ---- CTU rows >= 1: per-CTU RD choice among the top-only modes ----
    if nby > 1:
        mode_ids = constant("hevc_ang_modes", ANG_MODES, dev, torch.int32)
        # rem escape + chroma signalling + the MPM chain broken for the
        # right neighbour, charged so angular wins only where it clearly
        # beats Vertical
        pen = constant("hevc_top_pen", [0.0] + [20.0] * (len(ANG_MODES) - 1),
                       dev, torch.float32)[:, None]
        lam2 = lam2_hevc(qp)
        lane = torch.arange(nbx, device=dev)
        rows = [[], [], []]
        bot = [r[-1] for r in rec]
        for r in range(1, nby):
            ry_ = y[32 * r:32 * r + 32]
            ru_ = u[16 * r:16 * r + 16]
            rv_ = v[16 * r:16 * r + 16]
            preds = _top_mode_preds(bot[0], nbx)            # (M,nbx,32,32)
            cur_b = th.to_blocks(ry_, 32)[0]                # (nbx,32,32)
            # RD mode decision: per mode, quantize the real residual and
            # charge SSD(recon) + lambda2 * level-bits proxy (+ mode bits)
            z, rr = _tq(cur_b[None] - preds, qp, 5, True)
            # an integer sum rounded once; XLA sums float32 squares, which
            # agrees while the partial sums stay below 2^24
            dist = ssd(cur_b[None], preds + rr, (2, 3))
            costs = dist + lam2 * hevc_level_bits(z, (2, 3))
            costs = costs + lam2 * pen
            best = first_argmin(costs, 0)                   # (nbx,)
            modes.append(mode_ids[best][None])
            zy = z[best, lane]
            rec_yr = th.from_blocks(
                (preds[best, lane] + rr[best, lane]).clamp(0, 255)[None])
            pu = bot[1].expand(16, wc)
            pv = bot[2].expand(16, wc)
            zu, rru = _tq(th.to_blocks(ru_ - pu, 16), qpc, 4, True)
            zv, rrv = _tq(th.to_blocks(rv_ - pv, 16), qpc, 4, True)
            rec_ur = (pu + th.from_blocks(rru)).clamp(0, 255)
            rec_vr = (pv + th.from_blocks(rrv)).clamp(0, 255)
            for k, zr in enumerate(((zy[None], rec_yr), (zu, rec_ur),
                                    (zv, rec_vr))):
                rows[k].append(zr)
            bot = [rec_yr[-1], rec_ur[-1], rec_vr[-1]]
        for k in range(3):
            levels[k] = torch.cat([levels[k]] + [z for z, _ in rows[k]])
            rec[k] = torch.cat([rec[k]] + [r for _, r in rows[k]])
    return {
        "levels_y": levels[0].to(torch.int16),
        "levels_u": levels[1].to(torch.int16),
        "levels_v": levels[2].to(torch.int16),
        "modes": torch.cat(modes),
        "recon_y": rec[0], "recon_u": rec[1], "recon_v": rec[2],
    }


@functools.lru_cache(maxsize=None)
def _top_mode_tables():
    """Gather tables of the nine top-only modes over a stacked reference
    [unfiltered top (65), filtered top (65)]: (a index, b index, frac)
    each (M, 32, 32) int64, so that pred = ((32 - f) * ref[a] + f * ref[b]
    + 16) >> 5 (spec 8.4.4.2.6, ang >= 0, vertical)."""
    m = len(ANG_MODES)
    ia = np.zeros((m, 32, 32), np.int64)
    ff = np.zeros((m, 32, 32), np.int64)
    xs = np.arange(32)
    for k, (mode, ang) in enumerate(zip(ANG_MODES, ANG_ANGLE)):
        src = 0 if mode == 26 else 65           # 26 reads unfiltered refs
        for yy in range(32):
            ia[k, yy] = src + (((yy + 1) * ang) >> 5) + xs
            ff[k, yy] = ((yy + 1) * ang) & 31
    return ia, ia + 1, ff


def _ctu_top_refs(bot_y: torch.Tensor, nbx: int):
    """Per-CTU top reference rows from the final row above: (corner
    (nbx,), top64 (nbx, 64)); beyond the frame the top-right replicates
    the last available sample (spec substitution)."""
    w = bot_y.shape[0]
    dev = bot_y.device
    idx = (32 * torch.arange(nbx, device=dev)[:, None]
           + torch.arange(64, device=dev)[None, :]).clamp_(max=w - 1)
    cidx = (32 * torch.arange(nbx, device=dev) - 1).clamp_(0, w - 1)
    return bot_y[cidx], bot_y[idx]


def _top_mode_preds(bot_y: torch.Tensor, nbx: int) -> torch.Tensor:
    """Predictions of the top-only intra modes 26..34, (M, nbx, 32, 32).
    Mode 26 uses unfiltered refs (filterFlag 0), 27..34 the [1 2 1]
    filtered top row (spec 8.4.4.2.3, strong smoothing off in the SPS)."""
    corner, top = _ctu_top_refs(bot_y, nbx)
    # filtered top (pF[63] stays unfiltered per spec); one extra column
    # so mode 34's zero-weight b-term stays in bounds
    pf = torch.cat([
        ((corner + 2 * top[:, 0] + top[:, 1] + 2) >> 2)[:, None],
        (top[:, :-2] + 2 * top[:, 1:-1] + top[:, 2:] + 2) >> 2,
        top[:, -1:], top[:, -1:],
    ], dim=1)
    ref = torch.cat([top, top[:, -1:], pf], dim=1)      # (nbx, 130)
    dev = bot_y.device
    ia, ib, ff = (constant(f"hevc_top_{n}", t, dev)
                  for n, t in zip("abf", _top_mode_tables()))
    f = ff.to(torch.int32)[:, None]                      # (M, 1, 32, 32)
    a = ref[:, ia].permute(1, 0, 2, 3)                   # (M, nbx, 32, 32)
    b = ref[:, ib].permute(1, 0, 2, 3)
    return ((32 - f) * a + f * b + 16) >> 5


def search_fullpel(cur: torch.Tensor, ref: torch.Tensor, sr: int,
                   lam: int) -> torch.Tensor:
    """Exhaustive full-pel SAD + lam * (|dx| + |dy|) search per 32x32
    block; the first minimum in offset order o = (dy+sr)*(2sr+1) +
    (dx+sr) wins. cur / ref: (H, W) int32. Returns (nby, nbx, 2) int32
    (dy, dx)."""
    h, w = cur.shape
    nby, nbx = h // CTU, w // CTU
    side = 2 * sr + 1
    dev = cur.device
    ref_pad = pad_edge(ref, sr, sr, sr, sr)
    pen_x = lam * torch.arange(-sr, sr + 1, device=dev,
                               dtype=torch.int32).abs()
    costs = []
    for dy in range(-sr, sr + 1):
        # win[r, j, c] = ref_pad[dy + sr + r, j + c]: every dx of this dy
        win = ref_pad[dy + sr:dy + sr + h].unfold(1, w, 1)   # (h, side, w)
        sad = (cur[:, None, :] - win).abs().reshape(
            nby, CTU, side, nbx, CTU).sum(dim=(1, 4), dtype=torch.int32)
        costs.append(sad + (pen_x + lam * abs(dy))[None, :, None])
    cost = torch.stack(costs).permute(0, 2, 1, 3).reshape(side * side,
                                                          nby, nbx)
    o = first_argmin(cost, 0).to(torch.int32)
    return torch.stack([o // side - sr, o % side - sr], dim=-1)


def _block_index(mv_part: torch.Tensor, n: int, off: int, axis: int):
    """Per-sample row (axis 0) or column (axis 1) index of (nby, nbx, n, n)
    blocks displaced by the per-block integer offset ``mv_part``."""
    nb = mv_part.shape[axis]
    dev = mv_part.device
    base = n * torch.arange(nb, device=dev)
    base = base[:, None] if axis == 0 else base[None, :]
    t = torch.arange(n, device=dev)
    t = t[:, None] if axis == 0 else t[None, :]
    return (base + mv_part + off)[:, :, None, None] + t


def _mc_luma(ref: torch.Tensor, mv: torch.Tensor, sr: int) -> torch.Tensor:
    """Full-pel luma MC: per-pixel gather from the edge-padded ref."""
    ref_pad = pad_edge(ref, sr, sr, sr, sr)
    rows = _block_index(mv[..., 0], CTU, sr, 0)
    cols = _block_index(mv[..., 1], CTU, sr, 1)
    return th.from_blocks(ref_pad[rows, cols])


def _mc_chroma(ref_c: torch.Tensor, mv: torch.Tensor,
               sr: int) -> torch.Tensor:
    """Chroma MC at luma-MV/2: integer shift + normative 4-tap filter for
    the half-sample phase (-4, 36, 36, -4), combined 2D rounding
    (acc + 2048) >> 12."""
    pad = sr // 2 + 2
    ref_pad = pad_edge(ref_c, pad, pad, pad, pad)
    c = CTU // 2
    rows = _block_index(mv[..., 0] >> 1, c, pad, 0)
    cols = _block_index(mv[..., 1] >> 1, c, pad, 1)
    fy = (mv[..., 0] & 1)[:, :, None, None] == 1
    fx = (mv[..., 1] & 1)[:, :, None, None] == 1
    acc = torch.zeros((*mv.shape[:2], c, c), dtype=torch.int32,
                      device=ref_c.device)
    for i in range(4):
        wy = torch.where(fy, _TAPS4[i], _TAPS0[i]).to(torch.int32)
        for j in range(4):
            wx = torch.where(fx, _TAPS4[j], _TAPS0[j]).to(torch.int32)
            acc = acc + wy * wx * ref_pad[rows + (i - 1), cols + (j - 1)]
    return th.from_blocks((acc + 2048) >> 12)


def luma_frac_planes(ref: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-padded ref -> the 16 clipped 8-bit fractional planes, stacked
    at index 4 * fy + fx, each (H + 2*pad - 7, W + 2*pad - 7) with the
    frame origin at offset pad - 3 (spec 8.5.4.2.2.1: 14-bit separable
    intermediates, horizontal pass first, final (v + 32) >> 6)."""
    rp = pad_edge(ref, pad, pad, pad, pad).to(torch.int32)

    def conv(a, taps, axis):
        n = a.shape[axis] - 7
        acc = None
        for i, t in enumerate(taps):
            if t == 0:
                continue
            term = t * (a[i:i + n] if axis == 0 else a[:, i:i + n])
            acc = term if acc is None else acc + term
        return acc

    planes = [None] * 16
    planes[0] = rp[3:-4, 3:-4]
    hmid = {}
    for fx in (1, 2, 3):
        hv = conv(rp, LUMA_TAPS[fx], axis=1)       # (Hp, W') 14-bit
        hmid[fx] = hv
        planes[fx] = ((hv[3:-4] + 32) >> 6).clamp(0, 255)
    for fy in (1, 2, 3):
        vv = conv(rp, LUMA_TAPS[fy], axis=0)
        planes[4 * fy] = ((vv[:, 3:-4] + 32) >> 6).clamp(0, 255)
        for fx in (1, 2, 3):
            bv = conv(hmid[fx], LUMA_TAPS[fy], axis=0) >> 6
            planes[4 * fy + fx] = ((bv + 32) >> 6).clamp(0, 255)
    return torch.stack(planes)


def mc_luma_q_blocks(planes: torch.Tensor, mvq: torch.Tensor,
                     pad: int) -> torch.Tensor:
    """Quarter-pel luma MC as (nby, nbx, 32, 32) blocks: each CTU reads
    the fractional plane of its phase at its integer offset."""
    po = pad - 3
    rows = _block_index(mvq[..., 0] >> 2, CTU, po, 0)
    cols = _block_index(mvq[..., 1] >> 2, CTU, po, 1)
    pidx = (4 * (mvq[..., 0] & 3) + (mvq[..., 1] & 3)).long()
    return planes[pidx[:, :, None, None], rows, cols]


def mc_luma_q(planes: torch.Tensor, mvq: torch.Tensor,
              pad: int) -> torch.Tensor:
    """Quarter-pel luma MC of the whole frame (H, W)."""
    return th.from_blocks(mc_luma_q_blocks(planes, mvq, pad))


def mc_chroma_q(ref_c: torch.Tensor, mvq: torch.Tensor,
                pad: int) -> torch.Tensor:
    """1/8-pel chroma MC with the normative 4-tap filters (chroma MV =
    luma quarter-pel MV; phase = mv & 7 on the chroma grid)."""
    rp = pad_edge(ref_c, pad, pad, pad, pad).to(torch.int32)
    c = CTU // 2
    rows = _block_index(mvq[..., 0] >> 3, c, pad, 0)
    cols = _block_index(mvq[..., 1] >> 3, c, pad, 1)
    taps = constant("hevc_chroma_taps", CHROMA_TAPS, ref_c.device,
                    torch.int32)
    wy = taps[(mvq[..., 0] & 7).long()][:, :, None, None]   # (..,1,1,4)
    wx = taps[(mvq[..., 1] & 7).long()][:, :, None, None]
    acc = torch.zeros((*mvq.shape[:2], c, c), dtype=torch.int32,
                      device=ref_c.device)
    for i in range(4):
        row_acc = torch.zeros_like(acc)
        for j in range(4):
            row_acc = row_acc + wx[..., j] * rp[rows + (i - 1),
                                                cols + (j - 1)]
        acc = acc + wy[..., i] * row_acc
    return th.from_blocks((acc + 2048) >> 12)


def refine_subpel(cur: torch.Tensor, planes: torch.Tensor,
                  mv_full: torch.Tensor, pad: int, lam: int) -> torch.Tensor:
    """Half- then quarter-pel refinement around the full-pel winner, per
    CTU SAD over the fractional planes; a neighbour pays ``lam`` and must
    beat the best so far strictly (the first minimum of centre + the
    eight neighbours in order). Returns quarter-pel MVs."""
    cur_b = th.to_blocks(cur, CTU)
    nby, nbx = cur_b.shape[:2]
    dev = cur.device
    iy = torch.arange(nby, device=dev)[:, None]
    ix = torch.arange(nbx, device=dev)[None, :]

    def stage(mvq, step):
        cands = [mvq] + [mvq + torch.tensor([dy, dx], dtype=torch.int32,
                                            device=dev)
                         for dy in (-step, 0, step) for dx in (-step, 0, step)
                         if dy or dx]
        costs = torch.stack([
            (cur_b - mc_luma_q_blocks(planes, c, pad)).abs().sum(
                dim=(2, 3), dtype=torch.int32) + (lam if k else 0)
            for k, c in enumerate(cands)])
        best = first_argmin(costs, 0)
        return torch.stack(cands)[best, iy, ix]

    return stage(stage(mv_full * 4, 2), 1)


def encode_pframe(y, u, v, ref_y, ref_u, ref_v, qp: int, qpc: int,
                  sr: int, lam: int, subpel: bool = True) -> dict:
    """Inter (P) frame: one 32x32 2Nx2N PU per CTU; quarter-pel MVs
    (full-pel search + half / quarter refinement over the normative 8-tap
    planes) when ``subpel``; ``mv`` in the output is quarter-pel."""
    h, w = y.shape
    mv_full = search_fullpel(y, ref_y, sr, lam)
    if subpel:
        pad = sr + 4
        planes = luma_frac_planes(ref_y, pad)
        mv = refine_subpel(y, planes, mv_full, pad, lam)
        pred_y = mc_luma_q(planes, mv, pad)
        pred_u = mc_chroma_q(ref_u, mv, sr // 2 + 2)
        pred_v = mc_chroma_q(ref_v, mv, sr // 2 + 2)
    else:
        mv = mv_full * 4
        pred_y = _mc_luma(ref_y, mv_full, sr)
        pred_u = _mc_chroma(ref_u, mv_full, sr)
        pred_v = _mc_chroma(ref_v, mv_full, sr)

    zy, rry = _tq(th.to_blocks(y - pred_y, 32), qp, 5, False)
    zu, rru = _tq(th.to_blocks(u - pred_u, 16), qpc, 4, False)
    zv, rrv = _tq(th.to_blocks(v - pred_v, 16), qpc, 4, False)
    rec_y = (pred_y + th.from_blocks(rry)).clamp(0, 255)
    rec_u = (pred_u + th.from_blocks(rru)).clamp(0, 255)
    rec_v = (pred_v + th.from_blocks(rrv)).clamp(0, 255)
    nz32 = (zy != 0).any(dim=-1).any(dim=-1)
    rec_y, rec_u, rec_v = deblock_frame_hevc(
        rec_y, rec_u, rec_v, qp, qpc, intra=False, nz32=nz32, mv=mv)
    return {
        "mv": mv,
        "levels_y": zy.to(torch.int16),
        "levels_u": zu.to(torch.int16),
        "levels_v": zv.to(torch.int16),
        "recon_y": rec_y, "recon_u": rec_u, "recon_v": rec_v,
    }


# ---------------------------------------------------------------------------
# NumPy twins for the validation decoder (bit-exact with the above);
# copies of vcp_tpu's.
# ---------------------------------------------------------------------------

def mc_luma_np(ref: np.ndarray, mv: np.ndarray) -> np.ndarray:
    """Index-clipping form of the device's edge-padded gather (the two
    are equivalent because out-of-range reads land on edge samples)."""
    h, w = ref.shape
    dy = np.repeat(np.repeat(mv[..., 0], CTU, 0), CTU, 1)
    dx = np.repeat(np.repeat(mv[..., 1], CTU, 0), CTU, 1)
    rows = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
    cols = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
    return ref[rows, cols]


def mc_chroma_np(ref_c: np.ndarray, mv: np.ndarray) -> np.ndarray:
    hc, wc = ref_c.shape
    ref_c = ref_c.astype(np.int32)
    c = CTU // 2
    dyi = np.repeat(np.repeat(mv[..., 0] >> 1, c, 0), c, 1)
    dxi = np.repeat(np.repeat(mv[..., 1] >> 1, c, 0), c, 1)
    fy = np.repeat(np.repeat(mv[..., 0] & 1, c, 0), c, 1)
    fx = np.repeat(np.repeat(mv[..., 1] & 1, c, 0), c, 1)
    rows = np.arange(hc)[:, None] + dyi
    cols = np.arange(wc)[None, :] + dxi
    acc = np.zeros((hc, wc), np.int64)
    for i in range(4):
        wy = np.where(fy == 1, _TAPS4[i], _TAPS0[i])
        ri = np.clip(rows + (i - 1), 0, hc - 1)
        for j in range(4):
            wx = np.where(fx == 1, _TAPS4[j], _TAPS0[j])
            cj = np.clip(cols + (j - 1), 0, wc - 1)
            acc += wy * wx * ref_c[ri, cj]
    return ((acc + 2048) >> 12).astype(np.int32)


def mc_luma_q_np(ref: np.ndarray, mvq: np.ndarray) -> np.ndarray:
    """NumPy twin of the quarter-pel luma MC (plane construction +
    per-CTU select)."""
    h, w = ref.shape
    pad = int(np.abs(mvq).max() // 4) + 5
    rp = np.pad(ref, pad, mode="edge").astype(np.int64)

    def conv(a, taps, axis):
        n = a.shape[axis] - 7
        acc = np.zeros((n, a.shape[1]) if axis == 0
                       else (a.shape[0], n), np.int64)
        for i, t in enumerate(taps):
            if t == 0:
                continue
            sl = (slice(i, i + n) if axis == 0
                  else (slice(None), slice(i, i + n)))
            acc += t * a[sl]
        return acc

    planes = {(0, 0): rp[3:-4, 3:-4]}
    hmid = {}
    for fx in (1, 2, 3):
        hv = conv(rp, LUMA_TAPS[fx], axis=1)
        hmid[fx] = hv
        planes[(0, fx)] = np.clip((hv[3:-4] + 32) >> 6, 0, 255)
    for fy in (1, 2, 3):
        vv = conv(rp, LUMA_TAPS[fy], axis=0)
        planes[(fy, 0)] = np.clip((vv[:, 3:-4] + 32) >> 6, 0, 255)
        for fx in (1, 2, 3):
            bv = conv(hmid[fx], LUMA_TAPS[fy], axis=0) >> 6
            planes[(fy, fx)] = np.clip((bv + 32) >> 6, 0, 255)

    po = pad - 3
    iy = np.repeat(np.repeat(mvq[..., 0] >> 2, CTU, 0), CTU, 1)
    ix = np.repeat(np.repeat(mvq[..., 1] >> 2, CTU, 0), CTU, 1)
    fy = np.repeat(np.repeat(mvq[..., 0] & 3, CTU, 0), CTU, 1)
    fx = np.repeat(np.repeat(mvq[..., 1] & 3, CTU, 0), CTU, 1)
    rows = np.arange(h)[:, None] + iy + po
    cols = np.arange(w)[None, :] + ix + po
    out = np.zeros((h, w), np.int64)
    for (py, px), pl in planes.items():
        m = (fy == py) & (fx == px)
        if m.any():
            out[m] = pl[rows[m], cols[m]]
    return out.astype(np.int32)


def mc_chroma_q_np(ref_c: np.ndarray, mvq: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`mc_chroma_q` (1/8-pel 4-tap chroma MC)."""
    hc, wc = ref_c.shape
    pad = int(np.abs(mvq).max() // 8) + 3
    rp = np.pad(ref_c, pad, mode="edge").astype(np.int64)
    c = CTU // 2
    dyi = np.repeat(np.repeat(mvq[..., 0] >> 3, c, 0), c, 1)
    dxi = np.repeat(np.repeat(mvq[..., 1] >> 3, c, 0), c, 1)
    fy = np.repeat(np.repeat(mvq[..., 0] & 7, c, 0), c, 1)
    fx = np.repeat(np.repeat(mvq[..., 1] & 7, c, 0), c, 1)
    rows = np.arange(hc)[:, None] + dyi + pad
    cols = np.arange(wc)[None, :] + dxi + pad
    taps = np.asarray(CHROMA_TAPS, np.int64)
    wy = taps[fy]
    wx = taps[fx]
    acc = np.zeros((hc, wc), np.int64)
    for i in range(4):
        row_acc = np.zeros((hc, wc), np.int64)
        for j in range(4):
            row_acc += wx[..., j] * rp[rows + (i - 1), cols + (j - 1)]
        acc += wy[..., i] * row_acc
    return ((acc + 2048) >> 12).astype(np.int32)


def top_mode_preds_np(bot_y: np.ndarray, nbx: int) -> np.ndarray:
    """NumPy twin of :func:`_top_mode_preds`: (9, nbx, 32, 32)
    predictions for modes 26..34 from the final row above."""
    w = bot_y.shape[0]
    bot_y = bot_y.astype(np.int64)
    ext = np.concatenate([bot_y, np.full(32, bot_y[-1], np.int64)])
    idx = 32 * np.arange(nbx)[:, None] + np.arange(64)[None, :]
    top = ext[np.clip(idx, 0, w + 31)]
    top = np.where(idx < w, top, bot_y[-1])
    cidx = np.clip(32 * np.arange(nbx) - 1, 0, w - 1)
    corner = bot_y[cidx]
    pf = np.concatenate([
        ((corner + 2 * top[:, 0] + top[:, 1] + 2) >> 2)[:, None],
        (top[:, :-2] + 2 * top[:, 1:-1] + top[:, 2:] + 2) >> 2,
        top[:, -1:], top[:, -1:],
    ], axis=1)
    top = np.concatenate([top, top[:, -1:]], axis=1)
    preds = []
    for mode, ang in zip(ANG_MODES, ANG_ANGLE):
        ref = top if mode == 26 else pf
        rows = []
        for yy in range(32):
            ii = ((yy + 1) * ang) >> 5
            ff = ((yy + 1) * ang) & 31
            a = ref[:, ii:ii + 32]
            b = ref[:, ii + 1:ii + 33]
            rows.append(((32 - ff) * a + ff * b + 16) >> 5)
        preds.append(np.stack(rows, axis=1))
    return np.stack(preds)
