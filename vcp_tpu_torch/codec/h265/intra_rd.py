"""HEVC RD intra: 32x32 intra predictors, reference assembly and the
slope-2 wavefront I frame of the quality presets, on the planes' device.

Port of ``vcp_tpu/codec/h265/intra_rd.py``. The speed path's intra frame
(``frame_ops.encode_iframe``) keeps to top-only modes; this one chooses
per CTU among ``MODESET`` (planar, DC and the angular family at 4-mode
spacing), which needs the left, top, top-left and top-right CTUs. The
slope-2 wavefront d = 2*mby + mbx puts top-right on d-1, top on d-2 and
left on d-1, so each of its 2*nby + nbx - 2 steps codes a whole diagonal
of CTUs batched (126 steps at 1088x1920).

Scope (the encoder's stream shape: one 32x32 CU / TU per CTU): n = 32
only, so the DC / 10 / 26 edge smoothing never applies; reference
smoothing (8.4.4.2.3) with strong smoothing off: DC, 10 and 26 read
unfiltered references, every other mode the [1 2 1]-filtered set; the
picture is CTU-padded, so availability reduces to three booleans (left /
top / top-right CTU present) and below-left never exists.

Each angular mode's prediction is one gather from the stacked reference
set (:func:`_angular_tables`, built on the host from the spec's
construction of ``ref[]``), bit-exact with ``vcp_tpu``'s row-by-row
slices and with the foreign decoder's ``intra_pred``.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ...device import constant
from ...ops.deblock_hevc import deblock_frame_hevc
from ..h264.rdcost import first_argmin, ssd
from .foreign import ANGLE, INV_ANGLE
from .frame_ops import _tq, hevc_level_bits, lam2_hevc

N = 32
LOG2N = 5

# encoder candidate set: planar, DC, and the angular family at ~4-mode
# spacing (the coarse grid x265's fast mode decision seeds with).
MODESET = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34)

# luma mode signalling estimate (bits): planar / DC usually ride the MPM
# list; Vertical often does via the degenerate chain; other angular
# modes mostly pay the 1 + 5-bit rem escape.
_MODE_BITS = {0: 2.5, 1: 2.5, 26: 4.0}
_MODE_BITS_DEFAULT = 6.5

# offsets of the stacked reference set [left64, corner, top64] (129
# samples), unfiltered then filtered
_LEFT, _CORNER, _TOP, _FILT = 0, 64, 65, 129


def diagonal_maps2(nby: int, nbx: int):
    """Slope-2 wavefront index maps: CTU (mby, mbx) runs at step
    d = 2*mby + mbx. Returns (MBY, MBX, VALID) each (D, L) plus inverse
    maps (DMAP, KMAP) with stacked[DMAP[y,x], KMAP[y,x]] == (y, x)."""
    D = 2 * nby + nbx - 2 if nby and nbx else 0
    lanes = []
    for d in range(D):
        cells = [(mby, d - 2 * mby) for mby in range(nby)
                 if 0 <= d - 2 * mby < nbx]
        lanes.append(cells)
    L = max(1, max(len(c) for c in lanes) if lanes else 1)
    MBY = np.zeros((D, L), np.int32)
    MBX = np.zeros((D, L), np.int32)
    VALID = np.zeros((D, L), bool)
    DMAP = np.zeros((nby, nbx), np.int32)
    KMAP = np.zeros((nby, nbx), np.int32)
    for d, cells in enumerate(lanes):
        for k, (mby, mbx) in enumerate(cells):
            MBY[d, k] = mby
            MBX[d, k] = mbx
            VALID[d, k] = True
            DMAP[mby, mbx] = d
            KMAP[mby, mbx] = k
    return MBY, MBX, VALID, DMAP, KMAP


def build_refs(left32, top64, corner, avl, avt, avtr):
    """Availability substitution (8.4.4.2.2) at CTU granularity.

    left32 (L,32), top64 (L,64), corner (L,): raw plane reads (garbage
    where the matching avail flag is False). avl/avt/avtr (L,) bool.
    Returns (left64, corner, top64) int32, the substituted reference
    set. Below-left is never available at one CU per CTU, so left[32:]
    extends left[31] (or the global fill)."""
    l32 = left32.to(torch.int32)
    t64 = top64.to(torch.int32)
    c = corner.to(torch.int32)
    L = l32.shape[0]
    # top[32:] when the top-right CTU is absent extends top[31]
    t_hi = torch.where(avtr[:, None], t64[:, 32:], t64[:, 31:32])
    t64 = torch.cat([t64[:, :32], t_hi], dim=1)
    # the 8.4.4.2.2 scan order is left-bottom -> corner -> top-right;
    # with whole-CTU availability it collapses to four cases
    fill_t = torch.where(avl, l32[:, 0], 128)     # top row when !avt
    fill_l = torch.where(avt, t64[:, 0], 128)     # left col when !avl
    c = torch.where(avt & avl, c, torch.where(avt, fill_l, fill_t))
    t64 = torch.where(avt[:, None], t64, fill_t[:, None])
    l32 = torch.where(avl[:, None], l32, fill_l[:, None])
    l64 = torch.cat([l32, l32[:, 31:32].expand(L, 32)], dim=1)
    return l64, c.to(torch.int32), t64.to(torch.int32)


def filter_refs(left64, corner, top64):
    """[1 2 1] reference smoothing (8.4.4.2.3), n=32, strong smoothing
    off. Endpoints left[63] / top[63] stay unfiltered per spec."""
    l_, t_, c = left64, top64, corner
    fl0 = (l_[:, 1] + 2 * l_[:, 0] + c + 2) >> 2
    fli = (l_[:, 2:] + 2 * l_[:, 1:-1] + l_[:, :-2] + 2) >> 2
    fl = torch.cat([fl0[:, None], fli, l_[:, -1:]], dim=1)[:, :64]
    ft0 = (c + 2 * t_[:, 0] + t_[:, 1] + 2) >> 2
    fti = (t_[:, :-2] + 2 * t_[:, 1:-1] + t_[:, 2:] + 2) >> 2
    ft = torch.cat([ft0[:, None], fti, t_[:, -1:]], dim=1)[:, :64]
    fc = (l_[:, 0] + 2 * c + t_[:, 0] + 2) >> 2
    return fl, fc, ft


def _pred_planar(left64, corner, top64):
    l_ = left64[:, :N]
    t_ = top64[:, :N]
    tr = top64[:, N]
    bl = left64[:, N]
    xs = torch.arange(N, dtype=torch.int32, device=left64.device)
    return ((N - 1 - xs[None, None, :]) * l_[:, :, None]
            + (xs[None, None, :] + 1) * tr[:, None, None]
            + (N - 1 - xs[None, :, None]) * t_[:, None, :]
            + (xs[None, :, None] + 1) * bl[:, None, None] + N) >> 6


def _pred_dc(left64, corner, top64):
    dc = (left64[:, :N].sum(1, dtype=torch.int32)
          + top64[:, :N].sum(1, dtype=torch.int32) + N) >> 6
    return dc[:, None, None].expand(left64.shape[0], N, N)


def _ref_columns(mode: int) -> tuple[np.ndarray, int]:
    """``ref[]`` of an angular mode (spec 8.4.4.2.6, n = 32) as indices
    into the stacked reference set (``_LEFT`` .. ``_FILT``): [corner,
    main[0..63], main[63]], prefixed for negative angles by the side
    samples at ((x * invAngle + 128) >> 8) - 1. Returns (indices, column
    of ref[0])."""
    ang = ANGLE[mode]
    main, side = (_TOP, _LEFT) if mode >= 18 else (_LEFT, _TOP)
    cols = [_CORNER] + [main + j for j in range(64)] + [main + 63]
    ext = []
    if ang < 0:
        inv = INV_ANGLE[ang]
        ext = [side + min(2 * N - 1, max(0, ((x * inv + 128) >> 8) - 1))
               for x in range((N * ang) >> 5, 0)]
    off = _FILT if mode not in (1, 10, 26) else 0
    return np.asarray(ext + cols, np.int64) + off, len(ext)


@functools.lru_cache(maxsize=None)
def _angular_tables(modes: tuple[int, ...]):
    """For each angular mode of ``modes``: (a index, b index, frac), each
    (32, 32), with pred[y, x] = ((32 - frac) * ref[a] + frac * ref[b] +
    16) >> 5 over the stacked reference set."""
    shape = (len(modes), N, N)
    ia, ib, ff = (np.zeros(shape, np.int64) for _ in range(3))
    for k, mode in enumerate(modes):
        cols, base_col = _ref_columns(mode)
        ang = ANGLE[mode]
        for q in range(N):
            i0 = base_col + 1 + (((q + 1) * ang) >> 5)
            ia[k, q] = cols[i0:i0 + N]
            ib[k, q] = cols[i0 + 1:i0 + N + 1]
            ff[k, q] = ((q + 1) * ang) & 31
        if mode < 18:
            # horizontal modes predict [y = n, x = q]
            ia[k], ib[k], ff[k] = (t[k].T.copy() for t in (ia, ib, ff))
    return ia, ib, ff


def pred_modes(refs_plain, refs_filt, modes=MODESET) -> torch.Tensor:
    """Predictions (len(modes), L, 32, 32) int32 of ``modes`` from the
    (unfiltered, filtered) reference triples; ``modes`` holds planar (0)
    and DC (1) first, if at all, then angular modes."""
    out = []
    ang = tuple(m for m in modes if m >= 2)
    for m in modes[:len(modes) - len(ang)]:
        out.append(_pred_planar(*refs_filt) if m == 0
                   else _pred_dc(*refs_plain))
    if ang:
        (lp, cp, tp), (lf, cf, tf) = refs_plain, refs_filt
        ref = torch.cat([lp, cp[:, None], tp, lf, cf[:, None], tf], dim=1)
        dev = ref.device
        ia, ib, ff = (constant(f"hevc_ang_{n}_{ang}", t, dev)
                      for n, t in zip("abf", _angular_tables(ang)))
        f = ff.to(torch.int32)
        a = ref[:, ia].permute(1, 0, 2, 3)            # (Ma, L, 32, 32)
        b = ref[:, ib].permute(1, 0, 2, 3)
        out.append(((32 - f[:, None]) * a + f[:, None] * b + 16) >> 5)
    return torch.cat([o if o.dim() == 4 else o[None] for o in out])


def pred_mode(refs_plain, refs_filt, mode: int) -> torch.Tensor:
    """Prediction (L, 32, 32) of one mode."""
    return pred_modes(refs_plain, refs_filt, (mode,))[0]


def encode_iframe_rd(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     qp: int, qpc: int) -> dict:
    """RD intra frame; ``VCP_HEVC_RDI_LAM`` (a multiplier of lambda2,
    default 1) is read at every call, as ``vcp_tpu`` reads it per call."""
    lam_mult = float(os.environ.get("VCP_HEVC_RDI_LAM", "1"))
    return _encode_iframe_rd(y, u, v, qp, qpc, lam_mult)


def _encode_iframe_rd(y, u, v, qp: int, qpc: int,
                      lam_mult: float = 1.0) -> dict:
    """Encode one HEVC intra frame with per-CTU RD mode selection over
    MODESET. y: (H, W) int planes padded to 32 multiples; u, v: (H/2,
    W/2). Returns levels (int16), per-CTU ``modes`` and the deblocked
    recon planes (int32). Chroma keeps the engine's fixed scheme (row 0
    DC, rows >= 1 Vertical).

    A loop over the slope-2 diagonals; each step runs every lane's full
    MODESET trial batched (one transform / quant / recon per mode), takes
    the first minimum of the costs, and scatters the lane recons into the
    padded planes.
    """
    y = y.to(torch.int32)
    u = u.to(torch.int32)
    v = v.to(torch.int32)
    dev = y.device
    h, w = y.shape
    nby, nbx = h // N, w // N
    MBY, MBX, VALID, DMAP, KMAP = diagonal_maps2(nby, nbx)
    D, L = MBY.shape
    lam2 = lam2_hevc(qp, lam_mult)
    modeset = torch.tensor(MODESET, dtype=torch.int32, device=dev)
    base_bits = torch.tensor([_MODE_BITS.get(m, _MODE_BITS_DEFAULT)
                              for m in MODESET], dtype=torch.float32,
                             device=dev)

    ymb = y.reshape(nby, N, nbx, N).permute(0, 2, 1, 3)   # (nby,nbx,32,32)
    cmbs = [c.reshape(nby, 16, nbx, 16).permute(0, 2, 1, 3) for c in (u, v)]

    # padded recon planes: +1 top / left border (masked by availability);
    # +32 right columns keep the raw top64 gather in bounds at the last
    # CTU column (substitution masks the garbage); +32 bottom trash rows
    # take the writes of invalid lanes.
    py = torch.zeros((h + N + 1, w + N + 1), dtype=torch.int32, device=dev)
    pcs = [torch.zeros((h // 2 + 17, w // 2 + 1), dtype=torch.int32,
                       device=dev) for _ in range(2)]

    a16 = torch.arange(16, device=dev)
    a32 = torch.arange(N, device=dev)
    a64 = torch.arange(2 * N, device=dev)
    lane = torch.arange(L, device=dev)
    mby_t, mbx_t, valid_t = (torch.from_numpy(a).to(dev)
                             for a in (MBY.astype(np.int64),
                                       MBX.astype(np.int64), VALID))
    outs = []
    for d in range(D):
        mby, mbx, valid = mby_t[d], mbx_t[d], valid_t[d]
        mbyc = torch.where(valid, mby, 0)
        mbxc = torch.where(valid, mbx, 0)
        avl = (mbx > 0) & valid
        avt = (mby > 0) & valid
        avtr = avt & (mbx < nbx - 1)

        # ---- luma: full MODESET RD trial ----
        y0 = mbyc * N + 1
        x0 = mbxc * N + 1
        cur = ymb[mbyc, mbxc]                               # (L,32,32)
        left32 = py[y0[:, None] + a32[None, :], (x0 - 1)[:, None]]
        top64 = py[(y0 - 1)[:, None], x0[:, None] + a64[None, :]]
        corner = py[y0 - 1, x0 - 1]
        refs_plain = build_refs(left32, top64, corner, avl, avt, avtr)
        refs_filt = filter_refs(*refs_plain)
        preds = pred_modes(refs_plain, refs_filt)           # (M,L,32,32)
        z, rr = _tq(cur[None] - preds, qp, LOG2N, True)
        recon = (preds + rr).clamp(0, 255)
        dist = ssd(cur[None], recon, (2, 3))
        bits = hevc_level_bits(z, (2, 3))
        # explicit-chroma signalling (~3 bits) whenever the luma mode
        # differs from the row's fixed chroma prediction (DM otherwise)
        chroma_pred = torch.where(mby == 0, 1, 26)
        pen = base_bits[:, None] + torch.where(
            modeset[:, None] == chroma_pred[None, :], 0.0, 3.0)
        cost = dist + lam2 * (bits + pen)
        best = first_argmin(cost, 0)                        # (L,)
        # Invalid lanes write to the trash rows below the picture (several
        # lanes may hit the same trash samples, in no defined order on
        # CUDA); valid lanes are distinct CTUs and never share a sample,
        # and nothing reads the trash rows, so the planes are exact.
        y0s = torch.where(valid, y0, h + 1)
        py[y0s[:, None, None] + a32[None, :, None],
           x0[:, None, None] + a32[None, None, :]] = recon[best, lane]

        # ---- chroma: fixed row scheme (row 0 DC from the left, rows >= 1
        # Vertical), matching syntax.encode_slice_data's chroma_pred ----
        c0 = mbyc * 16 + 1
        cx0 = mbxc * 16 + 1
        row0 = mby == 0
        zc_out = []
        for k in range(2):
            pc = pcs[k]
            curc = cmbs[k][mbyc, mbxc]                      # (L,16,16)
            leftc = pc[c0[:, None] + a16[None, :], (cx0 - 1)[:, None]]
            topc = pc[(c0 - 1)[:, None], cx0[:, None] + a16[None, :]]
            # DC with the 8.4.4.2.2 substitution: the top row propagates
            # from left[0]; nothing available (frame corner) -> 128
            dcc = torch.where(
                avl, (leftc.sum(1, dtype=torch.int32) + 16 * leftc[:, 0]
                      + 16) >> 5, 128)
            predc = torch.where(row0[:, None, None],
                                dcc[:, None, None].expand(L, 16, 16),
                                topc[:, None, :].expand(L, 16, 16))
            zc, rc = _tq(curc - predc, qpc, 4, True)
            c0s = torch.where(valid, c0, h // 2 + 1)
            pc[c0s[:, None, None] + a16[None, :, None],
               cx0[:, None, None] + a16[None, None, :]] = \
                (predc + rc).clamp(0, 255)
            zc_out.append(zc)
        outs.append((modeset[best], z[best, lane], *zc_out))

    dm = torch.from_numpy(DMAP.astype(np.int64)).to(dev)
    km = torch.from_numpy(KMAP.astype(np.int64)).to(dev)
    modes_s, zy_s, zu_s, zv_s = (torch.stack(t) for t in zip(*outs))
    rec_y, rec_u, rec_v = deblock_frame_hevc(
        py[1:h + 1, 1:w + 1], pcs[0][1:h // 2 + 1, 1:w // 2 + 1],
        pcs[1][1:h // 2 + 1, 1:w // 2 + 1], qp, qpc, intra=True)
    return {
        "levels_y": zy_s[dm, km].to(torch.int16),
        "levels_u": zu_s[dm, km].to(torch.int16),
        "levels_v": zv_s[dm, km].to(torch.int16),
        "modes": modes_s[dm, km],
        "recon_y": rec_y, "recon_u": rec_u, "recon_v": rec_v,
    }
