"""The per-frame P step of the B-GOP coder, with the partition decision
and the intra overlay.

Port of ``encode_pframe`` and ``_encode_pframe_device_parts`` of
``vcp_tpu/codec/h264/pframe.py``. Without partitions the step is the
chunked path's ``gop_ops._pstep`` unpacked into a dict. With partitions
(the quality presets) every MB picks 16x16 / 16x8 / 8x16 / P_8x8: one
full-pel sweep scores every granularity (``motion.full_search_parts``,
or the pyramid ``motion.hier_search_parts`` on wide windows), each is
refined to half-pel (efforts 5-6) or quarter-pel (7-9) at its own
geometry (below effort 5, with ``VCP_PARTS=1``, the full-pel vectors
stay as they are), the sub-16x16 shape is preselected by SAD + lambda *
MV rate with fixed syntax penalties, and 16x16 against that shape is a
luma RD trial (transform, quantize, SSD + lambda2 * bits). The final MV field lives on the 8x8 grid, so MC,
the residual and the deblock run once, partition-agnostic.

With ``intra_mbs`` a cheap parallel probe (bits-free SSD of the I16
V / H / DC / Plane predictions from the inter recon, scaled by
VCP_GATE_MARGIN) bounds what intra could win; where it beats the inter
cost anywhere (or VCP_INTRA_GATE=0), ``intra_rd.intra_overlay_pass``
runs the intra wavefront over the frame. The gate is read on the host,
one device-to-host sync per P picture.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...ops import motion as mops
from . import gop_ops, rdcost
from .encoder import lam_for_qp
from .gop_ops import MB_WORDS, _rep2


def part_penalties() -> tuple[int, int, int]:
    """(P_8x8 penalty, 16x8 / 8x16 penalty, minimum split), read on every
    call: the extra-bits penalties for choosing a partitioned mb_type
    over P_L0_16x16 (mb_type ue + extra mvd headers + lost P_Skip
    eligibility) in the SAD-lambda currency, ``VCP_P8_PENALTY`` (40) and
    ``VCP_P2_PENALTY`` (20), and the minimum linf divergence from the
    16x16 vector (quarter-pel) for a partition to be considered,
    ``VCP_P8_MINSPLIT`` (4): sub-pel refinement jitters every block by
    1-2 qpel, and those "splits" never pay for their syntax. ``vcp_tpu``
    reads the same switches once, at import."""
    return (int(os.environ.get("VCP_P8_PENALTY", "40")),
            int(os.environ.get("VCP_P2_PENALTY", "20")),
            int(os.environ.get("VCP_P8_MINSPLIT", "4")))


NO_SPLIT = 2 ** 30


def encode_pframe(y, u, v, ref_y, ref_u, ref_v, qp: int, qpc: int,
                  search_range: int = 8, deblock: bool = False,
                  subpel: int = 1, t8: bool = False, parts: bool = False,
                  intra_mbs: bool = False) -> dict:
    """One P picture against the reference recon. Returns the entropy
    inputs ("mv" quarter-pel [dy, dx], level arrays, "t8"; with
    ``parts`` also "mv8" (2nMBy, 2nMBx, 2) and "parts"; with
    ``intra_mbs`` also the overlay's "intra", "i8", "imodes", "icmodes",
    "luma_dc", "i8_modes") and the uint8 recon planes."""
    lam = lam_for_qp(qp)
    if parts:
        return _encode_pframe_parts(y, u, v, ref_y, ref_u, ref_v, qp, qpc,
                                    search_range, lam, deblock, subpel, t8,
                                    intra_mbs)
    y, u, v, ref_y, ref_u, ref_v = (
        a.to(torch.int32) for a in (y, u, v, ref_y, ref_u, ref_v))
    n_mby, n_mbx = y.shape[0] // 16, y.shape[1] // 16
    packed, recon_y, recon_u, recon_v = gop_ops._pstep(
        y, u, v, ref_y, ref_u, ref_v, qp, qpc, search_range, lam,
        subpel=subpel, deblock=deblock, t8=t8)
    arr = packed.reshape(n_mby, n_mbx, MB_WORDS).to(torch.int32)
    return {
        "mv": arr[..., :2],
        "cb_dc": arr[..., 2:6],
        "cr_dc": arr[..., 6:10],
        "t8": arr[..., 10].to(torch.bool),
        "luma": arr[..., 12:268].reshape(n_mby, n_mbx, 16, 16),
        "cb_ac": arr[..., 268:332].reshape(n_mby, n_mbx, 4, 16),
        "cr_ac": arr[..., 332:396].reshape(n_mby, n_mbx, 4, 16),
        "recon_y": recon_y.to(torch.uint8),
        "recon_u": recon_u.to(torch.uint8),
        "recon_v": recon_v.to(torch.uint8),
    }


def _rate(vq: torch.Tensor) -> torch.Tensor:
    return (vq[..., 0].abs() + vq[..., 1].abs()) >> 1


def _median3(a, b, c):
    return a + b + c - torch.maximum(torch.maximum(a, b), c) \
        - torch.minimum(torch.minimum(a, b), c)


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """a moved down by dy / right by dx (-1 = left) MBs, zero-filled."""
    out = torch.zeros_like(a)
    h, w = a.shape[:2]
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        a[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def _encode_pframe_parts(y, u, v, ref_y, ref_u, ref_v, qp: int, qpc: int,
                         sr: int, lam: int, deblock: bool, subpel: int,
                         t8: bool, intra_mbs: bool) -> dict:
    """P step with the per-MB partition decision (16x16 / 16x8 / 8x16 /
    P_8x8) and the optional intra overlay."""
    from ...ops import deblock as dbf
    from . import intra_rd
    y, u, v, ref_y, ref_u, ref_v = (
        a.to(torch.int32) for a in (y, u, v, ref_y, ref_u, ref_v))
    dev = y.device
    h, w = y.shape
    n_mby, n_mbx = h // 16, w // 16

    search = (mops.hier_search_parts if gop_ops.use_hier_me(sr)
              else mops.full_search_parts)
    mv16f, mv8f, mvhf, mvvf = search(y, ref_y, sr, lam)
    pad = sr + 6
    margin = pad - 3
    planes = torch.stack(mops.half_planes(
        mops.pad_edge(ref_y, pad, pad, pad, pad)))
    if subpel == 1:
        # fused half-pel refine + MC per geometry (16x16, 8x8, 16x8, 8x16)
        mv16, pred16 = mops.refine_half_mc(y, planes, mv16f, lam, margin,
                                           bs=16)
        mv8, pred8 = mops.refine_half_mc(y, planes, mv8f, lam, margin, bs=8)
        mvh, predh = mops.refine_half_mc(y, planes, mvhf, lam, margin,
                                         bs=(8, 16))
        mvv, predv = mops.refine_half_mc(y, planes, mvvf, lam, margin,
                                         bs=(16, 8))
    elif subpel:
        # quarter-pel refinement at each geometry
        mv16, mv8, mvh, mvv = (
            mops.refine_subpel(y, planes, mvf, lam, margin, quarter=True,
                               bs=bs)
            for mvf, bs in ((mv16f, 16), (mv8f, 8), (mvhf, (8, 16)),
                            (mvvf, (16, 8))))
    else:
        mv16, mv8, mvh, mvv = mv16f * 4, mv8f * 4, mvhf * 4, mvvf * 4
    # every shape's vectors on the common 8x8 grid
    mv16_q = _rep2(mv16, 2)
    mvh_q = mvh.repeat_interleave(2, 1)
    mvv_q = mvv.repeat_interleave(2, 0)
    if subpel != 1:
        # every shape's MC on the 8x8 grid (interpolation is a function of
        # position and vector alone, so the replication is exact)
        pred16, pred8, predh, predv = (
            mops.mc_luma_q(planes, m, margin, bs=8)
            for m in (mv16_q, mv8, mvh_q, mvv_q))
    mv16_h = mv16.repeat_interleave(2, 0)          # 16x16 vector per 16x8
    mv16_v = mv16.repeat_interleave(2, 1)          # ... and per 8x16

    def sad8_of(pred):
        return (y - pred).abs().reshape(2 * n_mby, 8, 2 * n_mbx, 8) \
            .sum(dim=(1, 3), dtype=torch.int32)

    def mb_sum(a):
        return a.reshape(n_mby, 2, n_mbx, 2).sum(dim=(1, 3))

    # SAD + lam * crude |mv| rates, each partition's rate spread over the
    # blocks it covers
    pen8, pen2, min_split = part_penalties()
    cost16 = mb_sum(sad8_of(pred16)) + lam * _rate(mv16)
    cost8 = mb_sum(sad8_of(pred8) + lam * _rate(mv8 - mv16_q)) \
        + lam * pen8
    costh = (sad8_of(predh).reshape(2 * n_mby, n_mbx, 2).sum(-1)
             + lam * _rate(mvh - mv16_h)).reshape(n_mby, 2, n_mbx).sum(1) \
        + lam * pen2
    costv = (sad8_of(predv).reshape(n_mby, 2, 2 * n_mbx).sum(1)
             + lam * _rate(mvv - mv16_v)).reshape(n_mby, n_mbx, 2).sum(-1) \
        + lam * pen2

    # a shape needs a real motion split, or its "gain" is sub-pel
    # refinement noise that never pays for its syntax
    def split_of(mv_q):
        return (mv_q - mv16_q).abs().amax(dim=-1).reshape(
            n_mby, 2, n_mbx, 2).amax(dim=(1, 3)) >= min_split

    cost8 = torch.where(split_of(mv8), cost8, NO_SPLIT)
    costh = torch.where(split_of(mvh_q), costh, NO_SPLIT)
    costv = torch.where(split_of(mvv_q), costv, NO_SPLIT)

    # SAD preselects the best sub-16x16 shape; 16x16 against it is then a
    # luma RD trial (SSD + lambda2 * (level + mvd + header bits))
    sub_costs = torch.stack([costh, costv, cost8])          # sub type 0..2
    sub_t = rdcost.first_argmin(sub_costs, 0).to(torch.int32)
    no_sub = sub_costs.amin(dim=0) >= NO_SPLIT
    st_px = _rep2(sub_t, 16)
    pred_sub = torch.where(st_px == 0, predh,
                           torch.where(st_px == 1, predv, pred8))

    lam2 = rdcost.lam2_for_qp(qp)

    # approximate median MV predictor for pricing mvd16 (neighbours'
    # candidate 16x16 vectors stand in for the final ones)
    mvp = _median3(_shift(mv16, 0, 1), _shift(mv16, 1, 0),
                   _shift(mv16, 1, -1))
    mvbits16 = rdcost.se_bits(mv16 - mvp).sum(-1)
    # sub-shape mvds priced against the 16x16 vector, plus its own cost
    mvb_h = rdcost.se_bits(mvh - mv16_h).sum(-1).reshape(
        n_mby, 2, n_mbx).sum(1)
    mvb_v = rdcost.se_bits(mvv - mv16_v).sum(-1).reshape(
        n_mby, n_mbx, 2).sum(-1)
    mvb_8 = rdcost.exact_sum(rdcost.se_bits(mv8 - mv16_q).sum(-1).reshape(
        n_mby, 2, n_mbx, 2), (1, 3))
    mvbits_sub = torch.where(sub_t == 0, mvb_h,
                             torch.where(sub_t == 1, mvb_v, mvb_8)) \
        + mvbits16
    hdr_sub = torch.where(sub_t == 2, 9.0, 3.0)    # mb_type + sub_mb_types

    ssd16, lb16, nz16 = gop_ops.luma_trial(y, pred16, qp)
    ssds, lbs, nzs = gop_ops.luma_trial(y, pred_sub, qp)
    rd16 = ssd16 + lam2 * (lb16 + 3.0 * nz16 + mvbits16 + 1.0)
    rdsub = ssds + lam2 * (lbs + 3.0 * nzs + mvbits_sub + hdr_sub)
    use_sub = (rdsub < rd16) & ~no_sub
    ptype = torch.where(use_sub, sub_t + 1, 0).to(torch.int32)
    pt2 = _rep2(ptype, 2)[..., None]
    mv8_final = torch.where(
        pt2 == 0, mv16_q, torch.where(
            pt2 == 1, mvh_q, torch.where(pt2 == 2, mvv_q, mv8)))
    pt_px = _rep2(ptype, 16)
    pred_y = torch.where(
        pt_px == 0, pred16, torch.where(
            pt_px == 1, predh, torch.where(pt_px == 2, predv, pred8)))
    pred_u, pred_v = gop_ops._mc_chroma_pair(ref_u, ref_v, mv8_final, sr,
                                             bs=8)

    (z_luma, cb_dc, cb_ac, cr_dc, cr_ac,
     recon_y, recon_u, recon_v, nz4, t8g) = gop_ops._residual_recon(
        y, u, v, pred_y, pred_u, pred_v, qp, qpc, t8=t8)

    out = {
        "mv": mv8_final[::2, ::2],             # partition-0 view
        "mv8": mv8_final, "parts": ptype,
        "cb_dc": cb_dc, "cr_dc": cr_dc, "t8": t8g,
        "luma": z_luma.reshape(n_mby, n_mbx, 16, 16),
        "cb_ac": cb_ac.reshape(n_mby, n_mbx, 4, 16),
        "cr_ac": cr_ac.reshape(n_mby, n_mbx, 4, 16),
    }
    intra_grid = torch.zeros((n_mby, n_mbx), dtype=torch.bool, device=dev)
    if intra_mbs:
        # the inter MBs' RD cost in the overlay's currency
        issd = rdcost.ssd(y.reshape(n_mby, 16, n_mbx, 16),
                          recon_y.reshape(n_mby, 16, n_mbx, 16), (1, 3))
        lb = rdcost.level_bits(z_luma, -1)
        cb_bits = rdcost.level_bits(torch.cat(
            [cb_dc, cr_dc, cb_ac, cr_ac], dim=-1), -1)
        mvbits = torch.where(use_sub, mvbits_sub, mvbits16)
        inter_cost = issd + lam2 * (lb + cb_bits + mvbits + 4.0)

        def zeros(*shape):
            return torch.zeros((n_mby, n_mbx, *shape), dtype=torch.int32,
                               device=dev)
        ov = {"intra": intra_grid, "i8": intra_grid, "modes": zeros(),
              "cmodes": zeros(), "luma_dc": zeros(16), "i8_modes": zeros(4)}
        if _overlay_gate(y, recon_y, inter_cost, lam2):
            ov = intra_rd.intra_overlay_pass(y, u, v, recon_y, recon_u,
                                             recon_v, inter_cost, qp, qpc)
            intra_grid = ov["intra"]
            recon_y, recon_u, recon_v = (ov["recon_y"], ov["recon_u"],
                                         ov["recon_v"])
            ipx = intra_grid[:, :, None]
            out["luma"] = torch.where(
                ipx[..., None], ov["luma_mux"].reshape(n_mby, n_mbx, 16, 16),
                out["luma"])
            for k in ("cb_dc", "cr_dc"):
                out[k] = torch.where(ipx, ov[k], out[k])
            for k in ("cb_ac", "cr_ac"):
                out[k] = torch.where(ipx[..., None], ov[k], out[k])
            t8g = out["t8"] = torch.where(intra_grid, ov["i8"], t8g)
        out.update(intra=intra_grid, i8=ov["i8"], imodes=ov["modes"],
                   icmodes=ov["cmodes"], luma_dc=ov["luma_dc"],
                   i8_modes=ov["i8_modes"])

    if deblock:
        qp_mb = torch.full((n_mby, n_mbx), qp, dtype=torch.int32, device=dev)
        recon_y, recon_u, recon_v = dbf.deblock_frame(
            recon_y, recon_u, recon_v, qp_mb, intra_grid, nz4, mv8_final,
            no_strong=not intra_mbs, qp_scalar=qp,
            t8=t8g if (t8 or intra_mbs) else None)

    out["recon_y"] = recon_y.to(torch.uint8)
    out["recon_u"] = recon_u.to(torch.uint8)
    out["recon_v"] = recon_v.to(torch.uint8)
    return out


def _overlay_gate(y, recon_y, inter_cost, lam2: float) -> bool:
    """Does any MB's optimistic intra probe beat its inter cost? The
    probe is the bits-free SSD of the best I16 V / H / DC / Plane
    prediction (spec 8.3.3) from the inter recon's neighbours, scaled by
    VCP_GATE_MARGIN (default 0.15: the wavefront's i8 directional modes
    can beat the best I16 probe several times over on oblique
    gradients), plus the I16 mode overhead. Where it wins nowhere the
    overlay would replace nothing. VCP_INTRA_GATE=0 forces the overlay.
    Both variables are read at every call; the answer is read on the
    host."""
    from . import intra_rd
    if os.environ.get("VCP_INTRA_GATE") == "0":
        return True
    h, w = y.shape
    n_mby, n_mbx = h // 16, w // 16
    dev = y.device
    f32 = torch.float32
    ymb = y.reshape(n_mby, 16, n_mbx, 16).to(f32)
    above = torch.cat([torch.full((1, w), 128, dtype=torch.int32, device=dev),
                       recon_y[15::16][:-1]]).reshape(n_mby, n_mbx, 16).to(f32)
    left = torch.cat([torch.full((h, 1), 128, dtype=torch.int32, device=dev),
                      recon_y[:, 15::16][:, :-1]], dim=1) \
        .reshape(n_mby, 16, n_mbx).to(f32)
    dc = torch.div(above.sum(-1) + left.sum(1) + 16.0, 32.0,
                   rounding_mode="floor")

    def ssd(pred):
        return ((ymb - pred) ** 2).sum(dim=(1, 3))

    # I16 Plane (spec 8.3.3.4), the gradient workhorse
    tl = torch.cat([torch.full((n_mby, 1), 128.0, device=dev),
                    above[:, :-1, 15]], dim=1)             # p[-1, -1]
    a_ext = torch.cat([tl[..., None], above], dim=-1)      # A[i] = p[-1, i-1]
    l_ext = torch.cat([tl[:, None, :], left], dim=1)       # L[j] = p[j-1, -1]
    xs = torch.arange(1, 9, dtype=f32, device=dev)
    hh = (xs * (a_ext[..., 9:17] - a_ext[..., :8].flip(-1))).sum(-1)
    vv = (xs[:, None] * (l_ext[:, 9:17] - l_ext[:, :8].flip(1))).sum(1)
    a_p = 16.0 * (above[..., 15] + left[:, 15])
    b_p = torch.floor((5.0 * hh + 32.0) / 64.0)
    c_p = torch.floor((5.0 * vv + 32.0) / 64.0)
    gy = torch.arange(16, dtype=f32, device=dev) - 7.0
    plane = torch.clamp(torch.floor(
        (a_p[:, None, :, None] + b_p[:, None, :, None] * gy[None, None, None]
         + c_p[:, None, :, None] * gy[None, :, None, None] + 16.0) / 32.0),
        0, 255)
    best = torch.minimum(
        torch.minimum(ssd(plane), ssd(dc[:, None, :, None])),
        torch.minimum(ssd(above[:, None]), ssd(left[..., None])))
    margin = float(np.float32(os.environ.get("VCP_GATE_MARGIN", "0.15")))
    probe = margin * best + lam2 * intra_rd.I16_OVERHEAD_BITS
    return bool((probe < inter_cost).any())
