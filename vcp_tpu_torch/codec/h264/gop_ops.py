"""GOP-chunk device encoding on torch tensors (the P-frame hot path).

Port of the main-path subset of ``vcp_tpu/codec/h264/gop_ops.py``: the
P step (full-pel: ``motion_search`` kernel with fused prediction;
half-pel: the pyramid search or the search-only kernel, then half-pel
planes and the fused refine + MC; chroma MC, 4x4 residual
transform/quant/recon with dead-MB decimation and, with ``t8``, the
adaptive 8x8 transform chosen per MB by RD cost; uniform-QP deblock),
the P-chunk loop (``lax.scan`` becomes a Python loop over device tensors,
each frame predicting from the previous recon), and the sparse packing of
each chunk's entropy inputs into compacted int16 rows, plus the sparse
IDR packing. The host-side unpackers turn the fetched rows back into the
dense dicts the slice writers take. What crosses the bus: each P chunk's
outputs as one buffer (``combine_fetch`` / ``split_fetch``), the source
as changed 16x16 tiles against a device-resident MB-tiled carry
(``tile_delta`` on the host, ``encode_pchunk_delta``,
``encode_iframe_delta``, ``delta_planes``), and the B GOP's buffers as
their nonzero 16-word chunks (``sparsify_buf`` / ``unsparsify_buf``).
The B step (``encode_bframe``:
search against both anchors, the frame-dominant vector of each list, an
RD mode decision per MB, two-list deblock) shares the search, chroma MC
and residual code with the P step.

Packed per-MB int16 words:
  [mv 2 | cb_dc 4 | cr_dc 4 | flags 1 | pad 1 | luma 16x16 | cb_ac 4x16
   | cr_ac 4x16]
(flags bit 0 = transform_size_8x8: the luma words then hold four
64-coefficient 8x8 scans instead of sixteen 4x4 scans).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...device import constant
from ...ops import motion as mops
from ...ops import transform as tf
from ...ops import transform8 as t8ops
from ...ops.motion_cuda import motion_search
from . import rdcost
from .frame_ops import _blk_order, _zigzag

MB_WORDS_MV = 2
MB_WORDS_LUMA = 256
MB_WORDS_CDC = 4
MB_WORDS_CAC = 64
MB_META = MB_WORDS_MV + 2 * MB_WORDS_CDC + 2              # 12
MB_PAYLOAD = MB_WORDS_LUMA + 2 * MB_WORDS_CAC             # 384
MB_WORDS = MB_META + MB_PAYLOAD
BLOCKS_PER_MB = 24  # 16 luma + 4 cbAC + 4 crAC, each 16 zig-zag words
IMB_META = 24       # I-frame meta per MB: luma DC 16 + cbDC 4 + crDC 4

# x264-style decimation weights: an isolated ±1 coefficient preceded by
# `run` zeros contributes tab[min(run, 7)]; blocks whose total falls below
# the threshold cost more bits than the distortion they remove.
_DECIMATE_TAB = np.array([3, 2, 2, 1, 1, 1, 0, 0], np.int32)
DECIMATE_THRESHOLD = 6     # whole-MB threshold (x264's p-skip decimation)


def use_hier_me(sr: int) -> bool:
    """Two-level pyramid search (``motion.hier_search``) for the sub-pel P
    step: on for wide windows (R >= 12), where the exhaustive sweep's
    (2R+1)^2 offsets dominate. VCP_HIER_ME=0 opts out (the exhaustive
    search-only kernel runs instead), =1 forces it on at every range; read
    at every call."""
    val = os.environ.get("VCP_HIER_ME", "")
    if val == "0":
        return False
    if val == "1":
        return True
    return sr >= 12


def _rep2(a: torch.Tensor, f: int) -> torch.Tensor:
    return a.repeat_interleave(f, 0).repeat_interleave(f, 1)


def decimate_keep_mask(z_zz: torch.Tensor, extra: int = 0) -> torch.Tensor:
    """Per-MB keep mask for zig-zag level arrays (..., 16 blocks, 16): a
    MB's luma residual is dropped when every |level| <= 1 and the summed
    run-weighted score of its ±1s stays below the threshold."""
    a = z_zz.to(torch.int32).abs()
    nz = a > 0
    big = (a > 1).any(dim=-1).any(dim=-1)
    idx = torch.arange(z_zz.shape[-1], dtype=torch.int32,
                       device=z_zz.device)
    marked = torch.where(nz, idx, torch.full_like(a, -1))
    prev = torch.cummax(marked, dim=-1).values
    prev_before = torch.cat(
        [torch.full_like(marked[..., :1], -1), prev[..., :-1]], dim=-1)
    gap = torch.clamp(idx - prev_before - 1, 0, 7)
    tab = constant("decimate_tab", _DECIMATE_TAB, z_zz.device, torch.int32)
    score = torch.where(nz, tab[gap.long()], 0).sum(dim=(-1, -2))
    return big | (score >= DECIMATE_THRESHOLD + extra)


def _residual_recon(cur_y, cur_u, cur_v, pred_y, pred_u, pred_v,
                    qp: int, qpc: int, decimate_extra: int = 0,
                    t8: bool = False):
    """Inter residual: transform/quantize/reconstruct against prediction
    planes; shared by the P and the B step. Returns (z_luma (nMBy, nMBx,
    256), cb_dc, cb_ac, cr_dc, cr_ac, recon_y, recon_u, recon_v, nz4
    (H/4, W/4) bool, t8 grid (nMBy, nMBx) bool, all False when ``t8`` is
    off). ``decimate_extra`` raises the dead-MB threshold (B pictures,
    which nothing references, drop marginal residuals more readily).
    ``t8`` enables the High-profile adaptive 8x8 luma transform: both
    transforms are computed and each MB picks by rate-distortion cost
    (SSD + lambda2 * bits estimate, see ``rdcost``)."""
    h, w = cur_y.shape
    n_mby, n_mbx = h // 16, w // 16
    diff = cur_y - pred_y
    z = tf.quant4(tf.fdct4(tf.to_blocks4(diff)), qp, intra=False)
    zb = z.reshape(n_mby, 4, n_mbx, 4, 4, 4).permute(0, 2, 1, 3, 4, 5)
    z_zz = _zigzag(_blk_order(zb))                    # (nMBy, nMBx, 16, 16)

    # dead-MB decimation (applies to entropy AND recon identically)
    keep = decimate_keep_mask(z_zz, decimate_extra)
    z_zz = z_zz * keep[..., None, None]
    z = z * _rep2(keep, 4)[..., None, None]

    recon_y = torch.clamp(
        pred_y + tf.from_blocks4(tf.idct4(tf.dequant4(z, qp))), 0, 255)
    z_luma = z_zz.reshape(n_mby, n_mbx, 256)
    t8_grid = torch.zeros((n_mby, n_mbx), dtype=torch.bool,
                          device=cur_y.device)

    if t8:
        z8 = t8ops.quant8(t8ops.fdct8(t8ops.to_blocks8(diff)), qp,
                          intra=False)                # (H/8, W/8, 8, 8)
        # per-MB scans (nMBy, nMBx, 4, 64), 8x8 blocks in raster order
        scan_mb = t8ops.zigzag8(z8).reshape(n_mby, 2, n_mbx, 2, 64) \
            .permute(0, 2, 1, 3, 4).reshape(n_mby, n_mbx, 4, 64)
        # dead-MB decimation on the 8x8 path too (16-coefficient chunks
        # of the scans keep the run structure the score models)
        keep8 = decimate_keep_mask(scan_mb.reshape(n_mby, n_mbx, 16, 16),
                                   decimate_extra)
        scan_mb = scan_mb * keep8[..., None, None]
        z8k = t8ops.unzigzag8(
            scan_mb.reshape(n_mby, n_mbx, 2, 2, 64)
            .permute(0, 2, 1, 3, 4).reshape(n_mby * 2, n_mbx * 2, 64))
        recon8_y = torch.clamp(
            pred_y + t8ops.from_blocks8(
                t8ops.idct8(t8ops.dequant8(z8k, qp))), 0, 255)

        # RD choice per MB: SSD + lambda2 * bits proxy, which charges
        # each nonzero level plus a per-coded-block overhead (4x4 blocks
        # carry more sig-map/cbf overhead)
        lam2 = rdcost.lam2_for_qp(qp)

        def mb_ssd(rec):
            return rdcost.ssd(cur_y.reshape(n_mby, 16, n_mbx, 16),
                              rec.reshape(n_mby, 16, n_mbx, 16), (1, 3))

        def bits_proxy(levels, per_block_words: int, blk_over: float):
            grp = levels.reshape(n_mby, n_mbx, -1, per_block_words)
            nzblk = (grp != 0).any(dim=-1).sum(dim=-1).to(torch.float32)
            return rdcost.level_bits(grp, (-1, -2)) + blk_over * nzblk

        cost4 = mb_ssd(recon_y) + lam2 * bits_proxy(z_zz, 16, 3.0)
        cost8 = mb_ssd(recon8_y) + lam2 * bits_proxy(scan_mb, 64, 6.0)
        has8 = (scan_mb != 0).any(dim=-1).any(dim=-1)
        t8_grid = (cost8 < cost4) & has8
        recon_y = torch.where(_rep2(t8_grid, 16), recon8_y, recon_y)
        z_luma = torch.where(t8_grid[..., None],
                             scan_mb.reshape(n_mby, n_mbx, 256), z_luma)

    def chroma(cur, pred):
        hc, wc = cur.shape
        cf = tf.fdct4(tf.to_blocks4(cur - pred))
        dc_mb = cf[..., 0, 0].reshape(n_mby, 2, n_mbx, 2).permute(0, 2, 1, 3)
        z_dc = tf.quant_dc2(tf.hadamard2(dc_mb), qpc, intra=False)
        z_ac = tf.quant4(cf, qpc, intra=False)
        wr = tf.dequant4(z_ac, qpc)
        wr[..., 0, 0] = tf.dequant_dc2(z_dc, qpc).permute(0, 2, 1, 3) \
            .reshape(hc // 4, wc // 4)
        rec = torch.clamp(pred + tf.from_blocks4(tf.idct4(wr)), 0, 255)
        zc = z_ac.reshape(n_mby, 2, n_mbx, 2, 4, 4).permute(0, 2, 1, 3, 4, 5)
        z_ac_zz = _zigzag(zc.reshape(n_mby, n_mbx, 4, 4, 4))
        return (z_dc.reshape(n_mby, n_mbx, 4),
                z_ac_zz.reshape(n_mby, n_mbx, 64), rec)

    cb_dc, cb_ac, recon_u = chroma(cur_u, pred_u)
    cr_dc, cr_ac, recon_v = chroma(cur_v, pred_v)
    nz4 = (z != 0).any(dim=-1).any(dim=-1)            # (H/4, W/4)
    if t8:
        # deblock residual presence per TRANSFORM block: the 8x8 flags
        # expanded to the 4x4 grid for t8 MBs
        nz8 = (z8k != 0).any(dim=-1).any(dim=-1)      # (H/8, W/8)
        nz4 = torch.where(_rep2(t8_grid, 4), _rep2(nz8, 2), nz4)
    return (z_luma, cb_dc, cb_ac, cr_dc, cr_ac,
            recon_y, recon_u, recon_v, nz4, t8_grid)


def _search_mc_luma(cur_y, ref_y, sr: int, lam: int, subpel: int,
                    row0: int | None = None):
    """Motion search + luma MC against one reference. Returns (mvq
    quarter-pel (nMBy, nMBx, 2), pred_y, mcu) where ``mcu(g)``
    motion-compensates one frame-uniform quarter-pel vector ``g`` (2,)
    against the same reference (the B step's dominant-MV candidates).

    ``subpel`` 0 is full-pel ME (the search kernel also writes the
    prediction); 1 and 2 take full-pel vectors from the pyramid search
    (wide windows, see ``use_hier_me``) or from the exhaustive
    search-only kernel, and refine them over the half-pel planes of the
    padded reference: to half-pel with the fused refine + MC (1), or to
    quarter-pel with ``refine_subpel`` and the 16-case MC (2).

    ``row0`` None is the whole frame. An int makes ``cur_y`` the band of
    MB rows that starts at frame row ``row0`` of the taller ``ref_y`` (the
    tile mesh's step, ``parallel.mesh``); a band always takes the
    exhaustive search, never the pyramid, whatever sr and VCP_HIER_ME say,
    as ``vcp_tpu``'s traced band row does."""
    h, w = cur_y.shape
    band = row0 is not None
    r0 = row0 if band else 0
    if subpel == 0:
        mv_full, pred_y = motion_search(cur_y.contiguous(),
                                        ref_y.contiguous(), sr, lam,
                                        with_pred=True, row0=r0)
        return mv_full * 4, pred_y, lambda g: mops.mc_luma(
            ref_y, torch.div(g, 4, rounding_mode="floor")
            .expand(mv_full.shape), sr, r0)
    if not band and use_hier_me(sr):
        mv_full = mops.hier_search(cur_y, ref_y, sr, lam)
    else:
        mv_full = motion_search(cur_y.contiguous(), ref_y.contiguous(),
                                sr, lam, with_pred=False, row0=r0)
    pad = sr + 6
    margin = pad - 3
    planes = torch.stack(mops.half_planes(
        mops.pad_edge(ref_y, pad, pad, pad, pad)))
    if subpel == 1:
        mv, pred_y = mops.refine_half_mc(cur_y, planes, mv_full, lam, margin,
                                         row0=r0)
        return mv, pred_y, lambda g: mops.mc_luma_uniform(planes, g, margin,
                                                          r0, h, w)
    mv = mops.refine_subpel(cur_y, planes, mv_full, lam, margin,
                            quarter=True, row0=r0)
    pred_y = mops.mc_luma_q(planes, mv, margin, r0)
    return mv, pred_y, lambda g: mops.mc_luma_q(
        planes, g.expand(mv_full.shape), margin, r0)


def _mc_chroma_pair(ref_u, ref_v, mv, sr: int, bs: int = 16,
                    row0c: int = 0):
    return (mops.mc_chroma_q(ref_u, mv, sr // 2 + 2, row0c, bs=bs),
            mops.mc_chroma_q(ref_v, mv, sr // 2 + 2, row0c, bs=bs))


def _pstep_core(cur_y, cur_u, cur_v, ref_y, ref_u, ref_v, qp: int,
                qpc: int, sr: int, lam: int, subpel: int = 1,
                t8: bool = False, row0: int | None = None):
    """P step before deblocking. Returns (packed int16 (nMB * MB_WORDS,),
    recon planes, nz4 grid, quarter-pel mv grid, t8 grid). With ``row0``
    the ``cur_*`` planes are the band from frame row ``row0`` (chroma row
    ``row0 // 2``) against the whole-frame references, and every output is
    the band's (see ``_search_mc_luma``)."""
    h, w = cur_y.shape
    n_mby, n_mbx = h // 16, w // 16
    mv, pred_y, _ = _search_mc_luma(cur_y, ref_y, sr, lam, subpel, row0)
    pred_u, pred_v = _mc_chroma_pair(ref_u, ref_v, mv, sr,
                                     row0c=(row0 or 0) // 2)
    (z_luma, cb_dc, cb_ac, cr_dc, cr_ac,
     recon_y, recon_u, recon_v, nz4, t8g) = _residual_recon(
        cur_y, cur_u, cur_v, pred_y, pred_u, pred_v, qp, qpc, t8=t8)
    zero = torch.zeros((n_mby, n_mbx, 1), dtype=torch.int32,
                       device=cur_y.device)
    packed = torch.cat([mv.to(torch.int32), cb_dc, cr_dc,
                        t8g.to(torch.int32)[..., None], zero,
                        z_luma, cb_ac, cr_ac], dim=-1) \
        .to(torch.int16).reshape(-1)
    return packed, recon_y, recon_u, recon_v, nz4, mv, t8g


def _pstep(cur_y, cur_u, cur_v, ref_y, ref_u, ref_v, qp: int, qpc: int,
           sr: int, lam: int, subpel: int = 1, deblock: bool = False,
           t8: bool = False):
    """One P frame; returns (packed, recon planes). MVs in quarter-pel."""
    packed, recon_y, recon_u, recon_v, nz4, mv, t8g = _pstep_core(
        cur_y, cur_u, cur_v, ref_y, ref_u, ref_v, qp, qpc, sr, lam,
        subpel=subpel, t8=t8)
    if deblock:
        from ...ops import deblock as dbf
        h, w = cur_y.shape
        dev = cur_y.device
        qp_mb = torch.full((h // 16, w // 16), qp, dtype=torch.int32,
                           device=dev)
        intra = torch.zeros((h // 16, w // 16), dtype=torch.bool, device=dev)
        recon_y, recon_u, recon_v = dbf.deblock_frame(
            recon_y, recon_u, recon_v, qp_mb, intra, nz4, mv,
            no_strong=True, qp_scalar=qp, t8=t8g if t8 else None)
    return packed, recon_y, recon_u, recon_v


def encode_pchunk(ys, us, vs, ref_y, ref_u, ref_v, qp: int, qpc: int,
                  sr: int, lam: int, deblock: bool = False,
                  subpel: int = 1, t8: bool = False):
    """Encode N consecutive P frames, each predicting from the previous
    recon. ys (N, H, W), refs (H, W), any integer dtype. Returns (packed
    (N, nMB*MB_WORDS) int16, recon_y/u/v int32 of the last frame)."""
    ry, ru, rv = (a.to(torch.int32) for a in (ref_y, ref_u, ref_v))
    out = []
    for k in range(ys.shape[0]):
        cy, cu, cv = (a[k].to(torch.int32) for a in (ys, us, vs))
        packed, ry, ru, rv = _pstep(cy, cu, cv, ry, ru, rv, qp, qpc, sr,
                                    lam, subpel=subpel, deblock=deblock,
                                    t8=t8)
        out.append(packed)
    return torch.stack(out), ry, ru, rv


def luma_trial(cur_y, pred, qp: int):
    """Per-MB luma trial of the quantized 4x4 path against one
    prediction: (SSD of the recon, level-bit proxy, count of coded 4x4
    blocks), float32 (``rdcost``)."""
    h, w = cur_y.shape
    n_mby, n_mbx = h // 16, w // 16
    zt = tf.quant4(tf.fdct4(tf.to_blocks4(cur_y - pred)), qp, intra=False)
    rec = torch.clamp(pred + tf.from_blocks4(tf.idct4(tf.dequant4(zt, qp))),
                      0, 255)
    ssd = rdcost.ssd(cur_y.reshape(n_mby, 16, n_mbx, 16),
                     rec.reshape(n_mby, 16, n_mbx, 16), (1, 3))
    zmb = zt.reshape(n_mby, 4, n_mbx, 4, 16)
    nzblk = (zmb != 0).any(dim=-1).sum(dim=(1, 3)).to(torch.float32)
    return ssd, rdcost.level_bits(zmb, (1, 3, 4)), nzblk


def dominant_mv(mv: torch.Tensor, snap: int) -> torch.Tensor:
    """The frame-dominant vector (2,) of an MV grid: per component the
    lower median of the MBs' values, sorted[(n-1)//2] (the tie rule of
    ``jnp.quantile(..., 0.5, method="nearest")``; ``torch.quantile``
    rounds half to even and differs for even n), floored to a multiple of
    ``snap``."""
    flat = mv.reshape(-1, 2).to(torch.float32)
    med = torch.kthvalue(flat, (flat.shape[0] - 1) // 2 + 1, dim=0).values
    return torch.div(med.to(torch.int32), snap, rounding_mode="floor") * snap


def encode_bframe(cur_y, cur_u, cur_v, r0y, r0u, r0v, r1y, r1u, r1v,
                  qp: int, qpc: int, sr: int, lam: int, subpel: int = 1,
                  deblock: bool = False) -> dict:
    """One B picture against the two enclosing anchor recons (L0 = past,
    L1 = future). Each MB picks B_L0 / B_L1 / B_Bi_16x16 with its own
    searched vectors, or the frame-uniform candidate (each list's
    dominant vector; L0 alone or bi, one choice per frame), or that
    candidate with no residual (B_Skip material), by rate-distortion cost
    (SSD + lambda2 * bits proxy, ``rdcost``). Bi-prediction is the
    unweighted (p0 + p1 + 1) >> 1 (spec 8.4.2.3.2). B pictures are not
    references: the recon is returned for PSNR only.

    Returns mv0 / mv1 (nMBy, nMBx, 2) quarter-pel, mode (nMBy, nMBx) with
    0 = L0 / 1 = L1 / 2 = Bi, the zig-zagged level arrays and the uint8
    recon planes."""
    cur_y, cur_u, cur_v, r0y, r0u, r0v, r1y, r1u, r1v = (
        a.to(torch.int32)
        for a in (cur_y, cur_u, cur_v, r0y, r0u, r0v, r1y, r1u, r1v))
    h, w = cur_y.shape
    n_mby, n_mbx = h // 16, w // 16

    mv0, p0y, mc0 = _search_mc_luma(cur_y, r0y, sr, lam, subpel)
    mv1, p1y, mc1 = _search_mc_luma(cur_y, r1y, sr, lam, subpel)
    pby = (p0y + p1y + 1) >> 1

    # the uniform-MV candidate: per list the frame-dominant vector,
    # snapped to the sub-pel grid in use; regions that adopt one shared
    # vector collapse to skip runs at entropy time
    snap = 4 if subpel == 0 else (2 if subpel == 1 else 1)
    g0, g1 = dominant_mv(mv0, snap), dominant_mv(mv1, snap)
    pu0 = mc0(g0)
    pu1 = mc1(g1)
    pub = (pu0 + pu1 + 1) >> 1

    lam2 = rdcost.lam2_for_qp(qp)

    def cand_cost(pred):
        ssd, bits, _ = luma_trial(cur_y, pred, qp)
        return ssd + lam2 * bits

    c0 = cand_cost(p0y) + lam2 * (rdcost.mv_bits(mv0) + 3.0)
    c1 = cand_cost(p1y) + lam2 * (rdcost.mv_bits(mv1) + 3.0)
    cbi = cand_cost(pby) + lam2 * (rdcost.mv_bits(mv0)
                                   + rdcost.mv_bits(mv1) + 5.0)
    # one uniform mode for the whole frame (L0 or bi); its vectors cost
    # ~nothing, since in-region mvds collapse to the prediction
    cu0 = cand_cost(pu0)
    cub = cand_cost(pub)
    use_ub = cub.sum(dtype=torch.float64) < cu0.sum(dtype=torch.float64)
    pu = torch.where(use_ub, pub, pu0)
    cu = torch.where(use_ub, cub, cu0) + lam2 * 1.0

    best_exp = torch.minimum(cbi, torch.minimum(c0, c1))
    # the uniform prediction with the residual forced to zero (~1 bit)
    c_skip = rdcost.ssd(cur_y.reshape(n_mby, 16, n_mbx, 16),
                        pu.reshape(n_mby, 16, n_mbx, 16), (1, 3)) \
        + lam2 * 1.0
    skip_pick = c_skip <= torch.minimum(cu, best_exp)
    pick_u = (cu <= best_exp) | skip_pick
    mode = torch.where(cbi <= torch.minimum(c0, c1), 2,
                       torch.where(c1 < c0, 1, 0)).to(torch.int32)
    mode = torch.where(pick_u, torch.where(use_ub, 2, 0), mode) \
        .to(torch.int32)
    mv0 = torch.where((pick_u & (mode != 1))[..., None], g0, mv0)
    mv1 = torch.where((pick_u & (mode != 0))[..., None], g1, mv1)

    mode_px = _rep2(mode, 16)
    pred_y = torch.where(_rep2(pick_u, 16), pu,
                         torch.where(mode_px == 0, p0y,
                                     torch.where(mode_px == 1, p1y, pby)))
    p0u, p0v = _mc_chroma_pair(r0u, r0v, mv0, sr)
    p1u, p1v = _mc_chroma_pair(r1u, r1v, mv1, sr)
    mode_c = _rep2(mode, 8)

    def sel_c(a, b):
        return torch.where(mode_c == 0, a,
                           torch.where(mode_c == 1, b, (a + b + 1) >> 1))

    pred_u = sel_c(p0u, p1u)
    pred_v = sel_c(p0v, p1v)

    (z_luma, cb_dc, cb_ac, cr_dc, cr_ac,
     recon_y, recon_u, recon_v, nz4, _t8g) = _residual_recon(
        cur_y, cur_u, cur_v, pred_y, pred_u, pred_v, qp, qpc,
        decimate_extra=3)

    # skip-forced MBs drop their residual (recon = prediction)
    keep = ~skip_pick[..., None]
    z_luma, cb_dc, cb_ac, cr_dc, cr_ac = (
        a * keep for a in (z_luma, cb_dc, cb_ac, cr_dc, cr_ac))
    recon_y = torch.where(_rep2(skip_pick, 16), pred_y, recon_y)
    recon_u = torch.where(_rep2(skip_pick, 8), pred_u, recon_u)
    recon_v = torch.where(_rep2(skip_pick, 8), pred_v, recon_v)
    nz4 = nz4 & ~_rep2(skip_pick, 4)

    if deblock:
        from ...ops import deblock as dbf
        qp_mb = torch.full((n_mby, n_mbx), qp, dtype=torch.int32,
                           device=cur_y.device)
        intra = torch.zeros((n_mby, n_mbx), dtype=torch.bool,
                            device=cur_y.device)
        use = torch.stack([mode != 1, mode != 0], dim=-1)
        recon_y, recon_u, recon_v = dbf.deblock_frame(
            recon_y, recon_u, recon_v, qp_mb, intra, nz4, (mv0, mv1, use),
            no_strong=True, qp_scalar=qp)

    return {
        "mv0": mv0, "mv1": mv1, "mode": mode,
        "luma": z_luma.reshape(n_mby, n_mbx, 16, 16),
        "cb_dc": cb_dc, "cb_ac": cb_ac.reshape(n_mby, n_mbx, 4, 16),
        "cr_dc": cr_dc, "cr_ac": cr_ac.reshape(n_mby, n_mbx, 4, 16),
        "recon_y": recon_y.to(torch.uint8),
        "recon_u": recon_u.to(torch.uint8),
        "recon_v": recon_v.to(torch.uint8),
    }


def _flag_words(flags_f: torch.Tensor) -> torch.Tensor:
    """(F, B) bool → (F, ceil(B/16)) int16 packed little-endian bits."""
    f, b = flags_f.shape
    pad = (-b) % 16
    if pad:
        flags_f = torch.cat([flags_f, flags_f.new_zeros((f, pad))], dim=1)
    bits = flags_f.reshape(f, -1, 16).to(torch.int32)
    weights = constant("bit_weights", [1 << i for i in range(16)],
                       flags_f.device, torch.int32)
    words = (bits * weights).sum(dim=-1, dtype=torch.int32)
    return torch.where(words >= 1 << 15, words - (1 << 16), words) \
        .to(torch.int16)                  # the uint16 → int16 wrap


def skip_mv_grid(mv: torch.Tensor) -> torch.Tensor:
    """Spec 8.4.1.1 P_Skip MV over an all-inter MV grid (F, nMBy, nMBx,
    2): border MBs and MBs whose left or top neighbor is the zero vector
    predict (0, 0); the rest take the componentwise median of left, top
    and top-right (top-left substituted in the last column)."""
    f, nby, nbx, _ = mv.shape
    a = torch.cat([torch.zeros_like(mv[:, :, :1]), mv[:, :, :-1]], dim=2)
    b = torch.cat([torch.zeros_like(mv[:, :1]), mv[:, :-1]], dim=1)
    c = torch.cat([b[:, :, 1:], b[:, :, -2:-1]], dim=2)
    pred = torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))
    dev = mv.device
    xs = torch.arange(nbx, device=dev)[None, None, :, None]
    ys = torch.arange(nby, device=dev)[None, :, None, None]
    border = (xs == 0) | (ys == 0)
    a_zero = (a == 0).all(dim=-1, keepdim=True)
    b_zero = (b == 0).all(dim=-1, keepdim=True)
    return torch.where(border | a_zero | b_zero, torch.zeros_like(pred), pred)


def _compact_rows(flags_flat: torch.Tensor, rows: torch.Tensor):
    """Stream compaction without a host sync: rows[i] for flagged i move
    to the front (stable). Returns (count, compacted); rows past count
    repeat row 0."""
    n = flags_flat.shape[0]
    dest = torch.cumsum(flags_flat.to(torch.int32), 0) - 1
    count = flags_flat.sum(dtype=torch.int32)
    src = torch.zeros(n + 1, dtype=torch.long, device=rows.device)
    src[torch.where(flags_flat, dest, n).long()] = torch.arange(
        n, device=rows.device)
    return count, rows[src[:n]]


def _sparsify_packed(packed: torch.Tensor, f: int, n_mb: int, n_mbx: int):
    """Compact a dense (F, nMB*MB_WORDS) int16 chunk into (bitmap, counts,
    meta, payload): per-MB active bits, [active MBs, blocky MBs], the
    active MBs' 16-word meta rows and the blocky MBs' 384-word payloads,
    each compacted to the front. A MB is active when it has any nonzero
    block, any nonzero chroma DC, or a mv other than its P_Skip
    prediction; chroma AC flags test words 1..15 (word 0 is the DC slot
    carried by the separate chroma DC block)."""
    arr = packed.reshape(f, n_mb, MB_WORDS)
    mv = arr[..., :2].to(torch.int32)
    payload = arr.reshape(f * n_mb, MB_WORDS)[:, MB_META:]
    blocks = payload.reshape(f * n_mb, BLOCKS_PER_MB, 16)
    bnz = (blocks != 0).any(dim=-1)
    cnz = (blocks[:, 16:, 1:] != 0).any(dim=-1)
    blkflags = torch.cat([bnz[:, :16], cnz], dim=1)   # (F*nMB, 24)

    smv = skip_mv_grid(mv.reshape(f, n_mb // n_mbx, n_mbx, 2))
    mv_active = (mv != smv.reshape(f, n_mb, 2)).any(dim=-1)
    dc_active = (arr[..., 2:10] != 0).any(dim=-1)
    blocky = blkflags.any(dim=-1)
    active = (blocky.reshape(f, n_mb) | dc_active | mv_active).reshape(-1)

    bitmap = _flag_words(active.reshape(f, n_mb))
    meta_all = torch.cat([
        arr.reshape(f * n_mb, MB_WORDS)[:, :MB_META],
        _flag_words(blkflags),                      # (F*nMB, 2): 24 bits
        torch.zeros((f * n_mb, 2), dtype=torch.int16, device=packed.device),
    ], dim=1)
    mcount, meta = _compact_rows(active, meta_all)
    bcount, payload_c = _compact_rows(blocky, payload)
    return bitmap, torch.stack([mcount, bcount]), meta, payload_c


def pack_frames(batch: list) -> np.ndarray:
    """[(y, u, v) uint8 padded planes] → (N, h*w*3//2) uint8 buffer."""
    return np.stack([
        np.concatenate([y.reshape(-1), u.reshape(-1), v.reshape(-1)])
        for y, u, v in batch])


def encode_pchunk_sparse(buf, ref_y, ref_u, ref_v, qp: int, qpc: int,
                         sr: int, lam: int, h: int, w: int,
                         deblock: bool = False, subpel: int = 1,
                         t8: bool = False):
    """P chunk from ONE packed uint8 planar buffer (N, h*w*3//2) on the
    device; returns (bitmap, counts, meta, payload, recon_y/u/v)."""
    n = buf.shape[0]
    hw, cw = h * w, (h // 2) * (w // 2)
    ys = buf[:, :hw].reshape(n, h, w)
    us = buf[:, hw:hw + cw].reshape(n, h // 2, w // 2)
    vs = buf[:, hw + cw:].reshape(n, h // 2, w // 2)
    packed, ry, ru, rv = encode_pchunk(ys, us, vs, ref_y, ref_u, ref_v,
                                       qp, qpc, sr, lam, deblock, subpel,
                                       t8)
    bitmap, counts, meta, payload = _sparsify_packed(
        packed, n, (h // 16) * (w // 16), w // 16)
    return bitmap, counts, meta, payload, ry, ru, rv


def encode_iframe_sparse(y, u, v, qp: int, qpc: int, deblock: bool = False):
    """Intra encode with compacted outputs: returns (meta (nMBy,
    nMBx*IMB_META + flag words) int16, count (1,) int32, blocks (nblk,
    16) int16 with the nonzero AC blocks first, recon planes)."""
    from .frame_ops import encode_iframe
    out = encode_iframe(y, u, v, qp, qpc, deblock)
    luma_dc = out["luma_dc"]                          # (R, X, 16)
    r, x = luma_dc.shape[:2]
    blocks = torch.cat([
        out["luma_ac"].reshape(r, x, 16, 16),
        out["cb_ac"].reshape(r, x, 4, 16),
        out["cr_ac"].reshape(r, x, 4, 16),
    ], dim=2)                                         # (R, X, 24, 16)
    flags = (blocks != 0).any(dim=-1)
    flat = flags.reshape(-1)
    nblk = flat.shape[0]
    dest = torch.cumsum(flat.to(torch.int32), 0) - 1
    count = flat.sum(dtype=torch.int32)
    buffer = torch.zeros((nblk + 1, 16), dtype=torch.int16, device=y.device)
    buffer[torch.where(flat, dest, nblk).long()] = \
        blocks.reshape(nblk, 16).to(torch.int16)
    meta = torch.cat([
        torch.cat([luma_dc, out["cb_dc"], out["cr_dc"]], dim=-1)
        .reshape(r, x * IMB_META).to(torch.int16),
        _flag_words(flags.reshape(r, x * BLOCKS_PER_MB)),
    ], dim=1)
    return (meta, count.reshape(1), buffer[:nblk],
            out["recon_y"], out["recon_u"], out["recon_v"])


def fetch_bucket(count: int, cap: int, base: int = 4096) -> int:
    """Round a compacted-row count up to a fetch bucket: ``base`` doubled
    until it holds ``count``, at most ``cap``."""
    k = base
    while k < count:
        k *= 2
    return min(k, cap)


def combine_fetch(bitmap, counts, meta, payload, mcap: int, pcap: int):
    """One P chunk's sparse outputs as ONE flat int16 tensor: [counts as 4
    words | bitmap | meta[:mcap] | payload[:pcap]], so that the chunk
    crosses the bus in one copy. The caps are the encoder's sticky ones;
    rows past them (an overflow) are fetched apart."""
    return torch.cat([
        counts.to(torch.int32).contiguous().view(torch.int16).reshape(-1),
        bitmap.reshape(-1),
        meta[:mcap].reshape(-1),
        payload[:pcap].reshape(-1),
    ])


def split_fetch(arr: np.ndarray, f: int, n_mb: int, mcap: int, pcap: int):
    """Host inverse of ``combine_fetch``: (mcount, bcount, bitmap (f, nW),
    meta (mcap, 16), payload (pcap, 384)). Meta / payload rows past the
    counts are not data: ``unpack_sparse_chunk`` reads only the first
    mcount / bcount rows."""
    mcount, bcount = (int(x) for x in
                      np.ascontiguousarray(arr[:4]).view(np.int32))
    nw = (n_mb + 15) // 16
    o = 4
    bitmap = arr[o:o + f * nw].reshape(f, nw)
    o += f * nw
    meta = arr[o:o + mcap * 16].reshape(mcap, 16)
    o += mcap * 16
    payload = arr[o:o + pcap * MB_PAYLOAD].reshape(pcap, MB_PAYLOAD)
    return mcount, bcount, bitmap, meta, payload


# ---------------------------------------------------------------------------
# Conditional-replenishment source upload (delta tiles)
# ---------------------------------------------------------------------------
#
# The host uploads only the 16x16 macroblock tiles that changed since the
# previous source frame, and the device carries the source across the GOP
# MB-tiled: luma (nMB, 256) + chroma 2x (nMB, 64) uint8, so a frame update
# is one scatter per plane. Tiles are copied verbatim, so the encode is
# bit-exact; content where every tile changes costs the dense bytes plus
# a 4-byte index per MB.
TILE_WORDS = 384  # 256 luma + 64 cb + 64 cr bytes per MB


def tiles_from_planes_host(yp: np.ndarray, up: np.ndarray,
                           vp: np.ndarray) -> np.ndarray:
    """(padded uint8 planes) → (nMB, 384) uint8 MB tiles (the plain
    reference of the native pass)."""
    h, w = yp.shape
    mby, mbx = h // 16, w // 16
    yt = yp.reshape(mby, 16, mbx, 16).swapaxes(1, 2).reshape(-1, 256)
    ut = up.reshape(mby, 8, mbx, 8).swapaxes(1, 2).reshape(-1, 64)
    vt = vp.reshape(mby, 8, mbx, 8).swapaxes(1, 2).reshape(-1, 64)
    return np.concatenate([yt, ut, vt], axis=1)


def delta_tiles_host(prev_tiles: np.ndarray,
                     cur_tiles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Changed MBs between consecutive source frames (plain reference):
    (idx (K,) int32, tiles (K, 384) uint8)."""
    changed = (prev_tiles != cur_tiles).any(axis=1)
    idx = np.nonzero(changed)[0].astype(np.int32)
    return idx, cur_tiles[idx]


def tile_delta(yp: np.ndarray, up: np.ndarray, vp: np.ndarray,
               prev: np.ndarray, full: bool = False):
    """Tile gather + changed-MB delta against the carried host tiles, in
    one native sweep (``native/tiles.cpp``). ``prev`` ((nMB, 384) uint8)
    is updated IN PLACE to the current frame's tiles; ``full`` treats
    every MB as changed. Returns (idx (K,) int32, tiles (K, 384) uint8).
    The host library builds or raises; under ``VCP_NO_NATIVE=1`` the
    numpy pair ``tiles_from_planes_host`` + ``delta_tiles_host`` runs
    instead, as in ``vcp_tpu``."""
    import ctypes

    from ... import native
    h, w = yp.shape
    n_mb = (h // 16) * (w // 16)
    if prev.shape != (n_mb, TILE_WORDS) or prev.dtype != np.uint8 \
            or not prev.flags.c_contiguous:
        raise ValueError(f"prev must be C-contiguous uint8 ({n_mb}, "
                         f"{TILE_WORDS}), got {prev.dtype} {prev.shape}")
    if native.disabled():
        cur = tiles_from_planes_host(*(np.asarray(p, np.uint8)
                                       for p in (yp, up, vp)))
        if full:
            idx, tiles = np.arange(n_mb, dtype=np.int32), cur
        else:
            idx, tiles = delta_tiles_host(prev, cur)
        prev[:] = cur
        return idx, tiles
    lib = native.get_lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    idx = np.empty(n_mb, np.int32)
    tiles = np.empty((n_mb, TILE_WORDS), np.uint8)
    ya, ua, va = (np.ascontiguousarray(p, np.uint8) for p in (yp, up, vp))
    k = lib.vcp_tile_delta(
        ya.ctypes.data_as(u8p), ua.ctypes.data_as(u8p),
        va.ctypes.data_as(u8p), h, w, prev.ctypes.data_as(u8p),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tiles.ctypes.data_as(u8p), 1 if full else 0)
    return idx[:k], tiles[:k]


def delta_bucket(k: int, n_mb: int) -> int:
    """Round a tile count up to a bucket: 128 times a power of 4, at most
    n_mb (a few upload shapes; at most 4x padding of a small delta)."""
    b = 128
    while b < k:
        b *= 4
    return min(b, n_mb)


def pad_delta(idx: np.ndarray, tiles: np.ndarray, bucket: int, n_mb: int):
    """Pad (idx, tiles) to ``bucket`` rows; padding rows take index n_mb,
    which the device scatter discards (``_apply_tiles``)."""
    k = idx.shape[0]
    if k == bucket:
        return idx, tiles
    pidx = np.full(bucket, n_mb, np.int32)
    pidx[:k] = idx
    ptiles = np.zeros((bucket, TILE_WORDS), np.uint8)
    ptiles[:k] = tiles
    return pidx, ptiles


def _apply_tiles(sy, su, sv, idx_f, t):
    """Scatter one frame's delta tiles into the carried MB-tiled source;
    returns new tensors. Each plane's scatter runs on a copy with one sink
    row past the nMB rows, where the padding index nMB lands, and the sink
    is cut off again (XLA's scatter ``mode="drop"``): no mask, so no host
    sync on the data-dependent tile count."""
    idx = idx_f.long()
    out = []
    for s, lo, hi in ((sy, 0, 256), (su, 256, 320), (sv, 320, 384)):
        ext = torch.cat([s, s[:1]])
        ext[idx] = t[:, lo:hi]
        out.append(ext[:-1])
    return tuple(out)


def _tiled_to_planes(sy, su, sv, n_mby: int, n_mbx: int):
    """The MB-tiled source back to padded planes (uint8)."""
    y = sy.reshape(n_mby, n_mbx, 16, 16).permute(0, 2, 1, 3) \
        .reshape(n_mby * 16, n_mbx * 16)
    u = su.reshape(n_mby, n_mbx, 8, 8).permute(0, 2, 1, 3) \
        .reshape(n_mby * 8, n_mbx * 8)
    v = sv.reshape(n_mby, n_mbx, 8, 8).permute(0, 2, 1, 3) \
        .reshape(n_mby * 8, n_mbx * 8)
    return y, u, v


def source_tiles(yp, up, vp, h: int, w: int):
    """Padded planes on the device → the MB-tiled source carry (a GOP's
    first frame, uploaded whole)."""
    n_mby, n_mbx = h // 16, w // 16
    sy = yp.reshape(n_mby, 16, n_mbx, 16).permute(0, 2, 1, 3) \
        .reshape(-1, 256)
    su = up.reshape(n_mby, 8, n_mbx, 8).permute(0, 2, 1, 3).reshape(-1, 64)
    sv = vp.reshape(n_mby, 8, n_mbx, 8).permute(0, 2, 1, 3).reshape(-1, 64)
    return sy, su, sv


def delta_planes(sy, su, sv, idx, tiles, h: int, w: int):
    """Apply one frame's delta tiles to the carried source: (sy', su',
    sv', y, u, v), the new carry and the padded uint8 planes (the B-GOP
    upload)."""
    sy, su, sv = _apply_tiles(sy, su, sv, idx, tiles)
    return (sy, su, sv, *_tiled_to_planes(sy, su, sv, h // 16, w // 16))


def encode_pchunk_delta(sy, su, sv, idx, tiles, ref_y, ref_u, ref_v,
                        qp: int, qpc: int, sr: int, lam: int, h: int, w: int,
                        deblock: bool = False, subpel: int = 1,
                        t8: bool = False):
    """``encode_pchunk_sparse`` fed by delta tiles: sy / su / sv the
    carried source (the previous frame), idx (N, K) int32 changed-MB
    indices (nMB = padding), tiles (N, K, 384) uint8. Per frame one
    scatter and one untile, then the P step from the previous recon.
    Returns (bitmap, counts, meta, payload, sy', su', sv', recon_y / u / v
    int32 of the last frame)."""
    n_mby, n_mbx = h // 16, w // 16
    ry, ru, rv = (a.to(torch.int32) for a in (ref_y, ref_u, ref_v))
    out = []
    for k in range(idx.shape[0]):
        sy, su, sv = _apply_tiles(sy, su, sv, idx[k], tiles[k])
        cy, cu, cv = (p.to(torch.int32)
                      for p in _tiled_to_planes(sy, su, sv, n_mby, n_mbx))
        packed, ry, ru, rv = _pstep(cy, cu, cv, ry, ru, rv, qp, qpc, sr,
                                    lam, subpel=subpel, deblock=deblock,
                                    t8=t8)
        out.append(packed)
    bitmap, counts, meta, payload = _sparsify_packed(
        torch.stack(out), idx.shape[0], n_mby * n_mbx, n_mbx)
    return bitmap, counts, meta, payload, sy, su, sv, ry, ru, rv


def encode_iframe_delta(sy, su, sv, idx, tiles, qp: int, qpc: int, h: int,
                        w: int, deblock: bool = False):
    """``encode_iframe_sparse`` fed by delta tiles against the carried
    source (an IDR that opens a later GOP): its outputs and the new carry,
    (meta, count, blocks, sy', su', sv', recon_y / u / v)."""
    sy, su, sv = _apply_tiles(sy, su, sv, idx, tiles)
    y, u, v = _tiled_to_planes(sy, su, sv, h // 16, w // 16)
    meta, count, blocks, ry, ru, rv = encode_iframe_sparse(y, u, v, qp, qpc,
                                                          deblock)
    return meta, count, blocks, sy, su, sv, ry, ru, rv


# ---------------------------------------------------------------------------
# Word-sparse fetch (the B-GOP buffers)
# ---------------------------------------------------------------------------
#
# A B GOP's per-frame buffers pack many fields with no fixed per-MB
# layout, so ``_sparsify_packed`` does not apply. This is the
# layout-agnostic form: the int16 buffer as 16-word chunks, only the
# nonzero chunks shipped, [count | chunk bitmap | compacted chunks] in one
# buffer.
SP_K = 16  # words per sparsity chunk (one 4x4 block)


def sparsify_buf(buf, cap: int):
    """(n,) int16 → (combined, comp): combined = [nonzero-chunk count as
    2 words | chunk bitmap | comp[:cap] rows], flat int16; comp, all the
    compacted chunks, stays on the device for an overflow tail."""
    n = buf.shape[0]
    pad = (-n) % SP_K
    if pad:
        buf = torch.cat([buf, buf.new_zeros(pad)])
    chunks = buf.reshape(-1, SP_K)
    flags = (chunks != 0).any(dim=-1)
    count, comp = _compact_rows(flags, chunks)
    combined = torch.cat([
        count.reshape(1).view(torch.int16),
        _flag_words(flags[None, :])[0],
        comp[:cap].reshape(-1),
    ])
    return combined, comp


# ---------------------------------------------------------------------------
# Host-side unpackers (numpy; copies of vcp_tpu's)
# ---------------------------------------------------------------------------

def unpack_sparse_iframe(meta_h: np.ndarray, blocks_h: np.ndarray,
                         count: int, n_mbx: int) -> dict:
    """Rebuild the dense entropy arrays for write_islice."""
    r = meta_h.shape[0]
    nbits = n_mbx * BLOCKS_PER_MB
    nwords = (nbits + 15) // 16
    meta = meta_h[:, : n_mbx * IMB_META].reshape(r, n_mbx, IMB_META)
    words = meta_h[:, n_mbx * IMB_META: n_mbx * IMB_META + nwords]
    bits = np.unpackbits(
        words.astype(np.uint16).view(np.uint8), bitorder="little",
        axis=1)[:, :nbits]
    flags = bits.astype(bool).reshape(r, n_mbx, BLOCKS_PER_MB)
    blocks = np.zeros((r, n_mbx, BLOCKS_PER_MB, 16), np.int16)
    blocks[flags] = blocks_h[:count]
    return {
        "luma_dc": meta[..., :16],
        "cb_dc": meta[..., 16:20],
        "cr_dc": meta[..., 20:24],
        "luma_ac": blocks[:, :, :16].reshape(r, n_mbx, 16, 16),
        "cb_ac": blocks[:, :, 16:20].reshape(r, n_mbx, 4, 16),
        "cr_ac": blocks[:, :, 20:24].reshape(r, n_mbx, 4, 16),
    }


def _unpack_bits(words: np.ndarray, nbits: int) -> np.ndarray:
    """(..., W) int16 little-endian bit words → (..., nbits) bool."""
    u8 = np.ascontiguousarray(words).astype(np.uint16).view(np.uint8)
    return np.unpackbits(u8, bitorder="little",
                         axis=-1)[..., :nbits].astype(bool)


def unsparsify_buf(arr: np.ndarray, n: int, cap: int, comp=None):
    """Host inverse of ``sparsify_buf``: the dense (n,) int16 buffer and
    the chunk count. When the count passed ``cap``, the tail rows are
    fetched from the device-resident ``comp`` in one copy."""
    count = int(np.ascontiguousarray(arr[:2]).view(np.int32)[0])
    nchunks = (n + SP_K - 1) // SP_K
    nw = (nchunks + 15) // 16
    flags = _unpack_bits(arr[2:2 + nw].reshape(1, nw), nchunks)[0]
    k = min(count, cap)
    rows = arr[2 + nw:2 + nw + k * SP_K].reshape(k, SP_K)
    if count > cap:
        rows = np.concatenate([rows, comp[cap:count].cpu().numpy()])
    out = np.zeros((nchunks, SP_K), np.int16)
    out[flags] = rows
    return out.reshape(-1)[:n], count


def unpack_sparse_chunk(bitmap_h: np.ndarray, meta_h: np.ndarray,
                        payload_h: np.ndarray, mcount: int, bcount: int,
                        n_mby: int, n_mbx: int) -> list[dict]:
    """Rebuild per-frame entropy dicts from the sparse fetch. Rows of
    inactive MBs are zero and are ignored by the slice writer, which
    derives their P_Skip MVs itself (the ``active`` grid)."""
    f = bitmap_h.shape[0]
    n_mb = n_mby * n_mbx
    active = _unpack_bits(bitmap_h, n_mb)          # (F, nMB)
    metas = meta_h[:mcount]
    blkflags = _unpack_bits(metas[:, MB_META:MB_META + 2], BLOCKS_PER_MB)
    blocky = blkflags.any(axis=1)
    payloads = payload_h[:bcount]

    meta_d = np.zeros((f, n_mb, MB_META), np.int16)
    meta_d[active] = metas[:, :MB_META]
    pay_d = np.zeros((f, n_mb, MB_PAYLOAD), np.int16)
    act_idx = np.nonzero(active.reshape(-1))[0]
    pay_d.reshape(-1, MB_PAYLOAD)[act_idx[blocky]] = payloads

    out = []
    for i in range(f):
        m = meta_d[i]
        blk = pay_d[i]
        d = {
            "active": active[i].reshape(n_mby, n_mbx),
            "mv": m[:, :2].reshape(n_mby, n_mbx, 2).astype(np.int32),
            "cb_dc": m[:, 2:6].reshape(n_mby, n_mbx, 4),
            "cr_dc": m[:, 6:10].reshape(n_mby, n_mbx, 4),
            "luma": blk[:, :256].reshape(n_mby, n_mbx, 16, 16),
            "cb_ac": blk[:, 256:320].reshape(n_mby, n_mbx, 4, 16),
            "cr_ac": blk[:, 320:384].reshape(n_mby, n_mbx, 4, 16),
        }
        t8 = m[:, 10].reshape(n_mby, n_mbx).astype(bool)
        if t8.any():
            d["t8"] = t8
        out.append(d)
    return out


def unpack_frame(packed: np.ndarray, n_mby: int, n_mbx: int) -> dict:
    """Split one frame's dense packed int16 buffer (the tile mesh's fetch)
    back into the slice writer's arrays, views where possible."""
    arr = packed.reshape(n_mby, n_mbx, MB_WORDS)
    o = 0

    def take(n):
        nonlocal o
        out = arr[..., o:o + n]
        o += n
        return out

    mv = take(2).astype(np.int32)
    cb_dc = take(4)
    cr_dc = take(4)
    t8 = take(1)[..., 0].astype(bool)
    take(1)                                  # pad word
    luma = take(256).reshape(n_mby, n_mbx, 16, 16)
    cb_ac = take(64).reshape(n_mby, n_mbx, 4, 16)
    cr_ac = take(64).reshape(n_mby, n_mbx, 4, 16)
    out = {"mv": mv, "luma": luma, "cb_dc": cb_dc, "cb_ac": cb_ac,
           "cr_dc": cr_dc, "cr_ac": cr_ac}
    if t8.any():
        out["t8"] = t8
    return out
