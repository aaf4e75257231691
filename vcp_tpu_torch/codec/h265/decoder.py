"""HEVC validation decoder (host, NumPy).

Copy of ``vcp_tpu/codec/h265/decoder.py`` (host code); the deblock
runs through ``ops.deblock_hevc.deblock_frame_hevc_np``.
"""

from __future__ import annotations

import numpy as np

from ...utils.bitstream import BitReader, emulation_remove
from ...ops import transform_hevc as th
from . import headers, syntax
from .frame_ops import mc_chroma_np, mc_luma_np
from .syntax import MODE_DC, MODE_VER


class HevcDecodeError(ValueError):
    pass


def _blocks_to_plane(blocks: np.ndarray) -> np.ndarray:
    """(nby, nbx, n, n) -> (nby*n, nbx*n)."""
    nby, nbx, n, _ = blocks.shape
    return blocks.transpose(0, 2, 1, 3).reshape(nby * n, nbx * n)


class HevcDecoder:
    """Stateful NAL-by-NAL decoder."""

    def __init__(self):
        self.hp: headers.HevcParams | None = None
        self.recon = None       # (y, u, v) int32 padded planes

    def decode_nal(self, nal: bytes):
        """Feed one NAL (no start code). Returns (y, u, v) uint8 cropped
        planes for slice NALs, else None."""
        if len(nal) < 3:
            raise HevcDecodeError("short NAL")
        nal_type = (nal[0] >> 1) & 0x3F
        rbsp = emulation_remove(nal[2:])
        if nal_type == headers.NAL_VPS:
            return None
        if nal_type == headers.NAL_SPS:
            self.hp = headers.parse_sps(rbsp)
            if self.hp.log2_ctu != 5:
                raise HevcDecodeError("only 32x32 CTUs are produced")
            return None
        if nal_type == headers.NAL_PPS:
            if self.hp is not None:
                self.hp.qp = headers.parse_pps_qp(rbsp)
            return None
        if nal_type in (headers.NAL_IDR_W_RADL, headers.NAL_TRAIL_R):
            return self._decode_slice(rbsp, nal_type)
        raise HevcDecodeError(f"unsupported NAL type {nal_type}")

    def _decode_slice(self, rbsp: bytes, nal_type: int):
        if self.hp is None:
            raise HevcDecodeError("slice before SPS")
        hp = self.hp
        br = BitReader(rbsp)
        slice_type, slice_qp, _poc = headers.parse_slice_header(
            br, hp, nal_type)
        payload = rbsp[br.pos // 8:]
        is_idr = slice_type == 2
        nby, nbx = hp.height // 32, hp.width // 32
        ly, lu, lv, modes, mv = syntax.decode_slice_data(
            payload, slice_qp, is_idr, nby, nbx)
        qpc = th.chroma_qp(slice_qp)
        if is_idr:
            self.recon = self._recon_intra(ly, lu, lv, modes,
                                           slice_qp, qpc)
        else:
            if self.recon is None:
                raise HevcDecodeError("P slice before IDR")
            self.recon = self._recon_inter(ly, lu, lv, mv,
                                           slice_qp, qpc)
        y, u, v = self.recon
        w = hp.width - hp.conf_win_right
        h = hp.height - hp.conf_win_bottom
        return (y[:h, :w].astype(np.uint8),
                u[:h // 2, :w // 2].astype(np.uint8),
                v[:h // 2, :w // 2].astype(np.uint8))

    def _recon_intra(self, ly, lu, lv, modes, qp, qpc):
        """Intra picture reconstruction. Luma: any of the 35 modes per
        CTU, predicted with the spec-proven foreign predictors
        (foreign.intra_refs/_filter_refs/intra_pred — the same math the
        device encoder is pinned against in tests/test_h265_intra_rd).
        Chroma: the engine's fixed scheme — DC on CTU row 0, Vertical on
        rows >= 1 (signalled DM or explicit; anything else raises)."""
        hp = self.hp
        h, w = hp.height, hp.width
        nby, nbx = h // 32, w // 32
        modes, cmodes = modes if isinstance(modes, tuple) else (modes, None)
        if cmodes is None:
            cmodes = np.full((nby, nbx), -1, np.int32)
        rec_y = np.zeros((h, w), np.int32)
        rec_u = np.zeros((h // 2, w // 2), np.int32)
        rec_v = np.zeros((h // 2, w // 2), np.int32)

        res_y = th.inv_np(th.dequant_np(ly, qp, 5), 5)
        res_u = th.inv_np(th.dequant_np(lu, qpc, 4), 4)
        res_v = th.inv_np(th.dequant_np(lv, qpc, 4), 4)

        from .foreign import _filter_refs, intra_pred, intra_refs
        for by in range(nby):
            chroma_pred = MODE_DC if by == 0 else MODE_VER
            for bx in range(nbx):
                mode = int(modes[by, bx])
                eff_c = mode if cmodes[by, bx] == -1 else int(cmodes[by, bx])
                if eff_c != chroma_pred:
                    raise HevcDecodeError(
                        f"unsupported chroma intra mode {eff_c}")
                # luma: general prediction on the partial recon plane
                left, corner, top = intra_refs(
                    rec_y, bx * 32, by * 32, 32, 5, nbx, w, h)
                fl, fc, ft = _filter_refs(left, int(corner), top, 32,
                                          mode, strong_ok=False)
                py = intra_pred(fl, fc, ft, 32, mode, luma=True)
                rec_y[by * 32:by * 32 + 32, bx * 32:bx * 32 + 32] = \
                    np.clip(py + res_y[by, bx], 0, 255)
                # chroma: DC from the left column (row 0) / Vertical
                if by == 0:
                    if bx == 0:
                        dcu = dcv = 128
                    else:
                        left_u = rec_u[0:16, bx * 16 - 1]
                        left_v = rec_v[0:16, bx * 16 - 1]
                        dcu = int(left_u.sum() + 16 * left_u[0] + 16) >> 5
                        dcv = int(left_v.sum() + 16 * left_v[0] + 16) >> 5
                    pu = np.full((16, 16), dcu, np.int32)
                    pv = np.full((16, 16), dcv, np.int32)
                else:
                    pu = np.broadcast_to(
                        rec_u[by * 16 - 1, bx * 16:bx * 16 + 16], (16, 16))
                    pv = np.broadcast_to(
                        rec_v[by * 16 - 1, bx * 16:bx * 16 + 16], (16, 16))
                rec_u[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16] = \
                    np.clip(pu + res_u[by, bx], 0, 255)
                rec_v[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16] = \
                    np.clip(pv + res_v[by, bx], 0, 255)
        from ...ops.deblock_hevc import deblock_frame_hevc_np
        return deblock_frame_hevc_np(rec_y, rec_u, rec_v, qp, qpc,
                                     intra=True)

    def _recon_inter(self, ly, lu, lv, mv, qp, qpc):
        # mv is QUARTER-pel (dy, dx)
        from .frame_ops import mc_chroma_q_np, mc_luma_q_np
        ref_y, ref_u, ref_v = self.recon
        pred_y = mc_luma_q_np(ref_y, mv)
        pred_u = mc_chroma_q_np(ref_u, mv)
        pred_v = mc_chroma_q_np(ref_v, mv)
        res_y = _blocks_to_plane(th.inv_np(th.dequant_np(ly, qp, 5), 5))
        res_u = _blocks_to_plane(th.inv_np(th.dequant_np(lu, qpc, 4), 4))
        res_v = _blocks_to_plane(th.inv_np(th.dequant_np(lv, qpc, 4), 4))
        rec_y = np.clip(pred_y + res_y, 0, 255)
        rec_u = np.clip(pred_u + res_u, 0, 255)
        rec_v = np.clip(pred_v + res_v, 0, 255)
        from ...ops.deblock_hevc import deblock_frame_hevc_np
        nby, nbx = rec_y.shape[0] // 32, rec_y.shape[1] // 32
        nz32 = np.any(np.asarray(ly) != 0, axis=(-1, -2)).reshape(nby, nbx)
        return deblock_frame_hevc_np(rec_y, rec_u, rec_v, qp, qpc,
                                     intra=False, nz32=nz32,
                                     mv=np.asarray(mv))


def decode_mp4(path: str):
    """Decode an hvc1 MP4 produced by this engine. Yields (y, u, v)
    uint8 planes; also returns via StopIteration nothing — use
    ``list(decode_mp4(p))``."""
    from ..mp4 import Mp4Demuxer
    mux = Mp4Demuxer(path)
    track = mux.video
    if track is None or track.codec not in ("hvc1", "hev1"):
        raise HevcDecodeError("no hvc1 video track")
    dec = HevcDecoder()
    for nal in track.vps + track.sps + track.pps:
        dec.decode_nal(nal)
    for i in range(track.sample_count):
        for nal in mux.sample_nals(track, i):
            out = dec.decode_nal(nal)
            if out is not None:
                yield out


def decode_annexb(data: bytes):
    """Decode an Annex-B elementary stream; yields (y, u, v) planes."""
    from ..mp4 import split_annexb
    dec = HevcDecoder()
    for nal in split_annexb(data):
        out = dec.decode_nal(nal)
        if out is not None:
            yield out
