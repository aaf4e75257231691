"""H.264 decoder in Python and NumPy: the benchmark's reference.

A copy of the port's library-free decode path (``vcp_tpu_torch``'s
``codec/h264/decoder.py`` under ``VCP_NO_NATIVE=1``: the Python CABAC
parse of ``cabac_syntax`` / ``inter_cabac``, the NumPy reconstruction of
``inter_recon`` and the intra MBs here, and the NumPy deblock of
``deblock_host``), with the C++ routes taken out. It imports nothing of
the port, so a change to the port's decoder cannot move the yardstick.

Decodes Main and High profile CABAC streams, all intra modes
(I_4x4/I_8x8/I16 with filtered 8x8 prediction), P 16x16/16x8/8x16/P_8x8
partitions, 1-16 reference frames with ref list modification and MMCO,
explicit weighted P prediction, B pictures with spatial direct, per-MB
mb_qp_delta, the 8x8 transform, and deblocking in spec order with
reference-aware bS. Out of scope: interlaced (MBAFF/PAFF), FMO/ASO,
multi-slice pictures, sub-8x8 partitions, temporal direct, long-term
references.

With ``parse_only`` set, each slice is parsed to its end (every syntax
element, the end of the slice data) and not reconstructed: the syntax
check of a picture whose references are not decoded. The reference
pictures are still marked, without samples, so that a B slice parsed
after its anchors finds both reference lists. With ``headers_only`` set,
a slice's header is read and its picture marked, and its data is not:
the anchors of a B slice whose data another process parses.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import xform as tf
from .bitstream import BitReader, emulation_remove
from . import headers as H
from .consts import CHROMA_BLK_ORDER
from .consts import LUMA_BLK_ORDER
from .consts import ZIGZAG_4x4

_ZZ = np.array(ZIGZAG_4x4)


def unzigzag(levels16) -> np.ndarray:
    """16 zig-zag-ordered coeffs → 4x4 raster block."""
    arr = np.zeros(16, np.int32)
    arr[_ZZ] = levels16
    return arr.reshape(4, 4)


class DecodeError(ValueError):
    pass


def _build_intra_tables(ns: int):
    """Index tables for the directional intra modes 3..8 (spec 8.3.1.2 /
    8.3.2.2): every predicted sample is (r[I1] + 2*r[I2] + r[I3] + 2)>>2
    over a flat reference vector r = [left(ns) | corner | top(2*ns for
    4x4 incl. top-right, 2*ns for 8x8)]. Two-tap (a+b+1)>>1 samples use
    (a + 2b + a), plain copies (a + 2a + a) — identical integer results.
    One fancy-gather per block replaces the per-pixel Python loops
    (the decode hot spot for intra-heavy foreign streams)."""
    L, M, T = 0, ns, ns + 1          # le[i] = i, m = ns, t[i] = ns+1+i

    tabs = {}
    for mode in (3, 4, 5, 6, 7, 8):
        I1 = np.zeros((ns, ns), np.int32)
        I2 = np.zeros((ns, ns), np.int32)
        I3 = np.zeros((ns, ns), np.int32)
        for yy in range(ns):
            for xx in range(ns):
                if mode == 3:                          # diag down-left
                    if xx == ns - 1 and yy == ns - 1:
                        a, b, c = T + 2 * ns - 2, T + 2 * ns - 1, \
                            T + 2 * ns - 1
                    else:
                        i = xx + yy
                        a, b, c = T + i, T + i + 1, T + i + 2
                elif mode == 4:                        # diag down-right
                    if xx > yy:
                        i = xx - yy
                        a = M if i == 1 else T + i - 2
                        b, c = T + i - 1, T + i
                    elif xx < yy:
                        i = yy - xx
                        a = M if i == 1 else L + i - 2
                        b, c = L + i - 1, L + i
                    else:
                        a, b, c = T + 0, M, L + 0
                elif mode == 5:                        # vertical-right
                    z = 2 * xx - yy
                    i = xx - (yy >> 1)
                    if z >= 0 and z % 2 == 0:
                        a = M if i == 0 else T + i - 1
                        b, c = T + i, a
                    elif z >= 0:
                        a = M if i == 1 else T + i - 2
                        b, c = T + i - 1, T + i
                    elif z == -1:
                        a, b, c = L + 0, M, T + 0
                    else:
                        j = yy - 2 * xx
                        a, b = L + j - 1, L + j - 2
                        c = L + j - 3 if j >= 3 else M
                elif mode == 6:                        # horizontal-down
                    z = 2 * yy - xx
                    i = yy - (xx >> 1)
                    if z >= 0 and z % 2 == 0:
                        a = M if i == 0 else L + i - 1
                        b, c = L + i, a
                    elif z >= 0:
                        a = M if i == 1 else L + i - 2
                        b, c = L + i - 1, L + i
                    elif z == -1:
                        a, b, c = T + 0, M, L + 0
                    else:
                        j = xx - 2 * yy
                        a, b = T + j - 1, T + j - 2
                        c = T + j - 3 if j >= 3 else M
                elif mode == 7:                        # vertical-left
                    i = xx + (yy >> 1)
                    if yy % 2 == 0:
                        a, b, c = T + i, T + i + 1, T + i
                    else:
                        a, b, c = T + i, T + i + 1, T + i + 2
                else:                                  # horizontal-up
                    z = xx + 2 * yy
                    if z > 2 * ns - 3:
                        a = b = c = L + ns - 1
                    elif z == 2 * ns - 3:
                        a, b, c = L + ns - 2, L + ns - 1, L + ns - 1
                    elif z % 2 == 0:
                        i = yy + (xx >> 1)
                        a, b, c = L + i, L + i + 1, L + i
                    else:
                        i = yy + (xx >> 1)
                        a, b, c = L + i, L + i + 1, L + i + 2
                I1[yy, xx], I2[yy, xx], I3[yy, xx] = a, b, c
        tabs[mode] = (I1, I3, I2)   # (a, c, 2*b) gather order
    return tabs


_I4_TABS = _build_intra_tables(4)
_I8_TABS = _build_intra_tables(8)


@dataclasses.dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    is_idr: bool = False


class _Nz:
    def __init__(self, bh, bw_):
        self.nz = np.full((bh, bw_), -1, np.int16)


class H264Decoder:
    def __init__(self):
        self.sp: H.SeqParams | None = None
        self.pp: H.PicParams | None = None
        self.ref: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        self.frames: list[DecodedFrame] = []
        # DPB for B streams: [(poc, planes)] reference pictures of the
        # current coded video sequence (cleared at IDR)
        self.dpb: list = []              # refpic.RefPic entries
        self._group = -1                 # IDR counter (POC resets there)
        self._order: list[tuple] = []    # (group, poc) per decoded frame
        self._prev_poc_msb = 0
        self._prev_poc_lsb = 0
        self.parse_only = False          # parse each slice, reconstruct none
        self.headers_only = False        # read slice headers and marking only
        self.parsed = 0                  # slices parsed in parse-only mode

    # -- top level ------------------------------------------------------

    def decode_nals(self, nals: list[bytes]) -> list[DecodedFrame]:
        for nal in nals:
            self._decode_nal(nal)
        return self._output_order()

    def _output_order(self) -> list[DecodedFrame]:
        """Frames in display order: decode order re-sorted by (IDR group,
        POC). A no-op for streams without B pictures."""
        paired = sorted(zip(self._order, self.frames), key=lambda t: t[0])
        self.frames = [f for _, f in paired]
        self._order = [k for k, _ in paired]
        return self.frames

    def drain(self, flush: bool = False) -> list[DecodedFrame]:
        """Streaming output: pop the frames that are safe to display.

        B streams decode out of display order; a reorder buffer of
        num_ref_frames pictures covers the worst reordering the DPB can
        express (foreign B-pyramid streams reorder deeper than our own
        one-anchor lag; x264 sets num_ref_frames >= its reorder depth).
        ``flush=True`` empties the buffer at end of stream."""
        hold = 0
        if self.sp is not None and self.sp.poc_type == 0:
            hold = max(1, self.sp.num_ref_frames)
        out: list[DecodedFrame] = []
        while len(self.frames) > (0 if flush else hold):
            i = min(range(len(self.frames)), key=lambda j: self._order[j])
            out.append(self.frames.pop(i))
            self._order.pop(i)
        return out

    def _decode_nal(self, nal: bytes) -> None:
        nal_type = nal[0] & 0x1F
        rbsp = emulation_remove(nal[1:])
        if nal_type == H.NAL_SPS:
            self.sp = H.parse_sps(rbsp)
        elif nal_type == H.NAL_PPS:
            self.pp = H.parse_pps(rbsp)
        elif nal_type in (H.NAL_SLICE_IDR, H.NAL_SLICE_NONIDR):
            ref_idc = (nal[0] >> 5) & 3
            self._decode_slice(rbsp, nal_type == H.NAL_SLICE_IDR, ref_idc)

    # -- slice ----------------------------------------------------------
    def _decode_slice(self, rbsp: bytes, is_idr: bool,
                      ref_idc: int = 3) -> None:
        if self.sp is None or self.pp is None:
            raise DecodeError("slice before SPS/PPS")
        sp, pp = self.sp, self.pp
        br = BitReader(rbsp)
        first_mb = br.ue()
        if first_mb != 0:
            raise DecodeError("multi-slice pictures unsupported")
        slice_type = br.ue()
        is_p = slice_type % 5 == 0
        is_b = slice_type % 5 == 1
        is_i = slice_type % 5 == 2
        if not (is_p or is_i or is_b):
            raise DecodeError(f"slice_type {slice_type} unsupported")
        br.ue()                                   # pps id
        fn = br.u(sp.log2_max_frame_num)          # frame_num
        if is_idr:
            br.ue()                               # idr_pic_id
            self.dpb.clear()
            self._group += 1
            self._prev_poc_msb = self._prev_poc_lsb = 0
        # poc_type 2: decode order
        poc = 2 * (len(self.frames) + self.parsed)
        if sp.poc_type == 0:
            lsb = br.u(sp.log2_max_poc_lsb)       # pic_order_cnt_lsb
            max_lsb = 1 << sp.log2_max_poc_lsb
            # 8.2.1.1 POC msb wrap
            if (lsb < self._prev_poc_lsb
                    and self._prev_poc_lsb - lsb >= max_lsb // 2):
                msb = self._prev_poc_msb + max_lsb
            elif (lsb > self._prev_poc_lsb
                    and lsb - self._prev_poc_lsb > max_lsb // 2):
                msb = self._prev_poc_msb - max_lsb
            else:
                msb = self._prev_poc_msb
            poc = msb + lsb
            if ref_idc:
                self._prev_poc_msb, self._prev_poc_lsb = msb, lsb
        from . import refpic as RP
        if is_b:
            if not br.u(1):                       # direct_spatial_mv_pred
                raise DecodeError("temporal direct mode unsupported")
        num_ref0, num_ref1 = pp.num_ref_l0, pp.num_ref_l1
        mod0 = mod1 = ()
        wt0 = wt1 = None
        if is_p or is_b:
            if br.u(1):                           # num_ref_idx_override
                num_ref0 = br.ue() + 1
                if is_b:
                    num_ref1 = br.ue() + 1
            try:
                mod0, mod1 = RP.parse_ref_list_modification(br, is_b)
            except ValueError as e:
                raise DecodeError(str(e))
        if is_p and pp.weighted_pred:
            wt0, _ = RP.parse_pred_weight_table(br, num_ref0, 0)
            if all(wt0.identity(r) for r in range(num_ref0)):
                wt0 = None                        # identity table: skip
        elif is_b and pp.weighted_bipred == 1:
            wt0, wt1 = RP.parse_pred_weight_table(br, num_ref0, num_ref1)
        mmco = []
        if ref_idc:
            try:
                mmco = RP.parse_dec_ref_pic_marking(br, is_idr)
            except ValueError as e:
                raise DecodeError(str(e))
        cabac_init_idc = 0
        if pp.cabac and not is_i:
            cabac_init_idc = br.ue()
        qp = pp.init_qp + br.se()
        deblock_idc = 1
        if pp.deblocking_filter_control_present:
            deblock_idc = br.ue()
            if deblock_idc != 1:
                br.se()
                br.se()

        if self.headers_only:
            if ref_idc:
                self._mark_ref(RP.RefPic(poc=poc, frame_num=fn,
                                         planes=None), mmco)
            self.parsed += 1
            return

        w16, h16 = sp.mb_width * 16, sp.mb_height * 16
        y = np.zeros((h16, w16), np.int32)
        u = np.zeros((h16 // 2, w16 // 2), np.int32)
        v = np.zeros((h16 // 2, w16 // 2), np.int32)
        nz_y = _Nz(sp.mb_height * 4, sp.mb_width * 4)
        nz_cb = _Nz(sp.mb_height * 2, sp.mb_width * 2)
        nz_cr = _Nz(sp.mb_height * 2, sp.mb_width * 2)
        mvs = np.zeros((sp.mb_height, sp.mb_width, 2), np.int32)
        mv_valid = np.zeros((sp.mb_height, sp.mb_width), bool)
        intra_mb = np.zeros((sp.mb_height, sp.mb_width), bool)
        qp_mb = np.full((sp.mb_height, sp.mb_width), qp, np.int32)

        ctx = dict(br=br, sp=sp, pp=pp, qp=qp, y=y, u=u, v=v,
                   nz_y=nz_y, nz_cb=nz_cb, nz_cr=nz_cr,
                   mvs=mvs, mv_valid=mv_valid, intra_mb=intra_mb,
                   qp_mb=qp_mb, cur_qp=qp,
                   i4_modes=np.full((sp.mb_height * 4, sp.mb_width * 4),
                                    -1, np.int8))
        # transform_size_8x8 per MB: luma rows 4b..4b+4 of p_z_luma
        # hold 8x8 block b's 64-scan instead of four 4x4 scans (also
        # drives the 8x8 deblock edge grid; I slices can carry i8 MBs)
        ctx["p_t8"] = np.zeros((sp.mb_height, sp.mb_width), bool)
        if is_p or is_b:
            # P/B slices defer recon: parse fills these level arrays,
            # then one vectorized pass reconstructs every inter MB at
            # once (inter prediction reads only the reference frames, so
            # order is irrelevant); queued intra MBs recon after, in
            # raster order, once their inter neighbors are final.
            ctx["p_z_luma"] = np.zeros(
                (sp.mb_height, sp.mb_width, 16, 16), np.int32)
            ctx["p_cdc"] = np.zeros(
                (sp.mb_height, sp.mb_width, 2, 4), np.int32)
            ctx["p_cac"] = np.zeros(
                (sp.mb_height, sp.mb_width, 2, 4, 16), np.int32)
            # general inter state on the 8x8 block grid: per-list MVs +
            # refIdx (-1 = unused/intra); dec8 marks decoded blocks (in
            # partition order — MV prediction availability, 6.4.9)
            nby2, nbx2 = 2 * sp.mb_height, 2 * sp.mb_width
            ctx["mv8_l0"] = np.zeros((nby2, nbx2, 2), np.int32)
            ctx["ref8_l0"] = np.full((nby2, nbx2), -1, np.int8)
            ctx["dec8"] = np.zeros((nby2, nbx2), bool)
            ctx["n_ref0"], ctx["n_ref1"] = num_ref0, num_ref1
            ctx["wt0"], ctx["wt1"] = wt0, wt1
            max_fn = 1 << sp.log2_max_frame_num
            intra_queue: list = []
            if is_p and not self.parse_only:
                init0 = RP.init_list_p(self.dpb, fn, max_fn)
                try:
                    lst0 = RP.apply_modification(init0, mod0, fn, max_fn,
                                                 num_ref0)
                except ValueError as e:
                    raise DecodeError(str(e))
                if len(lst0) < num_ref0:
                    raise DecodeError("list0 shorter than active count")
                ctx["list0_pics"] = lst0
                ctx["list0"] = [r.planes_i32()
                                for r in lst0]
        if is_b:
            ctx["mv8_l1"] = np.zeros((nby2, nbx2, 2), np.int32)
            ctx["ref8_l1"] = np.full((nby2, nbx2), -1, np.int8)
            i0, i1 = RP.init_lists_b(self.dpb, poc)
            try:
                lst0 = RP.apply_modification(i0, mod0, fn, max_fn,
                                             num_ref0)
                lst1 = RP.apply_modification(i1, mod1, fn, max_fn,
                                             num_ref1)
            except ValueError as e:
                raise DecodeError(str(e))
            if len(lst0) < num_ref0 or len(lst1) < num_ref1:
                raise DecodeError("B picture without both anchor "
                                  "references")
            ctx["list0_pics"], ctx["list1_pics"] = lst0, lst1
            ctx["col"] = lst1[0]
        if is_b and not self.parse_only:
            ctx["list0"] = [r.planes_i32()
                            for r in lst0]
            ctx["list1"] = [r.planes_i32()
                            for r in lst1]
            if pp.weighted_bipred == 2:
                w0 = np.zeros((num_ref0, num_ref1), np.int32)
                w1 = np.zeros((num_ref0, num_ref1), np.int32)
                for r0 in range(num_ref0):
                    for r1 in range(num_ref1):
                        w0[r0, r1], w1[r0, r1] = RP.implicit_weights(
                            poc, lst0[r0].poc, lst1[r1].poc)
                ctx["implicit_w"] = (w0, w1)
        if is_i:
            i_rows: list = [[None] * sp.mb_width
                            for _ in range(sp.mb_height)]

        if not pp.cabac:
            raise DecodeError("a CAVLC slice: the reference parses CABAC "
                              "only")
        br.byte_align()                     # cabac_alignment_one_bit(s)
        payload = rbsp[br.pos // 8:]
        self._parse_cabac_py(ctx, payload, qp, is_i, is_b, cabac_init_idc,
                             i_rows if is_i else None,
                             None if is_i else intra_queue)
        if is_i:
            intra_mb[:, :] = True
        if self.parse_only:
            if ref_idc:
                self._mark_ref(RP.RefPic(poc=poc, frame_num=fn,
                                         planes=None), mmco)
            self.parsed += 1
            return

        if is_p or is_b:
            from . import inter_recon
            inter_recon.recon_inter_frame(ctx)
            for mbx, mby, parsed in intra_queue:
                self._recon_intra_mb(ctx, mbx, mby, parsed)
        else:
            # recon after parse, row by row: a pure-Vertical row (our
            # encoder's rows 1..) depends only on the final row above and
            # reconstructs as one batch; anything else (the DC row 0's
            # left-chain, H modes, mixed rows) falls back per-MB in
            # raster order.
            for mby, row in enumerate(i_rows):
                if mby > 0 and all(
                        isinstance(e, dict)
                        and e.get("pred_mode") == 0
                        and e.get("chroma_mode") == 2 for e in row):
                    self._recon_intra_row_v(ctx, mby, row)
                else:
                    for mbx, e in enumerate(row):
                        if isinstance(e, dict):
                            self._recon_intra_mb(ctx, mbx, mby, e)

        if deblock_idc != 1:
            from . import deblock_host as dbf
            from .xform import CHROMA_QP_FULL
            nz = (nz_y.nz > 0)
            t8g = ctx.get("p_t8")
            if t8g is not None and t8g.any():
                # deblock bS tests residual presence per TRANSFORM block:
                # for 8x8-transform MBs expand nz to 8x8 granularity
                # (nz_y keeps per-4x4 totals for CAVLC nC contexts)
                nzb = nz.reshape(sp.mb_height, 2, 2, sp.mb_width, 2, 2)
                nz8 = np.repeat(np.repeat(nzb.any(axis=(2, 5)), 2, axis=1),
                                2, axis=3).reshape(nz.shape)
                t8px = np.repeat(np.repeat(t8g, 4, 0), 4, 1)
                nz = np.where(t8px, nz8, nz)
            # fold the PPS chroma_qp_index_offset into the lookup table
            cq = np.asarray(CHROMA_QP_FULL)[
                np.clip(np.arange(52) + pp.chroma_qp_index_offset, 0, 51)]
            if is_p or is_b:
                # general 8x8-grid form: per-list MVs + reference-PICTURE
                # ids so bS=1 triggers on different refs (8.7.2.1)
                id0, id1 = RP.ref_id_grids(ctx)
                mvq = {"mv0": ctx["mv8_l0"], "id0": id0}
                if is_b:
                    mvq["mv1"] = ctx["mv8_l1"]
                    mvq["id1"] = id1
            else:
                mvq = mvs
            yf, uf, vf = dbf.deblock_frame_np(
                y, u, v, qp_mb, intra_mb, nz, mvq, cq,
                t8=ctx.get("p_t8"))
            y = np.asarray(yf)
            u = np.asarray(uf)
            v = np.asarray(vf)

        crop_y = (y[: sp.height, : sp.width]).astype(np.uint8)
        crop_u = (u[: sp.height // 2, : sp.width // 2]).astype(np.uint8)
        crop_v = (v[: sp.height // 2, : sp.width // 2]).astype(np.uint8)
        if ref_idc:
            self.ref = (y.astype(np.uint8), u.astype(np.uint8),
                        v.astype(np.uint8))
            # colocated motion for spatial direct when this picture
            # serves as a B's RefPicList1[0] (8.4.1.2.2): per-8x8 MV of
            # the preferred list and whether that refIdx was 0
            nby2, nbx2 = 2 * sp.mb_height, 2 * sp.mb_width
            col_mv8 = np.zeros((nby2, nbx2, 2), np.int32)
            col_ref0 = np.zeros((nby2, nbx2), bool)
            if is_p or is_b:
                r0 = ctx["ref8_l0"]
                col_mv8[:] = ctx["mv8_l0"]
                col_ref0[:] = r0 == 0
                if is_b:
                    use0 = (r0 >= 0)
                    col_mv8 = np.where(use0[..., None], col_mv8,
                                       ctx["mv8_l1"])
                    col_ref0 = np.where(use0, col_ref0,
                                        ctx["ref8_l1"] == 0)
            self._mark_ref(RP.RefPic(poc=poc, frame_num=fn,
                                     planes=self.ref, col_mv8=col_mv8,
                                     col_ref0=col_ref0), mmco)
        self.frames.append(DecodedFrame(crop_y, crop_u, crop_v, is_idr))
        self._order.append((self._group, poc))
        if getattr(self, "collect_stats", False):
            # opt-in per-slice observability (stream analysis / rdbench
            # attribution): slice type, intra-MB share, t8 share, i4/i8
            # block counts
            if not hasattr(self, "mb_stats"):
                self.mb_stats = []
            im = ctx["intra_mb"]
            self.mb_stats.append({
                "type": "I" if is_i else ("B" if is_b else "P"),
                "intra_frac": float(im.mean()),
                "t8_frac": float(ctx["p_t8"].mean()),
                "i_nxn": int(((ctx["i4_modes"] >= 0).reshape(
                    sp.mb_height, 4, sp.mb_width, 4).any(
                        axis=(1, 3))).sum()),
                "n_mb": int(im.size),
            })

    def _mark_ref(self, pic, mmco: list) -> None:
        """Store a reference picture in the DPB with its marking (8.2.5):
        the MMCO ops before it, or the sliding window after it."""
        from . import refpic as RP
        sp = self.sp
        max_fn = 1 << sp.log2_max_frame_num
        if mmco:
            RP.apply_marking(self.dpb, mmco, pic.frame_num, max_fn,
                             sp.num_ref_frames)
        self.dpb.append(pic)
        if not mmco:
            RP.apply_marking(self.dpb, [], pic.frame_num, max_fn,
                             sp.num_ref_frames)

    def _parse_cabac_py(self, ctx, payload: bytes, qp: int, is_i: bool,
                        is_b: bool, init_idc: int, i_rows: list | None,
                        intra_queue: list | None) -> None:
        """Parse a CABAC slice with the Python parsers
        (``VCP_NO_NATIVE=1``): an I slice into ``i_rows`` and the cbf /
        QP / t8 grids, as ``vcp_tpu``'s decoder does; a P or B slice into
        the ctx and ``intra_queue``."""
        from . import cabac_syntax as CS
        from . import inter_cabac
        sp, pp = ctx["sp"], ctx["pp"]
        try:
            if not is_i:
                inter_cabac.parse_inter_slice_cabac(ctx, payload, qp, is_b,
                                                    init_idc, intra_queue)
                return
            rows, st = CS.parse_islice_cabac(
                payload, qp, sp.mb_height, sp.mb_width,
                transform_8x8=pp.transform_8x8)
        except DecodeError:
            raise
        except ValueError as e:
            raise DecodeError(str(e)) from e
        i_rows[:] = rows
        ctx["nz_y"].nz[:, :] = st.cbf_l4
        ctx["nz_cb"].nz[:, :] = st.cbf_c4[0]
        ctx["nz_cr"].nz[:, :] = st.cbf_c4[1]
        ctx["qp_mb"][:, :] = [[e.get("qp", qp) for e in row] for row in rows]
        if st.t8.any():
            ctx["p_t8"] = st.t8     # 8x8 deblock edge semantics

    # -- B slices ---------------------------------------------------------
    # -- intra MBs --------------------------------------------------------
    # -- I_4x4 / I_8x8 (I_NxN) macroblocks (foreign streams) --------------
    def _recon_intra_mb(self, ctx, mbx, mby, parsed):
        if parsed.get("kind") == "i4":
            return self._recon_i4x4_mb(ctx, mbx, mby, parsed)
        if parsed.get("kind") == "i8":
            return self._recon_i8x8_mb(ctx, mbx, mby, parsed)
        pred_mode = parsed["pred_mode"]
        chroma_mode = parsed["chroma_mode"]
        dc_zz, ac = parsed["dc_zz"], parsed["ac"]
        cdc, cac = parsed["cdc"], parsed["cac"]
        qp = parsed.get("qp", ctx["qp"])
        qpc = tf.chroma_qp(qp, ctx["pp"].chroma_qp_index_offset)

        # ---- luma recon
        y = ctx["y"]
        y0, x0 = 16 * mby, 16 * mbx
        pred = self._intra16_pred(y, y0, x0, pred_mode)
        dc_blk = unzigzag(dc_zz)
        dc_rec = tf.dequant_dc4_np(dc_blk[None], qp)[0]
        wq = np.zeros((16, 4, 4), np.int32)
        for blk in range(16):
            wq[blk] = unzigzag(ac[blk])
        w_rec = tf.dequant4_np(wq, qp)
        for blk in range(16):
            oy, ox = int(LUMA_BLK_ORDER[blk, 0]), int(LUMA_BLK_ORDER[blk, 1])
            w_rec[blk, 0, 0] = dc_rec[oy, ox]
        res = tf.idct4_np(w_rec)
        mb_rec = pred.astype(np.int64)
        for blk in range(16):
            oy, ox = int(LUMA_BLK_ORDER[blk, 0]), int(LUMA_BLK_ORDER[blk, 1])
            mb_rec[4 * oy:4 * oy + 4, 4 * ox:4 * ox + 4] += res[blk]
        y[y0:y0 + 16, x0:x0 + 16] = np.clip(mb_rec, 0, 255)

        self._recon_intra_chroma(ctx, mbx, mby, chroma_mode, cdc, cac, qpc)

    def _recon_intra_chroma(self, ctx, mbx, mby, chroma_mode, cdc, cac,
                            qpc):
        for c, plane in ((0, ctx["u"]), (1, ctx["v"])):
            c0y, c0x = 8 * mby, 8 * mbx
            predc = self._chroma_pred(plane, c0y, c0x, chroma_mode)
            dc2 = cdc[c].reshape(2, 2)
            dc2_rec = tf.dequant_dc2_np(dc2[None], qpc)[0]
            wqc = np.zeros((4, 4, 4), np.int32)
            for blk in range(4):
                wqc[blk] = unzigzag(cac[c, blk])
            wc_rec = tf.dequant4_np(wqc, qpc)
            for blk in range(4):
                oy, ox = int(CHROMA_BLK_ORDER[blk, 0]), int(CHROMA_BLK_ORDER[blk, 1])
                wc_rec[blk, 0, 0] = dc2_rec[oy, ox]
            resc = tf.idct4_np(wc_rec)
            rec = predc.astype(np.int64)
            for blk in range(4):
                oy, ox = int(CHROMA_BLK_ORDER[blk, 0]), int(CHROMA_BLK_ORDER[blk, 1])
                rec[4 * oy:4 * oy + 4, 4 * ox:4 * ox + 4] += resc[blk]
            plane[c0y:c0y + 8, c0x:c0x + 8] = np.clip(rec, 0, 255)

    def _recon_i4x4_mb(self, ctx, mbx, mby, parsed):
        """Reconstruct an I_4x4 MB block-by-block in coding order (each
        block predicts from already-reconstructed neighbors)."""
        y = ctx["y"]
        sp = ctx["sp"]
        qp = parsed["qp"]
        qpc = tf.chroma_qp(qp, ctx["pp"].chroma_qp_index_offset)
        luma = np.asarray(parsed["luma"])
        wq = np.zeros_like(luma)
        wq[..., _ZZ] = luma                   # (16, 16) unzigzag batch
        res = tf.idct4_np(tf.dequant4_np(wq.reshape(16, 4, 4), qp))
        for blk in range(16):
            oy = int(LUMA_BLK_ORDER[blk, 0])
            ox = int(LUMA_BLK_ORDER[blk, 1])
            r0, c0 = 16 * mby + 4 * oy, 16 * mbx + 4 * ox
            pred = self._intra4_pred(y, r0, c0, int(parsed["modes"][blk]),
                                     16 * sp.mb_width, blk)
            y[r0:r0 + 4, c0:c0 + 4] = np.clip(
                pred.astype(np.int64) + res[blk], 0, 255)
        self._recon_intra_chroma(ctx, mbx, mby, parsed["chroma_mode"],
                                 parsed["cdc"], parsed["cac"], qpc)

    def _recon_i8x8_mb(self, ctx, mbx, mby, parsed):
        """Reconstruct an I_NxN MB with transform_size_8x8: four 8x8
        blocks in raster order, spec 8.3.2 prediction over FILTERED
        reference samples + the High-profile 8x8 inverse transform."""
        from . import xform as t8ops
        y = ctx["y"]
        sp = ctx["sp"]
        qp = parsed["qp"]
        qpc = tf.chroma_qp(qp, ctx["pp"].chroma_qp_index_offset)
        frame_w = 16 * sp.mb_width
        scans = np.asarray(parsed["luma"]).reshape(4, 64)
        wq = t8ops.unzigzag8_np(scans)        # all four blocks batched
        res4 = t8ops.idct8_np(t8ops.dequant8_np(wq, qp))
        for b8 in range(4):
            r0 = 16 * mby + 8 * (b8 // 2)
            c0 = 16 * mbx + 8 * (b8 % 2)
            pred = self._intra8_pred(y, r0, c0,
                                     int(parsed["modes"][4 * b8]), frame_w)
            y[r0:r0 + 8, c0:c0 + 8] = np.clip(
                pred.astype(np.int64) + res4[b8], 0, 255)
        self._recon_intra_chroma(ctx, mbx, mby, parsed["chroma_mode"],
                                 parsed["cdc"], parsed["cac"], qpc)

    def _intra8_pred(self, y, r0, c0, mode, frame_w):
        """Spec 8.3.2: 8x8 luma prediction — reference samples are
        low-pass filtered (8.3.2.2.1) before every mode."""
        top_ok = r0 > 0
        left_ok = c0 > 0
        tl_ok = top_ok and left_ok
        t = np.zeros(16, np.int64)
        if top_ok:
            t[:8] = y[r0 - 1, c0:c0 + 8]
            # top-right: inside the frame AND already decoded (not across
            # the right MB boundary from the bottom half of the MB)
            tr_ok = (c0 + 8 < frame_w
                     and not (r0 % 16 == 8 and (c0 + 8) % 16 == 0))
            if tr_ok:
                t[8:] = y[r0 - 1, c0 + 8:c0 + 16]
            else:
                t[8:] = t[7]
        le = y[r0:r0 + 8, c0 - 1].astype(np.int64) if left_ok \
            else np.zeros(8, np.int64)
        m = int(y[r0 - 1, c0 - 1]) if tl_ok else 0

        # ---- reference filtering (8.3.2.2.1)
        ft = t.copy()
        if top_ok:
            ft[0] = ((m + 2 * t[0] + t[1] + 2) >> 2) if tl_ok \
                else ((3 * t[0] + t[1] + 2) >> 2)
            for x in range(1, 15):
                ft[x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2
            ft[15] = (t[14] + 3 * t[15] + 2) >> 2
        fle = le.copy()
        if left_ok:
            fle[0] = ((m + 2 * le[0] + le[1] + 2) >> 2) if tl_ok \
                else ((3 * le[0] + le[1] + 2) >> 2)
            for yy in range(1, 7):
                fle[yy] = (le[yy - 1] + 2 * le[yy] + le[yy + 1] + 2) >> 2
            fle[7] = (le[6] + 3 * le[7] + 2) >> 2
        fm = ((t[0] + 2 * m + le[0] + 2) >> 2) if tl_ok else m

        t, le, m = ft, fle, fm
        out = np.zeros((8, 8), np.int64)
        if mode == 0:                                  # Vertical
            if not top_ok:
                raise DecodeError("i8 V without top")
            return np.broadcast_to(t[:8], (8, 8)).copy()
        if mode == 1:                                  # Horizontal
            if not left_ok:
                raise DecodeError("i8 H without left")
            return np.broadcast_to(le[:, None], (8, 8)).copy()
        if mode == 2:                                  # DC
            if top_ok and left_ok:
                dc = (int(t[:8].sum()) + int(le.sum()) + 8) >> 4
            elif top_ok:
                dc = (int(t[:8].sum()) + 4) >> 3
            elif left_ok:
                dc = (int(le.sum()) + 4) >> 3
            else:
                dc = 128
            out[:] = dc
            return out
        r = np.zeros(25, np.int64)
        if left_ok:
            r[0:8] = le
        r[8] = m
        if top_ok:
            r[9:25] = t
        if mode not in _I8_TABS:
            raise DecodeError(f"i8 mode {mode} unsupported")
        Ia, Ic, Ib = _I8_TABS[mode]
        return (r[Ia] + 2 * r[Ib] + r[Ic] + 2) >> 2

    # within-MB decode order of 4x4 blocks, by (row, col) offsets
    _BLK_DECODE_ORDER = None

    @classmethod
    def _blk_order_map(cls):
        if cls._BLK_DECODE_ORDER is None:
            m = np.zeros((4, 4), np.int32)
            for blk in range(16):
                m[int(LUMA_BLK_ORDER[blk, 0]),
                  int(LUMA_BLK_ORDER[blk, 1])] = blk
            cls._BLK_DECODE_ORDER = m
        return cls._BLK_DECODE_ORDER

    def _intra4_pred(self, y, r0, c0, mode, frame_w, blk):
        """Spec 8.3.1.2: the nine 4x4 luma prediction modes."""
        top_ok = r0 > 0
        left_ok = c0 > 0
        tl_ok = top_ok and left_ok
        t = y[r0 - 1, c0:c0 + 4].astype(np.int64) if top_ok else None
        le = y[r0:r0 + 4, c0 - 1].astype(np.int64) if left_ok else None
        m = int(y[r0 - 1, c0 - 1]) if tl_ok else 0
        # top-right: available only when those samples are inside the
        # frame AND decoded before this block (decode order: MB raster,
        # LUMA_BLK_ORDER within the MB)
        tr = None
        if top_ok and c0 + 4 < frame_w:
            omap = self._blk_order_map()
            cur = (r0 // 16 * 10000 + c0 // 16,
                   int(omap[(r0 % 16) // 4, (c0 % 16) // 4]))
            nbr_r, nbr_c = r0 - 4, c0 + 4
            nbr = (nbr_r // 16 * 10000 + nbr_c // 16,
                   int(omap[(nbr_r % 16) // 4, (nbr_c % 16) // 4]))
            if nbr < cur:
                tr = y[r0 - 1, c0 + 4:c0 + 8].astype(np.int64)
        if tr is None and top_ok:
            tr = np.full(4, int(t[3]), np.int64)

        out = np.zeros((4, 4), np.int64)
        if mode == 0:                                  # Vertical
            if not top_ok:
                raise DecodeError("i4 V without top")
            return np.broadcast_to(t, (4, 4)).copy()
        if mode == 1:                                  # Horizontal
            if not left_ok:
                raise DecodeError("i4 H without left")
            return np.broadcast_to(le[:, None], (4, 4)).copy()
        if mode == 2:                                  # DC
            if top_ok and left_ok:
                dc = (int(t.sum()) + int(le.sum()) + 4) >> 3
            elif top_ok:
                dc = (int(t.sum()) + 2) >> 2
            elif left_ok:
                dc = (int(le.sum()) + 2) >> 2
            else:
                dc = 128
            out[:] = dc
            return out
        r = np.zeros(13, np.int64)
        if left_ok:
            r[0:4] = le
        r[4] = m
        if top_ok:
            r[5:9] = t
            r[9:13] = tr
        if mode not in _I4_TABS:
            raise DecodeError(f"i4 mode {mode} unsupported")
        Ia, Ic, Ib = _I4_TABS[mode]
        return (r[Ia] + 2 * r[Ib] + r[Ic] + 2) >> 2

    def _recon_intra_row_v(self, ctx, mby, row):
        """Batched recon of one all-Vertical I16x16 MB row (luma V +
        chroma V): prediction is the final pixel row above, broadcast;
        residuals dequant/idct in one batch per plane."""
        from .consts import LUMA_BLK_ORDER as LBO
        from .pframe_dec import _BLK_GRID
        zz = _ZZ
        qp = ctx["qp"]
        qpc = tf.chroma_qp(qp, ctx["pp"].chroma_qp_index_offset)
        n_mbx = len(row)
        y = ctx["y"]
        w = 16 * n_mbx

        dc_zz = np.stack([e["dc_zz"] for e in row])      # (nMBx, 16)
        ac = np.stack([e["ac"] for e in row])            # (nMBx, 16, 16)
        dc_blk = np.zeros_like(dc_zz)
        dc_blk[..., zz] = dc_zz
        dc_rec = tf.dequant_dc4_np(dc_blk.reshape(n_mbx, 4, 4), qp)
        wq_flat = np.zeros_like(ac)
        wq_flat[..., zz] = ac
        wq = tf.dequant4_np(wq_flat.reshape(n_mbx, 16, 4, 4), qp)
        wq[:, :, 0, 0] = dc_rec[:, LBO[:, 0], LBO[:, 1]]
        res = tf.idct4_np(wq)                            # (nMBx, 16, 4, 4)
        res_rows = res[:, _BLK_GRID].transpose(1, 3, 0, 2, 4).reshape(16, w)
        y0 = 16 * mby
        pred = y[y0 - 1, :][None, :]
        y[y0:y0 + 16, :] = np.clip(pred + res_rows, 0, 255)

        cdc = np.stack([e["cdc"] for e in row])          # (nMBx, 2, 4)
        cac = np.stack([e["cac"] for e in row])          # (nMBx, 2, 4, 16)
        wc2 = 8 * n_mbx
        c0y = 8 * mby
        for ci, plane in enumerate((ctx["u"], ctx["v"])):
            dc2_rec = tf.dequant_dc2_np(
                cdc[:, ci].reshape(n_mbx, 2, 2), qpc)    # (nMBx, 2, 2)
            wc_flat = np.zeros_like(cac[:, ci])
            wc_flat[..., zz] = cac[:, ci]
            wcq = tf.dequant4_np(wc_flat.reshape(n_mbx, 4, 4, 4), qpc)
            wcq[:, :, 0, 0] = dc2_rec.reshape(n_mbx, 4)  # raster order
            resc = tf.idct4_np(wcq).reshape(n_mbx, 2, 2, 4, 4)
            resc_rows = resc.transpose(1, 3, 0, 2, 4).reshape(8, wc2)
            predc = plane[c0y - 1, :][None, :]
            plane[c0y:c0y + 8, :] = np.clip(predc + resc_rows, 0, 255)

    def _intra16_pred(self, y, y0, x0, mode) -> np.ndarray:
        top_ok = y0 > 0
        left_ok = x0 > 0
        if mode == 0:                              # Vertical
            if not top_ok:
                raise DecodeError("V pred without top")
            return np.broadcast_to(y[y0 - 1, x0:x0 + 16], (16, 16)).copy()
        if mode == 1:                              # Horizontal
            if not left_ok:
                raise DecodeError("H pred without left")
            return np.broadcast_to(y[y0:y0 + 16, x0 - 1][:, None], (16, 16)).copy()
        if mode == 2:                              # DC
            if top_ok and left_ok:
                dc = (int(y[y0 - 1, x0:x0 + 16].sum())
                      + int(y[y0:y0 + 16, x0 - 1].sum()) + 16) >> 5
            elif top_ok:
                dc = (int(y[y0 - 1, x0:x0 + 16].sum()) + 8) >> 4
            elif left_ok:
                dc = (int(y[y0:y0 + 16, x0 - 1].sum()) + 8) >> 4
            else:
                dc = 128
            return np.full((16, 16), dc, np.int64)
        if mode == 3:                              # Plane (spec 8.3.3.4)
            if not (top_ok and left_ok):
                raise DecodeError("Plane pred without neighbors")
            t = y[y0 - 1, x0 - 1:x0 + 16].astype(np.int64)  # t[0] = corner
            le = y[y0 - 1:y0 + 16, x0 - 1].astype(np.int64)
            hh = sum((x + 1) * (int(t[9 + x]) - int(t[7 - x]))
                     for x in range(8))
            vv = sum((yy + 1) * (int(le[9 + yy]) - int(le[7 - yy]))
                     for yy in range(8))
            a = 16 * (int(t[16]) + int(le[16]))
            b = (5 * hh + 32) >> 6
            c = (5 * vv + 32) >> 6
            xs = np.arange(16)
            grid = a + b * (xs[None, :] - 7) + c * (xs[:, None] - 7) + 16
            return np.clip(grid >> 5, 0, 255)
        raise DecodeError(f"I16 pred mode {mode} unsupported")

    def _chroma_pred(self, plane, c0y, c0x, mode) -> np.ndarray:
        top_ok = c0y > 0
        left_ok = c0x > 0
        if mode == 2:                              # Vertical
            if not top_ok:
                raise DecodeError("chroma V without top")
            return np.broadcast_to(plane[c0y - 1, c0x:c0x + 8], (8, 8)).copy()
        if mode == 1:                              # Horizontal
            if not left_ok:
                raise DecodeError("chroma H without left")
            return np.broadcast_to(
                plane[c0y:c0y + 8, c0x - 1][:, None], (8, 8)).copy()
        if mode == 0:                              # DC (per 4x4 sub-block)
            out = np.zeros((8, 8), np.int64)
            for sy in range(2):
                for sx in range(2):
                    tvals = plane[c0y - 1, c0x + 4 * sx:c0x + 4 * sx + 4] \
                        if top_ok else None
                    lvals = plane[c0y + 4 * sy:c0y + 4 * sy + 4, c0x - 1] \
                        if left_ok else None
                    # corner blocks use specific neighbor choices
                    use_t = tvals is not None and (sy == 0 or (sy, sx) == (1, 1) or lvals is None)
                    use_l = lvals is not None and (sx == 0 or (sy, sx) == (1, 1) or tvals is None)
                    if (sy, sx) == (0, 1) and tvals is not None:
                        use_t, use_l = True, False
                    if (sy, sx) == (1, 0) and lvals is not None:
                        use_t, use_l = False, True
                    if use_t and use_l:
                        dc = (int(tvals.sum()) + int(lvals.sum()) + 4) >> 3
                    elif use_t:
                        dc = (int(tvals.sum()) + 2) >> 2
                    elif use_l:
                        dc = (int(lvals.sum()) + 2) >> 2
                    else:
                        dc = 128
                    out[4 * sy:4 * sy + 4, 4 * sx:4 * sx + 4] = dc
            return out
        if mode == 3:                              # Plane (spec 8.3.4.4)
            if not (top_ok and left_ok):
                raise DecodeError("chroma Plane without neighbors")
            t = plane[c0y - 1, c0x - 1:c0x + 8].astype(np.int64)
            le = plane[c0y - 1:c0y + 8, c0x - 1].astype(np.int64)
            hh = sum((x + 1) * (int(t[5 + x]) - int(t[3 - x]))
                     for x in range(4))
            vv = sum((yy + 1) * (int(le[5 + yy]) - int(le[3 - yy]))
                     for yy in range(4))
            a = 16 * (int(t[8]) + int(le[8]))
            b = (17 * hh + 16) >> 5
            c = (17 * vv + 16) >> 5
            xs = np.arange(8)
            grid = a + b * (xs[None, :] - 3) + c * (xs[:, None] - 3) + 16
            return np.clip(grid >> 5, 0, 255)
        raise DecodeError(f"chroma pred mode {mode} unsupported")

    # -- inter MBs ---------------------------------------------------------
