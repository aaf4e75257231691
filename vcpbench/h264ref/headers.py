"""H.264 parameter-set and slice-header bitstreams (host); copy of
``vcp_tpu/codec/h264/headers.py``: the SPS / PPS parsers of the host
decoder.
"""

from __future__ import annotations

import dataclasses

from .bitstream import BitReader

NAL_SLICE_NONIDR = 1
NAL_SLICE_IDR = 5
NAL_SPS = 7
NAL_PPS = 8


@dataclasses.dataclass
class SeqParams:
    width: int                    # display width (may be unaligned)
    height: int
    profile_idc: int = 66         # Baseline
    level_idc: int = 40           # L4.0 (1080p30 fits)
    log2_max_frame_num: int = 8
    num_ref_frames: int = 1
    sps_id: int = 0
    poc_type: int = 2              # 2 = output order == decode order
    log2_max_poc_lsb: int = 8      # used when poc_type == 0

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16


@dataclasses.dataclass
class PicParams:
    pps_id: int = 0
    sps_id: int = 0
    init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: bool = True
    cabac: bool = False            # entropy_coding_mode_flag
    num_ref_l0: int = 1            # num_ref_idx_l0_default_active
    num_ref_l1: int = 1            # num_ref_idx_l1_default_active
    transform_8x8: bool = False    # PPS ext transform_8x8_mode_flag
    weighted_pred: bool = False    # weighted_pred_flag (P explicit)
    weighted_bipred: int = 0       # weighted_bipred_idc (2 = implicit)


# ---------------------------------------------------------------------------
# Parsing (for the host decoder)
# ---------------------------------------------------------------------------

def parse_sps(rbsp: bytes) -> SeqParams:
    br = BitReader(rbsp)
    profile = br.u(8)
    br.u(8)
    level = br.u(8)
    sps_id = br.ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139,
                   134, 135):
        chroma_format = br.ue()
        if chroma_format != 1:
            raise ValueError(f"chroma_format_idc {chroma_format} "
                             "unsupported (4:2:0 only)")
        if br.ue() != 0 or br.ue() != 0:   # bit depths
            raise ValueError("high bit depth unsupported")
        br.u(1)                            # qpprime_y_zero_transform_bypass
        if br.u(1):
            raise ValueError("seq scaling matrices unsupported")
    log2_mfn = br.ue() + 4
    poc_type = br.ue()
    log2_max_poc = 8
    if poc_type == 0:
        log2_max_poc = br.ue() + 4
    elif poc_type == 1:
        raise ValueError("poc_type 1 unsupported")
    num_ref = br.ue()
    br.u(1)
    mbw = br.ue() + 1
    mbh = br.ue() + 1
    frame_mbs_only = br.u(1)
    if not frame_mbs_only:
        raise ValueError("interlaced unsupported")
    br.u(1)
    width, height = mbw * 16, mbh * 16
    if br.u(1):  # cropping
        cl, cr, ct, cb = br.ue(), br.ue(), br.ue(), br.ue()
        width -= 2 * (cl + cr)
        height -= 2 * (ct + cb)
    return SeqParams(width=width, height=height, profile_idc=profile,
                     level_idc=level, log2_max_frame_num=log2_mfn,
                     num_ref_frames=num_ref, sps_id=sps_id,
                     poc_type=poc_type, log2_max_poc_lsb=log2_max_poc)


def parse_pps(rbsp: bytes) -> PicParams:
    br = BitReader(rbsp)
    pps_id = br.ue()
    sps_id = br.ue()
    cabac = bool(br.u(1))
    br.u(1)
    if br.ue() != 0:
        raise ValueError("slice groups unsupported")
    num_ref_l0 = br.ue() + 1
    num_ref_l1 = br.ue() + 1
    weighted_pred = bool(br.u(1))
    weighted_bipred = br.u(2)
    init_qp = br.se() + 26
    br.se()
    chroma_off = br.se()
    deblock_present = bool(br.u(1))
    constrained_intra = br.u(1)
    if constrained_intra:
        raise ValueError("constrained_intra_pred unsupported")
    br.u(1)                                    # redundant_pic_cnt_present
    transform_8x8 = False
    if br.more_rbsp_data():                    # High-profile PPS extension
        transform_8x8 = bool(br.u(1))
        if br.u(1):
            raise ValueError("pic scaling matrices unsupported")
        br.se()                                # second_chroma_qp_index_offset
    return PicParams(pps_id=pps_id, sps_id=sps_id, init_qp=init_qp,
                     chroma_qp_index_offset=chroma_off,
                     deblocking_filter_control_present=deblock_present,
                     cabac=cabac, num_ref_l0=num_ref_l0,
                     num_ref_l1=num_ref_l1,
                     transform_8x8=transform_8x8,
                     weighted_pred=weighted_pred,
                     weighted_bipred=weighted_bipred)
