"""H.264 parameter-set and slice-header bitstreams (host); copy of
``vcp_tpu/codec/h264/headers.py``: the writers, and the SPS / PPS
parsers of the host decoder.

Baseline-profile, 4:2:0, frame-coded, one slice per picture,
pic_order_cnt_type=2 (display order == decode order; no B-frames), one
reference frame. Deblocking is signalled per slice
(``disable_deblocking_filter_idc``). Replaces the container/codec headers
ffmpeg produced for the reference's presets (ref config.go:44-52).
"""

from __future__ import annotations

import dataclasses

from ...utils.bitstream import BitReader, BitWriter, nal_unit

NAL_SLICE_NONIDR = 1
NAL_SLICE_IDR = 5
NAL_SPS = 7
NAL_PPS = 8

SLICE_TYPE_P_ALL = 5   # "all slices in this picture are P"
SLICE_TYPE_B_ALL = 6
SLICE_TYPE_I_ALL = 7


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


def write_sps(sp: SeqParams) -> bytes:
    bw = BitWriter()
    bw.u(8, sp.profile_idc)
    # constraint_set0..5 + 2 reserved bits
    bw.u(8, 0b11000000 if sp.profile_idc == 66 else 0)
    bw.u(8, sp.level_idc)
    bw.ue(sp.sps_id)
    if sp.profile_idc >= 100:      # High: chroma/bit-depth/scaling fields
        bw.ue(1)                   # chroma_format_idc 4:2:0
        bw.ue(0)                   # bit_depth_luma_minus8
        bw.ue(0)                   # bit_depth_chroma_minus8
        bw.u(1, 0)                 # qpprime_y_zero_transform_bypass_flag
        bw.u(1, 0)                 # seq_scaling_matrix_present_flag
    bw.ue(sp.log2_max_frame_num - 4)
    bw.ue(sp.poc_type)             # 2 unless B frames (then 0)
    if sp.poc_type == 0:
        bw.ue(sp.log2_max_poc_lsb - 4)
    bw.ue(sp.num_ref_frames)
    bw.u(1, 0)                     # gaps_in_frame_num_value_allowed_flag
    bw.ue(sp.mb_width - 1)
    bw.ue(sp.mb_height - 1)
    bw.u(1, 1)                     # frame_mbs_only_flag
    bw.u(1, 1)                     # direct_8x8_inference_flag
    crop_r = sp.mb_width * 16 - sp.width
    crop_b = sp.mb_height * 16 - sp.height
    if crop_r or crop_b:
        bw.u(1, 1)
        bw.ue(0)                   # left (in 2-px chroma units)
        bw.ue(crop_r // 2)
        bw.ue(0)
        bw.ue(crop_b // 2)
    else:
        bw.u(1, 0)
    bw.u(1, 0)                     # vui_parameters_present_flag
    bw.rbsp_trailing_bits()
    return nal_unit(NAL_SPS, bw.to_bytes(), nal_ref_idc=3, long_start=True)


def write_pps(pp: PicParams) -> bytes:
    bw = BitWriter()
    bw.ue(pp.pps_id)
    bw.ue(pp.sps_id)
    bw.u(1, 1 if pp.cabac else 0)  # entropy_coding_mode_flag
    bw.u(1, 0)                     # bottom_field_pic_order_in_frame_present
    bw.ue(0)                       # num_slice_groups_minus1
    bw.ue(0)                       # num_ref_idx_l0_default_active_minus1
    bw.ue(0)                       # num_ref_idx_l1_default_active_minus1
    bw.u(1, 0)                     # weighted_pred_flag
    bw.u(2, 0)                     # weighted_bipred_idc
    bw.se(pp.init_qp - 26)         # pic_init_qp_minus26
    bw.se(0)                       # pic_init_qs_minus26
    bw.se(pp.chroma_qp_index_offset)
    bw.u(1, 1 if pp.deblocking_filter_control_present else 0)
    bw.u(1, 0)                     # constrained_intra_pred_flag
    bw.u(1, 0)                     # redundant_pic_cnt_present_flag
    if pp.transform_8x8:           # High-profile PPS extension
        bw.u(1, 1)                 # transform_8x8_mode_flag
        bw.u(1, 0)                 # pic_scaling_matrix_present_flag
        bw.se(pp.chroma_qp_index_offset)  # second_chroma_qp_index_offset
    bw.rbsp_trailing_bits()
    return nal_unit(NAL_PPS, bw.to_bytes(), nal_ref_idc=3, long_start=True)


def write_slice_header(bw: BitWriter, sp: SeqParams, pp: PicParams, *,
                       is_idr: bool, frame_num: int, slice_qp: int,
                       idr_pic_id: int = 0,
                       disable_deblocking: bool = True,
                       slice_type: str | None = None,
                       poc_lsb: int = 0,
                       is_ref: bool = True) -> None:
    """Append the slice header for a full-picture I/P/B slice.
    ``slice_type`` is "I"/"P"/"B" (defaults to I for IDR else P);
    ``poc_lsb`` is written when the SPS carries poc_type 0 (B streams);
    ``is_ref`` gates dec_ref_pic_marking (absent for nal_ref_idc 0,
    i.e. non-reference B pictures)."""
    st = slice_type or ("I" if is_idr else "P")
    bw.ue(0)                                  # first_mb_in_slice
    bw.ue({"I": SLICE_TYPE_I_ALL, "P": SLICE_TYPE_P_ALL,
           "B": SLICE_TYPE_B_ALL}[st])
    bw.ue(pp.pps_id)
    bw.u(sp.log2_max_frame_num, frame_num % (1 << sp.log2_max_frame_num))
    if is_idr:
        bw.ue(idr_pic_id)
    if sp.poc_type == 0:
        bw.u(sp.log2_max_poc_lsb, poc_lsb % (1 << sp.log2_max_poc_lsb))
    if st == "B":
        bw.u(1, 1)                            # direct_spatial_mv_pred_flag
    if st != "I":
        bw.u(1, 0)                            # num_ref_idx_active_override
        bw.u(1, 0)                            # ref_pic_list_modification_flag_l0
        if st == "B":
            bw.u(1, 0)                        # ref_pic_list_modification_flag_l1
    # dec_ref_pic_marking (only for reference pictures, nal_ref_idc != 0)
    if is_idr:
        bw.u(1, 0)                            # no_output_of_prior_pics_flag
        bw.u(1, 0)                            # long_term_reference_flag
    elif is_ref:
        bw.u(1, 0)                            # adaptive_ref_pic_marking_mode
    if pp.cabac and st != "I":
        bw.ue(0)                              # cabac_init_idc
    bw.se(slice_qp - pp.init_qp)              # slice_qp_delta
    if pp.deblocking_filter_control_present:
        if disable_deblocking:
            bw.ue(1)                          # disable_deblocking_filter_idc
        else:
            bw.ue(0)
            bw.se(0)                          # slice_alpha_c0_offset_div2
            bw.se(0)                          # slice_beta_offset_div2


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
