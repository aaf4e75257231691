"""HEVC parameter-set and slice-segment-header writers (spec 7.3.2/7.3.6).

Copy of ``vcp_tpu/codec/h265/headers.py`` (host code).
"""

from __future__ import annotations

import dataclasses

from ...utils.bitstream import BitWriter, emulation_prevent

# NAL unit types (Table 7-1)
NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34

MAIN_PROFILE_IDC = 1


@dataclasses.dataclass
class HevcParams:
    width: int                 # luma samples (multiple of min CB = 8)
    height: int
    qp: int = 30
    level_idc: int = 120       # level 4.0 (x30)
    log2_ctu: int = 6          # 64x64 CTUs
    log2_min_cb: int = 3       # 8x8 min coding block
    conf_win_right: int = 0    # conformance crop (luma samples)
    conf_win_bottom: int = 0
    pcm_enabled: bool = False
    log2_min_pcm: int = 5      # 32x32 PCM blocks when enabled

    @property
    def ctb_size(self) -> int:
        return 1 << self.log2_ctu

    @property
    def pic_width_in_ctbs(self) -> int:
        return (self.width + self.ctb_size - 1) >> self.log2_ctu

    @property
    def pic_height_in_ctbs(self) -> int:
        return (self.height + self.ctb_size - 1) >> self.log2_ctu


def hevc_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0) -> bytes:
    """Annex-B NAL: start code + 2-byte header + escaped payload."""
    hdr = bytes([(nal_type << 1) & 0x7E, 1 + temporal_id])
    return b"\x00\x00\x00\x01" + hdr + emulation_prevent(rbsp)


def _profile_tier_level(bw: BitWriter, p: HevcParams) -> None:
    """general_profile_tier_level with no sub-layers (7.3.3)."""
    bw.u(2, 0)                       # general_profile_space
    bw.u(1, 0)                       # general_tier_flag (Main tier)
    bw.u(5, MAIN_PROFILE_IDC)        # general_profile_idc
    flags = 1 << (31 - MAIN_PROFILE_IDC)
    bw.u(32, flags)                  # general_profile_compatibility_flags
    bw.u(1, 1)                       # general_progressive_source_flag
    bw.u(1, 0)                       # general_interlaced_source_flag
    bw.u(1, 1)                       # general_non_packed_constraint_flag
    bw.u(1, 1)                       # general_frame_only_constraint_flag
    bw.u(32, 0)                      # general_reserved_zero_44bits...
    bw.u(12, 0)
    bw.u(8, p.level_idc)             # general_level_idc


def write_vps(p: HevcParams) -> bytes:
    bw = BitWriter()
    bw.u(4, 0)                       # vps_video_parameter_set_id
    bw.u(1, 1)                       # vps_base_layer_internal_flag
    bw.u(1, 1)                       # vps_base_layer_available_flag
    bw.u(6, 0)                       # vps_max_layers_minus1
    bw.u(3, 0)                       # vps_max_sub_layers_minus1
    bw.u(1, 1)                       # vps_temporal_id_nesting_flag
    bw.u(16, 0xFFFF)                 # vps_reserved_0xffff_16bits
    _profile_tier_level(bw, p)
    bw.u(1, 0)                       # vps_sub_layer_ordering_info_present
    bw.ue(1)                         # vps_max_dec_pic_buffering_minus1
    bw.ue(0)                         # vps_max_num_reorder_pics
    bw.ue(0)                         # vps_max_latency_increase_plus1
    bw.u(6, 0)                       # vps_max_layer_id
    bw.ue(0)                         # vps_num_layer_sets_minus1
    bw.u(1, 0)                       # vps_timing_info_present_flag
    bw.u(1, 0)                       # vps_extension_flag
    bw.rbsp_trailing_bits()
    return hevc_nal(NAL_VPS, bw.to_bytes())


def write_sps(p: HevcParams) -> bytes:
    bw = BitWriter()
    bw.u(4, 0)                       # sps_video_parameter_set_id
    bw.u(3, 0)                       # sps_max_sub_layers_minus1
    bw.u(1, 1)                       # sps_temporal_id_nesting_flag
    _profile_tier_level(bw, p)
    bw.ue(0)                         # sps_seq_parameter_set_id
    bw.ue(1)                         # chroma_format_idc (4:2:0)
    bw.ue(p.width)                   # pic_width_in_luma_samples
    bw.ue(p.height)                  # pic_height_in_luma_samples
    if p.conf_win_right or p.conf_win_bottom:
        bw.u(1, 1)                   # conformance_window_flag
        bw.ue(0)                     # left (chroma units: /2 for 4:2:0)
        bw.ue(p.conf_win_right // 2)
        bw.ue(0)                     # top
        bw.ue(p.conf_win_bottom // 2)
    else:
        bw.u(1, 0)
    bw.ue(0)                         # bit_depth_luma_minus8
    bw.ue(0)                         # bit_depth_chroma_minus8
    bw.ue(4)                         # log2_max_pic_order_cnt_lsb_minus4
    bw.u(1, 0)                       # sps_sub_layer_ordering_info_present
    bw.ue(1)                         # sps_max_dec_pic_buffering_minus1
    bw.ue(0)                         # sps_max_num_reorder_pics
    bw.ue(0)                         # sps_max_latency_increase_plus1
    bw.ue(p.log2_min_cb - 3)         # log2_min_luma_coding_block_size_minus3
    bw.ue(p.log2_ctu - p.log2_min_cb)  # log2_diff_max_min_luma_cb_size
    bw.ue(0)                         # log2_min_luma_transform_block_size_minus2
    bw.ue(3)                         # log2_diff_max_min_transform (4..32)
    bw.ue(0)                         # max_transform_hierarchy_depth_inter
    bw.ue(0)                         # max_transform_hierarchy_depth_intra
    bw.u(1, 0)                       # scaling_list_enabled_flag
    bw.u(1, 0)                       # amp_enabled_flag
    bw.u(1, 0)                       # sample_adaptive_offset_enabled_flag
    if p.pcm_enabled:
        bw.u(1, 1)                   # pcm_enabled_flag
        bw.u(4, 7)                   # pcm_sample_bit_depth_luma_minus1
        bw.u(4, 7)                   # pcm_sample_bit_depth_chroma_minus1
        bw.ue(p.log2_min_pcm - 3)    # log2_min_pcm_luma_cb_size_minus3
        bw.ue(0)                     # log2_diff_max_min_pcm_luma_cb_size
        bw.u(1, 1)                   # pcm_loop_filter_disabled_flag
    else:
        bw.u(1, 0)
    bw.ue(0)                         # num_short_term_ref_pic_sets
    bw.u(1, 0)                       # long_term_ref_pics_present_flag
    bw.u(1, 0)                       # sps_temporal_mvp_enabled_flag
    bw.u(1, 0)                       # strong_intra_smoothing_enabled_flag
    bw.u(1, 0)                       # vui_parameters_present_flag
    bw.u(1, 0)                       # sps_extension_present_flag
    bw.rbsp_trailing_bits()
    return hevc_nal(NAL_SPS, bw.to_bytes())


def write_pps(p: HevcParams) -> bytes:
    bw = BitWriter()
    bw.ue(0)                         # pps_pic_parameter_set_id
    bw.ue(0)                         # pps_seq_parameter_set_id
    bw.u(1, 0)                       # dependent_slice_segments_enabled_flag
    bw.u(1, 0)                       # output_flag_present_flag
    bw.u(3, 0)                       # num_extra_slice_header_bits
    bw.u(1, 0)                       # sign_data_hiding_enabled_flag
    bw.u(1, 0)                       # cabac_init_present_flag
    bw.ue(0)                         # num_ref_idx_l0_default_active_minus1
    bw.ue(0)                         # num_ref_idx_l1_default_active_minus1
    bw.se(p.qp - 26)                 # init_qp_minus26
    bw.u(1, 0)                       # constrained_intra_pred_flag
    bw.u(1, 0)                       # transform_skip_enabled_flag
    bw.u(1, 0)                       # cu_qp_delta_enabled_flag
    bw.se(0)                         # pps_cb_qp_offset
    bw.se(0)                         # pps_cr_qp_offset
    bw.u(1, 0)                       # pps_slice_chroma_qp_offsets_present
    bw.u(1, 0)                       # weighted_pred_flag
    bw.u(1, 0)                       # weighted_bipred_flag
    bw.u(1, 0)                       # transquant_bypass_enabled_flag
    bw.u(1, 0)                       # tiles_enabled_flag
    bw.u(1, 0)                       # entropy_coding_sync_enabled_flag
    bw.u(1, 1)                       # pps_loop_filter_across_slices_enabled
    bw.u(1, 1)                       # deblocking_filter_control_present
    bw.u(1, 0)                       # deblocking_filter_override_enabled
    bw.u(1, 0)                       # pps_deblocking_filter_disabled_flag
    bw.se(0)                         # pps_beta_offset_div2
    bw.se(0)                         # pps_tc_offset_div2
    bw.u(1, 0)                       # pps_scaling_list_data_present_flag
    bw.u(1, 0)                       # lists_modification_present_flag
    bw.ue(0)                         # log2_parallel_merge_level_minus2
    bw.u(1, 0)                       # slice_segment_header_extension_present
    bw.u(1, 0)                       # pps_extension_present_flag
    bw.rbsp_trailing_bits()
    return hevc_nal(NAL_PPS, bw.to_bytes())


def _skip_ptl(br) -> int:
    br.u(2); br.u(1); br.u(5)
    br.u(32); br.u(1); br.u(1); br.u(1); br.u(1)
    br.u(32); br.u(12)
    return br.u(8)                   # general_level_idc


def parse_sps(rbsp: bytes) -> HevcParams:
    """Parse an SPS written by ``write_sps`` into HevcParams (the fields
    this engine varies; fixed fields are validated implicitly by the
    closed-loop decode)."""
    from ...utils.bitstream import BitReader
    br = BitReader(rbsp)
    br.u(4); br.u(3); br.u(1)
    level = _skip_ptl(br)
    br.ue()                          # sps id
    br.ue()                          # chroma_format_idc
    width = br.ue()
    height = br.ue()
    cw_right = cw_bottom = 0
    if br.u(1):                      # conformance_window_flag
        br.ue()
        cw_right = br.ue() * 2
        br.ue()
        cw_bottom = br.ue() * 2
    br.ue(); br.ue()                 # bit depths
    br.ue()                          # log2_max_poc_lsb_minus4
    br.u(1)                          # sub_layer_ordering_info_present
    br.ue(); br.ue(); br.ue()        # dpb sizing
    log2_min_cb = br.ue() + 3
    log2_ctu = log2_min_cb + br.ue()
    return HevcParams(width=width, height=height, level_idc=level,
                      log2_ctu=log2_ctu, log2_min_cb=log2_min_cb,
                      conf_win_right=cw_right, conf_win_bottom=cw_bottom)


def parse_pps_qp(rbsp: bytes) -> int:
    """init_qp from a PPS written by ``write_pps``."""
    from ...utils.bitstream import BitReader
    br = BitReader(rbsp)
    br.ue(); br.ue()
    br.u(1); br.u(1); br.u(3); br.u(1); br.u(1)
    br.ue(); br.ue()
    return 26 + br.se()


def write_slice_header(bw: BitWriter, p: HevcParams, *, is_idr: bool,
                       poc_lsb: int = 0, slice_qp: int | None = None) -> None:
    """Slice segment header (7.3.6.1) up to byte alignment; the CABAC
    payload (slice_segment_data) follows byte-aligned."""
    bw.u(1, 1)                       # first_slice_segment_in_pic_flag
    if is_idr:
        bw.u(1, 0)                   # no_output_of_prior_pics_flag
    bw.ue(0)                         # slice_pic_parameter_set_id
    bw.ue(2 if is_idr else 1)        # slice_type (2 = I, 1 = P)
    if not is_idr:
        bw.u(8, poc_lsb & 0xFF)      # slice_pic_order_cnt_lsb (log2=8)
        bw.u(1, 0)                   # short_term_ref_pic_set_sps_flag
        # st_ref_pic_set(0): one negative (previous) picture, used
        bw.ue(1)                     # num_negative_pics
        bw.ue(0)                     # num_positive_pics
        bw.ue(0)                     # delta_poc_s0_minus1 (POC - 1)
        bw.u(1, 1)                   # used_by_curr_pic_s0_flag
        # (long-term off, temporal MVP off, SAO off in SPS)
        bw.u(1, 0)                   # num_ref_idx_active_override_flag
        # (lists_modification off, cabac_init absent, weighted_pred off)
        bw.ue(4)                     # five_minus_max_num_merge_cand (=1)
    qp = slice_qp if slice_qp is not None else p.qp
    bw.se(qp - p.qp)                 # slice_qp_delta (vs pps init_qp)
    # deblock ON in PPS (no override): with loop_filter_across_slices
    # enabled and the filter active, the slice flag is present
    bw.u(1, 1)                       # slice_loop_filter_across_slices
    bw.u(1, 1)                       # alignment_bit_equal_to_one
    bw.byte_align(0)


def parse_slice_header(br, p: HevcParams, nal_type: int):
    """Parse a slice segment header written by ``write_slice_header``.
    Returns (slice_type, slice_qp, poc_lsb); leaves the reader
    byte-aligned at the start of slice_segment_data."""
    is_idr = nal_type == NAL_IDR_W_RADL
    assert br.u(1) == 1, "only single-slice pictures are produced"
    if is_idr:
        br.u(1)                      # no_output_of_prior_pics_flag
    br.ue()                          # slice_pic_parameter_set_id
    slice_type = br.ue()
    poc_lsb = 0
    if not is_idr:
        poc_lsb = br.u(8)
        br.u(1)                      # short_term_ref_pic_set_sps_flag (0)
        br.ue()                      # num_negative_pics
        br.ue()                      # num_positive_pics
        br.ue()                      # delta_poc_s0_minus1
        br.u(1)                      # used_by_curr_pic_s0_flag
        br.u(1)                      # num_ref_idx_active_override_flag
        br.ue()                      # five_minus_max_num_merge_cand
    slice_qp = p.qp + br.se()
    br.u(1)                          # slice_loop_filter_across_slices
    br.u(1)                          # alignment bit
    br.byte_align()
    return slice_type, slice_qp, poc_lsb
