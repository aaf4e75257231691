// CAVLC slice writers and NAL emulation prevention (host code).
//
// Copy of vcp_tpu/native/entropy.cpp: the CAVLC residual coder, the I
// slice writer (I16x16 MBs, row pattern or per-MB modes) and the P slice
// writer (P_L0_16x16 + P_Skip MBs, with the mask of MBs carried by a
// sparse chunk). The VLC tables in tables_gen.h are generated from the
// port's codec/h264/tables.py at build time (native/build.py).
//
// C ABI, loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#include "tables_gen.h"

namespace {

struct BitWriter {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    int nbits = 0;

    void u(int n, uint32_t value) {
        acc = (acc << n) | (uint64_t)value;
        nbits += n;
        while (nbits >= 8) {
            nbits -= 8;
            buf.push_back((uint8_t)((acc >> nbits) & 0xFF));
        }
        acc &= (nbits ? ((1ULL << nbits) - 1) : 0);
    }
    void code(VLC c) { u(c.len, c.bits); }
    void ue(uint32_t v) {
        uint32_t k = v + 1;
        int n = 32 - __builtin_clz(k);
        u(2 * n - 1, k);
    }
    void se(int32_t v) { ue(v > 0 ? 2 * (uint32_t)v - 1 : (uint32_t)(-2 * (int64_t)v)); }
    void byte_align0() { while (nbits % 8) u(1, 0); }
    void rbsp_trailing() { u(1, 1); byte_align0(); }
    void raw_bytes(const uint8_t* p, int n) {
        // requires alignment
        for (int i = 0; i < n; i++) buf.push_back(p[i]);
    }
};

// --- CAVLC residual block ---------------------------------------------------

// returns TotalCoeff
int encode_residual(BitWriter& bw, const int32_t* c, int n, int nc) {
    int idx[16], lev[16], total = 0;
    for (int i = 0; i < n; i++) {
        if (c[i]) { idx[total] = i; lev[total] = c[i]; total++; }
    }
    int t1 = 0;
    for (int i = total - 1; i >= 0 && t1 < 3; i--) {
        if (lev[i] == 1 || lev[i] == -1) t1++;
        else break;
    }
    // coeff_token
    if (nc == -1) bw.code(CT_CHROMA[total][t1]);
    else if (nc < 2) bw.code(CT_NC0[total][t1]);
    else if (nc < 4) bw.code(CT_NC2[total][t1]);
    else if (nc < 8) bw.code(CT_NC4[total][t1]);
    else {
        if (total == 0) bw.u(6, 3);
        else bw.u(6, (uint32_t)(((total - 1) << 2) | t1));
    }
    if (total == 0) return 0;

    for (int i = total - 1; i >= total - t1; i--) bw.u(1, lev[i] < 0 ? 1 : 0);

    int suffix_len = (total > 10 && t1 < 3) ? 1 : 0;
    bool first = true;
    for (int i = total - t1 - 1; i >= 0; i--) {
        int l = lev[i];
        int level_code = l > 0 ? 2 * l - 2 : -2 * l - 1;
        if (first && t1 < 3) level_code -= 2;
        first = false;
        if (suffix_len == 0) {
            if (level_code < 14) bw.u(level_code + 1, 1);
            else if (level_code < 30) { bw.u(15, 1); bw.u(4, level_code - 14); }
            else { bw.u(16, 1); bw.u(12, level_code - 30); }
        } else {
            int prefix = level_code >> suffix_len;
            if (prefix < 15) {
                bw.u(prefix + 1, 1);
                bw.u(suffix_len, level_code & ((1 << suffix_len) - 1));
            } else {
                bw.u(16, 1);
                bw.u(12, level_code - (15 << suffix_len));
            }
        }
        if (suffix_len == 0) suffix_len = 1;
        int al = l < 0 ? -l : l;
        if (al > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }

    int last = idx[total - 1];
    int total_zeros = last + 1 - total;
    if (total < n) {
        if (nc == -1) bw.code(TZ_CHROMA[total][total_zeros]);
        else bw.code(TZ_4x4[total][total_zeros]);
    }
    int zeros_left = total_zeros;
    for (int i = total - 1; i >= 1 && zeros_left > 0; i--) {
        int run = idx[i] - idx[i - 1] - 1;
        int zl = zeros_left < 7 ? zeros_left : 7;
        bw.code(RUN_BEFORE[zl][run]);
        zeros_left -= run;
    }
    return total;
}

// --- nC context --------------------------------------------------------------

struct Nz {
    std::vector<int16_t> v;
    int w;
    Nz(int h, int w_) : v((size_t)h * w_, -1), w(w_) {}
    int16_t& at(int y, int x) { return v[(size_t)y * w + x]; }
    int nc(int y, int x) {
        int na = x > 0 ? v[(size_t)y * w + x - 1] : -1;
        int nb = y > 0 ? v[(size_t)(y - 1) * w + x] : -1;
        if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
        if (na >= 0) return na;
        if (nb >= 0) return nb;
        return 0;
    }
};

// Luma 4x4 block coding order → (y, x) offsets in 4-pel units.
const int BLK_Y[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};
const int BLK_X[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
const int CBLK_Y[4] = {0,0,1,1};
const int CBLK_X[4] = {0,1,0,1};

void slice_header(BitWriter& bw, bool is_idr, int frame_num_bits,
                  int frame_num, int idr_pic_id, int qp, int init_qp,
                  int deblock_idc, int poc_bits = 0, int poc_lsb = 0) {
    bw.ue(0);                              // first_mb_in_slice
    bw.ue(is_idr ? 7 : 5);                 // slice_type (I-all / P-all)
    bw.ue(0);                              // pps id
    bw.u(frame_num_bits, (uint32_t)(frame_num & ((1 << frame_num_bits) - 1)));
    if (is_idr) bw.ue((uint32_t)idr_pic_id);
    if (poc_bits > 0)                      // pic_order_cnt_lsb (poc_type 0)
        bw.u(poc_bits, (uint32_t)(poc_lsb & ((1 << poc_bits) - 1)));
    if (!is_idr) { bw.u(1, 0); bw.u(1, 0); }  // no override, no reordering
    if (is_idr) { bw.u(1, 0); bw.u(1, 0); }
    else bw.u(1, 0);                       // adaptive_ref_pic_marking
    bw.se(qp - init_qp);                   // slice_qp_delta
    bw.ue((uint32_t)deblock_idc);          // disable_deblocking_filter_idc
    if (deblock_idc != 1) { bw.se(0); bw.se(0); }  // alpha/beta offsets
}

void chroma_residual(BitWriter& bw, int cbp_chroma, int mbx, int mby,
                     const int32_t* cb_dc, const int32_t* cr_dc,
                     const int32_t* cb_ac, const int32_t* cr_ac,
                     Nz& nz_cb, Nz& nz_cr) {
    if (cbp_chroma) {
        encode_residual(bw, cb_dc, 4, -1);
        encode_residual(bw, cr_dc, 4, -1);
    }
    const int32_t* acs[2] = {cb_ac, cr_ac};
    Nz* nzs[2] = {&nz_cb, &nz_cr};
    for (int c = 0; c < 2; c++) {
        for (int blk = 0; blk < 4; blk++) {
            int by = 2 * mby + CBLK_Y[blk], bx = 2 * mbx + CBLK_X[blk];
            int total = 0;
            if (cbp_chroma == 2) {
                total = encode_residual(bw, acs[c] + blk * 16 + 1, 15,
                                        nzs[c]->nc(by, bx));
            }
            nzs[c]->at(by, bx) = (int16_t)total;
        }
    }
}

}  // namespace

extern "C" {

// RBSP → EBSP emulation prevention. Returns output length.
int64_t vcp_escape(const uint8_t* in, int64_t n, uint8_t* out) {
    int64_t o = 0;
    int zeros = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = in[i];
        if (zeros >= 2 && b <= 3) { out[o++] = 3; zeros = 0; }
        out[o++] = b;
        zeros = (b == 0) ? zeros + 1 : 0;
    }
    return o;
}

// I slice of I16x16 MBs: without ``modes`` MB row 0 = Intra16x16 DC
// (chroma DC), rows 1.. = Intra16x16 Vertical (chroma V); with ``modes``
// / ``cmodes`` each MB's own. Level arrays are the device outputs for
// ALL rows (see frame_ops.py). Every MB is I16x16 (no I_PCM), so the
// writer takes no source planes. Returns the RBSP length written into
// out, or -1 if out_cap is too small.
int64_t vcp_write_islice(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int idr_pic_id, int deblock_idc,
    int poc_bits, int poc_lsb,
    const int32_t* luma_dc,    // (n_mby, n_mbx, 16)
    const int32_t* luma_ac,    // (n_mby, n_mbx, 16, 16)
    const int32_t* cb_dc,      // (n_mby, n_mbx, 4)
    const int32_t* cb_ac,      // (n_mby, n_mbx, 4, 16)
    const int32_t* cr_dc, const int32_t* cr_ac,
    const int32_t* modes,      // per-MB I16 pred mode (RD intra), or NULL
    const int32_t* cmodes,     // per-MB chroma pred mode, or NULL
    uint8_t* out, int64_t out_cap) {
    BitWriter bw;
    bw.buf.reserve((size_t)n_mby * n_mbx * 64);
    slice_header(bw, true, frame_num_bits, frame_num, idr_pic_id, qp,
                 init_qp, deblock_idc, poc_bits, poc_lsb);

    Nz nz_y(4 * n_mby, 4 * n_mbx), nz_cb(2 * n_mby, 2 * n_mbx),
        nz_cr(2 * n_mby, 2 * n_mbx);

    for (int mby = 0; mby < n_mby; mby++) {
        // row 0 has no top neighbors: DC modes; rows 1..: Vertical
        int pred_mode = (mby == 0) ? 2 : 0;
        int chroma_mode = (mby == 0) ? 0 : 2;
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mb = (size_t)mby * n_mbx + mbx;
            if (modes) { pred_mode = modes[mb]; chroma_mode = cmodes[mb]; }
            const int32_t* zdc = luma_dc + mb * 16;
            const int32_t* zac = luma_ac + mb * 256;
            const int32_t* cdc[2] = {cb_dc + mb * 4, cr_dc + mb * 4};
            const int32_t* cac[2] = {cb_ac + mb * 64, cr_ac + mb * 64};

            bool cbp_luma15 = false;
            for (int blk = 0; blk < 16 && !cbp_luma15; blk++)
                for (int k = 1; k < 16; k++)
                    if (zac[blk * 16 + k]) { cbp_luma15 = true; break; }
            bool any_cac = false, any_cdc = false;
            for (int c = 0; c < 2; c++) {
                for (int k = 0; k < 4; k++) if (cdc[c][k]) any_cdc = true;
                for (int blk = 0; blk < 4; blk++)
                    for (int k = 1; k < 16; k++)
                        if (cac[c][blk * 16 + k]) any_cac = true;
            }
            int cbp_chroma = any_cac ? 2 : (any_cdc ? 1 : 0);
            int mb_type =
                1 + pred_mode + 4 * cbp_chroma + 12 * (cbp_luma15 ? 1 : 0);
            bw.ue((uint32_t)mb_type);
            bw.ue((uint32_t)chroma_mode);   // intra_chroma_pred_mode
            bw.se(0);   // mb_qp_delta

            // Intra16x16DCLevel
            encode_residual(bw, zdc, 16, nz_y.nc(4 * mby, 4 * mbx));
            for (int blk = 0; blk < 16; blk++) {
                int by = 4 * mby + BLK_Y[blk], bx = 4 * mbx + BLK_X[blk];
                int total = 0;
                if (cbp_luma15)
                    total = encode_residual(bw, zac + blk * 16 + 1, 15,
                                            nz_y.nc(by, bx));
                nz_y.at(by, bx) = (int16_t)total;
            }
            chroma_residual(bw, cbp_chroma, mbx, mby, cdc[0], cdc[1],
                            cac[0], cac[1], nz_cb, nz_cr);
        }
    }
    bw.rbsp_trailing();
    if ((int64_t)bw.buf.size() > out_cap) return -1;
    std::memcpy(out, bw.buf.data(), bw.buf.size());
    return (int64_t)bw.buf.size();
}

// --- P slice -----------------------------------------------------------------

static void mv_neighbors(const int32_t* mv, const uint8_t* valid,
                         int n_mbx, int mbx, int mby,
                         int a[2], int& ra, int b[2], int& rb,
                         int c[2], int& rc) {
    auto get = [&](int x, int y, int m[2]) -> int {
        if (x < 0 || y < 0 || x >= n_mbx) { m[0] = m[1] = 0; return -1; }
        if (!valid[(size_t)y * n_mbx + x]) { m[0] = m[1] = 0; return -1; }
        m[0] = mv[((size_t)y * n_mbx + x) * 2 + 0];   // x component
        m[1] = mv[((size_t)y * n_mbx + x) * 2 + 1];   // y component
        return 0;
    };
    ra = get(mbx - 1, mby, a);
    rb = get(mbx, mby - 1, b);
    bool c_exists = (mby > 0) && (mbx + 1 < n_mbx);
    if (c_exists) rc = get(mbx + 1, mby - 1, c);
    else { c[0] = c[1] = 0; rc = -1; }
    if (rc < 0) {
        int d[2]; int rd = get(mbx - 1, mby - 1, d);
        c[0] = d[0]; c[1] = d[1]; rc = rd;
    }
}

static void mv_pred_c(const int32_t* mv, const uint8_t* valid, int n_mbx,
                      int mbx, int mby, int out[2]) {
    int a[2], b[2], c[2], ra, rb, rc;
    mv_neighbors(mv, valid, n_mbx, mbx, mby, a, ra, b, rb, c, rc);
    bool b_exists = (mby > 0) && rb >= 0;
    if (!b_exists && rc < 0 && ra >= 0) { out[0] = a[0]; out[1] = a[1]; return; }
    int hits = (ra == 0) + (rb == 0) + (rc == 0);
    if (hits == 1) {
        const int* m = (ra == 0) ? a : (rb == 0 ? b : c);
        out[0] = m[0]; out[1] = m[1]; return;
    }
    for (int k = 0; k < 2; k++) {
        int x = a[k], y = b[k], z = c[k];
        int mx = x > y ? x : y;
        int mn = x < y ? x : y;
        out[k] = z > mx ? mx : (z < mn ? mn : z);
    }
}

static void skip_mv_c(const int32_t* mv, const uint8_t* valid, int n_mbx,
                      int mbx, int mby, int out[2]) {
    out[0] = out[1] = 0;
    if (mbx - 1 < 0 || mby - 1 < 0) return;
    int a[2], b[2], c[2], ra, rb, rc;
    mv_neighbors(mv, valid, n_mbx, mbx, mby, a, ra, b, rb, c, rc);
    if (ra < 0 || rb < 0) return;
    if ((ra == 0 && a[0] == 0 && a[1] == 0) ||
        (rb == 0 && b[0] == 0 && b[1] == 0)) return;
    mv_pred_c(mv, valid, n_mbx, mbx, mby, out);
}

// mv layout: (n_mby, n_mbx, 2) [x, y] QUARTER-PEL. ``active`` may be
// null (all MBs carried in the dense arrays) or a per-MB mask: inactive
// MBs are sparse-fetch skips whose P_Skip MV this writer re-derives
// (the device classified them with the identical spec 8.4.1.1 rule,
// codec/h264/gop_ops.skip_mv_grid).
int64_t vcp_write_pslice(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int deblock_idc, int poc_bits, int poc_lsb,
    const uint8_t* active,
    const int32_t* mv_xy,
    const int32_t* luma,       // (n_mby, n_mbx, 16, 16)
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    uint8_t* out, int64_t out_cap) {
    BitWriter bw;
    bw.buf.reserve((size_t)n_mby * n_mbx * 32);
    slice_header(bw, false, frame_num_bits, frame_num, 0, qp, init_qp,
                 deblock_idc, poc_bits, poc_lsb);

    Nz nz_y(4 * n_mby, 4 * n_mbx), nz_cb(2 * n_mby, 2 * n_mbx),
        nz_cr(2 * n_mby, 2 * n_mbx);
    std::vector<uint8_t> valid((size_t)n_mby * n_mbx, 1);
    // mutable MV grid: inactive MBs get their derived skip MV written
    // back so later neighbors predict from the real value
    std::vector<int32_t> mvg(mv_xy, mv_xy + (size_t)n_mby * n_mbx * 2);
    int32_t* mvp = mvg.data();

    uint32_t skip_run = 0;
    for (int mby = 0; mby < n_mby; mby++) {
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mb = (size_t)mby * n_mbx + mbx;
            if (active && !active[mb]) {
                int smv[2];
                skip_mv_c(mvp, valid.data(), n_mbx, mbx, mby, smv);
                mvp[mb * 2 + 0] = smv[0];
                mvp[mb * 2 + 1] = smv[1];
                skip_run++;
                for (int i = 0; i < 4; i++)
                    for (int j = 0; j < 4; j++)
                        nz_y.at(4 * mby + i, 4 * mbx + j) = 0;
                for (int i = 0; i < 2; i++)
                    for (int j = 0; j < 2; j++) {
                        nz_cb.at(2 * mby + i, 2 * mbx + j) = 0;
                        nz_cr.at(2 * mby + i, 2 * mbx + j) = 0;
                    }
                continue;
            }
            const int32_t* zl = luma + mb * 256;
            const int32_t* cdc[2] = {cb_dc + mb * 4, cr_dc + mb * 4};
            const int32_t* cac[2] = {cb_ac + mb * 64, cr_ac + mb * 64};

            int cbp_luma = 0;
            for (int blk = 0; blk < 16; blk++) {
                for (int k = 0; k < 16; k++)
                    if (zl[blk * 16 + k]) { cbp_luma |= 1 << (blk / 4); break; }
            }
            bool any_cac = false, any_cdc = false;
            for (int c = 0; c < 2; c++) {
                for (int k = 0; k < 4; k++) if (cdc[c][k]) any_cdc = true;
                for (int blk = 0; blk < 4; blk++)
                    for (int k = 1; k < 16; k++)
                        if (cac[c][blk * 16 + k]) any_cac = true;
            }
            int cbp_chroma = any_cac ? 2 : (any_cdc ? 1 : 0);
            int cbp = cbp_luma | (cbp_chroma << 4);

            int m[2] = {mvp[mb * 2 + 0], mvp[mb * 2 + 1]};
            int smv[2];
            skip_mv_c(mvp, valid.data(), n_mbx, mbx, mby, smv);
            if (cbp == 0 && m[0] == smv[0] && m[1] == smv[1]) {
                skip_run++;
                for (int i = 0; i < 4; i++)
                    for (int j = 0; j < 4; j++)
                        nz_y.at(4 * mby + i, 4 * mbx + j) = 0;
                for (int i = 0; i < 2; i++)
                    for (int j = 0; j < 2; j++) {
                        nz_cb.at(2 * mby + i, 2 * mbx + j) = 0;
                        nz_cr.at(2 * mby + i, 2 * mbx + j) = 0;
                    }
                continue;
            }
            bw.ue(skip_run);
            skip_run = 0;
            int pred[2];
            mv_pred_c(mvp, valid.data(), n_mbx, mbx, mby, pred);
            bw.ue(0);                       // mb_type P_L0_16x16
            bw.se(m[0] - pred[0]);          // mvd (mv already 1/4-pel)
            bw.se(m[1] - pred[1]);
            bw.ue(CBP_INTER_CODE[cbp]);
            if (cbp) bw.se(0);              // mb_qp_delta

            for (int blk = 0; blk < 16; blk++) {
                int by = 4 * mby + BLK_Y[blk], bx = 4 * mbx + BLK_X[blk];
                int total = 0;
                if (cbp_luma & (1 << (blk / 4)))
                    total = encode_residual(bw, zl + blk * 16, 16,
                                            nz_y.nc(by, bx));
                nz_y.at(by, bx) = (int16_t)total;
            }
            chroma_residual(bw, cbp_chroma, mbx, mby, cdc[0], cdc[1],
                            cac[0], cac[1], nz_cb, nz_cr);
        }
    }
    if (skip_run) bw.ue(skip_run);
    bw.rbsp_trailing();
    if ((int64_t)bw.buf.size() > out_cap) return -1;
    std::memcpy(out, bw.buf.data(), bw.buf.size());
    return (int64_t)bw.buf.size();
}

}  // extern "C"
