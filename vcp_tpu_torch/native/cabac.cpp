// CABAC slice entropy engine (host).
//
// Copy of the engine and of the CABAC slice writers of
// vcp_tpu/native/cabac.cpp (spec 9.3): I slices of I16x16 MBs, I slices
// that mix I16x16 with I_NxN / transform-8x8 MBs, P slices of
// P_L0_16x16 + P_Skip MBs without and with the High-profile
// transform_size_8x8 flag, partitioned P slices (16x16 / 16x8 / 8x16 /
// P_8x8), partitioned P slices with intra MBs, and B slices (B_Skip /
// B_Direct_16x16 / B_L0 / B_L1 / B_Bi_16x16, spatial direct),
// bit-identical to vcp_tpu's writers. Host code, not a device kernel.
//
// C ABI, loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#include "tables_gen.h"   // CABAC context init (m, n) pairs

namespace {

// ---------------------------------------------------------------------------
// Arithmetic core (spec 9.3.4) — mirrors codec/cabac.py
// ---------------------------------------------------------------------------

// Table 9-44: rangeTabLPS[pStateIdx][qRangeIdx].
const uint8_t RANGE_TAB_LPS[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150}, {85, 104, 123, 142}, {81, 99, 117, 135},
    {77, 94, 111, 128}, {73, 89, 105, 122}, {69, 85, 100, 116},
    {66, 80, 95, 110}, {62, 76, 90, 104}, {59, 72, 86, 99},
    {56, 69, 81, 94}, {53, 65, 77, 89}, {51, 62, 73, 85},
    {48, 59, 69, 80}, {46, 56, 66, 76}, {43, 53, 63, 72},
    {41, 50, 59, 69}, {39, 48, 56, 65}, {37, 45, 54, 62},
    {35, 43, 51, 59}, {33, 41, 48, 56}, {32, 39, 46, 53},
    {30, 37, 43, 50}, {29, 35, 41, 48}, {27, 33, 39, 45},
    {26, 31, 37, 43}, {24, 30, 35, 41}, {23, 28, 33, 39},
    {22, 27, 32, 37}, {21, 26, 30, 35}, {20, 24, 29, 33},
    {19, 23, 27, 31}, {18, 22, 26, 30}, {17, 21, 25, 28},
    {16, 20, 23, 27}, {15, 19, 22, 25}, {14, 18, 21, 24},
    {14, 17, 20, 23}, {13, 16, 19, 22}, {12, 15, 18, 21},
    {12, 14, 17, 20}, {11, 14, 16, 19}, {11, 13, 15, 18},
    {10, 12, 15, 17}, {10, 12, 14, 16}, {9, 11, 13, 15},
    {9, 11, 12, 14}, {8, 10, 12, 14}, {8, 9, 11, 13},
    {7, 9, 11, 12}, {7, 9, 10, 12}, {7, 8, 10, 11},
    {6, 8, 9, 11}, {6, 7, 9, 10}, {6, 7, 8, 9},
    {2, 2, 2, 2},
};

// Table 9-45: transIdxLPS.
const uint8_t TRANS_IDX_LPS[64] = {
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
};

struct Ctx {
    uint8_t state;  // 6-bit probability state
    uint8_t mps;
};

struct CabacEnc {
    uint32_t low = 0;
    uint32_t range = 510;
    int bits_outstanding = 0;
    bool first = true;
    std::vector<uint8_t> bits;  // one bit per entry (kept simple: the
                                // bit plumbing is not the hot loop)

    void put(int b) {
        if (first) first = false;  // spec: the very first PutBit is discarded
        else bits.push_back((uint8_t)b);
        int nb = 1 - b;
        while (bits_outstanding > 0) {
            bits.push_back((uint8_t)nb);
            bits_outstanding--;
        }
    }
    void renorm() {
        while (range < 256) {
            if (low < 256) put(0);
            else if (low >= 512) { low -= 512; put(1); }
            else { low -= 256; bits_outstanding++; }
            range <<= 1;
            low <<= 1;
        }
    }
    void encode(Ctx& c, int binval) {
        uint32_t q = (range >> 6) & 3;
        uint32_t r_lps = RANGE_TAB_LPS[c.state][q];
        range -= r_lps;
        if (binval != c.mps) {
            low += range;
            range = r_lps;
            if (c.state == 0) c.mps ^= 1;
            c.state = TRANS_IDX_LPS[c.state];
        } else {
            if (c.state < 62) c.state++;
        }
        renorm();
    }
    void bypass(int binval) {
        low <<= 1;
        if (binval) low += range;
        if (low >= 1024) { low -= 1024; put(1); }
        else if (low < 512) put(0);
        else { low -= 512; bits_outstanding++; }
    }
    void bypass_bits(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; i--) bypass((v >> i) & 1);
    }
    void terminate(int binval) {
        range -= 2;
        if (binval) {
            low += range;
            range = 2;
            renorm();
            put((low >> 9) & 1);
            bits.push_back((uint8_t)((low >> 8) & 1));
            bits.push_back(1);
        } else {
            renorm();
        }
    }
    // Byte-align with zero padding; append payload bytes to out.
    void flush_to(std::vector<uint8_t>& out) {
        size_t n = bits.size();
        size_t nb = (n + 7) / 8;
        for (size_t i = 0; i < nb; i++) {
            uint32_t byte = 0;
            for (size_t j = 0; j < 8; j++) {
                size_t k = i * 8 + j;
                byte = (byte << 1) | (k < n ? bits[k] : 0);
            }
            out.push_back((uint8_t)byte);
        }
    }
};

// Exp-Golomb-k bypass suffix (cabac_syntax._write_egk).
void write_egk(CabacEnc& e, uint32_t v, int k) {
    while (v >= (1u << k)) {
        e.bypass(1);
        v -= 1u << k;
        k++;
    }
    e.bypass(0);
    if (k) e.bypass_bits(v, k);
}

// ---------------------------------------------------------------------------
// Header bit writer (plain Exp-Golomb, before the CABAC payload)
// ---------------------------------------------------------------------------

struct HdrWriter {
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
    void ue(uint32_t v) {
        uint32_t k = v + 1;
        int n = 32 - __builtin_clz(k);
        u(2 * n - 1, k);
    }
    void se(int32_t v) {
        ue(v > 0 ? 2 * (uint32_t)v - 1 : (uint32_t)(-2 * (int64_t)v));
    }
    void align_ones() { while (nbits % 8) u(1, 1); }  // cabac_alignment_one_bit
};

// Slice header for CABAC slices (headers.write_slice_header: for P slices
// cabac_init_idc=0 precedes slice_qp_delta).
void cabac_slice_header(HdrWriter& bw, bool is_idr, int frame_num_bits,
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
    if (is_idr) { bw.u(1, 0); bw.u(1, 0); }   // IDR dec_ref_pic_marking
    else bw.u(1, 0);                          // adaptive_ref_pic_marking
    if (!is_idr) bw.ue(0);                    // cabac_init_idc
    bw.se(qp - init_qp);                      // slice_qp_delta
    bw.ue((uint32_t)deblock_idc);             // disable_deblocking_filter_idc
    if (deblock_idc != 1) { bw.se(0); bw.se(0); }
}

// ---------------------------------------------------------------------------
// Contexts + per-slice neighbor state — mirrors H264CabacContexts/MbState
// ---------------------------------------------------------------------------

// Residual block categories (ctxBlockCat).
enum { CAT_I16_DC = 0, CAT_I16_AC, CAT_LUMA4, CAT_CHROMA_DC, CAT_CHROMA_AC };

// ctxBlockCat 5 (LumaLevel8x8): Table 9-43 sig/last ctxIdxInc per scan
// position (frame-coded) — mirrors cabac_syntax._SIG8_MAP/_LAST8_MAP.
const uint8_t SIG8_MAP[63] = {
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12};
const uint8_t LAST8_MAP[63] = {
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8};

// All slice contexts, spec-initialized (9.3.1.1, Tables 9-12..9-33 via
// tables_gen.h; cabac_init_idc=0 for P slices) in a global ctxIdx pool.
// Named slots are POINTERS into the pool so spec context sharing (e.g.
// both Intra16x16 pred-mode bins -> one ctxIdx) aliases naturally —
// mirrors cabac_syntax._ctx_index_map exactly.
struct H264Ctxs {
    Ctx g[VCP_N_CTX];
    Ctx *mbt_i[3], *mbt_i_tail[5], *mbt_p[3], *skip[3], *chroma_mode[4];
    Ctx *qp_delta[1], *cbp_l[4], *cbp_c[8];
    Ctx *mvd[2][7];                      // [comp][ctx]
    Ctx *cbf[5][4], *sig[5][15], *last[5][15], *absl[5][10];
    Ctx *sig8[15], *last8[9], *abs8[10], *t8flag[3];  // cat 5 (8x8)

    H264Ctxs(int slice_qp, bool pslice) {
        const int8_t (*tab)[2] = pslice ? CTX_INIT_P0 : CTX_INIT_I;
        int qp = slice_qp < 0 ? 0 : (slice_qp > 51 ? 51 : slice_qp);
        for (int i = 0; i < VCP_N_CTX; i++) {
            int pre = ((tab[i][0] * qp) >> 4) + tab[i][1];
            pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
            if (pre <= 63) g[i] = Ctx{(uint8_t)(63 - pre), 0};
            else g[i] = Ctx{(uint8_t)(pre - 64), 1};
        }
        const int mbti_p[3] = {17, 17, 17}, mbti_i[3] = {3, 4, 5};
        const int tail_p[5] = {18, 19, 19, 20, 20};
        const int tail_i[5] = {6, 7, 8, 9, 10};
        for (int i = 0; i < 3; i++) {
            mbt_i[i] = &g[(pslice ? mbti_p : mbti_i)[i]];
            mbt_p[i] = &g[14 + i];
            skip[i] = &g[11 + i];
        }
        for (int i = 0; i < 5; i++)
            mbt_i_tail[i] = &g[(pslice ? tail_p : tail_i)[i]];
        for (int i = 0; i < 4; i++) chroma_mode[i] = &g[64 + i];
        qp_delta[0] = &g[60];
        for (int i = 0; i < 4; i++) cbp_l[i] = &g[73 + i];
        for (int i = 0; i < 8; i++) cbp_c[i] = &g[77 + i];
        for (int i = 0; i < 7; i++) {
            mvd[0][i] = &g[40 + i];
            mvd[1][i] = &g[47 + i];
        }
        const int SIG_OFF[5] = {0, 15, 29, 44, 47};
        const int ABS_OFF[5] = {0, 10, 20, 30, 39};
        for (int c = 0; c < 5; c++) {
            for (int j = 0; j < 4; j++) cbf[c][j] = &g[85 + 4 * c + j];
            for (int j = 0; j < 15; j++) {
                sig[c][j] = &g[105 + SIG_OFF[c] + j];
                last[c][j] = &g[166 + SIG_OFF[c] + j];
            }
            for (int j = 0; j < 10; j++)
                absl[c][j] = &g[227 + ABS_OFF[c] + j];
        }
        for (int j = 0; j < 15; j++) sig8[j] = &g[402 + j];
        for (int j = 0; j < 9; j++) last8[j] = &g[417 + j];
        for (int j = 0; j < 10; j++) abs8[j] = &g[426 + j];
        for (int j = 0; j < 3; j++) t8flag[j] = &g[399 + j];
        // B-slice slots (cabac_syntax._ctx_index_map "B"): skip 24..26,
        // mb_type bin0 27..29, fixed tail bins 30..32
        for (int i = 0; i < 3; i++) {
            skip_b[i] = &g[24 + i];
            mbt_b[i] = &g[27 + i];
            mbt_b_fix[i] = &g[30 + i];
        }
    }
    Ctx *skip_b[3], *mbt_b[3], *mbt_b_fix[3];
};

// Luma 4x4 coding order → (y, x) offsets (frame_ops.LUMA_BLK_ORDER).
const int BLK_Y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
const int BLK_X[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const int CBLK_Y[4] = {0, 0, 1, 1};
const int CBLK_X[4] = {0, 1, 0, 1};

struct MbState {
    int n_mby, n_mbx;
    std::vector<uint8_t> avail, skip, intra, t8, i_nxn;
    std::vector<int32_t> chroma_mode, cbp_luma8, cbp_chroma;
    std::vector<int32_t> absmvd;     // (n_mby, n_mbx, 2)
    std::vector<int8_t> cbf_l4;      // (4*n_mby, 4*n_mbx)
    std::vector<int8_t> cbf_i16dc;   // (n_mby, n_mbx)
    std::vector<int8_t> cbf_cdc;     // (2, n_mby, n_mbx)
    std::vector<int8_t> cbf_c4;      // (2, 2*n_mby, 2*n_mbx)

    MbState(int h, int w)
        : n_mby(h), n_mbx(w),
          avail((size_t)h * w, 0), skip((size_t)h * w, 0),
          intra((size_t)h * w, 0), t8((size_t)h * w, 0),
          i_nxn((size_t)h * w, 0),
          chroma_mode((size_t)h * w, 0),
          cbp_luma8((size_t)4 * h * w, 0), cbp_chroma((size_t)h * w, 0),
          absmvd((size_t)2 * h * w, 0),
          cbf_l4((size_t)16 * h * w, 0), cbf_i16dc((size_t)h * w, 0),
          cbf_cdc((size_t)2 * h * w, 0), cbf_c4((size_t)8 * h * w, 0) {}

    size_t mb(int mbx, int mby) const { return (size_t)mby * n_mbx + mbx; }

    int mbt_i_ctx(int mbx, int mby) const {
        // condTerm counts intra neighbors that are NOT I_NxN
        // (cabac_syntax.MbState.mbt_i_ctx)
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  intra[mb(mbx - 1, mby)] &&
                  !i_nxn[mb(mbx - 1, mby)]) ? 1 : 0;
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  intra[mb(mbx, mby - 1)] &&
                  !i_nxn[mb(mbx, mby - 1)]) ? 1 : 0;
        return ca + cb;
    }
    int skip_ctx(int mbx, int mby) const {
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  !skip[mb(mbx - 1, mby)]) ? 1 : 0;
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  !skip[mb(mbx, mby - 1)]) ? 1 : 0;
        return ca + cb;
    }
    int chroma_mode_ctx(int mbx, int mby) const {
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  chroma_mode[mb(mbx - 1, mby)] != 0) ? 1 : 0;
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  chroma_mode[mb(mbx, mby - 1)] != 0) ? 1 : 0;
        return ca + cb;
    }
    int cbp_luma_ctx(int mbx, int mby, int b8) const {
        int gy = 2 * mby + b8 / 2, gx = 2 * mbx + b8 % 2;
        int w8 = 2 * n_mbx;
        int ca = (gx > 0 && cbp_luma8[(size_t)gy * w8 + gx - 1] == 0) ? 1 : 0;
        if (gx == 0) ca = 0;
        int cb = (gy > 0 && cbp_luma8[(size_t)(gy - 1) * w8 + gx] == 0) ? 1 : 0;
        if (gy == 0) cb = 0;
        return ca + 2 * cb;
    }
    int cbp_chroma_ctx(int mbx, int mby, int binidx) const {
        bool a = mbx > 0, b = mby > 0;
        if (binidx == 0) {
            int ca = (a && cbp_chroma[mb(mbx - 1, mby)] != 0) ? 1 : 0;
            int cb = (b && cbp_chroma[mb(mbx, mby - 1)] != 0) ? 1 : 0;
            return ca + 2 * cb;
        }
        int ca = (a && cbp_chroma[mb(mbx - 1, mby)] == 2) ? 1 : 0;
        int cb = (b && cbp_chroma[mb(mbx, mby - 1)] == 2) ? 1 : 0;
        return 4 + ca + 2 * cb;
    }
    int t8_ctx(int mbx, int mby) const {
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  t8[mb(mbx - 1, mby)]) ? 1 : 0;
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  t8[mb(mbx, mby - 1)]) ? 1 : 0;
        return ca + cb;
    }
    int mvd_ctx(int mbx, int mby, int comp) const {
        int s = 0;
        if (mbx > 0 && avail[mb(mbx - 1, mby)])
            s += absmvd[2 * mb(mbx - 1, mby) + comp];
        if (mby > 0 && avail[mb(mbx, mby - 1)])
            s += absmvd[2 * mb(mbx, mby - 1) + comp];
        return s < 3 ? 0 : (s <= 32 ? 1 : 2);
    }
    int cbf_ctx(int cat, int mbx, int mby, int blk, bool cur_intra,
                int c) const {
        int miss = cur_intra ? 1 : 0;
        int ca, cb;
        if (cat == CAT_I16_DC) {
            // an AVAILABLE neighbor without an I16 DC block contributes
            // 0 (9.3.3.1.1.9) — the grid is only ever set for I16 MBs,
            // so indexing it covers both; only out-of-picture uses the
            // intra-miss value (mixed P slices hit the difference)
            ca = mbx > 0 ? cbf_i16dc[mb(mbx - 1, mby)] : miss;
            cb = mby > 0 ? cbf_i16dc[mb(mbx, mby - 1)] : miss;
        } else if (cat == CAT_I16_AC || cat == CAT_LUMA4) {
            int gy = 4 * mby + BLK_Y[blk], gx = 4 * mbx + BLK_X[blk];
            int w4 = 4 * n_mbx;
            ca = gx > 0 ? cbf_l4[(size_t)gy * w4 + gx - 1] : miss;
            cb = gy > 0 ? cbf_l4[(size_t)(gy - 1) * w4 + gx] : miss;
        } else if (cat == CAT_CHROMA_DC) {
            ca = mbx > 0 ? cbf_cdc[(size_t)c * n_mby * n_mbx
                                   + mb(mbx - 1, mby)] : miss;
            cb = mby > 0 ? cbf_cdc[(size_t)c * n_mby * n_mbx
                                   + mb(mbx, mby - 1)] : miss;
        } else {  // CAT_CHROMA_AC
            int gy = 2 * mby + CBLK_Y[blk], gx = 2 * mbx + CBLK_X[blk];
            int w2 = 2 * n_mbx;
            size_t base = (size_t)c * 2 * n_mby * w2;
            ca = gx > 0 ? cbf_c4[base + (size_t)gy * w2 + gx - 1] : miss;
            cb = gy > 0 ? cbf_c4[base + (size_t)(gy - 1) * w2 + gx] : miss;
        }
        return ca + 2 * cb;
    }
    void set_cbf(int cat, int mbx, int mby, int blk, int val, int c) {
        if (cat == CAT_I16_DC) {
            cbf_i16dc[mb(mbx, mby)] = (int8_t)val;
        } else if (cat == CAT_I16_AC || cat == CAT_LUMA4) {
            int gy = 4 * mby + BLK_Y[blk], gx = 4 * mbx + BLK_X[blk];
            cbf_l4[(size_t)gy * 4 * n_mbx + gx] = (int8_t)val;
        } else if (cat == CAT_CHROMA_DC) {
            cbf_cdc[(size_t)c * n_mby * n_mbx + mb(mbx, mby)] = (int8_t)val;
        } else {
            int gy = 2 * mby + CBLK_Y[blk], gx = 2 * mbx + CBLK_X[blk];
            cbf_c4[(size_t)c * 2 * n_mby * 2 * n_mbx
                   + (size_t)gy * 2 * n_mbx + gx] = (int8_t)val;
        }
    }
    void set_cbp_luma8(int mbx, int mby, int b8, int bit) {
        cbp_luma8[(size_t)(2 * mby + b8 / 2) * 2 * n_mbx
                  + 2 * mbx + b8 % 2] = bit;
    }
    void fill_cbp_luma8(int mbx, int mby, int v) {
        for (int b8 = 0; b8 < 4; b8++) set_cbp_luma8(mbx, mby, b8, v);
    }
};

// ---------------------------------------------------------------------------
// Residual block (spec 9.3.2.7, frame-coded) — cabac_syntax._encode_block
// ---------------------------------------------------------------------------

void encode_block(CabacEnc& e, H264Ctxs& cx, MbState& st,
                  const int32_t* coeffs, int n, int cat, int mbx, int mby,
                  int blk, bool cur_intra, int c) {
    int nz[16], total = 0;
    for (int i = 0; i < n; i++)
        if (coeffs[i]) nz[total++] = i;
    int cbf = total ? 1 : 0;
    e.encode(*cx.cbf[cat][st.cbf_ctx(cat, mbx, mby, blk, cur_intra, c)], cbf);
    st.set_cbf(cat, mbx, mby, blk, cbf, c);
    if (!cbf) return;
    int last = nz[total - 1];
    for (int i = 0; i < n - 1; i++) {
        int sig = coeffs[i] ? 1 : 0;
        e.encode(*cx.sig[cat][i], sig);
        if (sig) {
            e.encode(*cx.last[cat][i], i == last ? 1 : 0);
            if (i == last) break;
        }
    }
    int neq1 = 0, ngt1 = 0;
    for (int j = total - 1; j >= 0; j--) {
        int i = nz[j];
        int32_t cv = coeffs[i];
        int v = (cv < 0 ? -cv : cv) - 1;
        int ctx0 = ngt1 > 0 ? 0 : (1 + neq1 < 4 ? 1 + neq1 : 4);
        int ctx1 = 5 + (ngt1 < 4 ? ngt1 : 4);
        int prefix = v < 14 ? v : 14;
        for (int b = 0; b < prefix; b++)
            e.encode(*cx.absl[cat][b == 0 ? ctx0 : ctx1], 1);
        if (prefix < 14)
            e.encode(*cx.absl[cat][prefix == 0 ? ctx0 : ctx1], 0);
        else
            write_egk(e, (uint32_t)(v - 14), 0);
        e.bypass(cv < 0 ? 1 : 0);
        if (v == 0) neq1++;
        else ngt1++;
    }
}

// ---------------------------------------------------------------------------
// MB-layer syntax — cabac_syntax._encode_mb_i16 / _encode_mvd_comp / walks
// ---------------------------------------------------------------------------

void encode_mb_i16(CabacEnc& e, H264Ctxs& cx, MbState& st, int mbx, int mby,
                   int pred_mode, int chroma_mode, bool cbp_luma15,
                   int cbp_chroma) {
    int b0 = st.mbt_i_ctx(mbx, mby);
    e.encode(*cx.mbt_i[b0], 1);              // not I_4x4
    e.terminate(0);                          // not I_PCM
    e.encode(*cx.mbt_i_tail[0], cbp_luma15 ? 1 : 0);
    e.encode(*cx.mbt_i_tail[1], cbp_chroma > 0 ? 1 : 0);
    if (cbp_chroma > 0)
        e.encode(*cx.mbt_i_tail[2], cbp_chroma == 2 ? 1 : 0);
    e.encode(*cx.mbt_i_tail[3], (pred_mode >> 1) & 1);
    e.encode(*cx.mbt_i_tail[4], pred_mode & 1);
    int cm_ctx = st.chroma_mode_ctx(mbx, mby);
    if (chroma_mode == 0) {
        e.encode(*cx.chroma_mode[cm_ctx], 0);
    } else {
        e.encode(*cx.chroma_mode[cm_ctx], 1);
        for (int b = 1; b < 3; b++) {
            if (chroma_mode == b) { e.encode(*cx.chroma_mode[3], 0); break; }
            e.encode(*cx.chroma_mode[3], 1);
        }
    }
    st.intra[st.mb(mbx, mby)] = 1;
    st.chroma_mode[st.mb(mbx, mby)] = chroma_mode;
    st.fill_cbp_luma8(mbx, mby, cbp_luma15 ? 1 : 0);
    st.cbp_chroma[st.mb(mbx, mby)] = cbp_chroma;
}

void encode_mvd_comp(CabacEnc& e, H264Ctxs& cx, MbState& st, int mbx,
                     int mby, int comp, int mvd) {
    int v = mvd < 0 ? -mvd : mvd;
    int b0 = st.mvd_ctx(mbx, mby, comp);
    Ctx** row = cx.mvd[comp];
    auto ctx_of = [&](int b) { return b == 0 ? b0 : (2 + b < 6 ? 2 + b : 6); };
    int prefix = v < 9 ? v : 9;
    for (int b = 0; b < prefix; b++) e.encode(*row[ctx_of(b)], 1);
    if (prefix < 9) e.encode(*row[ctx_of(prefix)], 0);
    else write_egk(e, (uint32_t)(v - 9), 3);
    if (v) e.bypass(mvd < 0 ? 1 : 0);
}

// I16x16 residual walk (cabac_syntax._mb_i16_residual, encode side).
void mb_i16_residual(CabacEnc& e, H264Ctxs& cx, MbState& st, int mbx,
                     int mby, bool cbp_luma15, int cbp_chroma,
                     const int32_t* dc_zz, const int32_t* ac,
                     const int32_t* cdc[2], const int32_t* cac[2]) {
    encode_block(e, cx, st, dc_zz, 16, CAT_I16_DC, mbx, mby, 0, true, 0);
    for (int blk = 0; blk < 16; blk++) {
        if (cbp_luma15)
            encode_block(e, cx, st, ac + blk * 16 + 1, 15, CAT_I16_AC,
                         mbx, mby, blk, true, 0);
        else
            st.set_cbf(CAT_I16_AC, mbx, mby, blk, 0, 0);
    }
    if (cbp_chroma) {
        for (int c = 0; c < 2; c++)
            encode_block(e, cx, st, cdc[c], 4, CAT_CHROMA_DC, mbx, mby, 0,
                         true, c);
    } else {
        for (int c = 0; c < 2; c++)
            st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c);
    }
    for (int c = 0; c < 2; c++) {
        for (int blk = 0; blk < 4; blk++) {
            if (cbp_chroma == 2)
                encode_block(e, cx, st, cac[c] + blk * 16 + 1, 15,
                             CAT_CHROMA_AC, mbx, mby, blk, true, c);
            else
                st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c);
        }
    }
}

// LumaLevel8x8 block (cabac_syntax._encode_block8): Table 9-43 maps,
// no coded_block_flag.
void encode_block8(CabacEnc& e, H264Ctxs& cx, const int32_t* coeffs) {
    int nz[64], total = 0;
    for (int i = 0; i < 64; i++)
        if (coeffs[i]) nz[total++] = i;
    int last = nz[total - 1];
    for (int i = 0; i < 63; i++) {
        int sig = coeffs[i] ? 1 : 0;
        e.encode(*cx.sig8[SIG8_MAP[i]], sig);
        if (sig) {
            e.encode(*cx.last8[LAST8_MAP[i]], i == last ? 1 : 0);
            if (i == last) break;
        }
    }
    int neq1 = 0, ngt1 = 0;
    for (int j = total - 1; j >= 0; j--) {
        int i = nz[j];
        int32_t cv = coeffs[i];
        int v = (cv < 0 ? -cv : cv) - 1;
        int ctx0 = ngt1 > 0 ? 0 : (1 + neq1 < 4 ? 1 + neq1 : 4);
        int ctx1 = 5 + (ngt1 < 4 ? ngt1 : 4);
        int prefix = v < 14 ? v : 14;
        for (int b = 0; b < prefix; b++)
            e.encode(*cx.abs8[b == 0 ? ctx0 : ctx1], 1);
        if (prefix < 14)
            e.encode(*cx.abs8[prefix == 0 ? ctx0 : ctx1], 0);
        else
            write_egk(e, (uint32_t)(v - 14), 0);
        e.bypass(cv < 0 ? 1 : 0);
        if (v == 0) neq1++;
        else ngt1++;
    }
}

// Inter residual walk (cabac_syntax._p_residual, encode side). With
// ``t8`` the luma rows 4b..4b+4 hold 8x8 block b's 64-scan.
void p_residual(CabacEnc& e, H264Ctxs& cx, MbState& st, int mbx, int mby,
                int cbp_l, int cbp_c, const int32_t* luma,
                const int32_t* cdc[2], const int32_t* cac[2],
                bool t8 = false) {
    if (t8) {
        for (int b8 = 0; b8 < 4; b8++) {
            int bit = (cbp_l >> b8) & 1;
            if (bit) encode_block8(e, cx, luma + b8 * 64);
            // every 4x4 position of the 8x8 carries its cbf (spec
            // 9.3.3.1.1.9 for transform-8x8 neighbors)
            int gy = 4 * mby + 2 * (b8 / 2), gx = 4 * mbx + 2 * (b8 % 2);
            int w4 = 4 * st.n_mbx;
            for (int dy = 0; dy < 2; dy++)
                for (int dx = 0; dx < 2; dx++)
                    st.cbf_l4[(size_t)(gy + dy) * w4 + gx + dx] =
                        (int8_t)bit;
        }
    } else {
    for (int blk = 0; blk < 16; blk++) {
        int b8 = blk / 4;
        if ((cbp_l >> b8) & 1)
            encode_block(e, cx, st, luma + blk * 16, 16, CAT_LUMA4,
                         mbx, mby, blk, false, 0);
        else
            st.set_cbf(CAT_LUMA4, mbx, mby, blk, 0, 0);
    }
    }
    if (cbp_c) {
        for (int c = 0; c < 2; c++)
            encode_block(e, cx, st, cdc[c], 4, CAT_CHROMA_DC, mbx, mby, 0,
                         false, c);
    } else {
        for (int c = 0; c < 2; c++)
            st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c);
    }
    for (int c = 0; c < 2; c++) {
        for (int blk = 0; blk < 4; blk++) {
            if (cbp_c == 2)
                encode_block(e, cx, st, cac[c] + blk * 16 + 1, 15,
                             CAT_CHROMA_AC, mbx, mby, blk, false, c);
            else
                st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c);
        }
    }
}

// mv prediction — duplicated small helpers from entropy.cpp (kept local so
// each TU is self-contained; both mirror pframe.mv_pred/skip_mv).
void mv_neighbors2(const int32_t* mv, const uint8_t* valid, int n_mbx,
                   int mbx, int mby, int a[2], int& ra, int b[2], int& rb,
                   int c[2], int& rc) {
    auto get = [&](int x, int y, int m[2]) -> int {
        if (x < 0 || y < 0 || x >= n_mbx) { m[0] = m[1] = 0; return -1; }
        if (!valid[(size_t)y * n_mbx + x]) { m[0] = m[1] = 0; return -1; }
        m[0] = mv[((size_t)y * n_mbx + x) * 2 + 0];
        m[1] = mv[((size_t)y * n_mbx + x) * 2 + 1];
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

void mv_pred2(const int32_t* mv, const uint8_t* valid, int n_mbx, int mbx,
              int mby, int out[2]) {
    int a[2], b[2], c[2], ra, rb, rc;
    mv_neighbors2(mv, valid, n_mbx, mbx, mby, a, ra, b, rb, c, rc);
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

void skip_mv2(const int32_t* mv, const uint8_t* valid, int n_mbx, int mbx,
              int mby, int out[2]) {
    out[0] = out[1] = 0;
    if (mbx - 1 < 0 || mby - 1 < 0) return;
    int a[2], b[2], c[2], ra, rb, rc;
    mv_neighbors2(mv, valid, n_mbx, mbx, mby, a, ra, b, rb, c, rc);
    if (ra < 0 || rb < 0) return;
    if ((ra == 0 && a[0] == 0 && a[1] == 0) ||
        (rb == 0 && b[0] == 0 && b[1] == 0)) return;
    mv_pred2(mv, valid, n_mbx, mbx, mby, out);
}

}  // namespace

extern "C" {

// CABAC IDR slice. Level-array layout identical to vcp_write_islice.
// Returns RBSP length, or -1 if out_cap too small.
int64_t vcp_write_islice_cabac(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int idr_pic_id, int deblock_idc,
    int poc_bits, int poc_lsb,
    const int32_t* luma_dc, const int32_t* luma_ac,
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    const int32_t* modes,      // per-MB I16 pred mode (RD intra), or NULL
    const int32_t* cmodes,     // per-MB chroma pred mode, or NULL
    uint8_t* out, int64_t out_cap) {
    HdrWriter bw;
    cabac_slice_header(bw, true, frame_num_bits, frame_num, idr_pic_id, qp,
                       init_qp, deblock_idc, poc_bits, poc_lsb);
    bw.align_ones();

    CabacEnc e;
    e.bits.reserve((size_t)n_mby * n_mbx * 256);
    H264Ctxs cx(qp, false);
    MbState st(n_mby, n_mbx);

    for (int mby = 0; mby < n_mby; mby++) {
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

            encode_mb_i16(e, cx, st, mbx, mby, pred_mode, chroma_mode,
                          cbp_luma15, cbp_chroma);
            e.encode(*cx.qp_delta[0], 0);      // mb_qp_delta == 0
            mb_i16_residual(e, cx, st, mbx, mby, cbp_luma15, cbp_chroma,
                            zdc, zac, cdc, cac);
            st.avail[mb] = 1;
            bool last = (mby == n_mby - 1) && (mbx == n_mbx - 1);
            e.terminate(last ? 1 : 0);
        }
    }
    std::vector<uint8_t>& buf = bw.buf;
    e.flush_to(buf);
    if ((int64_t)buf.size() > out_cap) return -1;
    std::memcpy(out, buf.data(), buf.size());
    return (int64_t)buf.size();
}

// CABAC P slice. mv layout: (n_mby, n_mbx, 2) [x, y] quarter-pel, as for
// vcp_write_pslice; ``active`` nullable, same semantics (sparse-fetch
// skip MBs whose P_Skip MV is re-derived here).
static int64_t write_pslice_cabac_impl(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int deblock_idc, int poc_bits, int poc_lsb,
    const uint8_t* active,
    const int32_t* mv_xy, const int32_t* luma,
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    uint8_t* out, int64_t out_cap,
    const uint8_t* t8, int transform_8x8) {
    HdrWriter bw;
    cabac_slice_header(bw, false, frame_num_bits, frame_num, 0, qp, init_qp,
                       deblock_idc, poc_bits, poc_lsb);
    bw.align_ones();

    CabacEnc e;
    e.bits.reserve((size_t)n_mby * n_mbx * 128);
    H264Ctxs cx(qp, true);
    MbState st(n_mby, n_mbx);
    std::vector<uint8_t> valid((size_t)n_mby * n_mbx, 1);
    std::vector<int32_t> mvg(mv_xy, mv_xy + (size_t)n_mby * n_mbx * 2);
    int32_t* mvp = mvg.data();

    for (int mby = 0; mby < n_mby; mby++) {
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mb = (size_t)mby * n_mbx + mbx;
            if (active && !active[mb]) {
                int smv[2];
                skip_mv2(mvp, valid.data(), n_mbx, mbx, mby, smv);
                mvp[mb * 2 + 0] = smv[0];
                mvp[mb * 2 + 1] = smv[1];
                e.encode(*cx.skip[st.skip_ctx(mbx, mby)], 1);
                st.avail[mb] = 1;
                st.skip[mb] = 1;
                st.fill_cbp_luma8(mbx, mby, 0);
                st.cbp_chroma[mb] = 0;
                bool last = (mby == n_mby - 1) && (mbx == n_mbx - 1);
                e.terminate(last ? 1 : 0);
                continue;
            }
            const int32_t* zl = luma + mb * 256;
            const int32_t* cdc[2] = {cb_dc + mb * 4, cr_dc + mb * 4};
            const int32_t* cac[2] = {cb_ac + mb * 64, cr_ac + mb * 64};

            int cbp_l = 0;
            for (int blk = 0; blk < 16; blk++) {
                for (int k = 0; k < 16; k++)
                    if (zl[blk * 16 + k]) { cbp_l |= 1 << (blk / 4); break; }
            }
            bool any_cac = false, any_cdc = false;
            for (int c = 0; c < 2; c++) {
                for (int k = 0; k < 4; k++) if (cdc[c][k]) any_cdc = true;
                for (int blk = 0; blk < 4; blk++)
                    for (int k = 1; k < 16; k++)
                        if (cac[c][blk * 16 + k]) any_cac = true;
            }
            int cbp_c = any_cac ? 2 : (any_cdc ? 1 : 0);

            int m[2] = {mvp[mb * 2 + 0], mvp[mb * 2 + 1]};
            int smv[2];
            skip_mv2(mvp, valid.data(), n_mbx, mbx, mby, smv);
            bool is_skip = (cbp_l == 0 && cbp_c == 0 &&
                            m[0] == smv[0] && m[1] == smv[1]);
            e.encode(*cx.skip[st.skip_ctx(mbx, mby)], is_skip ? 1 : 0);
            st.avail[mb] = 1;
            st.skip[mb] = is_skip ? 1 : 0;
            bool last = (mby == n_mby - 1) && (mbx == n_mbx - 1);
            if (is_skip) {
                st.fill_cbp_luma8(mbx, mby, 0);
                st.cbp_chroma[mb] = 0;
                e.terminate(last ? 1 : 0);
                continue;
            }
            // mb_type P_L0_16x16 -> "000"
            e.encode(*cx.mbt_p[0], 0);
            e.encode(*cx.mbt_p[1], 0);
            e.encode(*cx.mbt_p[2], 0);
            int pred[2];
            mv_pred2(mvp, valid.data(), n_mbx, mbx, mby, pred);
            int mvd[2] = {m[0] - pred[0], m[1] - pred[1]};
            encode_mvd_comp(e, cx, st, mbx, mby, 0, mvd[0]);
            encode_mvd_comp(e, cx, st, mbx, mby, 1, mvd[1]);
            st.absmvd[2 * mb + 0] = mvd[0] < 0 ? -mvd[0] : mvd[0];
            st.absmvd[2 * mb + 1] = mvd[1] < 0 ? -mvd[1] : mvd[1];
            for (int b8 = 0; b8 < 4; b8++) {
                int bit = (cbp_l >> b8) & 1;
                e.encode(*cx.cbp_l[st.cbp_luma_ctx(mbx, mby, b8)], bit);
                st.set_cbp_luma8(mbx, mby, b8, bit);
            }
            e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 0)],
                     cbp_c > 0 ? 1 : 0);
            if (cbp_c > 0)
                e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 1)],
                         cbp_c == 2 ? 1 : 0);
            st.cbp_chroma[mb] = cbp_c;
            bool t8f = t8 && t8[mb];
            if (cbp_l > 0 && transform_8x8) {
                e.encode(*cx.t8flag[st.t8_ctx(mbx, mby)], t8f ? 1 : 0);
            }
            st.t8[mb] = t8f ? 1 : 0;
            if (cbp_l || cbp_c) e.encode(*cx.qp_delta[0], 0);
            p_residual(e, cx, st, mbx, mby, cbp_l, cbp_c, zl, cdc, cac,
                       t8f);
            e.terminate(last ? 1 : 0);
        }
    }
    std::vector<uint8_t>& buf = bw.buf;
    e.flush_to(buf);
    if ((int64_t)buf.size() > out_cap) return -1;
    std::memcpy(out, buf.data(), buf.size());
    return (int64_t)buf.size();
}

int64_t vcp_write_pslice_cabac(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int deblock_idc, int poc_bits, int poc_lsb,
    const uint8_t* active,
    const int32_t* mv_xy, const int32_t* luma,
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    uint8_t* out, int64_t out_cap) {
    return write_pslice_cabac_impl(
        n_mby, n_mbx, qp, init_qp, frame_num_bits, frame_num, deblock_idc,
        poc_bits, poc_lsb, active, mv_xy, luma, cb_dc, cb_ac, cr_dc, cr_ac,
        out, out_cap, nullptr, 0);
}

// High-profile variant: ``t8`` (nullable) flags transform-8x8 MBs and
// transform_8x8_mode_flag is ON in the PPS (the flag is coded for every
// MB with luma residual).
int64_t vcp_write_pslice_cabac_t8(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int deblock_idc, int poc_bits, int poc_lsb,
    const uint8_t* active, const uint8_t* t8,
    const int32_t* mv_xy, const int32_t* luma,
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    uint8_t* out, int64_t out_cap) {
    return write_pslice_cabac_impl(
        n_mby, n_mbx, qp, init_qp, frame_num_bits, frame_num, deblock_idc,
        poc_bits, poc_lsb, active, mv_xy, luma, cb_dc, cb_ac, cr_dc, cr_ac,
        out, out_cap, t8, 1);
}


// ---------------------------------------------------------------------------
// Partitioned CABAC P slice (16x16 / 16x8 / 8x16 / P_8x8) on the 8x8 MV
// grid — native counterpart of cabac_syntax.write_pslice_cabac with a
// non-empty ``parts`` grid (the quality presets' shipping path).
// ---------------------------------------------------------------------------

static bool blk8_before(int by, int bx, int cby, int cbx) {
    // pframe._blk8_before: MB raster, partitions raster within the MB
    int mby = by >> 1, mbx = bx >> 1, cmby = cby >> 1, cmbx = cbx >> 1;
    if (cmby != mby || cmbx != mbx)
        return cmby < mby || (cmby == mby && cmbx < mbx);
    return (2 * (cby & 1) + (cbx & 1)) < (2 * (by & 1) + (bx & 1));
}

struct Nb8 { int x, y, ref; };

static Nb8 get8(const int32_t* mv8, int nbx2, int nby2, int by, int bx) {
    if (bx < 0 || by < 0 || bx >= nbx2 || by >= nby2)
        return {0, 0, -1};
    size_t i = (size_t)by * nbx2 + bx;
    return {mv8[2 * i + 0], mv8[2 * i + 1], 0};
}

// pframe._neighbor8 (valid8 all-true encoder semantics)
static void neighbor8(const int32_t* mv8, int nbx2, int nby2, int by,
                      int bx, int pw, Nb8* a, Nb8* b, Nb8* c) {
    *a = get8(mv8, nbx2, nby2, by, bx - 1);
    *b = get8(mv8, nbx2, nby2, by - 1, bx);
    bool c_exists = by - 1 >= 0 && bx + pw < nbx2
        && blk8_before(by, bx, by - 1, bx + pw);
    if (c_exists) *c = get8(mv8, nbx2, nby2, by - 1, bx + pw);
    else *c = {0, 0, -1};
    if (!c_exists || c->ref < 0) {
        Nb8 d = get8(mv8, nbx2, nby2, by - 1, bx - 1);
        if (c->ref < 0) *c = d;
    }
}

static void mv_pred8c(const int32_t* mv8, int nbx2, int nby2, int by,
                      int bx, int pw, int ph, int part_idx, int* out) {
    Nb8 a, b, c;
    neighbor8(mv8, nbx2, nby2, by, bx, pw, &a, &b, &c);
    if (pw == 2 && ph == 1) {                       // 16x8
        if (part_idx == 0 && b.ref == 0) { out[0] = b.x; out[1] = b.y; return; }
        if (part_idx == 1 && a.ref == 0) { out[0] = a.x; out[1] = a.y; return; }
    } else if (pw == 1 && ph == 2) {                // 8x16
        if (part_idx == 0 && a.ref == 0) { out[0] = a.x; out[1] = a.y; return; }
        if (part_idx == 1 && c.ref == 0) { out[0] = c.x; out[1] = c.y; return; }
    }
    bool b_exists = by - 1 >= 0 && b.ref >= 0;
    if (!b_exists && c.ref < 0 && a.ref >= 0) {
        out[0] = a.x; out[1] = a.y; return;
    }
    int hits = (a.ref == 0) + (b.ref == 0) + (c.ref == 0);
    if (hits == 1) {
        const Nb8& m = a.ref == 0 ? a : (b.ref == 0 ? b : c);
        out[0] = m.x; out[1] = m.y; return;
    }
    auto med3 = [](int u, int v, int w) {
        int lo = u < v ? u : v, hi = u < v ? v : u;
        return w < lo ? lo : (w > hi ? hi : w);
    };
    out[0] = med3(a.x, b.x, c.x);
    out[1] = med3(a.y, b.y, c.y);
}

static void skip_mv8c(const int32_t* mv8, int nbx2, int nby2, int mbx,
                      int mby, int* out) {
    int by = 2 * mby, bx = 2 * mbx;
    if (bx - 1 < 0 || by - 1 < 0) { out[0] = out[1] = 0; return; }
    Nb8 a, b, c;
    neighbor8(mv8, nbx2, nby2, by, bx, 2, &a, &b, &c);
    if ((a.ref == 0 && a.x == 0 && a.y == 0)
        || (b.ref == 0 && b.x == 0 && b.y == 0)
        || a.ref < 0 || b.ref < 0) {
        out[0] = out[1] = 0; return;
    }
    mv_pred8c(mv8, nbx2, nby2, by, bx, 2, 2, 0, out);
}

// mvd ctx on the 8x8 grid (cabac_syntax.MbState.mvd_ctx)
static int mvd_ctx8(const int32_t* absmvd8, const uint8_t* avail,
                    int n_mbx, int nbx2, int by, int bx, int comp) {
    int s = 0;
    if (bx > 0 && avail[(size_t)(by >> 1) * n_mbx + ((bx - 1) >> 1)])
        s += absmvd8[2 * ((size_t)by * nbx2 + bx - 1) + comp];
    if (by > 0 && avail[(size_t)((by - 1) >> 1) * n_mbx + (bx >> 1)])
        s += absmvd8[2 * ((size_t)(by - 1) * nbx2 + bx) + comp];
    return s < 3 ? 0 : (s <= 32 ? 1 : 2);
}

static void encode_mvd8(CabacEnc& e, H264Ctxs& cx, int ctx0, int comp,
                        int mvd) {
    int v = mvd < 0 ? -mvd : mvd;
    Ctx** row = cx.mvd[comp];
    auto ctx_of = [&](int b) {
        return b == 0 ? ctx0 : (2 + b < 6 ? 2 + b : 6);
    };
    int prefix = v < 9 ? v : 9;
    for (int b = 0; b < prefix; b++) e.encode(*row[ctx_of(b)], 1);
    if (prefix < 9) e.encode(*row[ctx_of(prefix)], 0);
    else write_egk(e, (uint32_t)(v - 9), 3);
    if (v) e.bypass(mvd < 0 ? 1 : 0);
}

int64_t vcp_write_pslice_cabac_parts(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int deblock_idc, int poc_bits, int poc_lsb,
    const uint8_t* active, const uint8_t* t8, int transform_8x8,
    const int32_t* mv8_xy,              // (2H, 2W, 2) [x, y] qpel
    const int32_t* parts,               // (nMBy, nMBx) 0/1/2/3
    const int32_t* luma,
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    uint8_t* out, int64_t out_cap) {
    HdrWriter bw;
    cabac_slice_header(bw, false, frame_num_bits, frame_num, 0, qp,
                       init_qp, deblock_idc, poc_bits, poc_lsb);
    bw.align_ones();

    CabacEnc e;
    e.bits.reserve((size_t)n_mby * n_mbx * 128);
    H264Ctxs cx(qp, true);
    MbState st(n_mby, n_mbx);
    const int nbx2 = 2 * n_mbx, nby2 = 2 * n_mby;
    std::vector<int32_t> mvg(mv8_xy,
                             mv8_xy + (size_t)nby2 * nbx2 * 2);
    int32_t* mvp = mvg.data();
    std::vector<int32_t> absmvd8((size_t)nby2 * nbx2 * 2, 0);

    // partition geometry per pt on the 8x8 grid: (dy, dx, pw, ph)
    static const int GEO16x8[2][4] = {{0, 0, 2, 1}, {1, 0, 2, 1}};
    static const int GEO8x16[2][4] = {{0, 0, 1, 2}, {0, 1, 1, 2}};

    auto set_absmvd = [&](int by, int bx, int ph, int pw, int ax,
                          int ay) {
        for (int y = by; y < by + ph; y++)
            for (int x = bx; x < bx + pw; x++) {
                absmvd8[2 * ((size_t)y * nbx2 + x) + 0] = ax;
                absmvd8[2 * ((size_t)y * nbx2 + x) + 1] = ay;
            }
    };

    for (int mby = 0; mby < n_mby; mby++) {
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mb = (size_t)mby * n_mbx + mbx;
            int by0 = 2 * mby, bx0 = 2 * mbx;
            int pt = parts[mb];
            bool last = (mby == n_mby - 1) && (mbx == n_mbx - 1);

            int cbp_l = 0, cbp_c = 0;
            const int32_t* zl = luma + mb * 256;
            const int32_t* cdc[2] = {cb_dc + mb * 4, cr_dc + mb * 4};
            const int32_t* cac[2] = {cb_ac + mb * 64, cr_ac + mb * 64};
            bool is_skip;
            int m[2] = {0, 0}, smv[2];
            if (active && !active[mb]) {
                skip_mv8c(mvp, nbx2, nby2, mbx, mby, smv);
                for (int y = by0; y < by0 + 2; y++)
                    for (int x = bx0; x < bx0 + 2; x++) {
                        mvp[2 * ((size_t)y * nbx2 + x) + 0] = smv[0];
                        mvp[2 * ((size_t)y * nbx2 + x) + 1] = smv[1];
                    }
                is_skip = true;
            } else {
                for (int blk = 0; blk < 16; blk++)
                    for (int k = 0; k < 16; k++)
                        if (zl[blk * 16 + k]) {
                            cbp_l |= 1 << (blk / 4);
                            break;
                        }
                bool any_cac = false, any_cdc = false;
                for (int c = 0; c < 2; c++) {
                    for (int k = 0; k < 4; k++)
                        if (cdc[c][k]) any_cdc = true;
                    for (int blk = 0; blk < 4; blk++)
                        for (int k = 1; k < 16; k++)
                            if (cac[c][blk * 16 + k]) any_cac = true;
                }
                cbp_c = any_cac ? 2 : (any_cdc ? 1 : 0);
                m[0] = mvp[2 * ((size_t)by0 * nbx2 + bx0) + 0];
                m[1] = mvp[2 * ((size_t)by0 * nbx2 + bx0) + 1];
                is_skip = false;
                if (pt == 0) {
                    skip_mv8c(mvp, nbx2, nby2, mbx, mby, smv);
                    is_skip = cbp_l == 0 && cbp_c == 0
                        && m[0] == smv[0] && m[1] == smv[1];
                }
            }
            e.encode(*cx.skip[st.skip_ctx(mbx, mby)], is_skip ? 1 : 0);
            st.avail[mb] = 1;
            st.skip[mb] = is_skip ? 1 : 0;
            if (is_skip) {
                st.fill_cbp_luma8(mbx, mby, 0);
                st.cbp_chroma[mb] = 0;
                e.terminate(last ? 1 : 0);
                continue;
            }

            auto mvd_part = [&](int by, int bx, int pw, int ph,
                                int part_idx) {
                int pred[2];
                mv_pred8c(mvp, nbx2, nby2, by, bx, pw, ph, part_idx,
                          pred);
                size_t bi = (size_t)by * nbx2 + bx;
                int dx = mvp[2 * bi + 0] - pred[0];
                int dy = mvp[2 * bi + 1] - pred[1];
                encode_mvd8(e, cx,
                            mvd_ctx8(absmvd8.data(), st.avail.data(),
                                     n_mbx, nbx2, by, bx, 0), 0, dx);
                encode_mvd8(e, cx,
                            mvd_ctx8(absmvd8.data(), st.avail.data(),
                                     n_mbx, nbx2, by, bx, 1), 1, dy);
                set_absmvd(by, bx, ph, pw, dx < 0 ? -dx : dx,
                           dy < 0 ? -dy : dy);
            };

            if (pt == 3) {                          // P_8x8: "001"
                e.encode(*cx.mbt_p[0], 0);
                e.encode(*cx.mbt_p[1], 0);
                e.encode(*cx.mbt_p[2], 1);
                for (int q = 0; q < 4; q++)
                    e.encode(cx.g[21], 1);          // sub_mb_type "1"
                for (int q = 0; q < 4; q++)
                    mvd_part(by0 + (q >> 1), bx0 + (q & 1), 1, 1, q);
            } else if (pt == 1 || pt == 2) {        // 16x8 "011"/8x16 "010"
                e.encode(*cx.mbt_p[0], 0);
                e.encode(*cx.mbt_p[1], 1);
                e.encode(cx.g[17], pt == 1 ? 1 : 0);
                const int (*geo)[4] = pt == 1 ? GEO16x8 : GEO8x16;
                for (int i = 0; i < 2; i++)
                    mvd_part(by0 + geo[i][0], bx0 + geo[i][1],
                             geo[i][2], geo[i][3], i);
            } else {                                // P_L0_16x16 "000"
                e.encode(*cx.mbt_p[0], 0);
                e.encode(*cx.mbt_p[1], 0);
                e.encode(*cx.mbt_p[2], 0);
                mvd_part(by0, bx0, 2, 2, 0);
            }

            for (int b8 = 0; b8 < 4; b8++) {
                int bit = (cbp_l >> b8) & 1;
                e.encode(*cx.cbp_l[st.cbp_luma_ctx(mbx, mby, b8)], bit);
                st.set_cbp_luma8(mbx, mby, b8, bit);
            }
            e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 0)],
                     cbp_c > 0 ? 1 : 0);
            if (cbp_c > 0)
                e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 1)],
                         cbp_c == 2 ? 1 : 0);
            st.cbp_chroma[mb] = cbp_c;
            bool t8f = t8 && t8[mb];
            if (cbp_l > 0 && transform_8x8)
                e.encode(*cx.t8flag[st.t8_ctx(mbx, mby)], t8f ? 1 : 0);
            st.t8[mb] = t8f ? 1 : 0;
            if (cbp_l || cbp_c) e.encode(*cx.qp_delta[0], 0);
            p_residual(e, cx, st, mbx, mby, cbp_l, cbp_c, zl, cdc, cac,
                       t8f);
            e.terminate(last ? 1 : 0);
        }
    }
    std::vector<uint8_t>& buf = bw.buf;
    e.flush_to(buf);
    if ((int64_t)buf.size() > out_cap) return -1;
    std::memcpy(out, buf.data(), buf.size());
    return (int64_t)buf.size();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// I_NxN / i8x8 macroblock and the mixed I16 / i8 IDR slice.
// ---------------------------------------------------------------------------

namespace {

// One I_NxN MB with transform_size_8x8 (vcp_tpu's encode_mb_i8). The
// caller provides the 4x4-granular I_NxN mode grid i4g (-1 = not I_NxN).
// modes4 (4,), i8_luma (4, 64) scans, cdc (2, 4), cac (2, 4*16).
void encode_mb_i8(CabacEnc& e, H264Ctxs& cx, MbState& st, int mbx,
                  int mby, const int32_t* modes4, const int32_t* i8_luma,
                  const int32_t* cdc[2], const int32_t* cac[2],
                  int8_t* i4g, int chroma_mode, bool in_pslice) {
    int n_mbx = st.n_mbx;
    int w4 = 4 * n_mbx;
    if (in_pslice) e.encode(*cx.mbt_p[0], 1);     // intra prefix
    e.encode(*cx.mbt_i[st.mbt_i_ctx(mbx, mby)], 0);   // I_NxN
    st.intra[st.mb(mbx, mby)] = 1;
    st.i_nxn[st.mb(mbx, mby)] = 1;
    e.encode(*cx.t8flag[st.t8_ctx(mbx, mby)], 1);
    st.t8[st.mb(mbx, mby)] = 1;
    for (int b8 = 0; b8 < 4; b8++) {
        int by = 4 * mby + 2 * (b8 / 2);
        int bx = 4 * mbx + 2 * (b8 % 2);
        int pred;
        if (bx == 0 || by == 0) {
            pred = 2;
        } else {
            int a = i4g[(size_t)by * w4 + bx - 1];
            int b = i4g[(size_t)(by - 1) * w4 + bx];
            int pa = a >= 0 ? a : 2, pb = b >= 0 ? b : 2;
            pred = pa < pb ? pa : pb;
        }
        int mode = modes4[b8];
        if (mode == pred) {
            e.encode(cx.g[68], 1);
        } else {
            e.encode(cx.g[68], 0);
            int rem = mode < pred ? mode : mode - 1;
            e.encode(cx.g[69], rem & 1);
            e.encode(cx.g[69], (rem >> 1) & 1);
            e.encode(cx.g[69], (rem >> 2) & 1);
        }
        for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++)
                i4g[(size_t)(by + dy) * w4 + bx + dx] = (int8_t)mode;
    }
    int cm_ctx = st.chroma_mode_ctx(mbx, mby);
    if (chroma_mode == 0) {
        e.encode(*cx.chroma_mode[cm_ctx], 0);
    } else {
        e.encode(*cx.chroma_mode[cm_ctx], 1);
        for (int b = 1; b < 3; b++) {
            if (chroma_mode == b) { e.encode(*cx.chroma_mode[3], 0); break; }
            e.encode(*cx.chroma_mode[3], 1);
        }
    }
    st.chroma_mode[st.mb(mbx, mby)] = chroma_mode;
    int cbp_l = 0;
    for (int b8 = 0; b8 < 4; b8++)
        for (int k = 0; k < 64; k++)
            if (i8_luma[b8 * 64 + k]) { cbp_l |= 1 << b8; break; }
    bool any_cac = false, any_cdc = false;
    for (int c = 0; c < 2; c++) {
        for (int k = 0; k < 4; k++) if (cdc[c][k]) any_cdc = true;
        for (int blk = 0; blk < 4; blk++)
            for (int k = 1; k < 16; k++)
                if (cac[c][blk * 16 + k]) any_cac = true;
    }
    int cbp_c = any_cac ? 2 : (any_cdc ? 1 : 0);
    for (int b8 = 0; b8 < 4; b8++) {
        int bit = (cbp_l >> b8) & 1;
        e.encode(*cx.cbp_l[st.cbp_luma_ctx(mbx, mby, b8)], bit);
        st.set_cbp_luma8(mbx, mby, b8, bit);
    }
    e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 0)], cbp_c > 0 ? 1 : 0);
    if (cbp_c > 0)
        e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 1)],
                 cbp_c == 2 ? 1 : 0);
    st.cbp_chroma[st.mb(mbx, mby)] = cbp_c;
    if (cbp_l || cbp_c) e.encode(*cx.qp_delta[0], 0);
    for (int b8 = 0; b8 < 4; b8++) {
        int bit = (cbp_l >> b8) & 1;
        if (bit) encode_block8(e, cx, i8_luma + b8 * 64);
        int gy = 4 * mby + 2 * (b8 / 2), gx = 4 * mbx + 2 * (b8 % 2);
        for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++)
                st.cbf_l4[(size_t)(gy + dy) * w4 + gx + dx] = (int8_t)bit;
    }
    if (cbp_c) {
        for (int c = 0; c < 2; c++)
            encode_block(e, cx, st, cdc[c], 4, CAT_CHROMA_DC, mbx, mby, 0,
                         true, c);
    } else {
        for (int c = 0; c < 2; c++)
            st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c);
    }
    for (int c = 0; c < 2; c++) {
        for (int blk = 0; blk < 4; blk++) {
            if (cbp_c == 2)
                encode_block(e, cx, st, cac[c] + blk * 16 + 1, 15,
                             CAT_CHROMA_AC, mbx, mby, blk, true, c);
            else
                st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c);
        }
    }
}


// decoder-exact MV prediction over (mv8, ref8, dec8) — mirrors
// codec.h264.mvpred (spec 8.4.1.3, single-ref P usage).
struct NbP { int x, y, ref; bool ok; };

static NbP getp(const int32_t* mv8, const int8_t* ref8,
                const uint8_t* dec8, int nbx2, int by, int bx) {
    if (by < 0 || bx < 0 || bx >= nbx2) return {0, 0, -1, false};
    size_t i = (size_t)by * nbx2 + bx;
    if (!dec8[i]) return {0, 0, -1, false};
    return {mv8[2 * i + 0], mv8[2 * i + 1], ref8[i], true};
}

static void nbsp(const int32_t* mv8, const int8_t* ref8,
                 const uint8_t* dec8, int nbx2, int by, int bx, int pw,
                 NbP* a, NbP* b, NbP* c) {
    *a = getp(mv8, ref8, dec8, nbx2, by, bx - 1);
    *b = getp(mv8, ref8, dec8, nbx2, by - 1, bx);
    *c = getp(mv8, ref8, dec8, nbx2, by - 1, bx + pw);
    if (!c->ok) *c = getp(mv8, ref8, dec8, nbx2, by - 1, bx - 1);
}

static void mv_pred_state(const int32_t* mv8, const int8_t* ref8,
                          const uint8_t* dec8, int nbx2, int by, int bx,
                          int pw, int ph, int part_idx, int out[2]) {
    NbP a, b, c;
    nbsp(mv8, ref8, dec8, nbx2, by, bx, pw, &a, &b, &c);
    if (pw == 2 && ph == 1) {
        if (part_idx == 0 && b.ok && b.ref == 0) {
            out[0] = b.x; out[1] = b.y; return; }
        if (part_idx == 1 && a.ok && a.ref == 0) {
            out[0] = a.x; out[1] = a.y; return; }
    } else if (pw == 1 && ph == 2) {
        if (part_idx == 0 && a.ok && a.ref == 0) {
            out[0] = a.x; out[1] = a.y; return; }
        if (part_idx == 1 && c.ok && c.ref == 0) {
            out[0] = c.x; out[1] = c.y; return; }
    }
    if (!b.ok && !c.ok && a.ok) { out[0] = a.x; out[1] = a.y; return; }
    int hits = (a.ok && a.ref == 0) + (b.ok && b.ref == 0)
        + (c.ok && c.ref == 0);
    if (hits == 1) {
        const NbP& m = (a.ok && a.ref == 0) ? a
            : ((b.ok && b.ref == 0) ? b : c);
        out[0] = m.x; out[1] = m.y; return;
    }
    auto med3 = [](int u, int v, int w) {
        int lo = u < v ? u : v, hi = u < v ? v : u;
        return w < lo ? lo : (w > hi ? hi : w);
    };
    int ax = a.ok ? a.x : 0, ay = a.ok ? a.y : 0;
    int bx2 = b.ok ? b.x : 0, by2 = b.ok ? b.y : 0;
    int cx2 = c.ok ? c.x : 0, cy2 = c.ok ? c.y : 0;
    out[0] = med3(ax, bx2, cx2);
    out[1] = med3(ay, by2, cy2);
}

static void p_skip_mv_state(const int32_t* mv8, const int8_t* ref8,
                            const uint8_t* dec8, int nbx2, int mby,
                            int mbx, int out[2]) {
    // mvpred.p_skip_mv: A or B out-of-picture/undecoded -> 0; A or B
    // inter-ref0 with zero mv -> 0; else median pred (intra neighbors
    // participate as (0,0) ref -1)
    int by = 2 * mby, bx = 2 * mbx;
    NbP a, b, c;
    nbsp(mv8, ref8, dec8, nbx2, by, bx, 2, &a, &b, &c);
    if (!a.ok || !b.ok) { out[0] = out[1] = 0; return; }
    if ((a.ref == 0 && a.x == 0 && a.y == 0)
        || (b.ref == 0 && b.x == 0 && b.y == 0)) {
        out[0] = out[1] = 0; return;
    }
    mv_pred_state(mv8, ref8, dec8, nbx2, by, bx, 2, 2, 0, out);
}

}  // namespace

// ---------------------------------------------------------------------------
// CABAC B slice — native counterpart of cabac_syntax.write_bslice_cabac
// (B_Skip / B_Direct_16x16 / B_L0/L1/Bi_16x16, spatial direct, two-list
// mvd, non-reference picture). Bit-identical to the Python writer
// (pinned by tests/test_native_entropy.py).
// ---------------------------------------------------------------------------

namespace {

// Decoder-semantics neighbor for one reference list (pframe.
// _mv_neighbors_dec): positions outside the picture are absent; an
// in-picture MB not using the list IS present with mv (0,0), ref -1.
struct NbB { int x, y, ref; bool pos; };

static NbB getb(const int32_t* mv_xy, const uint8_t* use, int n_mbx,
                int x, int y) {
    if (x < 0 || y < 0 || x >= n_mbx) return {0, 0, -1, false};
    size_t i = (size_t)y * n_mbx + x;
    if (!use[i]) return {0, 0, -1, true};
    return {mv_xy[2 * i + 0], mv_xy[2 * i + 1], 0, true};
}

static void nbs_decb(const int32_t* mv, const uint8_t* use, int n_mbx,
                     int mbx, int mby, NbB* a, NbB* b, NbB* c) {
    *a = getb(mv, use, n_mbx, mbx - 1, mby);
    *b = getb(mv, use, n_mbx, mbx, mby - 1);
    if (mby > 0 && mbx + 1 < n_mbx)
        *c = getb(mv, use, n_mbx, mbx + 1, mby - 1);
    else
        *c = {0, 0, -1, false};
    if (!c->pos) *c = getb(mv, use, n_mbx, mbx - 1, mby - 1);
}

static void mv_pred_decb(const int32_t* mv, const uint8_t* use, int n_mbx,
                         int mbx, int mby, int out[2]) {
    NbB a, b, c;
    nbs_decb(mv, use, n_mbx, mbx, mby, &a, &b, &c);
    if (!b.pos && !c.pos && a.pos) { out[0] = a.x; out[1] = a.y; return; }
    int hits = (a.pos && a.ref == 0) + (b.pos && b.ref == 0)
        + (c.pos && c.ref == 0);
    if (hits == 1) {
        const NbB& m = (a.pos && a.ref == 0) ? a
            : ((b.pos && b.ref == 0) ? b : c);
        out[0] = m.x; out[1] = m.y; return;
    }
    auto med3 = [](int u, int v, int w) {
        int lo = u < v ? u : v, hi = u < v ? v : u;
        return w < lo ? lo : (w > hi ? hi : w);
    };
    int ax = a.pos ? a.x : 0, ay = a.pos ? a.y : 0;
    int bx2 = b.pos ? b.x : 0, by2 = b.pos ? b.y : 0;
    int cx2 = c.pos ? c.x : 0, cy2 = c.pos ? c.y : 0;
    out[0] = med3(ax, bx2, cx2);
    out[1] = med3(ay, by2, cy2);
}

// bframe.direct_spatial: MB-level spatial direct derivation. Returns
// (use0, use1) and fills mv0/mv1 for the used lists.
static void direct_spatialc(const int32_t* mv0, const int32_t* mv1,
                            const uint8_t* use0, const uint8_t* use1,
                            int n_mbx, int mbx, int mby, int col_zero,
                            bool* u0, bool* u1, int dmv0[2], int dmv1[2]) {
    NbB a0, b0, c0, a1, b1, c1;
    nbs_decb(mv0, use0, n_mbx, mbx, mby, &a0, &b0, &c0);
    nbs_decb(mv1, use1, n_mbx, mbx, mby, &a1, &b1, &c1);
    int r0 = ((a0.pos && a0.ref == 0) || (b0.pos && b0.ref == 0)
              || (c0.pos && c0.ref == 0)) ? 0 : -1;
    int r1 = ((a1.pos && a1.ref == 0) || (b1.pos && b1.ref == 0)
              || (c1.pos && c1.ref == 0)) ? 0 : -1;
    if (r0 < 0 && r1 < 0) {          // directZeroPredictionFlag
        *u0 = *u1 = true;
        dmv0[0] = dmv0[1] = dmv1[0] = dmv1[1] = 0;
        return;
    }
    *u0 = r0 >= 0;
    *u1 = r1 >= 0;
    if (*u0) {
        if (col_zero) dmv0[0] = dmv0[1] = 0;
        else mv_pred_decb(mv0, use0, n_mbx, mbx, mby, dmv0);
    }
    if (*u1) {
        if (col_zero) dmv1[0] = dmv1[1] = 0;
        else mv_pred_decb(mv1, use1, n_mbx, mbx, mby, dmv1);
    }
}

}  // namespace

extern "C" int64_t vcp_write_bslice_cabac(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int deblock_idc, int poc_bits, int poc_lsb,
    int transform_8x8,
    const int32_t* mv0_xy, const int32_t* mv1_xy,   // (nMB, 2) [x, y] qpel
    const int32_t* mode,                            // 0=L0 1=L1 2=Bi
    const uint8_t* col_zero, const uint8_t* col_safe,
    const int32_t* luma, const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    uint8_t* out, int64_t out_cap) {
    size_t n_mb = (size_t)n_mby * n_mbx;
    HdrWriter bw;
    // headers.write_slice_header, slice_type "B", non-reference
    bw.ue(0);                          // first_mb_in_slice
    bw.ue(6);                          // slice_type B-all
    bw.ue(0);                          // pps id
    bw.u(frame_num_bits,
         (uint32_t)(frame_num & ((1 << frame_num_bits) - 1)));
    if (poc_bits > 0)
        bw.u(poc_bits, (uint32_t)(poc_lsb & ((1 << poc_bits) - 1)));
    bw.u(1, 1);                        // direct_spatial_mv_pred_flag
    bw.u(1, 0);                        // num_ref_idx_active_override
    bw.u(1, 0);                        // ref_pic_list_modification_l0
    bw.u(1, 0);                        // ref_pic_list_modification_l1
    // nal_ref_idc 0: no dec_ref_pic_marking
    bw.ue(0);                          // cabac_init_idc
    bw.se(qp - init_qp);               // slice_qp_delta
    bw.ue((uint32_t)deblock_idc);
    if (deblock_idc != 1) { bw.se(0); bw.se(0); }
    bw.align_ones();

    CabacEnc e;
    e.bits.reserve(n_mb * 64);
    H264Ctxs cx(qp, true);
    MbState st(n_mby, n_mbx);
    std::vector<uint8_t> bdirect(n_mb, 0);
    std::vector<int32_t> absmvd_b(n_mb * 4, 0);     // (nMB, lst, comp)
    std::vector<uint8_t> use0(n_mb), use1(n_mb);
    for (size_t i = 0; i < n_mb; i++) {
        use0[i] = mode[i] != 1 ? 1 : 0;
        use1[i] = mode[i] != 0 ? 1 : 0;
    }

    auto mbt_b_ctx = [&](int mbx, int mby) {
        int ca = (mbx > 0 && st.avail[st.mb(mbx - 1, mby)]
                  && !st.skip[st.mb(mbx - 1, mby)]
                  && !bdirect[st.mb(mbx - 1, mby)]) ? 1 : 0;
        int cb = (mby > 0 && st.avail[st.mb(mbx, mby - 1)]
                  && !st.skip[st.mb(mbx, mby - 1)]
                  && !bdirect[st.mb(mbx, mby - 1)]) ? 1 : 0;
        return ca + cb;
    };
    auto mvd_ctx_b = [&](int mbx, int mby, int lst, int comp) {
        int s = 0;
        if (mbx > 0 && st.avail[st.mb(mbx - 1, mby)])
            s += absmvd_b[4 * st.mb(mbx - 1, mby) + 2 * lst + comp];
        if (mby > 0 && st.avail[st.mb(mbx, mby - 1)])
            s += absmvd_b[4 * st.mb(mbx, mby - 1) + 2 * lst + comp];
        return s < 3 ? 0 : (s <= 32 ? 1 : 2);
    };
    auto encode_mvd_b = [&](int mbx, int mby, int lst, int comp, int mvd) {
        int v = mvd < 0 ? -mvd : mvd;
        int b0 = mvd_ctx_b(mbx, mby, lst, comp);
        Ctx** row = cx.mvd[comp];
        auto ctx_of = [&](int b) {
            return b == 0 ? b0 : (2 + b < 6 ? 2 + b : 6);
        };
        int prefix = v < 9 ? v : 9;
        for (int b = 0; b < prefix; b++) e.encode(*row[ctx_of(b)], 1);
        if (prefix < 9) e.encode(*row[ctx_of(prefix)], 0);
        else write_egk(e, (uint32_t)(v - 9), 3);
        if (v) e.bypass(mvd < 0 ? 1 : 0);
    };

    for (int mby = 0; mby < n_mby; mby++) {
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mb = st.mb(mbx, mby);
            const int32_t* zl = luma + mb * 256;
            const int32_t* cdc[2] = {cb_dc + mb * 4, cr_dc + mb * 4};
            const int32_t* cac[2] = {cb_ac + mb * 64, cr_ac + mb * 64};
            int cbp_l = 0;
            for (int blk = 0; blk < 16; blk++)
                for (int k = 0; k < 16; k++)
                    if (zl[blk * 16 + k]) { cbp_l |= 1 << (blk / 4); break; }
            bool any_cac = false, any_cdc = false;
            for (int c = 0; c < 2; c++) {
                for (int k = 0; k < 4; k++) if (cdc[c][k]) any_cdc = true;
                for (int blk = 0; blk < 4; blk++)
                    for (int k = 1; k < 16; k++)
                        if (cac[c][blk * 16 + k]) any_cac = true;
            }
            int cbp_c = any_cac ? 2 : (any_cdc ? 1 : 0);
            int md = mode[mb];

            // direct_ok: spatial direct reproduces (mode, mv0, mv1)
            bool direct_ok = col_safe[mb] != 0;
            if (direct_ok) {
                bool u0, u1;
                int dmv0[2], dmv1[2];
                direct_spatialc(mv0_xy, mv1_xy, use0.data(), use1.data(),
                                n_mbx, mbx, mby, col_zero[mb],
                                &u0, &u1, dmv0, dmv1);
                int dmd = (u0 && u1) ? 2 : (u1 ? 1 : 0);
                if (dmd != md) direct_ok = false;
                if (direct_ok && u0 &&
                    (dmv0[0] != mv0_xy[2 * mb] ||
                     dmv0[1] != mv0_xy[2 * mb + 1])) direct_ok = false;
                if (direct_ok && u1 &&
                    (dmv1[0] != mv1_xy[2 * mb] ||
                     dmv1[1] != mv1_xy[2 * mb + 1])) direct_ok = false;
            }
            bool is_skip = cbp_l == 0 && cbp_c == 0 && direct_ok;
            e.encode(*cx.skip_b[st.skip_ctx(mbx, mby)], is_skip ? 1 : 0);
            st.avail[mb] = 1;
            st.skip[mb] = is_skip ? 1 : 0;
            bool last = (mby == n_mby - 1) && (mbx == n_mbx - 1);
            if (is_skip) {
                st.fill_cbp_luma8(mbx, mby, 0);
                st.cbp_chroma[mb] = 0;
                e.terminate(last ? 1 : 0);
                continue;
            }
            if (direct_ok) {
                // B_Direct_16x16: bin0 = 0, motion derived, no mvd
                e.encode(*cx.mbt_b[mbt_b_ctx(mbx, mby)], 0);
                bdirect[mb] = 1;
            } else {
                // mb_type (Table 9-37): bin0 = 1, then '0'+list bin for
                // L0/L1 or '1' + 4 fixed zero bins for B_Bi_16x16
                e.encode(*cx.mbt_b[mbt_b_ctx(mbx, mby)], 1);
                if (md < 2) {
                    e.encode(*cx.mbt_b_fix[0], 0);
                    e.encode(*cx.mbt_b_fix[2], md);
                } else {
                    e.encode(*cx.mbt_b_fix[0], 1);
                    e.encode(*cx.mbt_b_fix[1], 0);
                    e.encode(*cx.mbt_b_fix[2], 0);
                    e.encode(*cx.mbt_b_fix[2], 0);
                    e.encode(*cx.mbt_b_fix[2], 0);
                }
                for (int lst = 0; lst < 2; lst++) {
                    const uint8_t* use = lst ? use1.data() : use0.data();
                    const int32_t* mvl = lst ? mv1_xy : mv0_xy;
                    if (!use[mb]) continue;
                    int pred[2];
                    mv_pred_decb(mvl, use, n_mbx, mbx, mby, pred);
                    int mvd_x = mvl[2 * mb + 0] - pred[0];
                    int mvd_y = mvl[2 * mb + 1] - pred[1];
                    encode_mvd_b(mbx, mby, lst, 0, mvd_x);
                    encode_mvd_b(mbx, mby, lst, 1, mvd_y);
                    absmvd_b[4 * mb + 2 * lst + 0] =
                        mvd_x < 0 ? -mvd_x : mvd_x;
                    absmvd_b[4 * mb + 2 * lst + 1] =
                        mvd_y < 0 ? -mvd_y : mvd_y;
                }
            }
            for (int b8 = 0; b8 < 4; b8++) {
                int bit = (cbp_l >> b8) & 1;
                e.encode(*cx.cbp_l[st.cbp_luma_ctx(mbx, mby, b8)], bit);
                st.set_cbp_luma8(mbx, mby, b8, bit);
            }
            e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 0)],
                     cbp_c > 0 ? 1 : 0);
            if (cbp_c > 0)
                e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 1)],
                         cbp_c == 2 ? 1 : 0);
            st.cbp_chroma[mb] = cbp_c;
            if (cbp_l > 0 && transform_8x8) {
                // B pictures keep the 4x4 transform; flag still coded
                e.encode(*cx.t8flag[st.t8_ctx(mbx, mby)], 0);
            }
            if (cbp_l || cbp_c) e.encode(*cx.qp_delta[0], 0);
            p_residual(e, cx, st, mbx, mby, cbp_l, cbp_c, zl, cdc, cac,
                       false);
            e.terminate(last ? 1 : 0);
        }
    }
    std::vector<uint8_t>& buf = bw.buf;
    e.flush_to(buf);
    if ((int64_t)buf.size() > out_cap) return -1;
    std::memcpy(out, buf.data(), buf.size());
    return (int64_t)buf.size();
}

// CABAC IDR slice with mixed I16 / I_NxN-i8 macroblocks (the RD-intra
// rd8 wavefront's output; cabac_syntax.write_islice_cabac with "i8").


extern "C" {

// CABAC IDR slice with mixed I16 / I_NxN-i8 macroblocks (the output of
// intra_rd.encode_iframe_rd8). For i8 MBs the ``luma_ac`` rows hold the
// 4x64 scans (i8_luma layout).
int64_t vcp_write_islice_cabac_i8(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int idr_pic_id, int deblock_idc,
    int poc_bits, int poc_lsb,
    const int32_t* luma_dc, const int32_t* luma_ac,
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    const int32_t* modes, const int32_t* cmodes,
    const uint8_t* i8, const int32_t* i8_modes,
    uint8_t* out, int64_t out_cap) {
    HdrWriter bw;
    cabac_slice_header(bw, true, frame_num_bits, frame_num, idr_pic_id, qp,
                       init_qp, deblock_idc, poc_bits, poc_lsb);
    bw.align_ones();

    CabacEnc e;
    e.bits.reserve((size_t)n_mby * n_mbx * 256);
    H264Ctxs cx(qp, false);
    MbState st(n_mby, n_mbx);
    std::vector<int8_t> i4g((size_t)16 * n_mby * n_mbx, -1);

    for (int mby = 0; mby < n_mby; mby++) {
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mb = (size_t)mby * n_mbx + mbx;
            const int32_t* cdc[2] = {cb_dc + mb * 4, cr_dc + mb * 4};
            const int32_t* cac[2] = {cb_ac + mb * 64, cr_ac + mb * 64};
            if (i8[mb]) {
                encode_mb_i8(e, cx, st, mbx, mby, i8_modes + mb * 4,
                             luma_ac + mb * 256, cdc, cac, i4g.data(),
                             cmodes[mb], false);
            } else {
                const int32_t* zdc = luma_dc + mb * 16;
                const int32_t* zac = luma_ac + mb * 256;
                bool cbp_luma15 = false;
                for (int blk = 0; blk < 16 && !cbp_luma15; blk++)
                    for (int k = 1; k < 16; k++)
                        if (zac[blk * 16 + k]) { cbp_luma15 = true; break; }
                bool any_cac = false, any_cdc = false;
                for (int c = 0; c < 2; c++) {
                    for (int k = 0; k < 4; k++)
                        if (cdc[c][k]) any_cdc = true;
                    for (int blk = 0; blk < 4; blk++)
                        for (int k = 1; k < 16; k++)
                            if (cac[c][blk * 16 + k]) any_cac = true;
                }
                int cbp_chroma = any_cac ? 2 : (any_cdc ? 1 : 0);
                encode_mb_i16(e, cx, st, mbx, mby, modes[mb], cmodes[mb],
                              cbp_luma15, cbp_chroma);
                e.encode(*cx.qp_delta[0], 0);
                mb_i16_residual(e, cx, st, mbx, mby, cbp_luma15,
                                cbp_chroma, zdc, zac, cdc, cac);
            }
            st.avail[mb] = 1;
            bool last = (mby == n_mby - 1) && (mbx == n_mbx - 1);
            e.terminate(last ? 1 : 0);
        }
    }
    std::vector<uint8_t>& buf = bw.buf;
    e.flush_to(buf);
    if ((int64_t)buf.size() > out_cap) return -1;
    std::memcpy(out, buf.data(), buf.size());
    return (int64_t)buf.size();
}

// Partitioned CABAC P slice WITH intra macroblocks — native counterpart
// of cabac_syntax.write_pslice_cabac_intra (decoder-exact MV state).
int64_t vcp_write_pslice_cabac_intra(
    int n_mby, int n_mbx, int qp, int init_qp, int frame_num_bits,
    int frame_num, int deblock_idc, int poc_bits, int poc_lsb,
    const uint8_t* t8, int transform_8x8,
    const uint8_t* intra, const uint8_t* i8,
    const int32_t* imodes, const int32_t* icmodes,
    const int32_t* luma_dc, const int32_t* i8_modes,
    const int32_t* mv8_xy, const int32_t* parts,
    const int32_t* luma,
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    uint8_t* out, int64_t out_cap) {
    int nbx2 = 2 * n_mbx;
    HdrWriter bw;
    cabac_slice_header(bw, false, frame_num_bits, frame_num, 0, qp,
                       init_qp, deblock_idc, poc_bits, poc_lsb);
    bw.align_ones();

    CabacEnc e;
    e.bits.reserve((size_t)n_mby * n_mbx * 160);
    H264Ctxs cx(qp, true);
    MbState st(n_mby, n_mbx);
    std::vector<int8_t> i4g((size_t)16 * n_mby * n_mbx, -1);
    // decoder-exact MV state
    std::vector<int32_t> mv8g((size_t)2 * n_mby * nbx2 * 2, 0);
    std::vector<int8_t> ref8g((size_t)2 * n_mby * nbx2, -1);
    std::vector<uint8_t> dec8g((size_t)2 * n_mby * nbx2, 0);
    // per-8x8 |mvd| grid for the mvd contexts (mvd_ctx8)
    std::vector<int32_t> absmvd8((size_t)2 * n_mby * nbx2 * 2, 0);

    auto mark = [&](int by, int bx, int ph, int pw, int mx, int my,
                    int8_t ref) {
        for (int dy = 0; dy < ph; dy++)
            for (int dx = 0; dx < pw; dx++) {
                size_t i = (size_t)(by + dy) * nbx2 + bx + dx;
                mv8g[2 * i + 0] = mx;
                mv8g[2 * i + 1] = my;
                ref8g[i] = ref;
                dec8g[i] = 1;
            }
    };

    const int PT_GEO[3][2][4] = {      // pframe._P_PARTS for pt 1, 2
        {{0, 0, 2, 1}, {1, 0, 2, 1}},  // 16x8: (dy, dx, pw, ph)
        {{0, 0, 1, 2}, {0, 1, 1, 2}},
        {{0, 0, 0, 0}, {0, 0, 0, 0}},
    };

    for (int mby = 0; mby < n_mby; mby++) {
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mb = (size_t)mby * n_mbx + mbx;
            int by0 = 2 * mby, bx0 = 2 * mbx;
            bool last = (mby == n_mby - 1) && (mbx == n_mbx - 1);
            const int32_t* zl = luma + mb * 256;
            const int32_t* cdc[2] = {cb_dc + mb * 4, cr_dc + mb * 4};
            const int32_t* cac[2] = {cb_ac + mb * 64, cr_ac + mb * 64};
            if (intra[mb]) {
                e.encode(*cx.skip[st.skip_ctx(mbx, mby)], 0);
                st.avail[mb] = 1;
                if (i8[mb]) {
                    encode_mb_i8(e, cx, st, mbx, mby, i8_modes + mb * 4,
                                 zl, cdc, cac, i4g.data(), icmodes[mb],
                                 true);
                } else {
                    bool cbp_luma15 = false;
                    for (int blk = 0; blk < 16 && !cbp_luma15; blk++)
                        for (int k = 1; k < 16; k++)
                            if (zl[blk * 16 + k]) {
                                cbp_luma15 = true; break;
                            }
                    bool any_cac = false, any_cdc = false;
                    for (int c = 0; c < 2; c++) {
                        for (int k = 0; k < 4; k++)
                            if (cdc[c][k]) any_cdc = true;
                        for (int blk = 0; blk < 4; blk++)
                            for (int k = 1; k < 16; k++)
                                if (cac[c][blk * 16 + k]) any_cac = true;
                    }
                    int cbp_chroma = any_cac ? 2 : (any_cdc ? 1 : 0);
                    e.encode(*cx.mbt_p[0], 1);       // intra prefix
                    encode_mb_i16(e, cx, st, mbx, mby, imodes[mb],
                                  icmodes[mb], cbp_luma15, cbp_chroma);
                    e.encode(*cx.qp_delta[0], 0);
                    mb_i16_residual(e, cx, st, mbx, mby, cbp_luma15,
                                    cbp_chroma, luma_dc + mb * 16, zl,
                                    cdc, cac);
                }
                mark(by0, bx0, 2, 2, 0, 0, -1);
                e.terminate(last ? 1 : 0);
                continue;
            }
            int pt = parts[mb];
            int m[2] = {mv8_xy[2 * ((size_t)by0 * nbx2 + bx0) + 0],
                        mv8_xy[2 * ((size_t)by0 * nbx2 + bx0) + 1]};
            int cbp_l = 0;
            for (int blk = 0; blk < 16; blk++)
                for (int k = 0; k < 16; k++)
                    if (zl[blk * 16 + k]) { cbp_l |= 1 << (blk / 4); break; }
            bool any_cac = false, any_cdc = false;
            for (int c = 0; c < 2; c++) {
                for (int k = 0; k < 4; k++) if (cdc[c][k]) any_cdc = true;
                for (int blk = 0; blk < 4; blk++)
                    for (int k = 1; k < 16; k++)
                        if (cac[c][blk * 16 + k]) any_cac = true;
            }
            int cbp_c = any_cac ? 2 : (any_cdc ? 1 : 0);
            bool is_skip = false;
            if (pt == 0) {
                int smv[2];
                p_skip_mv_state(mv8g.data(), ref8g.data(), dec8g.data(),
                                nbx2, mby, mbx, smv);
                is_skip = cbp_l == 0 && cbp_c == 0 && smv[0] == m[0]
                    && smv[1] == m[1];
            }
            e.encode(*cx.skip[st.skip_ctx(mbx, mby)], is_skip ? 1 : 0);
            st.avail[mb] = 1;
            st.skip[mb] = is_skip ? 1 : 0;
            if (is_skip) {
                st.fill_cbp_luma8(mbx, mby, 0);
                st.cbp_chroma[mb] = 0;
                mark(by0, bx0, 2, 2, m[0], m[1], 0);
                e.terminate(last ? 1 : 0);
                continue;
            }
            auto enc_mvd8_here = [&](int by, int bx, int comp, int mvd) {
                int c0 = mvd_ctx8(absmvd8.data(), st.avail.data(), n_mbx,
                                  nbx2, by, bx, comp);
                encode_mvd8(e, cx, c0, comp, mvd);
            };
            auto set_absmvd8 = [&](int by, int bx, int ph, int pw,
                                   int ax, int ay) {
                for (int dy = 0; dy < ph; dy++)
                    for (int dx = 0; dx < pw; dx++) {
                        size_t i = (size_t)(by + dy) * nbx2 + bx + dx;
                        absmvd8[2 * i + 0] = ax;
                        absmvd8[2 * i + 1] = ay;
                    }
            };
            if (pt == 3) {
                e.encode(*cx.mbt_p[0], 0);
                e.encode(*cx.mbt_p[1], 0);
                e.encode(*cx.mbt_p[2], 1);
                for (int q = 0; q < 4; q++)
                    e.encode(cx.g[21], 1);           // sub_mb_type P_L0_8x8
                for (int q = 0; q < 4; q++) {
                    int by = by0 + (q >> 1), bx = bx0 + (q & 1);
                    size_t bi = (size_t)by * nbx2 + bx;
                    int pred[2];
                    mv_pred_state(mv8g.data(), ref8g.data(), dec8g.data(),
                                  nbx2, by, bx, 1, 1, q, pred);
                    int mvd0 = mv8_xy[2 * bi + 0] - pred[0];
                    int mvd1 = mv8_xy[2 * bi + 1] - pred[1];
                    enc_mvd8_here(by, bx, 0, mvd0);
                    enc_mvd8_here(by, bx, 1, mvd1);
                    set_absmvd8(by, bx, 1, 1,
                                mvd0 < 0 ? -mvd0 : mvd0,
                                mvd1 < 0 ? -mvd1 : mvd1);
                    mark(by, bx, 1, 1, mv8_xy[2 * bi + 0],
                         mv8_xy[2 * bi + 1], 0);
                }
            } else if (pt == 1 || pt == 2) {
                e.encode(*cx.mbt_p[0], 0);
                e.encode(*cx.mbt_p[1], 1);
                // bin2 ctx 17 (mbt_p_alt): 16x8 -> 1, 8x16 -> 0
                e.encode(cx.g[17], pt == 1 ? 1 : 0);
                for (int i = 0; i < 2; i++) {
                    int dy = PT_GEO[pt - 1][i][0];
                    int dx = PT_GEO[pt - 1][i][1];
                    int pw = PT_GEO[pt - 1][i][2];
                    int ph = PT_GEO[pt - 1][i][3];
                    int by = by0 + dy, bx = bx0 + dx;
                    size_t bi = (size_t)by * nbx2 + bx;
                    int pred[2];
                    mv_pred_state(mv8g.data(), ref8g.data(), dec8g.data(),
                                  nbx2, by, bx, pw, ph, i, pred);
                    int mvd0 = mv8_xy[2 * bi + 0] - pred[0];
                    int mvd1 = mv8_xy[2 * bi + 1] - pred[1];
                    enc_mvd8_here(by, bx, 0, mvd0);
                    enc_mvd8_here(by, bx, 1, mvd1);
                    set_absmvd8(by, bx, ph, pw,
                                mvd0 < 0 ? -mvd0 : mvd0,
                                mvd1 < 0 ? -mvd1 : mvd1);
                    mark(by, bx, ph, pw, mv8_xy[2 * bi + 0],
                         mv8_xy[2 * bi + 1], 0);
                }
            } else {
                e.encode(*cx.mbt_p[0], 0);
                e.encode(*cx.mbt_p[1], 0);
                e.encode(*cx.mbt_p[2], 0);
                int pred[2];
                mv_pred_state(mv8g.data(), ref8g.data(), dec8g.data(),
                              nbx2, by0, bx0, 2, 2, 0, pred);
                int mvd0 = m[0] - pred[0];
                int mvd1 = m[1] - pred[1];
                enc_mvd8_here(by0, bx0, 0, mvd0);
                enc_mvd8_here(by0, bx0, 1, mvd1);
                set_absmvd8(by0, bx0, 2, 2,
                            mvd0 < 0 ? -mvd0 : mvd0,
                            mvd1 < 0 ? -mvd1 : mvd1);
                mark(by0, bx0, 2, 2, m[0], m[1], 0);
            }
            for (int b8 = 0; b8 < 4; b8++) {
                int bit = (cbp_l >> b8) & 1;
                e.encode(*cx.cbp_l[st.cbp_luma_ctx(mbx, mby, b8)], bit);
                st.set_cbp_luma8(mbx, mby, b8, bit);
            }
            e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 0)],
                     cbp_c > 0 ? 1 : 0);
            if (cbp_c > 0)
                e.encode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 1)],
                         cbp_c == 2 ? 1 : 0);
            st.cbp_chroma[mb] = cbp_c;
            bool t8f = t8 && t8[mb];
            if (cbp_l > 0 && transform_8x8)
                e.encode(*cx.t8flag[st.t8_ctx(mbx, mby)], t8f ? 1 : 0);
            st.t8[mb] = t8f ? 1 : 0;
            if (cbp_l || cbp_c) e.encode(*cx.qp_delta[0], 0);
            p_residual(e, cx, st, mbx, mby, cbp_l, cbp_c, zl, cdc, cac,
                       t8f);
            e.terminate(last ? 1 : 0);
        }
    }
    std::vector<uint8_t>& buf = bw.buf;
    e.flush_to(buf);
    if ((int64_t)buf.size() > out_cap) return -1;
    std::memcpy(out, buf.data(), buf.size());
    return (int64_t)buf.size();
}

}  // extern "C"
