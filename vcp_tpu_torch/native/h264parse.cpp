// H.264 CABAC slice parser of the host decoder; copy of
// vcp_tpu/native/h264parse.cpp.
//
// The native counterpart of the parsing half of vcp_tpu's Python CABAC
// parsers (vcp_tpu/codec/h264/cabac_syntax.py, inter_cabac.py and
// mvpred.py, the names the comments below cite): parses one I/P/B CABAC
// slice payload into the decoder's defer arrays (8x8-grid MVs/refs,
// residual level scans, cbf grids, intra-MB queue), bit for bit like
// those parsers. Reconstruction follows in h264recon.cpp.
//
// Unsupported constructs (sub-8x8 partitions, I_PCM) and corrupt
// slices return a negative code, which codec/h264/native_parse.py
// raises as DecodeError.
//
// C ABI, loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#include "tables_gen.h"   // CABAC context init (m, n) pairs

namespace {

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
const uint8_t TRANS_IDX_LPS[64] = {
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
};

struct Ctx { uint8_t state, mps; };

// Arithmetic decoder (spec 9.3.3.2) — mirrors codec/cabac.py CabacDecoder.
struct CabacDec {
    const uint8_t* data;
    int64_t len;
    int64_t pos = 0;           // bit position
    uint32_t range = 510;
    uint32_t offset = 0;

    CabacDec(const uint8_t* d, int64_t n) : data(d), len(n) {
        for (int i = 0; i < 9; i++) offset = (offset << 1) | bit();
    }
    inline int bit() {
        int64_t byte_i = pos >> 3;
        uint8_t byte = byte_i < len ? data[byte_i] : 0;
        int b = (byte >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    inline int decode(Ctx& c) {
        uint32_t q = (range >> 6) & 3;
        uint32_t r_lps = RANGE_TAB_LPS[c.state][q];
        range -= r_lps;
        int binval;
        if (offset >= range) {
            offset -= range;
            range = r_lps;
            binval = c.mps ^ 1;
            if (c.state == 0) c.mps ^= 1;
            c.state = TRANS_IDX_LPS[c.state];
        } else {
            binval = c.mps;
            if (c.state < 62) c.state++;
        }
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | bit();
        }
        return binval;
    }
    inline int bypass() {
        offset = (offset << 1) | bit();
        if (offset >= range) { offset -= range; return 1; }
        return 0;
    }
    inline uint32_t bypass_bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | bypass();
        return v;
    }
    inline int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | bit();
        }
        return 0;
    }
    // Exp-Golomb-k bypass suffix (cabac_syntax._read_egk).
    inline uint32_t egk(int k) {
        uint32_t v = 0;
        while (bypass()) { v += 1u << k; k++; }
        if (k) v += bypass_bits(k);
        return v;
    }
};

// Residual block categories (ctxBlockCat).
enum { CAT_I16_DC = 0, CAT_I16_AC, CAT_LUMA4, CAT_CHROMA_DC, CAT_CHROMA_AC };

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

// Luma 4x4 coding order → (y, x) offsets (frame_ops.LUMA_BLK_ORDER).
const int BLK_Y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
const int BLK_X[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const int CBLK_Y[4] = {0, 0, 1, 1};
const int CBLK_X[4] = {0, 1, 0, 1};

// Full slice context pool with decode-side slots, keyed like
// cabac_syntax._ctx_index_map (slice_type I/P/B + cabac_init_idc).
struct ParseCtxs {
    Ctx g[VCP_N_CTX];
    Ctx *mbt_i[3], *mbt_i_tail[5];
    Ctx *mbt_p[3], *mbt_p_alt, *submbt_p[3];
    Ctx *mbt_b[3], *mbt_b_fix[3], *submbt_b[4];
    Ctx *skip[3], *chroma_mode[4], *ref_idx[6];
    Ctx *cbp_l[4], *cbp_c[8];
    Ctx *mvd[2][7];
    Ctx *cbf[5][4], *sig[5][15], *last[5][15], *absl[5][10];
    Ctx *sig8[15], *last8[9], *abs8[10], *t8flag[3];

    ParseCtxs(int slice_qp, int kind /*0=P 1=B 2=I*/, int init_idc) {
        const int8_t (*tab)[2] =
            kind == 2 ? CTX_INIT_I
                      : (init_idc == 1 ? CTX_INIT_P1
                         : (init_idc == 2 ? CTX_INIT_P2 : CTX_INIT_P0));
        int qp = slice_qp < 0 ? 0 : (slice_qp > 51 ? 51 : slice_qp);
        for (int i = 0; i < VCP_N_CTX; i++) {
            int pre = ((tab[i][0] * qp) >> 4) + tab[i][1];
            pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
            if (pre <= 63) g[i] = Ctx{(uint8_t)(63 - pre), 0};
            else g[i] = Ctx{(uint8_t)(pre - 64), 1};
        }
        static const int MBTI[3][3] = {{17, 17, 17}, {32, 32, 32},
                                       {3, 4, 5}};
        static const int TAIL[3][5] = {{18, 19, 19, 20, 20},
                                       {33, 34, 34, 35, 35},
                                       {6, 7, 8, 9, 10}};
        for (int i = 0; i < 3; i++) {
            mbt_i[i] = &g[MBTI[kind][i]];
            mbt_p[i] = &g[14 + i];
            mbt_b[i] = &g[27 + i];
            mbt_b_fix[i] = &g[30 + i];
            submbt_p[i] = &g[21 + i];
            skip[i] = &g[(kind == 1 ? 24 : 11) + i];
            t8flag[i] = &g[399 + i];
        }
        for (int i = 0; i < 5; i++) mbt_i_tail[i] = &g[TAIL[kind][i]];
        mbt_p_alt = &g[17];
        for (int i = 0; i < 4; i++) {
            submbt_b[i] = &g[36 + i];
            chroma_mode[i] = &g[64 + i];
        }
        for (int i = 0; i < 6; i++) ref_idx[i] = &g[54 + i];
        for (int i = 0; i < 4; i++) cbp_l[i] = &g[73 + i];
        for (int i = 0; i < 8; i++) cbp_c[i] = &g[77 + i];
        for (int i = 0; i < 7; i++) {
            mvd[0][i] = &g[40 + i];
            mvd[1][i] = &g[47 + i];
        }
        static const int SIG_OFF[5] = {0, 15, 29, 44, 47};
        static const int ABS_OFF[5] = {0, 10, 20, 30, 39};
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
    }
};

// Per-slice neighbor state — mirrors cabac_syntax.MbState (decode-side
// superset: 8x8-grid |mvd| per list, refgt0, i_nxn, bdirect).
struct PState {
    int n_mby, n_mbx, nbx2;
    std::vector<uint8_t> avail, skip, intra, t8, i_nxn, bdirect;
    std::vector<uint8_t> refgt0;         // (2H, 2W, 2)
    std::vector<int32_t> chroma_mode, cbp_luma8, cbp_chroma;
    std::vector<int32_t> absmvd;         // (2H, 2W, 2 lists, 2 comps)
    int8_t *cbf_l4, *cbf_cb, *cbf_cr;    // caller buffers (exported)
    std::vector<int8_t> cbf_i16dc, cbf_cdc;
    int last_qp_delta = 0;

    PState(int h, int w, int8_t* l4, int8_t* cb4, int8_t* cr4)
        : n_mby(h), n_mbx(w), nbx2(2 * w),
          avail((size_t)h * w, 0), skip((size_t)h * w, 0),
          intra((size_t)h * w, 0), t8((size_t)h * w, 0),
          i_nxn((size_t)h * w, 0), bdirect((size_t)h * w, 0),
          refgt0((size_t)8 * h * w, 0),
          chroma_mode((size_t)h * w, 0),
          cbp_luma8((size_t)4 * h * w, 0), cbp_chroma((size_t)h * w, 0),
          absmvd((size_t)16 * h * w, 0),
          cbf_l4(l4), cbf_cb(cb4), cbf_cr(cr4),
          cbf_i16dc((size_t)h * w, 0), cbf_cdc((size_t)2 * h * w, 0) {
        memset(cbf_l4, 0, (size_t)16 * h * w);
        memset(cbf_cb, 0, (size_t)4 * h * w);
        memset(cbf_cr, 0, (size_t)4 * h * w);
    }
    size_t mb(int mbx, int mby) const { return (size_t)mby * n_mbx + mbx; }

    int mbt_i_ctx(int mbx, int mby) const {
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  intra[mb(mbx - 1, mby)] && !i_nxn[mb(mbx - 1, mby)]);
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  intra[mb(mbx, mby - 1)] && !i_nxn[mb(mbx, mby - 1)]);
        return ca + cb;
    }
    int skip_ctx(int mbx, int mby) const {
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  !skip[mb(mbx - 1, mby)]);
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  !skip[mb(mbx, mby - 1)]);
        return ca + cb;
    }
    int mbt_b_ctx(int mbx, int mby) const {
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  !skip[mb(mbx - 1, mby)] && !bdirect[mb(mbx - 1, mby)]);
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  !skip[mb(mbx, mby - 1)] && !bdirect[mb(mbx, mby - 1)]);
        return ca + cb;
    }
    int chroma_mode_ctx(int mbx, int mby) const {
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  chroma_mode[mb(mbx - 1, mby)] != 0);
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  chroma_mode[mb(mbx, mby - 1)] != 0);
        return ca + cb;
    }
    int cbp_luma_ctx(int mbx, int mby, int b8) const {
        int gy = 2 * mby + b8 / 2, gx = 2 * mbx + b8 % 2;
        int ca = (gx > 0 && cbp_luma8[(size_t)gy * nbx2 + gx - 1] == 0);
        if (gx == 0) ca = 0;
        int cb = (gy > 0 && cbp_luma8[(size_t)(gy - 1) * nbx2 + gx] == 0);
        if (gy == 0) cb = 0;
        return ca + 2 * cb;
    }
    int cbp_chroma_ctx(int mbx, int mby, int binidx) const {
        bool a = mbx > 0, b = mby > 0;
        if (binidx == 0) {
            int ca = (a && cbp_chroma[mb(mbx - 1, mby)] != 0);
            int cb = (b && cbp_chroma[mb(mbx, mby - 1)] != 0);
            return ca + 2 * cb;
        }
        int ca = (a && cbp_chroma[mb(mbx - 1, mby)] == 2);
        int cb = (b && cbp_chroma[mb(mbx, mby - 1)] == 2);
        return 4 + ca + 2 * cb;
    }
    int t8_ctx(int mbx, int mby) const {
        int ca = (mbx > 0 && avail[mb(mbx - 1, mby)] &&
                  t8[mb(mbx - 1, mby)]);
        int cb = (mby > 0 && avail[mb(mbx, mby - 1)] &&
                  t8[mb(mbx, mby - 1)]);
        return ca + cb;
    }
    int ref_idx_ctx(int by, int bx, int lst) const {
        int ca = (bx > 0 && refgt0[2 * ((size_t)by * nbx2 + bx - 1) + lst]);
        int cb = (by > 0 && refgt0[2 * ((size_t)(by - 1) * nbx2 + bx) + lst]);
        return ca + 2 * cb;
    }
    int mvd_ctx(int by, int bx, int comp, int lst) const {
        int s = 0;
        if (bx > 0 && avail[mb((bx - 1) >> 1, by >> 1)])
            s += absmvd[4 * ((size_t)by * nbx2 + bx - 1) + 2 * lst + comp];
        if (by > 0 && avail[mb(bx >> 1, (by - 1) >> 1)])
            s += absmvd[4 * ((size_t)(by - 1) * nbx2 + bx) + 2 * lst + comp];
        return s < 3 ? 0 : (s <= 32 ? 1 : 2);
    }
    void set_absmvd(int by, int bx, int ph, int pw, int lst,
                    int ax, int ay) {
        for (int y = by; y < by + ph; y++)
            for (int x = bx; x < bx + pw; x++) {
                absmvd[4 * ((size_t)y * nbx2 + x) + 2 * lst + 0] = ax;
                absmvd[4 * ((size_t)y * nbx2 + x) + 2 * lst + 1] = ay;
            }
    }
    int cbf_ctx(int cat, int mbx, int mby, int blk, bool cur_intra,
                int c) const {
        int miss = cur_intra ? 1 : 0;
        int ca, cb;
        if (cat == CAT_I16_DC) {
            ca = mbx > 0 ? cbf_i16dc[mb(mbx - 1, mby)] : miss;
            cb = mby > 0 ? cbf_i16dc[mb(mbx, mby - 1)] : miss;
        } else if (cat == CAT_I16_AC || cat == CAT_LUMA4) {
            int gy = 4 * mby + BLK_Y[blk], gx = 4 * mbx + BLK_X[blk];
            int w4 = 4 * n_mbx;
            ca = gx > 0 ? cbf_l4[(size_t)gy * w4 + gx - 1] : miss;
            cb = gy > 0 ? cbf_l4[(size_t)(gy - 1) * w4 + gx] : miss;
        } else if (cat == CAT_CHROMA_DC) {
            const int8_t* gr = cbf_cdc.data() + (size_t)c * n_mby * n_mbx;
            ca = mbx > 0 ? gr[mb(mbx - 1, mby)] : miss;
            cb = mby > 0 ? gr[mb(mbx, mby - 1)] : miss;
        } else {
            int gy = 2 * mby + CBLK_Y[blk], gx = 2 * mbx + CBLK_X[blk];
            const int8_t* gr = c == 0 ? cbf_cb : cbf_cr;
            ca = gx > 0 ? gr[(size_t)gy * nbx2 + gx - 1] : miss;
            cb = gy > 0 ? gr[(size_t)(gy - 1) * nbx2 + gx] : miss;
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
            (c == 0 ? cbf_cb : cbf_cr)[(size_t)gy * nbx2 + gx] = (int8_t)val;
        }
    }
};

// residual_block_cabac (cats 0-4) — mirrors cabac_syntax._decode_block.
void decode_block(CabacDec& d, ParseCtxs& cx, PState& st, int32_t* out,
                  int n, int cat, int mbx, int mby, int blk,
                  bool cur_intra, int c) {
    memset(out, 0, n * sizeof(int32_t));
    int cbf = d.decode(*cx.cbf[cat][st.cbf_ctx(cat, mbx, mby, blk,
                                               cur_intra, c)]);
    st.set_cbf(cat, mbx, mby, blk, cbf, c);
    if (!cbf) return;
    uint8_t sig[16] = {0};
    bool found_last = false;
    int i;
    for (i = 0; i < n - 1; i++) {
        sig[i] = (uint8_t)d.decode(*cx.sig[cat][i]);
        if (sig[i] && d.decode(*cx.last[cat][i])) { found_last = true; break; }
    }
    if (!found_last) sig[n - 1] = 1;
    int neq1 = 0, ngt1 = 0;
    for (i = n - 1; i >= 0; i--) {
        if (!sig[i]) continue;
        int ctx0 = ngt1 > 0 ? 0 : (neq1 + 1 < 4 ? neq1 + 1 : 4);
        int ctx1 = 5 + (ngt1 < 4 ? ngt1 : 4);
        int v = 0;
        while (v < 14 && d.decode(*cx.absl[cat][v == 0 ? ctx0 : ctx1])) v++;
        if (v == 14) v += (int)d.egk(0);
        int sign = d.bypass();
        out[i] = sign ? -(v + 1) : (v + 1);
        if (v == 0) neq1++; else ngt1++;
    }
}

// LumaLevel8x8 (ctxBlockCat 5) — mirrors cabac_syntax._decode_block8.
void decode_block8(CabacDec& d, ParseCtxs& cx, int32_t* out) {
    memset(out, 0, 64 * sizeof(int32_t));
    uint8_t sig[64] = {0};
    bool found_last = false;
    for (int i = 0; i < 63; i++) {
        sig[i] = (uint8_t)d.decode(*cx.sig8[SIG8_MAP[i]]);
        if (sig[i] && d.decode(*cx.last8[LAST8_MAP[i]])) {
            found_last = true;
            break;
        }
    }
    if (!found_last) sig[63] = 1;
    int neq1 = 0, ngt1 = 0;
    for (int i = 63; i >= 0; i--) {
        if (!sig[i]) continue;
        int ctx0 = ngt1 > 0 ? 0 : (neq1 + 1 < 4 ? neq1 + 1 : 4);
        int ctx1 = 5 + (ngt1 < 4 ? ngt1 : 4);
        int v = 0;
        while (v < 14 && d.decode(*cx.abs8[v == 0 ? ctx0 : ctx1])) v++;
        if (v == 14) v += (int)d.egk(0);
        int sign = d.bypass();
        out[i] = sign ? -(v + 1) : (v + 1);
        if (v == 0) neq1++; else ngt1++;
    }
}

int decode_qp_delta(CabacDec& d, ParseCtxs& cx, PState& st) {
    int b0 = st.last_qp_delta != 0 ? 1 : 0;
    int k = 0;
    if (d.decode(cx.g[60 + b0])) {
        k = 1;
        if (d.decode(cx.g[62])) {
            k = 2;
            while (d.decode(cx.g[63])) k++;
        }
    }
    st.last_qp_delta = k;
    if (k == 0) return 0;
    return (k % 2) ? (k + 1) / 2 : -(k / 2);
}

int decode_chroma_mode(CabacDec& d, ParseCtxs& cx, PState& st,
                       int mbx, int mby) {
    int cm = 0;
    if (d.decode(*cx.chroma_mode[st.chroma_mode_ctx(mbx, mby)])) {
        cm = 1;
        while (cm < 3 && d.decode(*cx.chroma_mode[3])) cm++;
    }
    return cm;
}

int decode_cbp(CabacDec& d, ParseCtxs& cx, PState& st, int mbx, int mby) {
    int cbp_l = 0;
    for (int b8 = 0; b8 < 4; b8++) {
        int bit = d.decode(*cx.cbp_l[st.cbp_luma_ctx(mbx, mby, b8)]);
        cbp_l |= bit << b8;
        st.cbp_luma8[(size_t)(2 * mby + b8 / 2) * st.nbx2
                     + 2 * mbx + b8 % 2] = bit;
    }
    int cbp_c = 0;
    if (d.decode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 0)]))
        cbp_c = d.decode(*cx.cbp_c[st.cbp_chroma_ctx(mbx, mby, 1)]) ? 2 : 1;
    st.cbp_chroma[st.mb(mbx, mby)] = cbp_c;
    return cbp_l | (cbp_c << 4);
}

int decode_mvd_comp(CabacDec& d, ParseCtxs& cx, PState& st,
                    int by, int bx, int comp, int lst) {
    int b0 = st.mvd_ctx(by, bx, comp, lst);
    int v = 0;
    while (v < 9) {
        int ci = v == 0 ? b0 : (2 + v < 6 ? 2 + v : 6);
        if (!d.decode(*cx.mvd[comp][ci])) break;
        v++;
    }
    if (v == 9) v += (int)d.egk(3);
    if (v && d.bypass()) return -v;
    return v;
}

// ---------------------------------------------------------------------------
// Output view + MV prediction (mirrors mvpred.py on the output grids)
// ---------------------------------------------------------------------------

struct Out {
    int n_mby, n_mbx, nbx2;
    int32_t *mv8[2];
    int8_t *ref8[2];
    uint8_t *dec8;
    uint8_t *intra_mb, *mv_valid;
    int32_t *qp_mb;
    uint8_t *p_t8;
    int32_t *z_luma;   // (nMB, 256)
    int32_t *cdc;      // (nMB, 8)
    int32_t *cac;      // (nMB, 128)
    size_t b(int by, int bx) const { return (size_t)by * nbx2 + bx; }
    size_t mb(int mbx, int mby) const { return (size_t)mby * n_mbx + mbx; }
};

struct Nbr { int mvx, mvy, ref; bool ok; };

inline Nbr get_nb(const Out& o, int lst, int by, int bx) {
    if (by < 0 || bx < 0 || bx >= o.nbx2) return {0, 0, 0, false};
    size_t i = o.b(by, bx);
    if (!o.dec8[i]) return {0, 0, 0, false};
    return {o.mv8[lst][2 * i], o.mv8[lst][2 * i + 1], o.ref8[lst][i], true};
}

// 8.4.1.3 luma MV prediction — mirrors mvpred.mv_pred.
void mv_pred(const Out& o, int lst, int by, int bx, int pw, int ph,
             int ref_idx, int part_idx, int* px, int* py) {
    Nbr a = get_nb(o, lst, by, bx - 1);
    Nbr b = get_nb(o, lst, by - 1, bx);
    Nbr c = get_nb(o, lst, by - 1, bx + pw);
    if (!c.ok) c = get_nb(o, lst, by - 1, bx - 1);

    if (pw == 2 && ph == 1) {                       // 16x8
        if (part_idx == 0 && b.ok && b.ref == ref_idx) {
            *px = b.mvx; *py = b.mvy; return;
        }
        if (part_idx == 1 && a.ok && a.ref == ref_idx) {
            *px = a.mvx; *py = a.mvy; return;
        }
    } else if (pw == 1 && ph == 2) {                // 8x16
        if (part_idx == 0 && a.ok && a.ref == ref_idx) {
            *px = a.mvx; *py = a.mvy; return;
        }
        if (part_idx == 1 && c.ok && c.ref == ref_idx) {
            *px = c.mvx; *py = c.mvy; return;
        }
    }
    if (!b.ok && !c.ok && a.ok) { *px = a.mvx; *py = a.mvy; return; }

    const Nbr* match = nullptr;
    int nmatch = 0;
    for (const Nbr* n : {&a, &b, &c})
        if (n->ok && n->ref == ref_idx) { match = n; nmatch++; }
    if (nmatch == 1) { *px = match->mvx; *py = match->mvy; return; }

    int xs[3], ys[3];
    const Nbr* ns[3] = {&a, &b, &c};
    for (int i = 0; i < 3; i++) {
        bool use = ns[i]->ok && ns[i]->ref >= 0;
        xs[i] = use ? ns[i]->mvx : 0;
        ys[i] = use ? ns[i]->mvy : 0;
    }
    auto med3 = [](int u, int v, int w) {
        int lo = u < v ? u : v, hi = u < v ? v : u;
        return w < lo ? lo : (w > hi ? hi : w);
    };
    *px = med3(xs[0], xs[1], xs[2]);
    *py = med3(ys[0], ys[1], ys[2]);
}

void set_part(Out& o, int by, int bx, int pw, int ph, int ref,
              int mvx, int mvy, int lst) {
    for (int y = by; y < by + ph; y++)
        for (int x = bx; x < bx + pw; x++) {
            size_t i = o.b(y, x);
            o.mv8[lst][2 * i] = mvx;
            o.mv8[lst][2 * i + 1] = mvy;
            o.ref8[lst][i] = (int8_t)ref;
            o.dec8[i] = 1;
        }
}

// 8.4.1.1 P_Skip MV — mirrors mvpred.p_skip_mv.
void p_skip_mv(const Out& o, int mby, int mbx, int* px, int* py) {
    int by = 2 * mby, bx = 2 * mbx;
    Nbr a = get_nb(o, 0, by, bx - 1);
    Nbr b = get_nb(o, 0, by - 1, bx);
    if (!a.ok || !b.ok) { *px = 0; *py = 0; return; }
    if (a.ref == 0 && a.mvx == 0 && a.mvy == 0) { *px = 0; *py = 0; return; }
    if (b.ref == 0 && b.mvx == 0 && b.mvy == 0) { *px = 0; *py = 0; return; }
    mv_pred(o, 0, by, bx, 2, 2, 0, 0, px, py);
}

// 8.4.1.2.2 spatial direct for one MB — mirrors mvpred.direct_spatial_refs
// + bframe.b_direct_mb.
void b_direct_mb(Out& o, int mbx, int mby, const uint8_t* col_ref0,
                 const int32_t* col_mv8, uint32_t blocks_mask) {
    int by = 2 * mby, bx = 2 * mbx;
    int refs[2], mvx[2], mvy[2];
    for (int lst = 0; lst < 2; lst++) {
        Nbr a = get_nb(o, lst, by, bx - 1);
        Nbr b = get_nb(o, lst, by - 1, bx);
        Nbr c = get_nb(o, lst, by - 1, bx + 2);
        if (!c.ok) c = get_nb(o, lst, by - 1, bx - 1);
        int r = -1;
        for (const Nbr* n : {&a, &b, &c})
            if (n->ok && n->ref >= 0 && (r < 0 || n->ref < r)) r = n->ref;
        refs[lst] = r;
    }
    bool zero = refs[0] < 0 && refs[1] < 0;
    if (zero) { refs[0] = refs[1] = 0; mvx[0] = mvy[0] = mvx[1] = mvy[1] = 0; }
    else {
        for (int lst = 0; lst < 2; lst++) {
            if (refs[lst] >= 0)
                mv_pred(o, lst, by, bx, 2, 2, refs[lst], 0,
                        &mvx[lst], &mvy[lst]);
            else { mvx[lst] = 0; mvy[lst] = 0; }
        }
    }
    for (int q = 0; q < 4; q++) {
        if (!(blocks_mask & (1u << q))) continue;
        int qy = by + (q >> 1), qx = bx + (q & 1);
        int m0x = mvx[0], m0y = mvy[0], m1x = mvx[1], m1y = mvy[1];
        if (!zero && col_ref0 != nullptr) {
            size_t ci = (size_t)qy * o.nbx2 + qx;
            bool colzero = col_ref0[ci] &&
                (col_mv8[2 * ci] < 0 ? -col_mv8[2 * ci]
                                     : col_mv8[2 * ci]) <= 1 &&
                (col_mv8[2 * ci + 1] < 0 ? -col_mv8[2 * ci + 1]
                                         : col_mv8[2 * ci + 1]) <= 1;
            if (colzero) {
                if (refs[0] == 0) { m0x = 0; m0y = 0; }
                if (refs[1] == 0) { m1x = 0; m1y = 0; }
            }
        }
        if (refs[0] >= 0) set_part(o, qy, qx, 1, 1, refs[0], m0x, m0y, 0);
        if (refs[1] >= 0) set_part(o, qy, qx, 1, 1, refs[1], m1x, m1y, 1);
        o.dec8[o.b(qy, qx)] = 1;
    }
    o.mv_valid[o.mb(mbx, mby)] = 1;
}

int read_ref_idx(CabacDec& d, ParseCtxs& cx, PState& st,
                 int by, int bx, int lst) {
    if (!d.decode(*cx.ref_idx[st.ref_idx_ctx(by, bx, lst)])) return 0;
    int v = 1;
    while (d.decode(*cx.ref_idx[v == 1 ? 4 : 5])) {
        v++;
        if (v >= 32) return -1;
    }
    return v;
}

// mb_type trees (Table 9-37) — mirror inter_cabac._decode_*_mb_type.
int decode_p_mb_type(CabacDec& d, ParseCtxs& cx) {
    if (d.decode(*cx.mbt_p[0])) return -1;             // intra suffix
    if (d.decode(*cx.mbt_p[1]))
        return d.decode(*cx.mbt_p_alt) ? 1 : 2;
    return d.decode(*cx.mbt_p[2]) ? 3 : 0;
}

int decode_b_mb_type(CabacDec& d, ParseCtxs& cx, PState& st,
                     int mbx, int mby) {
    if (!d.decode(*cx.mbt_b[st.mbt_b_ctx(mbx, mby)])) return 0;
    if (!d.decode(*cx.mbt_b_fix[0]))
        return 1 + d.decode(*cx.mbt_b_fix[2]);
    int bits = d.decode(*cx.mbt_b_fix[1]) << 3;
    bits |= d.decode(*cx.mbt_b_fix[2]) << 2;
    bits |= d.decode(*cx.mbt_b_fix[2]) << 1;
    bits |= d.decode(*cx.mbt_b_fix[2]);
    if (bits < 8) return bits + 3;
    if (bits == 13) return -1;                         // intra suffix
    if (bits == 14) return 11;
    if (bits == 15) return 22;                         // B_8x8
    bits = (bits << 1) | d.decode(*cx.mbt_b_fix[2]);
    return bits - 4;
}

int decode_p_sub_type(CabacDec& d, ParseCtxs& cx) {
    if (d.decode(*cx.submbt_p[0])) return 0;           // P_L0_8x8
    if (!d.decode(*cx.submbt_p[1])) return 1;
    return d.decode(*cx.submbt_p[2]) ? 2 : 3;
}

int decode_b_sub_type(CabacDec& d, ParseCtxs& cx) {
    if (!d.decode(*cx.submbt_b[0])) return 0;          // B_Direct_8x8
    if (!d.decode(*cx.submbt_b[1]))
        return 1 + d.decode(*cx.submbt_b[3]);
    int t = 3;
    if (d.decode(*cx.submbt_b[2])) {
        if (d.decode(*cx.submbt_b[3]))
            return 11 + d.decode(*cx.submbt_b[3]);
        t += 4;
    }
    t += 2 * d.decode(*cx.submbt_b[3]);
    t += d.decode(*cx.submbt_b[3]);
    return t;
}

// bframe._B_TWO_PART: (vertical, mask0, mask1) for B mb_type 4..21.
const uint8_t B_TWO_PART[18][3] = {
    {0, 1, 1}, {1, 1, 1}, {0, 2, 2}, {1, 2, 2}, {0, 1, 2}, {1, 1, 2},
    {0, 2, 1}, {1, 2, 1}, {0, 1, 3}, {1, 1, 3}, {0, 2, 3}, {1, 2, 3},
    {0, 3, 1}, {1, 3, 1}, {0, 3, 2}, {1, 3, 2}, {0, 3, 3}, {1, 3, 3},
};

// pframe._P_PARTS on the 8x8 grid: mb_type 0..2 (dy, dx, pw, ph).
const int P_PARTS[3][2][4] = {
    {{0, 0, 2, 2}, {0, 0, 0, 0}},
    {{0, 0, 2, 1}, {1, 0, 2, 1}},
    {{0, 0, 1, 2}, {0, 1, 1, 2}},
};
const int P_NPARTS[3] = {1, 2, 2};

struct Part { int by, bx, pw, ph, pi, mask; };

// residual walk for an inter MB — mirrors cabac_syntax._p_residual.
void p_residual(CabacDec& d, ParseCtxs& cx, PState& st, int mbx, int mby,
                int cbp_l, int cbp_c, bool t8f, bool cur_intra,
                int32_t* luma, int32_t* cdc, int32_t* cac) {
    if (t8f) {
        for (int b8 = 0; b8 < 4; b8++) {
            int bit = (cbp_l >> b8) & 1;
            if (bit) decode_block8(d, cx, luma + 64 * b8);
            int gy = 4 * mby + 2 * (b8 / 2), gx = 4 * mbx + 2 * (b8 % 2);
            int w4 = 4 * st.n_mbx;
            for (int yy = 0; yy < 2; yy++)
                for (int xx = 0; xx < 2; xx++)
                    st.cbf_l4[(size_t)(gy + yy) * w4 + gx + xx] =
                        (int8_t)bit;
        }
    } else {
        for (int blk = 0; blk < 16; blk++) {
            int b8 = blk / 4;
            if ((cbp_l >> b8) & 1)
                decode_block(d, cx, st, luma + 16 * blk, 16, CAT_LUMA4,
                             mbx, mby, blk, cur_intra, 0);
            else
                st.set_cbf(CAT_LUMA4, mbx, mby, blk, 0, 0);
        }
    }
    if (cbp_c) {
        for (int c = 0; c < 2; c++)
            decode_block(d, cx, st, cdc + 4 * c, 4, CAT_CHROMA_DC,
                         mbx, mby, 0, cur_intra, c);
    } else {
        for (int c = 0; c < 2; c++)
            st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c);
    }
    for (int c = 0; c < 2; c++)
        for (int blk = 0; blk < 4; blk++) {
            if (cbp_c == 2)
                decode_block(d, cx, st, cac + 64 * c + 16 * blk + 1, 15,
                             CAT_CHROMA_AC, mbx, mby, blk, cur_intra, c);
            else
                st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c);
        }
}

// I16x16 residual walk — mirrors cabac_syntax._mb_i16_residual (decode).
void i16_residual(CabacDec& d, ParseCtxs& cx, PState& st, int mbx, int mby,
                  bool cbp_l15, int cbp_c, int32_t* dc_zz, int32_t* ac,
                  int32_t* cdc, int32_t* cac) {
    decode_block(d, cx, st, dc_zz, 16, CAT_I16_DC, mbx, mby, 0, true, 0);
    for (int blk = 0; blk < 16; blk++) {
        if (cbp_l15)
            decode_block(d, cx, st, ac + 16 * blk + 1, 15, CAT_I16_AC,
                         mbx, mby, blk, true, 0);
        else
            st.set_cbf(CAT_I16_AC, mbx, mby, blk, 0, 0);
    }
    if (cbp_c) {
        for (int c = 0; c < 2; c++)
            decode_block(d, cx, st, cdc + 4 * c, 4, CAT_CHROMA_DC,
                         mbx, mby, 0, true, c);
    } else {
        for (int c = 0; c < 2; c++)
            st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c);
    }
    for (int c = 0; c < 2; c++)
        for (int blk = 0; blk < 4; blk++) {
            if (cbp_c == 2)
                decode_block(d, cx, st, cac + 64 * c + 16 * blk + 1, 15,
                             CAT_CHROMA_AC, mbx, mby, blk, true, c);
            else
                st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c);
        }
}

// Error codes.
enum {
    ERR_SUB8 = -1,       // sub-8x8 partitions
    ERR_IPCM = -2,       // I_PCM macroblock
    ERR_TERM = -3,       // terminate-bin / MB count mismatch
    ERR_REF = -4,        // ref_idx out of range
};

}  // namespace

extern "C" {

// Parse one CABAC slice payload. Returns the number of intra-queue
// entries (>= 0) or a negative error code (see ERR_* above). The
// Python side is codec/h264/native_parse.py.
int64_t vcp_parse_slice_cabac(
    const uint8_t* payload, int64_t payload_len,
    int32_t slice_kind,          // 0=P, 1=B, 2=I
    int32_t qp, int32_t init_idc, int32_t n_mby, int32_t n_mbx,
    int32_t pps_t8, int32_t n_ref0, int32_t n_ref1,
    const uint8_t* col_ref0, const int32_t* col_mv8,   // NULL when absent
    // outputs (caller-allocated, zero- or default-initialized by us):
    int32_t* mv8_l0, int8_t* ref8_l0,
    int32_t* mv8_l1, int8_t* ref8_l1,
    uint8_t* dec8,
    uint8_t* intra_mb, uint8_t* mv_valid, int32_t* qp_mb, uint8_t* p_t8,
    int32_t* z_luma, int32_t* cdc_a, int32_t* cac_a,
    int8_t* cbf_l4, int8_t* cbf_cb, int8_t* cbf_cr,
    // intra queue (capacity n_mby*n_mbx each):
    int32_t* iq_mb,              // mby * n_mbx + mbx, raster-parse order
    int32_t* iq_info,            // (count, 4): kind(0=i16,1=i4,2=i8),
                                 //             pred_mode, chroma_mode, qp
    int8_t* iq_modes,            // (count, 16) I_NxN per-block modes
    int32_t* iq_dc) {            // (count, 16) I16 DC scan
    const bool is_b = slice_kind == 1;
    const bool is_i = slice_kind == 2;
    const int nbx2 = 2 * n_mbx;
    const size_t n_mb = (size_t)n_mby * n_mbx;

    CabacDec dec(payload, payload_len);
    ParseCtxs cx(qp, slice_kind, init_idc);
    PState st(n_mby, n_mbx, cbf_l4, cbf_cb, cbf_cr);

    Out o;
    o.n_mby = n_mby; o.n_mbx = n_mbx; o.nbx2 = nbx2;
    o.mv8[0] = mv8_l0; o.ref8[0] = ref8_l0;
    o.mv8[1] = mv8_l1; o.ref8[1] = ref8_l1;
    o.dec8 = dec8;
    o.intra_mb = intra_mb; o.mv_valid = mv_valid;
    o.qp_mb = qp_mb; o.p_t8 = p_t8;
    o.z_luma = z_luma; o.cdc = cdc_a; o.cac = cac_a;

    memset(dec8, 0, 4 * n_mb);
    memset(intra_mb, 0, n_mb);
    memset(mv_valid, 0, n_mb);
    memset(z_luma, 0, n_mb * 256 * sizeof(int32_t));
    memset(cdc_a, 0, n_mb * 8 * sizeof(int32_t));
    memset(cac_a, 0, n_mb * 128 * sizeof(int32_t));
    if (!is_i) {
        memset(mv8_l0, 0, 8 * n_mb * sizeof(int32_t));
        memset(ref8_l0, -1, 4 * n_mb);
        if (is_b) {
            memset(mv8_l1, 0, 8 * n_mb * sizeof(int32_t));
            memset(ref8_l1, -1, 4 * n_mb);
        }
    }
    for (size_t i = 0; i < n_mb; i++) qp_mb[i] = qp;

    // I_NxN 4x4-mode grid (-1 = not I_NxN) for mode prediction.
    std::vector<int8_t> i4g((size_t)16 * n_mb, -1);
    const int w4 = 4 * n_mbx;

    int cur_qp = qp;
    int64_t iq_count = 0;

    // Shared intra-MB parse (mb_type intra prefix already consumed).
    // Mirrors inter_cabac._parse_intra_mb / the islice MB body.
    auto parse_intra = [&](int mbx, int mby) -> int64_t {
        size_t mi = o.mb(mbx, mby);
        int64_t slot = iq_count++;
        iq_mb[slot] = (int32_t)mi;
        int32_t* info = iq_info + 4 * slot;
        int b0 = st.mbt_i_ctx(mbx, mby);
        if (dec.decode(*cx.mbt_i[b0]) == 0) {
            // ---- I_NxN (mirrors cabac_syntax._parse_i_nxn)
            st.intra[mi] = 1;
            st.i_nxn[mi] = 1;
            bool t8f = false;
            if (pps_t8)
                t8f = dec.decode(*cx.t8flag[st.t8_ctx(mbx, mby)]);
            st.t8[mi] = t8f ? 1 : 0;
            int n_blocks = t8f ? 4 : 16;
            int raw[16];                    // rem mode or -1 (use pred)
            for (int i = 0; i < n_blocks; i++) {
                if (dec.decode(cx.g[68])) raw[i] = -1;
                else
                    raw[i] = dec.decode(cx.g[69])
                        | (dec.decode(cx.g[69]) << 1)
                        | (dec.decode(cx.g[69]) << 2);
            }
            int8_t* modes = iq_modes + 16 * slot;
            if (t8f) {
                for (int b8 = 0; b8 < 4; b8++) {
                    int by = 4 * mby + 2 * (b8 / 2);
                    int bx = 4 * mbx + 2 * (b8 % 2);
                    int pred;
                    if (bx == 0 || by == 0) pred = 2;
                    else {
                        int a = i4g[(size_t)by * w4 + bx - 1];
                        int b = i4g[(size_t)(by - 1) * w4 + bx];
                        int av = a >= 0 ? a : 2, bv = b >= 0 ? b : 2;
                        pred = av < bv ? av : bv;
                    }
                    int rem = raw[b8];
                    int mode = rem < 0 ? pred : (rem < pred ? rem : rem + 1);
                    for (int k = 0; k < 4; k++) modes[4 * b8 + k] = (int8_t)mode;
                    for (int yy = 0; yy < 2; yy++)
                        for (int xx = 0; xx < 2; xx++)
                            i4g[(size_t)(by + yy) * w4 + bx + xx] =
                                (int8_t)mode;
                }
            } else {
                for (int blk = 0; blk < 16; blk++) {
                    int by = 4 * mby + BLK_Y[blk];
                    int bx = 4 * mbx + BLK_X[blk];
                    int pred;
                    if (bx == 0 || by == 0) pred = 2;
                    else {
                        int a = i4g[(size_t)by * w4 + bx - 1];
                        int b = i4g[(size_t)(by - 1) * w4 + bx];
                        int av = a >= 0 ? a : 2, bv = b >= 0 ? b : 2;
                        pred = av < bv ? av : bv;
                    }
                    int rem = raw[blk];
                    int mode = rem < 0 ? pred : (rem < pred ? rem : rem + 1);
                    modes[blk] = (int8_t)mode;
                    i4g[(size_t)by * w4 + bx] = (int8_t)mode;
                }
            }
            int chroma_mode = decode_chroma_mode(dec, cx, st, mbx, mby);
            st.chroma_mode[mi] = chroma_mode;
            int cbp = decode_cbp(dec, cx, st, mbx, mby);
            int cbp_l = cbp & 15, cbp_c = cbp >> 4;
            int delta;
            if (cbp) delta = decode_qp_delta(dec, cx, st);
            else { delta = 0; st.last_qp_delta = 0; }
            cur_qp = ((cur_qp + delta) % 52 + 52) % 52;
            int32_t* luma = z_luma + 256 * mi;
            if (t8f) {
                for (int b8 = 0; b8 < 4; b8++) {
                    int bit = (cbp_l >> b8) & 1;
                    if (bit) decode_block8(dec, cx, luma + 64 * b8);
                    int gy = 4 * mby + 2 * (b8 / 2);
                    int gx = 4 * mbx + 2 * (b8 % 2);
                    for (int yy = 0; yy < 2; yy++)
                        for (int xx = 0; xx < 2; xx++)
                            st.cbf_l4[(size_t)(gy + yy) * w4 + gx + xx] =
                                (int8_t)bit;
                }
            } else {
                for (int blk = 0; blk < 16; blk++) {
                    if ((cbp_l >> blk / 4) & 1)
                        decode_block(dec, cx, st, luma + 16 * blk, 16,
                                     CAT_LUMA4, mbx, mby, blk, true, 0);
                    else
                        st.set_cbf(CAT_LUMA4, mbx, mby, blk, 0, 0);
                }
            }
            int32_t* cdc = cdc_a + 8 * mi;
            int32_t* cac = cac_a + 128 * mi;
            if (cbp_c) {
                for (int c = 0; c < 2; c++)
                    decode_block(dec, cx, st, cdc + 4 * c, 4,
                                 CAT_CHROMA_DC, mbx, mby, 0, true, c);
            } else {
                for (int c = 0; c < 2; c++)
                    st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c);
            }
            for (int c = 0; c < 2; c++)
                for (int blk = 0; blk < 4; blk++) {
                    if (cbp_c == 2)
                        decode_block(dec, cx, st,
                                     cac + 64 * c + 16 * blk + 1, 15,
                                     CAT_CHROMA_AC, mbx, mby, blk, true, c);
                    else
                        st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c);
                }
            info[0] = t8f ? 2 : 1;
            info[1] = 0;
            info[2] = chroma_mode;
            info[3] = cur_qp;
        } else {
            // ---- Intra_16x16
            if (dec.terminate()) return ERR_IPCM;
            int cbp_l15 = dec.decode(*cx.mbt_i_tail[0]);
            int cbp_c = 0;
            if (dec.decode(*cx.mbt_i_tail[1]))
                cbp_c = dec.decode(*cx.mbt_i_tail[2]) ? 2 : 1;
            int pred_mode = (dec.decode(*cx.mbt_i_tail[3]) << 1)
                | dec.decode(*cx.mbt_i_tail[4]);
            int chroma_mode = decode_chroma_mode(dec, cx, st, mbx, mby);
            st.intra[mi] = 1;
            st.chroma_mode[mi] = chroma_mode;
            for (int yy = 0; yy < 2; yy++)
                for (int xx = 0; xx < 2; xx++)
                    st.cbp_luma8[(size_t)(2 * mby + yy) * nbx2
                                 + 2 * mbx + xx] = cbp_l15 ? 1 : 0;
            st.cbp_chroma[mi] = cbp_c;
            cur_qp = ((cur_qp + decode_qp_delta(dec, cx, st)) % 52 + 52)
                % 52;
            i16_residual(dec, cx, st, mbx, mby, cbp_l15 != 0, cbp_c,
                         iq_dc + 16 * slot, z_luma + 256 * mi,
                         cdc_a + 8 * mi, cac_a + 128 * mi);
            info[0] = 0;
            info[1] = pred_mode;
            info[2] = chroma_mode;
            info[3] = cur_qp;
        }
        intra_mb[mi] = 1;
        mv_valid[mi] = 0;
        qp_mb[mi] = cur_qp;
        if (!is_i) {
            // inter slices mark the whole MB decoded (intra blocks
            // contribute ref -1 to MV prediction)
            for (int yy = 0; yy < 2; yy++)
                for (int xx = 0; xx < 2; xx++)
                    dec8[o.b(2 * mby + yy, 2 * mbx + xx)] = 1;
        }
        return 0;
    };

    for (int mby = 0; mby < n_mby; mby++) {
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mi = o.mb(mbx, mby);
            bool last = mby == n_mby - 1 && mbx == n_mbx - 1;

            if (is_i) {
                int64_t e = parse_intra(mbx, mby);
                if (e < 0) return e;
                st.avail[mi] = 1;
                if (dec.terminate() != (last ? 1 : 0)) return ERR_TERM;
                continue;
            }

            int is_skip = dec.decode(*cx.skip[st.skip_ctx(mbx, mby)]);
            st.avail[mi] = 1;
            st.skip[mi] = (uint8_t)is_skip;
            int by0 = 2 * mby, bx0 = 2 * mbx;
            if (is_skip) {
                for (int yy = 0; yy < 2; yy++)
                    for (int xx = 0; xx < 2; xx++)
                        st.cbp_luma8[(size_t)(by0 + yy) * nbx2 + bx0 + xx]
                            = 0;
                st.cbp_chroma[mi] = 0;
                st.last_qp_delta = 0;
                if (is_b) {
                    b_direct_mb(o, mbx, mby, col_ref0, col_mv8, 0xF);
                } else {
                    int mx, my;
                    p_skip_mv(o, mby, mbx, &mx, &my);
                    set_part(o, by0, bx0, 2, 2, 0, mx, my, 0);
                    mv_valid[mi] = 1;
                }
                qp_mb[mi] = cur_qp;
                if (dec.terminate() != (last ? 1 : 0)) return ERR_TERM;
                continue;
            }

            int mb_type = is_b ? decode_b_mb_type(dec, cx, st, mbx, mby)
                               : decode_p_mb_type(dec, cx);
            if (mb_type < 0) {                          // intra suffix
                int64_t e = parse_intra(mbx, mby);
                if (e < 0) return e;
                if (dec.terminate() != (last ? 1 : 0)) return ERR_TERM;
                continue;
            }

            Part parts[4];
            int n_parts = 0;
            if (!is_b) {
                if (mb_type == 3) {                     // P_8x8
                    for (int q = 0; q < 4; q++)
                        if (decode_p_sub_type(dec, cx) != 0) return ERR_SUB8;
                    for (int q = 0; q < 4; q++)
                        parts[n_parts++] =
                            {by0 + (q >> 1), bx0 + (q & 1), 1, 1, q, 1};
                } else {
                    for (int i = 0; i < P_NPARTS[mb_type]; i++) {
                        const int* p = P_PARTS[mb_type][i];
                        parts[n_parts++] = {by0 + p[0], bx0 + p[1],
                                            p[2], p[3], i, 1};
                    }
                }
            } else if (mb_type == 0) {                  // B_Direct_16x16
                st.bdirect[mi] = 1;
                b_direct_mb(o, mbx, mby, col_ref0, col_mv8, 0xF);
            } else if (mb_type <= 3) {
                parts[n_parts++] = {by0, bx0, 2, 2, 0, mb_type};
            } else if (mb_type <= 21) {
                const uint8_t* tp = B_TWO_PART[mb_type - 4];
                if (tp[0]) {                            // vertical (8x16)
                    parts[n_parts++] = {by0, bx0, 1, 2, 0, tp[1]};
                    parts[n_parts++] = {by0, bx0 + 1, 1, 2, 1, tp[2]};
                } else {
                    parts[n_parts++] = {by0, bx0, 2, 1, 0, tp[1]};
                    parts[n_parts++] = {by0 + 1, bx0, 2, 1, 1, tp[2]};
                }
            } else {                                    // B_8x8
                for (int q = 0; q < 4; q++) {
                    int s = decode_b_sub_type(dec, cx);
                    if (s > 3) return ERR_SUB8;
                    if (s == 0)
                        b_direct_mb(o, mbx, mby, col_ref0, col_mv8,
                                    1u << q);
                    else
                        parts[n_parts++] = {by0 + (q >> 1), bx0 + (q & 1),
                                            1, 1, q, s};  // _B_SUB_MODE[s]=s
                }
            }

            // Syntax order 7.3.5.1: all ref_idx per list, then all mvd
            // per list — mirrors inter_cabac.parse_parts.
            int refs[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
            int n_act[2] = {n_ref0, n_ref1};
            for (int lst = 0; lst < (is_b ? 2 : 1); lst++)
                for (int i = 0; i < n_parts; i++) {
                    const Part& p = parts[i];
                    if (!(p.mask & (1 << lst))) continue;
                    if (n_act[lst] > 1) {
                        int r = read_ref_idx(dec, cx, st, p.by, p.bx, lst);
                        if (r < 0) return ERR_REF;
                        refs[i][lst] = r;
                    }
                    for (int y = p.by; y < p.by + p.ph; y++)
                        for (int x = p.bx; x < p.bx + p.pw; x++)
                            st.refgt0[2 * ((size_t)y * nbx2 + x) + lst] =
                                refs[i][lst] > 0;
                }
            for (int lst = 0; lst < (is_b ? 2 : 1); lst++)
                for (int i = 0; i < n_parts; i++) {
                    const Part& p = parts[i];
                    if (!(p.mask & (1 << lst))) continue;
                    int mvd_x = decode_mvd_comp(dec, cx, st, p.by, p.bx,
                                                0, lst);
                    int mvd_y = decode_mvd_comp(dec, cx, st, p.by, p.bx,
                                                1, lst);
                    st.set_absmvd(p.by, p.bx, p.ph, p.pw, lst,
                                  mvd_x < 0 ? -mvd_x : mvd_x,
                                  mvd_y < 0 ? -mvd_y : mvd_y);
                    int px, py;
                    mv_pred(o, lst, p.by, p.bx, p.pw, p.ph, refs[i][lst],
                            p.pi, &px, &py);
                    set_part(o, p.by, p.bx, p.pw, p.ph, refs[i][lst],
                             px + mvd_x, py + mvd_y, lst);
                }
            if (n_parts > 0) mv_valid[mi] = 1;
            if (is_b && (mb_type == 0 || mb_type == 22)) mv_valid[mi] = 1;

            int cbp = decode_cbp(dec, cx, st, mbx, mby);
            int cbp_l = cbp & 15, cbp_c = cbp >> 4;
            bool t8f = false;
            if (cbp_l > 0 && pps_t8)
                t8f = dec.decode(*cx.t8flag[st.t8_ctx(mbx, mby)]);
            st.t8[mi] = t8f ? 1 : 0;
            if (cbp) {
                int delta = decode_qp_delta(dec, cx, st);
                cur_qp = ((cur_qp + delta) % 52 + 52) % 52;
            } else {
                st.last_qp_delta = 0;
            }
            qp_mb[mi] = cur_qp;
            p_residual(dec, cx, st, mbx, mby, cbp_l, cbp_c, t8f, false,
                       z_luma + 256 * mi, cdc_a + 8 * mi, cac_a + 128 * mi);
            if (dec.terminate() != (last ? 1 : 0)) return ERR_TERM;
        }
    }

    // Export st.t8 (covers both inter t8 MBs and I_NxN-8x8 MBs).
    for (size_t i = 0; i < n_mb; i++) p_t8[i] = st.t8[i];
    return iq_count;
}

}  // extern "C"
