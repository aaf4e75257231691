// H.264 reconstruction of the host decoder; copy of
// vcp_tpu/native/h264recon.cpp.
//
// The native counterpart of vcp_tpu/codec/h264/inter_recon.py (full-picture
// inter prediction: quarter-pel luma MC, 1/8-pel bilinear chroma MC,
// multi-reference lists, explicit/implicit weighted prediction,
// per-MB-QP residual dequant + idct 4x4/8x8) and of the decoder's per-MB
// intra reconstruction (decoder._recon_intra_mb: I16/I4x4/I8x8
// prediction incl. filtered 8x8 references, chroma modes, DC
// transforms), bit for bit like vcp_tpu's numpy versions.
//
// C ABI, loaded via ctypes.

#include <cstdint>
#include <cstring>

#include "tables_gen.h"

namespace {

inline int32_t clampi(int32_t v, int32_t lo, int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
inline int32_t clip255(int32_t v) { return clampi(v, 0, 255); }

// ---------------------------------------------------------------------------
// Transforms (mirror ops/transform.py + transform8.py numpy twins)
// ---------------------------------------------------------------------------

void idct4(int32_t w[16], int32_t out[16]) {
    int32_t y[16];
    for (int r = 0; r < 4; r++) {
        const int32_t* t = w + 4 * r;
        int32_t e0 = t[0] + t[2], e1 = t[0] - t[2];
        int32_t e2 = (t[1] >> 1) - t[3], e3 = t[1] + (t[3] >> 1);
        y[4 * r + 0] = e0 + e3;
        y[4 * r + 1] = e1 + e2;
        y[4 * r + 2] = e1 - e2;
        y[4 * r + 3] = e0 - e3;
    }
    for (int c = 0; c < 4; c++) {
        int32_t e0 = y[c] + y[8 + c], e1 = y[c] - y[8 + c];
        int32_t e2 = (y[4 + c] >> 1) - y[12 + c];
        int32_t e3 = y[4 + c] + (y[12 + c] >> 1);
        out[c] = (e0 + e3 + 32) >> 6;
        out[4 + c] = (e1 + e2 + 32) >> 6;
        out[8 + c] = (e1 - e2 + 32) >> 6;
        out[12 + c] = (e0 - e3 + 32) >> 6;
    }
}

// Mirrors tf.hadamard4_np: rows pass first (a = x[0,:] + x[3,:] over
// columns), then the columns pass.
void hadamard4_np(const int32_t x[16], int32_t out[16]) {
    int32_t y[16];
    for (int c = 0; c < 4; c++) {                  // rows pass
        int32_t a = x[0 * 4 + c] + x[3 * 4 + c];
        int32_t b = x[1 * 4 + c] + x[2 * 4 + c];
        int32_t cc = x[1 * 4 + c] - x[2 * 4 + c];
        int32_t d = x[0 * 4 + c] - x[3 * 4 + c];
        y[0 * 4 + c] = a + b; y[1 * 4 + c] = d + cc;
        y[2 * 4 + c] = a - b; y[3 * 4 + c] = d - cc;
    }
    for (int r = 0; r < 4; r++) {                  // columns pass
        int32_t a = y[4 * r + 0] + y[4 * r + 3];
        int32_t b = y[4 * r + 1] + y[4 * r + 2];
        int32_t cc = y[4 * r + 1] - y[4 * r + 2];
        int32_t d = y[4 * r + 0] - y[4 * r + 3];
        out[4 * r + 0] = a + b; out[4 * r + 1] = d + cc;
        out[4 * r + 2] = a - b; out[4 * r + 3] = d - cc;
    }
}

void dequant4(const int32_t lev[16], int qp, int32_t out[16]) {
    const int32_t* v = VCP_V4 + 16 * (qp % 6);
    int per = qp / 6;
    for (int i = 0; i < 16; i++) out[i] = (lev[i] * v[i]) << per;
}

// dequant_dc4_np: hadamard + v00 scaling with low-QP rounding.
void dequant_dc4(const int32_t dc_blk[16], int qp, int32_t out[16]) {
    int32_t f[16];
    hadamard4_np(dc_blk, f);
    int32_t v00 = VCP_V4[16 * (qp % 6)];
    int per = qp / 6;
    for (int i = 0; i < 16; i++) {
        int32_t p = f[i] * v00;
        out[i] = per >= 2 ? p << (per - 2)
                          : (p + (1 << (1 - per))) >> (2 - per);
    }
}

void dequant_dc2(const int32_t dc[4], int qpc, int32_t out[4]) {
    // hadamard2_np over a 2x2 block (rows pass then columns pass)
    int32_t s0c0 = dc[0] + dc[2], s0c1 = dc[1] + dc[3];
    int32_t s1c0 = dc[0] - dc[2], s1c1 = dc[1] - dc[3];
    int32_t f[4] = {s0c0 + s0c1, s0c0 - s0c1, s1c0 + s1c1, s1c0 - s1c1};
    int32_t v00 = VCP_V4[16 * (qpc % 6)];
    int per = qpc / 6;
    for (int i = 0; i < 4; i++) out[i] = ((f[i] * v00) << per) >> 1;
}

void inv8_rows(const int32_t* w, int32_t* out) {   // horizontal pass
    for (int r = 0; r < 8; r++) {
        const int32_t* g = w + 8 * r;
        int32_t a0 = g[0] + g[4], a2 = g[0] - g[4];
        int32_t a4 = (g[2] >> 1) - g[6], a6 = g[2] + (g[6] >> 1);
        int32_t b0 = a0 + a6, b2 = a2 + a4, b4 = a2 - a4, b6 = a0 - a6;
        int32_t a1 = -g[3] + g[5] - g[7] - (g[7] >> 1);
        int32_t a3 = g[1] + g[7] - g[3] - (g[3] >> 1);
        int32_t a5 = -g[1] + g[7] + g[5] + (g[5] >> 1);
        int32_t a7 = g[3] + g[5] + g[1] + (g[1] >> 1);
        int32_t b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2);
        int32_t b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
        int32_t* o = out + 8 * r;
        o[0] = b0 + b7; o[1] = b2 + b5; o[2] = b4 + b3; o[3] = b6 + b1;
        o[4] = b6 - b1; o[5] = b4 - b3; o[6] = b2 - b5; o[7] = b0 - b7;
    }
}

void idct8(const int32_t w[64], int32_t out[64]) {
    int32_t y[64], t[64];
    inv8_rows(w, y);                               // axis_rows=False
    // vertical pass: same butterflies over columns
    for (int c = 0; c < 8; c++) {
        int32_t g[8];
        for (int i = 0; i < 8; i++) g[i] = y[8 * i + c];
        int32_t a0 = g[0] + g[4], a2 = g[0] - g[4];
        int32_t a4 = (g[2] >> 1) - g[6], a6 = g[2] + (g[6] >> 1);
        int32_t b0 = a0 + a6, b2 = a2 + a4, b4 = a2 - a4, b6 = a0 - a6;
        int32_t a1 = -g[3] + g[5] - g[7] - (g[7] >> 1);
        int32_t a3 = g[1] + g[7] - g[3] - (g[3] >> 1);
        int32_t a5 = -g[1] + g[7] + g[5] + (g[5] >> 1);
        int32_t a7 = g[3] + g[5] + g[1] + (g[1] >> 1);
        int32_t b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2);
        int32_t b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
        t[8 * 0 + c] = b0 + b7; t[8 * 1 + c] = b2 + b5;
        t[8 * 2 + c] = b4 + b3; t[8 * 3 + c] = b6 + b1;
        t[8 * 4 + c] = b6 - b1; t[8 * 5 + c] = b4 - b3;
        t[8 * 6 + c] = b2 - b5; t[8 * 7 + c] = b0 - b7;
    }
    for (int i = 0; i < 64; i++) out[i] = (t[i] + 32) >> 6;
}

void dequant8(const int32_t lev[64], int qp, int32_t out[64]) {
    const int32_t* v = VCP_V8 + 64 * (qp % 6);
    int per = qp / 6;
    for (int i = 0; i < 64; i++) {
        int32_t p = lev[i] * v[i];
        out[i] = per >= 2 ? p << (per - 2)
                          : (p + (1 << (1 - per))) >> (2 - per);
    }
}

inline void unzigzag4(const int32_t scan[16], int32_t out[16]) {
    for (int i = 0; i < 16; i++) out[i] = 0;
    for (int i = 0; i < 16; i++) out[VCP_ZZ4[i]] = scan[i];
}
inline void unzigzag8(const int32_t scan[64], int32_t out[64]) {
    for (int i = 0; i < 64; i++) out[i] = 0;
    for (int i = 0; i < 64; i++) out[VCP_ZZ8[i]] = scan[i];
}

// LUMA_BLK_ORDER (coding order of 4x4 blocks within an MB)
const int BLK_Y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
const int BLK_X[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};

// ---------------------------------------------------------------------------
// Motion compensation (mirror pframe._mc_luma_np / _mc_chroma_np)
// ---------------------------------------------------------------------------

struct Plane {
    const int32_t* p;
    int h, w;
    inline int32_t at(int y, int x) const {
        return p[(size_t)clampi(y, 0, h - 1) * w + clampi(x, 0, w - 1)];
    }
};

// Quarter-pel NSxNS luma block (8 = one quadrant, 16 = a whole MB
// when all four quadrants share mv/ref). out row-major NSxNS. FAST
// selects the interior path (raw indexing, no per-fetch clamping) —
// valid when the whole filter window [Y0-2, Y0+NS+4) x [X0-2,
// X0+NS+4) is in bounds.
template <int NS, bool FAST>
void mc_luma_t(const Plane& ref, int Y0, int X0, int fy, int fx,
               int32_t* out) {
    auto at = [&](int yy, int xx) -> int32_t {
        if (FAST) return ref.p[(size_t)yy * ref.w + xx];
        return ref.at(yy, xx);
    };
    if (fy == 0 && fx == 0) {
        for (int r = 0; r < NS; r++)
            for (int c = 0; c < NS; c++)
                out[NS * r + c] = at(Y0 + r, X0 + c);
        return;
    }
    const int32_t* q = VCP_QPEL + 6 * (fy * 4 + fx);
    int p1i = q[0], o1y = q[1], o1x = q[2];
    int p2i = q[3], o2y = q[4], o2x = q[5];
    bool nb = p1i == 1 || p2i == 1;
    bool nh = p1i == 2 || p2i == 2;
    bool nj = p1i == 3 || p2i == 3;

    // braw[dy+2][dx] for dy in -2..NS+3, dx in 0..NS (only rows needed)
    int32_t braw[NS + 6][NS + 1];
    if (nb || nj) {
        int rlo = nj ? -2 : 0, rhi = nj ? NS + 4 : NS + 1;
        for (int dy = rlo; dy < rhi; dy++)
            for (int dx = 0; dx < NS + 1; dx++) {
                int yy = Y0 + dy, xx = X0 + dx;
                braw[dy + 2][dx] =
                    at(yy, xx - 2) - 5 * at(yy, xx - 1)
                    + 20 * at(yy, xx) + 20 * at(yy, xx + 1)
                    - 5 * at(yy, xx + 2) + at(yy, xx + 3);
            }
    }
    int32_t pg[NS + 1][NS + 1], pb[NS + 1][NS + 1];
    int32_t ph[NS + 1][NS + 1], pj[NS + 1][NS + 1];
    if (p1i == 0 || p2i == 0)
        for (int dy = 0; dy < NS + 1; dy++)
            for (int dx = 0; dx < NS + 1; dx++)
                pg[dy][dx] = at(Y0 + dy, X0 + dx);
    if (nb)
        for (int dy = 0; dy < NS + 1; dy++)
            for (int dx = 0; dx < NS + 1; dx++)
                pb[dy][dx] = clip255((braw[dy + 2][dx] + 16) >> 5);
    if (nh)
        for (int dy = 0; dy < NS + 1; dy++)
            for (int dx = 0; dx < NS + 1; dx++) {
                int yy = Y0 + dy, xx = X0 + dx;
                int32_t hr = at(yy - 2, xx) - 5 * at(yy - 1, xx)
                    + 20 * at(yy, xx) + 20 * at(yy + 1, xx)
                    - 5 * at(yy + 2, xx) + at(yy + 3, xx);
                ph[dy][dx] = clip255((hr + 16) >> 5);
            }
    if (nj)
        for (int dy = 0; dy < NS + 1; dy++)
            for (int dx = 0; dx < NS + 1; dx++) {
                int32_t jr = braw[dy][dx] - 5 * braw[dy + 1][dx]
                    + 20 * braw[dy + 2][dx] + 20 * braw[dy + 3][dx]
                    - 5 * braw[dy + 4][dx] + braw[dy + 5][dx];
                pj[dy][dx] = clip255((jr + 512) >> 10);
            }
    auto pick = [&](int pi, int dy, int dx) -> int32_t {
        switch (pi) {
            case 0: return pg[dy][dx];
            case 1: return pb[dy][dx];
            case 2: return ph[dy][dx];
            default: return pj[dy][dx];
        }
    };
    for (int r = 0; r < NS; r++)
        for (int c = 0; c < NS; c++)
            out[NS * r + c] = (pick(p1i, r + o1y, c + o1x)
                               + pick(p2i, r + o2y, c + o2x) + 1) >> 1;
}

template <int NS>
void mc_luma(const Plane& ref, int y0, int x0, int mvy, int mvx,
             int32_t* out) {
    int iy = mvy >> 2, ix = mvx >> 2, fy = mvy & 3, fx = mvx & 3;
    int Y0 = y0 + iy, X0 = x0 + ix;
    if (Y0 - 2 >= 0 && Y0 + NS + 4 <= ref.h && X0 - 2 >= 0
        && X0 + NS + 4 <= ref.w)
        mc_luma_t<NS, true>(ref, Y0, X0, fy, fx, out);
    else
        mc_luma_t<NS, false>(ref, Y0, X0, fy, fx, out);
}

// 1/8-pel bilinear NSxNS chroma block at chroma coords (cy0, cx0).
template <int NS>
void mc_chroma(const Plane& ref, int cy0, int cx0, int mvy, int mvx,
               int32_t* out) {
    int iy = mvy >> 3, ix = mvx >> 3, fy = mvy & 7, fx = mvx & 7;
    for (int r = 0; r < NS; r++)
        for (int c = 0; c < NS; c++) {
            int br_ = cy0 + r + iy, bc_ = cx0 + c + ix;
            int32_t a = ref.at(br_, bc_), b = ref.at(br_, bc_ + 1);
            int32_t cc = ref.at(br_ + 1, bc_), d = ref.at(br_ + 1, bc_ + 1);
            out[NS * r + c] =
                ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
                 + (8 - fx) * fy * cc + fx * fy * d + 32) >> 6;
        }
}

// ---------------------------------------------------------------------------
// Weighted prediction (mirror inter_recon._apply_weight_single/_combine)
// ---------------------------------------------------------------------------

// Explicit weight table layout (packed by the Python caller):
//   [0] luma_log2, [1] chroma_log2, then per ref r:
//   [2+6r .. 2+6r+5] = lw, lo, cw0, co0, cw1, co1
struct Wt {
    const int32_t* a;                 // nullptr = no table
    bool on() const { return a != nullptr; }
    int llog() const { return a[0]; }
    int clog() const { return a[1]; }
    int lw(int r) const { return a[2 + 6 * r]; }
    int lo(int r) const { return a[3 + 6 * r]; }
    int cw(int r, int c) const { return a[4 + 6 * r + 2 * c]; }
    int co(int r, int c) const { return a[5 + 6 * r + 2 * c]; }
};

// Weight one single-list block in place; chroma_c < 0 = luma.
template <int N>
void weight_single(int32_t* blk, const Wt& wt, int r, int chroma_c) {
    int logwd = chroma_c < 0 ? wt.llog() : wt.clog();
    int w = chroma_c < 0 ? wt.lw(r) : wt.cw(r, chroma_c);
    int o = chroma_c < 0 ? wt.lo(r) : wt.co(r, chroma_c);
    for (int i = 0; i < N * N; i++) {
        int32_t v;
        if (logwd >= 1)
            v = ((blk[i] * w + (1 << (logwd - 1))) >> logwd) + o;
        else
            v = blk[i] * w + o;
        blk[i] = clip255(v);
    }
}

// Combine one quadrant's block (N=8 luma, N=4 chroma) into out.
// r0/r1 = refIdx (-1 unused). p0/p1 = raw (unweighted) predictions.
template <int N>
void combine(const int32_t* p0, const int32_t* p1, int r0, int r1,
             const Wt& wt0, const Wt& wt1,
             const int32_t* iw0, const int32_t* iw1, int n1_refs,
             int chroma_c, int32_t* out) {
    bool u0 = r0 >= 0, u1 = r1 >= 0;
    if (u0 && u1) {
        if (wt0.on() && wt1.on()) {
            int logwd = chroma_c < 0 ? wt0.llog() : wt0.clog();
            int w0 = chroma_c < 0 ? wt0.lw(r0) : wt0.cw(r0, chroma_c);
            int o0 = chroma_c < 0 ? wt0.lo(r0) : wt0.co(r0, chroma_c);
            int w1 = chroma_c < 0 ? wt1.lw(r1) : wt1.cw(r1, chroma_c);
            int o1 = chroma_c < 0 ? wt1.lo(r1) : wt1.co(r1, chroma_c);
            for (int i = 0; i < N * N; i++)
                out[i] = clip255(((p0[i] * w0 + p1[i] * w1 + (1 << logwd))
                                  >> (logwd + 1)) + ((o0 + o1 + 1) >> 1));
        } else if (iw0 != nullptr) {
            int w0 = iw0[r0 * n1_refs + r1], w1 = iw1[r0 * n1_refs + r1];
            for (int i = 0; i < N * N; i++)
                out[i] = clip255((p0[i] * w0 + p1[i] * w1 + 32) >> 6);
        } else {
            for (int i = 0; i < N * N; i++)
                out[i] = (p0[i] + p1[i] + 1) >> 1;
        }
        return;
    }
    if (u0) {
        memcpy(out, p0, N * N * sizeof(int32_t));
        if (wt0.on()) weight_single<N>(out, wt0, r0, chroma_c);
    } else if (u1) {
        memcpy(out, p1, N * N * sizeof(int32_t));
        if (wt1.on()) weight_single<N>(out, wt1, r1, chroma_c);
    } else {
        memset(out, 0, N * N * sizeof(int32_t));
    }
}

}  // namespace

extern "C" {

// Full-picture inter reconstruction: every MB with inter_mb[mi] != 0
// gets prediction + residual + clip written into the y/u/v planes.
// Refs are arrays of per-picture plane pointers (int32, H*W / quarter).
int64_t vcp_recon_inter_frame(
    const int32_t* const* l0y, const int32_t* const* l0u,
    const int32_t* const* l0v, int32_t n0,
    const int32_t* const* l1y, const int32_t* const* l1u,
    const int32_t* const* l1v, int32_t n1,            // 0 for P slices
    int32_t H, int32_t W,
    const int32_t* mv8_0, const int8_t* ref8_0,
    const int32_t* mv8_1, const int8_t* ref8_1,       // null for P
    const uint8_t* inter_mb, int32_t n_mby, int32_t n_mbx,
    const int32_t* z_luma, const int32_t* cdc_a, const int32_t* cac_a,
    const uint8_t* t8, const int32_t* qp_mb, int32_t chroma_qp_off,
    const int32_t* wt0_arr, const int32_t* wt1_arr,   // explicit (nullable)
    const int32_t* iw0, const int32_t* iw1,           // implicit (nullable)
    int32_t* y, int32_t* u, int32_t* v) {
    const int nbx2 = 2 * n_mbx;
    const int Hc = H / 2, Wc = W / 2;
    const bool is_b = n1 > 0;
    Wt wt0{wt0_arr}, wt1{wt1_arr};

    for (int mby = 0; mby < n_mby; mby++)
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            size_t mi = (size_t)mby * n_mbx + mbx;
            if (!inter_mb[mi]) continue;
            int qp = qp_mb[mi];

            // ---- luma residual for the whole MB
            int32_t res[256];
            const int32_t* z = z_luma + 256 * mi;
            if (t8[mi]) {
                for (int b8 = 0; b8 < 4; b8++) {
                    int32_t blk[64], dq[64], r8[64];
                    unzigzag8(z + 64 * b8, blk);
                    dequant8(blk, qp, dq);
                    idct8(dq, r8);
                    int oy = 8 * (b8 / 2), ox = 8 * (b8 % 2);
                    for (int r = 0; r < 8; r++)
                        for (int c = 0; c < 8; c++)
                            res[16 * (oy + r) + ox + c] = r8[8 * r + c];
                }
            } else {
                for (int blk = 0; blk < 16; blk++) {
                    int32_t b4[16], dq[16], r4[16];
                    unzigzag4(z + 16 * blk, b4);
                    dequant4(b4, qp, dq);
                    idct4(dq, r4);
                    int oy = 4 * BLK_Y[blk], ox = 4 * BLK_X[blk];
                    for (int r = 0; r < 4; r++)
                        for (int c = 0; c < 4; c++)
                            res[16 * (oy + r) + ox + c] = r4[4 * r + c];
                }
            }

            // ---- prediction + write. Fast path: when all four 8x8
            // quadrants share mv/ref on every used list (skip /
            // direct / 16x16 MBs — the common case), run one 16x16
            // luma MC + 8x8 chroma MC per list instead of four.
            size_t bi0 = (size_t)(2 * mby) * nbx2 + 2 * mbx;
            const size_t bis[4] = {bi0, bi0 + 1, bi0 + nbx2,
                                   bi0 + nbx2 + 1};
            bool uni = true;
            for (int q = 1; q < 4 && uni; q++) {
                uni = ref8_0[bis[q]] == ref8_0[bis[0]]
                    && mv8_0[2 * bis[q]] == mv8_0[2 * bis[0]]
                    && mv8_0[2 * bis[q] + 1] == mv8_0[2 * bis[0] + 1];
                if (is_b)
                    uni = uni && ref8_1[bis[q]] == ref8_1[bis[0]]
                        && mv8_1[2 * bis[q]] == mv8_1[2 * bis[0]]
                        && mv8_1[2 * bis[q] + 1] == mv8_1[2 * bis[0] + 1];
            }
            int qpc = VCP_CHROMA_QP[clampi(qp + chroma_qp_off, 0, 51)];

            // ---- chroma residual for the whole MB (both components)
            int32_t resc2[2][64];
            for (int ci = 0; ci < 2; ci++) {
                int32_t dcq[4];
                dequant_dc2(cdc_a + 8 * mi + 4 * ci, qpc, dcq);
                const int32_t* cac = cac_a + 128 * mi + 64 * ci;
                for (int blk = 0; blk < 4; blk++) {
                    int32_t b4[16], dq[16], r4[16];
                    unzigzag4(cac + 16 * blk, b4);
                    dequant4(b4, qpc, dq);
                    dq[0] = dcq[blk];              // raster DC order
                    idct4(dq, r4);
                    int oy = 4 * (blk / 2), ox = 4 * (blk % 2);
                    for (int r = 0; r < 4; r++)
                        for (int c = 0; c < 4; c++)
                            resc2[ci][8 * (oy + r) + ox + c] =
                                r4[4 * r + c];
                }
            }

            if (uni) {
                int r0 = ref8_0[bi0];
                int r1 = is_b ? ref8_1[bi0] : -1;
                int32_t p0[256], p1[256], pr[256];
                if (r0 >= 0)
                    mc_luma<16>(Plane{l0y[r0], H, W}, 16 * mby, 16 * mbx,
                                mv8_0[2 * bi0 + 1], mv8_0[2 * bi0], p0);
                if (r1 >= 0)
                    mc_luma<16>(Plane{l1y[r1], H, W}, 16 * mby, 16 * mbx,
                                mv8_1[2 * bi0 + 1], mv8_1[2 * bi0], p1);
                combine<16>(p0, p1, r0, r1, wt0, wt1, iw0, iw1, n1, -1,
                            pr);
                for (int r = 0; r < 16; r++)
                    for (int c = 0; c < 16; c++)
                        y[(size_t)(16 * mby + r) * W + 16 * mbx + c] =
                            clip255(pr[16 * r + c] + res[16 * r + c]);
                for (int ci = 0; ci < 2; ci++) {
                    int32_t* plane = ci ? v : u;
                    const int32_t* const* refs0 = ci ? l0v : l0u;
                    const int32_t* const* refs1 = ci ? l1v : l1u;
                    int32_t c0[64], c1[64], cr[64];
                    if (r0 >= 0)
                        mc_chroma<8>(Plane{refs0[r0], Hc, Wc}, 8 * mby,
                                     8 * mbx, mv8_0[2 * bi0 + 1],
                                     mv8_0[2 * bi0], c0);
                    if (r1 >= 0)
                        mc_chroma<8>(Plane{refs1[r1], Hc, Wc}, 8 * mby,
                                     8 * mbx, mv8_1[2 * bi0 + 1],
                                     mv8_1[2 * bi0], c1);
                    combine<8>(c0, c1, r0, r1, wt0, wt1, iw0, iw1, n1,
                               ci, cr);
                    for (int r = 0; r < 8; r++)
                        for (int c = 0; c < 8; c++)
                            plane[(size_t)(8 * mby + r) * Wc + 8 * mbx
                                  + c] = clip255(cr[8 * r + c]
                                                 + resc2[ci][8 * r + c]);
                }
                continue;
            }

            // ---- general path: per 8x8 quadrant
            for (int q = 0; q < 4; q++) {
                int by = 2 * mby + q / 2, bx = 2 * mbx + q % 2;
                size_t bi = bis[q];
                int r0 = ref8_0[bi];
                int r1 = is_b ? ref8_1[bi] : -1;
                int32_t p0[64], p1[64], pr[64];
                if (r0 >= 0)
                    mc_luma<8>(Plane{l0y[r0], H, W}, 8 * by, 8 * bx,
                               mv8_0[2 * bi + 1], mv8_0[2 * bi], p0);
                if (r1 >= 0)
                    mc_luma<8>(Plane{l1y[r1], H, W}, 8 * by, 8 * bx,
                               mv8_1[2 * bi + 1], mv8_1[2 * bi], p1);
                combine<8>(p0, p1, r0, r1, wt0, wt1, iw0, iw1, n1, -1,
                           pr);
                int fy0 = 8 * by, fx0 = 8 * bx;
                int ry0 = 8 * (q / 2), rx0 = 8 * (q % 2);
                for (int r = 0; r < 8; r++)
                    for (int c = 0; c < 8; c++)
                        y[(size_t)(fy0 + r) * W + fx0 + c] = clip255(
                            pr[8 * r + c] + res[16 * (ry0 + r) + rx0 + c]);
                for (int ci = 0; ci < 2; ci++) {
                    int32_t* plane = ci ? v : u;
                    const int32_t* const* refs0 = ci ? l0v : l0u;
                    const int32_t* const* refs1 = ci ? l1v : l1u;
                    int32_t c0[16], c1[16], cr[16];
                    if (r0 >= 0)
                        mc_chroma<4>(Plane{refs0[r0], Hc, Wc}, 4 * by,
                                     4 * bx, mv8_0[2 * bi + 1],
                                     mv8_0[2 * bi], c0);
                    if (r1 >= 0)
                        mc_chroma<4>(Plane{refs1[r1], Hc, Wc}, 4 * by,
                                     4 * bx, mv8_1[2 * bi + 1],
                                     mv8_1[2 * bi], c1);
                    combine<4>(c0, c1, r0, r1, wt0, wt1, iw0, iw1, n1,
                               ci, cr);
                    int cy0 = 4 * by, cx0 = 4 * bx;
                    int ry = 4 * (q / 2), rx = 4 * (q % 2);
                    for (int r = 0; r < 4; r++)
                        for (int c = 0; c < 4; c++)
                            plane[(size_t)(cy0 + r) * Wc + cx0 + c] =
                                clip255(cr[4 * r + c]
                                        + resc2[ci][8 * (ry + r) + rx
                                                    + c]);
                }
            }
        }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Intra reconstruction (mirror decoder._recon_intra_mb and helpers)
// ---------------------------------------------------------------------------

namespace {

struct Frame {
    int32_t* p;
    int h, w;
    inline int32_t& at(int y, int x) { return p[(size_t)y * w + x]; }
    inline int32_t cat(int y, int x) const { return p[(size_t)y * w + x]; }
};

// decoder._intra16_pred. Returns false on an impossible mode/neighbor
// combination (caller falls back to Python for the exact error).
bool intra16_pred(Frame& y, int y0, int x0, int mode, int32_t out[256]) {
    bool top = y0 > 0, left = x0 > 0;
    if (mode == 0) {                               // Vertical
        if (!top) return false;
        for (int r = 0; r < 16; r++)
            for (int c = 0; c < 16; c++) out[16 * r + c] = y.cat(y0 - 1, x0 + c);
        return true;
    }
    if (mode == 1) {                               // Horizontal
        if (!left) return false;
        for (int r = 0; r < 16; r++) {
            int32_t s = y.cat(y0 + r, x0 - 1);
            for (int c = 0; c < 16; c++) out[16 * r + c] = s;
        }
        return true;
    }
    if (mode == 2) {                               // DC
        int32_t dc;
        if (top && left) {
            int32_t s = 16;
            for (int i = 0; i < 16; i++)
                s += y.cat(y0 - 1, x0 + i) + y.cat(y0 + i, x0 - 1);
            dc = s >> 5;
        } else if (top) {
            int32_t s = 8;
            for (int i = 0; i < 16; i++) s += y.cat(y0 - 1, x0 + i);
            dc = s >> 4;
        } else if (left) {
            int32_t s = 8;
            for (int i = 0; i < 16; i++) s += y.cat(y0 + i, x0 - 1);
            dc = s >> 4;
        } else {
            dc = 128;
        }
        for (int i = 0; i < 256; i++) out[i] = dc;
        return true;
    }
    if (mode == 3) {                               // Plane
        if (!(top && left)) return false;
        int32_t t[17], le[17];
        for (int i = 0; i < 17; i++) {
            t[i] = y.cat(y0 - 1, x0 - 1 + i);
            le[i] = y.cat(y0 - 1 + i, x0 - 1);
        }
        int32_t hh = 0, vv = 0;
        for (int x = 0; x < 8; x++) hh += (x + 1) * (t[9 + x] - t[7 - x]);
        for (int yy = 0; yy < 8; yy++)
            vv += (yy + 1) * (le[9 + yy] - le[7 - yy]);
        int32_t a = 16 * (t[16] + le[16]);
        int32_t b = (5 * hh + 32) >> 6;
        int32_t c = (5 * vv + 32) >> 6;
        for (int r = 0; r < 16; r++)
            for (int cc = 0; cc < 16; cc++)
                out[16 * r + cc] = clip255(
                    (a + b * (cc - 7) + c * (r - 7) + 16) >> 5);
        return true;
    }
    return false;
}

// decoder._chroma_pred (8x8). mode: 0=DC, 1=H, 2=V, 3=Plane.
bool chroma_pred(Frame& pl, int c0y, int c0x, int mode, int32_t out[64]) {
    bool top = c0y > 0, left = c0x > 0;
    if (mode == 2) {
        if (!top) return false;
        for (int r = 0; r < 8; r++)
            for (int c = 0; c < 8; c++) out[8 * r + c] = pl.cat(c0y - 1, c0x + c);
        return true;
    }
    if (mode == 1) {
        if (!left) return false;
        for (int r = 0; r < 8; r++) {
            int32_t s = pl.cat(c0y + r, c0x - 1);
            for (int c = 0; c < 8; c++) out[8 * r + c] = s;
        }
        return true;
    }
    if (mode == 0) {
        for (int sy = 0; sy < 2; sy++)
            for (int sx = 0; sx < 2; sx++) {
                bool use_t = top && (sy == 0 || (sy == 1 && sx == 1)
                                     || !left);
                bool use_l = left && (sx == 0 || (sy == 1 && sx == 1)
                                      || !top);
                if (sy == 0 && sx == 1 && top) { use_t = true; use_l = false; }
                if (sy == 1 && sx == 0 && left) { use_t = false; use_l = true; }
                int32_t dc;
                int32_t ts = 0, ls = 0;
                if (top)
                    for (int i = 0; i < 4; i++)
                        ts += pl.cat(c0y - 1, c0x + 4 * sx + i);
                if (left)
                    for (int i = 0; i < 4; i++)
                        ls += pl.cat(c0y + 4 * sy + i, c0x - 1);
                if (use_t && use_l) dc = (ts + ls + 4) >> 3;
                else if (use_t) dc = (ts + 2) >> 2;
                else if (use_l) dc = (ls + 2) >> 2;
                else dc = 128;
                for (int r = 0; r < 4; r++)
                    for (int c = 0; c < 4; c++)
                        out[8 * (4 * sy + r) + 4 * sx + c] = dc;
            }
        return true;
    }
    if (mode == 3) {
        if (!(top && left)) return false;
        int32_t t[9], le[9];
        for (int i = 0; i < 9; i++) {
            t[i] = pl.cat(c0y - 1, c0x - 1 + i);
            le[i] = pl.cat(c0y - 1 + i, c0x - 1);
        }
        int32_t hh = 0, vv = 0;
        for (int x = 0; x < 4; x++) hh += (x + 1) * (t[5 + x] - t[3 - x]);
        for (int yy = 0; yy < 4; yy++)
            vv += (yy + 1) * (le[5 + yy] - le[3 - yy]);
        int32_t a = 16 * (t[8] + le[8]);
        int32_t b = (17 * hh + 16) >> 5;
        int32_t c = (17 * vv + 16) >> 5;
        for (int r = 0; r < 8; r++)
            for (int cc = 0; cc < 8; cc++)
                out[8 * r + cc] = clip255(
                    (a + b * (cc - 3) + c * (r - 3) + 16) >> 5);
        return true;
    }
    return false;
}

// within-MB decode-order index of the 4x4 block at offset (oy, ox)
const int BLK_ORDER_MAP[4][4] = {
    {0, 1, 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15}};

// decoder._intra4_pred
bool intra4_pred(Frame& y, int r0, int c0, int mode, int frame_w,
                 int32_t out[16]) {
    bool top = r0 > 0, left = c0 > 0, tl = top && left;
    int32_t r[13] = {0};
    if (left) for (int i = 0; i < 4; i++) r[i] = y.cat(r0 + i, c0 - 1);
    r[4] = tl ? y.cat(r0 - 1, c0 - 1) : 0;
    if (top) {
        for (int i = 0; i < 4; i++) r[5 + i] = y.cat(r0 - 1, c0 + i);
        bool tr_ok = false;
        if (c0 + 4 < frame_w) {
            // decode-order availability of the top-right block
            int cur_mb = (r0 / 16) * 10000 + c0 / 16;
            int cur_bo = BLK_ORDER_MAP[(r0 % 16) / 4][(c0 % 16) / 4];
            int nr = r0 - 4, nc = c0 + 4;
            int nbr_mb = (nr / 16) * 10000 + nc / 16;
            int nbr_bo = BLK_ORDER_MAP[(nr % 16) / 4][(nc % 16) / 4];
            tr_ok = nbr_mb < cur_mb
                || (nbr_mb == cur_mb && nbr_bo < cur_bo);
        }
        if (tr_ok)
            for (int i = 0; i < 4; i++) r[9 + i] = y.cat(r0 - 1, c0 + 4 + i);
        else
            for (int i = 0; i < 4; i++) r[9 + i] = r[8];
    }
    if (mode == 0) {
        if (!top) return false;
        for (int rr = 0; rr < 4; rr++)
            for (int c = 0; c < 4; c++) out[4 * rr + c] = r[5 + c];
        return true;
    }
    if (mode == 1) {
        if (!left) return false;
        for (int rr = 0; rr < 4; rr++)
            for (int c = 0; c < 4; c++) out[4 * rr + c] = r[rr];
        return true;
    }
    if (mode == 2) {
        int32_t dc;
        if (top && left)
            dc = (r[5] + r[6] + r[7] + r[8] + r[0] + r[1] + r[2] + r[3]
                  + 4) >> 3;
        else if (top) dc = (r[5] + r[6] + r[7] + r[8] + 2) >> 2;
        else if (left) dc = (r[0] + r[1] + r[2] + r[3] + 2) >> 2;
        else dc = 128;
        for (int i = 0; i < 16; i++) out[i] = dc;
        return true;
    }
    if (mode < 3 || mode > 8) return false;
    const uint8_t* tabs = VCP_I4_TABS + (mode - 3) * 3 * 16;
    const uint8_t* Ia = tabs, *Ic = tabs + 16, *Ib = tabs + 32;
    for (int i = 0; i < 16; i++)
        out[i] = (r[Ia[i]] + 2 * r[Ib[i]] + r[Ic[i]] + 2) >> 2;
    return true;
}

// decoder._intra8_pred (filtered references, spec 8.3.2)
bool intra8_pred(Frame& y, int r0, int c0, int mode, int frame_w,
                 int32_t out[64]) {
    bool top = r0 > 0, left = c0 > 0, tl = top && left;
    int32_t t[16] = {0}, le[8] = {0};
    int32_t m = tl ? y.cat(r0 - 1, c0 - 1) : 0;
    if (top) {
        for (int i = 0; i < 8; i++) t[i] = y.cat(r0 - 1, c0 + i);
        bool tr_ok = (c0 + 8 < frame_w)
            && !((r0 % 16) == 8 && ((c0 + 8) % 16) == 0);
        if (tr_ok)
            for (int i = 0; i < 8; i++) t[8 + i] = y.cat(r0 - 1, c0 + 8 + i);
        else
            for (int i = 0; i < 8; i++) t[8 + i] = t[7];
    }
    if (left) for (int i = 0; i < 8; i++) le[i] = y.cat(r0 + i, c0 - 1);

    // reference filtering (8.3.2.2.1)
    int32_t ft[16], fle[8], fm;
    memcpy(ft, t, sizeof(ft));
    memcpy(fle, le, sizeof(fle));
    if (top) {
        ft[0] = tl ? (m + 2 * t[0] + t[1] + 2) >> 2
                   : (3 * t[0] + t[1] + 2) >> 2;
        for (int x = 1; x < 15; x++)
            ft[x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2;
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2;
    }
    if (left) {
        fle[0] = tl ? (m + 2 * le[0] + le[1] + 2) >> 2
                    : (3 * le[0] + le[1] + 2) >> 2;
        for (int i = 1; i < 7; i++)
            fle[i] = (le[i - 1] + 2 * le[i] + le[i + 1] + 2) >> 2;
        fle[7] = (le[6] + 3 * le[7] + 2) >> 2;
    }
    fm = tl ? (t[0] + 2 * m + le[0] + 2) >> 2 : m;

    if (mode == 0) {
        if (!top) return false;
        for (int r = 0; r < 8; r++)
            for (int c = 0; c < 8; c++) out[8 * r + c] = ft[c];
        return true;
    }
    if (mode == 1) {
        if (!left) return false;
        for (int r = 0; r < 8; r++)
            for (int c = 0; c < 8; c++) out[8 * r + c] = fle[r];
        return true;
    }
    if (mode == 2) {
        int32_t dc;
        if (top && left) {
            int32_t s = 8;
            for (int i = 0; i < 8; i++) s += ft[i] + fle[i];
            dc = s >> 4;
        } else if (top) {
            int32_t s = 4;
            for (int i = 0; i < 8; i++) s += ft[i];
            dc = s >> 3;
        } else if (left) {
            int32_t s = 4;
            for (int i = 0; i < 8; i++) s += fle[i];
            dc = s >> 3;
        } else {
            dc = 128;
        }
        for (int i = 0; i < 64; i++) out[i] = dc;
        return true;
    }
    if (mode < 3 || mode > 8) return false;
    int32_t r[25] = {0};
    if (left) for (int i = 0; i < 8; i++) r[i] = fle[i];
    r[8] = fm;
    if (top) for (int i = 0; i < 16; i++) r[9 + i] = ft[i];
    const uint8_t* tabs = VCP_I8_TABS + (mode - 3) * 3 * 64;
    const uint8_t* Ia = tabs, *Ic = tabs + 64, *Ib = tabs + 128;
    for (int i = 0; i < 64; i++)
        out[i] = (r[Ia[i]] + 2 * r[Ib[i]] + r[Ic[i]] + 2) >> 2;
    return true;
}

bool recon_intra_chroma(Frame& u, Frame& v, int mbx, int mby,
                        int chroma_mode, const int32_t* cdc,
                        const int32_t* cac, int qpc) {
    for (int ci = 0; ci < 2; ci++) {
        Frame& pl = ci ? v : u;
        int c0y = 8 * mby, c0x = 8 * mbx;
        int32_t pred[64];
        if (!chroma_pred(pl, c0y, c0x, chroma_mode, pred)) return false;
        int32_t dcq[4];
        dequant_dc2(cdc + 4 * ci, qpc, dcq);
        for (int blk = 0; blk < 4; blk++) {
            int32_t b4[16], dq[16], r4[16];
            unzigzag4(cac + 64 * ci + 16 * blk, b4);
            dequant4(b4, qpc, dq);
            dq[0] = dcq[blk];
            idct4(dq, r4);
            int oy = 4 * (blk / 2), ox = 4 * (blk % 2);
            for (int r = 0; r < 4; r++)
                for (int c = 0; c < 4; c++)
                    pl.at(c0y + oy + r, c0x + ox + c) = clip255(
                        pred[8 * (oy + r) + ox + c] + r4[4 * r + c]);
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Reconstruct the queued intra MBs (native-parse output layout) in
// order. Returns 0, or a negative code when a prediction mode is
// invalid for its position — the caller redoes the queue in Python
// (recon is deterministic and idempotent) to raise the exact error.
int64_t vcp_recon_intra_mbs(
    int32_t* yp, int32_t* up, int32_t* vp,
    int32_t H, int32_t W, int32_t n_mbx,
    int64_t count,
    const int32_t* iq_mb, const int32_t* iq_info, const int8_t* iq_modes,
    const int32_t* iq_dc,
    const int32_t* z_luma, const int32_t* cdc_a, const int32_t* cac_a,
    int32_t chroma_qp_off) {
    Frame y{yp, H, W}, u{up, H / 2, W / 2}, v{vp, H / 2, W / 2};

    for (int64_t s = 0; s < count; s++) {
        int mi = iq_mb[s];
        int mby = mi / n_mbx, mbx = mi % n_mbx;
        int kind = iq_info[4 * s + 0];
        int pred_mode = iq_info[4 * s + 1];
        int chroma_mode = iq_info[4 * s + 2];
        int qp = iq_info[4 * s + 3];
        int qpc = VCP_CHROMA_QP[clampi(qp + chroma_qp_off, 0, 51)];
        const int32_t* z = z_luma + 256 * (size_t)mi;
        int y0 = 16 * mby, x0 = 16 * mbx;

        if (kind == 0) {                           // Intra_16x16
            int32_t pred[256];
            if (!intra16_pred(y, y0, x0, pred_mode, pred)) return -1;
            int32_t dc_blk[16], dc_rec[16];
            unzigzag4(iq_dc + 16 * s, dc_blk);
            dequant_dc4(dc_blk, qp, dc_rec);
            for (int blk = 0; blk < 16; blk++) {
                int32_t b4[16], dq[16], r4[16];
                unzigzag4(z + 16 * blk, b4);
                dequant4(b4, qp, dq);
                dq[0] = dc_rec[4 * BLK_Y[blk] + BLK_X[blk]];
                idct4(dq, r4);
                int oy = 4 * BLK_Y[blk], ox = 4 * BLK_X[blk];
                for (int r = 0; r < 4; r++)
                    for (int c = 0; c < 4; c++)
                        y.at(y0 + oy + r, x0 + ox + c) = clip255(
                            pred[16 * (oy + r) + ox + c] + r4[4 * r + c]);
            }
        } else if (kind == 1) {                    // I_4x4
            for (int blk = 0; blk < 16; blk++) {
                int32_t b4[16], dq[16], r4[16], pred[16];
                unzigzag4(z + 16 * blk, b4);
                dequant4(b4, qp, dq);
                idct4(dq, r4);
                int r0 = y0 + 4 * BLK_Y[blk], c0 = x0 + 4 * BLK_X[blk];
                if (!intra4_pred(y, r0, c0, iq_modes[16 * s + blk], W,
                                 pred))
                    return -1;
                for (int r = 0; r < 4; r++)
                    for (int c = 0; c < 4; c++)
                        y.at(r0 + r, c0 + c) = clip255(
                            pred[4 * r + c] + r4[4 * r + c]);
            }
        } else {                                   // I_8x8
            for (int b8 = 0; b8 < 4; b8++) {
                int32_t blk[64], dq[64], r8[64], pred[64];
                unzigzag8(z + 64 * b8, blk);
                dequant8(blk, qp, dq);
                idct8(dq, r8);
                int r0 = y0 + 8 * (b8 / 2), c0 = x0 + 8 * (b8 % 2);
                if (!intra8_pred(y, r0, c0, iq_modes[16 * s + 4 * b8], W,
                                 pred))
                    return -1;
                for (int r = 0; r < 8; r++)
                    for (int c = 0; c < 8; c++)
                        y.at(r0 + r, c0 + c) = clip255(
                            pred[8 * r + c] + r8[8 * r + c]);
            }
        }
        if (!recon_intra_chroma(u, v, mbx, mby, chroma_mode,
                                cdc_a + 8 * (size_t)mi,
                                cac_a + 128 * (size_t)mi, qpc))
            return -1;
    }
    return 0;
}

}  // extern "C"
