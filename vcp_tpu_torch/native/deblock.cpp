// Host-side H.264 in-loop deblocking (spec 8.7) for the host decoder,
// scalar raster order; copy of vcp_deblock_frame_direct of
// vcp_tpu/native/deblock.cpp. The spec's filter order is sequential per
// MB (vertical edges then horizontal, each edge reading previously
// filtered samples), which is a scalar double loop on the host.
//
// C ABI, loaded via ctypes.

#include <cstdint>
#include <cstdlib>

namespace {

inline int32_t clip3(int32_t lo, int32_t hi, int32_t v) {
    return v < lo ? lo : (v > hi ? hi : v);
}

inline int32_t clip1(int32_t v) { return clip3(0, 255, v); }

// One luma edge line: p/q are strided sample pointers (stride = step
// between p0 and p1 etc., i.e. -1 column/row direction handled by sign).
inline void filter_luma_line(int32_t* s, int step, int32_t bs, int32_t al,
                             int32_t be, int32_t tc0) {
    // s points at q0; p_i = s[-(i+1)*step], q_i = s[i*step]
    int32_t q0 = s[0], q1 = s[step], q2 = s[2 * step], q3 = s[3 * step];
    int32_t p0 = s[-step], p1 = s[-2 * step], p2 = s[-3 * step],
            p3 = s[-4 * step];
    if (bs == 0) return;
    if (abs(p0 - q0) >= al || abs(p1 - p0) >= be || abs(q1 - q0) >= be)
        return;
    bool ap = abs(p2 - p0) < be;
    bool aq = abs(q2 - q0) < be;
    if (bs == 4) {
        bool strong = abs(p0 - q0) < ((al >> 2) + 2);
        if (ap && strong) {
            s[-step] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
            s[-2 * step] = (p2 + p1 + p0 + q0 + 2) >> 2;
            s[-3 * step] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
        } else {
            s[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
        }
        if (aq && strong) {
            s[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
            s[step] = (q2 + q1 + q0 + p0 + 2) >> 2;
            s[2 * step] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
        } else {
            s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
        }
        return;
    }
    int32_t tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    int32_t delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    s[-step] = clip1(p0 + delta);
    s[0] = clip1(q0 - delta);
    if (ap)
        s[-2 * step] = p1 + clip3(-tc0, tc0,
                                  (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1);
    if (aq)
        s[step] = q1 + clip3(-tc0, tc0,
                             (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1);
}

inline void filter_chroma_line(int32_t* s, int step, int32_t bs,
                               int32_t al, int32_t be, int32_t tc0) {
    int32_t q0 = s[0], q1 = s[step];
    int32_t p0 = s[-step], p1 = s[-2 * step];
    if (bs == 0) return;
    if (abs(p0 - q0) >= al || abs(p1 - p0) >= be || abs(q1 - q0) >= be)
        return;
    if (bs == 4) {
        s[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
        s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
        return;
    }
    int32_t tc = tc0 + 1;
    int32_t delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    s[-step] = clip1(p0 + delta);
    s[0] = clip1(q0 - delta);
}

}  // namespace

// ---------------------------------------------------------------------------
// Direct-threshold filter: same spec-order raster loop, with bS / QP /
// alpha / beta / tc0 computed inline per 4-sample edge segment from the
// raw decode state (the general and simple forms of the boundary-strength
// rules, the averaged edge QP and the alpha / beta / tc0 tables; no
// threshold grids are materialized). Spec 8.7 / 8.7.2.
// ---------------------------------------------------------------------------

#include "tables_gen.h"

namespace {

struct BsCtx {
    int n_mby, n_mbx, bh, bw;          // 4x4-block grid dims
    const uint8_t* intra;              // (n_mby, n_mbx)
    const uint8_t* nz;                 // (bh, bw)
    const uint8_t* t8;                 // (n_mby, n_mbx) or null
    int mv_mode;                       // 0 none, 1 simple, 2 general
    const int32_t* mv0;                // simple: (gh, gw, 2); general: 8x8
    const int32_t* id0;                // general only (nby2, nbx2)
    const int32_t* mv1;                // general, nullable
    const int32_t* id1;
    int gh, gw;                        // simple-grid dims
    int nbx2;                          // general 8x8 grid row stride

    inline bool dmv(const int32_t* a, const int32_t* b) const {
        return abs(a[0] - b[0]) >= 4 || abs(a[1] - b[1]) >= 4;
    }
    // mv-difference test between 4x4 blocks p and q (8.7.2.1)
    bool mv_diff(int pbr, int pbc, int qbr, int qbc) const {
        if (mv_mode == 0) return false;
        if (mv_mode == 1) {
            const int32_t* p = mv0 + 2 * ((size_t)(pbr * gh / bh) * gw
                                          + pbc * gw / bw);
            const int32_t* q = mv0 + 2 * ((size_t)(qbr * gh / bh) * gw
                                          + qbc * gw / bw);
            return dmv(p, q);
        }
        size_t pi = (size_t)(pbr / 2) * nbx2 + pbc / 2;
        size_t qi = (size_t)(qbr / 2) * nbx2 + qbc / 2;
        int32_t i0p = id0[pi], i0q = id0[qi];
        int32_t i1p = id1 ? id1[pi] : -1, i1q = id1 ? id1[qi] : -1;
        const int32_t *m0p = mv0 + 2 * pi, *m0q = mv0 + 2 * qi;
        static const int32_t Z[2] = {0, 0};
        const int32_t *m1p = mv1 ? mv1 + 2 * pi : Z;
        const int32_t *m1q = mv1 ? mv1 + 2 * qi : Z;
        int cnt_p = (i0p >= 0) + (i1p >= 0);
        int cnt_q = (i0q >= 0) + (i1q >= 0);
        if (cnt_p != cnt_q) return true;
        if (cnt_p == 2) {
            bool straight = i0p == i0q && i1p == i1q;
            bool crossed = i0p == i1q && i1p == i0q;
            if (!(straight || crossed)) return true;
            bool d_ss = dmv(m0p, m0q) || dmv(m1p, m1q);
            bool d_cx = dmv(m0p, m1q) || dmv(m1p, m0q);
            if (i0p == i1p) return d_ss && d_cx;
            return straight ? d_ss : d_cx;
        }
        int32_t sp_id = i0p >= 0 ? i0p : i1p;
        int32_t sq_id = i0q >= 0 ? i0q : i1q;
        const int32_t* sp_mv = i0p >= 0 ? m0p : m1p;
        const int32_t* sq_mv = i0q >= 0 ? m0q : m1q;
        return sp_id != sq_id || dmv(sp_mv, sq_mv);
    }
    // bS of the edge between adjacent 4x4 blocks p and q; edge_j is the
    // edge index along the filtering direction (MB-edge / t8 interior).
    int bs(int pbr, int pbc, int qbr, int qbc, int edge_j) const {
        size_t pmb = (size_t)(pbr / 4) * n_mbx + pbc / 4;
        size_t qmb = (size_t)(qbr / 4) * n_mbx + qbc / 4;
        bool mb_edge = (edge_j + 1) % 4 == 0;
        if (t8 && t8[pmb] && ((edge_j + 1) % 2 == 1)) return 0;
        if (intra[pmb] || intra[qmb]) return mb_edge ? 4 : 3;
        if (nz[(size_t)pbr * bw + pbc] || nz[(size_t)qbr * bw + qbc])
            return 2;
        return mv_diff(pbr, pbc, qbr, qbc) ? 1 : 0;
    }
};

}  // namespace

extern "C" {

// Deblock one frame in place from raw decode state. mv_mode: 0 = no
// motion (all-intra), 1 = simple MV grid (gh, gw, 2), 2 = general
// per-8x8 lists (mv0/id0 [+ mv1/id1]). cq_tbl: 52-entry chroma QP map
// with the PPS offset already folded in.
void vcp_deblock_frame_direct(
    int32_t* y, int32_t* u, int32_t* v, int32_t h, int32_t w,
    const uint8_t* intra_mb, const uint8_t* nz, const int32_t* qp_mb,
    const uint8_t* t8, int32_t mv_mode,
    const int32_t* mv0, const int32_t* id0,
    const int32_t* mv1, const int32_t* id1,
    int32_t gh, int32_t gw, const int32_t* cq_tbl) {
    const int n_mby = h / 16, n_mbx = w / 16;
    const int hc = h / 2, wc = w / 2;
    BsCtx cx{n_mby, n_mbx, h / 4, w / 4, intra_mb, nz, t8, mv_mode,
             mv0, id0, mv1, id1, gh, gw, 2 * n_mbx};
    auto qp_at = [&](int mby, int mbx) {
        return qp_mb[(size_t)mby * n_mbx + mbx];
    };
    auto cqp = [&](int mby, int mbx) {
        int q = qp_at(mby, mbx);
        return cq_tbl[q < 0 ? 0 : (q > 51 ? 51 : q)];
    };
    auto thr = [&](int bs, int qp_av, int32_t* al, int32_t* be,
                   int32_t* tc) {
        int q = qp_av < 0 ? 0 : (qp_av > 51 ? 51 : qp_av);
        int b = bs < 1 ? 1 : (bs > 3 ? 3 : bs);
        *al = VCP_DB_ALPHA[q];
        *be = VCP_DB_BETA[q];
        *tc = VCP_DB_TC0[52 * (b - 1) + q];
    };

    for (int mby = 0; mby < n_mby; mby++) {
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            // --- vertical luma edges, left to right
            for (int k = 0; k < 4; k++) {
                int c = 16 * mbx + 4 * k;
                if (c == 0) continue;
                int e = c / 4 - 1;                 // edge between block
                                                   // cols e, e+1
                for (int g = 0; g < 4; g++) {      // 4-row segments
                    int br = 4 * mby + g;
                    int bs = cx.bs(br, e, br, e + 1, e);
                    if (!bs) continue;
                    int qp_av = (qp_at(br / 4, e / 4)
                                 + qp_at(br / 4, (e + 1) / 4) + 1) >> 1;
                    int32_t al, be, tc;
                    thr(bs, qp_av, &al, &be, &tc);
                    for (int r = 4 * br; r < 4 * br + 4; r++)
                        filter_luma_line(y + (int64_t)r * w + c, 1, bs,
                                         al, be, tc);
                }
            }
            // --- horizontal luma edges, top to bottom
            for (int k = 0; k < 4; k++) {
                int r = 16 * mby + 4 * k;
                if (r == 0) continue;
                int e = r / 4 - 1;
                for (int g = 0; g < 4; g++) {
                    int bc = 4 * mbx + g;
                    int bs = cx.bs(e, bc, e + 1, bc, e);
                    if (!bs) continue;
                    int qp_av = (qp_at(e / 4, bc / 4)
                                 + qp_at((e + 1) / 4, bc / 4) + 1) >> 1;
                    int32_t al, be, tc;
                    thr(bs, qp_av, &al, &be, &tc);
                    for (int c = 4 * bc; c < 4 * bc + 4; c++)
                        filter_luma_line(y + (int64_t)r * w + c, w, bs,
                                         al, be, tc);
                }
            }
            // --- chroma edges (8-px MBs, both planes); bS from the
            // aligned luma edge, chroma QP map
            for (int k = 0; k < 2; k++) {
                int c = 8 * mbx + 4 * k;
                if (c == 0) continue;
                int e = 2 * (c / 4) - 1;           // luma edge col
                int ec = c / 4 - 1;                // chroma-block edge
                for (int g = 0; g < 4; g++) {      // 2-row segments
                    int rc0 = 8 * mby + 2 * g;
                    int br = rc0 / 2;
                    int bs = cx.bs(br, e, br, e + 1, e);
                    if (!bs) continue;
                    int qp_av = (cqp(rc0 / 8, ec / 2)
                                 + cqp(rc0 / 8, (ec + 1) / 2) + 1) >> 1;
                    int32_t al, be, tc;
                    thr(bs, qp_av, &al, &be, &tc);
                    for (int rc = rc0; rc < rc0 + 2; rc++) {
                        filter_chroma_line(u + (int64_t)rc * wc + c, 1,
                                           bs, al, be, tc);
                        filter_chroma_line(v + (int64_t)rc * wc + c, 1,
                                           bs, al, be, tc);
                    }
                }
            }
            for (int k = 0; k < 2; k++) {
                int r = 8 * mby + 4 * k;
                if (r == 0) continue;
                int e = 2 * (r / 4) - 1;
                int ec = r / 4 - 1;
                for (int g = 0; g < 4; g++) {
                    int cc0 = 8 * mbx + 2 * g;
                    int bc = cc0 / 2;
                    int bs = cx.bs(e, bc, e + 1, bc, e);
                    if (!bs) continue;
                    int qp_av = (cqp(ec / 2, cc0 / 8)
                                 + cqp((ec + 1) / 2, cc0 / 8) + 1) >> 1;
                    int32_t al, be, tc;
                    thr(bs, qp_av, &al, &be, &tc);
                    for (int cc = cc0; cc < cc0 + 2; cc++) {
                        filter_chroma_line(u + (int64_t)r * wc + cc, wc,
                                           bs, al, be, tc);
                        filter_chroma_line(v + (int64_t)r * wc + cc, wc,
                                           bs, al, be, tc);
                    }
                }
            }
        }
    }
}

}  // extern "C"
