// H.264 in-loop deblocking filter (spec 8.7) in spec order, one launch per
// frame.
//
// Replaces two TPU kernels of vcp_tpu/ops/deblock_pallas.py:
//   deblock_fast    <- _kernel_fast (wavefront_pallas_fast): uniform slice
//                      QP, all-inter frame, bS <= 3; one bS grid per edge
//                      direction plus ten scalar thresholds.
//   deblock_general <- _kernel (wavefront_pallas): per-edge (bS, alpha,
//                      beta, tc0) grids; strong=1 adds the bS 4 filter.
//
// Bound: the work is one read and one write of each plane plus the edge
// grids, so bytes bound it. What it pays is something else: the filter is
// sequential across macroblocks (raster order, each MB's vertical then
// horizontal edges reading already filtered samples), so MB (x, y) can
// start only when MB (x+1, y-1) is done, and a frame is a chain of
// d_steps = nMBx + 2 (nMBy - 1) dependent MB steps (254 at 1088x1920).
// The kernel's time is d_steps times the cost of one step.
//
// Design (deblock_wave<MODE>), made to keep a step short:
//   * One launch carries the whole wavefront. One thread block owns one
//     MB row and walks it left to right.
//   * Rows are taken by ticket (an atomicAdd on a counter), not by
//     blockIdx: the holder of row r started after the holders of all rows
//     above it, so a block never waits on one that is not yet scheduled,
//     whatever the number of rows and whatever else occupies the card.
//   * Progress is one int32 counter per MB row in device memory (zeroed
//     by the caller). When MB x is stored, the block passes a barrier and
//     one thread fences and release-stores x + 1. Before an active MB x of
//     row y > 0 a warp acquire-loads row y-1's counter until it reads
//     min(x + 2, nMBx), then loads the four rows above with L2-coherent
//     loads (__ldcg).
//   * The samples of an MB live in a shared-memory window: the MB, the
//     4 columns left of it and the 4 rows above it (luma 20 x 20, each
//     chroma plane 10 x 10), with the thresholds of its edges beside
//     them. All edges are filtered there. The left columns never come
//     from device memory: the filtering warp keeps its MB's last columns
//     for the next one.
//   * A step of the chain is only the filter itself, because the block is
//     a pipeline of six warps over a ring of windows, handed from warp to
//     warp through named barriers: two warps fetch an MB's samples and
//     thresholds (two MBs ahead, they depend on no other block) and the
//     rows above; warp 0 filters luma (16 lines) and warp 1 both chroma
//     planes (8 + 8 lines), each line in registers and in straight-line
//     code, so the two filters never serialise inside a warp and the
//     edges of a line overlap; one warp stores the window and one fences
//     and publishes, so no filtering warp ever waits for memory.
//   * An MB none of whose edges has bS > 0 is not filtered and does not
//     wait for the row above; it is decided from the thresholds the block
//     loads anyway.
//   * The kernel reads the input planes and writes the output planes:
//     every MB stores its 16 x 16 (filtered or not), so the copy the
//     filter needs is folded into the kernel and the caller passes
//     uninitialised outputs.
//
// deblock_diag<MODE> + launch_all is the earlier design, one grid per
// diagonal d = mbx + 2 mby, in place on device memory. It stays behind the
// *_diag entry points as an independent on-card reference for tests and
// timing; no encode path calls it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Params {
    const int32_t* y_in;      // wave: input planes (diag: unused)
    const int32_t* u_in;
    const int32_t* v_in;
    int32_t* y;               // wave: output planes; diag: in place
    int32_t* u;
    int32_t* v;
    int h, w;
    // uniform-QP form
    const int32_t* bs_v;      // (w/4 - 1, h/4): edge j at x = 4(j+1)
    const int32_t* bs_h;      // (h/4 - 1, w/4): edge j at y = 4(j+1)
    int a_l, b_l, tc_l[3], a_c, b_c, tc_c[3];
    // general form: (4, ...) channels bS, alpha, beta, tc0
    const int32_t* vthr;      // (4, h, w/4)
    const int32_t* hthr;      // (4, h/4, w)
    const int32_t* cvthr;     // (4, h/2, w/8)
    const int32_t* chthr;     // (4, h/8, w/2)
};

struct Thr { int bs, alpha, beta, tc0; };

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ Thr fast_thr(int bs, int a, int b,
                                        const int* tc) {
    return {bs, a, b, bs == 1 ? tc[0] : (bs == 2 ? tc[1] : tc[2])};
}

__device__ __forceinline__ Thr grid_thr(const int32_t* g, size_t plane,
                                        size_t idx) {
    return {g[idx], g[plane + idx], g[2 * plane + idx], g[3 * plane + idx]};
}

// Luma edge at s[0] (q0), p samples at s[-stride..-4 stride].
template <bool STRONG>
__device__ void filter_luma(int32_t* s, int st, Thr t) {
    if (t.bs <= 0) return;
    const int p3 = s[-4 * st], p2 = s[-3 * st], p1 = s[-2 * st];
    const int p0 = s[-st], q0 = s[0], q1 = s[st], q2 = s[2 * st];
    const int q3 = s[3 * st];
    if (!(abs(p0 - q0) < t.alpha && abs(p1 - p0) < t.beta &&
          abs(q1 - q0) < t.beta))
        return;
    const bool ap = abs(p2 - p0) < t.beta, aq = abs(q2 - q0) < t.beta;
    if (STRONG && t.bs == 4) {
        const bool sc = abs(p0 - q0) < ((t.alpha >> 2) + 2);
        if (ap && sc) {
            s[-st] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
            s[-2 * st] = (p2 + p1 + p0 + q0 + 2) >> 2;
            s[-3 * st] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
        } else {
            s[-st] = (2 * p1 + p0 + q1 + 2) >> 2;
        }
        if (aq && sc) {
            s[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
            s[st] = (q2 + q1 + q0 + p0 + 2) >> 2;
            s[2 * st] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
        } else {
            s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
        }
        return;
    }
    const int tc = t.tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    s[-st] = clip3(0, 255, p0 + delta);
    s[0] = clip3(0, 255, q0 - delta);
    const int avg = (p0 + q0 + 1) >> 1;
    if (ap) s[-2 * st] = p1 + clip3(-t.tc0, t.tc0, (p2 + avg - 2 * p1) >> 1);
    if (aq) s[st] = q1 + clip3(-t.tc0, t.tc0, (q2 + avg - 2 * q1) >> 1);
}

__device__ void filter_chroma(int32_t* s, int st, Thr t) {
    if (t.bs <= 0) return;
    const int p1 = s[-2 * st], p0 = s[-st], q0 = s[0], q1 = s[st];
    if (!(abs(p0 - q0) < t.alpha && abs(p1 - p0) < t.beta &&
          abs(q1 - q0) < t.beta))
        return;
    if (t.bs == 4) {
        s[-st] = (2 * p1 + p0 + q1 + 2) >> 2;
        s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
        return;
    }
    const int tc = t.tc0 + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    s[-st] = clip3(0, 255, p0 + delta);
    s[0] = clip3(0, 255, q0 - delta);
}

// The same two filters on samples held in registers, in straight-line
// code: every lane computes all outcomes and selects, as the plain
// PyTorch version does. Each arm of a choice is computed into a variable
// of its own before the choice, and conditions are joined with `&`, so
// that no arm becomes a branch: the wavefront kernel runs the edges of a
// line back to back in one warp, and without branches the next edge's
// independent work fills the gaps of the current one's.
template <bool STRONG>
__device__ __forceinline__ void edge_luma(int p3, int& p2, int& p1, int& p0,
                                          int& q0, int& q1, int& q2, int q3,
                                          Thr t) {
    const int d0 = abs(p0 - q0);
    const bool filt = (t.bs > 0) & (d0 < t.alpha) & (abs(p1 - p0) < t.beta)
                      & (abs(q1 - q0) < t.beta);
    const bool ap = abs(p2 - p0) < t.beta, aq = abs(q2 - q0) < t.beta;
    const int tc = t.tc0 + (int)ap + (int)aq;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const int avg = (p0 + q0 + 1) >> 1;
    const int f_p1 = p1 + clip3(-t.tc0, t.tc0, (p2 + avg - 2 * p1) >> 1);
    const int f_q1 = q1 + clip3(-t.tc0, t.tc0, (q2 + avg - 2 * q1) >> 1);
    int n_p2 = p2, n_q2 = q2;
    int n_p1 = ap ? f_p1 : p1, n_q1 = aq ? f_q1 : q1;
    int n_p0 = clip3(0, 255, p0 + delta), n_q0 = clip3(0, 255, q0 - delta);
    if (STRONG) {
        const bool is4 = t.bs == 4;
        const bool sc = d0 < ((t.alpha >> 2) + 2);
        const bool ps = ap & sc, qs = aq & sc;
        const int w_p0 = (2 * p1 + p0 + q1 + 2) >> 2;
        const int w_q0 = (2 * q1 + q0 + p1 + 2) >> 2;
        const int s_p0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
        const int s_p1 = (p2 + p1 + p0 + q0 + 2) >> 2;
        const int s_p2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
        const int s_q0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
        const int s_q1 = (q2 + q1 + q0 + p0 + 2) >> 2;
        const int s_q2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
        const int b_p0 = ps ? s_p0 : w_p0, b_p1 = ps ? s_p1 : p1;
        const int b_p2 = ps ? s_p2 : p2;
        const int b_q0 = qs ? s_q0 : w_q0, b_q1 = qs ? s_q1 : q1;
        const int b_q2 = qs ? s_q2 : q2;
        n_p0 = is4 ? b_p0 : n_p0; n_p1 = is4 ? b_p1 : n_p1;
        n_p2 = is4 ? b_p2 : n_p2; n_q0 = is4 ? b_q0 : n_q0;
        n_q1 = is4 ? b_q1 : n_q1; n_q2 = is4 ? b_q2 : n_q2;
    }
    p2 = filt ? n_p2 : p2; p1 = filt ? n_p1 : p1; p0 = filt ? n_p0 : p0;
    q0 = filt ? n_q0 : q0; q1 = filt ? n_q1 : q1; q2 = filt ? n_q2 : q2;
}

__device__ __forceinline__ void edge_chroma(int p1, int& p0, int& q0, int q1,
                                            Thr t) {
    const bool filt = (t.bs > 0) & (abs(p0 - q0) < t.alpha)
                      & (abs(p1 - p0) < t.beta) & (abs(q1 - q0) < t.beta);
    const int tc = t.tc0 + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const bool is4 = t.bs == 4;
    const int s_p0 = (2 * p1 + p0 + q1 + 2) >> 2;
    const int s_q0 = (2 * q1 + q0 + p1 + 2) >> 2;
    const int f_p0 = clip3(0, 255, p0 + delta);
    const int f_q0 = clip3(0, 255, q0 - delta);
    const int n_p0 = is4 ? s_p0 : f_p0, n_q0 = is4 ? s_q0 : f_q0;
    p0 = filt ? n_p0 : p0;
    q0 = filt ? n_q0 : q0;
}

// One luma line of a window (20 samples, ``st`` apart) through its four
// edges in order; one chroma line (10 samples) through its two.
template <bool STRONG>
__device__ __forceinline__ void line_luma(int32_t* s, int st, const Thr* t) {
    int v[20];
#pragma unroll
    for (int i = 0; i < 20; i++) v[i] = s[i * st];
#pragma unroll
    for (int k = 0; k < 4; k++)
        edge_luma<STRONG>(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3],
                          v[4 * k + 4], v[4 * k + 5], v[4 * k + 6],
                          v[4 * k + 7], t[k]);
#pragma unroll
    for (int i = 1; i < 19; i++) s[i * st] = v[i];
}

__device__ __forceinline__ void line_chroma(int32_t* s, int st,
                                            const Thr* t) {
    int v[10];
#pragma unroll
    for (int i = 0; i < 10; i++) v[i] = s[i * st];
#pragma unroll
    for (int k = 0; k < 2; k++)
        edge_chroma(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3], t[k]);
#pragma unroll
    for (int i = 1; i < 9; i++) s[i * st] = v[i];
}

// ---------------------------------------------------------------------------
// The wavefront kernel: one launch per frame
// ---------------------------------------------------------------------------

constexpr int kThreads = 192; // warps: luma, chroma, samples, storer,
                              // publisher, thresholds
constexpr int kRing = 3;      // windows in flight per MB row
constexpr int kLP = 21;       // luma window pitch (odd: no bank conflicts)
constexpr int kCP = 11;       // chroma window pitch

// Luma rows/cols 0..3 and chroma rows/cols 0..1 hold the neighbours'
// samples, the rest the MB's own.
struct Window {
    int32_t y[20 * kLP];
    int32_t c[2][10 * kCP];
    // The thresholds of the MB's edges, as warp 5 copied them from the
    // grids. General form, [channel bS/alpha/beta/tc0]:
    int4 tv[4][16];        // [luma row]: its 4 vertical edges
    int32_t th[4][4][16];  // [horizontal edge][luma column]
    int2 tcv[4][8];        // [chroma row]: its 2 vertical edges
    int32_t tch[4][2][8];  // [horizontal edge][chroma column]
    // Uniform-QP form, bS only (chroma takes edges 0 and 2):
    int4 bsv[4];           // [4-row band]: its 4 vertical edges
    int4 bsh[4];           // [4-column band]: its 4 horizontal edges
};

// The thresholds of one filtering lane for one MB: its line's 4 (chroma:
// 2) vertical edges as a row, and its 4 (2) horizontal edges as a column.
struct Edges { Thr v[4], h[4]; };

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

// With the __threadfence() before it, a release store at device scope.
__device__ __forceinline__ void st_relaxed(int32_t* p, int v) {
    asm volatile("st.relaxed.gpu.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// Named barriers hand a window from warp to warp: the producer arrives
// (and goes on), the consumer syncs (and waits). One barrier per window
// of the ring and kind of hand-over, so a producer that runs ahead never
// arrives twice at one barrier: the ring's own back-pressure (a window is
// loaded only after it was freed) keeps two uses of a barrier apart.
// Every lane of a warp executes the instruction.
enum : int { kLoaded = 1, kFiltered = 1 + kRing, kStored = 1 + 2 * kRing,
             kFree = 1 + 3 * kRing };

__device__ __forceinline__ void bar_arrive(int id, int threads) {
    __syncwarp();
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
    __syncwarp();
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// Built with -DVCP_WAVE_PROBE the kernel also sums, per MB row, the SM
// cycles its warps spend in each part of a step, into 16 int32 a row
// behind the ticket counter (so progress must then hold 17 nMBy + 1).
// Luma warp: [0] waiting for a loaded window, [1] vertical edges, [2]
// horizontal edges, [3] its whole step after the wait, [11] the whole
// row; samples warp: [4] waiting for a free window; thresholds warp: [12]
// waiting for a free window, [13] window stores and the next fetch, [5]
// waiting for the row above, [6] steps that waited for it, [7] loading
// the rows above; storer: [8] waiting for a filtered window, [9] stores;
// publisher: [10] fence and progress store.
// tools/probe_deblock_wave.py reads it.
#ifdef VCP_WAVE_PROBE
#define PROBE_NOW(t) const long long t = clock64()
// The clock after a barrier: a barrier defers its blocking to the warp's
// next memory access, so the reading is made to depend on one.
#define PROBE_AFTER_BAR(t, word) \
    long long t; \
    asm volatile("mov.u64 %0, %%clock64;" \
                 : "=l"(t) : "r"(*(volatile int*)(word)) : "memory")
#define PROBE_ADD(i, a, b) prb[i] += (int)((b) - (a))
#define PROBE_INC(i) prb[i] += 1
#else
#define PROBE_NOW(t)
#define PROBE_AFTER_BAR(t, word)
#define PROBE_ADD(i, a, b)
#define PROBE_INC(i)
#endif

// What the two loading warps hold in registers for one MB, fetched with
// 16-byte loads (the wrapper passes 16-byte aligned tensors) two MBs
// ahead: its own input samples, and the thresholds of its edges. (Whether
// any edge has bS > 0 counts the frame-edge entries, which no thread
// filters, too: an MB taken for active without need is only slower.)
struct Samples { int4 y[2], c; };   // 8 luma + 4 chroma a lane
struct Thresholds {
    int4 tv[2], th[2], tch;   // general form
    int2 tcv;
    int bs;                   // uniform-QP form
};

__device__ __forceinline__ bool any_pos(int4 a) {
    return (a.x > 0) | (a.y > 0) | (a.z > 0) | (a.w > 0);
}

__device__ __forceinline__ void fetch_samples(const Params& p, int mbx,
                                              int mby, int lane, Samples& f) {
    const int w = p.w, wc = w / 2;
#pragma unroll
    for (int i = 0; i < 2; i++) {   // luma: row e / 4, columns 4 (e % 4)..
        const int e = lane + 32 * i;
        f.y[i] = *reinterpret_cast<const int4*>(
            p.y_in + (size_t)(16 * mby + (e >> 2)) * w + 16 * mbx
            + 4 * (e & 3));
    }
    // chroma: plane lane / 16, row (lane / 2) % 8, columns 4 (lane % 2)..
    f.c = *reinterpret_cast<const int4*>(
        (lane < 16 ? p.u_in : p.v_in)
        + (size_t)(8 * mby + ((lane >> 1) & 7)) * wc + 8 * mbx
        + 4 * (lane & 1));
}

__device__ __forceinline__ void store_samples(Window& W, int lane,
                                              const Samples& f) {
#pragma unroll
    for (int i = 0; i < 2; i++) {
        const int e = lane + 32 * i;
        int32_t* d = W.y + (4 + (e >> 2)) * kLP + 4 + 4 * (e & 3);
        d[0] = f.y[i].x; d[1] = f.y[i].y; d[2] = f.y[i].z; d[3] = f.y[i].w;
    }
    int32_t* d = W.c[lane >> 4] + (2 + ((lane >> 1) & 7)) * kCP + 2
                 + 4 * (lane & 1);
    d[0] = f.c.x; d[1] = f.c.y; d[2] = f.c.z; d[3] = f.c.w;
}

template <int MODE>
__device__ __forceinline__ void fetch_thresholds(const Params& p, int mbx,
                                                 int mby, int lane,
                                                 Thresholds& f) {
    const int h = p.h, w = p.w, hc = h / 2, wc = w / 2;
    if (MODE == 0) {
        // lanes 0..15: bs_v of (band lane / 4, edge lane % 4); 16..31: bs_h
        const int j = (lane >> 2) & 3, k = lane & 3;
        const int e = 4 * (lane < 16 ? mbx : mby) + k;
        f.bs = 0;
        if (e > 0)
            f.bs = lane < 16
                ? p.bs_v[(size_t)(e - 1) * (h / 4) + 4 * mby + j]
                : p.bs_h[(size_t)(e - 1) * (w / 4) + 4 * mbx + j];
    } else {
#pragma unroll
        for (int i = 0; i < 2; i++) {
            const int e = lane + 32 * i, ch = e >> 4;
            f.tv[i] = *reinterpret_cast<const int4*>(
                p.vthr + (size_t)ch * h * (w / 4)
                + (size_t)(16 * mby + (e & 15)) * (w / 4) + 4 * mbx);
            f.th[i] = *reinterpret_cast<const int4*>(
                p.hthr + (size_t)ch * (h / 4) * w
                + (size_t)(4 * mby + ((e >> 2) & 3)) * w + 16 * mbx
                + 4 * (e & 3));
        }
        f.tcv = *reinterpret_cast<const int2*>(
            p.cvthr + (size_t)(lane >> 3) * hc * (wc / 4)
            + (size_t)(8 * mby + (lane & 7)) * (wc / 4) + 2 * mbx);
        f.tch = make_int4(0, 0, 0, 0);
        if (lane < 16)
            f.tch = *reinterpret_cast<const int4*>(
                p.chthr + (size_t)(lane >> 2) * (hc / 4) * wc
                + (size_t)(2 * mby + ((lane >> 1) & 1)) * wc + 8 * mbx
                + 4 * (lane & 1));
    }
}

// Into the window; returns whether this lane holds a bS > 0. (Looked at
// here and not when fetched: a fetch must not wait for its own loads.)
template <int MODE>
__device__ __forceinline__ bool store_thresholds(Window& W, int lane,
                                                 const Thresholds& f) {
    if (MODE == 0) {
        int32_t* b = reinterpret_cast<int32_t*>(lane < 16 ? W.bsv : W.bsh);
        b[lane & 15] = f.bs;     // [band j][edge k] at 4 j + k
        return f.bs > 0;
    } else {
#pragma unroll
        for (int i = 0; i < 2; i++) {
            const int e = lane + 32 * i;
            W.tv[e >> 4][e & 15] = f.tv[i];
            *reinterpret_cast<int4*>(
                &W.th[e >> 4][(e >> 2) & 3][4 * (e & 3)]) = f.th[i];
        }
        W.tcv[lane >> 3][lane & 7] = f.tcv;
        if (lane < 16)
            *reinterpret_cast<int4*>(
                &W.tch[lane >> 2][(lane >> 1) & 1][4 * (lane & 1)]) = f.tch;
        // channel 0 is bS: lanes 0..15 of the first luma loads, 0..7 of
        // cvthr, 0..3 of chthr
        return (lane < 16 && (any_pos(f.tv[0]) | any_pos(f.th[0])))
               | (lane < 8 && ((f.tcv.x > 0) | (f.tcv.y > 0)))
               | (lane < 4 && any_pos(f.tch));
    }
}

__device__ __forceinline__ int comp(int4 a, int k) {
    return k == 0 ? a.x : (k == 1 ? a.y : (k == 2 ? a.z : a.w));
}

// The thresholds of one line of the window's MB, for the lane that filters
// it: luma line ``ln`` (row for the vertical edges, column for the
// horizontal ones) or chroma line ``ln`` (both planes alike). A frame-edge
// entry (x == 0 or y == 0) is no edge: bS 0.
template <int MODE>
__device__ __forceinline__ void read_edges(const Params& p, const Window& W,
                                           bool luma, int ln, int mbx,
                                           int mby, Edges& e) {
    if (MODE == 0) {
        if (luma) {
            const int4 bv = W.bsv[ln >> 2], bh = W.bsh[ln >> 2];
#pragma unroll
            for (int k = 0; k < 4; k++) {
                e.v[k] = fast_thr(comp(bv, k), p.a_l, p.b_l, p.tc_l);
                e.h[k] = fast_thr(comp(bh, k), p.a_l, p.b_l, p.tc_l);
            }
        } else {
            const int4 bv = W.bsv[ln >> 1], bh = W.bsh[ln >> 1];
#pragma unroll
            for (int k = 0; k < 2; k++) {
                e.v[k] = fast_thr(comp(bv, 2 * k), p.a_c, p.b_c, p.tc_c);
                e.h[k] = fast_thr(comp(bh, 2 * k), p.a_c, p.b_c, p.tc_c);
            }
        }
    } else if (luma) {
        const int4 b = W.tv[0][ln], a = W.tv[1][ln], bt = W.tv[2][ln],
                   t = W.tv[3][ln];
#pragma unroll
        for (int k = 0; k < 4; k++) {
            e.v[k] = {comp(b, k), comp(a, k), comp(bt, k), comp(t, k)};
            e.h[k] = {W.th[0][k][ln], W.th[1][k][ln], W.th[2][k][ln],
                      W.th[3][k][ln]};
        }
    } else {
        const int2 b = W.tcv[0][ln], a = W.tcv[1][ln], bt = W.tcv[2][ln],
                   t = W.tcv[3][ln];
        e.v[0] = {b.x, a.x, bt.x, t.x};
        e.v[1] = {b.y, a.y, bt.y, t.y};
#pragma unroll
        for (int k = 0; k < 2; k++)
            e.h[k] = {W.tch[0][k][ln], W.tch[1][k][ln], W.tch[2][k][ln],
                      W.tch[3][k][ln]};
    }
    if (mbx == 0) e.v[0].bs = 0;
    if (mby == 0) e.h[0].bs = 0;
}

// The 4 luma and 2 + 2 chroma rows above MB mbx of row mby, from the
// output planes (the row above has stored them), by one warp.
__device__ __forceinline__ void load_top(const Params& p, int mbx, int mby,
                                         int lane, Window& W) {
    const int w = p.w, wc = w / 2;
#pragma unroll
    for (int i = 0; i < 2; i++) {
        const int e = lane + 32 * i, r = e >> 4, c = e & 15;
        W.y[r * kLP + 4 + c] = __ldcg(
            p.y + (size_t)(16 * mby - 4 + r) * w + 16 * mbx + c);
    }
    const int pl = lane >> 4, r = (lane >> 3) & 1, c = lane & 7;
    W.c[pl][r * kCP + 2 + c] = __ldcg(
        (pl ? p.v : p.u) + (size_t)(8 * mby - 2 + r) * wc + 8 * mbx + c);
}

// MODE 0: uniform-QP form; 1: general form; 2: general form + strong.
// progress: (nMBy + 1,) int32, zero on entry: [r] = MBs of row r whose
// samples the rows below may read, [nMBy] = the ticket counter. Grid: nMBy
// blocks of kThreads.
//
// The six warps of a block form a pipeline over the MBs of its row; MB x
// lives in window x % kRing from its load to its store:
//   samples     (warp 2) waits until the window is free; writes MB x's own
//               samples into it. -> loaded
//   thresholds  (warp 5) waits until the window is free; writes the
//               thresholds of MB x's edges into it and whether the MB is
//               active; for an active MB of row y > 0 waits for MB
//               (x+1, y-1) and fetches the rows above. -> loaded
//   luma        (warp 0) copies MB x-1's last columns in as left
//               neighbours, filters the vertical then the horizontal edges
//               of an active MB, keeps the last columns for MB x+1.
//               -> filtered
//   chroma      (warp 1) the same for both chroma planes. -> filtered
//   storer      (warp 3) stores the window. -> stored
//   publisher   (warp 4) frees the window, fences and publishes x + 1.
// The columns MB x+1's left edge will rewrite (luma 13..15, chroma 7) are
// left to MB x+1's store, so every sample is stored once; the rows below
// need them only when progress says x + 2.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
deblock_wave(Params p, int32_t* progress) {
    constexpr bool kStrong = MODE == 2;
    __shared__ Window win[kRing];
    __shared__ int32_t carry_y[16 * 4], carry_c[2][8 * 2];
    __shared__ int s_act[kRing];
    __shared__ int s_row;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int w = p.w, wc = w / 2;
    const int n_mby = p.h / 16, n_mbx = w / 16;
    if (tid == 0) s_row = atomicAdd(progress + n_mby, 1);
    for (int i = tid; i < (int)(sizeof(win) / sizeof(int32_t)); i += kThreads)
        reinterpret_cast<int32_t*>(win)[i] = 0;  // frame-edge neighbours
    __syncthreads();
    const int mby = s_row;
    if (mby >= n_mby) return;
#ifdef VCP_WAVE_PROBE
    int prb[16] = {0};
    int32_t* probe_out = progress + n_mby + 1 + 16 * mby;
#endif
    PROBE_NOW(t_begin);

    if (warp == 2) {                                   // ---- samples
        Samples fetched[2];
        fetch_samples(p, 0, mby, lane, fetched[0]);
        if (n_mbx > 1) fetch_samples(p, 1, mby, lane, fetched[1]);
        for (int mbx0 = 0; mbx0 < n_mbx; mbx0 += 2)
#pragma unroll
        for (int half = 0; half < 2; half++) {
            const int mbx = mbx0 + half;
            if (mbx >= n_mbx) break;
            const int s = mbx % kRing;
            PROBE_NOW(t0);
            if (mbx >= kRing) bar_sync(kFree + s, 96);
            PROBE_AFTER_BAR(t1, &s_act[s]);
            PROBE_ADD(4, t0, t1);
            store_samples(win[s], lane, fetched[half]);
            if (mbx + 2 < n_mbx)
                fetch_samples(p, mbx + 2, mby, lane, fetched[half]);
            bar_arrive(kLoaded + s, 128);
        }
        for (int mbx = max(n_mbx - kRing, 0); mbx < n_mbx; mbx++)
            bar_sync(kFree + mbx % kRing, 96);
#ifdef VCP_WAVE_PROBE
        if (lane == 0) probe_out[4] = prb[4];
#endif
    } else if (warp == 5) {                            // ---- thresholds
        Thresholds fetched[2];
        fetch_thresholds<MODE>(p, 0, mby, lane, fetched[0]);
        if (n_mbx > 1) fetch_thresholds<MODE>(p, 1, mby, lane, fetched[1]);
        for (int mbx0 = 0; mbx0 < n_mbx; mbx0 += 2)
#pragma unroll
        for (int half = 0; half < 2; half++) {
            const int mbx = mbx0 + half;
            if (mbx >= n_mbx) break;
            Thresholds& f = fetched[half];
            const int s = mbx % kRing;
            Window& W = win[s];
            PROBE_NOW(t0);
            if (mbx >= kRing) bar_sync(kFree + s, 96);
            PROBE_AFTER_BAR(t1, &s_act[s]);
            PROBE_ADD(12, t0, t1);
            const bool act = __any_sync(
                0xffffffffu, store_thresholds<MODE>(W, lane, f));
            if (lane == 0) s_act[s] = act;
            if (mbx + 2 < n_mbx)
                fetch_thresholds<MODE>(p, mbx + 2, mby, lane, f);
            PROBE_NOW(t1b);
            PROBE_ADD(13, t1, t1b);
            if (act && mby > 0) {
                // wait for MB (x+1, y-1)
                const int32_t* above = progress + mby - 1;
                const int want = min(mbx + 2, n_mbx);
                unsigned polls = 0;
                PROBE_NOW(t2);
                while (ld_acquire(above) < want) {
                    if (++polls > 32u) __nanosleep(40);
                    if (polls > (1u << 26)) __trap();
                }
                PROBE_NOW(t3);
                load_top(p, mbx, mby, lane, W);
                PROBE_NOW(t4);
                PROBE_ADD(5, t2, t3);
                PROBE_ADD(7, t3, t4);
                if (polls) PROBE_INC(6);
            }
            bar_arrive(kLoaded + s, 128);
        }
        for (int mbx = max(n_mbx - kRing, 0); mbx < n_mbx; mbx++)
            bar_sync(kFree + mbx % kRing, 96);
#ifdef VCP_WAVE_PROBE
        if (lane == 0) {
            for (int i = 5; i < 8; i++) probe_out[i] = prb[i];
            probe_out[12] = prb[12];
            probe_out[13] = prb[13];
        }
#endif
    } else if (warp == 4) {                            // ---- publisher
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            const int s = mbx % kRing;
            bar_sync(kStored + s, 64);
            bar_arrive(kFree + s, 96);
            PROBE_AFTER_BAR(t0, &s_act[s]);
            if (lane == 0) {
                __threadfence();
                st_relaxed(progress + mby, mbx + 1);
            }
            PROBE_NOW(t1);
            PROBE_ADD(10, t0, t1);
        }
#ifdef VCP_WAVE_PROBE
        if (lane == 0) probe_out[10] = prb[10];
#endif
    } else if (warp == 3) {                            // ---- storer
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            const int s = mbx % kRing;
            const Window& W = win[s];
            PROBE_NOW(t0);
            bar_sync(kFiltered + s, 96);
            PROBE_AFTER_BAR(t1, &s_act[s]);
            PROBE_ADD(8, t0, t1);
            const bool top = s_act[s] && mby > 0;
            // window columns to store of the MB's own rows: from the left
            // neighbour's last three, up to where MB x+1 will rewrite
            const int c0 = mbx > 0 ? 1 : 4;
            const int nc = (mbx + 1 < n_mbx ? 17 : 20) - c0;
            int32_t* yo = p.y + ((long long)(16 * mby - 4) * w + 16 * mbx - 4);
            if (top)
                for (int i = lane; i < 3 * 16; i += 32) {
                    const int r = 1 + (i >> 4), c = 4 + (i & 15);
                    yo[(size_t)r * w + c] = W.y[r * kLP + c];
                }
            if (lane < nc)
#pragma unroll 4
                for (int r = 4; r < 20; r++)
                    yo[(size_t)r * w + c0 + lane] = W.y[r * kLP + c0 + lane];
            // chroma: lanes 0..15 the u plane, 16..31 the v plane
            const int cc0 = mbx > 0 ? 1 : 2;
            const int ncc = (mbx + 1 < n_mbx ? 9 : 10) - cc0;
            const int pl = lane >> 4, cl = lane & 15;
            int32_t* co = (pl ? p.v : p.u)
                          + ((long long)(8 * mby - 2) * wc + 8 * mbx - 2);
            if (top && cl < 8)
                co[(size_t)wc + 2 + cl] = W.c[pl][kCP + 2 + cl];
            if (cl < ncc)
#pragma unroll 4
                for (int r = 2; r < 10; r++)
                    co[(size_t)r * wc + cc0 + cl] = W.c[pl][r * kCP + cc0 + cl];
            bar_arrive(kStored + s, 64);
            PROBE_NOW(t2);
            PROBE_ADD(9, t1, t2);
        }
#ifdef VCP_WAVE_PROBE
        if (lane == 0)
            for (int i = 8; i < 10; i++) probe_out[i] = prb[i];
#endif
    } else {                                           // ---- filters
        const bool line = lane < 16;
        const int cpl = lane >> 3, cln = lane & 7;     // of a chroma line
        Edges cur;
        for (int mbx = 0; mbx < n_mbx; mbx++) {
            const int s = mbx % kRing;
            Window& W = win[s];
            PROBE_NOW(t0);
            bar_sync(kLoaded + s, 128);
            PROBE_AFTER_BAR(t1, &s_act[s]);
            PROBE_ADD(0, t0, t1);
            const bool act = s_act[s];
            if (act && line)
                read_edges<MODE>(p, W, warp == 0, warp == 0 ? lane : cln,
                                 mbx, mby, cur);
            if (warp == 0) {
                int32_t* row = W.y + (4 + lane) * kLP;
                int32_t* keep = carry_y + 4 * lane;
                if (line && mbx > 0)
#pragma unroll
                    for (int c = 0; c < 4; c++) row[c] = keep[c];
                PROBE_NOW(t2);
                if (act) {
                    if (line) line_luma<kStrong>(row, 1, cur.v);
                    __syncwarp();
                    PROBE_NOW(t3);
                    PROBE_ADD(1, t2, t3);
                    if (line)
                        line_luma<kStrong>(W.y + 4 + lane, kLP, cur.h);
                    __syncwarp();
                    PROBE_NOW(t4);
                    PROBE_ADD(2, t3, t4);
                }
                if (line)
#pragma unroll
                    for (int c = 0; c < 4; c++) keep[c] = row[16 + c];
            } else {
                int32_t* row = W.c[cpl] + (2 + cln) * kCP;
                int32_t* keep = carry_c[cpl] + 2 * cln;
                if (line && mbx > 0) {
                    row[0] = keep[0];
                    row[1] = keep[1];
                }
                if (act) {
                    if (line) line_chroma(row, 1, cur.v);
                    __syncwarp();
                    if (line)
                        line_chroma(W.c[cpl] + 2 + cln, kCP, cur.h);
                    __syncwarp();
                }
                if (line) {
                    keep[0] = row[8];
                    keep[1] = row[9];
                }
            }
            bar_arrive(kFiltered + s, 96);
            PROBE_NOW(t5);
            PROBE_ADD(3, t1, t5);
        }
#ifdef VCP_WAVE_PROBE
        PROBE_NOW(t_end);
        PROBE_ADD(11, t_begin, t_end);
        if (tid == 0) {
            for (int i = 0; i < 4; i++) probe_out[i] = prb[i];
            probe_out[11] = prb[11];
        }
#endif
    }
}

template <int MODE>
int launch_wave(const Params& p, int32_t* progress, cudaStream_t stream) {
    deblock_wave<MODE><<<p.h / 16, kThreads, 0, stream>>>(p, progress);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The per-diagonal reference: one grid per diagonal, in place
// ---------------------------------------------------------------------------

template <int MODE>
__global__ void deblock_diag(Params p, int d, int mby_lo) {
    constexpr bool kStrong = MODE == 2;
    const int mby = mby_lo + blockIdx.x, mbx = d - 2 * mby;
    const int t = threadIdx.x;
    const int h = p.h, w = p.w, hc = h / 2, wc = w / 2;
    const size_t lv = (size_t)h * (w / 4), lh = (size_t)(h / 4) * w;
    const size_t cv = (size_t)hc * (wc / 4), ch = (size_t)(hc / 4) * wc;

    if (t < 16) {                      // luma rows: vertical edges
        const int row = 16 * mby + t;
        int32_t* line = p.y + (size_t)row * w;
        for (int k = 0; k < 4; k++) {
            const int x = 16 * mbx + 4 * k;
            if (x == 0) continue;
            const Thr th = MODE == 0
                ? fast_thr(p.bs_v[(size_t)(x / 4 - 1) * (h / 4) + row / 4],
                           p.a_l, p.b_l, p.tc_l)
                : grid_thr(p.vthr, lv, (size_t)row * (w / 4) + x / 4);
            filter_luma<kStrong>(line + x, 1, th);
        }
    } else {                           // chroma rows: vertical edges
        const int rc = 8 * mby + ((t - 16) & 7);
        int32_t* line = ((t - 16) < 8 ? p.u : p.v) + (size_t)rc * wc;
        for (int k = 0; k < 2; k++) {
            const int xc = 8 * mbx + 4 * k;
            if (xc == 0) continue;
            const Thr th = MODE == 0
                ? fast_thr(p.bs_v[(size_t)(xc / 2 - 1) * (h / 4) + rc / 2],
                           p.a_c, p.b_c, p.tc_c)
                : grid_thr(p.cvthr, cv, (size_t)rc * (wc / 4) + xc / 4);
            filter_chroma(line + xc, 1, th);
        }
    }
    __syncthreads();
    if (t < 16) {                      // luma columns: horizontal edges
        const int col = 16 * mbx + t;
        for (int k = 0; k < 4; k++) {
            const int yy = 16 * mby + 4 * k;
            if (yy == 0) continue;
            const Thr th = MODE == 0
                ? fast_thr(p.bs_h[(size_t)(yy / 4 - 1) * (w / 4) + col / 4],
                           p.a_l, p.b_l, p.tc_l)
                : grid_thr(p.hthr, lh, (size_t)(yy / 4) * w + col);
            filter_luma<kStrong>(p.y + (size_t)yy * w + col, w, th);
        }
    } else {                           // chroma columns: horizontal edges
        const int cc = 8 * mbx + ((t - 16) & 7);
        int32_t* plane = (t - 16) < 8 ? p.u : p.v;
        for (int k = 0; k < 2; k++) {
            const int yc = 8 * mby + 4 * k;
            if (yc == 0) continue;
            const Thr th = MODE == 0
                ? fast_thr(p.bs_h[(size_t)(yc / 2 - 1) * (w / 4) + cc / 2],
                           p.a_c, p.b_c, p.tc_c)
                : grid_thr(p.chthr, ch, (size_t)(yc / 4) * wc + cc);
            filter_chroma(plane + (size_t)yc * wc + cc, wc, th);
        }
    }
}

template <int MODE>
int launch_all(const Params& p, cudaStream_t stream) {
    const int n_mby = p.h / 16, n_mbx = p.w / 16;
    const int d_steps = n_mbx + 2 * (n_mby - 1);
    for (int d = 0; d < d_steps; d++) {
        // MBs of diagonal d: mbx = d - 2*mby in [0, n_mbx)
        const int lo = d - n_mbx + 1 > 0 ? (d - n_mbx + 2) / 2 : 0;
        const int hi = min(n_mby - 1, d / 2);
        deblock_diag<MODE><<<hi - lo + 1, 32, 0, stream>>>(p, d, lo);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

void set_scalars(Params& p, const int32_t* scal_host) {
    p.a_l = scal_host[0]; p.b_l = scal_host[1];
    for (int i = 0; i < 3; i++) p.tc_l[i] = scal_host[2 + i];
    p.a_c = scal_host[5]; p.b_c = scal_host[6];
    for (int i = 0; i < 3; i++) p.tc_c[i] = scal_host[7 + i];
}

}  // namespace

extern "C" {

const char* vcp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Uniform-QP all-inter form. y (h, w), u/v (h/2, w/2) int32 device planes
// in; yo, uo, vo the filtered planes out (distinct from the inputs, need
// not be initialised); bs_v (w/4-1, h/4), bs_h (h/4-1, w/4) int32;
// scal_host: alpha, beta, tc0[bS 1..3] for luma then chroma (host memory);
// progress (h/16 + 1,) int32 device scratch, zero on entry. One launch.
// Returns cudaGetLastError() of the launch.
int vcp_deblock_fast(const int32_t* y, const int32_t* u, const int32_t* v,
                     int32_t* yo, int32_t* uo, int32_t* vo, int h, int w,
                     const int32_t* bs_v, const int32_t* bs_h,
                     const int32_t* scal_host, int32_t* progress,
                     void* stream) {
    Params p{};
    p.y_in = y; p.u_in = u; p.v_in = v; p.y = yo; p.u = uo; p.v = vo;
    p.h = h; p.w = w; p.bs_v = bs_v; p.bs_h = bs_h;
    set_scalars(p, scal_host);
    return launch_wave<0>(p, progress, (cudaStream_t)stream);
}

// General form: vthr (4, h, w/4), hthr (4, h/4, w), cvthr (4, h/2, w/8),
// chthr (4, h/8, w/2) int32 device grids; strong != 0 enables bS 4.
// Planes and progress as above. One launch.
int vcp_deblock_general(const int32_t* y, const int32_t* u, const int32_t* v,
                        int32_t* yo, int32_t* uo, int32_t* vo, int h, int w,
                        const int32_t* vthr, const int32_t* hthr,
                        const int32_t* cvthr, const int32_t* chthr,
                        int32_t* progress, int strong, void* stream) {
    Params p{};
    p.y_in = y; p.u_in = u; p.v_in = v; p.y = yo; p.u = uo; p.v = vo;
    p.h = h; p.w = w;
    p.vthr = vthr; p.hthr = hthr; p.cvthr = cvthr; p.chthr = chthr;
    return strong ? launch_wave<2>(p, progress, (cudaStream_t)stream)
                  : launch_wave<1>(p, progress, (cudaStream_t)stream);
}

// The per-diagonal reference of the two functions above: the planes are
// filtered in place by d_steps grid launches. Returns the first nonzero
// cudaGetLastError() of the launches, or 0.
int vcp_deblock_fast_diag(int32_t* y, int32_t* u, int32_t* v, int h, int w,
                          const int32_t* bs_v, const int32_t* bs_h,
                          const int32_t* scal_host, void* stream) {
    Params p{};
    p.y = y; p.u = u; p.v = v; p.h = h; p.w = w;
    p.bs_v = bs_v; p.bs_h = bs_h;
    set_scalars(p, scal_host);
    return launch_all<0>(p, (cudaStream_t)stream);
}

int vcp_deblock_general_diag(int32_t* y, int32_t* u, int32_t* v, int h,
                             int w, const int32_t* vthr,
                             const int32_t* hthr, const int32_t* cvthr,
                             const int32_t* chthr, int strong,
                             void* stream) {
    Params p{};
    p.y = y; p.u = u; p.v = v; p.h = h; p.w = w;
    p.vthr = vthr; p.hthr = hthr; p.cvthr = cvthr; p.chthr = chthr;
    return strong ? launch_all<2>(p, (cudaStream_t)stream)
                  : launch_all<1>(p, (cudaStream_t)stream);
}

}  // extern "C"
