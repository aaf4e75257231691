// Full-pel exhaustive SAD motion search, with or without the fused
// full-pel prediction.
//
// Replaces the two TPU kernels of vcp_tpu/ops/motion_pallas.py
// (full_search_pallas -> _search_impl): _kernel_pred (motion_pallas.py:207),
// here motion_search_strip<true, K>, and the search-only _kernel
// (motion_pallas.py:225), here motion_search_strip<false, K>. Per 16x16
// macroblock, the cost SAD + lam * (|dx| + |dy|) of every full-pel offset
// in +-sr against an edge-padded reference; the first minimum in dy-major,
// dx-ascending order wins (the tie rule of vcp_tpu/ops/motion.py
// full_search). With kPred the winning 16x16 block is written as the
// prediction (equal to motion.mc_luma(ref, mv, sr)); the search-only form,
// whose caller interpolates a sub-pel prediction itself, writes the
// vectors alone.
//
// Band form (the tile mesh, vcp_tpu/parallel/mesh.py): cur may be a
// horizontal band of h rows that starts at frame row row0 of a reference
// h_ref rows tall; the window rows are read at clamp(row0 + y, 0,
// h_ref - 1), the vectors and the prediction are the band's (equal to
// motion.full_search / mc_luma with row0). The whole frame is row0 = 0,
// h_ref = h.
//
// What bounds it on this card (an H100; tools/probe_motion.py measures
// it, PERF.md keeps the numbers): not bytes, but the issue rate of the
// absolute differences. Of the exact sequences, vabsdiff4 with add is the
// fastest: four pixel-offsets an instruction on a pipe that takes half a
// warp instruction per clock, 256 pixel-offsets per SM clock (fp32 sub +
// abs-add: 64, int32 sub/abs/add: 35). The funnel shifts that align the
// window words issue to the same pipe. The design:
//
// * Samples are 8-bit (Y4M input, reconstruction clamped to 0..255), so
//   the window and the current MBs are packed four samples to a 32-bit
//   word as they land in shared memory, and one vabsdiff4 with add (PTX
//   vabsdiff4.u32.u32.u32.add, SASS VABSDIFF4) forms four absolute
//   differences and their sum. A sample outside 0..255 would make that
//   wrong, so the load checks every sample and executes __trap(): a bad
//   input fails at the next synchronise instead of giving a quiet answer.
// * Register blocking over offsets: a thread owns one (MB, dy) and a run
//   of K consecutive dx (K = 12, 16, 20 or 28, a multiple of 4, so the
//   run starts on a word; the last run of a row is cut at the range).
//   Per window row it loads K/4 + 4 words, builds the K + 12 byte-shifted
//   words once (3 shifts per 4 offsets, against 16 vabsdiff4s), and
//   accumulates K SADs; the current row is one 16-byte load for the run.
// * A block is a strip of n MBs of one MB row that share one window of
//   (16 + 2sr) rows; the host picks n, K and the block size so that the
//   (MB, dy, run) items fill the threads (no idle slots beyond rounding to
//   a warp) and the busiest SM has the least work. Each thread keeps four
//   loads in flight while the block fills its window.
// * Each thread keeps the first minimum of its own run as a 64-bit key
//   (cost with its sign bit flipped, offset index), so one atomicMin per
//   item in shared memory is the lexicographic (cost, index) merge, in
//   whatever order the items finish.
//
// Where the rest of the time goes: the cut tail of each run (at sr 8, 17
// of 20 dx are used; at sr 12, 25 of 28), the window loads at the start
// of each block (all blocks of a wave load at once), and the blocks of a
// second, partly filled wave.
//
// The per-MB design of the port's first slice stays as motion_search_ref
// (one block per MB, one offset per thread, int32 samples); no encode
// path launches it, chip_smoke.py and tools/probe_motion.py hold the new
// kernel against it.

#include <cstdint>
#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

// --------------------------------------------------------------------------
// The strip kernel
// --------------------------------------------------------------------------

constexpr int kMaxStrip = 16;      // MBs per block at most
constexpr int kMaxThreads = 512;
constexpr int kBatch = 4;          // loads a thread keeps in flight

__device__ __forceinline__ uint32_t sad4_add(uint32_t a, uint32_t b,
                                             uint32_t acc) {
    uint32_t d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
        : "=r"(d) : "r"(a), "r"(b), "r"(acc));
    return d;
}

// Four int32 samples as the bytes of one word (first sample lowest);
// `bad` collects their bits, which pass 255 only for a sample outside
// 0..255.
__device__ __forceinline__ uint32_t pack4(int4 v, unsigned& bad) {
    bad |= (unsigned)v.x | (unsigned)v.y | (unsigned)v.z | (unsigned)v.w;
    return (uint32_t)v.x | ((uint32_t)v.y << 8) | ((uint32_t)v.z << 16)
        | ((uint32_t)v.w << 24);
}

#ifdef VCP_MOTION_PROBE
// Built by tools/probe_motion.py only. Per block, seven words: the SM,
// the global timer (ns) at the start, clock64 at the start, after the
// loads, after the search and at the end, and the global timer at the
// end.
__device__ unsigned long long* g_probe = nullptr;

__device__ __forceinline__ void probe_mark(int slot, const uint32_t* smem) {
    if (threadIdx.x != 0 || g_probe == nullptr) return;
    // a shared load issued after a barrier waits for it, and the clocks
    // are read after that load
    const uint32_t v = *reinterpret_cast<const volatile uint32_t*>(smem);
    unsigned long long* out =
        g_probe + 7 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
    long long c;
    unsigned long long g;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) : "r"(v));
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g) : "r"(v));
    out[2 + slot] = (unsigned long long)c;
    if (slot == 0) {
        unsigned smid;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
        out[0] = smid;
        out[1] = g;
    }
    if (slot == 3) out[6] = g;
}
#define PROBE_MARK(slot, smem) probe_mark(slot, smem)
#else
#define PROBE_MARK(slot, smem)
#endif

// Window words per row: the last run of the last MB reads up to byte
// 16(n-1) + K*nruns + 15, the prediction up to 16(n-1) + 2sr + 19. Odd,
// so that the rows the threads of a warp read lie on different banks.
__host__ __device__ inline int window_words(int n, int k, int nruns) {
    return (4 * (n - 1) + (k / 4) * nruns + 5) | 1;
}

// Shared memory: one key per MB, the current MBs (16 rows of 4n words),
// then the window ((16 + 2sr) rows of `ws` words).
__host__ __device__ inline size_t strip_smem_bytes(int n, int sr, int ws) {
    return (size_t)kMaxStrip * 8 + (size_t)64 * n * 4
        + (size_t)(16 + 2 * sr) * ws * 4;
}

template <bool kPred, int K>
__global__ void __launch_bounds__(kMaxThreads)
motion_search_strip(const int32_t* __restrict__ cur,
                    const int32_t* __restrict__ ref, int w, int h_ref,
                    int row0, int sr, int lam, int n,
                    int32_t* __restrict__ mv, int32_t* __restrict__ pred) {
    constexpr int kWords = K / 4 + 4;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned long long* best = reinterpret_cast<unsigned long long*>(smem_raw);
    uint32_t* cb = reinterpret_cast<uint32_t*>(smem_raw + kMaxStrip * 8);
    const int side = 2 * sr + 1;
    const int nruns = (side + K - 1) / K;
    const int ws = window_words(n, K, nruns);
    const int wrows = 16 + 2 * sr;
    uint32_t* win = cb + 64 * n;

    const int n_mbx = w / 16;
    const int mb0 = blockIdx.x * n;
    const int nm = min(n, n_mbx - mb0);
    const int mby = blockIdx.y;
    const int x0 = mb0 * 16, y0 = mby * 16;
    const int tid = threadIdx.x;

    PROBE_MARK(0, cb);
    if (tid < kMaxStrip) best[tid] = ~0ull;
    unsigned bad = 0;
    // The current MBs (16 rows of cw words) and the window (wrows rows of
    // ws words from reference row row0 + y0 - sr on, coordinates clamped
    // to the reference plane: the edge padding), four samples to a word.
    // A thread issues kBatch loads before it waits for any: a block's
    // loads are a few round trips to L2, not one per word.
    // A word whose samples lie inside the plane is one 16-byte load when
    // the window starts on a multiple of four samples.
    const int cw = 4 * n;
    const int n_cur = 16 * cw, n_all = n_cur + wrows * ws;
    const bool aligned = ((x0 - sr) & 3) == 0;
    for (int base = tid; base < n_all; base += kBatch * blockDim.x) {
        int4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; u++) {
            const int i = base + u * blockDim.x;
            v[u] = make_int4(0, 0, 0, 0);
            if (i < n_cur) {
                const int r = i / cw, c = i - r * cw;
                if (c < 4 * nm)
                    v[u] = __ldg(reinterpret_cast<const int4*>(
                        cur + (size_t)(y0 + r) * w + x0 + 4 * c));
            } else if (i < n_all) {
                const int r = (i - n_cur) / ws, c = i - n_cur - r * ws;
                const int32_t* row = ref
                    + (size_t)min(max(row0 + y0 - sr + r, 0), h_ref - 1) * w;
                const int xb = x0 - sr + 4 * c;
                if (aligned && xb >= 0 && xb + 4 <= w) {
                    v[u] = __ldg(reinterpret_cast<const int4*>(row + xb));
                } else {
                    v[u].x = __ldg(row + min(max(xb, 0), w - 1));
                    v[u].y = __ldg(row + min(max(xb + 1, 0), w - 1));
                    v[u].z = __ldg(row + min(max(xb + 2, 0), w - 1));
                    v[u].w = __ldg(row + min(max(xb + 3, 0), w - 1));
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; u++) {
            const int i = base + u * blockDim.x;
            if (i < n_all) cb[i] = pack4(v[u], bad);   // win = cb + n_cur
        }
    }
    if (bad > 255u) __trap();         // a sample outside 0..255
    __syncthreads();
    PROBE_MARK(1, cb);

    const int per_mb = side * nruns;
    for (int i = tid; i < nm * per_mb; i += blockDim.x) {
        const int m = i / per_mb;
        const int rest = i - m * per_mb;
        const int dy = rest / nruns;
        const int j = rest - dy * nruns;
        const uint32_t* wp = win + dy * ws + 4 * m + (K / 4) * j;
        const uint32_t* cp = cb + 4 * m;
        uint32_t acc[K];
#pragma unroll
        for (int k = 0; k < K; k++) acc[k] = 0;
#pragma unroll 2
        for (int r = 0; r < 16; r++) {
            uint32_t wd[kWords];
#pragma unroll
            for (int k = 0; k < kWords; k++) wd[k] = wp[r * ws + k];
            const uint4 c4 = *reinterpret_cast<const uint4*>(cp + r * cw);
            const uint32_t c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int t = 0; t < K + 12; t++) {
                const uint32_t s = (t & 3)
                    ? __funnelshift_r(wd[t >> 2], wd[(t >> 2) + 1], 8 * (t & 3))
                    : wd[t >> 2];
#pragma unroll
                for (int q = 0; q < 4; q++) {
                    const int dx = t - 4 * q;
                    if (dx >= 0 && dx < K) acc[dx] = sad4_add(c[q], s, acc[dx]);
                }
            }
        }
        // first minimum of the run as a key: (cost, offset index)
        unsigned long long key = ~0ull;
        const int ady = abs(dy - sr);
#pragma unroll
        for (int k = 0; k < K; k++) {
            const int dx = K * j + k;
            if (dx < side) {
                const int cost = (int)acc[k] + lam * (abs(dx - sr) + ady);
                const unsigned long long kk =
                    ((unsigned long long)((uint32_t)cost ^ 0x80000000u) << 32)
                    | (uint32_t)(dy * side + dx);
                key = kk < key ? kk : key;
            }
        }
        atomicMin(best + m, key);
    }
    __syncthreads();
    PROBE_MARK(2, cb);

    if (tid < nm) {
        const int o = (int)(uint32_t)best[tid];
        const size_t mi = (size_t)mby * n_mbx + mb0 + tid;
        mv[2 * mi + 0] = o / side - sr;
        mv[2 * mi + 1] = o % side - sr;
    }
    if (kPred) {
        // the winner's 16x16 block, four samples per 16-byte store
        for (int i = tid; i < nm * 64; i += blockDim.x) {
            const int m = i >> 6, r = (i >> 2) & 15, q = i & 3;
            const int o = (int)(uint32_t)best[m];
            const int bdy = o / side, bdx = o - (o / side) * side;
            const int col = 16 * m + bdx + 4 * q;
            const uint32_t* wr = win + (bdy + r) * ws + (col >> 2);
            const uint32_t v = __funnelshift_r(wr[0], wr[1], 8 * (col & 3));
            *reinterpret_cast<int4*>(
                pred + (size_t)(y0 + r) * w + x0 + 16 * m + 4 * q) =
                make_int4(v & 255, (v >> 8) & 255, (v >> 16) & 255, v >> 24);
        }
    }
#ifdef VCP_MOTION_PROBE
    __syncthreads();
#endif
    PROBE_MARK(3, cb);
}

struct Plan {
    int k, n, threads;
    size_t smem;
};

constexpr int kRuns[] = {12, 16, 20, 28};    // the instantiated run lengths

// Estimated issue slots of one item: per window row the vabsdiff4s, the
// funnel shifts, the loads and the loop; then the run's costs and keys.
inline long item_instrs(int k) {
    return 16 * (4 * k + 3 * (k + 12) / 4 + (k + 16) / 4 + 3) + 8 * k + 20;
}

// K, strip length and block size with the least work on the busiest SM:
// per block, the items (rounded up to whole rounds of the block) times
// the instructions of an item, plus about 16 instructions a window word
// to load and pack. (A model that also counted waves of resident blocks
// chose slower plans: see PERF.md.) nsm is the SM count of the card the
// launch goes to, which the caller passes: the device that happens to be
// current need not be that card.
Plan plan_strip(int h, int w, int sr, int nsm) {
    const int side = 2 * sr + 1, n_mby = h / 16, n_mbx = w / 16;
    Plan best{0, 0, 0, 0};
    long best_cost = LONG_MAX;
    for (int k : kRuns) {
        const int nruns = (side + k - 1) / k;
        for (int n = 1; n <= kMaxStrip && n <= n_mbx; n++) {
            const int items = side * nruns * n;
            const int threads = std::min(kMaxThreads, (items + 31) / 32 * 32);
            const int rounds = (items + threads - 1) / threads;
            const long blocks = (long)n_mby * ((n_mbx + n - 1) / n);
            const long per_sm = (blocks + nsm - 1) / nsm;
            const int ws = window_words(n, k, nruns);
            const long load = (long)(16 + 2 * sr) * ws + 64 * n;
            const long cost = per_sm * ((long)threads * rounds
                                        * item_instrs(k) + 16 * load);
            if (cost < best_cost) {
                best_cost = cost;
                best = Plan{k, n, threads, strip_smem_bytes(n, sr, ws)};
            }
        }
    }
    return best;
}

template <bool kPred>
void launch_strip(const Plan& p, const int32_t* cur, const int32_t* ref,
                  int h, int w, int h_ref, int row0, int sr, int lam,
                  int32_t* mv, int32_t* pred, cudaStream_t stream) {
    dim3 grid((w / 16 + p.n - 1) / p.n, h / 16);
    auto kernel = p.k == 12 ? motion_search_strip<kPred, 12>
        : p.k == 16 ? motion_search_strip<kPred, 16>
        : p.k == 20 ? motion_search_strip<kPred, 20>
        : motion_search_strip<kPred, 28>;
    kernel<<<grid, p.threads, p.smem, stream>>>(cur, ref, w, h_ref, row0, sr,
                                                 lam, p.n, mv, pred);
}

// --------------------------------------------------------------------------
// The reference design: one block per MB, one offset per thread
// --------------------------------------------------------------------------

constexpr int kRefThreads = 256;

template <bool kPred>
__global__ void motion_search_kernel(const int32_t* __restrict__ cur,
                                     const int32_t* __restrict__ ref,
                                     int h, int w, int sr, int lam,
                                     int32_t* __restrict__ mv,
                                     int32_t* __restrict__ pred) {
    extern __shared__ int32_t smem[];
    const int side = 2 * sr + 1;
    const int wn = 16 + 2 * sr;
    int32_t* win = smem;                 // (wn, wn) reference window
    int32_t* cb = smem + wn * wn;        // (16, 16) current block
    __shared__ int red_cost[kRefThreads / 32];
    __shared__ int red_idx[kRefThreads / 32];

    const int mbx = blockIdx.x, mby = blockIdx.y;
    const int n_mbx = gridDim.x;
    const int tid = threadIdx.x;
    const int y0 = mby * 16 - sr, x0 = mbx * 16 - sr;

    for (int i = tid; i < wn * wn; i += blockDim.x) {
        int r = i / wn, c = i - (i / wn) * wn;
        int yy = min(max(y0 + r, 0), h - 1);
        int xx = min(max(x0 + c, 0), w - 1);
        win[i] = ref[(size_t)yy * w + xx];
    }
    for (int i = tid; i < 256; i += blockDim.x)
        cb[i] = cur[(size_t)(mby * 16 + (i >> 4)) * w + mbx * 16 + (i & 15)];
    __syncthreads();

    int best_cost = INT_MAX, best_o = INT_MAX;
    for (int o = tid; o < side * side; o += blockDim.x) {
        const int dy = o / side, dx = o - (o / side) * side;
        int sad = 0;
        for (int r = 0; r < 16; r++) {
            const int32_t* wr = win + (dy + r) * wn + dx;
            const int32_t* cr = cb + r * 16;
#pragma unroll
            for (int c = 0; c < 16; c++) sad += abs(cr[c] - wr[c]);
        }
        const int cost = sad + lam * (abs(dx - sr) + abs(dy - sr));
        if (cost < best_cost) { best_cost = cost; best_o = o; }
    }

    // block-wide argmin on (cost, offset index)
    for (int off = 16; off > 0; off >>= 1) {
        int oc = __shfl_down_sync(0xffffffffu, best_cost, off);
        int oo = __shfl_down_sync(0xffffffffu, best_o, off);
        if (oc < best_cost || (oc == best_cost && oo < best_o)) {
            best_cost = oc;
            best_o = oo;
        }
    }
    const int warp = tid >> 5, lane = tid & 31;
    if (lane == 0) { red_cost[warp] = best_cost; red_idx[warp] = best_o; }
    __syncthreads();
    if (warp == 0) {
        const int nw = blockDim.x >> 5;
        best_cost = lane < nw ? red_cost[lane] : INT_MAX;
        best_o = lane < nw ? red_idx[lane] : INT_MAX;
        for (int off = 16; off > 0; off >>= 1) {
            int oc = __shfl_down_sync(0xffffffffu, best_cost, off);
            int oo = __shfl_down_sync(0xffffffffu, best_o, off);
            if (oc < best_cost || (oc == best_cost && oo < best_o)) {
                best_cost = oc;
                best_o = oo;
            }
        }
        if (lane == 0) red_idx[0] = best_o;
    }
    __syncthreads();
    const int win_o = red_idx[0];
    const int bdy = win_o / side, bdx = win_o - (win_o / side) * side;
    if (tid == 0) {
        const size_t m = (size_t)mby * n_mbx + mbx;
        mv[2 * m + 0] = bdy - sr;
        mv[2 * m + 1] = bdx - sr;
    }
    if (kPred) {
        for (int i = tid; i < 256; i += blockDim.x) {
            const int r = i >> 4, c = i & 15;
            pred[(size_t)(mby * 16 + r) * w + mbx * 16 + c] =
                win[(bdy + r) * wn + bdx + c];
        }
    }
}

}  // namespace

extern "C" {

const char* vcp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// vcp_motion_search with a given plan (run length k of 12, 16, 20 or 28,
// n MBs per block, threads per block); for the probe's sweep of plans.
int vcp_motion_search_planned(const int32_t* cur, const int32_t* ref, int h,
                              int w, int h_ref, int row0, int sr, int lam,
                              int32_t* mv, int32_t* pred, int k, int n,
                              int threads, void* stream) {
    const int nruns = (2 * sr + 1 + k - 1) / k;
    const Plan p{k, n, threads,
                 strip_smem_bytes(n, sr, window_words(n, k, nruns))};
    cudaStream_t s = (cudaStream_t)stream;
    if (pred != nullptr)
        launch_strip<true>(p, cur, ref, h, w, h_ref, row0, sr, lam, mv, pred,
                           s);
    else
        launch_strip<false>(p, cur, ref, h, w, h_ref, row0, sr, lam, mv,
                            nullptr, s);
    return (int)cudaGetLastError();
}

// cur: (h, w) int32 device band from frame row row0 of ref: (h_ref, w)
// (h, w, row0 multiples of 16, row0 + h <= h_ref, samples 0..255, 16-byte
// aligned; the whole frame is row0 = 0, h_ref = h); mv out: (h/16, w/16,
// 2) int32 [dy, dx]; pred out (h, w) int32, or null for the search-only
// kernel; nsm: the SM count of the card of `stream`. Returns
// cudaGetLastError() after the launch.
int vcp_motion_search(const int32_t* cur, const int32_t* ref, int h, int w,
                      int h_ref, int row0, int sr, int lam, int32_t* mv,
                      int32_t* pred, int nsm, void* stream) {
    const Plan p = plan_strip(h, w, sr, nsm);
    return vcp_motion_search_planned(cur, ref, h, w, h_ref, row0, sr, lam, mv,
                                     pred, p.k, p.n, p.threads, stream);
}

// The plan vcp_motion_search launches for a shape and range on a card of
// nsm SMs: out[0..3] = run length K, MBs per block, threads per block,
// dynamic shared bytes.
void vcp_motion_search_plan(int h, int w, int sr, int nsm, int* out) {
    const Plan p = plan_strip(h, w, sr, nsm);
    out[0] = p.k;
    out[1] = p.n;
    out[2] = p.threads;
    out[3] = (int)p.smem;
}

#ifdef VCP_MOTION_PROBE
void vcp_motion_probe_buffer(unsigned long long* buf) {
    cudaMemcpyToSymbol(g_probe, &buf, sizeof(buf));
}
#endif

// The reference design, same arguments and results.
int vcp_motion_search_ref(const int32_t* cur, const int32_t* ref, int h,
                          int w, int sr, int lam, int32_t* mv, int32_t* pred,
                          void* stream) {
    const int wn = 16 + 2 * sr;
    const size_t shmem = (size_t)(wn * wn + 256) * sizeof(int32_t);
    dim3 grid(w / 16, h / 16);
    if (pred != nullptr)
        motion_search_kernel<true>
            <<<grid, kRefThreads, shmem, (cudaStream_t)stream>>>(
                cur, ref, h, w, sr, lam, mv, pred);
    else
        motion_search_kernel<false>
            <<<grid, kRefThreads, shmem, (cudaStream_t)stream>>>(
                cur, ref, h, w, sr, lam, mv, nullptr);
    return (int)cudaGetLastError();
}

}  // extern "C"
