// Full-pel exhaustive SAD motion search, with or without the fused
// full-pel prediction.
//
// Replaces the two TPU kernels of vcp_tpu/ops/motion_pallas.py
// (full_search_pallas -> _search_impl): _kernel_pred, here
// motion_search_kernel<true>, and the search-only _kernel, here
// motion_search_kernel<false>. Per 16x16 macroblock, the cost SAD + lam *
// (|dx| + |dy|) of every full-pel offset in +-sr against an edge-padded
// reference; the first minimum in dy-major, dx-ascending order wins (the
// tie rule of vcp_tpu/ops/motion.py full_search). With kPred the winning
// 16x16 block is written as the prediction (equal to motion.mc_luma(ref,
// mv, sr)); the search-only form, whose caller interpolates a sub-pel
// prediction itself, writes the vectors alone.
//
// Design: one thread block per MB. The (16+2sr)^2 reference window is
// loaded once into shared memory with the reference coordinates clamped
// to the plane (the clamp is the edge padding), the current MB beside it.
// Each thread sums exact int32 SADs for a strided subset of the
// (2sr+1)^2 offsets from shared memory, keeping its own first minimum;
// a warp-shuffle then shared-memory reduction on (cost, offset index),
// lowest index on ties, picks the block's winner. Bound: at sr=8 each MB
// does 289 * 256 absolute differences (~74k integer ops) on 1 KB of
// input, so the kernel is bound by integer operations, not by bytes; the
// shared-memory window keeps device-memory traffic at about one read of
// each plane plus the outputs.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
    __shared__ int red_cost[kThreads / 32];
    __shared__ int red_idx[kThreads / 32];

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

// cur, ref: (h, w) int32 device planes (h, w multiples of 16); mv out:
// (h/16, w/16, 2) int32 [dy, dx]; pred out (h, w) int32, or null for the
// search-only kernel. Returns cudaGetLastError() after the launch.
int vcp_motion_search(const int32_t* cur, const int32_t* ref, int h, int w,
                      int sr, int lam, int32_t* mv, int32_t* pred,
                      void* stream) {
    const int wn = 16 + 2 * sr;
    const size_t shmem = (size_t)(wn * wn + 256) * sizeof(int32_t);
    dim3 grid(w / 16, h / 16);
    if (pred != nullptr)
        motion_search_kernel<true>
            <<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
                cur, ref, h, w, sr, lam, mv, pred);
    else
        motion_search_kernel<false>
            <<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
                cur, ref, h, w, sr, lam, mv, nullptr);
    return (int)cudaGetLastError();
}

}  // extern "C"
