// Microbenchmark of the instruction sequences that can form the absolute
// differences of a SAD, for tools/probe_motion.py and chip_smoke.py.
//
// Each thread runs 8 independent chains; a step of a chain folds one
// input word (or sample) into its accumulator with one sequence, and the
// next step's input depends on the accumulator, so the compiler can hoist
// nothing. The caller launches one wave of resident blocks and divides
// the pixel-offsets by the time between CUDA events. (A clock64 read
// after a barrier does not time the block: the barrier holds a warp only
// at its next memory access, so such counts read short.) Not on any
// encode path.
//
//   0  vabsdiff4 with add (PTX vabsdiff4.u32.u32.u32.add): 4 per step
//   1  __vabsdiffu4 + __dp4a(d, 0x01010101, acc): 4 per step
//   2  fp32: d = c - r; acc += |d| (abs as an operand modifier): 1
//   3  int32: d = c - r; acc += abs(d): 1
//   4  0 fed by a funnel shift, one each: 4 per step (not a SAD; shows
//      whether the shifts of the kernel share the vabsdiff4's pipe)
//   5  0 fed by a byte permute (the same shift by __byte_perm)
//   6  0 fed by the same shift made of mul.hi + mad.lo

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 8;

template <int kSeq>
__device__ __forceinline__ void step(uint32_t mul, uint32_t (&a)[kChains],
                                     uint32_t (&acc)[kChains],
                                     float (&fa)[kChains],
                                     float (&facc)[kChains]) {
#pragma unroll
    for (int c = 0; c < kChains; c++) {
        if (kSeq == 0) {
            uint32_t d;
            asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
                         : "=r"(d) : "r"(a[c]), "r"(acc[c]), "r"(acc[c]));
            acc[c] = d;
        } else if (kSeq == 1) {
            const uint32_t d = __vabsdiffu4(a[c], acc[c]);
            acc[c] = __dp4a(d, 0x01010101u, acc[c]);
        } else if (kSeq == 2) {
            const float d = fa[c] - facc[c];
            facc[c] = facc[c] + fabsf(d);
        } else if (kSeq == 3) {
            const int d = (int)a[c] - (int)acc[c];
            acc[c] = (uint32_t)((int)acc[c] + abs(d));
        } else {
            uint32_t s;
            if (kSeq == 4) {
                s = __funnelshift_r(a[c], acc[c], 8);
            } else if (kSeq == 5) {
                s = __byte_perm(a[c], acc[c], 0x4321);
            } else {        // the same shift by two integer multiplies
                uint32_t t;
                asm volatile("mul.hi.u32 %0, %1, %2;"
                             : "=r"(t) : "r"(a[c]), "r"(mul));
                asm volatile("mad.lo.u32 %0, %1, %2, %3;"
                             : "=r"(s) : "r"(acc[c]), "r"(mul), "r"(t));
            }
            uint32_t d;
            asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
                         : "=r"(d) : "r"(s), "r"(a[c]), "r"(acc[c]));
            acc[c] = d;
        }
    }
}

template <int kSeq>
__global__ void seq_kernel(int iters, uint32_t mul, uint32_t* sink) {
    uint32_t a[kChains], acc[kChains];
    float fa[kChains], facc[kChains];
#pragma unroll
    for (int c = 0; c < kChains; c++) {
        a[c] = threadIdx.x * 0x01030507u + c * 0x11111111u;
        acc[c] = blockIdx.x + c;
        fa[c] = (float)(threadIdx.x & 255);
        facc[c] = (float)c;
    }
    for (int it = 0; it < iters; it++) {
#pragma unroll
        for (int u = 0; u < kUnroll; u++) step<kSeq>(mul, a, acc, fa, facc);
    }
    uint32_t s = 0;
#pragma unroll
    for (int c = 0; c < kChains; c++) s += acc[c] + __float_as_uint(facc[c]);
    sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

void (*const kKernels[])(int, uint32_t, uint32_t*) = {
    seq_kernel<0>, seq_kernel<1>, seq_kernel<2>, seq_kernel<3>,
    seq_kernel<4>, seq_kernel<5>, seq_kernel<6>};

}  // namespace

extern "C" {

const char* vcp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Steps per thread of one launch: iters x kUnroll x kChains.
int vcp_probe_steps_per_iter(void) { return kUnroll * kChains; }

// Blocks of `threads` threads of sequence `seq` resident on one SM.
int vcp_probe_occupancy(int seq, int threads) {
    int occ = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kKernels[seq],
                                                  threads, 0);
    return occ;
}

// Launch sequence `seq` (0..6) on `blocks` blocks of `threads`; sink out:
// (blocks * threads,) uint32.
int vcp_probe_seq(int seq, int blocks, int threads, int iters,
                  uint32_t* sink, void* stream) {
    // 1 << 24 from the host: a multiplier the compiler cannot fold into a
    // shift
    kKernels[seq]<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        iters, 1u << 24, sink);
    return (int)cudaGetLastError();
}

}  // extern "C"
