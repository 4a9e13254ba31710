// Shared helpers for the port's kernels. Each csrc/*.cu file is built by
// nvcc into its own shared library with a plain C interface and loaded with
// ctypes (path_gene_multimodal_tpu_torch/ops/cuda.py); every launcher
// returns the cudaError_t of its launch as an int, and pgm_error_string
// turns that into text for the Python wrapper's exception.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PGM_EXPORT extern "C" __attribute__((visibility("default")))

PGM_EXPORT const char* pgm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Allow `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
template <typename K>
static inline cudaError_t pgm_set_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// Inclusive prefix sum of one int per thread over a block of up to 1024
// threads (blockDim.x a multiple of 32). `warp_tot` is shared scratch of 32
// ints. Every thread of the block must call it.
__device__ inline int pgm_block_inclusive_scan(int v, int* warp_tot) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        int n = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += n;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int t = lane < nwarps ? warp_tot[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            int n = __shfl_up_sync(0xffffffffu, t, d);
            if (lane >= d) t += n;
        }
        if (lane < nwarps) warp_tot[lane] = t;
    }
    __syncthreads();
    int out = v + (warp > 0 ? warp_tot[warp - 1] : 0);
    __syncthreads();  // warp_tot may be reused by the caller's next scan
    return out;
}
