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

// Devices a launcher keeps per-device state for (function attributes and
// occupancy are set and read on the current device only), and the current
// device's ordinal (-1 on an error).
constexpr int kPgmMaxDevices = 64;

static inline int pgm_device() {
    int d = -1;
    return cudaGetDevice(&d) == cudaSuccess && d < kPgmMaxDevices ? d : -1;
}

// Allow `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
template <typename K>
static inline cudaError_t pgm_set_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// GELU as the TPU kernels compute it: tanh by default; exact erf through
// the Abramowitz-Stegun 7.1.26 polynomial of the TPU kernel
// (path_gene_multimodal_tpu/ops/pallas/convnext_block.py:65-83).
__device__ inline float pgm_gelu(float x, int exact) {
    if (exact) {
        const float z = x * 0.7071067811865476f;
        const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
                    a4 = -1.453152027f, a5 = 1.061405429f, pp = 0.3275911f;
        const float az = fabsf(z);
        const float t = 1.0f / (1.0f + pp * az);
        const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
        const float e = 1.0f - poly * expf(-az * az);
        const float erf_z = z > 0.0f ? e : (z < 0.0f ? -e : 0.0f);
        return 0.5f * x * (1.0f + erf_z);
    }
    const float k = 0.7978845608028654f;
    return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
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
