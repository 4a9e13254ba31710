// Per-instance statistics of dense label maps (one segment reduction per
// tile) for the H100.
//
// Replaces the TPU kernel `instance_stats_pallas`
// (path_gene_multimodal_tpu/ops/pallas/instance_stats.py:123, pallas_call
// at :152), which builds a one-hot (pixels, S) matrix per row strip and
// contracts it with a value matrix on the MXU.
//
// What bounds it here: bytes. The work is a read of two int32 maps
// (2 x 4 B per pixel) and a small (S, 16) + (4, S) f32 write per tile, with
// ~12 integer atomics per pixel into shared memory. The one-hot matmul
// would spend S operations per pixel to do what one shared-memory atomic
// does, so it is not carried over.
//
// Design: one block per tile holds the tile's slot table in shared memory
// (S x {count, sum x, sum y, votes} as int32, the three second moments as
// 64-bit integers, and the bbox extrema as int32). Every summand is an
// integer: x, y and, with the moments taken about the tile centre
// (sx, sy) = (w/2, h/2), (2x - w)^2 / 4 etc. The sums are therefore exact
// and independent of the order of the atomics; they become f32 once, at
// the end. (The TPU kernel sums in f32, so its second moments carry f32
// rounding once they pass 2^24.) Slot 0 (background) takes most pixels, so
// each thread sums its slot-0 pixels in registers and adds them once.
// Ids outside [0, S) are ignored, as the one-hot ignores them.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kFixed = 6;  // count, sum x, sum y, sum dx^2, sum dy^2, sum dxdy
constexpr float kBig = 3e38f;

__global__ void __launch_bounds__(kThreads)
instance_stats_kernel(const int* __restrict__ lbl, const int* __restrict__ tp,
                      float* __restrict__ sums, float* __restrict__ mins,
                      int h, int w, int s_slots, int num_types, int c_sum) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = s_slots;
    const int nv = num_types - 1;
    unsigned long long* mom = reinterpret_cast<unsigned long long*>(smem);  // 3*S
    int* cnt = reinterpret_cast<int*>(mom + 3 * S);
    int* sx = cnt + S;
    int* sy = sx + S;
    int* votes = sy + S;       // nv*S
    int* ext = votes + nv * S; // xmin, ymin, xmax, ymax: 4*S

    for (int i = threadIdx.x; i < 3 * S; i += blockDim.x) mom[i] = 0ull;
    for (int i = threadIdx.x; i < (3 + nv) * S; i += blockDim.x) cnt[i] = 0;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
        ext[i] = INT_MAX;
        ext[S + i] = INT_MAX;
        ext[2 * S + i] = INT_MIN;
        ext[3 * S + i] = INT_MIN;
    }
    __syncthreads();

    const int b = blockIdx.x;
    const long long base = static_cast<long long>(b) * h * w;
    const int n = h * w;
    // slot-0 partials kept in registers
    int c0 = 0, x0 = 0, y0 = 0;
    long long m0xx = 0, m0yy = 0, m0xy = 0;
    int v0[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int xmn = INT_MAX, ymn = INT_MAX, xmx = INT_MIN, ymx = INT_MIN;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        const int id = lbl[base + p];
        if (id < 0 || id >= S) continue;
        const int x = p % w;
        const int y = p / w;
        const long long dx = 2LL * x - w;
        const long long dy = 2LL * y - h;
        const int t = tp[base + p];
        if (id == 0) {
            c0 += 1;
            x0 += x;
            y0 += y;
            m0xx += dx * dx;
            m0yy += dy * dy;
            m0xy += dx * dy;
            if (t >= 1 && t <= nv) v0[t - 1] += 1;
            xmn = min(xmn, x);
            ymn = min(ymn, y);
            xmx = max(xmx, x);
            ymx = max(ymx, y);
            continue;
        }
        atomicAdd(&cnt[id], 1);
        atomicAdd(&sx[id], x);
        atomicAdd(&sy[id], y);
        atomicAdd(&mom[id], static_cast<unsigned long long>(dx * dx));
        atomicAdd(&mom[S + id], static_cast<unsigned long long>(dy * dy));
        atomicAdd(&mom[2 * S + id], static_cast<unsigned long long>(dx * dy));
        if (t >= 1 && t <= nv) atomicAdd(&votes[(t - 1) * S + id], 1);
        atomicMin(&ext[id], x);
        atomicMin(&ext[S + id], y);
        atomicMax(&ext[2 * S + id], x);
        atomicMax(&ext[3 * S + id], y);
    }
    if (c0 > 0) {
        atomicAdd(&cnt[0], c0);
        atomicAdd(&sx[0], x0);
        atomicAdd(&sy[0], y0);
        atomicAdd(&mom[0], static_cast<unsigned long long>(m0xx));
        atomicAdd(&mom[S], static_cast<unsigned long long>(m0yy));
        atomicAdd(&mom[2 * S], static_cast<unsigned long long>(m0xy));
        for (int t = 0; t < nv && t < 8; ++t)
            if (v0[t]) atomicAdd(&votes[t * S], v0[t]);
        atomicMin(&ext[0], xmn);
        atomicMin(&ext[S], ymn);
        atomicMax(&ext[2 * S], xmx);
        atomicMax(&ext[3 * S], ymx);
    }
    __syncthreads();

    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        float* o = sums + (static_cast<long long>(b) * S + s) * c_sum;
        o[0] = static_cast<float>(cnt[s]);
        o[1] = static_cast<float>(sx[s]);
        o[2] = static_cast<float>(sy[s]);
        // 64-bit two's complement sums: the cross term may be negative
        o[3] = static_cast<float>(static_cast<double>(static_cast<long long>(mom[s])) * 0.25);
        o[4] = static_cast<float>(static_cast<double>(static_cast<long long>(mom[S + s])) * 0.25);
        o[5] = static_cast<float>(static_cast<double>(static_cast<long long>(mom[2 * S + s])) * 0.25);
        for (int t = 0; t < nv; ++t) o[kFixed + t] = static_cast<float>(votes[t * S + s]);
        for (int c = kFixed + nv; c < c_sum; ++c) o[c] = 0.0f;
        float* m = mins + static_cast<long long>(b) * 4 * S;
        const bool live = cnt[s] > 0;
        m[s] = live ? static_cast<float>(ext[s]) : kBig;
        m[S + s] = live ? static_cast<float>(ext[S + s]) : kBig;
        m[2 * S + s] = live ? -static_cast<float>(ext[2 * S + s]) : kBig;
        m[3 * S + s] = live ? -static_cast<float>(ext[3 * S + s]) : kBig;
    }
}

}  // namespace

PGM_EXPORT size_t instance_stats_smem_bytes(int s_slots, int num_types) {
    return static_cast<size_t>(s_slots) * (3 * 8 + (3 + (num_types - 1) + 4) * 4);
}

PGM_EXPORT int instance_stats_launch(const void* lbl, const void* tp, void* sums,
                                     void* mins, int b, int h, int w, int s_slots,
                                     int num_types, int c_sum, void* stream) {
    const size_t smem = instance_stats_smem_bytes(s_slots, num_types);
    cudaError_t e = pgm_set_smem(instance_stats_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    instance_stats_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lbl), static_cast<const int*>(tp),
        static_cast<float*>(sums), static_cast<float*>(mins), h, w, s_slots, num_types,
        c_sum);
    return static_cast<int>(cudaGetLastError());
}
