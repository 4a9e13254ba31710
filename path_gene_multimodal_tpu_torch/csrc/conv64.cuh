// The 64 -> 64 channel 3x3 conv core of the port's final-stage kernels
// (csrc/upsample_conv.cu: K9, K10; csrc/conv64.cu: K8, K11). Each kernel
// builds its input rows in shared memory its own way (an upsampled halo, a
// ring of copied rows) and calls these for the rest:
//  - the resident weight: 64 output channels of a (3, 3, 64, ldw) weight in
//    wgmma's canonical no-swizzle K-major layout, 73,728 B. k-step
//    s = tap * 4 + ci / 16, then the 8-channel half (ci / 8) % 2 (1,024 B
//    apart), the 8-cout group co / 8 (128 B apart), cout co % 8 (16 B
//    apart), ci % 8;
//  - the product loop over a planar input: pixel p of an input row,
//    channels 8 c .. 8 c + 7, at row base + c * plane + p * 16, so that the
//    A operand of any tap, 64 consecutive pixels of a row shifted by dx, is
//    a canonical operand (8-pixel groups 128 B apart, 8-channel halves one
//    plane apart). 36 k-steps (9 taps x four 16-channel chunks) x R rows of
//    wgmma m64n64k16, both operands by descriptor, then one commit and one
//    wait: no barrier, no ldmatrix and no global access in the K loop;
//  - the epilogue: bias + GELU in registers (bias_act), rounded to bf16
//    pairs, and K10's / K11's head product on the tensor cores (mma.sync
//    m16n8k16: the accumulator layout of a warp's 16 rows is mma's A
//    layout) with its bias, staged for the store.
// A warpgroup owns R output rows of 64 pixels; in its accumulator (r, 4 nf
// + j) thread (warp wq, lane 4 g + q) holds pixel 16 wq + g + 8 (j >> 1)
// of row r, channel 8 nf + 2 q + (j & 1). Include after common.cuh.
#pragma once

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace conv64 {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                       // cin = cout
constexpr int kSteps = 9 * (kC / 16);        // k16 steps
constexpr int kLd = kC + 8;                  // bf16 row stride of an output staging
constexpr int kNP = 16;                      // head columns, zero-padded
constexpr int kLdHead = kNP + 8;             // bf16 row stride of the head weights (48 B)
constexpr size_t kWBytes = size_t(kSteps) * 16 * kC * 2;
constexpr size_t kHeadBytes = size_t(kC) * kLdHead * 2;

// output channels co0 .. co0 + 63 of w (3, 3, 64, ldw) into Ws, resident
template <int kThreads>
__device__ __forceinline__ void load_weights(bf16* Ws, const bf16* w, int ldw, int co0) {
    for (int i = threadIdx.x; i < kSteps * 2 * 8 * 8; i += kThreads) {
        const int n = i & 63, half = (i >> 6) & 1, s = i >> 7;
        const int tap = s >> 2, ci0 = (s & 3) * 16 + half * 8;
        const bf16* src = w + (static_cast<size_t>(tap) * kC + ci0) * ldw + co0 + n;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = src[k * ldw];
        *reinterpret_cast<uint4*>(Ws + (s * 2 + half) * 512 + n * 8) =
            *reinterpret_cast<const uint4*>(v);
    }
}

// head weights wh[r0 + r, c0 + c] (row stride ldh), r < 64, c < nout, into
// Hw (64 x kNP, rows kLdHead apart), zero past nout
template <int kThreads>
__device__ __forceinline__ void load_head(bf16* Hw, const bf16* wh, int ldh, int r0, int c0,
                                          int nout) {
    for (int i = threadIdx.x; i < kC * kNP; i += kThreads) {
        const int r = i / kNP, c = i % kNP;
        Hw[r * kLdHead + c] =
            c < nout ? wh[static_cast<size_t>(r0 + r) * ldh + c0 + c] : __float2bfloat16(0.0f);
    }
}

// the lane's ldmatrix.trans address into Hw: lane l gives row
// (l & 7) + 8 ((l >> 3) & 1), columns 8 (l >> 4) ..
__device__ __forceinline__ uint32_t head_base(const bf16* Hw, int lane) {
    return smem_u32(Hw + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdHead + (lane >> 4) * 8);
}

// acc[r] = the conv of the warpgroup's output row r: row_addr(i) is the
// shared address of the input row under output row r = i - dy, i.e. of tap
// row dy of row r, planar with `plane` bytes between 8-channel planes
template <int R, typename RowAddr>
__device__ __forceinline__ void products(float (&acc)[R][32], uint32_t ws, RowAddr row_addr,
                                         uint32_t plane) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
        const int tap = s >> 2, kc = s & 3, dy = tap / 3, dx = tap % 3;
        const uint64_t db = desc(ws + s * 2048, 1024, 128);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const uint32_t aa = row_addr(r + dy) + 2 * kc * plane + dx * 16;
            wgmma_bf16<64>(acc[r], desc(aa, plane, 128), db, s > 0);
        }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 32; ++j) pin(acc[r][j]);
}

// y[r][nf][hf] = bf16 pair act(acc + b) of pixel 16 wq + g + 8 hf,
// channels 8 nf + 2 q, + 1; act: the GELU
template <int R, typename Act>
__device__ __forceinline__ void bias_act(uint32_t (&y)[R][8][2], const float (&acc)[R][32],
                                         const bf16* b, int q, Act act) {
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
        const float b0 = __bfloat162float(b[nf * 8 + 2 * q]);
        const float b1 = __bfloat162float(b[nf * 8 + 2 * q + 1]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
                y[r][nf][hf] = pack_bf16(act(acc[r][4 * nf + 2 * hf] + b0),
                                         act(acc[r][4 * nf + 2 * hf + 1] + b1));
    }
}

// gelu_fast's tanh mode, x / (1 + exp(-2u)) with u = k (x + 0.044715 x^3),
// its constants folded into one power of two, 2^(x (c1 + c2 x^2)), and the
// exponential and reciprocal as ex2.approx.ftz / rcp.approx.ftz: four FP32
// operations and two MUFU operations an element (gelu_fast: about twice
// the FP32 operations); within ~1e-6 |x| of pgm_gelu
__device__ __forceinline__ float gelu_tanh_ex2(float x) {
    const float c1 = -2.302208198144325f;   // -2 k log2(e)
    const float c2 = -0.1029432395800235f;  // -2 k 0.044715 log2(e)
    float e, r;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * fmaf(c2, x * x, c1)));
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + e));
    return x * r;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the head: Z (64 x 16) = Y (64 x 64, bf16) @ Wh (64 x 16) per warp and
// row; z[r][nf][2 hf + j]: pixel 16 wq + g + 8 hf, column 8 nf + 2 q + j
template <int R>
__device__ __forceinline__ void head_product(float (&z)[R][2][4], const uint32_t (&y)[R][8][2],
                                             uint32_t h_base) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int nf = 0; nf < 2; ++nf)
#pragma unroll
            for (int j = 0; j < 4; ++j) z[r][nf][j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
        uint32_t hb[4];
        ldsm_x4_trans(hb, h_base + kk * 16 * kLdHead * 2);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const uint32_t af[4] = {y[r][2 * kk][0], y[r][2 * kk][1], y[r][2 * kk + 1][0],
                                    y[r][2 * kk + 1][1]};
            mma_bf16(z[r][0], af, hb[0], hb[1]);
            mma_bf16(z[r][1], af, hb[2], hb[3]);
        }
    }
}

// z + bh (columns >= nout get 0 bias) as bf16 into the warp's staging, row
// r * 16 + pixel, kNP columns a row
template <int R>
__device__ __forceinline__ void stage_head(bf16* stg, const float (&z)[R][2][4], const bf16* bh,
                                           int nout, int g, int q) {
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
        const int n0 = nf * 8 + 2 * q;
        const float h0 = n0 < nout ? __bfloat162float(bh[n0]) : 0.0f;
        const float h1 = n0 + 1 < nout ? __bfloat162float(bh[n0 + 1]) : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
                *reinterpret_cast<uint32_t*>(stg + (r * 16 + g + 8 * hf) * kNP + n0) =
                    pack_bf16(z[r][nf][2 * hf] + h0, z[r][nf][2 * hf + 1] + h1);
    }
}

}  // namespace conv64
