// ConvNeXtV2 block (dw 7x7 + LN + pw1 + GELU + GRN + pw2 + residual) for
// the H100.
//
// Replaces the TPU kernel `fused_convnext_block`
// (path_gene_multimodal_tpu/ops/pallas/convnext_block.py:174, pallas_call
// at :210), which keeps one whole image VMEM-resident per grid step.
//
// Numerics follow the TPU kernel: bf16 storage, f32 accumulation, LN over C
// (eps 1e-6), bf16 rounding of the operand of each pointwise product, GELU
// by flag (tanh default; exact erf through the same Abramowitz-Stegun
// polynomial the TPU kernel uses, convnext_block.py:65-83), GRN per image
// (gx = sqrt(sum_hw y^2 + 1e-12), nx = gx / (mean_c gx + 1e-6),
// y * (gamma * nx + 1) + beta). One difference: the pw1 output y2 is stored
// in bf16 between the two launches, so the GRN affine reads bf16(y2) where
// the TPU kernel reads the f32 value (its sum of squares is taken in f32
// here as there).
//
// What bounds it here: operations. pw1 and pw2 are 2 x 4C^2 multiply-adds
// per pixel (HoverNeXt-tiny stage 0: 0.31 TFLOP per block over 512 images),
// well above the card's ~295 flop/byte balance point once the weights are
// reused across a 64-pixel tile.
//
// Design: the per-image GRN reduction sits between the two products, and
// the 4C activation of one image (stage 0: 64*64*384 bf16 = 3 MB) is far
// beyond an SM's 227 KB, so the TPU's one-image residency cannot carry
// over. The block is split into two launches over 64-pixel tiles:
//   A: dw 7x7 + bias -> LN -> pw1 (bf16 wmma, f32 accumulate) + b1 -> GELU;
//      writes y2 (bf16) and adds each tile's per-channel sum of y2^2 into a
//      per-image (B, 4C) f32 buffer (atomics);
//   B: per image, nx from that buffer; y3 = bf16(y2 * scale + beta) staged
//      through shared memory in 64-wide K chunks -> pw2 (wmma) + b2 +
//      residual -> bf16 out.
// Storing y2 (2 x 2 bytes per 4C element per pixel: write then read) was
// chosen over recomputing dw + LN + pw1 in launch B: the recompute doubles
// pw1's 4C^2 multiply-adds per pixel and the dw conv, while the store costs
// ~1 ms of HBM traffic per stage-0 block and keeps each launch simple.
// The products use the warp-level wmma API (mma.sync underneath); wgmma,
// TMA and a persistent schedule are later work.
#include "common.cuh"

#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // pixels per block (4 wmma row tiles)
constexpr int kChunk = 64;     // K chunk of launch B
constexpr int kMaxStrips = 3;  // 16-column strips of C per warp (C <= 384)

__device__ inline void load8(const bf16* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

// Launch A: one block = 64 consecutive pixels of one image.
// smem: dwo f32 [64][C] (reused as per-warp 16x16 f32 scratch) |
//       a bf16 [64][C + 8]
__global__ void __launch_bounds__(kThreads)
block_pw1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dw,
                 const bf16* __restrict__ dwb, const bf16* __restrict__ lng,
                 const bf16* __restrict__ lnb, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, bf16* __restrict__ y2,
                 float* __restrict__ gsum, int h, int w, int c, int exact) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int hw = h * w;
    const int tiles = (hw + kTile - 1) / kTile;
    const int img = blockIdx.x / tiles;
    const int p0 = (blockIdx.x % tiles) * kTile;
    const int c4 = 4 * c;
    const int lda = c + 8;
    float* dwo = reinterpret_cast<float*>(smem);
    bf16* a = reinterpret_cast<bf16*>(smem + static_cast<size_t>(kTile) * c * 4);
    const bf16* xi = x + static_cast<long long>(img) * hw * c;

    // depthwise 7x7, zero padding 3; taps summed dx-major as the TPU kernel
    const int groups = c / 8;
    for (int it = threadIdx.x; it < kTile * groups; it += kThreads) {
        const int pix = it / groups;
        const int g = it % groups;
        const int p = p0 + pix;
        float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (p < hw) {
            const int yy = p / w, xx = p % w;
            for (int dx = 0; dx < 7; ++dx) {
                const int sx = xx + dx - 3;
                if (sx < 0 || sx >= w) continue;
                for (int dy = 0; dy < 7; ++dy) {
                    const int sy = yy + dy - 3;
                    if (sy < 0 || sy >= h) continue;
                    float xv[8], wv[8];
                    load8(xi + (static_cast<long long>(sy) * w + sx) * c + g * 8, xv);
                    load8(dw + (dy * 7 + dx) * c + g * 8, wv);
#pragma unroll
                    for (int i = 0; i < 8; ++i) acc[i] += xv[i] * wv[i];
                }
            }
            float bv[8];
            load8(dwb + g * 8, bv);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] += bv[i];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) dwo[pix * c + g * 8 + i] = acc[i];
    }
    __syncthreads();

    // LayerNorm over C, one warp per pixel; bf16 result is pw1's operand
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int pix = warp; pix < kTile; pix += kWarps) {
        const float* row = dwo + pix * c;
        float s = 0.0f;
        for (int ch = lane; ch < c; ch += 32) s += row[ch];
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const float mu = s / c;
        float v = 0.0f;
        for (int ch = lane; ch < c; ch += 32) {
            const float d = row[ch] - mu;
            v += d * d;
        }
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        const float rs = rsqrtf(v / c + 1e-6f);
        const bool valid = p0 + pix < hw;
        for (int ch = lane; ch < c; ch += 32) {
            const float y = (row[ch] - mu) * rs * __bfloat162float(lng[ch]) +
                            __bfloat162float(lnb[ch]);
            a[pix * lda + ch] = __float2bfloat16(valid ? y : 0.0f);
        }
    }
    __syncthreads();

    // pw1: [64 x C] @ [C x 4C]; warp w owns 16-column strips w, w+8, ...
    float* scr = dwo + warp * 256;
    const int ksteps = c / 16;
    for (int j = warp; j < c4 / 16; j += kWarps) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[m], 0.0f);
        for (int k = 0; k < ksteps; ++k) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, w1 + static_cast<long long>(k) * 16 * c4 + j * 16, c4);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
                wmma::load_matrix_sync(afr, a + m * 16 * lda + k * 16, lda);
                wmma::mma_sync(acc[m], afr, bfr, acc[m]);
            }
        }
        const int col = lane & 15;
        const int n = j * 16 + col;
        const float bias = __bfloat162float(b1[n]);
        float sq = 0.0f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            wmma::store_matrix_sync(scr, acc[m], 16, wmma::mem_row_major);
            __syncwarp();
            for (int r = lane >> 4; r < 16; r += 2) {
                const int p = p0 + m * 16 + r;
                if (p < hw) {
                    const float v = pgm_gelu(scr[r * 16 + col] + bias, exact);
                    y2[(static_cast<long long>(img) * hw + p) * c4 + n] = __float2bfloat16(v);
                    sq += v * v;
                }
            }
            __syncwarp();
        }
        sq += __shfl_xor_sync(0xffffffffu, sq, 16);
        if (lane < 16) atomicAdd(&gsum[static_cast<long long>(img) * c4 + n], sq);
    }
}

// Launch B: one block = 64 consecutive pixels of one image.
// smem: scale f32 [4C] | shift f32 [4C] | a bf16 [64][kChunk + 8] |
//       per-warp 16x16 f32 scratch
__global__ void __launch_bounds__(kThreads)
block_pw2_kernel(const bf16* __restrict__ y2, const float* __restrict__ gsum,
                 const bf16* __restrict__ gg, const bf16* __restrict__ gb,
                 const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                 const bf16* __restrict__ x, bf16* __restrict__ out, int hw, int c) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int tiles = (hw + kTile - 1) / kTile;
    const int img = blockIdx.x / tiles;
    const int p0 = (blockIdx.x % tiles) * kTile;
    const int c4 = 4 * c;
    constexpr int lda = kChunk + 8;
    float* scale = reinterpret_cast<float*>(smem);
    float* shift = scale + c4;
    bf16* a = reinterpret_cast<bf16*>(shift + c4);
    float* scr_all = reinterpret_cast<float*>(a + kTile * lda);
    __shared__ float warp_sum[kWarps];
    __shared__ float mean_gx;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    // GRN: nx = gx / (mean_c gx + 1e-6) for this image
    float s = 0.0f;
    for (int n = threadIdx.x; n < c4; n += kThreads) {
        const float gx = sqrtf(gsum[static_cast<long long>(img) * c4 + n] + 1e-12f);
        scale[n] = gx;
        s += gx;
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) warp_sum[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        float t = 0.0f;
        for (int i = 0; i < kWarps; ++i) t += warp_sum[i];
        mean_gx = t / c4;
    }
    __syncthreads();
    for (int n = threadIdx.x; n < c4; n += kThreads) {
        const float nx = scale[n] / (mean_gx + 1e-6f);
        scale[n] = __bfloat162float(gg[n]) * nx + 1.0f;
        shift[n] = __bfloat162float(gb[n]);
    }
    __syncthreads();

    const int nstrips = c / 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxStrips][4];
#pragma unroll
    for (int si = 0; si < kMaxStrips; ++si)
#pragma unroll
        for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[si][m], 0.0f);

    const bf16* yi = y2 + static_cast<long long>(img) * hw * c4;
    for (int k0 = 0; k0 < c4; k0 += kChunk) {
        // y3 = bf16(y2 * scale + shift) for a 64 x kChunk operand chunk
        for (int it = threadIdx.x; it < kTile * (kChunk / 8); it += kThreads) {
            const int r = it / (kChunk / 8);
            const int cc = (it % (kChunk / 8)) * 8;
            const int p = p0 + r;
            float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            if (p < hw) {
                load8(yi + static_cast<long long>(p) * c4 + k0 + cc, v);
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = v[i] * scale[k0 + cc + i] + shift[k0 + cc + i];
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) a[r * lda + cc + i] = __float2bfloat16(v[i]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr[4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
                wmma::load_matrix_sync(afr[m], a + m * 16 * lda + kk * 16, lda);
#pragma unroll
            for (int si = 0; si < kMaxStrips; ++si) {
                const int j = warp + si * kWarps;
                if (j < nstrips) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
                    wmma::load_matrix_sync(
                        bfr, w2 + static_cast<long long>(k0 + kk * 16) * c + j * 16, c);
#pragma unroll
                    for (int m = 0; m < 4; ++m) wmma::mma_sync(acc[si][m], afr[m], bfr, acc[si][m]);
                }
            }
        }
        __syncthreads();
    }

    // + b2 + residual, bf16 out
    float* scr = scr_all + warp * 256;
    const int col = lane & 15;
#pragma unroll
    for (int si = 0; si < kMaxStrips; ++si) {
        const int j = warp + si * kWarps;
        if (j >= nstrips) continue;
        const int n = j * 16 + col;
        const float bias = __bfloat162float(b2[n]);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            wmma::store_matrix_sync(scr, acc[si][m], 16, wmma::mem_row_major);
            __syncwarp();
            for (int r = lane >> 4; r < 16; r += 2) {
                const int p = p0 + m * 16 + r;
                if (p < hw) {
                    const long long o = (static_cast<long long>(img) * hw + p) * c + n;
                    out[o] = __float2bfloat16(__bfloat162float(x[o]) + (scr[r * 16 + col] + bias));
                }
            }
            __syncwarp();
        }
    }
}

size_t pw1_smem(int c) {
    return static_cast<size_t>(kTile) * c * 4 + static_cast<size_t>(kTile) * (c + 8) * 2;
}

size_t pw2_smem(int c) {
    return static_cast<size_t>(8) * c * 4 + static_cast<size_t>(kTile) * (kChunk + 8) * 2 +
           static_cast<size_t>(kWarps) * 256 * 4;
}

}  // namespace

PGM_EXPORT int convnext_block_max_dim() { return 16 * kWarps * kMaxStrips; }

// x, out: (B, H, W, C) bf16; y2: (B, H*W, 4C) bf16 scratch; gsum: (B, 4C)
// f32, zeroed by the caller. Weights bf16: dw (7, 7, C), w1 (C, 4C),
// w2 (4C, C); vectors (C,) or (4C,).
PGM_EXPORT int convnext_block_launch(const void* x, const void* dw, const void* dwb,
                                     const void* lng, const void* lnb, const void* w1,
                                     const void* b1, const void* gg, const void* gb,
                                     const void* w2, const void* b2, void* y2, void* gsum,
                                     void* out, int b, int h, int w, int c, int exact,
                                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tiles = (h * w + kTile - 1) / kTile;
    cudaError_t e = pgm_set_smem(block_pw1_kernel, pw1_smem(c));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = pgm_set_smem(block_pw2_kernel, pw2_smem(c));
    if (e != cudaSuccess) return static_cast<int>(e);
    block_pw1_kernel<<<b * tiles, kThreads, pw1_smem(c), st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dw),
        static_cast<const bf16*>(dwb), static_cast<const bf16*>(lng),
        static_cast<const bf16*>(lnb), static_cast<const bf16*>(w1),
        static_cast<const bf16*>(b1), static_cast<bf16*>(y2), static_cast<float*>(gsum), h,
        w, c, exact);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    block_pw2_kernel<<<b * tiles, kThreads, pw2_smem(c), st>>>(
        static_cast<const bf16*>(y2), static_cast<const float*>(gsum),
        static_cast<const bf16*>(gg), static_cast<const bf16*>(gb),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
        static_cast<const bf16*>(x), static_cast<bf16*>(out), h * w, c);
    return static_cast<int>(cudaGetLastError());
}
