// ConvNeXtV2 block (dw 7x7 + LN + pw1 + GELU + GRN + pw2 + residual) for
// the H100, as three launches.
//
// Replaces the TPU kernel `fused_convnext_block`
// (path_gene_multimodal_tpu/ops/pallas/convnext_block.py:174, pallas_call
// at :210), which keeps one whole image VMEM-resident per grid step.
//
// Numerics follow the TPU kernel: bf16 storage, f32 accumulation, the dw
// taps summed dx-major (:114-121), LN over C in two passes (mean, then the
// centred variance; eps 1e-6, :123-126), bf16 rounding of the operand of
// each pointwise product (:131, :144-148), GELU by flag with pgm_gelu's
// arithmetic (tanh default; exact erf through the Abramowitz-Stegun
// polynomial of :65-83), GRN per image
// (gx = sqrt(sum_hw y^2 + 1e-12), nx = gx / (mean_c gx + 1e-6),
// y * (gamma * nx + 1) + beta). The pw1 output y2 is stored in f32 between
// launches 1 and 2, so the GRN affine reads the f32 value, as the TPU
// kernel does, and y3 is the first rounding after it. The LN output `a` is
// stored in bf16 between launches 0 and 1, which is no rounding point of
// its own: it is the operand the TPU kernel rounds before pw1.
//
// Why three launches: the per-image GRN reduction sits between the two
// products, and an image's 4C activation (stage 0: 64*64*384 bf16 = 3 MB)
// is far beyond an SM's 227 KB, so the TPU's one-image residency cannot
// carry over; and an f32 C-wide dw tile beside a weight ring does not fit
// either at C = 384. So each launch is what the card does simply:
//   0 (dw_ln_kernel): dw 7x7 + bias + LN -> bf16 a (B, H*W, C). CUDA cores.
//     A block walks a strip of rows of one column tile, four output rows
//     per step; the input rows they need slide through a ring of 14 rows in
//     shared memory (10 read, the next step's 4 copied ahead with
//     cp.async, zeros outside the image: the conv's padding), so each input
//     value is read from device memory once per column tile. A thread owns
//     4 channels of one column for the 4 rows: each value it loads serves
//     up to 4 taps, each weight 4 rows. Bound by bytes (x in, a out) in
//     principle; in practice by the CUDA cores' issue rate (49 taps).
//   1 (pw1_kernel): a @ w1 + b1 -> GELU -> f32 y2 (B, H*W, 4C), and the
//     per-image, per-channel sums of y2^2 (f32, unrounded) into gsum: each
//     tile stores its own sums, and the last of an image's tiles to finish
//     (a counter per image and N tile) adds them in tile order, so that the
//     sums, and the block's output, do not depend on the order in which the
//     blocks ran. An ordinary pipelined GEMM: 128-pixel x
//     128-channel tiles, two consumer warpgroups of m64 each on wgmma
//     (m64n128k16), A and B through a 4-stage cp.async ring of 32-deep K
//     chunks in wgmma's canonical no-swizzle K-major layout, one wgmma group
//     kept in flight; y2 leaves through shared memory in 16-byte row stores.
//   2 (pw2_kernel<NT>): per image scale = gamma * nx + 1 and shift = beta
//     from gsum; each f32 y2 chunk lands in the ring stage as it is, and the
//     thread that copied a piece turns it into bf16(y2 * scale + shift) in
//     the stage's bf16 A tile (the TPU's rounding point; the scale is not
//     folded into w2, which would move it) before wgmma reads it;
//     [px x 4C] @ [4C x NT] on a ring of 5 or 6 stages, NT = C up to 192
//     (C = 384 as two halves); + b2 + the residual x, bf16 out through
//     shared memory.
// What bounds them: launch 0 and stage 0's launches 1-2 by bytes (y2 is
// 4C wide and f32: 3.2 GB written and read per stage-0 call of 512 images), the
// stage-2 products (C = 384: 2 x 4C^2 multiply-adds per pixel) by
// operations. A 128-pixel tile lies in one image (H*W = 4096, 1024, 256 at
// the stages; any other H*W gets a masked last tile per image).
// The weights of the products come as nn.Linear keeps them: w1t (4C, C)
// and w2t (C, 4C), K contiguous, which is what a K-major B operand is.
// Any C from 1 to 2048: where C is no multiple of 32, the products run at
// cp = C rounded up to 32, on weights the wrapper pads with zeros (w1t
// (4 cp, cp), w2t (cp, 4 cp), b1 and the GRN vectors 4 cp), so that every K
// chunk and N tile is whole: launch 0 writes zeros into a's channels past C,
// pw1's padded channels come out GELU(0) = 0, their GRN sums 0, and pw2
// takes the GRN mean over the true 4C, writes only the channels below C and
// reads x there alone. Launch 0 has two routes: the ring above where C is a
// multiple of 32 up to 384 (HoverNeXt-tiny's widths), and the any route
// (dw_ln_any_kernel) for every other C: a block of 4 output rows and a
// column tile keeps its pixels' f32 LN input for all C in shared memory
// (at most 96 KB: the tile narrows as C grows) while the channels go by in
// chunks of 32 through an f32 halo, and a warp a pixel takes the two-pass LN
// over the true C. pw2's ring loses a stage where a wide C's GRN vectors
// (8 cp f32) would not fit beside it.
// The launch geometry is ops/convnext_block.py::ConvNeXtTiling; each
// launcher refuses a geometry that differs from its own.
// Not yet here: TMA, warp specialisation (the GELU epilogue of pw1 does not
// overlap its products and copies but by a second block on the SM).
#include "common.cuh"
#include "hopper.cuh"

#include <climits>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kM = 128;        // pixels per GEMM tile: two m64 warpgroups
constexpr int kN1 = 128;       // pw1 output channels per tile
constexpr int kKc = 32;        // K chunk per ring stage: two k16 steps
// ring depth: kStages - 2 chunks copied ahead, one wgmma group in flight; a
// pw2 stage holds the f32 y2 chunk beside its bf16 A tile, so at N = 192 five
// stages fit a block's shared memory
constexpr int kStages1 = 4;
__host__ __device__ constexpr int stages2(int nt) { return nt >= 192 ? 5 : 6; }
constexpr int kThreads = 256;  // GEMM blocks
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // dw output rows a thread computes per step
constexpr int kRing = 14;      // dw input rows held: kRows + 6 read, kRows copied ahead
constexpr int kRingMaxC = 384;  // the ring route of launch 0: C a multiple of 32 up to here
constexpr int kMaxC = 2048;     // any route: C (padded to 32) up to here
constexpr int kMaxStrip = 64;  // dw rows per block
constexpr int kDwMaxThreads = 768;
constexpr int kLdY = kN1 + 4;  // f32 row stride of pw1's output staging
constexpr size_t kChunkA = size_t(kM) * kKc;  // bf16 elements of one A chunk
constexpr size_t kSmemMax = 232448;           // shared memory a block can take
// launch 0's any route: output rows a block, channels a chunk, threads,
// and the f32 LN input it keeps (bytes)
constexpr int kAnyRows = 4;
constexpr int kAnyCc = 32;
constexpr int kAnyThreads = 256;
constexpr size_t kAnyAccBytes = 96 * 1024;

int pad_c(int c) { return (c + kKc - 1) / kKc * kKc; }
bool channels_ok(int c) { return c > 0 && pad_c(c) <= kMaxC; }
// launch 0 takes the ring route (the geometry of PR 19) where C fits it
bool ring_route(int c) { return c % kKc == 0 && c <= kRingMaxC; }

// ------------------------------------------------------------ geometry

int dw_tile_w(int c) {
    int tw = ring_route(c) ? 64 : 16;
    if (ring_route(c))
        while (tw * c / 4 > kDwMaxThreads) tw /= 2;
    else
        while (tw > 1 && size_t(kAnyRows) * tw * c * 4 > kAnyAccBytes) tw /= 2;
    return tw;
}
int dw_strip(int h, int c) {
    if (!ring_route(c)) return kAnyRows;
    return h < kMaxStrip ? h : kMaxStrip;
}
int dw_threads(int c) { return ring_route(c) ? dw_tile_w(c) * c / 4 : kAnyThreads; }
size_t dw_smem(int c) {
    const int tw = dw_tile_w(c);
    if (!ring_route(c))
        return size_t(kAnyRows) * tw * c * 4 + size_t(kAnyRows + 6) * (tw + 6) * kAnyCc * 4;
    const int threads = tw * c / 4;
    return size_t(kRing) * (tw + 6) * c * 2 + size_t(49) * c * 4 +
           size_t(kRows) * (threads / 8 + tw) * 4;
}
constexpr size_t kRing1 = size_t(kStages1) * (kChunkA + size_t(kN1) * kKc) * 2;
constexpr size_t kStaging1 = size_t(kM) * kLdY * 4;
// the ring, which the f32 y2 staging later lies over, and the per-warp sums
constexpr size_t kRegion1 = kRing1 > kStaging1 ? kRing1 : kStaging1;
size_t pw1_smem() { return kRegion1 + kWarps * kN1 * 4; }
int pw2_n_tile(int cp) {
    constexpr int kTiles[] = {192, 128, 96, 64, 32};
    for (int nt : kTiles)
        if (cp % nt == 0) return nt;
    return 0;
}
// a pw2 stage: the f32 y2 chunk, its bf16 A tile, the bf16 w2 chunk
__host__ __device__ constexpr size_t stage2_elems(int nt) {
    return kChunkA * 2 + kChunkA + size_t(nt) * kKc;
}
size_t pw2_smem_at(int cp, int nt, int stages) {
    return size_t(stages) * stage2_elems(nt) * 2 + size_t(8) * cp * 4;
}
// the ring's depth: five stages at the 192-wide N tile, six otherwise, one
// fewer while the ring and the GRN vectors of a wide C do not fit
int pw2_stages(int cp, int nt) {
    int s = stages2(nt);
    while (s > 3 && pw2_smem_at(cp, nt, s) > kSmemMax) --s;
    return s;
}
size_t pw2_smem(int cp, int nt) { return pw2_smem_at(cp, nt, pw2_stages(cp, nt)); }

// ------------------------------------------------------------ launch 0

// vector loads from shared memory as one instruction each (the compiler
// otherwise splits a vector load whose lanes are used one by one)
__device__ __forceinline__ float4 lds_f4(const float* p) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(smem_u32(p))
                 : "memory");
    return v;
}
__device__ __forceinline__ uint2 lds_u2(const void* p) {
    uint2 v;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(smem_u32(p))
                 : "memory");
    return v;
}

__device__ __forceinline__ void unpack4(const uint2& raw, float* v) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

struct DwArgs {
    const bf16* x;    // (B, H, W, C)
    const bf16* dw;   // (7, 7, C)
    const bf16* dwb;  // (C,)
    const bf16* lng;
    const bf16* lnb;
    bf16* a;          // (B, H * W, C)
    int h, w, c, tile_w, strip, strips, ctiles;
};

// One block: image img, rows y0 .. y0 + strip - 1, columns x0 .. x0 +
// tile_w - 1; thread (px, g) = (tid / (C/4), tid % (C/4)) owns column
// x0 + px and channels 4 g .. 4 g + 3, and computes kRows output rows per
// step: each input value it loads serves up to 4 taps, each weight 4. The
// 8 threads of 32 consecutive channels (C/4 is a multiple of 8) sum the LN
// statistics by shuffles. smem: ring [kRing][tile_w + 6][C] bf16 | dw f32
// [49][C] | partial sums f32 [kRows][tile_w][C/32] | statistic f32
// [kRows][tile_w]
__global__ void __launch_bounds__(kDwMaxThreads, 1) dw_ln_kernel(const DwArgs p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int c = p.c, G = c / 4, NG = G / 8, tw = p.tile_w;
    const int slot = (tw + 6) * c;
    bf16* ring = reinterpret_cast<bf16*>(smem);
    float* wts = reinterpret_cast<float*>(ring + kRing * slot);
    float* part = wts + 49 * c;
    float* stat = part + kRows * tw * NG;

    int bid = blockIdx.x;
    const int ct = bid % p.ctiles;
    bid /= p.ctiles;
    const int y0 = (bid % p.strips) * p.strip;
    const long long img = bid / p.strips;
    const int x0 = ct * tw;
    const int y1 = min(y0 + p.strip, p.h);
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int px = tid / G, g = tid % G;
    const bf16* xi = p.x + img * p.h * p.w * c;

    // input row r (>= -3) into its ring slot, zero outside the image
    auto load_row = [&](int r) {
        bf16* dst = ring + ((r + kRing) % kRing) * slot;
        const bool row_ok = r >= 0 && r < p.h;
        const int c8 = c / 8;
        for (int i = tid; i < (tw + 6) * c8; i += nthr) {
            const int col = i / c8, cg = i - col * c8;
            const int sx = x0 - 3 + col;
            const bool ok = row_ok && sx >= 0 && sx < p.w;
            const bf16* src = ok ? xi + (static_cast<long long>(r) * p.w + sx) * c + cg * 8 : p.x;
            cp_async16(dst + col * c + cg * 8, src, ok);
        }
    };
    for (int r = y0 - 3; r < y0 + kRows + 3; ++r) load_row(r);
    cp_async_commit();
    for (int i = tid; i < 49 * c / 8; i += nthr) {
        float v[8];
        unpack8(reinterpret_cast<const uint4*>(p.dw)[i], v);
        reinterpret_cast<float4*>(wts)[2 * i] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(wts)[2 * i + 1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    float bias[4];
    unpack4(reinterpret_cast<const uint2*>(p.dwb)[g], bias);
    const bool col_ok = x0 + px < p.w;
    const float inv_c = 1.0f / c;

    for (int y = y0; y < y1; y += kRows) {
        // the slots of rows y + 7 .. y + 10 held rows y - 7 .. y - 4, last
        // read by the previous step
        if (y + kRows < y1)
            for (int r = y + kRows + 3; r < y + 2 * kRows + 3; ++r) load_row(r);
        cp_async_commit();
        cp_async_wait<1>();  // rows up to y + kRows + 2 have landed
        __syncthreads();

        // taps summed dx-major, as the TPU kernel: input row y - 3 + r is
        // tap dy = r - o of output row y + o
        const int s0 = (y - 3 + kRing) % kRing;
        float acc[kRows][4];
#pragma unroll
        for (int o = 0; o < kRows; ++o)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[o][i] = 0.0f;
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
            // tap dy is read by input rows dy .. dy + kRows - 1: a rolling
            // window of kRows weights (slot dy % kRows) is live at a time
            float4 wv[kRows];
#pragma unroll
            for (int r = 0; r < kRows + 6; ++r) {
                if (r < 7) wv[r % kRows] = lds_f4(wts + (r * 7 + dx) * c + 4 * g);
                int sl = s0 + r;
                if (sl >= kRing) sl -= kRing;
                float xv[4];
                unpack4(lds_u2(ring + sl * slot + (px + dx) * c + 4 * g), xv);
#pragma unroll
                for (int o = 0; o < kRows; ++o) {
                    const int dy = r - o;
                    if (dy >= 0 && dy < 7) {
                        const float4 wd = wv[dy % kRows];
                        acc[o][0] += xv[0] * wd.x;
                        acc[o][1] += xv[1] * wd.y;
                        acc[o][2] += xv[2] * wd.z;
                        acc[o][3] += xv[3] * wd.w;
                    }
                }
            }
        }

        // LayerNorm over C of each output row: the mean, then the centred variance
        float sm[kRows];
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
            sm[o] = 0.0f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[o][i] += bias[i];
                sm[o] += acc[o][i];
            }
        }
        for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
            for (int o = 0; o < kRows; ++o)
#pragma unroll
                for (int off = 1; off < 8; off <<= 1)
                    sm[o] += __shfl_xor_sync(0xffffffffu, sm[o], off);
            if ((tid & 7) == 0)
#pragma unroll
                for (int o = 0; o < kRows; ++o) part[(o * tw + px) * NG + g / 8] = sm[o];
            __syncthreads();
            if (tid < kRows * tw) {
                float t = 0.0f;
                for (int k = 0; k < NG; ++k) t += part[tid * NG + k];
                stat[tid] = pass == 0 ? t * inv_c : rsqrtf(t * inv_c + 1e-6f);
            }
            __syncthreads();
            if (pass == 0) {
#pragma unroll
                for (int o = 0; o < kRows; ++o) {
                    const float mu = stat[o * tw + px];
                    sm[o] = 0.0f;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        acc[o][i] -= mu;
                        sm[o] += acc[o][i] * acc[o][i];
                    }
                }
            }
        }
        float lg[4], lb[4];
        unpack4(reinterpret_cast<const uint2*>(p.lng)[g], lg);
        unpack4(reinterpret_cast<const uint2*>(p.lnb)[g], lb);
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
            const float rs = stat[o * tw + px];
            if (col_ok && y + o < y1) {
                float v[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) v[i] = __fmaf_rn(acc[o][i] * rs, lg[i], lb[i]);
                *reinterpret_cast<uint2*>(p.a + ((img * p.h + y + o) * p.w + x0 + px) * c + 4 * g) =
                    make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
            }
        }
    }
    cp_async_wait<0>();
}

// Launch 0, any route: C not a multiple of 32, or over the ring's 384. One
// block of 256 threads: image img, output rows y0 .. y0 + 3, columns x0 ..
// x0 + tile_w - 1 (P = 4 tile_w pixels). The channels go by in chunks of 32:
// the chunk's input rows y0 - 3 .. y0 + 6 and columns x0 - 3 .. x0 +
// tile_w + 2 land in shared memory as f32 (zero outside the image and past
// C: the conv's padding), then warp k computes pixels k, k + 8, ... with a
// lane a channel, the 49 weights of its channel in registers, the taps
// summed dx-major as the TPU kernel sums them, + bias, into the block's f32
// LN input [P][C]. Then a warp a pixel: the mean over the true C, the
// centred variance, the affine, bf16 out into a (B, H * W, cp), zeros in
// channels C .. cp - 1 (the operand pw1's padded K chunk reads).
// smem: LN input f32 [P][C] | halo f32 [kAnyRows + 6][tile_w + 6][32]
__global__ void __launch_bounds__(kAnyThreads) dw_ln_any_kernel(const DwArgs p, int cp) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int c = p.c, tw = p.tile_w, np = kAnyRows * tw, hw_ = tw + 6;
    float* acc = reinterpret_cast<float*>(smem);
    float* halo = acc + np * c;

    int bid = blockIdx.x;
    const int ct = bid % p.ctiles;
    bid /= p.ctiles;
    const int y0 = (bid % p.strips) * kAnyRows;
    const long long img = bid / p.strips;
    const int x0 = ct * tw;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int kW = kAnyThreads / 32;
    const bf16* xi = p.x + img * p.h * p.w * c;

    for (int c0 = 0; c0 < c; c0 += kAnyCc) {
        const int ch = c0 + lane;
        for (int i = tid; i < (kAnyRows + 6) * hw_ * kAnyCc; i += kAnyThreads) {
            const int j = i % kAnyCc, col = (i / kAnyCc) % hw_, row = i / (kAnyCc * hw_);
            const int sy = y0 - 3 + row, sx = x0 - 3 + col;
            const bool ok = sy >= 0 && sy < p.h && sx >= 0 && sx < p.w && c0 + j < c;
            const long long at = (static_cast<long long>(sy) * p.w + sx) * c + c0 + j;
            halo[i] = ok ? __bfloat162float(xi[at]) : 0.0f;
        }
        float wk[49];
#pragma unroll
        for (int t = 0; t < 49; ++t) wk[t] = ch < c ? __bfloat162float(p.dw[t * c + ch]) : 0.0f;
        const float bias = ch < c ? __bfloat162float(p.dwb[ch]) : 0.0f;
        __syncthreads();
        for (int px = warp; px < np; px += kW) {
            const int py = px / tw, pxx = px - py * tw;
            float a = 0.0f;
#pragma unroll
            for (int dx = 0; dx < 7; ++dx)
#pragma unroll
                for (int dy = 0; dy < 7; ++dy)
                    a += halo[((py + dy) * hw_ + pxx + dx) * kAnyCc + lane] * wk[dy * 7 + dx];
            if (ch < c) acc[px * c + ch] = a + bias;
        }
        __syncthreads();  // the halo is the next chunk's
    }

    const float inv_c = 1.0f / c;
    for (int px = warp; px < np; px += kW) {
        const int py = px / tw, pxx = px - py * tw;
        if (y0 + py >= p.h || x0 + pxx >= p.w) continue;  // uniform over the warp
        const float* v = acc + px * c;
        float sm = 0.0f;
        for (int k = lane; k < c; k += 32) sm += v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sm += __shfl_xor_sync(0xffffffffu, sm, off);
        const float mu = sm * inv_c;
        float sq = 0.0f;
        for (int k = lane; k < c; k += 32) {
            const float d = v[k] - mu;
            sq += d * d;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
        const float rs = rsqrtf(sq * inv_c + 1e-6f);
        bf16* out = p.a + ((img * p.h + y0 + py) * p.w + x0 + pxx) * cp;
        for (int k = lane; k < cp; k += 32)
            out[k] = __float2bfloat16(k < c ? __fmaf_rn((v[k] - mu) * rs,
                                                        __bfloat162float(p.lng[k]),
                                                        __bfloat162float(p.lnb[k]))
                                            : 0.0f);
    }
}

// ------------------------------------------------------------ launches 1, 2

// Chunk kc of a GEMM tile into a ring stage, canonical K-major: element
// (row, k) of a 32-deep chunk at ((k / 8) * rows + row) * 8 + k % 8. Two
// threads copy one 32-byte sector of a row; rows past `valid` are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int rows,
                                          int valid, int k0) {
    for (int i = threadIdx.x; i < rows * 4; i += kThreads) {
        const int r = (i >> 1) % rows, kg = (i / (2 * rows)) * 2 + (i & 1);
        const bool ok = r < valid;
        cp_async16(dst + (kg * rows + r) * 8, ok ? src + r * ld + k0 + kg * 8 : src, ok);
    }
}

// The f32 twin of load_rows: element (row, k) of a 32-deep chunk at
// ((k / 8) * rows + row) * 8 + k % 8 floats, each thread copying the two
// 16-byte halves of one 8-float group (so that it can convert the group
// alone once its own copies have landed); rows past `valid` are zero.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long ld,
                                              int rows, int valid, int k0) {
    for (int i = threadIdx.x; i < rows * 4; i += kThreads) {
        const int r = (i >> 1) % rows, kg = (i / (2 * rows)) * 2 + (i & 1);
        const bool ok = r < valid;
        const float* s = ok ? src + r * ld + k0 + kg * 8 : src;
        float* d = dst + (kg * rows + r) * 8;
        cp_async16(d, s, ok);
        cp_async16(d + 4, ok ? s + 4 : s, ok);
    }
}

// pw1: block (m tile, n tile), n fastest; smem: ring (later the f32 staging)
// | reduction f32 [8][128]
__global__ void __launch_bounds__(kThreads, 2)
pw1_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w1t, const bf16* __restrict__ b1,
           float* __restrict__ y2, float* __restrict__ gsum, int hw, int c, int tiles_per_img,
           int exact) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* ring = reinterpret_cast<bf16*>(smem);
    constexpr size_t kStage = kChunkA + size_t(kN1) * kKc;
    float* red = reinterpret_cast<float*>(smem + kRegion1);

    const int c4 = 4 * c, ntiles = c4 / kN1;
    const int nt = blockIdx.x % ntiles, mt = blockIdx.x / ntiles;
    const long long img = mt / tiles_per_img;
    const int p0 = (mt % tiles_per_img) * kM, n0 = nt * kN1;
    const int valid = min(kM, hw - p0);
    const bf16* ai = a + (img * hw + p0) * c;
    const bf16* bi = w1t + static_cast<long long>(n0) * c;
    const int nk = c / kKc;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;

    auto load = [&](int kc) {
        bf16* st = ring + (kc % kStages1) * kStage;
        load_rows(st, ai, c, kM, valid, kc * kKc);
        load_rows(st + kChunkA, bi, c, kN1, kN1, kc * kKc);
    };
#pragma unroll
    for (int s = 0; s < kStages1 - 2; ++s) {
        if (s < nk) load(s);
        cp_async_commit();
    }
    float acc[kN1 / 2];
#pragma unroll
    for (int j = 0; j < kN1 / 2; ++j) acc[j] = 0.0f;
    for (int kc = 0; kc < nk; ++kc) {
        cp_async_wait<kStages1 - 3>();  // chunk kc has landed
        fence_async_shared();
        __syncthreads();  // ... for every thread; chunk kc - 2's wgmma is done
        if (kc + kStages1 - 2 < nk) load(kc + kStages1 - 2);
        cp_async_commit();
        const uint32_t sa = smem_u32(ring + (kc % kStages1) * kStage);
        const uint32_t sb = sa + kChunkA * 2;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kKc / 16; ++s)
            wgmma_bf16<kN1>(acc, desc(sa + (2 * s * kM + 64 * wg) * 16, kM * 16, 128),
                            desc(sb + 2 * s * kN1 * 16, kN1 * 16, 128), 1);
        wgmma_commit();
        wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kN1 / 2; ++j) pin(acc[j]);
    cp_async_wait<0>();
    __syncthreads();  // both warpgroups are done with the ring: it becomes the staging

    // + b1, GELU; y2 into the f32 staging, its square summed over this
    // tile's valid pixels per channel
    float* stg = reinterpret_cast<float*>(smem);
    const int r0 = 64 * wg + 16 * wq + g;
    const bool v0 = r0 < valid, v1 = r0 + 8 < valid;
#pragma unroll
    for (int nf = 0; nf < kN1 / 8; ++nf) {
        const int col = nf * 8 + 2 * q;
        const float bb0 = __bfloat162float(b1[n0 + col]), bb1 = __bfloat162float(b1[n0 + col + 1]);
        const float e00 = pgm_gelu(acc[4 * nf] + bb0, exact);
        const float e01 = pgm_gelu(acc[4 * nf + 1] + bb1, exact);
        const float e10 = pgm_gelu(acc[4 * nf + 2] + bb0, exact);
        const float e11 = pgm_gelu(acc[4 * nf + 3] + bb1, exact);
        *reinterpret_cast<float2*>(stg + r0 * kLdY + col) = make_float2(e00, e01);
        *reinterpret_cast<float2*>(stg + (r0 + 8) * kLdY + col) = make_float2(e10, e11);
        float s0 = (v0 ? e00 * e00 : 0.0f) + (v1 ? e10 * e10 : 0.0f);
        float s1 = (v0 ? e01 * e01 : 0.0f) + (v1 ? e11 * e11 : 0.0f);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (g == 0) {
            red[warp * kN1 + col] = s0;
            red[warp * kN1 + col + 1] = s1;
        }
    }
    __syncthreads();
    float* yo = y2 + (img * hw + p0) * c4 + n0;
    for (int i = tid; i < kM * (kN1 / 4); i += kThreads) {
        const int r = i / (kN1 / 4), ch = i % (kN1 / 4);
        if (r < valid)
            *reinterpret_cast<float4*>(yo + static_cast<long long>(r) * c4 + ch * 4) =
                *reinterpret_cast<const float4*>(stg + r * kLdY + ch * 4);
    }
    // the grn scratch behind gsum (B, 4C): the tiles' sums (B, tiles, 4C),
    // then a counter per (image, N tile), zero between launches
    const long long nb = gridDim.x / (static_cast<long long>(tiles_per_img) * ntiles);
    float* part = gsum + nb * c4;
    unsigned* count = reinterpret_cast<unsigned*>(part + nb * tiles_per_img * c4);
    const long long row = img * tiles_per_img;
    if (tid < kN1) {
        float t = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += red[w * kN1 + tid];
        part[(row + mt % tiles_per_img) * c4 + n0 + tid] = t;
        __threadfence();
    }
    __shared__ int last;
    __syncthreads();
    if (tid == 0) {
        last = atomicAdd(count + img * ntiles + nt, 1u) == static_cast<unsigned>(tiles_per_img - 1);
        if (last) count[img * ntiles + nt] = 0;
    }
    __syncthreads();
    if (last && tid < kN1) {
        float s = 0.0f;
        for (int k = 0; k < tiles_per_img; ++k) s += __ldcg(part + (row + k) * c4 + n0 + tid);
        gsum[img * c4 + n0 + tid] = s;
    }
}

// pw2: block (m tile, n tile), n fastest; smem: ring of kS stages [f32 y2
// chunk | bf16 A tile | w2 chunk] | scale f32 [4 cp] | shift f32 [4 cp].
// K and N run over the padded cp (w2t (cp, 4 cp), the GRN vectors 4 cp;
// zero past C); x and out are (B, H*W, C), and the GRN mean is over the
// true 4C.
template <int NT, int kS>
__global__ void __launch_bounds__(kThreads, 1)
pw2_kernel(const float* __restrict__ y2, const float* __restrict__ gsum,
           const bf16* __restrict__ gg, const bf16* __restrict__ gb, const bf16* __restrict__ w2t,
           const bf16* __restrict__ b2, const bf16* __restrict__ x, bf16* __restrict__ out,
           int hw, int c, int cp, int tiles_per_img) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr size_t kStage = stage2_elems(NT);  // bf16 units
    constexpr int kLdO = NT + 8;
    static_assert(kM * kLdO <= kS * kStage, "pw2 staging fits the ring");
    bf16* ring = reinterpret_cast<bf16*>(smem);
    const int c4 = 4 * cp;
    float* scale = reinterpret_cast<float*>(ring + kS * kStage);
    float* shift = scale + c4;
    __shared__ double warp_sum[kWarps];

    const int ntiles = cp / NT;
    const int nt = blockIdx.x % ntiles, mt = blockIdx.x / ntiles;
    const long long img = mt / tiles_per_img;
    const int p0 = (mt % tiles_per_img) * kM, n0 = nt * NT;
    const int valid = min(kM, hw - p0);
    const float* ai = y2 + (img * hw + p0) * c4;
    const bf16* bi = w2t + static_cast<long long>(n0) * c4;
    const int nk = c4 / kKc;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;

    auto load = [&](int kc) {
        bf16* st = ring + (kc % kS) * kStage;
        load_rows_f32(reinterpret_cast<float*>(st), ai, c4, kM, valid, kc * kKc);
        load_rows(st + 3 * kChunkA, bi, c4, NT, NT, kc * kKc);
    };
#pragma unroll
    for (int s = 0; s < kS - 2; ++s) {
        if (s < nk) load(s);
        cp_async_commit();
    }

    // GRN of this image: scale = gamma * nx + 1, shift = beta. The mean of
    // gx over 4C is summed in f64 and rounded once to f32, so that it does
    // not depend on the order of the sum (the plain version takes the same
    // value); the affine steps are fused multiply-adds, rounded once, as the
    // plain version and the JAX reference on the CPU compute them.
    double s = 0.0;
    for (int n = tid; n < c4; n += kThreads) {
        const float gx = sqrtf(gsum[img * c4 + n] + 1e-12f);
        scale[n] = gx;
        if (n < 4 * c) s += gx;
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) warp_sum[warp] = s;
    __syncthreads();
    double tot = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += warp_sum[w];
    const float denom = static_cast<float>(tot / (4 * c)) + 1e-6f;
    for (int n = tid; n < c4; n += kThreads) {
        const float nx = scale[n] / denom;
        scale[n] = __fmaf_rn(__bfloat162float(gg[n]), nx, 1.0f);
        shift[n] = __bfloat162float(gb[n]);
    }
    __syncthreads();

    float acc[NT / 2];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) acc[j] = 0.0f;
    for (int kc = 0; kc < nk; ++kc) {
        cp_async_wait<kS - 3>();  // this thread's copies of chunk kc have landed
        // y3 = bf16(y2 * scale + shift) into the bf16 A tile, from the f32
        // groups this thread copied
        bf16* st = ring + (kc % kS) * kStage;
        const float* fa = reinterpret_cast<const float*>(st);
        bf16* ab = st + 2 * kChunkA;
        const int k0 = kc * kKc;
        for (int i = tid; i < kM * 4; i += kThreads) {
            const int r = (i >> 1) % kM, kg = (i / (2 * kM)) * 2 + (i & 1);
            const int e = (kg * kM + r) * 8;
            const float4 y0 = lds_f4(fa + e), y1 = lds_f4(fa + e + 4);
            float v[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
            const float* sc = scale + k0 + kg * 8;
            const float* sh = shift + k0 + kg * 8;
            const float4 s0 = lds_f4(sc), s1 = lds_f4(sc + 4), h0 = lds_f4(sh), h1 = lds_f4(sh + 4);
            v[0] = __fmaf_rn(v[0], s0.x, h0.x); v[1] = __fmaf_rn(v[1], s0.y, h0.y);
            v[2] = __fmaf_rn(v[2], s0.z, h0.z); v[3] = __fmaf_rn(v[3], s0.w, h0.w);
            v[4] = __fmaf_rn(v[4], s1.x, h1.x); v[5] = __fmaf_rn(v[5], s1.y, h1.y);
            v[6] = __fmaf_rn(v[6], s1.z, h1.z); v[7] = __fmaf_rn(v[7], s1.w, h1.w);
            *reinterpret_cast<uint4*>(ab + e) = pack8(v);
        }
        fence_async_shared();
        __syncthreads();  // chunk kc complete for every thread; chunk kc - 2's wgmma is done
        if (kc + kS - 2 < nk) load(kc + kS - 2);
        cp_async_commit();
        const uint32_t sa = smem_u32(ab);
        const uint32_t sb = sa + kChunkA * 2;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kKc / 16; ++k)
            wgmma_bf16<NT>(acc, desc(sa + (2 * k * kM + 64 * wg) * 16, kM * 16, 128),
                           desc(sb + 2 * k * NT * 16, NT * 16, 128), 1);
        wgmma_commit();
        wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) pin(acc[j]);
    cp_async_wait<0>();
    __syncthreads();  // the ring becomes the output staging

    // + b2 + residual x, rounded once to bf16
    bf16* stg = ring;
    const int r0 = 64 * wg + 16 * wq + g;
    if (c != cp) {  // C no multiple of 32: channels one by one, those past C dropped
#pragma unroll
        for (int nf = 0; nf < NT / 8; ++nf) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int r = r0 + 8 * hf;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = nf * 8 + 2 * q + e, ch = n0 + col;
                    float o = 0.0f;
                    if (r < valid && ch < c)
                        o = __bfloat162float(x[(img * hw + p0 + r) * c + ch]) +
                            (acc[4 * nf + 2 * hf + e] + __bfloat162float(b2[ch]));
                    stg[r * kLdO + col] = __float2bfloat16(o);
                }
            }
        }
        __syncthreads();
        for (int i = tid; i < kM * NT; i += kThreads) {
            const int r = i / NT, col = i % NT;
            if (r < valid && n0 + col < c)
                out[(img * hw + p0 + r) * c + n0 + col] = stg[r * kLdO + col];
        }
        return;
    }
#pragma unroll
    for (int nf = 0; nf < NT / 8; ++nf) {
        const int col = nf * 8 + 2 * q;
        const float bb0 = __bfloat162float(b2[n0 + col]), bb1 = __bfloat162float(b2[n0 + col + 1]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + 8 * hf;
            float o0 = 0.0f, o1 = 0.0f;
            if (r < valid) {
                const uint32_t xw = __ldg(reinterpret_cast<const unsigned int*>(
                    x + (img * hw + p0 + r) * c + n0 + col));
                const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw));
                o0 = xr.x + (acc[4 * nf + 2 * hf] + bb0);
                o1 = xr.y + (acc[4 * nf + 2 * hf + 1] + bb1);
            }
            *reinterpret_cast<uint32_t*>(stg + r * kLdO + col) = pack_bf16(o0, o1);
        }
    }
    __syncthreads();
    bf16* oo = out + (img * hw + p0) * c + n0;
    for (int i = tid; i < kM * (NT / 8); i += kThreads) {
        const int r = i / (NT / 8), ch = i % (NT / 8);
        if (r < valid)
            *reinterpret_cast<uint4*>(oo + static_cast<long long>(r) * c + ch * 8) =
                *reinterpret_cast<const uint4*>(stg + r * kLdO + ch * 8);
    }
}

// the block counts of launches 1 and 2, INT_MAX-checked
bool gemm_blocks(int b, int hw, int ntiles, int* tiles_per_img, int* blocks) {
    *tiles_per_img = (hw + kM - 1) / kM;
    const long long n = static_cast<long long>(b) * *tiles_per_img * ntiles;
    if (b <= 0 || hw <= 0 || n > INT_MAX) return false;
    *blocks = static_cast<int>(n);
    return true;
}

template <int NT, int S>
cudaError_t launch_pw2(const void* y2, const void* gsum, const void* gg, const void* gb,
                       const void* w2t, const void* b2, const void* x, void* out, int b, int hw,
                       int c, int cp, size_t smem, cudaStream_t st) {
    int tiles, blocks;
    if (!gemm_blocks(b, hw, cp / NT, &tiles, &blocks)) return cudaErrorInvalidValue;
    cudaError_t e = pgm_set_smem(pw2_kernel<NT, S>, smem);
    if (e != cudaSuccess) return e;
    pw2_kernel<NT, S><<<blocks, kThreads, smem, st>>>(
        static_cast<const float*>(y2), static_cast<const float*>(gsum),
        static_cast<const bf16*>(gg), static_cast<const bf16*>(gb),
        static_cast<const bf16*>(w2t), static_cast<const bf16*>(b2),
        static_cast<const bf16*>(x), static_cast<bf16*>(out), hw, c, cp, tiles);
    return cudaGetLastError();
}

}  // namespace

// Launch 0. x (B, H, W, C); dw (7, 7, C); dwb, lng, lnb (C,); a (B, H*W, cp)
// out, cp = C rounded up to 32 (zeros past C). tile_w, strip, threads, smem:
// ConvNeXtTiling's dw geometry (the ring route where C is a multiple of 32
// up to 384, the any route otherwise).
PGM_EXPORT int convnext_dw_ln_launch(const void* x, const void* dw, const void* dwb,
                                     const void* lng, const void* lnb, void* a, int b, int h,
                                     int w, int c, int tile_w, int strip, int threads, int smem,
                                     void* stream) {
    if (!channels_ok(c) || b <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
    if (tile_w != dw_tile_w(c) || strip != dw_strip(h, c) || threads != dw_threads(c) ||
        static_cast<size_t>(smem) != dw_smem(c) || dw_smem(c) > kSmemMax)
        return cudaErrorInvalidValue;
    DwArgs p{static_cast<const bf16*>(x), static_cast<const bf16*>(dw),
             static_cast<const bf16*>(dwb), static_cast<const bf16*>(lng),
             static_cast<const bf16*>(lnb), static_cast<bf16*>(a), h, w, c, tile_w, strip,
             (h + strip - 1) / strip, (w + tile_w - 1) / tile_w};
    const long long blocks = static_cast<long long>(b) * p.strips * p.ctiles;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!ring_route(c)) {
        cudaError_t e = pgm_set_smem(dw_ln_any_kernel, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        dw_ln_any_kernel<<<static_cast<int>(blocks), threads, smem, st>>>(p, pad_c(c));
        return static_cast<int>(cudaGetLastError());
    }
    cudaError_t e = pgm_set_smem(dw_ln_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dw_ln_kernel<<<static_cast<int>(blocks), threads, smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// Launch 1. a (B, H*W, cp); w1t (4 cp, cp); b1 (4 cp,); y2 (B, H*W, 4 cp) f32
// out; cp a multiple of 32 (C padded with zero weights). gsum:
// ConvNeXtTiling.grn_words f32 words, the sums (B, 4 cp) first, its
// counters zero (as the launch leaves them). m_tile, n_tile, smem:
// ConvNeXtTiling's pw1 geometry.
PGM_EXPORT int convnext_pw1_launch(const void* a, const void* w1t, const void* b1, void* y2,
                                   void* gsum, int b, int hw, int cp, int exact, int m_tile,
                                   int n_tile, int smem, void* stream) {
    if (!channels_ok(cp) || cp % kKc || m_tile != kM || n_tile != kN1 ||
        static_cast<size_t>(smem) != pw1_smem())
        return cudaErrorInvalidValue;
    int tiles, blocks;
    if (!gemm_blocks(b, hw, 4 * cp / kN1, &tiles, &blocks)) return cudaErrorInvalidValue;
    cudaError_t e = pgm_set_smem(pw1_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    pw1_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w1t), static_cast<const bf16*>(b1),
        static_cast<float*>(y2), static_cast<float*>(gsum), hw, cp, tiles, exact);
    return static_cast<int>(cudaGetLastError());
}

// Launch 2. y2 (B, H*W, 4 cp) f32; gsum: the sums (B, 4 cp) from launch 1;
// gg, gb (4 cp,); w2t (cp, 4 cp); b2 (C,); x, out (B, H*W, C). m_tile,
// n_tile, stages, smem: ConvNeXtTiling's pw2 geometry.
PGM_EXPORT int convnext_pw2_launch(const void* y2, const void* gsum, const void* gg,
                                   const void* gb, const void* w2t, const void* b2, const void* x,
                                   void* out, int b, int hw, int c, int m_tile, int n_tile,
                                   int stages, int smem, void* stream) {
    const int cp = pad_c(c);
    if (!channels_ok(c) || m_tile != kM || n_tile != pw2_n_tile(cp) ||
        stages != pw2_stages(cp, n_tile) || static_cast<size_t>(smem) != pw2_smem(cp, n_tile) ||
        static_cast<size_t>(smem) > kSmemMax)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
#define PGM_PW2(NT, S) \
    e = launch_pw2<NT, S>(y2, gsum, gg, gb, w2t, b2, x, out, b, hw, c, cp, smem, st)
    switch (n_tile * 10 + stages) {
        case 1925: PGM_PW2(192, 5); break;
        case 1924: PGM_PW2(192, 4); break;
        case 1286: PGM_PW2(128, 6); break;
        case 1285: PGM_PW2(128, 5); break;
        case 966: PGM_PW2(96, 6); break;
        case 965: PGM_PW2(96, 5); break;
        case 646: PGM_PW2(64, 6); break;
        case 645: PGM_PW2(64, 5); break;
        case 326: PGM_PW2(32, 6); break;
        default: e = cudaErrorInvalidValue;
    }
#undef PGM_PW2
    return static_cast<int>(e);
}

// The block: launches 0, 1, 2, with gsum's counters zeroed first. x, out
// (B, H, W, C); weights bf16: dw (7, 7, C), dwb, lng, lnb, b2 (C,), and in
// the padded layout (cp = C rounded up to 32, zeros past C): w1t (4 cp, cp),
// b1, gg, gb (4 cp,), w2t (cp, 4 cp); scratch a (B, H*W, cp), y2 (B, H*W,
// 4 cp) f32, gsum ConvNeXtTiling.grn_words f32 words. The geometry arguments
// are ConvNeXtTiling.launch_args().
PGM_EXPORT int convnext_block_launch(const void* x, const void* dw, const void* dwb,
                                     const void* lng, const void* lnb, const void* w1t,
                                     const void* b1, const void* gg, const void* gb,
                                     const void* w2t, const void* b2, void* a, void* y2,
                                     void* gsum, void* out, int b, int h, int w, int c, int exact,
                                     int dw_tile, int dw_rows, int dw_threads_, int dw_smem_b,
                                     int m_tile, int n1_tile, int n2_tile, int n2_stages,
                                     int pw1_smem_b, int pw2_smem_b, void* stream) {
    if (!channels_ok(c) || b <= 0) return cudaErrorInvalidValue;
    const int cp = pad_c(c);
    const size_t tiles = (static_cast<size_t>(h) * w + kM - 1) / kM, c4 = 4 * size_t(cp);
    cudaError_t e = cudaMemsetAsync(static_cast<float*>(gsum) + b * c4 * (1 + tiles), 0,
                                    sizeof(unsigned) * b * (c4 / kN1),
                                    static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    int r = convnext_dw_ln_launch(x, dw, dwb, lng, lnb, a, b, h, w, c, dw_tile, dw_rows,
                                  dw_threads_, dw_smem_b, stream);
    if (r) return r;
    r = convnext_pw1_launch(a, w1t, b1, y2, gsum, b, h * w, cp, exact, m_tile, n1_tile,
                            pw1_smem_b, stream);
    if (r) return r;
    return convnext_pw2_launch(y2, gsum, gg, gb, w2t, b2, x, out, b, h * w, c, m_tile, n2_tile,
                               n2_stages, pw2_smem_b, stream);
}
