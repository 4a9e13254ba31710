// The HoverNeXt upsampling final-stage kernels for the H100: bilinear 2x ->
// 3x3 SAME conv 64 -> 64 -> bias -> GELU, with an optional head product.
//
// Replaces two TPU kernels of path_gene_multimodal_tpu/ops/pallas/decoder.py:
//   K9  fused_upsample_final (:307, pallas_call :325): bilinear 2x (f32,
//       rounded to bf16) + 3x3 conv + bias + GELU -> bf16 (B, 2H, 2W, 64);
//   K10 fused_final_heads    (:392, pallas_call :415): the same, the GELU
//       output rounded to bf16 -> head product (64 -> nout <= 16) + bias ->
//       bf16 logits, NHWC (the TPU kernel writes NCHW).
//
// Numerics as the TPU kernels: the upsample in f32, rows first, then columns,
// each product and sum rounded on its own (no FMA contraction), rounded once
// to bf16; bf16 weights and vectors, f32 accumulation. GELU by flag, as
// pgm_gelu, each exponential through ex2.approx (tanh mode in the closed form
// x / (1 + exp(-2u)) of 0.5 x (1 + tanh(u))): within ~1e-6 |x| of pgm_gelu.
//
// What bounds them here: operations. 2 * 9 * 64 * 64 = 73,728 flops per
// output pixel against 256 bytes moved (K9), far above the card's ~295
// flops per byte: 0.62 TFLOP per 128-image call, 0.63 ms at the bf16 peak.
//
// Design (the TPU kernel's idea, upsample once into fast memory and run the
// taps from there, cut to a tile that fits an SM):
//  1. Persistent blocks: one block of two warpgroups per SM (the shared
//     memory below allows one) walks output tiles tile = blockIdx.x,
//     += gridDim.x over (image, tile row, tile col). A tile is 8 x 64 output
//     pixels; warpgroup g owns its rows 4g .. 4g + 3, each row one m64 tile.
//  2. Operands in shared memory in wgmma's canonical no-swizzle K-major
//     layout: core matrices of 8 rows (pixels or output channels) x 8
//     channels (16 B), 128 B each. The whole (3, 3, 64, 64) weight is
//     resident (73,728 B), copied once per block. The upsampled halo is held
//     planar, [channel / 8][halo pixel][8], so the A operand of any tap,
//     64 consecutive pixels of a halo row shifted by (dy, dx), is a canonical
//     operand: its 8-pixel groups 128 B apart, its two 8-channel halves one
//     plane apart. No operand passes through registers.
//  3. The low-res window a tile needs, (8/2 + 2) x (64/2 + 2) pixels x 64
//     channels, is copied with cp.async into one of two buffers (planar as
//     the halo); the next tile's copy is issued before the current tile is
//     computed. Its origin is (tile row0 / 2 - 1, tile col0 / 2 - 1): the
//     bilinear taps of the halo's rows row0 - 1 .. row0 + 8 read low-res rows
//     row0/2 - 1 .. row0/2 + 4 after the edge clamp
//     (ops/decoder.py::UpsampleTiling states the same geometry and the tests
//     check its coverage). Pixels outside the low-res image are zero-filled
//     and never read.
//  4. The upsampled halo, 10 x 66 x 64 bf16, is built once per tile from the
//     window: each upsampled element once (1.29x the tile's elements instead
//     of the 9x of a per-tap prologue). Halo pixels outside the upsampled
//     image are zero: the conv's SAME padding of the upsampled map, not the
//     upsample's clamp.
//  5. Tensor cores: per tile each warpgroup issues 36 k-steps (9 taps x four
//     16-channel chunks) x 4 rows of wgmma m64n64k16 (bf16, f32 accumulate),
//     both operands by descriptor, back to back, then one commit and one
//     wait. The K loop has no barrier, no ldmatrix and no global access.
//  6. Epilogue: bias + GELU in registers, rounded to bf16. K9 stages each
//     warp's 64 x 64 tile over the halo (free once every warpgroup's wgmma
//     has finished) and writes 16-B chunks to consecutive addresses. K10
//     runs the head product on the tensor cores (mma.sync m16n8k16: the
//     accumulator layout of a warp's 16 rows is mma's A layout), adds the
//     head bias and writes bf16 logits. Activation offsets are 64-bit: one
//     K9 call takes a 512-image TTA batch, 2^31 output elements.
// Shared memory: weights 73,728 B + halo 84,480 + 2 windows 52,224 (+ K10
// head weights 3,072) = 210,432 (213,504) B; K9's output staging lies over
// the halo.
// The resident weight, the product loop over the planar halo, the bilinear
// taps and the epilogue's bias + GELU and head product are the 64-channel
// conv core shared with K8 and K11 (csrc/conv64.cuh). Other widths and
// more than 16 head columns take csrc/decoder_conv.cu's any route.
// Not yet here: overlap of the halo build and the epilogue with the products
// (warp specialisation), TMA.
#include "common.cuh"
#include "conv64.cuh"

#include <climits>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace conv64;

constexpr int kTH = 8, kTW = 64;             // output tile (rows, cols)
constexpr int kHH = kTH + 2, kHW = kTW + 2;  // upsampled halo tile
constexpr int kHPx = kHH * kHW;
constexpr int kWH = kTH / 2 + 2, kWW = kTW / 2 + 2;  // low-res window
constexpr int kWPx = kWH * kWW;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kWarps / 4;          // warpgroups
constexpr int kRows = kTH / kGroups;         // output rows (m64 tiles) per warpgroup
static_assert(kTW == 64, "a tile row is one m64 wgmma tile");
static_assert(kRows * kGroups == kTH, "whole rows per warpgroup");

constexpr size_t kPlane = size_t(kHPx) * 16;  // bytes of one 8-channel halo plane
constexpr size_t kHaloBytes = 8 * kPlane;
constexpr size_t kWinBytes = size_t(kWPx) * kC * 2;
constexpr size_t kStgElems = size_t(kRows) * 16 * kLd;  // per warp: 4 rows x 16 pixels
static_assert(kWarps * kStgElems * 2 <= kHaloBytes, "the staging fits over the halo");
constexpr size_t kOffHalo = kWBytes;
constexpr size_t kOffWin = kOffHalo + kHaloBytes;
constexpr size_t kOffHead = kOffWin + 2 * kWinBytes;

constexpr size_t smem_bytes(bool head) { return kOffHead + (head ? kHeadBytes : 0); }

struct Args {
    const bf16* x;   // (B, h, w_, 64), half resolution
    const bf16* w;   // (3, 3, 64, 64)
    const bf16* b;   // (64,)
    const bf16* wh;  // (64, nout), K10
    const bf16* bh;  // (nout,), K10
    bf16* out;       // (B, 2h, 2w_, 64) or (B, 2h, 2w_, nout)
    int h, w_;
    int oh, ow;
    int tiles_x, tiles_per_img, n_tiles;
    int nout;
    int exact;
};

struct Tile {
    long long img;
    int oy0, ox0;  // first output row / col
};

__device__ __forceinline__ Tile tile_at(const Args& a, int t) {
    const int img = t / a.tiles_per_img, rem = t - img * a.tiles_per_img;
    const int ty = rem / a.tiles_x;
    return Tile{img, ty * kTH, (rem - ty * a.tiles_x) * kTW};
}

// the low-res window of tile t into `win`, planar: pixel (wy0 + sy, wx0 + sx),
// channels 8 c .. 8 c + 7 at (c * kWPx + sy * kWW + sx) * 8, zero-filled
// outside the image
__device__ __forceinline__ void load_window(const Args& a, int t, bf16* win) {
    const Tile tl = tile_at(a, t);
    const int wy0 = (tl.oy0 >> 1) - 1, wx0 = (tl.ox0 >> 1) - 1;
    for (int i = threadIdx.x; i < kWPx * 8; i += kThreads) {
        const int s = i >> 3, c = i & 7;
        const int y = wy0 + s / kWW, x = wx0 + s % kWW;
        const bool ok = y >= 0 && y < a.h && x >= 0 && x < a.w_;
        const bf16* src = ok ? a.x + ((tl.img * a.h + y) * a.w_ + x) * kC + c * 8 : a.x;
        cp_async16(win + (c * kWPx + s) * 8, src, ok);
    }
}

// the upsampled halo of tile t from its window, planar as the window: halo
// pixel p = hr * kHW + hc is output pixel (oy0 - 1 + hr, ox0 - 1 + hc), zero
// outside the output image
__device__ __forceinline__ void build_halo(const Args& a, int t, const bf16* win, bf16* halo) {
    const Tile tl = tile_at(a, t);
    const int wy0 = (tl.oy0 >> 1) - 1, wx0 = (tl.ox0 >> 1) - 1;
    for (int i = threadIdx.x; i < kHPx * 8; i += kThreads) {
        const int c = i / kHPx, p = i - c * kHPx;
        const int oy = tl.oy0 - 1 + p / kHW, ox = tl.ox0 - 1 + p % kHW;
        uint4 res = make_uint4(0u, 0u, 0u, 0u);
        if (oy >= 0 && oy < a.oh && ox >= 0 && ox < a.ow) {
            int r0, r1, c0, c1;
            float ra, rb, ca, cb;
            up_taps(oy, a.h, r0, r1, ra, rb);
            up_taps(ox, a.w_, c0, c1, ca, cb);
            const bf16* pl = win + c * kWPx * 8;
            r0 = (r0 - wy0) * kWW; r1 = (r1 - wy0) * kWW;
            c0 -= wx0; c1 -= wx0;
            float v00[8], v10[8], v01[8], v11[8];
            unpack8(*reinterpret_cast<const uint4*>(pl + (r0 + c0) * 8), v00);
            unpack8(*reinterpret_cast<const uint4*>(pl + (r1 + c0) * 8), v10);
            unpack8(*reinterpret_cast<const uint4*>(pl + (r0 + c1) * 8), v01);
            unpack8(*reinterpret_cast<const uint4*>(pl + (r1 + c1) * 8), v11);
            uint32_t o[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {  // rows first, then columns
                float u[2];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int e = 2 * k + j;
                    const float u0 = lerp_rn(ra, v00[e], rb, v10[e]);
                    const float u1 = lerp_rn(ra, v01[e], rb, v11[e]);
                    u[j] = lerp_rn(ca, u0, cb, u1);
                }
                o[k] = pack_bf16(u[0], u[1]);
            }
            res = make_uint4(o[0], o[1], o[2], o[3]);
        }
        *reinterpret_cast<uint4*>(halo + (c * kHPx + p) * 8) = res;
    }
}

template <bool HEAD>
__global__ void __launch_bounds__(kThreads, 1) upsample_conv_kernel(const Args a) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Ws = reinterpret_cast<bf16*>(smem);
    bf16* Hs = reinterpret_cast<bf16*>(smem + kOffHalo);
    bf16* Win = reinterpret_cast<bf16*>(smem + kOffWin);
    bf16* Hw = reinterpret_cast<bf16*>(smem + kOffHead);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
    const int g = lane >> 2, q = lane & 3;     // accumulator row group, column pair
    bf16* stg = Hs + warp * kStgElems;         // the warp's output staging, over the halo

    load_weights<kThreads>(Ws, a.w, kC, 0);  // resident
    if (HEAD) load_head<kThreads>(Hw, a.wh, a.nout, 0, 0, a.nout);
    const uint32_t ws = smem_u32(Ws), hs = smem_u32(Hs);
    const uint32_t h_base = head_base(Hw, lane);

    int tile = blockIdx.x;
    if (tile < a.n_tiles) load_window(a, tile, Win);
    cp_async_commit();
    for (int it = 0; tile < a.n_tiles; tile += gridDim.x, ++it) {
        const bf16* win = Win + (it & 1) * (kWinBytes / 2);
        const int next = tile + gridDim.x;
        if (next < a.n_tiles) load_window(a, next, Win + ((it + 1) & 1) * (kWinBytes / 2));
        cp_async_commit();
        cp_async_wait<1>();  // this tile's window has landed
        // also: every warp is done with the previous tile's staging
        __syncthreads();
        build_halo(a, tile, win, Hs);
        fence_async_shared();  // the halo (and, first, the weights) to the tensor cores
        __syncthreads();

        // rows grp * kRows + r of the tile; tap row dy of row r is halo row
        // grp * kRows + r + dy
        float acc[kRows][32];
        products<kRows>(
            acc, ws, [&](int i) { return hs + (grp * kRows + i) * kHW * 16; }, kPlane);
        uint32_t y[kRows][8][2];
        bias_act<kRows>(y, acc, a.b, q, [&](float v) { return gelu_fast(v, a.exact); });
        __syncthreads();  // every warpgroup is done with the halo: it becomes the staging

        // the warp's 64 pixels: rows grp * kRows + r, columns 16 wq .. 16 wq + 15
        const Tile tl = tile_at(a, tile);
        const int oy = tl.oy0 + grp * kRows, ox = tl.ox0 + 16 * wq;
        if (!HEAD) {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
                for (int nf = 0; nf < 8; ++nf)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf)
                        *reinterpret_cast<uint32_t*>(stg + (r * 16 + g + 8 * hf) * kLd + nf * 8 +
                                                     2 * q) = y[r][nf][hf];
            __syncwarp();
            // 64 pixels x 8 chunks of 16 B; 8 lanes write one pixel's 128 B
#pragma unroll
            for (int k = 0; k < kRows * 4; ++k) {
                const int i = k * 32 + lane, p = i >> 3, c8 = (i & 7) * 8;
                const int yy = oy + (p >> 4), x = ox + (p & 15);
                if (yy < a.oh && x < a.ow)
                    *reinterpret_cast<uint4*>(a.out + ((tl.img * a.oh + yy) * a.ow + x) * kC + c8) =
                        *reinterpret_cast<const uint4*>(stg + p * kLd + c8);
            }
        } else {
            float z[kRows][2][4];
            head_product<kRows>(z, y, h_base);
            stage_head<kRows>(stg, z, a.bh, a.nout, g, q);
            __syncwarp();
            for (int i = lane; i < kRows * 16 * a.nout; i += 32) {
                const int p = i / a.nout, n = i - p * a.nout;
                const int yy = oy + (p >> 4), x = ox + (p & 15);
                if (yy < a.oh && x < a.ow)
                    a.out[((tl.img * a.oh + yy) * a.ow + x) * a.nout + n] = stg[p * kNP + n];
            }
        }
    }
    cp_async_wait<0>();
}

// Checks the geometry the wrapper computed (ops/decoder.py::UpsampleTiling)
// against this source's own, then launches.
cudaError_t launch(Args a, bool head, int batch, int cin, int cout, int tile_h, int tile_w,
                   int grid, int smem, cudaStream_t st) {
    if (cin != kC || cout != kC || tile_h != kTH || tile_w != kTW) return cudaErrorInvalidValue;
    if (a.h <= 0 || a.w_ <= 0 || batch <= 0) return cudaErrorInvalidValue;
    if (head && (a.nout <= 0 || a.nout > kNP)) return cudaErrorInvalidValue;
    if (static_cast<size_t>(smem) != smem_bytes(head)) return cudaErrorInvalidValue;
    a.oh = 2 * a.h;
    a.ow = 2 * a.w_;
    a.tiles_x = (a.ow + kTW - 1) / kTW;
    a.tiles_per_img = ((a.oh + kTH - 1) / kTH) * a.tiles_x;
    const long long n_tiles = static_cast<long long>(batch) * a.tiles_per_img;
    if (n_tiles > INT_MAX || grid < 1 || grid > n_tiles) return cudaErrorInvalidValue;
    a.n_tiles = static_cast<int>(n_tiles);
    void (*kernel)(const Args) = head ? upsample_conv_kernel<true> : upsample_conv_kernel<false>;
    cudaError_t e = pgm_set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// K9. x (B, H, W, cin) at half resolution, w (3, 3, cin, cout), b (cout,);
// out (B, 2H, 2W, cout); cin = cout = 64. tile_h, tile_w, grid, smem: the
// launch geometry of ops/decoder.py::UpsampleTiling.
PGM_EXPORT int upsample_final_launch(const void* x, const void* w, const void* b, void* out,
                                     int batch, int h, int w_, int cin, int cout, int exact,
                                     int tile_h, int tile_w, int grid, int smem, void* stream) {
    Args a{};
    a.x = static_cast<const bf16*>(x);
    a.w = static_cast<const bf16*>(w);
    a.b = static_cast<const bf16*>(b);
    a.out = static_cast<bf16*>(out);
    a.h = h;
    a.w_ = w_;
    a.exact = exact;
    return static_cast<int>(launch(a, false, batch, cin, cout, tile_h, tile_w, grid, smem,
                                   static_cast<cudaStream_t>(stream)));
}

// K10. x (B, H, W, cin) at half resolution, w (3, 3, cin, cout), b (cout,),
// wh (cout, nout), bh (nout,); out (B, 2H, 2W, nout) NHWC; cin = cout = 64,
// nout <= 16. Geometry as K9's.
PGM_EXPORT int final_heads_launch(const void* x, const void* w, const void* b, const void* wh,
                                  const void* bh, void* out, int batch, int h, int w_, int cin,
                                  int cout, int nout, int exact, int tile_h, int tile_w, int grid,
                                  int smem, void* stream) {
    Args a{};
    a.x = static_cast<const bf16*>(x);
    a.w = static_cast<const bf16*>(w);
    a.b = static_cast<const bf16*>(b);
    a.wh = static_cast<const bf16*>(wh);
    a.bh = static_cast<const bf16*>(bh);
    a.out = static_cast<bf16*>(out);
    a.h = h;
    a.w_ = w_;
    a.nout = nout;
    a.exact = exact;
    return static_cast<int>(launch(a, true, batch, cin, cout, tile_h, tile_w, grid, smem,
                                   static_cast<cudaStream_t>(stream)));
}
