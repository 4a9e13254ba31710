// The HoverNeXt decoder conv kernel for the H100.
//
// Replaces one TPU kernel of path_gene_multimodal_tpu/ops/pallas/decoder.py
// (the final-stage kernels are csrc/upsample_conv.cu, K9 and K10, and
// csrc/conv64.cu, K8 and K11):
//   K7  fused_decoder_conv     (:168, pallas_call :220): skip concat by split
//       weights + 3x3 SAME conv + bias + LayerNorm (eps 1e-6, two-pass
//       variance) + GELU -> bf16.
//
// Numerics follow the TPU kernel: bf16 inputs, weights and vectors, f32
// accumulation, bf16 outputs. GELU by flag, compiled into the kernel: tanh
// as csrc/conv64.cuh::gelu_tanh_ex2, exact as csrc/hopper.cuh::gelu_fast
// (each within ~1e-6 |x| of pgm_gelu).
//
// What bounds it here: operations. At HoverNeXt-tiny widths the convs do
// 9 * cin * cout multiply-adds per output pixel, 5.7 TFLOP per 512-image
// batch over the 8 calls (5.8 ms at the bf16 peak); the activations are
// ~9 GB in and out. So the design keeps the tensor cores fed from shared
// memory and moves as little as it can through L2:
//  1. An implicit GEMM over pixel tiles of tile_h x tile_w (8 x 8 at cout
//     384, 8 x 16 at 192, 16 x 16 at 96 and 64) of one image and all of
//     cout, K walked as (32-channel chunk, tap). A wgmma M tile is an 8 x 8
//     block of pixels: for each chunk the tile's halo, (tile_h + 2) x
//     (tile_w + 2) pixels x 32 channels, is copied once by one TMA box of a
//     5-D view of x or of the skip (8 channels, W, H, C / 8, B) that lands
//     planar ([channel group][halo row][pixel][8]), the tensor map's zero
//     fill outside the image being the conv's SAME padding; then tap
//     (dy, dx)'s A operand of a block is 8 core matrices, one per pixel row
//     (halo row by * 8 + m + dy, pixels bx * 8 + dx ..), a halo row apart:
//     one descriptor, whatever the image's width (W = 16 and 32 included),
//     and every input pixel enters shared memory once per chunk and tile.
//     The skip's chunks follow x's: its weight rows are read at offset cx,
//     and the concat is never built.
//  2. The weights stream by k-slices (1 tap at cout 384, 3 taps below, x 32
//     channels x cout: the larger the slice, the fewer ring round trips per
//     product, and at cout 192 3-tap slices in 4 slots ran 1.2x faster than
//     1-tap slices in 8; at 384 a 3-tap slice is 72 KB, more than the ring
//     has room for; the wrapper lays the (3, 3, cin, cout)
//     weight out as (cin / 32, 9, 4, cout, 8), wgmma's canonical K-major B,
//     so that a slice is contiguous) through an mbarrier ring, each slice
//     shared by a thread block cluster of 2 blocks on neighbouring tiles:
//     each block copies half of it by bulk copy multicast into the same
//     slot of both, so each slice crosses L2 once per 128 (cout 384), 256
//     (192) or 512 (96, 64) pixels; a slot is refilled once the consumers
//     of both blocks have released it. (Clusters of 4 at cout 384 halved
//     that call's weight traffic but ran slower: only 30 clusters of 4
//     fit the card at once, 120 of its 132 SMs.)
//  3. Warp specialisation: one producer warp (one thread) keeps the halo
//     and weight copies in flight, across tiles too, so the next tile's
//     copies land under this tile's epilogue; two consumer warpgroups run
//     wgmma (m64n192k16 on the two halves of cout 384 for one block of 64
//     pixels; m64n192k16 on a block each at 192; two blocks each of
//     m64n96k16 / m64n64k16 at 96 / 64), both operands by descriptor, one
//     wgmma group kept in flight, and release a slot when its group is done.
//  4. The epilogue from registers: bias, LayerNorm over cout (a pixel's
//     channels lie in the 4 lanes of a quad: a sum in the thread, then a
//     4-lane shuffle, and at cout 384 an exchange of the two warpgroups'
//     halves through shared memory; the mean first, then the centred sum of
//     squares), GELU, rounded to bf16, staged per warp by 32 channels and
//     written in 16-B stores.
// Persistent: the clusters walk the tile groups (a group: cluster adjacent
// tiles, images, then tile rows, then tile columns) with a stride of the
// clusters that fit the card at once; a block whose group runs past the
// last tile repeats the last one and writes nothing. Launch geometry:
// ops/decoder.py::DecoderConvTiling, which the launcher checks against its
// own. Activation offsets are 64-bit.
//
// The any route (decoder_conv_any_launch, instantiated with ANY) runs the
// same kernel at every width the Pallas kernel takes, on the tile width
// (COUT: 64, 96, 192 or 384) at or above the true cout:
//  - K: each source's weight rows are zero-padded to whole 32-channel
//    chunks by the wrapper (the skip's from its own chunk boundary). A
//    source whose rows are whole 16-B groups (C % 8 == 0) lands by TMA, the
//    box's groups past C zero-filled; any other one (TMA needs 16-B global
//    strides), and the bilinear 2x of x (kSrcUpsample: K9/K10 at widths
//    other than 64), is built in the halo slot by the producer warp's 32
//    lanes with plain loads, zero past C and outside the image;
//  - N: the columns past cout have zero weights and zero bias, so they add
//    nothing to the LayerNorm's sums; its divisor is the true cout and its
//    centred sum skips them; only the true channels are stored, a row
//    cout apart;
//  - past 384 output channels (and for the final stage's heads) the kernel
//    writes f32 conv + bias of one 384-wide column chunk a launch (raw) and
//    conv_epilogue_kernel finishes each pixel: LayerNorm over the true
//    channels, GELU, bf16, and the head product (K10/K11 at other widths,
//    past 16 head columns, or with a full head) with its bias.
// The tile widths at the shapes of the fixed route are unchanged: the any
// route is compiled apart (ANY), and the four fixed instantiations are the
// code they were.
#include "common.cuh"
#include "conv64.cuh"

#include <climits>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 288;   // two consumer warpgroups and a producer warp
constexpr int kKc = 32;         // input channels per chunk
constexpr int kCluster = 2;     // blocks that share each weight slice
constexpr int kLdS = kKc + 8;   // bf16 row stride of a warp's output staging
constexpr int kStgWarp = 16 * kLdS * 2;
constexpr int kRedBytes = 2 * 2 * 64 * 4;  // LayerNorm partial sums [pass][group][row]

// The geometry of each cout: cout split over the two warpgroups (2) or not
// (1), m64 blocks per warpgroup, tile, taps per weight slice, ring slots of
// weights and of halos.
template <int COUT>
struct Cfg;
template <>
struct Cfg<384> {
    static constexpr int kSplit = 2, kMT = 1, kTH = 8, kTW = 8, kTaps = 1, kRingW = 8,
                         kRingH = 2;
};
template <>
struct Cfg<192> {
    static constexpr int kSplit = 1, kMT = 1, kTH = 8, kTW = 16, kTaps = 3, kRingW = 4,
                         kRingH = 2;
};
template <>
struct Cfg<96> {
    static constexpr int kSplit = 1, kMT = 2, kTH = 16, kTW = 16, kTaps = 3, kRingW = 6,
                         kRingH = 3;
};
template <>
struct Cfg<64> {
    static constexpr int kSplit = 1, kMT = 2, kTH = 16, kTW = 16, kTaps = 3, kRingW = 6,
                         kRingH = 3;
};

template <int COUT>
struct Geo : Cfg<COUT> {
    using C = Cfg<COUT>;
    static constexpr int kNW = COUT / C::kSplit;             // N of a warpgroup
    static constexpr int kSlices = 9 / C::kTaps;            // weight slices per chunk
    static constexpr int kSliceBytes = C::kTaps * kKc * COUT * 2;
    static constexpr int kPortion = kSliceBytes / kCluster;  // one block's multicast
    static constexpr int kHaloW = C::kTW + 2;
    static constexpr int kPlane = (C::kTH + 2) * kHaloW * 16;  // one 8-channel plane
    static constexpr int kHaloBytes = 4 * kPlane;
    static constexpr int kBlocksX = C::kTW / 8;
    static constexpr size_t kOffHalo = size_t(C::kRingW) * kSliceBytes;
    static constexpr size_t kOffStg = kOffHalo + size_t(C::kRingH) * kHaloBytes;
    static constexpr size_t kOffRed = kOffStg + 8 * kStgWarp;
    static constexpr size_t kOffBar = kOffRed + kRedBytes;
    static constexpr size_t kSmem = kOffBar + 2 * (C::kRingW + C::kRingH) * 8;
    static_assert(C::kSplit == 2 ? (C::kTH / 8) * kBlocksX == 1
                                 : (C::kTH / 8) * kBlocksX == 2 * C::kMT,
                  "the warpgroups' blocks cover the tile");
    static_assert(kSliceBytes % 128 == 0 && kHaloBytes % 128 == 0, "TMA landings 128-B aligned");
    static_assert(kPortion % 16 == 0, "bulk copies of whole 16 B");
    static_assert(kNW % 32 == 0, "whole 32-channel staging groups");
};

// how a source's halo chunk lands (the any route)
constexpr int kSrcTma = 0, kSrcPlain = 1, kSrcUpsample = 2;

struct Args {
    const bf16* wl;    // (K / 32, 9, 4, cout, 8): w (3, 3, K, cout), K = cx + cs, relaid
    const bf16* bias;  // (cout,)
    const bf16* lng;   // (cout,) LayerNorm, or null
    const bf16* lnb;
    bf16* out;         // (B, h, w_, cout)
    int h, w_;
    int chunks, chunks_x;  // 32-channel chunks of K, and of x
    int tiles_x, tiles_per_img, n_tiles;
    // the any route only: K and cout as the wrapper padded them to the
    // tile's (COUT) columns
    const bf16* src[2];  // x and the skip, for the halos built by the producer warp
    int csrc[2];         // their channels
    int mode[2];         // how each one's halo lands: kSrcTma, kSrcPlain, kSrcUpsample
    int in_h, in_w;      // kSrcUpsample: x's resolution (h = 2 in_h, w_ = 2 in_w)
    int cout;            // the true output channels, out's row stride
    float inv_cout;      // 1 / cout, rounded once on the host (an f32 division in the
                         // epilogue would be a call, whose saved registers spill)
    float* raw;          // or f32 (B, h, w_, ld_raw): conv + bias of the COUT columns, no more
    int ld_raw;
};

// consumer warpgroups only (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

struct Tile {
    int img, y0, x0;
};

__device__ __forceinline__ Tile tile_at(const Args& a, int t, int th, int tw) {
    const int img = t / a.tiles_per_img, rem = t - img * a.tiles_per_img;
    const int ty = rem / a.tiles_x;
    return Tile{img, ty * th, (rem - ty * a.tiles_x) * tw};
}

// 8 bf16 from p: one 16-B load where the source's rows are whole 16-B
// groups (vec: C % 8 == 0, so all 8 lie in the row), else the first n of
// them one by one and zeros after
__device__ __forceinline__ uint4 load8(const bf16* p, int n, bool vec) {
    if (vec) return *reinterpret_cast<const uint4*>(p);
    __align__(16) bf16 e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = k < n ? p[k] : __float2bfloat16(0.0f);
    return *reinterpret_cast<const uint4*>(e);
}

// v[ch], v[ch + 1] as floats, one 4-B load (ch even): the any route's
// vectors, so that loading them all at once takes half the registers
__device__ __forceinline__ float2 load_pair(const bf16* v, int ch) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + ch));
}

// The any route's halo chunk of source s (its channels c0 .. c0 + 31) for
// tile tl, built by the producer warp's lanes where TMA cannot take the
// source, planar as TMA's box lands ([8-channel plane][halo row][pixel][8]):
// zero past the source's channels and outside the image (the conv's SAME
// padding); kSrcUpsample: pixel (y, x) of the bilinear 2x of x, rows first,
// then columns, in f32 with each product and sum rounded on its own,
// rounded once to bf16, as csrc/upsample_conv.cu builds its halo.
template <int TH, int TW>
__device__ __forceinline__ void build_halo(const Args& a, int s, const Tile& tl, int c0,
                                           unsigned char* halo, int lane) {
    constexpr int kHW = TW + 2, kPx = (TH + 2) * kHW;
    // (no runtime index into the parameter's arrays: that would copy them to the stack)
    const bf16* src = s ? a.src[1] : a.src[0];
    const int C = s ? a.csrc[1] : a.csrc[0];
    const bool up = (s ? a.mode[1] : a.mode[0]) == kSrcUpsample, vec = C % 8 == 0;
    for (int i = lane; i < 4 * kPx; i += 32) {
        const int pl = i / kPx, p = i - pl * kPx;
        const int y = tl.y0 - 1 + p / kHW, x = tl.x0 - 1 + p % kHW, ch = c0 + 8 * pl;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (y >= 0 && y < a.h && x >= 0 && x < a.w_ && ch < C) {
            if (!up) {
                v = load8(src + ((static_cast<long long>(tl.img) * a.h + y) * a.w_ + x) * C + ch,
                          C - ch, vec);
            } else {
                int r0, r1, q0, q1;
                float ra, rb, qa, qb;
                conv64::up_taps(y, a.in_h, r0, r1, ra, rb);
                conv64::up_taps(x, a.in_w, q0, q1, qa, qb);
                const bf16* img = src + static_cast<long long>(tl.img) * a.in_h * a.in_w * C + ch;
                auto px = [&](int r, int q) {
                    return img + (static_cast<long long>(r) * a.in_w + q) * C;
                };
                float v00[8], v10[8], v01[8], v11[8], u[8];
                unpack8(load8(px(r0, q0), C - ch, vec), v00);
                unpack8(load8(px(r1, q0), C - ch, vec), v10);
                unpack8(load8(px(r0, q1), C - ch, vec), v01);
                unpack8(load8(px(r1, q1), C - ch, vec), v11);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    u[e] = conv64::lerp_rn(qa, conv64::lerp_rn(ra, v00[e], rb, v10[e]), qb,
                                           conv64::lerp_rn(ra, v01[e], rb, v11[e]));
                v = pack8(u);
            }
        }
        *reinterpret_cast<uint4*>(halo + pl * (kPx * 16) + p * 16) = v;
    }
}

// EXACT: the GELU mode; ANY: the any route (see the top of the file).
// xmap / smap: x and the skip as (8 channels, w_, h, C / 8, B) with boxes
// of 8 x (tile_w + 2) x (tile_h + 2) x 4 groups x 1 (the any route: where
// the source lands by TMA)
template <int COUT, bool EXACT, bool ANY>
__global__ void __launch_bounds__(kThreads, 1)
    decoder_conv_kernel(const Args a, const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap smap) {
    using G = Geo<COUT>;
    constexpr int SW = G::kRingW, SH = G::kRingH;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t base = smem_u32(smem);
    const uint32_t wring = base, hring = base + G::kOffHalo;
    const uint32_t full_w = base + G::kOffBar, empty_w = full_w + SW * 8;
    const uint32_t full_h = empty_w + SW * 8, empty_h = full_h + SH * 8;
    float* red = reinterpret_cast<float*>(smem + G::kOffRed);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rank = static_cast<int>(cluster_rank());
    const int cluster = blockIdx.x / kCluster, n_clusters = gridDim.x / kCluster;

    if (base & 127) __trap();  // TMA landings 128-B aligned
    if (tid == 0) {
        for (int s = 0; s < SW; ++s) {
            mbar_init(full_w + s * 8, 1);
            mbar_init(empty_w + s * 8, 2 * kCluster);  // both warpgroups of every block
        }
        for (int s = 0; s < SH; ++s) {
            mbar_init(full_h + s * 8, 1);
            mbar_init(empty_h + s * 8, 2);
        }
    }
    fence_mbar_init();
    cluster_sync();  // every block's barriers exist before any copy or remote arrival

    if (warp == 8) {
        // ---- producer: halo chunks and weight slices, tile after tile
        // (one lane; in the any route the whole warp, which builds the
        // halos TMA cannot copy)
        if (ANY || lane == 0) {
            uint32_t wc = 0, hc = 0;
            for (int gi = cluster; gi * kCluster < a.n_tiles; gi += n_clusters) {
                const int t = min(gi * kCluster + rank, a.n_tiles - 1);
                const Tile tl = tile_at(a, t, G::kTH, G::kTW);
                for (int c = 0; c < a.chunks; ++c) {
                    const uint32_t hs = hc % SH, hk = hc / SH;
                    if (hk) mbar_wait(empty_h + hs * 8, (hk - 1) & 1);
                    const bool sk = c >= a.chunks_x;
                    const int cc = sk ? c - a.chunks_x : c;
                    if (!ANY || (sk ? a.mode[1] : a.mode[0]) == kSrcTma) {
                        if (lane == 0) {
                            mbar_arrive_expect_tx(full_h + hs * 8, G::kHaloBytes);
                            tma_load_5d(hring + hs * G::kHaloBytes, sk ? &smap : &xmap, 0,
                                        tl.x0 - 1, tl.y0 - 1, cc * 4, tl.img, full_h + hs * 8);
                        }
                    } else {
                        build_halo<G::kTH, G::kTW>(a, sk, tl, cc * kKc,
                                                   smem + G::kOffHalo + hs * G::kHaloBytes, lane);
                        fence_async_shared();  // the lanes' stores to the tensor cores
                        __syncwarp();
                        if (lane == 0) mbar_arrive(full_h + hs * 8);
                    }
                    ++hc;
                    if (lane == 0)
                        for (int s = 0; s < G::kSlices; ++s) {
                            const uint32_t ws = wc % SW, wk = wc / SW;
                            if (wk) mbar_wait(empty_w + ws * 8, (wk - 1) & 1);
                            mbar_arrive_expect_tx(full_w + ws * 8, G::kSliceBytes);
                            const char* src =
                                reinterpret_cast<const char*>(a.wl) +
                                (static_cast<size_t>(c) * 9 + s * G::kTaps) * 4 * COUT * 16 +
                                rank * G::kPortion;
                            const uint32_t dst = wring + ws * G::kSliceBytes + rank * G::kPortion;
                            bulk_load_multicast(dst, src, G::kPortion, full_w + ws * 8,
                                                static_cast<uint16_t>((1 << kCluster) - 1));
                            ++wc;
                        }
                    if (ANY) __syncwarp();
                }
            }
        }
        __syncwarp();
    } else {
        // ---- consumers
        const int grp = warp >> 2, wq = warp & 3, gtid = tid & 127;
        const int g = lane >> 2, q = lane & 3;
        const int n0 = G::kSplit == 2 ? grp * G::kNW : 0;
        bf16* stg = reinterpret_cast<bf16*>(smem + G::kOffStg + warp * kStgWarp);
        uint32_t wc = 0, hc = 0;
        // release slot ws (in every block of the cluster) and, at a chunk's
        // end, halo slot hs, once the wgmma group reading them is done
        auto release = [&](uint32_t ws, bool chunk_end, uint32_t hs) {
            if (gtid < kCluster) mbar_arrive_cluster(empty_w + ws * 8, gtid);
            if (chunk_end && gtid == kCluster) mbar_arrive(empty_h + hs * 8);
        };
        for (int gi = cluster; gi * kCluster < a.n_tiles; gi += n_clusters) {
            const int t = gi * kCluster + rank;
            const Tile tl = tile_at(a, min(t, a.n_tiles - 1), G::kTH, G::kTW);
            float acc[G::kMT][G::kNW / 2];
            uint32_t pw = 0, ph = 0;
            bool pend = false, pchunk_end = false;
            for (int c = 0; c < a.chunks; ++c) {
                const uint32_t hs = hc % SH;
                mbar_wait(full_h + hs * 8, (hc / SH) & 1);
                const uint32_t ha = hring + hs * G::kHaloBytes;
                for (int s = 0; s < G::kSlices; ++s) {
                    const uint32_t ws = wc % SW;
                    mbar_wait(full_w + ws * 8, (wc / SW) & 1);
                    const uint32_t wa = wring + ws * G::kSliceBytes;
                    wgmma_fence();
#pragma unroll
                    for (int tt = 0; tt < G::kTaps; ++tt) {
                        const int tap = s * G::kTaps + tt, dy = tap / 3, dx = tap % 3;
#pragma unroll
                        for (int j = 0; j < 2; ++j) {  // 16 channels: planes 2j, 2j + 1
                            const uint64_t db =
                                desc(wa + ((tt * 4 + 2 * j) * COUT + n0) * 16, COUT * 16, 128);
                            const int accumulate = c > 0 || s > 0 || tt > 0 || j > 0;
#pragma unroll
                            for (int mt = 0; mt < G::kMT; ++mt) {
                                const int blk = G::kSplit == 2 ? 0 : grp * G::kMT + mt;
                                const int by = blk / G::kBlocksX, bx = blk % G::kBlocksX;
                                const uint32_t aa = ha + 2 * j * G::kPlane +
                                                    ((by * 8 + dy) * G::kHaloW + bx * 8 + dx) * 16;
                                wgmma_bf16<G::kNW>(acc[mt], desc(aa, G::kPlane, G::kHaloW * 16),
                                                   db, accumulate);
                            }
                        }
                    }
                    wgmma_commit();
                    wgmma_wait<1>();
                    if (pend) release(pw, pchunk_end, ph);
                    pend = true;
                    pw = ws;
                    ph = hs;
                    pchunk_end = s + 1 == G::kSlices;
                    ++wc;
                }
                ++hc;
            }
            wgmma_wait<0>();
#pragma unroll
            for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
                for (int k = 0; k < G::kNW / 2; ++k) pin(acc[mt][k]);
            release(pw, pchunk_end, ph);

            // ---- epilogue: thread (wq, g, q) holds pixel row 2 wq + hf, column
            // g of its blocks, channels n0 + 8 nf + 2 q + (0, 1)
#pragma unroll
            for (int nf = 0; nf < G::kNW / 8; ++nf) {
                const int ch = n0 + nf * 8 + 2 * q;
                const float2 bb = ANY ? load_pair(a.bias, ch) : make_float2(0.0f, 0.0f);
                const float b0 = ANY ? bb.x : __bfloat162float(a.bias[ch]);
                const float b1 = ANY ? bb.y : __bfloat162float(a.bias[ch + 1]);
#pragma unroll
                for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        acc[mt][4 * nf + 2 * hf] += b0;
                        acc[mt][4 * nf + 2 * hf + 1] += b1;
                    }
            }
            if (ANY && a.raw != nullptr) {  // f32 conv + bias for conv_epilogue_kernel
                if (t < a.n_tiles)
#pragma unroll
                    for (int mt = 0; mt < G::kMT; ++mt) {
                        const int blk = G::kSplit == 2 ? 0 : grp * G::kMT + mt;
                        const int by = blk / G::kBlocksX, bx = blk % G::kBlocksX;
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int y = tl.y0 + by * 8 + 2 * wq + hf, x = tl.x0 + bx * 8 + g;
                            if (y >= a.h || x >= a.w_) continue;
                            float* row = a.raw +
                                         ((static_cast<long long>(tl.img) * a.h + y) * a.w_ + x) *
                                             a.ld_raw + n0 + 2 * q;
#pragma unroll
                            for (int nf = 0; nf < G::kNW / 8; ++nf)
                                *reinterpret_cast<float2*>(row + 8 * nf) = make_float2(
                                    acc[mt][4 * nf + 2 * hf], acc[mt][4 * nf + 2 * hf + 1]);
                        }
                    }
                continue;
            }
            // the any route's mean and variance over the true cout
            auto over_cout = [&](float v) { return v * (ANY ? a.inv_cout : 1.0f / COUT); };
            if (a.lng != nullptr) {
                const int lim = a.cout - n0 - 2 * q;
                float mu[G::kMT][2], rs[G::kMT][2];
#pragma unroll
                for (int pass = 0; pass < 2; ++pass) {
                    float sm[G::kMT][2];
#pragma unroll
                    for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            float v = 0.0f;
#pragma unroll
                            for (int nf = 0; nf < G::kNW / 8; ++nf)
#pragma unroll
                                for (int e = 0; e < 2; ++e) {
                                    if (ANY && pass && 8 * nf + e >= lim) continue;
                                    const float d = acc[mt][4 * nf + 2 * hf + e] -
                                                    (pass ? mu[mt][hf] : 0.0f);
                                    v += pass ? d * d : d;
                                }
                            v += __shfl_xor_sync(0xffffffffu, v, 1);
                            v += __shfl_xor_sync(0xffffffffu, v, 2);
                            sm[mt][hf] = v;
                        }
                    if (G::kSplit == 2) {  // the other half of cout, from the other warpgroup
                        float* r = red + pass * 128;
                        if (q == 0)
#pragma unroll
                            for (int hf = 0; hf < 2; ++hf)
                                r[grp * 64 + 16 * wq + g + 8 * hf] = sm[0][hf];
                        consumers_sync();
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf)
                            sm[0][hf] += r[(1 - grp) * 64 + 16 * wq + g + 8 * hf];
                    }
#pragma unroll
                    for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            if (pass == 0)
                                mu[mt][hf] = over_cout(sm[mt][hf]);
                            else
                                rs[mt][hf] = rsqrtf(over_cout(sm[mt][hf]) + 1e-6f);
                        }
                }
#pragma unroll
                for (int nf = 0; nf < G::kNW / 8; ++nf) {
                    const int ch = n0 + nf * 8 + 2 * q;
                    float g0, g1, c0, c1;
                    if (ANY) {
                        const float2 gg = load_pair(a.lng, ch), cc = load_pair(a.lnb, ch);
                        g0 = gg.x, g1 = gg.y, c0 = cc.x, c1 = cc.y;
                    } else {
                        g0 = __bfloat162float(a.lng[ch]), g1 = __bfloat162float(a.lng[ch + 1]);
                        c0 = __bfloat162float(a.lnb[ch]), c1 = __bfloat162float(a.lnb[ch + 1]);
                    }
#pragma unroll
                    for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int k = 4 * nf + 2 * hf;
                            acc[mt][k] = (acc[mt][k] - mu[mt][hf]) * rs[mt][hf] * g0 + c0;
                            acc[mt][k + 1] = (acc[mt][k + 1] - mu[mt][hf]) * rs[mt][hf] * g1 + c1;
                        }
                }
            }
            // GELU, bf16, staged 32 channels at a time: the warp's 16 pixels
            // (rows 2 wq, 2 wq + 1 of a block, 8 columns each) x 64 B
            const bool real = t < a.n_tiles;
#pragma unroll
            for (int mt = 0; mt < G::kMT; ++mt) {
                const int blk = G::kSplit == 2 ? 0 : grp * G::kMT + mt;
                const int by = blk / G::kBlocksX, bx = blk % G::kBlocksX;
#pragma unroll
                for (int cg = 0; cg < G::kNW / 32; ++cg) {
#pragma unroll
                    for (int k = 0; k < 4; ++k)
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const float v0 = acc[mt][4 * (cg * 4 + k) + 2 * hf];
                            const float v1 = acc[mt][4 * (cg * 4 + k) + 2 * hf + 1];
                            const float e0 = EXACT ? gelu_fast(v0, 1) : conv64::gelu_tanh_ex2(v0);
                            const float e1 = EXACT ? gelu_fast(v1, 1) : conv64::gelu_tanh_ex2(v1);
                            *reinterpret_cast<uint32_t*>(stg + (g + 8 * hf) * kLdS + k * 8 + 2 * q) =
                                pack_bf16(e0, e1);
                        }
                    __syncwarp();
#pragma unroll
                    for (int k = 0; k < 2; ++k) {
                        const int i = k * 32 + lane, p = i >> 2, c8 = (i & 3) * 8;
                        const int y = tl.y0 + by * 8 + 2 * wq + (p >> 3), x = tl.x0 + bx * 8 + (p & 7);
                        if (!real || y >= a.h || x >= a.w_) continue;
                        const long long pix = (static_cast<long long>(tl.img) * a.h + y) * a.w_ + x;
                        const int ch = n0 + cg * 32 + c8;
                        if (!ANY) {
                            *reinterpret_cast<uint4*>(a.out + pix * COUT + ch) =
                                *reinterpret_cast<const uint4*>(stg + p * kLdS + c8);
                        } else if (a.cout % 8 == 0) {  // whole 16-B groups, a row cout apart
                            if (ch < a.cout)
                                *reinterpret_cast<uint4*>(a.out + pix * a.cout + ch) =
                                    *reinterpret_cast<const uint4*>(stg + p * kLdS + c8);
                        } else {
#pragma unroll
                            for (int e = 0; e < 8; ++e)
                                if (ch + e < a.cout)
                                    a.out[pix * a.cout + ch + e] = stg[p * kLdS + c8 + e];
                        }
                    }
                    __syncwarp();
                }
            }
        }
    }
    cluster_sync();  // no block leaves while another may still reach its barriers
}

// t (batch, h, w_, c) bf16 as a 5-D tensor (8 channels, w_, h, c / 8 groups,
// batch) with boxes of 8 x (tw + 2) x (th + 2) x 4 groups x 1: a box lands
// as [group][row][pixel][8 channels], a planar halo chunk
bool halo_map(CUtensorMap* map, const void* t, int batch, int h, int w_, int c, int th, int tw) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(w_), static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(c / 8), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[4] = {c * 2ull, c * 2ull * w_, 16, c * 2ull * w_ * h};  // bytes
    const cuuint32_t box[5] = {8, static_cast<cuuint32_t>(tw + 2), static_cast<cuuint32_t>(th + 2),
                               4, 1};
    const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(t), dims, strides,
                  box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int COUT>
cudaLaunchConfig_t launch_config(int grid, cudaStream_t st, cudaLaunchAttribute* attr) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = kCluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Geo<COUT>::kSmem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// blocks of this cout's kernel (the fixed or the any route's) that fit the
// current device at once, in whole clusters (0 on an error); the same for
// both GELU modes
template <int COUT, bool ANY>
int slots() {
    static int cached[kPgmMaxDevices];  // per device: the blocks + 1 (0: not asked yet)
    const int dev = pgm_device();
    if (dev < 0) return 0;
    if (cached[dev] == 0) {
        auto kernel = decoder_conv_kernel<COUT, false, ANY>;
        int clusters = 0;
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg =
            launch_config<COUT>(kCluster, nullptr, &attr);
        if (pgm_set_smem(kernel, Geo<COUT>::kSmem) != cudaSuccess ||
            pgm_set_smem(decoder_conv_kernel<COUT, true, ANY>, Geo<COUT>::kSmem) != cudaSuccess ||
            cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
            return 0;
        cached[dev] = clusters * kCluster + 1;
    }
    return cached[dev] - 1;
}

template <bool ANY>
int slots_of(int cout) {
    switch (cout) {
        case 384: return slots<384, ANY>();
        case 192: return slots<192, ANY>();
        case 96: return slots<96, ANY>();
        case 64: return slots<64, ANY>();
        default: return 0;
    }
}

struct Request {
    const void *x, *skip;
    Args a;
    int batch, cx, cs;
    int tile_h, tile_w, taps, ring_w, ring_h, cluster, grid, smem;
};

// Checks the geometry the wrapper computed (ops/decoder.py::
// DecoderConvTiling) against this source's own, builds the tensor maps of
// the sources that land by TMA, then launches.
template <int COUT, bool EXACT, bool ANY>
cudaError_t run(Request r, cudaStream_t st) {
    using G = Geo<COUT>;
    if (r.tile_h != G::kTH || r.tile_w != G::kTW || r.taps != G::kTaps || r.ring_w != G::kRingW ||
        r.ring_h != G::kRingH || r.cluster != kCluster ||
        static_cast<size_t>(r.smem) != G::kSmem)
        return cudaErrorInvalidValue;
    Args& a = r.a;
    a.tiles_x = (a.w_ + G::kTW - 1) / G::kTW;
    a.tiles_per_img = ((a.h + G::kTH - 1) / G::kTH) * a.tiles_x;
    const long long n_tiles = static_cast<long long>(r.batch) * a.tiles_per_img;
    const int cap = slots<COUT, ANY>();
    if (n_tiles > INT_MAX / 2 || cap < kCluster) return cudaErrorInvalidValue;
    a.n_tiles = static_cast<int>(n_tiles);
    const long long groups = (n_tiles + kCluster - 1) / kCluster;
    if (r.grid != kCluster * static_cast<int>(groups < cap / kCluster ? groups : cap / kCluster))
        return cudaErrorInvalidValue;
    CUtensorMap xmap{}, smap{};
    if (!ANY || a.mode[0] == kSrcTma)
        if (!halo_map(&xmap, r.x, r.batch, a.h, a.w_, r.cx, G::kTH, G::kTW))
            return cudaErrorNotSupported;
    if (r.cs > 0 && (!ANY || a.mode[1] == kSrcTma)) {
        if (!halo_map(&smap, r.skip, r.batch, a.h, a.w_, r.cs, G::kTH, G::kTW))
            return cudaErrorNotSupported;
    } else {
        smap = xmap;
    }
    auto kernel = decoder_conv_kernel<COUT, EXACT, ANY>;
    cudaError_t e = pgm_set_smem(kernel, G::kSmem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config<COUT>(r.grid, st, &attr);
    e = cudaLaunchKernelEx(&cfg, kernel, a, xmap, smap);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

template <bool ANY>
cudaError_t run_cout(const Request& r, int cout, int exact, cudaStream_t st) {
    switch (cout) {
        case 384: return exact ? run<384, true, ANY>(r, st) : run<384, false, ANY>(r, st);
        case 192: return exact ? run<192, true, ANY>(r, st) : run<192, false, ANY>(r, st);
        case 96: return exact ? run<96, true, ANY>(r, st) : run<96, false, ANY>(r, st);
        case 64: return exact ? run<64, true, ANY>(r, st) : run<64, false, ANY>(r, st);
        default: return cudaErrorInvalidValue;
    }
}

Request request(const void* x, const void* skip, const void* wl, const void* b, const void* lng,
                const void* lnb, void* out, int batch, int h, int w_, int cx, int cs, int tile_h,
                int tile_w, int taps, int ring_w, int ring_h, int cluster, int grid, int smem) {
    Request r{};
    r.x = x;
    r.skip = skip;
    r.a.wl = static_cast<const bf16*>(wl);
    r.a.bias = static_cast<const bf16*>(b);
    r.a.lng = static_cast<const bf16*>(lng);
    r.a.lnb = static_cast<const bf16*>(lnb);
    r.a.out = static_cast<bf16*>(out);
    r.a.h = h;
    r.a.w_ = w_;
    r.a.chunks_x = (cx + kKc - 1) / kKc;
    r.a.chunks = r.a.chunks_x + (cs + kKc - 1) / kKc;
    r.batch = batch;
    r.cx = cx;
    r.cs = cs;
    r.tile_h = tile_h;
    r.tile_w = tile_w;
    r.taps = taps;
    r.ring_w = ring_w;
    r.ring_h = ring_h;
    r.cluster = cluster;
    r.grid = grid;
    r.smem = smem;
    return r;
}

// ---- the second pass of the any route: LayerNorm, GELU and the head

constexpr int kEpiThreads = 256;

struct EpiArgs {
    const float* acc;         // (n_pix, ld) f32 conv + bias
    const bf16 *lng, *lnb;    // (c,) LayerNorm, or null
    const bf16 *wh, *bh;      // (c, nh) head and (nh,) its bias, or null
    bf16* out;                // (n_pix, nh) with a head, else (n_pix, c)
    long long n_pix;
    int ld, c, nh;
    int pix;                  // pixels a block takes at once (a head's rows staged)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// A warp a pixel: the LayerNorm's mean, then its centred sum of squares
// (two passes over the pixel's c values, as the fused epilogue), the
// affine, GELU, rounded to bf16; with a head, the block's pixels' bf16 rows
// staged in shared memory, then a thread per (pixel, head column) sums
// c products in f32 and adds the bias. CUDA cores only: the conv's
// operations dwarf these.
template <bool EXACT>
__global__ void __launch_bounds__(kEpiThreads) conv_epilogue_kernel(const EpiArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* ys = reinterpret_cast<bf16*>(smem);  // [pix][c]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float cf = static_cast<float>(a.c);
    for (long long p0 = static_cast<long long>(blockIdx.x) * a.pix; p0 < a.n_pix;
         p0 += static_cast<long long>(gridDim.x) * a.pix) {
        for (int j = warp; j < a.pix && p0 + j < a.n_pix; j += kEpiThreads / 32) {
            const long long p = p0 + j;
            const float* row = a.acc + p * a.ld;
            float mu = 0.0f, rs = 1.0f;
            if (a.lng != nullptr) {
                float s = 0.0f;
                for (int c = lane; c < a.c; c += 32) s += row[c];
                mu = warp_sum(s) / cf;
                s = 0.0f;
                for (int c = lane; c < a.c; c += 32) {
                    const float d = row[c] - mu;
                    s += d * d;
                }
                rs = rsqrtf(warp_sum(s) / cf + 1e-6f);
            }
            for (int c = lane; c < a.c; c += 32) {
                float v = row[c];
                if (a.lng != nullptr)
                    v = (v - mu) * rs * __bfloat162float(a.lng[c]) + __bfloat162float(a.lnb[c]);
                const bf16 y = __float2bfloat16(EXACT ? gelu_fast(v, 1) : conv64::gelu_tanh_ex2(v));
                if (a.wh != nullptr)
                    ys[j * a.c + c] = y;
                else
                    a.out[p * a.c + c] = y;
            }
        }
        if (a.wh == nullptr) continue;
        __syncthreads();
        for (int i = threadIdx.x; i < a.pix * a.nh; i += kEpiThreads) {
            const int j = i / a.nh, n = i - j * a.nh;
            if (p0 + j >= a.n_pix) break;
            const bf16* y = ys + j * a.c;
            float s = 0.0f;
            const bf16* col = a.wh + n;
            for (int c = 0; c < a.c; ++c)
                s = fmaf(__bfloat162float(y[c]),
                         __bfloat162float(col[static_cast<long long>(c) * a.nh]), s);
            a.out[(p0 + j) * a.nh + n] = __float2bfloat16(s + __bfloat162float(a.bh[n]));
        }
        __syncthreads();
    }
}

}  // namespace

// Blocks of K7's kernel of tile width `cout` (the fixed route, or with
// `any` the any route's) that fit the card at once (whole clusters); 0 for
// a width it is not compiled for or on an error.
PGM_EXPORT size_t decoder_conv_slots(int cout, int any) {
    const int n = any ? slots_of<true>(cout) : slots_of<false>(cout);
    return n > 0 ? static_cast<size_t>(n) : 0;
}

// K7. x (B, H, W, cx), skip (B, H, W, cs) or null with cs = 0, wl the weight
// (3, 3, cx + cs, cout) laid out as (K / 32, 9, 4, cout, 8), vectors
// (cout,), ln_scale/ln_bias null for no LayerNorm; out (B, H, W, cout). All
// bf16. tile_h .. smem: the launch geometry of ops/decoder.py::
// DecoderConvTiling.
PGM_EXPORT int decoder_conv_launch(const void* x, const void* skip, const void* wl, const void* b,
                                   const void* lng, const void* lnb, void* out, int batch, int h,
                                   int w_, int cx, int cs, int cout, int exact, int tile_h,
                                   int tile_w, int taps, int ring_w, int ring_h, int cluster,
                                   int grid, int smem, void* stream) {
    if (batch <= 0 || h <= 0 || w_ <= 0 || cx <= 0 || cx % kKc || cs < 0 || cs % kKc ||
        (cs > 0) != (skip != nullptr) || (lng == nullptr) != (lnb == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const Request r = request(x, skip, wl, b, lng, lnb, out, batch, h, w_, cx, cs, tile_h, tile_w,
                              taps, ring_w, ring_h, cluster, grid, smem);
    return static_cast<int>(run_cout<false>(r, cout, exact, static_cast<cudaStream_t>(stream)));
}

// K7's any route (and K8-K11's at the shapes their own kernels do not
// take): one launch at tile width n_tile (64, 96, 192 or 384) for the true
// cout <= n_tile. x (B, H, W, cx), or with mode_x = 2 (upsample) (B, in_h,
// in_w, cx) whose bilinear 2x is the conv's input (H = 2 in_h, W = 2
// in_w); skip (B, H, W, cs) or null with cs = 0; mode_x, mode_s: 0 TMA (C
// % 8 == 0), 1 plain loads, 2 upsample (x only). wl: the weight zero-padded
// to (3, 3, 32 ceil(cx / 32) + 32 ceil(cs / 32), n_tile), the skip's rows
// from x's last chunk on, laid out as K7's; b, lng, lnb padded with zeros
// to n_tile. out (B, H, W, cout) bf16; or, with raw not null, no LayerNorm,
// no GELU and nothing in out: raw (B, H, W, ld_raw) f32 takes conv + bias
// of the n_tile columns. Geometry as decoder_conv_launch's.
PGM_EXPORT int decoder_conv_any_launch(const void* x, const void* skip, const void* wl,
                                       const void* b, const void* lng, const void* lnb, void* out,
                                       void* raw, int ld_raw, int batch, int h, int w_, int cx,
                                       int cs, int cout, int n_tile, int mode_x, int mode_s,
                                       int in_h, int in_w, int exact, int tile_h, int tile_w,
                                       int taps, int ring_w, int ring_h, int cluster, int grid,
                                       int smem, void* stream) {
    const bool up = mode_x == kSrcUpsample;
    if (batch <= 0 || h <= 0 || w_ <= 0 || cx <= 0 || cs < 0 || cout <= 0 || cout > n_tile ||
        (cs > 0) != (skip != nullptr) || (lng == nullptr) != (lnb == nullptr) ||
        mode_x < kSrcTma || mode_x > kSrcUpsample || mode_s < kSrcTma || mode_s > kSrcPlain ||
        (mode_x == kSrcTma && cx % 8) || (cs > 0 && mode_s == kSrcTma && cs % 8) ||
        (up && (cs > 0 || h != 2 * in_h || w_ != 2 * in_w)) ||
        (raw != nullptr && (lng != nullptr || ld_raw < n_tile || ld_raw % 2)) ||
        (raw == nullptr && out == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    Request r = request(x, skip, wl, b, lng, lnb, out, batch, h, w_, cx, cs, tile_h, tile_w, taps,
                        ring_w, ring_h, cluster, grid, smem);
    Args& a = r.a;
    a.src[0] = static_cast<const bf16*>(x);
    a.src[1] = static_cast<const bf16*>(skip);
    a.csrc[0] = cx;
    a.csrc[1] = cs;
    a.mode[0] = mode_x;
    a.mode[1] = mode_s;
    a.in_h = in_h;
    a.in_w = in_w;
    a.cout = cout;
    a.inv_cout = 1.0f / static_cast<float>(cout);
    a.raw = static_cast<float*>(raw);
    a.ld_raw = ld_raw;
    return static_cast<int>(run_cout<true>(r, n_tile, exact, static_cast<cudaStream_t>(stream)));
}

// The any route's second pass over acc (n_pix, ld) f32 conv + bias: per
// pixel its first c values through the LayerNorm (lng, lnb (c,), or both
// null), GELU and bf16, into out (n_pix, c); or, with a head wh (c, nh)
// and bh (nh,), those bf16 values through the head into out (n_pix, nh)
// bf16. pix pixels a block at once (smem = pix c 2 bytes with a head, else
// 0), grid blocks of 256 threads.
PGM_EXPORT int conv_epilogue_launch(const void* acc, int ld, int n_pix, int c, const void* lng,
                                    const void* lnb, const void* wh, const void* bh, int nh,
                                    void* out, int exact, int pix, int grid, int smem,
                                    void* stream) {
    if (n_pix <= 0 || c <= 0 || ld < c || (lng == nullptr) != (lnb == nullptr) ||
        (wh == nullptr) != (bh == nullptr) || (wh != nullptr && nh <= 0) || pix <= 0 ||
        grid <= 0 || smem != (wh != nullptr ? pix * c * 2 : 0))
        return static_cast<int>(cudaErrorInvalidValue);
    EpiArgs a{};
    a.acc = static_cast<const float*>(acc);
    a.lng = static_cast<const bf16*>(lng);
    a.lnb = static_cast<const bf16*>(lnb);
    a.wh = static_cast<const bf16*>(wh);
    a.bh = static_cast<const bf16*>(bh);
    a.out = static_cast<bf16*>(out);
    a.n_pix = n_pix;
    a.ld = ld;
    a.c = c;
    a.nh = nh;
    a.pix = pix;
    void (*kernel)(const EpiArgs) =
        exact ? conv_epilogue_kernel<true> : conv_epilogue_kernel<false>;
    cudaError_t e = pgm_set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kEpiThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
