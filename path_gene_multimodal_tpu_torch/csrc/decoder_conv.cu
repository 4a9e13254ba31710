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

struct Args {
    const bf16* wl;    // (K / 32, 9, 4, cout, 8): w (3, 3, K, cout), K = cx + cs, relaid
    const bf16* bias;  // (cout,)
    const bf16* lng;   // (cout,) LayerNorm, or null
    const bf16* lnb;
    bf16* out;         // (B, h, w_, cout)
    int h, w_;
    int chunks, chunks_x;  // 32-channel chunks of K, and of x
    int tiles_x, tiles_per_img, n_tiles;
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

// EXACT: the GELU mode. xmap / smap: x and the skip as (8 channels, w_, h,
// C / 8, B) with boxes of 8 x (tile_w + 2) x (tile_h + 2) x 4 groups x 1
template <int COUT, bool EXACT>
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
        if (lane == 0) {
            uint32_t wc = 0, hc = 0;
            for (int gi = cluster; gi * kCluster < a.n_tiles; gi += n_clusters) {
                const int t = min(gi * kCluster + rank, a.n_tiles - 1);
                const Tile tl = tile_at(a, t, G::kTH, G::kTW);
                for (int c = 0; c < a.chunks; ++c) {
                    const uint32_t hs = hc % SH, hk = hc / SH;
                    if (hk) mbar_wait(empty_h + hs * 8, (hk - 1) & 1);
                    mbar_arrive_expect_tx(full_h + hs * 8, G::kHaloBytes);
                    const bool sk = c >= a.chunks_x;
                    tma_load_5d(hring + hs * G::kHaloBytes, sk ? &smap : &xmap, 0, tl.x0 - 1,
                                tl.y0 - 1, (sk ? c - a.chunks_x : c) * 4, tl.img, full_h + hs * 8);
                    ++hc;
                    for (int s = 0; s < G::kSlices; ++s) {
                        const uint32_t ws = wc % SW, wk = wc / SW;
                        if (wk) mbar_wait(empty_w + ws * 8, (wk - 1) & 1);
                        mbar_arrive_expect_tx(full_w + ws * 8, G::kSliceBytes);
                        const char* src = reinterpret_cast<const char*>(a.wl) +
                                          (static_cast<size_t>(c) * 9 + s * G::kTaps) * 4 * COUT * 16 +
                                          rank * G::kPortion;
                        const uint32_t dst = wring + ws * G::kSliceBytes + rank * G::kPortion;
                        bulk_load_multicast(dst, src, G::kPortion, full_w + ws * 8,
                                            static_cast<uint16_t>((1 << kCluster) - 1));
                        ++wc;
                    }
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
                const float b0 = __bfloat162float(a.bias[n0 + nf * 8 + 2 * q]);
                const float b1 = __bfloat162float(a.bias[n0 + nf * 8 + 2 * q + 1]);
#pragma unroll
                for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        acc[mt][4 * nf + 2 * hf] += b0;
                        acc[mt][4 * nf + 2 * hf + 1] += b1;
                    }
            }
            if (a.lng != nullptr) {
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
                                mu[mt][hf] = sm[mt][hf] * (1.0f / COUT);
                            else
                                rs[mt][hf] = rsqrtf(sm[mt][hf] * (1.0f / COUT) + 1e-6f);
                        }
                }
#pragma unroll
                for (int nf = 0; nf < G::kNW / 8; ++nf) {
                    const int ch = n0 + nf * 8 + 2 * q;
                    const float g0 = __bfloat162float(a.lng[ch]), g1 = __bfloat162float(a.lng[ch + 1]);
                    const float c0 = __bfloat162float(a.lnb[ch]), c1 = __bfloat162float(a.lnb[ch + 1]);
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
                        if (real && y < a.h && x < a.w_)
                            *reinterpret_cast<uint4*>(
                                a.out + ((static_cast<long long>(tl.img) * a.h + y) * a.w_ + x) * COUT +
                                n0 + cg * 32 + c8) = *reinterpret_cast<const uint4*>(stg + p * kLdS + c8);
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

// blocks of this cout's kernel that fit the current device at once, in
// whole clusters (0 on an error); the same for both GELU modes
template <int COUT>
int slots() {
    static int cached[kPgmMaxDevices];  // per device: the blocks + 1 (0: not asked yet)
    const int dev = pgm_device();
    if (dev < 0) return 0;
    if (cached[dev] == 0) {
        auto kernel = decoder_conv_kernel<COUT, false>;
        int clusters = 0;
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg =
            launch_config<COUT>(kCluster, nullptr, &attr);
        if (pgm_set_smem(kernel, Geo<COUT>::kSmem) != cudaSuccess ||
            pgm_set_smem(decoder_conv_kernel<COUT, true>, Geo<COUT>::kSmem) != cudaSuccess ||
            cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
            return 0;
        cached[dev] = clusters * kCluster + 1;
    }
    return cached[dev] - 1;
}

int slots_of(int cout) {
    switch (cout) {
        case 384: return slots<384>();
        case 192: return slots<192>();
        case 96: return slots<96>();
        case 64: return slots<64>();
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
// DecoderConvTiling) against this source's own, builds the tensor maps,
// then launches.
template <int COUT, bool EXACT>
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
    const int cap = slots<COUT>();
    if (n_tiles > INT_MAX / 2 || cap < kCluster) return cudaErrorInvalidValue;
    a.n_tiles = static_cast<int>(n_tiles);
    const long long groups = (n_tiles + kCluster - 1) / kCluster;
    if (r.grid != kCluster * static_cast<int>(groups < cap / kCluster ? groups : cap / kCluster))
        return cudaErrorInvalidValue;
    CUtensorMap xmap, smap;
    if (!halo_map(&xmap, r.x, r.batch, a.h, a.w_, r.cx, G::kTH, G::kTW))
        return cudaErrorNotSupported;
    if (r.cs > 0 ? !halo_map(&smap, r.skip, r.batch, a.h, a.w_, r.cs, G::kTH, G::kTW)
                 : !halo_map(&smap, r.x, r.batch, a.h, a.w_, r.cx, G::kTH, G::kTW))
        return cudaErrorNotSupported;
    auto kernel = decoder_conv_kernel<COUT, EXACT>;
    cudaError_t e = pgm_set_smem(kernel, G::kSmem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config<COUT>(r.grid, st, &attr);
    e = cudaLaunchKernelEx(&cfg, kernel, a, xmap, smap);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

template <int COUT>
cudaError_t run_mode(const Request& r, int exact, cudaStream_t st) {
    return exact ? run<COUT, true>(r, st) : run<COUT, false>(r, st);
}

}  // namespace

// Blocks of K7's kernel for `cout` that fit the card at once (whole
// clusters); 0 for a cout it does not take or on an error.
PGM_EXPORT size_t decoder_conv_slots(int cout) {
    const int n = slots_of(cout);
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
    r.a.chunks = (cx + cs) / kKc;
    r.a.chunks_x = cx / kKc;
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    switch (cout) {
        case 384: e = run_mode<384>(r, exact, st); break;
        case 192: e = run_mode<192>(r, exact, st); break;
        case 96: e = run_mode<96>(r, exact, st); break;
        case 64: e = run_mode<64>(r, exact, st); break;
        default: e = cudaErrorInvalidValue;
    }
    return static_cast<int>(e);
}
