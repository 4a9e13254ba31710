// The HoverNeXt final stage's convs for the H100 at the widths the
// 64-channel kernels (csrc/upsample_conv.cu: K9, K10; csrc/conv64.cu: K8,
// K11) are not compiled for: any cin and cout; with a head, up to 80 head
// columns summed at once.
//
// Replaces four TPU kernels of path_gene_multimodal_tpu/ops/pallas/decoder.py
// at those shapes:
//   K8  fused_final_conv_gelu (:591, pallas_call :620): 3x3 SAME conv
//       cin -> cout + bias + GELU -> bf16, NHWC (no head);
//   K9  fused_upsample_final  (:307, pallas_call :325): bilinear 2x (f32,
//       rounded to bf16) + K8's conv, bias and GELU (no head);
//   K10 fused_final_heads     (:392, pallas_call :415): K9, the GELU output
//       rounded to bf16 -> head product (cout -> n_out) + bias -> bf16
//       logits, NHWC;
//   K11 composite_final_heads (:462, pallas_call :506): 3x3 SAME conv with the
//       parity-folded weights (3, 3, cin, 4 cout) + bias + GELU, rounded to
//       bf16 -> head (4 cout, 4 n_out) + bias -> bf16 parity logits. A head
//       the caller states block-diagonal runs as four phases, block b taking
//       phase b % 4 (a conv cin -> cout and its diagonal head block, as
//       csrc/conv64.cu does); any other head as one conv cin -> 4 cout whose
//       every column chunk multiplies its rows of the whole head.
// Numerics as the TPU kernels and the port's plain versions
// (ops/decoder.py::final_conv_gelu_plain, upsample_final_plain,
// final_heads_plain, composite_final_heads_plain): bf16 inputs, weights and
// vectors, f32 accumulation; the upsample in f32, rows first, then columns,
// each product and sum rounded on its own, rounded once to bf16; the GELU
// output rounded to bf16 (the output, or the head's input); the head summed
// in f32 with its bias, rounded to bf16. GELU by flag, compiled into the
// kernel: tanh mode as csrc/conv64.cuh::gelu_tanh_ex2, exact mode as
// csrc/hopper.cuh::gelu_fast, each within ~1e-6 |x| of pgm_gelu.
//
// What bounds it here: operations, 2 * 9 * cin * cout per output pixel
// against ~2 (cin / 4 + cout) bytes (K9) moved; at path (4)'s model (b)
// (cin = cout = 40) 1.1 TFLOP per 512-image batch, 1.1 ms at the bf16 peak.
//
// Design (csrc/decoder_conv.cu's any route, which these shapes took before,
// padded N to its compiled tile widths and K to 32 channels, built K9's
// halo by one producer warp, and wrote f32 conv + bias to device memory for
// a head's second pass):
//  1. Persistent blocks of two warpgroups (256 threads), one per SM, walk
//     output tiles of 4 x 64 pixels (ops/decoder.py::HeadTiling states the
//     geometry); warpgroup g owns the tile's rows 2g, 2g + 1, each one m64
//     wgmma tile. cin is zero-padded to a multiple of 16 and walked in K
//     chunks of at most 64 channels, cout (per phase) to a multiple of 16 and
//     walked in N chunks of NM columns (64; 128 without a head where the
//     wrapper asks for it), the last one narrower: each 16-channel step
//     picks its wgmma width at run time, over one accumulator array of
//     NM / 2 values a row. With a block-diagonal K11
//     head, block b runs phase b % 4.
//  2. The input: the tile's halo, 6 x 66 pixels x the K chunk, planar
//     ([8-channel plane][pixel][8]), so that the A operand of any tap (64
//     pixels of a halo row shifted by dx) is a canonical wgmma operand.
//     K8/K11 copy it by one TMA box of a 5-D view of x (8 channels, w, h,
//     c / 8, B), the tensor map's zero fill outside the image being the
//     conv's SAME padding. K9/K10 copy the tile's low-res window (4 x 34
//     pixels) by one TMA box and the whole block upsamples it into the halo,
//     each upsampled element once. The copies are double-buffered: the
//     next item's box is in flight while this one's products run. Inputs
//     whose channels are no multiple of 8 (TMA needs 16-B strides) are
//     loaded by every thread instead.
//  3. The weights as k-slices of 9 taps x 16 input channels x an N chunk, in
//     wgmma's canonical K-major layout (the wrapper lays them out,
//     ops/decoder.py::head_weight_layout), copied by bulk copies into a ring
//     of `ring` slots, each slot's mbarrier completing its bytes. Where every
//     slice of the block's phase fits the ring, they are copied once and stay
//     resident (model (b): 3 slices); otherwise they stream, slice after
//     slice, a slot refilled once both warpgroups' wgmma groups that read it
//     are done.
//  4. Per N chunk: wgmma m64nNk16 (N = the chunk's width) over (16-channel
//     step, tap), both operands by descriptor, f32 accumulators in registers;
//     then bias + GELU in registers, rounded to bf16 pairs.
//     Without a head (K8, K9) each warp stages its 16 pixels' columns a row
//     at a time in a staging of its own and stores them NHWC at the chunk's
//     column offset, 16 B a lane where a pixel's columns are whole 16-B
//     groups: each chunk leaves as soon as its epilogue is done, so any
//     cout runs.
//     With a head (K10, K11): the head product on the tensor cores,
//     mma.sync m16n8k16 with A straight from those pairs (the accumulator
//     layout of a warp's 16 pixels is mma's A layout), B by ldmatrix.trans
//     from the resident head rows of the chunk, the head's columns (padded to
//     16) summed in f32 registers across the N chunks. After the last chunk
//     the head bias is added, the logits are rounded to bf16, staged over the
//     input buffer and stored: NHWC (K10), a phase's columns of the parity
//     logits (K11). The head's f32 sums (2 rows x 80 columns a thread) bound
//     the columns: the wrapper sends heads past kColsMax to
//     csrc/decoder_conv.cu's any route.
//  No f32 scratch, no second pass. Activation offsets are 64-bit.
#include "common.cuh"
#include "conv64.cuh"

#include <climits>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 4, kTW = 64;                     // output tile (rows, columns)
constexpr int kRows = 2;                             // m64 rows per warpgroup
constexpr int kHH = kTH + 2, kHW = kTW + 2;          // halo
constexpr int kHPx = kHH * kHW;
constexpr int kWH = kTH / 2 + 2, kWW = kTW / 2 + 2;  // K9/K10's low-res window
constexpr int kWPx = kWH * kWW;
constexpr int kKMax = 64;                            // input channels of a K chunk, at most
constexpr int kHeadNMax = 64;                        // conv columns of an N chunk with a head
constexpr int kColsMax = 80;                         // head columns summed at once
constexpr int kZ8 = kColsMax / 8;                    // their n8 fragments
constexpr int kMaxRing = 8;                          // weight slots
constexpr int kSliceColBytes = 9 * 16 * 2;           // a k-slice's bytes per column
constexpr uint32_t kPlane = kHPx * 16;               // bytes of one 8-channel halo plane
static_assert(2 * kRows == kTH, "two warpgroups cover the tile's rows");
static_assert(kWarps * kRows * 16 == kTH * kTW, "a warp stages 2 rows of 16 pixels, a lane's each");

// shared memory, in bytes: the weight ring, the input buffers (K9/K10: the
// halo and two windows; K8/K11: two halos), then with a head the head rows
// (cols_p + 8 bf16 apart; the logits' staging lies over a halo) and the
// f32 bias and head bias, without one each warp's output staging (16
// pixels x (nm + 8) bf16); the mbarriers (ring slots, then the two input
// buffers)
struct Layout {
    uint32_t slot, in_halo, win, off_in, off_out, off_vec, off_bar, total;
};

__host__ __device__ inline Layout layout(bool up, bool head, int cout_p, int kw, int cols_p,
                                         int ring, int nm) {
    Layout l;
    l.slot = kSliceColBytes * (cout_p < nm ? cout_p : nm);
    const uint32_t halo = kPlane * (kw / 8), stage = kWarps * kRows * 16 * (cols_p + 2) * 2;
    l.in_halo = head && stage > halo ? stage : halo;
    l.win = kWPx * 16 * (kw / 8);
    l.off_in = ring * l.slot;
    l.off_out = l.off_in + (up ? l.in_halo + 2 * l.win : 2 * l.in_halo);
    l.off_vec = l.off_out + (head ? cout_p * (cols_p + 8) * 2 : kWarps * 16 * (nm + 8) * 2);
    l.off_bar = l.off_vec + (head ? ((cout_p + cols_p) * 4 + 15) / 16 * 16 : 0);
    l.total = l.off_bar + (ring + 2) * 8;
    return l;
}

struct Args {
    const bf16* x;       // (B, in_h, in_w, cin)
    const bf16* wl;      // (phases, w_phase): each phase's k-slices (head_weight_layout)
    const float* bias;   // (phases, cout_p)
    const bf16* head;    // (phases, cout_p, cols_p + 8); null without a head
    const float* hbias;  // (phases, cols_p); null without a head
    bf16* out;           // (B, oh, ow, phases * ncols)
    long long w_phase;   // elements of a phase's weight
    int in_h, in_w, cin, oh, ow;
    int cin16, kw, kch;  // 16-channel steps of the padded cin, K chunk width, K chunks
    int cout_p, nch;     // the padded cout of a phase, its N chunks
    int cols_p, ncols, phases;  // ncols: a phase's output columns (n_out, or cout without a head)
    int ring, slices;
    int tiles_x, tiles_per_img, n_tiles;
    int vec, vec_out;    // x by TMA (cin % 8 == 0); 16-B output stores (ldo % 8 == 0)
    Layout l;
};

struct Tile {
    long long img;
    int oy0, ox0;  // first output row / column
};

__device__ __forceinline__ Tile tile_at(const Args& a, int t) {
    const int img = t / a.tiles_per_img, rem = t - img * a.tiles_per_img;
    const int ty = rem / a.tiles_x;
    return Tile{img, ty * kTH, (rem - ty * a.tiles_x) * kTW};
}

template <int NM>
__device__ __forceinline__ int n_width(const Args& a, int nc) {
    return min(NM, a.cout_p - nc * NM);
}

// bulk copy of `bytes` contiguous bytes (a multiple of 16) into this block's
// shared memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// slice gi of the block's sequence (its phase's slices (nc, ci16), nc
// outer, repeated tile after tile) into ring slot gi % ring
template <int NM>
__device__ __forceinline__ void issue_slice(const Args& a, int phase, long long gi, uint32_t ring,
                                            uint32_t bars) {
    const int local = static_cast<int>(gi % a.slices);
    const int nc = local / a.cin16, ci = local - nc * a.cin16;
    const int nw = n_width<NM>(a, nc);
    const int slot = static_cast<int>(gi % a.ring);
    // the 144-element columns of every k-slice before it
    const long long cols = static_cast<long long>(nc) * NM * a.cin16 + nw * ci;
    const bf16* src = a.wl + a.w_phase * phase + cols * (kSliceColBytes / 2);
    const uint32_t bytes = kSliceColBytes * nw;
    mbar_arrive_expect_tx(bars + slot * 8, bytes);
    bulk_load(ring + slot * a.l.slot, src, bytes, bars + slot * 8);
}

// item ii of the block's input sequence: (tile, K chunk); a tile has one
// item where cin is one K chunk (its halo serves every N chunk), else one
// per (N chunk, K chunk)
__device__ __forceinline__ void item_of(const Args& a, int first, int stride, int ii, int& t,
                                        int& kc) {
    const int per = a.kch == 1 ? 1 : a.nch * a.kch;
    t = first + (ii / per) * stride;
    kc = a.kch == 1 ? 0 : (ii % per) % a.kch;
}

// TMA: item ii's box (K9/K10: the low-res window, K8/K11: the halo) of
// kw / 8 channel groups, planar, into dst
template <bool UP>
__device__ __forceinline__ void issue_item(const Args& a, const CUtensorMap* map, int first,
                                           int stride, int ii, uint32_t dst, uint32_t bar) {
    int t, kc;
    item_of(a, first, stride, ii, t, kc);
    const Tile tl = tile_at(a, t);
    mbar_arrive_expect_tx(bar, (UP ? kWPx : kHPx) * 16 * (a.kw / 8));
    if (UP)
        tma_load_5d(dst, map, 0, (tl.ox0 >> 1) - 1, (tl.oy0 >> 1) - 1, kc * (a.kw / 8),
                    static_cast<int>(tl.img), bar);
    else
        tma_load_5d(dst, map, 0, tl.ox0 - 1, tl.oy0 - 1, kc * (a.kw / 8), static_cast<int>(tl.img),
                    bar);
}

// the same box by every thread's loads, for inputs whose channels are no
// multiple of 8: zero past cin and outside the image
template <bool UP>
__device__ __forceinline__ void load_plain(const Args& a, const Tile& tl, int kc, bf16* dst) {
    constexpr int kPx = UP ? kWPx : kHPx, kRowPx = UP ? kWW : kHW;
    const int y0 = UP ? (tl.oy0 >> 1) - 1 : tl.oy0 - 1, x0 = UP ? (tl.ox0 >> 1) - 1 : tl.ox0 - 1;
    for (int i = threadIdx.x; i < (a.kw / 8) * kPx; i += kThreads) {
        const int c = i / kPx, s = i - c * kPx;
        const int y = y0 + s / kRowPx, x = x0 + s % kRowPx, ch = kc * a.kw + 8 * c;
        __align__(16) bf16 e[8];
        const bool in = y >= 0 && y < a.in_h && x >= 0 && x < a.in_w;
        const bf16* p = a.x + ((tl.img * a.in_h + (in ? y : 0)) * a.in_w + (in ? x : 0)) * a.cin;
#pragma unroll
        for (int k = 0; k < 8; ++k)
            e[k] = in && ch + k < a.cin ? p[ch + k] : __float2bfloat16(0.0f);
        *reinterpret_cast<uint4*>(dst + (c * kPx + s) * 8) = *reinterpret_cast<const uint4*>(e);
    }
}

// K9/K10: the upsampled halo of the tile's first `planes` channel planes
// from its window, a thread a halo pixel (its bilinear taps found once for
// all planes): halo pixel p = hr * kHW + hc is output pixel (oy0 - 1 + hr,
// ox0 - 1 + hc), zero outside the output image (the conv's SAME padding);
// the window's origin is (oy0 / 2 - 1, ox0 / 2 - 1), which the bilinear
// taps of every halo row and column stay within after the edge clamp
__device__ __forceinline__ void build_halo(const Args& a, const Tile& tl, int planes,
                                           const bf16* win, bf16* halo) {
    const int wy0 = (tl.oy0 >> 1) - 1, wx0 = (tl.ox0 >> 1) - 1;
    for (int p = threadIdx.x; p < kHPx; p += kThreads) {
        const int oy = tl.oy0 - 1 + p / kHW, ox = tl.ox0 - 1 + p % kHW;
        uint4* dst = reinterpret_cast<uint4*>(halo + p * 8);
        if (oy < 0 || oy >= a.oh || ox < 0 || ox >= a.ow) {
            for (int c = 0; c < planes; ++c) dst[c * kHPx] = make_uint4(0u, 0u, 0u, 0u);
            continue;
        }
        int r0, r1, c0, c1;
        float ra, rb, ca, cb;
        conv64::up_taps(oy, a.in_h, r0, r1, ra, rb);
        conv64::up_taps(ox, a.in_w, c0, c1, ca, cb);
        r0 = (r0 - wy0) * kWW;
        r1 = (r1 - wy0) * kWW;
        c0 -= wx0;
        c1 -= wx0;
        const uint4* w4 = reinterpret_cast<const uint4*>(win);
#pragma unroll 2
        for (int c = 0; c < planes; ++c) {
            const uint4* pl = w4 + c * kWPx;
            float v00[8], v10[8], v01[8], v11[8];
            unpack8(pl[r0 + c0], v00);
            unpack8(pl[r1 + c0], v10);
            unpack8(pl[r0 + c1], v01);
            unpack8(pl[r1 + c1], v11);
            float u[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)  // rows first, then columns
                u[e] = conv64::lerp_rn(ca, conv64::lerp_rn(ra, v00[e], rb, v10[e]), cb,
                                       conv64::lerp_rn(ra, v01[e], rb, v11[e]));
            dst[c * kHPx] = pack8(u);
        }
    }
}

// acc[r] (N / 2 of its NM / 2 values) += the conv of the warpgroup's row r
// over one 16-channel step: the halo's two 8-channel planes from aa, the
// k-slice (9 taps x 16 channels x N, [tap][half][n][8]) at wa; init: the
// chunk's first step, which overwrites
template <int N, int NM>
__device__ __forceinline__ void products(float (&acc)[kRows][NM / 2], uint32_t aa, uint32_t wa,
                                         int grp, bool init) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const uint64_t db = desc(wa + tap * 32 * N, 16 * N, 128);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const uint32_t ar = aa + ((grp * kRows + r + dy) * kHW + dx) * 16;
            wgmma_bf16<N>(*reinterpret_cast<float(*)[N / 2]>(&acc[r][0]), desc(ar, kPlane, 128),
                          db, !(init && tap == 0));
        }
    }
}

// EXACT: the GELU mode (the launcher's `exact`), compiled into the epilogue;
// HEAD: K10/K11 (the head product in the epilogue, N chunks of 64) or K8/K9
// (each N chunk of NM columns stored as it is done)
template <bool UP, bool EXACT, bool HEAD, int NM>
__global__ void __launch_bounds__(kThreads, 1)
    heads_wide_kernel(const Args a, const __grid_constant__ CUtensorMap in_map) {
    static_assert(!HEAD || NM == kHeadNMax, "a head sums N chunks of 64 columns");
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout& l = a.l;
    const uint32_t base = smem_u32(smem);
    const uint32_t wring = base, bars = base + l.off_bar, in_bars = bars + a.ring * 8;
    bf16* Hw = reinterpret_cast<bf16*>(smem + l.off_out);  // the head rows, or the staging
    float* bs = reinterpret_cast<float*>(smem + l.off_vec);
    float* hbs = bs + a.cout_p;
    // item buffer b (K9/K10: window b; K8/K11: halo b)
    auto item_buf = [&](int b) {
        return smem + l.off_in + (UP ? l.in_halo + b * l.win : b * l.in_halo);
    };

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
    const int g = lane >> 2, q = lane & 3;     // accumulator row group, column pair
    const int phase = blockIdx.x % a.phases;
    const int stride = gridDim.x / a.phases, first = blockIdx.x / a.phases;
    const int ldh = a.cols_p + 8;

    if (base & 127) __trap();  // TMA boxes land 128-B aligned
    if (tid == 0) {
        for (int s = 0; s < a.ring + 2; ++s) mbar_init(bars + s * 8, 1);
    }
    if constexpr (HEAD) {  // the phase's head rows, bias and head bias, resident
        const uint4* src = reinterpret_cast<const uint4*>(
            a.head + static_cast<long long>(phase) * a.cout_p * ldh);
        uint4* dst = reinterpret_cast<uint4*>(Hw);
        for (int i = tid; i < a.cout_p * ldh / 8; i += kThreads) dst[i] = src[i];
        for (int i = tid; i < a.cout_p; i += kThreads) bs[i] = a.bias[phase * a.cout_p + i];
        for (int i = tid; i < a.cols_p; i += kThreads) hbs[i] = a.hbias[phase * a.cols_p + i];
    }
    fence_mbar_init();
    __syncthreads();

    const int my_tiles = first < a.n_tiles ? (a.n_tiles - 1 - first) / stride + 1 : 0;
    const bool resident = a.slices <= a.ring;
    const long long total = resident ? a.slices : static_cast<long long>(my_tiles) * a.slices;
    const int n_items = my_tiles * (a.kch == 1 ? 1 : a.nch * a.kch);
    if (tid == 0 && my_tiles > 0) {
        for (long long s = 0; s < total && s < a.ring; ++s)
            issue_slice<NM>(a, phase, s, wring, bars);
        if (a.vec) issue_item<UP>(a, &in_map, first, stride, 0, smem_u32(item_buf(0)), in_bars);
    }
    // the lane's ldmatrix.trans address into the head rows: row (l & 7) +
    // 8 ((l >> 3) & 1), columns 8 (l >> 4) ..
    const uint32_t h_lane =
        smem_u32(Hw + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldh + (lane >> 4) * 8);
    const int z16 = a.cols_p / 16;
    auto act = [](float v) { return EXACT ? gelu_fast(v, 1) : conv64::gelu_tanh_ex2(v); };
    // the store's walk over a row's logits (with a head): the lane's first
    // (pixel, column) and the step of 32 elements
    const int ldo = a.phases * a.ncols, col0 = phase * a.ncols;
    const int lane_p = lane / a.ncols, lane_n = lane % a.ncols;
    const int step_p = 32 / a.ncols, step_n = 32 % a.ncols;
    // without a head: the warp's staging, 16 pixels of nm + 8 bf16
    constexpr int kSp = NM + 8;
    bf16* stg_own = Hw + warp * 16 * kSp;

    long long gi = 0;  // the block's slice counter
    int ii = 0;        // its input item counter
    for (int t = first; t < a.n_tiles; t += stride) {
        const Tile tl = tile_at(a, t);
        float z[kRows][kZ8][4];  // with a head: its f32 sums across the N chunks
        if constexpr (HEAD) {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
                for (int j = 0; j < kZ8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) z[r][j][e] = 0.0f;
        }
        uint32_t abuf = 0;  // the halo the products read
        for (int nc = 0; nc < a.nch; ++nc) {
            const int nw = n_width<NM>(a, nc);
            float acc[kRows][NM / 2];
            for (int kc = 0; kc < a.kch; ++kc) {
                const int kwc = min(a.kw, a.cin16 * 16 - kc * a.kw);  // this chunk's channels
                if (nc == 0 || a.kch > 1) {  // the next input item
                    wgmma_wait<0>();
                    __syncthreads();  // every reader of the buffers before is done
                    const int b = ii & 1;
                    if (a.vec) {
                        if (tid == 0 && ii + 1 < n_items)
                            issue_item<UP>(a, &in_map, first, stride, ii + 1,
                                           smem_u32(item_buf(b ^ 1)), in_bars + (b ^ 1) * 8);
                        mbar_wait(in_bars + b * 8, (ii >> 1) & 1);
                    } else {
                        load_plain<UP>(a, tl, kc, reinterpret_cast<bf16*>(item_buf(b)));
                        __syncthreads();
                    }
                    if (UP)
                        build_halo(a, tl, kwc / 8, reinterpret_cast<const bf16*>(item_buf(b)),
                                   reinterpret_cast<bf16*>(smem + l.off_in));
                    fence_async_shared();  // the threads' stores to the tensor cores
                    __syncthreads();
                    abuf = UP ? base + l.off_in : smem_u32(item_buf(b));
                    ++ii;
                }
                for (int c = 0; c < kwc / 16; ++c, ++gi) {
                    const int slot = resident ? nc * a.cin16 + kc * (a.kw / 16) + c
                                              : static_cast<int>(gi % a.ring);
                    mbar_wait(bars + slot * 8,
                              resident ? 0 : static_cast<uint32_t>((gi / a.ring) & 1));
                    const uint32_t aa = abuf + 2 * c * kPlane, wa = wring + slot * l.slot;
                    const bool init = kc == 0 && c == 0;
                    wgmma_fence();
                    if constexpr (NM > 64) {  // every path issues one wgmma group
                        switch (nw) {
                            case 128: products<128, NM>(acc, aa, wa, grp, init); break;
                            case 112: products<112, NM>(acc, aa, wa, grp, init); break;
                            case 96: products<96, NM>(acc, aa, wa, grp, init); break;
                            case 80: products<80, NM>(acc, aa, wa, grp, init); break;
                            case 64: products<64, NM>(acc, aa, wa, grp, init); break;
                            case 48: products<48, NM>(acc, aa, wa, grp, init); break;
                            case 32: products<32, NM>(acc, aa, wa, grp, init); break;
                            default: products<16, NM>(acc, aa, wa, grp, init); break;
                        }
                    } else {
                        switch (nw) {
                            case 64: products<64, NM>(acc, aa, wa, grp, init); break;
                            case 48: products<48, NM>(acc, aa, wa, grp, init); break;
                            case 32: products<32, NM>(acc, aa, wa, grp, init); break;
                            default: products<16, NM>(acc, aa, wa, grp, init); break;
                        }
                    }
                    wgmma_commit();
                    if (!resident) {  // slice gi - 1's slot is free once both groups are past it
                        wgmma_wait<1>();
                        __syncthreads();
                        if (tid == 0 && gi >= 1 && gi - 1 + a.ring < total)
                            issue_slice<NM>(a, phase, gi - 1 + a.ring, wring, bars);
                    }
                }
            }
            wgmma_wait<0>();
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
                for (int j = 0; j < NM / 2; ++j) pin(acc[r][j]);

            if constexpr (HEAD) {
                // bias + GELU, rounded to bf16 pairs: y[r][nf][hf] = pixel
                // 16 wq + g + 8 hf of row r, channels nc * 64 + 8 nf + 2 q, + 1
                uint32_t y[kRows][NM / 8][2];
                const float* bch = bs + nc * NM;
#pragma unroll
                for (int nf = 0; nf < NM / 8; ++nf) {
                    if (nf * 8 < nw) {
                        const float b0 = bch[nf * 8 + 2 * q], b1 = bch[nf * 8 + 2 * q + 1];
#pragma unroll
                        for (int r = 0; r < kRows; ++r)
#pragma unroll
                            for (int hf = 0; hf < 2; ++hf)
                                y[r][nf][hf] = pack_bf16(act(acc[r][4 * nf + 2 * hf] + b0),
                                                         act(acc[r][4 * nf + 2 * hf + 1] + b1));
                    }
                }
                // the head: z[r][j] += Y (16 x nw) @ Wh[the chunk's rows, 8 j ..]
#pragma unroll
                for (int kk = 0; kk < NM / 16; ++kk) {
                    if (kk * 16 < nw) {
                        uint32_t af[kRows][4];
#pragma unroll
                        for (int r = 0; r < kRows; ++r) {
                            af[r][0] = y[r][2 * kk][0];
                            af[r][1] = y[r][2 * kk][1];
                            af[r][2] = y[r][2 * kk + 1][0];
                            af[r][3] = y[r][2 * kk + 1][1];
                        }
#pragma unroll
                        for (int j = 0; j < kZ8 / 2; ++j) {
                            if (j < z16) {
                                uint32_t hb[4];
                                conv64::ldsm_x4_trans(
                                    hb, h_lane + ((nc * NM + kk * 16) * ldh + j * 16) * 2);
#pragma unroll
                                for (int r = 0; r < kRows; ++r) {
                                    conv64::mma_bf16(z[r][2 * j], af[r], hb[0], hb[1]);
                                    conv64::mma_bf16(z[r][2 * j + 1], af[r], hb[2], hb[3]);
                                }
                            }
                        }
                    }
                }
            } else {
                // bias + GELU, rounded to bf16, into the warp's staging a row
                // at a time (pixel g + 8 hf, columns 8 nf + 2 q, + 1), then
                // the row's pixels' valid columns of the chunk out
                const int n0 = nc * NM, vc = min(nw, a.ncols - n0);
                const int ox = tl.ox0 + 16 * wq, px = min(16, a.ow - ox);  // the warp's pixels
                const float* bg = a.bias + static_cast<long long>(phase) * a.cout_p + n0;
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
#pragma unroll
                    for (int nf = 0; nf < NM / 8; ++nf) {
                        if (nf * 8 < nw) {
                            const float b0 = __ldg(bg + nf * 8 + 2 * q);
                            const float b1 = __ldg(bg + nf * 8 + 2 * q + 1);
#pragma unroll
                            for (int hf = 0; hf < 2; ++hf)
                                *reinterpret_cast<uint32_t*>(stg_own + (g + 8 * hf) * kSp +
                                                             nf * 8 + 2 * q) =
                                    pack_bf16(act(acc[r][4 * nf + 2 * hf] + b0),
                                              act(acc[r][4 * nf + 2 * hf + 1] + b1));
                        }
                    }
                    __syncwarp();
                    const int yy = tl.oy0 + grp * kRows + r;
                    if (yy < a.oh && px > 0) {
                        bf16* row = a.out + ((tl.img * a.oh + yy) * a.ow + ox) * ldo + col0 + n0;
                        if (a.vec_out) {  // 16 B a lane, neighbouring lanes in order
                            const int v8 = vc >> 3;
                            for (int e = lane; e < px * v8; e += 32) {
                                const int p = e / v8, v = e - p * v8;
                                *reinterpret_cast<uint4*>(row + p * ldo + 8 * v) =
                                    *reinterpret_cast<const uint4*>(stg_own + p * kSp + 8 * v);
                            }
                        } else {
                            for (int e = lane; e < px * vc; e += 32) {
                                const int p = e / vc, n = e - p * vc;
                                row[p * ldo + n] = stg_own[p * kSp + n];
                            }
                        }
                    }
                    __syncwarp();
                }
            }
        }
        if constexpr (HEAD) {
            __syncthreads();  // every warpgroup is done with the halo: the staging lies over it

            // z + the head bias as bf16 into the warp's staging, row r * 16 +
            // pixel, sp = cols_p + 2 columns apart; then each of the warp's two
            // rows of 16 pixels out
            const int sp = a.cols_p + 2;
            bf16* stg = reinterpret_cast<bf16*>(smem + (abuf - base)) + warp * (kRows * 16 * sp);
#pragma unroll
            for (int j = 0; j < kZ8; ++j) {
                if (j * 8 < a.cols_p) {
                    const int n0 = j * 8 + 2 * q;
                    const float h0 = hbs[n0], h1 = hbs[n0 + 1];
#pragma unroll
                    for (int r = 0; r < kRows; ++r)
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf)
                            *reinterpret_cast<uint32_t*>(stg + (r * 16 + g + 8 * hf) * sp + n0) =
                                pack_bf16(z[r][j][2 * hf] + h0, z[r][j][2 * hf + 1] + h1);
                }
            }
            __syncwarp();
            // a row's logits: element e = p * ncols + n is pixel ox + p's
            // column col0 + n, walked in order by neighbouring lanes (in K10
            // the row's pixels are contiguous too), p and n kept without a
            // division
            const int ox = tl.ox0 + 16 * wq, px = min(16, a.ow - ox);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const int yy = tl.oy0 + grp * kRows + r;
                if (yy >= a.oh || px <= 0) continue;
                bf16* row = a.out + ((tl.img * a.oh + yy) * a.ow + ox) * ldo + col0;
                const bf16* src = stg + r * 16 * sp;
                int p = lane_p, n = lane_n;
                for (int e = lane; e < px * a.ncols; e += 32) {
                    row[p * ldo + n] = src[p * sp + n];
                    p += step_p;
                    n += step_n;
                    if (n >= a.ncols) {
                        n -= a.ncols;
                        ++p;
                    }
                }
            }
            fence_async_shared();  // the staging's buffer is a TMA landing again
        }
    }
}

// x (batch, h, w_, c) bf16 as a 5-D tensor (8 channels, w_, h, c / 8 groups,
// batch) with boxes of 8 x box_w x box_h pixels x `groups` x 1: a box lands
// as [group][row][pixel][8 channels], planar
bool planar_map(CUtensorMap* map, const void* t, int batch, int h, int w_, int c, int box_w,
                int box_h, int groups) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(w_), static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(c / 8), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[4] = {c * 2ull, c * 2ull * w_, 16, c * 2ull * w_ * h};  // bytes
    const cuuint32_t box[5] = {8, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h),
                               static_cast<cuuint32_t>(groups), 1};
    const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(t), dims, strides,
                  box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

using Kernel = void (*)(const Args, const CUtensorMap);

template <bool HEAD, int NM>
Kernel pick(bool up, bool exact) {
    return up ? (exact ? heads_wide_kernel<true, true, HEAD, NM>
                       : heads_wide_kernel<true, false, HEAD, NM>)
              : (exact ? heads_wide_kernel<false, true, HEAD, NM>
                       : heads_wide_kernel<false, false, HEAD, NM>);
}

// the launch both launchers share: a.x .. a.out, a.cin, a.cout_p, a.cols_p,
// a.ncols and a.phases set by the caller; checks the rest of the geometry
// against its own and launches
int launch_wide(Args& a, int batch, int in_h, int in_w, bool upsample, bool exact, int tile_h,
                int tile_w, int kw, int nm, int ring, int grid, int smem, void* stream) {
    const bool head = a.cols_p > 0;
    if (batch <= 0 || in_h <= 0 || in_w <= 0 || a.cin <= 0 || a.cout_p <= 0 || a.cout_p % 16 ||
        tile_h != kTH || tile_w != kTW || ring < 1 || ring > kMaxRing)
        return static_cast<int>(cudaErrorInvalidValue);
    a.in_h = in_h;
    a.in_w = in_w;
    a.oh = upsample ? 2 * in_h : in_h;
    a.ow = upsample ? 2 * in_w : in_w;
    a.cin16 = (a.cin + 15) / 16;
    a.kch = (a.cin16 * 16 + kKMax - 1) / kKMax;
    a.kw = 16 * ((a.cin16 + a.kch - 1) / a.kch);
    a.nch = (a.cout_p + nm - 1) / nm;
    a.w_phase = static_cast<long long>(a.cout_p) * a.cin16 * (kSliceColBytes / 2);
    a.ring = ring;
    a.slices = a.nch * a.cin16;
    a.vec = a.cin % 8 == 0;
    a.vec_out = (a.phases * a.ncols) % 8 == 0;
    if (kw != a.kw || (a.slices > ring && ring < 2)) return static_cast<int>(cudaErrorInvalidValue);
    a.l = layout(upsample, head, a.cout_p, a.kw, a.cols_p, ring, nm);
    if (static_cast<size_t>(smem) != a.l.total) return static_cast<int>(cudaErrorInvalidValue);
    a.tiles_x = (a.ow + kTW - 1) / kTW;
    a.tiles_per_img = ((a.oh + kTH - 1) / kTH) * a.tiles_x;
    const long long n_tiles = static_cast<long long>(batch) * a.tiles_per_img;
    const long long per = a.kch == 1 ? 1 : a.nch * a.kch;
    if (n_tiles * per > INT_MAX || grid < a.phases || grid % a.phases ||
        grid / a.phases > n_tiles)
        return static_cast<int>(cudaErrorInvalidValue);
    a.n_tiles = static_cast<int>(n_tiles);
    CUtensorMap in_map{};
    if (a.vec && !planar_map(&in_map, a.x, batch, in_h, in_w, a.cin, upsample ? kWW : kHW,
                             upsample ? kWH : kHH, a.kw / 8))
        return static_cast<int>(cudaErrorNotSupported);
    const Kernel kernel = head        ? pick<true, kHeadNMax>(upsample, exact)
                          : nm == 64 ? pick<false, 64>(upsample, exact)
                                     : pick<false, 128>(upsample, exact);
    cudaError_t e = pgm_set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, in_map);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10 (upsample = 1) and K11 (upsample = 0) at the shapes their own kernels
// do not take. x (batch, in_h, in_w, cin) bf16; wl, bias, head, hbias as
// ops/decoder.py::head_weight_layout and head_vectors lay them out for
// `phases` phases of cout_p padded columns and cols_p padded head columns;
// out (batch, oh, ow, phases * ncols) bf16, (oh, ow) = (2 in_h, 2 in_w) with
// upsample, else (in_h, in_w). tile_h, tile_w, kw, ring, grid, smem: the
// launch geometry of ops/decoder.py::HeadTiling, which this checks against
// its own.
PGM_EXPORT int heads_wide_launch(const void* x, const void* wl, const void* bias, const void* head,
                                 const void* hbias, void* out, int batch, int in_h, int in_w,
                                 int cin, int cout_p, int cols_p, int ncols, int phases,
                                 int upsample, int exact, int tile_h, int tile_w, int kw, int ring,
                                 int grid, int smem, void* stream) {
    if (cols_p <= 0 || cols_p % 16 || cols_p > kColsMax || ncols <= 0 || ncols > cols_p ||
        (phases != 1 && phases != 4) || head == nullptr || hbias == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{};
    a.x = static_cast<const bf16*>(x);
    a.wl = static_cast<const bf16*>(wl);
    a.bias = static_cast<const float*>(bias);
    a.head = static_cast<const bf16*>(head);
    a.hbias = static_cast<const float*>(hbias);
    a.out = static_cast<bf16*>(out);
    a.cin = cin;
    a.cout_p = cout_p;
    a.cols_p = cols_p;
    a.ncols = ncols;
    a.phases = phases;
    return launch_wide(a, batch, in_h, in_w, upsample != 0, exact != 0, tile_h, tile_w, kw,
                       kHeadNMax, ring, grid, smem, stream);
}

// K9 (upsample = 1) and K8 (upsample = 0) at the shapes their own kernels do
// not take: the same conv with no head, any cout. x as above; wl as
// ops/decoder.py::head_weight_layout lays it out (one phase) for N chunks
// of n_max (64 or 128) columns, bias (cout_p,) f32 zero past cout; out
// (batch, oh, ow, cout) bf16. tile_h, tile_w, kw, n_max, ring, grid, smem:
// the launch geometry of ops/decoder.py::HeadTiling with n_out = 0.
PGM_EXPORT int conv_wide_launch(const void* x, const void* wl, const void* bias, void* out,
                                int batch, int in_h, int in_w, int cin, int cout_p, int cout,
                                int upsample, int exact, int tile_h, int tile_w, int kw, int n_max,
                                int ring, int grid, int smem, void* stream) {
    if (cout <= 0 || cout_p != (cout + 15) / 16 * 16 || (n_max != 64 && n_max != 128))
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{};
    a.x = static_cast<const bf16*>(x);
    a.wl = static_cast<const bf16*>(wl);
    a.bias = static_cast<const float*>(bias);
    a.out = static_cast<bf16*>(out);
    a.cin = cin;
    a.cout_p = cout_p;
    a.cols_p = 0;
    a.ncols = cout;
    a.phases = 1;
    return launch_wide(a, batch, in_h, in_w, upsample != 0, exact != 0, tile_h, tile_w, kw, n_max,
                       ring, grid, smem, stream);
}
