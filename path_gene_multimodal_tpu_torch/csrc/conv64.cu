// The HoverNeXt final-stage 3x3 convs at their input's resolution for the
// H100: conv 64 -> 64 -> bias -> GELU, or, per parity phase, conv 64 -> 64
// -> bias -> GELU -> head product.
//
// Replaces two TPU kernels of path_gene_multimodal_tpu/ops/pallas/decoder.py:
//   K8  fused_final_conv_gelu (:591, pallas_call :620): 3x3 SAME conv +
//       bias + GELU -> bf16 (B, H, W, 64), at full resolution;
//   K11 composite_final_heads (:462, pallas_call :506): 3x3 SAME conv with
//       the parity-folded weights (3, 3, 64, 4 x 64) + bias + GELU, rounded
//       to bf16, then the block-diagonal head product (4 x 64, 4 n) + bias ->
//       bf16 (B, H, W, 4 n) parity logits, at half resolution. Phase p's
//       logits (columns p n .. p n + n - 1) depend only on its own 64 conv
//       channels, since the off-diagonal head blocks are zero: the kernel
//       runs the four phases as four independent 64 -> 64 convs, each with
//       its diagonal head block, and reads no off-diagonal block
//       (ops/decoder.py::composite_final_heads takes this route only where
//       the caller states that the head is block-diagonal; other heads,
//       widths other than 64 and more than 16 head columns take
//       csrc/decoder_conv.cu's any route, which multiplies the whole head).
//
// Numerics as the TPU kernels: bf16 inputs, weights and vectors, f32
// accumulation, bf16 outputs; K11 rounds the GELU output to bf16 before the
// head. GELU by flag, as pgm_gelu: tanh mode as csrc/conv64.cuh::
// gelu_tanh_ex2 (one ex2.approx, one rcp.approx), exact mode as
// csrc/hopper.cuh::gelu_fast; each within ~1e-6 |x| of pgm_gelu. The mode
// is compiled into the kernel.
//
// What bounds them here: K8 bytes and operations about equally (2^31 bf16
// elements in and out per 512-image batch, 8.6 GB, 2.56 ms at the HBM rate;
// 2.47 TFLOP, 2.50 ms at the bf16 peak); K11 operations (2.5 TFLOP per
// batch for 1.1 GB in, 0.67 GB out).
//
// Design: the 64-channel conv core of K9/K10 (csrc/conv64.cuh: resident
// weights, a planar input, 36 k-steps of wgmma m64n64k16 with both operands
// from shared memory, bias + GELU and the head in registers) fed by a ring
// of copied input rows instead of an upsampled halo.
//  1. Persistent blocks of two warpgroups, one per SM, each block holding
//     phase p = blockIdx.x % phases's weight resident (73,728 B; K8: one
//     phase; K11: four, so the four blocks of one tile run side by side and
//     read its input from L2 once it is there). Each warpgroup is a worker
//     of its own, with its own ring and its own named barrier: a work item
//     is a strip of kStripH rows x 64 columns of one image, and worker
//     w = (blockIdx.x / phases) * 2 + g walks items t = w, += 2 gridDim.x /
//     phases. The two workers of a block take turns at the tensor cores
//     (named barriers 3 and 4), so that one's copies and bias + GELU
//     epilogue (two MUFU operations an element, on the CUDA cores) run
//     while the other's products hold the tensor cores; left to themselves
//     they ran in step, both products, then both epilogues.
//  2. An item is walked downwards in steps of 4 output rows, each one m64
//     tile. A step reads input rows y0 - 1 .. y0 + 4, columns x0 - 1 ..
//     x0 + 64.
//  3. The ring: a worker's input rows form one stream (item by item, each
//     item's rows y0 - 1 .. y0 + 4 steps), stream position s in slot s % 8,
//     each slot one row of 66 pixels held planar ([c / 8][pixel][8],
//     8,448 B), so every tap is a canonical wgmma operand. Thread 0 of the
//     worker copies a row by one TMA box of a 5-D view of x (8 channels,
//     w, h, 8 channel groups, B) that lands planar, the tensor map's zero
//     fill outside the image being the conv's SAME padding; slot s's
//     mbarrier completes once per fill. Before a step's products, the rows
//     of the following steps that fit the free slots are issued; after the
//     products have released the step's slots, the rest of the next step's
//     rows. Each input row is copied once per item (read amplification
//     66/64 x 34/32).
//  4. Epilogue: bias + GELU in registers, rounded to bf16. K8 stages one
//     output row of a warp's 16 pixels at a time and writes 16-B chunks
//     (TMA stores from a swizzled staging ran slower); K11 runs the head
//     product on the tensor cores and writes its n columns of the pixel's
//     4 n-wide row.
// Activation offsets are 64-bit: one K8 call takes a 512-image batch, 2^31
// elements. Launch geometry: ops/decoder.py::StripTiling, which the
// launcher checks against its own.
// Shared memory: weights 73,728 + two rings 135,168 + staging 18,432 +
// mbarriers 128 (+ head weights 3,072) = 227,456 (230,528) B.
#include "common.cuh"
#include "conv64.cuh"

#include <climits>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace conv64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kWarps / 4;            // warpgroups, each a worker of its own
constexpr int kGroupThreads = kThreads / kGroups;
constexpr int kRows = 4;                       // output rows (m64 tiles) per step of a worker
constexpr int kTW = 64;                        // strip width
constexpr int kStripH = 32;                    // rows of a work item
constexpr int kRowPx = kTW + 2;                // pixels of a ring row
constexpr int kRing = 8;                       // ring slots (input rows) per worker
constexpr int kWin = kRows + 2;                // input rows a step reads
static_assert(kRing > kWin, "the ring holds a step's window and more");
static_assert(kStripH % kRows == 0, "whole steps per strip");
static_assert(kGroups == 2, "two workers take turns");

constexpr uint32_t kPlane = kRowPx * 16;       // bytes of one 8-channel plane of a row
constexpr uint32_t kSlot = 8 * kPlane;         // one TMA box, 128-B aligned
static_assert(kSlot % 128 == 0, "TMA boxes 128-B aligned");
constexpr uint32_t kStgBytes = 16 * kLd * 2;   // per warp: a row of 16 pixels (K11: 4 x 16 x kNP)
static_assert(kStgBytes >= kRows * 16 * kNP * 2, "the head staging fits");
constexpr size_t kOffRing = kWBytes;
constexpr size_t kOffStg = kOffRing + size_t(kGroups) * kRing * kSlot;
constexpr size_t kOffBar = kOffStg + size_t(kWarps) * kStgBytes;
constexpr size_t kOffHead = kOffBar + kGroups * kRing * 8;
static_assert(kOffRing % 128 == 0, "TMA boxes 128-B aligned");

constexpr size_t smem_bytes(bool head) { return kOffHead + (head ? kHeadBytes : 0); }

struct Args {
    const bf16* x;   // (B, h, w_, 64)
    const bf16* w;   // (3, 3, 64, 64 phases)
    const bf16* b;   // (64 phases,)
    const bf16* wh;  // (64 phases, nout phases), block-diagonal; K11
    const bf16* bh;  // (nout phases,); K11
    bf16* out;       // (B, h, w_, 64) or (B, h, w_, nout phases)
    int h, w_;
    int strips_x, items_per_img, n_items;
    int phases, nout;
    int exact;
};

struct Item {
    int img;
    int y0, x0;  // first output row / col
    int steps;   // steps of kRows rows (the last may pass the image's end)
};

// item t: image, row segment, column strip (columns fastest)
__device__ __forceinline__ Item item_at(const Args& a, int t) {
    const int img = t / a.items_per_img, rem = t - img * a.items_per_img;
    const int sy = rem / a.strips_x;
    const int y0 = sy * kStripH;
    const int rows = min(kStripH, a.h - y0);
    return Item{img, y0, (rem - sy * a.strips_x) * kTW, (rows + kRows - 1) / kRows};
}

// The cursor over a worker's stream of input rows: row k of item t's
// rows (input row y0 - 1 + k) is next, at stream position pos.
struct Loader {
    int t, k, pos;
    Item it;
};

// issue the copies of the stream's rows before position `limit`: input
// row y, columns x0 - 1 .. x0 + 64, into ring slot pos % kRing, planar
// (plane c: channels 8 c .. 8 c + 7 of the 66 pixels), one TMA box, zero
// outside the image; slot s's copy completes mbarrier s, one phase per
// fill. Every thread of the worker keeps the cursor; the issuer copies.
__device__ __forceinline__ void issue_until(const Args& a, const CUtensorMap& in_map,
                                            Loader& ld, int limit, int stride, uint32_t ring,
                                            uint32_t bars, bool issuer) {
    while (ld.pos < limit && ld.t < a.n_items) {
        if (issuer) {
            const uint32_t slot = ring + (ld.pos % kRing) * kSlot;
            const uint32_t bar = bars + (ld.pos % kRing) * 8;
            mbar_arrive_expect_tx(bar, kSlot);
            tma_load_5d(slot, &in_map, 0, ld.it.x0 - 1, ld.it.y0 - 1 + ld.k, 0, ld.it.img, bar);
        }
        ++ld.pos;
        if (++ld.k == kRows * ld.it.steps + 2) {
            ld.k = 0;
            ld.t += stride;
            if (ld.t < a.n_items) ld.it = item_at(a, ld.t);
        }
    }
}

// a barrier of warpgroup grp's 128 threads (named barrier 1 + grp)
__device__ __forceinline__ void group_sync(int grp) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(kGroupThreads) : "memory");
}

// The workers' turns at the tensor cores: warpgroup grp waits at named
// barrier 3 + grp until the other has arrived there (its products done)
__device__ __forceinline__ void turn_wait(int grp) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(3 + grp), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void turn_pass(int grp) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + (1 - grp)), "n"(kThreads) : "memory");
}

// the steps of worker w: its items' steps, summed
__device__ __forceinline__ int steps_of(const Args& a, int w, int stride) {
    int n = 0;
    for (int t = w; t < a.n_items; t += stride) n += item_at(a, t).steps;
    return n;
}

// EXACT: the GELU mode (a.exact), compiled into the epilogue. in_map: x as
// (8 channels, w_, h, 8 channel groups, B), boxes of all 8 x 66 pixels x
// all 8 groups, which land planar.
template <bool HEAD, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
    conv64_kernel(const Args a, const __grid_constant__ CUtensorMap in_map) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Ws = reinterpret_cast<bf16*>(smem);
    bf16* Hw = reinterpret_cast<bf16*>(smem + kOffHead);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
    const int g = lane >> 2, q = lane & 3;     // accumulator row group, column pair
    const int gtid = tid & (kGroupThreads - 1);
    const uint32_t base = smem_u32(smem);
    const uint32_t ring = base + kOffRing + grp * kRing * kSlot;
    const uint32_t bars = base + kOffBar + grp * kRing * 8;
    bf16* stg = reinterpret_cast<bf16*>(smem + kOffStg + warp * kStgBytes);
    const int phase = blockIdx.x % a.phases;
    const int stride = gridDim.x / a.phases * kGroups;  // workers per phase
    const int ldo = HEAD ? a.nout * a.phases : kC;

    if (base & 127) __trap();  // TMA boxes land 128-B aligned
    if (gtid == 0)
        for (int s = 0; s < kRing; ++s) mbar_init(bars + s * 8, 1);
    load_weights<kThreads>(Ws, a.w, kC * a.phases, kC * phase);  // resident
    if (HEAD) load_head<kThreads>(Hw, a.wh, ldo, kC * phase, a.nout * phase, a.nout);
    const bf16* bias = a.b + kC * phase;
    const bf16* bh = HEAD ? a.bh + a.nout * phase : nullptr;
    const uint32_t ws = smem_u32(Ws);
    const uint32_t h_base = head_base(Hw, lane);
    fence_mbar_init();
    fence_async_shared();  // the weights to the tensor cores ...
    __syncthreads();       // ... of both warpgroups, the mbarriers to both

    // Both workers of the block take the same number of turns, a worker
    // with fewer steps idling through the rest: in each, it waits for its
    // turn at the tensor cores, runs its products and passes the turn on,
    // so that one's epilogue runs under the other's products.
    const int w0 = blockIdx.x / a.phases * kGroups;
    const int mine = steps_of(a, w0 + grp, stride);
    const int turns = max(steps_of(a, w0, stride), steps_of(a, w0 + 1, stride));
    const int first = w0 + grp;  // this worker's first item
    Loader ld{first, 0, 0, {}};
    if (first < a.n_items) ld.it = item_at(a, first);
    Item it = ld.it;  // the item of the worker's next step, and the step
    int t = first, j = 0;
    issue_until(a, in_map, ld, kWin, stride, ring, bars, gtid == 0);
    if (grp == 1 && turns > 0) turn_pass(grp);  // worker 0 goes first
    int P = 0;  // stream position of the step's first input row
    for (int turn = 0; turn < turns; ++turn) {
        const bool work = turn < mine;
        if (work) {
#pragma unroll
            for (int i = 0; i < kWin; ++i)  // the step's rows have landed
                mbar_wait(bars + ((P + i) % kRing) * 8, ((P + i) / kRing) & 1);
            issue_until(a, in_map, ld, P + kRing, stride, ring, bars, gtid == 0);  // free slots
        }
        turn_wait(grp);
        // tap row dy of output row r: stream position P + r + dy
        float acc[kRows][32];
        if (work) {
            products<kRows>(
                acc, ws, [&](int i) { return ring + ((P + i) % kRing) * kSlot; }, kPlane);
        } else {  // an idle turn; left undefined here, K11's accumulators spill
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
                for (int k = 0; k < 32; ++k) acc[r][k] = 0.0f;
        }
        if (grp == 0 || turn + 1 < turns) turn_pass(grp);
        if (!work) continue;

        const int pn = P + (j + 1 == it.steps ? kWin : kRows);  // the next step's
        group_sync(grp);  // the worker's warps are done with this step's slots
        issue_until(a, in_map, ld, pn + kWin, stride, ring, bars, gtid == 0);

        uint32_t y[kRows][8][2];
        bias_act<kRows>(y, acc, bias, q, [](float v) {
            return EXACT ? gelu_fast(v, 1) : gelu_tanh_ex2(v);
        });
        // the warp's pixels: rows oy .. oy + 3, columns ox .. ox + 15
        const int oy = it.y0 + j * kRows, ox = it.x0 + 16 * wq;
        if (!HEAD) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
                for (int nf = 0; nf < 8; ++nf)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf)
                        *reinterpret_cast<uint32_t*>(stg + (g + 8 * hf) * kLd + nf * 8 + 2 * q) =
                            y[r][nf][hf];
                __syncwarp();
                // 16 pixels x 8 chunks of 16 B; 8 lanes write one pixel's 128 B
                const int yy = oy + r;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int i = k * 32 + lane, px = i >> 3, c8 = (i & 7) * 8;
                    const int x = ox + px;
                    if (yy < a.h && x < a.w_)
                        *reinterpret_cast<uint4*>(
                            a.out + ((static_cast<long long>(it.img) * a.h + yy) * a.w_ + x) * kC +
                            c8) = *reinterpret_cast<const uint4*>(stg + px * kLd + c8);
                }
                __syncwarp();
            }
        } else {
            // row by row: the four rows' head sums at once would not fit
            // the registers
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                float z[1][2][4];
                head_product<1>(z, reinterpret_cast<const uint32_t(&)[1][8][2]>(y[r]), h_base);
                stage_head<1>(stg + r * 16 * kNP, z, bh, a.nout, g, q);
            }
            __syncwarp();
            for (int i = lane; i < kRows * 16 * a.nout; i += 32) {
                const int p = i / a.nout, n = i - p * a.nout;
                const int yy = oy + (p >> 4), x = ox + (p & 15);
                if (yy < a.h && x < a.w_)
                    a.out[((static_cast<long long>(it.img) * a.h + yy) * a.w_ + x) * ldo +
                          a.nout * phase + n] = stg[p * kNP + n];
            }
            __syncwarp();
        }
        P = pn;
        if (++j == it.steps) {
            j = 0;
            t += stride;
            if (t < a.n_items) it = item_at(a, t);
        }
    }
}

// x (batch, h, w_, 64) bf16 as a 5-D tensor (8 channels, w_, h, 8 channel
// groups, batch) with boxes of 8 x 66 pixels x 1 row x 8 groups x 1 image:
// a box lands as [group][pixel][8 channels], the ring's planar row
bool planar_map(CUtensorMap* map, const void* t, int batch, int h, int w_) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(w_), static_cast<cuuint64_t>(h), 8,
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[4] = {kC * 2ull, kC * 2ull * w_, 16, kC * 2ull * w_ * h};  // bytes
    const cuuint32_t box[5] = {8, kRowPx, 1, 8, 1}, estr[5] = {1, 1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(t), dims, strides,
                  box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks the geometry the wrapper computed (ops/decoder.py::StripTiling)
// against this source's own, builds the input's tensor map, then launches.
cudaError_t launch(Args a, bool head, int batch, int cin, int cout, int strip_h, int strip_w,
                   int step_rows, int ring, int grid, int smem, cudaStream_t st) {
    if (cin != kC || cout != kC * a.phases || strip_h != kStripH || strip_w != kTW ||
        step_rows != kRows || ring != kRing)
        return cudaErrorInvalidValue;
    if (a.h <= 0 || a.w_ <= 0 || batch <= 0) return cudaErrorInvalidValue;
    if (head && (a.nout <= 0 || a.nout > kNP)) return cudaErrorInvalidValue;
    if (static_cast<size_t>(smem) != smem_bytes(head)) return cudaErrorInvalidValue;
    a.strips_x = (a.w_ + kTW - 1) / kTW;
    a.items_per_img = ((a.h + kStripH - 1) / kStripH) * a.strips_x;
    const long long n_items = static_cast<long long>(batch) * a.items_per_img;
    if (n_items > INT_MAX / 2 || grid < a.phases || grid % a.phases ||
        grid / a.phases > (n_items + kGroups - 1) / kGroups)
        return cudaErrorInvalidValue;
    a.n_items = static_cast<int>(n_items);
    CUtensorMap in_map;
    if (!planar_map(&in_map, a.x, batch, a.h, a.w_)) return cudaErrorNotSupported;
    void (*kernel)(const Args, const CUtensorMap) =
        head ? (a.exact ? conv64_kernel<true, true> : conv64_kernel<true, false>)
             : (a.exact ? conv64_kernel<false, true> : conv64_kernel<false, false>);
    cudaError_t e = pgm_set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, st>>>(a, in_map);
    return cudaGetLastError();
}

}  // namespace

// K8. x (B, H, W, cin), w (3, 3, cin, cout), b (cout,); out (B, H, W, cout);
// cin = cout = 64. strip_h, strip_w, ring, grid, smem: the launch geometry
// of ops/decoder.py::StripTiling.
PGM_EXPORT int final_conv_gelu_launch(const void* x, const void* w, const void* b, void* out,
                                      int batch, int h, int w_, int cin, int cout, int exact,
                                      int strip_h, int strip_w, int step_rows, int ring, int grid,
                                      int smem, void* stream) {
    Args a{};
    a.x = static_cast<const bf16*>(x);
    a.w = static_cast<const bf16*>(w);
    a.b = static_cast<const bf16*>(b);
    a.out = static_cast<bf16*>(out);
    a.h = h;
    a.w_ = w_;
    a.phases = 1;
    a.exact = exact;
    return static_cast<int>(launch(a, false, batch, cin, cout, strip_h, strip_w, step_rows, ring,
                                   grid, smem, static_cast<cudaStream_t>(stream)));
}

// K11. x (B, H, W, cin), wc (3, 3, cin, c4), b4 (c4,), wh (c4, n4)
// block-diagonal (only its four diagonal (c4 / 4, n4 / 4) blocks are read),
// bh4 (n4,); out (B, H, W, n4); cin = c4 / 4 = 64, n4 / 4 <= 16. Geometry
// as K8's, with four phases.
PGM_EXPORT int composite_final_heads_launch(const void* x, const void* wc, const void* b4,
                                            const void* wh, const void* bh4, void* out, int batch,
                                            int h, int w_, int cin, int c4, int n4, int exact,
                                            int strip_h, int strip_w, int step_rows, int ring,
                                            int grid, int smem, void* stream) {
    if (n4 % 4) return static_cast<int>(cudaErrorInvalidValue);
    Args a{};
    a.x = static_cast<const bf16*>(x);
    a.w = static_cast<const bf16*>(wc);
    a.b = static_cast<const bf16*>(b4);
    a.wh = static_cast<const bf16*>(wh);
    a.bh = static_cast<const bf16*>(bh4);
    a.out = static_cast<bf16*>(out);
    a.h = h;
    a.w_ = w_;
    a.phases = 4;
    a.nout = n4 / 4;
    a.exact = exact;
    return static_cast<int>(launch(a, true, batch, cin, c4, strip_h, strip_w, step_rows, ring,
                                   grid, smem, static_cast<cudaStream_t>(stream)));
}
