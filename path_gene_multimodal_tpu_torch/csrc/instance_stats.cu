// Per-instance statistics of dense label maps (one segment reduction per
// tile) for the H100.
//
// Replaces the TPU kernel `instance_stats_pallas`
// (path_gene_multimodal_tpu/ops/pallas/instance_stats.py:123, pallas_call
// at :152), which builds a one-hot (pixels, S) matrix per row strip and
// contracts it with a value matrix on the MXU.
//
// What bounds it here: bytes. The work is a read of two int32 maps
// (2 x 4 B per pixel) and a small (S, 16) + (4, S) f32 write per tile. The
// one-hot matmul would spend S operations per pixel to do what one
// shared-memory atomic does, so it is not carried over.
//
// Every summand is an integer: x, y and, with the moments taken about the
// tile centre (sx, sy) = (w/2, h/2), (2x - w)^2 / 4 etc. The sums are exact
// and independent of the order of any atomic; they become f32 once, at the
// end, so the outputs equal ops/instance_stats.py::instance_stats_plain bit
// for bit. (The TPU kernel sums in f32, so its second moments carry f32
// rounding once they pass 2^24.) Ids outside [0, S) are ignored, as the
// one-hot ignores them.
//
// Design (geometry: ops/instance_stats.py::InstanceStatsTiling, checked
// here):
// - Runs, not pixels. A row is cut into spans of 8 pixels, one span a lane.
//   Where rows are 16-byte aligned (w % 4 == 0) a whole span comes by two
//   16-byte loads of labels and two of types, other spans (a row's tail,
//   unaligned rows) by scalar loads of their valid pixels. (Copying each
//   warp's next 32 spans into shared memory by cp.async an iteration ahead
//   was no faster: the loop waits on its runs' work, not on its loads.) A
//   lane keeps its span as bit masks: run boundaries, the pixels of each
//   type, the background's pixels. The background (slot 0, most pixels)
//   is summed from its mask (counts and index sums by popcount) into the
//   lane's own record and added to the table every few thousand spans.
//   Slots >= 1 go by runs of one id: a run of one row is a range [x0, x1]
//   at one y, so its count, sums and moments follow in closed form from
//   (x0, x1, y), its votes by popcount of the type masks (16-bit fields,
//   types 1-4 and 5-8 in two 64-bit words). A warp takes 32 consecutive
//   spans of its block's rows (a band's rows, then the next band's); a run
//   that crosses lanes (same id, same row) is joined by a segmented scan
//   over the lanes (heads from a ballot, the votes summed with shuffles),
//   and each maximal run of the warp's 256 pixels issues one set of
//   shared-memory atomics (6 sums, its votes, 4 extrema), from the lane
//   where it ends, or where it ends inside a span after crossing into it;
//   a lane adds its runs in one loop, so that the lanes of a warp add
//   theirs side by side.
// - A tile split over a thread-block cluster of k blocks of 512 threads.
//   The tile's rows are cut into bands of 8, dealt to the blocks in turn
//   (block r takes bands r, r + k, ...), so that each block meets the
//   tile's nuclei about evenly; each block keeps the tile's whole slot
//   table for its rows in shared memory (S x (five sums, count, votes, 4
//   extrema): 30 KB at S = 512 and 6 types with 32-bit sums, which tiles
//   up to about 280^2 take, 40 KB with 64-bit ones). After a cluster
//   barrier, rank r gathers the slots it owns, [r, r + 1) * ceil(S / k),
//   from the other ranks' tables through distributed shared memory
//   (`map_shared_rank`; each peer's count read first, the rest only for a
//   slot live there), turns them into f32 and writes them; a last cluster
//   barrier keeps every table alive until its peers have read it.
// - The cluster kernel takes 2..9 types, tables that fit a block's shared
//   memory and sides under 2^27. Every other shape the TPU kernel takes
//   (any slot count, any num_types >= 1) goes to the table route (further
//   down): the same sums, kept in device memory. Both refuse a tile whose
//   64-bit moment sums could reach 2^63 (moments_fit; no side of 2^27
//   passes it).
#include "common.cuh"

#include <cooperative_groups.h>
#include <limits.h>

#include <type_traits>

namespace cg = cooperative_groups;

// The block's slot table (below), dynamic shared memory.
extern __shared__ __align__(16) unsigned char smem[];

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 8;  // pixels a lane
constexpr int kBand = 8;  // rows of a band (a block takes every k-th band)
constexpr int kFixed = 6;  // count, sum x, sum y, sum dx^2, sum dy^2, sum dxdy
constexpr float kBig = 3e38f;
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

struct Params {
    const int* lbl;
    const int* tp;
    float* sums;
    float* mins;
    int h, w, S, nv, c_sum;
    int spr;    // spans a row
    int vec;    // rows 16-byte aligned: whole spans by vector loads
    int drain;  // spans a lane between additions of its slot-0 sums
    int slot0_at;  // bytes: the lanes' slot-0 records (32-bit sums), after the table
};

// One block's slot table in shared memory, S slots: five sums of type T
// [5][S] (sum x, sum y, sum (2x - w)^2, sum (2y - h)^2, sum of their
// products, the last in two's complement), then the count [S], the votes
// [nv][S] and the extrema xmin, ymin, xmax, ymax [4][S] as int32, at these
// offsets from the table's base (in 4-byte words). T is 32-bit where no
// sum of a tile can pass 2^31 (InstanceStatsTiling.narrow: tiles up to
// about 280^2), with native shared-memory atomics; 64-bit otherwise, whose
// atomic adds the card runs as compare-and-swap loops.
template <typename T>
__device__ __forceinline__ int count_at(int S) { return 5 * static_cast<int>(sizeof(T) / 4) * S; }
template <typename T>
__device__ __forceinline__ int votes_at(int S) { return count_at<T>(S) + S; }
template <typename T>
__device__ __forceinline__ int ext_at(int S, int nv) { return count_at<T>(S) + (1 + nv) * S; }

// This block's table, indexed from the shared symbol so that the compiler
// keeps 32-bit shared addresses and shared-memory atomics.
template <typename T>
__device__ __forceinline__ T* sums(int k, int S) { return reinterpret_cast<T*>(smem) + k * S; }
__device__ __forceinline__ int* word32(int at) { return reinterpret_cast<int*>(smem) + at; }

// A table sum as the signed integer it holds (its value fits T's signed
// range: two's complement for the cross moment).
__device__ __forceinline__ long long signed_of(unsigned v) { return static_cast<int>(v); }
__device__ __forceinline__ long long signed_of(u64 v) { return static_cast<long long>(v); }

enum { kSumX, kSumY, kMomXX, kMomYY, kMomXY };

__device__ __forceinline__ int field(u64 va, u64 vb, int t) {  // t: 0..7
    return static_cast<int>(((t < 4 ? va : vb) >> (16 * (t & 3))) & 0xffffull);
}

// Type votes of the pixels rm of a span as 16-bit fields, types 1-4 in va
// and 5-8 in vb, from its type masks tm (byte t: the pixels of type t + 1).
__device__ __forceinline__ void mask_votes(u64 tm, unsigned rm, u64& va, u64& vb) {
    va = vb = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        va |= static_cast<u64>(__popc(static_cast<unsigned>(tm >> (8 * t)) & rm)) << (16 * t);
        vb |= static_cast<u64>(__popc(static_cast<unsigned>(tm >> (8 * t + 32)) & rm)) << (16 * t);
    }
}

// A finished run of slot id >= 1, pixels x0..x1 of row y: one set of
// shared-memory atomics with its closed-form sums (wrapping in T: the
// table's sums are exact as long as each final sum fits).
template <typename T>
__device__ __forceinline__ void add_run(int S, int nv, int w, int h, int id, int x0, int x1,
                                        int y, u64 va, u64 vb) {
    // In T's width where a term is bounded by a narrow tile's own sums
    // (n (x0 + x1) <= 2 w^2, n y <= w h, n dy^2 <= w h^2, |dy n (x0 + x1 -
    // w)| <= h w^2, all under 2^31); the moment below in 64 bits.
    typedef typename std::conditional<sizeof(T) == 4, int, long long>::type I;
    const I n = x1 - x0 + 1;
    const I dy = 2 * static_cast<I>(y) - h;
    atomicAdd(word32(count_at<T>(S)) + id, static_cast<int>(n));
    atomicAdd(sums<T>(kSumX, S) + id, static_cast<T>(n * (x0 + x1) / 2));
    atomicAdd(sums<T>(kSumY, S) + id, static_cast<T>(n * y));
    // sum_{k < n} (a + 2k)^2 = n a^2 + 2 a n (n - 1) + 2 (n - 1) n (2n - 1) / 3,
    // a = 2 x0 - w, formed in 64 bits whatever T: its terms pass 2^31 for a
    // run of ~1,000 px and the last is divided, which a wrapped product
    // would spoil. (A run is cut at its warp's 256 px, so that today they
    // fit 32 bits; this does not rest on it.) Only the table's sum has to
    // fit T.
    const long long nl = n, a = 2LL * x0 - w;
    const long long mxx = nl * a * a + 2 * a * nl * (nl - 1) + 2 * ((nl - 1) * nl * (2 * nl - 1) / 3);
    atomicAdd(sums<T>(kMomXX, S) + id, static_cast<T>(mxx));
    atomicAdd(sums<T>(kMomYY, S) + id, static_cast<T>(n * dy * dy));
    atomicAdd(sums<T>(kMomXY, S) + id, static_cast<T>(dy * n * (x0 + x1 - w)));  // dy sum (2x - w)
#pragma unroll
    for (int t = 0; t < 8; ++t) {
        const int v = field(va, vb, t);
        if (t < nv && v) atomicAdd(word32(votes_at<T>(S) + t * S) + id, v);
    }
    int* e = word32(ext_at<T>(S, nv));
    atomicMin(e + id, x0);
    atomicMin(e + S + id, y);
    atomicMax(e + 2 * S + id, x1);
    atomicMax(e + 3 * S + id, y);
}

// A lane's sums of the background, added into the table every `drain`
// spans (Params): a lane adds at most 8 pixels of slot 0 a span, so its
// 32-bit count and sums of x and y stay under 2^31, its moments (in the
// table's width T; at most 8 max(w, h)^2 a span) too, and its votes (at
// most 8 a type a span) under the 16-bit fields' 2^16 (types 2t+1 and
// 2t+2 in v[t]). With 32-bit sums a lane keeps them in shared memory
// (Slot0Smem, 15 words a lane so that a warp's lanes fall in distinct
// banks), which keeps the loop within 64 registers; with 64-bit ones in
// registers.
template <typename T>
struct Slot0 {
    int cnt, sx, sy;
    T mxx, myy, mxy;
    int xmn, ymn, xmx, ymx;
    unsigned v[4];
};

template <typename T>
__device__ __forceinline__ Slot0<T> slot0_zero() {
    return Slot0<T>{0, 0, 0, 0, 0, 0, INT_MAX, INT_MAX, INT_MIN, INT_MIN, {0u, 0u, 0u, 0u}};
}

struct Slot0Smem : Slot0<unsigned> {
    unsigned pad;
};
static_assert(sizeof(Slot0Smem) == 15 * 4, "a lane's slot-0 record: 15 words");

// This lane's slot-0 sums: its record in shared memory behind the table
// (32-bit sums), or the registers of `reg` (64-bit).
template <typename T>
__device__ __forceinline__ Slot0<T>& slot0_of(Slot0<T>& reg, int table_bytes) {
    if constexpr (sizeof(T) == 4)
        return reinterpret_cast<Slot0Smem*>(smem + table_bytes)[threadIdx.x];
    else
        return reg;
}

// Add the background pixels m0 of the span at (xs, y) to z: with i the
// pixel's index in the span, sum i and sum i^2 from popcounts of its bits.
template <typename T>
__device__ __forceinline__ void add_slot0(Slot0<T>& z, unsigned m0, u64 tm, int xs, int y, int w,
                                          int h) {
    const int n = __popc(m0);
    const int b0 = __popc(m0 & 0xAAu), b1 = __popc(m0 & 0xCCu), b2 = __popc(m0 & 0xF0u);
    const int s1 = b0 + 2 * b1 + 4 * b2;
    const int s2 = b0 + 4 * b1 + 16 * b2 + 4 * __popc(m0 & 0xAAu & 0xCCu) +
                   8 * __popc(m0 & 0xAAu & 0xF0u) + 16 * __popc(m0 & 0xCCu & 0xF0u);
    const long long a = 2LL * xs - w, dy = 2LL * y - h;
    z.cnt += n;
    z.sx += n * xs + s1;
    z.sy += n * y;
    z.mxx += static_cast<T>(n * a * a + 4 * a * s1 + 4 * s2);  // sum (a + 2i)^2
    z.myy += static_cast<T>(n * dy * dy);
    z.mxy += static_cast<T>(dy * (n * a + 2 * s1));
    u64 va, vb;
    mask_votes(tm, m0, va, vb);
    z.v[0] += static_cast<unsigned>(va);
    z.v[1] += static_cast<unsigned>(va >> 32);
    z.v[2] += static_cast<unsigned>(vb);
    z.v[3] += static_cast<unsigned>(vb >> 32);
    z.xmn = min(z.xmn, xs + __ffs(m0) - 1);
    z.xmx = max(z.xmx, xs + 31 - __clz(m0));
    z.ymn = min(z.ymn, y);
    z.ymx = max(z.ymx, y);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// Add the warp's slot-0 registers into the table (lane 0) and clear them.
// Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void drain(Slot0<T>& z, int S, int nv) {
    const int lane = threadIdx.x & 31;
    const int c0 = __reduce_add_sync(kFull, static_cast<unsigned>(z.cnt));
    const long long sx = warp_sum(z.sx), sy = warp_sum(z.sy);
    const long long mxx = warp_sum(signed_of(z.mxx)), myy = warp_sum(signed_of(z.myy)),
                    mxy = warp_sum(signed_of(z.mxy));
    const int xmn = __reduce_min_sync(kFull, z.xmn), ymn = __reduce_min_sync(kFull, z.ymn);
    const int xmx = __reduce_max_sync(kFull, z.xmx), ymx = __reduce_max_sync(kFull, z.ymx);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
        const int v = __reduce_add_sync(kFull, (z.v[t >> 1] >> (16 * (t & 1))) & 0xffffu);
        if (t < nv && v && lane == 0) atomicAdd(word32(votes_at<T>(S) + t * S), v);
    }
    if (lane == 0 && c0 > 0) {
        int* e = word32(ext_at<T>(S, nv));
        atomicAdd(word32(count_at<T>(S)), c0);
        atomicAdd(sums<T>(kSumX, S), static_cast<T>(sx));
        atomicAdd(sums<T>(kSumY, S), static_cast<T>(sy));
        atomicAdd(sums<T>(kMomXX, S), static_cast<T>(mxx));
        atomicAdd(sums<T>(kMomYY, S), static_cast<T>(myy));
        atomicAdd(sums<T>(kMomXY, S), static_cast<T>(mxy));
        atomicMin(e, xmn);
        atomicMin(e + S, ymn);
        atomicMax(e + 2 * S, xmx);
        atomicMax(e + 3 * S, ymx);
    }
    z = slot0_zero<T>();
}

// One lane's span: the pixels [xs, xs + 8) of a row, those past the row's
// end and ids outside [0, S) ignored. What the warp needs of it: the run
// boundaries bm (bit i: pixel i starts a run, i in 1..7) among the pixels
// of slots >= 1 (the background and ignored pixels are one "no run" id),
// the type masks tm, and the run ids, packed as id + 1 in 16-bit fields
// (0: no run). The background's pixels go to z.
struct Span {
    unsigned bm;
    u64 tm;
    unsigned ids[4];
};

__device__ __forceinline__ int run_id(const Span& sp, int i) {  // i: 0..7
    const unsigned w = i < 4 ? (i < 2 ? sp.ids[0] : sp.ids[1]) : (i < 6 ? sp.ids[2] : sp.ids[3]);
    return static_cast<int>((w >> (16 * (i & 1))) & 0xffffu) - 1;
}

template <typename T>
__device__ __forceinline__ Span load_span(const Params& p, Slot0<T>& z, long long px, int nval,
                                          int xs, int y) {
    int id[kSpan], ty[kSpan];
    if (p.vec && nval == kSpan) {
        const int4 l0 = __ldg(reinterpret_cast<const int4*>(p.lbl + px));
        const int4 l1 = __ldg(reinterpret_cast<const int4*>(p.lbl + px) + 1);
        const int4 t0 = __ldg(reinterpret_cast<const int4*>(p.tp + px));
        const int4 t1 = __ldg(reinterpret_cast<const int4*>(p.tp + px) + 1);
        id[0] = l0.x; id[1] = l0.y; id[2] = l0.z; id[3] = l0.w;
        id[4] = l1.x; id[5] = l1.y; id[6] = l1.z; id[7] = l1.w;
        ty[0] = t0.x; ty[1] = t0.y; ty[2] = t0.z; ty[3] = t0.w;
        ty[4] = t1.x; ty[5] = t1.y; ty[6] = t1.z; ty[7] = t1.w;
    } else {
#pragma unroll
        for (int i = 0; i < kSpan; ++i) {
            id[i] = i < nval ? __ldg(p.lbl + px + i) : -1;
            ty[i] = i < nval ? __ldg(p.tp + px + i) : 0;
        }
    }
    Span sp;
    sp.bm = 0;
    sp.tm = 0;
    unsigned m0 = 0;
#pragma unroll
    for (int i = 0; i < kSpan; ++i) {
        m0 |= static_cast<unsigned>(id[i] == 0) << i;
        id[i] = (id[i] >= 1 && id[i] < p.S) ? id[i] : -1;
        if (i > 0) sp.bm |= static_cast<unsigned>(id[i] != id[i - 1]) << i;
        if (ty[i] >= 1 && ty[i] <= p.nv) sp.tm |= 1ull << (8 * (ty[i] - 1) + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        sp.ids[j] = static_cast<unsigned>(id[2 * j] + 1) | (static_cast<unsigned>(id[2 * j + 1] + 1) << 16);
    if (m0) add_slot0(z, m0, sp.tm, xs, y, p.w, p.h);
    return sp;
}

__device__ __forceinline__ unsigned bits(int a, int b) {  // pixels [a, b) of a span
    return ((1u << b) - 1u) & ~((1u << a) - 1u);
}

// Two blocks an SM with 32-bit sums (64 registers, the path's tiles); one
// with 64-bit sums, whose wider registers would spill at 64.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
    instance_stats_kernel(const Params p) {
    cg::cluster_group cl = cg::this_cluster();
    const int k = static_cast<int>(cl.num_blocks());
    const int rank = static_cast<int>(cl.block_rank());
    const int img = blockIdx.x / k;
    const int S = p.S, nv = p.nv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int i = tid; i < 5 * S; i += kThreads) sums<T>(0, S)[i] = 0;
    for (int i = tid; i < (1 + nv) * S; i += kThreads) word32(count_at<T>(S))[i] = 0;
    for (int i = tid; i < 2 * S; i += kThreads) {
        word32(ext_at<T>(S, nv))[i] = INT_MAX;
        word32(ext_at<T>(S, nv))[2 * S + i] = INT_MIN;
    }
    __syncthreads();

    Slot0<T> z_reg;
    Slot0<T>& z = slot0_of(z_reg, p.slot0_at);
    z = slot0_zero<T>();
    int rows = 0;  // this block's: bands rank, rank + k, ... (the last may be short)
    for (int g = rank; g * kBand < p.h; g += k) rows += min(kBand, p.h - g * kBand);
    const int items = rows * p.spr, band_items = kBand * p.spr;
    const long long img_px = static_cast<long long>(img) * p.h * p.w;
    int since_drain = 0;
    for (int base = warp * 32; base < items; base += kWarps * 32) {
        const int item = base + lane;
        const bool valid = item < items;
        const int band = valid ? item / band_items : 0, in_band = valid ? item - band * band_items : 0;
        const int row = in_band / p.spr, s = in_band - row * p.spr;
        const int y = (band * k + rank) * kBand + row, xs = s * kSpan;
        const long long px = img_px + static_cast<long long>(y) * p.w + xs;
        const Span sp = load_span(p, z, px, valid ? min(kSpan, p.w - xs) : 0, xs, y);
        const bool multi = sp.bm != 0;
        const int id0 = run_id(sp, 0), id7 = run_id(sp, kSpan - 1);
        // the first run [0, fe), the last [lb, 8); the middle runs between
        // them are whole here
        const int fe = multi ? __ffs(sp.bm) - 1 : kSpan;
        const int lb = multi ? 31 - __clz(sp.bm) : 0;

        // Join runs across lanes: lane l's first run continues lane l-1's
        // last one when both are one id >= 1 in one row (s > 0). A lane
        // whose whole span continues is no segment head; the segments'
        // votes are summed by a segmented scan, their x0 is their head's.
        const int prev_id = __shfl_up_sync(kFull, id7, 1);
        const bool cont = valid && lane > 0 && s > 0 && id0 >= 1 && id0 == prev_id;
        const unsigned heads = __ballot_sync(kFull, multi || !cont);
        const unsigned joins = __ballot_sync(kFull, multi && cont);  // first run ends a segment
        const int head = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
        u64 va, vb;  // the last run's votes, then its segment's up to this lane
        mask_votes(sp.tm, bits(lb, kSpan), va, vb);
        if (heads != kFull) {
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const u64 na = __shfl_up_sync(kFull, va, d), nb = __shfl_up_sync(kFull, vb, d);
                if (lane - d >= head) {
                    va += na;
                    vb += nb;
                }
            }
        }
        const int seg_x0 = __shfl_sync(kFull, xs + lb, head);
        const u64 pa = __shfl_up_sync(kFull, va, 1), pb = __shfl_up_sync(kFull, vb, 1);
        const int px0 = __shfl_up_sync(kFull, seg_x0, 1);
        const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
        const bool handed_on = lane < 31 && ((joins >> (lane + 1)) & 1u);

        // The runs this lane adds, by their first pixel: the first run (the
        // end of the previous lane's segment when it continues it), the
        // middle ones, the last (its segment, where the segment ends here).
        // One loop, so that the lanes add their runs side by side.
        unsigned todo = multi ? sp.bm & ~(1u << lb) : 0u;  // middle runs
        if (multi && id0 >= 1) todo |= 1u;
        if (valid && tail && !handed_on && id7 >= 1) todo |= 1u << lb;
        while (todo) {
            const int a = __ffs(todo) - 1;
            todo &= todo - 1;
            const unsigned later = sp.bm & ~((2u << a) - 1u);
            const int b = later ? __ffs(later) - 1 : kSpan;
            const int id = run_id(sp, a);
            if (id < 1) continue;
            u64 ra, rb;
            int x0 = xs + a;
            if (a == lb) {  // the segment this lane ends
                ra = va;
                rb = vb;
                x0 = seg_x0;
            } else {
                mask_votes(sp.tm, bits(a, b), ra, rb);
                if (a == 0 && cont) {  // the previous lane's segment, ended here
                    ra += pa;
                    rb += pb;
                    x0 = px0;
                }
            }
            add_run<T>(S, nv, p.w, p.h, id, x0, xs + b - 1, y, ra, rb);
        }
        if (++since_drain == p.drain) {  // warp-uniform
            drain<T>(z, S, nv);
            since_drain = 0;
        }
    }
    drain<T>(z, S, nv);  // slot 0: the warp's sums, added once
    // every rank's table is complete (a block barrier too)
    if (k > 1) cl.sync();
    else __syncthreads();

    // this rank's slots: its own table plus each peer's where the slot is
    // live there, read through distributed shared memory; as f32, once
    const int chunk = (S + k - 1) / k;
    const int s0 = rank * chunk, ns = max(0, min(S, s0 + chunk) - s0);
    for (int s = s0 + tid; s < s0 + ns; s += kThreads) {
        T sm[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) sm[q] = sums<T>(q, S)[s];
        int cnt = word32(count_at<T>(S))[s];
        int votes[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) votes[t] = t < nv ? word32(votes_at<T>(S) + t * S)[s] : 0;
        const int* e = word32(ext_at<T>(S, nv));
        int ext[4] = {e[s], e[S + s], e[2 * S + s], e[3 * S + s]};
        for (int q = 1; q < k; ++q) {
            const int r = (rank + q) % k;
            const unsigned char* o = cl.map_shared_rank(smem, r);
            const int* o32 = reinterpret_cast<const int*>(o);
            const int c = o32[count_at<T>(S) + s];
            if (c == 0) continue;
            cnt += c;
            const T* ot = reinterpret_cast<const T*>(o);
#pragma unroll
            for (int j = 0; j < 5; ++j) sm[j] += ot[j * S + s];
#pragma unroll
            for (int t = 0; t < 8; ++t)
                if (t < nv) votes[t] += o32[votes_at<T>(S) + t * S + s];
            const int* oe = o32 + ext_at<T>(S, nv);
            ext[0] = min(ext[0], oe[s]);
            ext[1] = min(ext[1], oe[S + s]);
            ext[2] = max(ext[2], oe[2 * S + s]);
            ext[3] = max(ext[3], oe[3 * S + s]);
        }
        float row[16];
        row[0] = static_cast<float>(cnt);
        row[1] = static_cast<float>(signed_of(sm[kSumX]));
        row[2] = static_cast<float>(signed_of(sm[kSumY]));
#pragma unroll
        for (int j = 0; j < 3; ++j)
            row[3 + j] = static_cast<float>(static_cast<double>(signed_of(sm[2 + j])) * 0.25);
#pragma unroll
        for (int t = 0; t < 10; ++t) row[kFixed + t] = t < nv ? static_cast<float>(votes[t < 8 ? t : 0]) : 0.0f;
        float4* so = reinterpret_cast<float4*>(p.sums + (static_cast<long long>(img) * S + s) * p.c_sum);
        so[0] = make_float4(row[0], row[1], row[2], row[3]);
        so[1] = make_float4(row[4], row[5], row[6], row[7]);
        if (p.c_sum == 16) {
            so[2] = make_float4(row[8], row[9], row[10], row[11]);
            so[3] = make_float4(row[12], row[13], row[14], row[15]);
        }
        float* mo = p.mins + static_cast<long long>(img) * 4 * S + s;
        const bool live = cnt > 0;
        mo[0] = live ? static_cast<float>(ext[0]) : kBig;
        mo[S] = live ? static_cast<float>(ext[1]) : kBig;
        mo[2 * S] = live ? static_cast<float>(-ext[2]) : kBig;
        mo[3 * S] = live ? static_cast<float>(-ext[3]) : kBig;
    }
    if (k > 1) cl.sync();  // no block leaves while a peer may still read its table
}

bool valid_cluster(int k) { return k == 1 || k == 2 || k == 4 || k == 8; }

template <typename T>
cudaError_t launch(const Params& p, int b, int k, int smem, cudaStream_t st) {
    cudaError_t e = pgm_set_smem(instance_stats_kernel<T>, static_cast<size_t>(smem));
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(static_cast<unsigned>(b * k));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, instance_stats_kernel<T>, p);
    return e != cudaSuccess ? e : cudaGetLastError();
}

// ------------------------------------------------------------ table route
//
// Every shape the cluster kernel does not take (a table past a block's
// shared memory, num_types outside 2..9): the slot
// table in device memory, [B][5][S] int64 sums (sum x, sum y, the three
// moments) and [B][1 + nv + 4][S] int32 (the count, the votes of types
// 1..nv, xmin, ymin, xmax, ymax), filled by global atomics. A thread takes
// a chunk of 16 pixels of a row (whole chunks by 16-byte loads where rows
// are 16-byte aligned), walks its runs of one id (slot 0 like any other)
// and adds each run's closed-form sums once (a run that crosses chunks is
// added in pieces: the sums are exact integers, so the pieces add up to
// the same), its votes once per stretch of one type. Slot 0, which holds
// most pixels, is summed in registers and added once per warp at the end
// (its votes go by atomics, as any slot's). A block takes chunks of one
// image; a last kernel turns each slot into f32 once, as the cluster
// kernel does, so the outputs equal instance_stats_plain bit for bit.

constexpr int kTabThreads = 256;
constexpr int kChunk = 16;  // pixels a thread

struct TabParams {
    const int* lbl;
    const int* tp;
    float* sums;
    float* mins;
    long long* tsum;  // [B][5][S]
    int* t32;         // [B][1 + nv + 4][S]
    int b, h, w, S, nv, c_sum;
    int cpr;  // chunks a row
    int vec;  // rows 16-byte aligned: whole chunks by vector loads
    int bpi;  // blocks an image
};

__global__ void __launch_bounds__(kTabThreads) table_init_kernel(const TabParams p) {
    const long long n64 = 5LL * p.b * p.S, rows32 = 1LL + p.nv + 4;
    const long long n32 = rows32 * p.b * p.S;
    const long long stride = static_cast<long long>(gridDim.x) * kTabThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kTabThreads + threadIdx.x; i < n64;
         i += stride)
        p.tsum[i] = 0;
    for (long long i = static_cast<long long>(blockIdx.x) * kTabThreads + threadIdx.x; i < n32;
         i += stride) {
        const long long row = (i / p.S) % rows32;  // 0 count, 1..nv votes, then the extrema
        p.t32[i] = row <= p.nv ? 0 : (row < p.nv + 3 ? INT_MAX : INT_MIN);
    }
}

// The closed-form sums of a run of slot id >= 1, pixels x0..x1 of row y,
// into the table (64-bit throughout; a run lies within one chunk, so its
// terms stay far below the 2^63 that moments_fit bounds the sums by).
__device__ __forceinline__ void table_run(const TabParams& p, long long* ts, int* t32, int id,
                                          int x0, int x1, int y) {
    const long long S = p.S, n = x1 - x0 + 1, a = 2LL * x0 - p.w, dy = 2LL * y - p.h;
    const long long sx = static_cast<long long>(x0) + x1;
    u64* s = reinterpret_cast<u64*>(ts) + id;
    atomicAdd(t32 + id, static_cast<int>(n));
    atomicAdd(s, static_cast<u64>(n * sx / 2));
    atomicAdd(s + S, static_cast<u64>(n * y));
    atomicAdd(s + 2 * S, static_cast<u64>(n * a * a + 2 * a * n * (n - 1) +
                                          2 * ((n - 1) * n * (2 * n - 1) / 3)));
    atomicAdd(s + 3 * S, static_cast<u64>(n * dy * dy));
    atomicAdd(s + 4 * S, static_cast<u64>(dy * n * (sx - p.w)));
    int* e = t32 + (1 + p.nv) * S;
    atomicMin(e + id, x0);
    atomicMin(e + S + id, y);
    atomicMax(e + 2 * S + id, x1);
    atomicMax(e + 3 * S + id, y);
}

// Slot 0's sums of a thread, added once per warp at the end.
struct Slot0Table {
    long long cnt, sx, sy, mxx, myy, mxy;
    int xmn, ymn, xmx, ymx;
};

__global__ void __launch_bounds__(kTabThreads) table_stats_kernel(const TabParams p) {
    const int img = blockIdx.x / p.bpi, part = blockIdx.x - img * p.bpi;
    const long long S = p.S;
    long long* ts = p.tsum + img * 5 * S;
    int* t32 = p.t32 + img * (5 + p.nv) * S;
    const long long img_px = static_cast<long long>(img) * p.h * p.w;
    const long long chunks = static_cast<long long>(p.h) * p.cpr;
    Slot0Table z{0, 0, 0, 0, 0, 0, INT_MAX, INT_MAX, INT_MIN, INT_MIN};

    for (long long c = static_cast<long long>(part) * kTabThreads + threadIdx.x; c < chunks;
         c += static_cast<long long>(p.bpi) * kTabThreads) {
        const int y = static_cast<int>(c / p.cpr);
        const int xs = static_cast<int>(c - static_cast<long long>(y) * p.cpr) * kChunk;
        const int nval = min(kChunk, p.w - xs);
        const long long px = img_px + static_cast<long long>(y) * p.w + xs;
        int id[kChunk], ty[kChunk];
        if (p.vec && nval == kChunk) {
#pragma unroll
            for (int q = 0; q < kChunk / 4; ++q) {
                const int4 l = __ldg(reinterpret_cast<const int4*>(p.lbl + px) + q);
                const int4 t = __ldg(reinterpret_cast<const int4*>(p.tp + px) + q);
                id[4 * q] = l.x; id[4 * q + 1] = l.y; id[4 * q + 2] = l.z; id[4 * q + 3] = l.w;
                ty[4 * q] = t.x; ty[4 * q + 1] = t.y; ty[4 * q + 2] = t.z; ty[4 * q + 3] = t.w;
            }
        } else {
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
                id[i] = i < nval ? __ldg(p.lbl + px + i) : -1;
                ty[i] = i < nval ? __ldg(p.tp + px + i) : 0;
            }
        }
        // the run [x0, xs + i) of slot cur (-1: ignored ids), its current
        // stretch of type tcur, tn pixels long
        int cur = -1, x0 = xs, tcur = 0, tn = 0;
        auto close_votes = [&]() {
            if (cur >= 0 && tcur >= 1 && tcur <= p.nv)
                atomicAdd(t32 + tcur * S + cur, tn);
        };
        auto close_run = [&](int x1) {
            if (cur == 0) {
                const long long n = x1 - x0 + 1, a = 2LL * x0 - p.w, dy = 2LL * y - p.h;
                const long long sx = static_cast<long long>(x0) + x1;
                z.cnt += n;
                z.sx += n * sx / 2;
                z.sy += n * y;
                z.mxx += n * a * a + 2 * a * n * (n - 1) + 2 * ((n - 1) * n * (2 * n - 1) / 3);
                z.myy += n * dy * dy;
                z.mxy += dy * n * (sx - p.w);
                z.xmn = min(z.xmn, x0);
                z.ymn = min(z.ymn, y);
                z.xmx = max(z.xmx, x1);
                z.ymx = max(z.ymx, y);
            } else if (cur > 0) {
                table_run(p, ts, t32, cur, x0, x1, y);
            }
        };
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
            if (i >= nval) break;
            const int v = (id[i] >= 0 && id[i] < p.S) ? id[i] : -1;
            if (i == 0 || v != cur) {
                if (i > 0) {
                    close_votes();
                    close_run(xs + i - 1);
                }
                cur = v;
                x0 = xs + i;
                tcur = ty[i];
                tn = 0;
            } else if (ty[i] != tcur) {
                close_votes();
                tcur = ty[i];
                tn = 0;
            }
            ++tn;
        }
        close_votes();
        close_run(xs + nval - 1);
    }

    const long long cnt = warp_sum(z.cnt);
    const long long sx = warp_sum(z.sx), sy = warp_sum(z.sy);
    const long long mxx = warp_sum(z.mxx), myy = warp_sum(z.myy), mxy = warp_sum(z.mxy);
    const int xmn = __reduce_min_sync(kFull, z.xmn), ymn = __reduce_min_sync(kFull, z.ymn);
    const int xmx = __reduce_max_sync(kFull, z.xmx), ymx = __reduce_max_sync(kFull, z.ymx);
    if ((threadIdx.x & 31) == 0 && cnt > 0) {
        u64* s = reinterpret_cast<u64*>(ts);
        atomicAdd(t32, static_cast<int>(cnt));
        atomicAdd(s, static_cast<u64>(sx));
        atomicAdd(s + S, static_cast<u64>(sy));
        atomicAdd(s + 2 * S, static_cast<u64>(mxx));
        atomicAdd(s + 3 * S, static_cast<u64>(myy));
        atomicAdd(s + 4 * S, static_cast<u64>(mxy));
        int* e = t32 + (1 + p.nv) * S;
        atomicMin(e, xmn);
        atomicMin(e + S, ymn);
        atomicMax(e + 2 * S, xmx);
        atomicMax(e + 3 * S, ymx);
    }
}

// Each slot of the table as f32, once: the outputs' layout as the cluster
// kernel writes them.
__global__ void __launch_bounds__(kTabThreads) table_finish_kernel(const TabParams p) {
    const long long S = p.S, total = static_cast<long long>(p.b) * S;
    for (long long i = static_cast<long long>(blockIdx.x) * kTabThreads + threadIdx.x; i < total;
         i += static_cast<long long>(gridDim.x) * kTabThreads) {
        const long long img = i / S, s = i - img * S;
        const long long* ts = p.tsum + img * 5 * S + s;
        const int* t32 = p.t32 + img * (5 + p.nv) * S + s;
        const int cnt = t32[0];
        float* so = p.sums + i * p.c_sum;
        so[0] = static_cast<float>(cnt);
        so[1] = static_cast<float>(ts[0]);
        so[2] = static_cast<float>(ts[S]);
        for (int j = 0; j < 3; ++j)
            so[3 + j] = static_cast<float>(static_cast<double>(ts[(2 + j) * S]) * 0.25);
        for (int t = 0; t < p.nv; ++t) so[kFixed + t] = static_cast<float>(t32[(1 + t) * S]);
        for (int c = kFixed + p.nv; c < p.c_sum; ++c) so[c] = 0.0f;
        const int* e = t32 + (1 + p.nv) * S;
        float* mo = p.mins + img * 4 * S + s;
        const bool live = cnt > 0;
        mo[0] = live ? static_cast<float>(e[0]) : kBig;
        mo[S] = live ? static_cast<float>(e[S]) : kBig;
        mo[2 * S] = live ? static_cast<float>(-e[2 * S]) : kBig;
        mo[3 * S] = live ? static_cast<float>(-e[3 * S]) : kBig;
    }
}

// sum_{x < n} (2x - n)^2, the sum of (2x - w)^2 over a whole row of a tile:
// 4 sum x^2 - 4 n sum x + n^3
long long row_moment(long long n) {
    return 4 * ((n - 1) * n * (2 * n - 1) / 6) - 2 * n * n * (n - 1) + n * n * n;
}

// Whether every sum of a slot of an h x w tile stays under 2^31, so that
// the table's sums can be 32-bit (the tile's sums of x, y, (2x - w)^2 and
// (2y - h)^2 bound a slot's; Cauchy-Schwarz bounds its cross moment by
// theirs).
bool narrow(int h, int w) {
    const long long lim = 0x7fffffffLL, hh = h, ww = w;
    if (hh * ww * ww >= lim || ww * hh * hh >= lim) return false;  // sum x, sum y (and w, h < 2^16)
    const long long mx = hh * row_moment(ww), my = ww * row_moment(hh);
    return mx < lim && my < lim;  // and so sqrt(mx my) < 2^31
}

// Whether a slot's 64-bit moment sums stay under 2^63: h (w^3 + 2w) / 3, h
// times a row's sum of (2x - w)^2, bounds a slot's, w (h^3 + 2h) / 3 its
// sum of (2y - h)^2, and Cauchy-Schwarz its cross moment (as
// ops/instance_stats.py::_check_moments).
bool moments_fit(int h, int w) {
    using u128 = unsigned __int128;
    const u128 hh = h, ww = w, lim = static_cast<u128>(1) << 63;
    return hh * (ww * ww * ww + 2 * ww) / 3 < lim && ww * (hh * hh * hh + 2 * hh) / 3 < lim;
}

// Shared memory of one block: its slot table (five sums of 4 or 8 bytes,
// the count, the votes of types 1..num_types-1 and four extrema a slot)
// and, with 32-bit sums, each lane's slot-0 record.
size_t table_bytes(int s_slots, int num_types, int wide) {
    return static_cast<size_t>(s_slots) * (5 * (wide ? 8 : 4) + 4 * (1 + (num_types - 1) + 4));
}

size_t smem_bytes(int s_slots, int num_types, int wide) {
    return table_bytes(s_slots, num_types, wide) + (wide ? 0 : kThreads * sizeof(Slot0Smem));
}

}  // namespace

// lbl, tp (b, h, w) int32; sums (b, S, c_sum) f32; mins (b, 4, S) f32.
// k: the cluster (blocks a tile), band: rows a band, vec: whole spans by
// vector loads, wide: 64-bit table sums, smem: the block's shared memory bytes; as
// ops/instance_stats.py::InstanceStatsTiling computes them, and refused if
// they differ from this file's.
PGM_EXPORT int instance_stats_launch(const void* lbl, const void* tp, void* sums, void* mins,
                                     int b, int h, int w, int s_slots, int num_types, int c_sum,
                                     int k, int band, int vec, int wide, int smem, void* stream) {
    const int nv = num_types - 1;
    if (b <= 0 || h <= 0 || w <= 0 || s_slots <= 0 || num_types < 2 || num_types > 9 ||
        c_sum != ((kFixed + nv + 7) / 8) * 8 || !valid_cluster(k) || band != kBand ||
        vec != (w % 4 == 0) || static_cast<long long>(h) * w >= (1LL << 31) ||
        max(h, w) >= (1 << 27) || !moments_fit(h, w) || static_cast<long long>(b) * k > 0x7fffffffLL ||
        wide != !narrow(h, w) || static_cast<size_t>(smem) != smem_bytes(s_slots, num_types, wide))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.lbl = static_cast<const int*>(lbl);
    p.tp = static_cast<const int*>(tp);
    p.sums = static_cast<float*>(sums);
    p.mins = static_cast<float*>(mins);
    p.h = h;
    p.w = w;
    p.S = s_slots;
    p.nv = nv;
    p.c_sum = c_sum;
    p.spr = (w + kSpan - 1) / kSpan;
    p.vec = vec;
    p.slot0_at = static_cast<int>(table_bytes(s_slots, num_types, wide));
    // a lane's slot-0 count and sums of x and y grow by at most 8 max(w, h)
    // a span, its 32-bit moments by 8 max(w, h)^2 (its votes by 8 a type,
    // in 16-bit fields)
    const long long m = max(w, h);
    p.drain = static_cast<int>(min(8191LL, 0x7fffffffLL / (8 * m * (wide ? 1 : m))));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(wide ? launch<u64>(p, b, k, smem, st) : launch<unsigned>(p, b, k, smem, st));
}

// The table route (ops/instance_stats.py::InstanceStatsTiling.route ==
// "table"): lbl, tp, sums, mins as instance_stats_launch's; table: a device
// scratch of b S (5 x 8 + (4 + num_types) x 4) bytes, 8-byte aligned (its
// layout above); vec: whole chunks by vector loads; bpi: blocks an image of
// the statistics pass; grid: blocks of the table's first and last pass. As
// InstanceStatsTiling computes them, and refused if they differ from this
// file's.
PGM_EXPORT int instance_stats_table_launch(const void* lbl, const void* tp, void* sums, void* mins,
                                           void* table, int b, int h, int w, int s_slots,
                                           int num_types, int c_sum, int vec, int bpi, int grid,
                                           void* stream) {
    const int nv = num_types - 1;
    if (b <= 0 || h <= 0 || w <= 0 || s_slots <= 0 || num_types < 1 || table == nullptr ||
        c_sum != ((kFixed + nv + 7) / 8) * 8 || vec != (w % 4 == 0) ||
        static_cast<long long>(h) * w >= (1LL << 31) || !moments_fit(h, w) || bpi <= 0 ||
        static_cast<long long>(b) * bpi > 0x7fffffffLL || grid <= 0 ||
        reinterpret_cast<uintptr_t>(table) % 8)
        return static_cast<int>(cudaErrorInvalidValue);
    TabParams p;
    p.lbl = static_cast<const int*>(lbl);
    p.tp = static_cast<const int*>(tp);
    p.sums = static_cast<float*>(sums);
    p.mins = static_cast<float*>(mins);
    p.tsum = static_cast<long long*>(table);
    p.t32 = reinterpret_cast<int*>(p.tsum + 5LL * b * s_slots);
    p.b = b;
    p.h = h;
    p.w = w;
    p.S = s_slots;
    p.nv = nv;
    p.c_sum = c_sum;
    p.cpr = (w + kChunk - 1) / kChunk;
    p.vec = vec;
    p.bpi = bpi;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    table_init_kernel<<<grid, kTabThreads, 0, st>>>(p);
    table_stats_kernel<<<b * bpi, kTabThreads, 0, st>>>(p);
    table_finish_kernel<<<grid, kTabThreads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
}
