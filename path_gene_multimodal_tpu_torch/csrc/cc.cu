// Connected-component labelling for the H100: one seeded per-tile fixpoint
// core, each tile's rows split into bands over a thread-block cluster,
// launched over a batch of tiles (K6) or over the tiles of one large mask,
// round after round (K5).
//
// Replaces two TPU kernels of path_gene_multimodal_tpu/ops/pallas/cc.py:
//   K6  pallas_label_components        (:112, pallas_call :122): per tile,
//       seeds = pixel linear index, at most 1 + max_iters relaxations;
//   K5  pallas_label_components_tiled  (:146, pallas_call :180): one mask
//       cut into tile x tile blocks (the last ones reaching past the mask
//       read as background), seeds = linear indices of the mask; rounds of
//       the fixpoint in every tile, each round after the first seeded by a
//       one-pixel border-min of the previous round's labels (:190-201),
//       until a round changes nothing or max_outer rounds after the first
//       have run.
//
// Contract (identical outputs to the Pallas kernels and to the plain
// versions in ops/cc.py): a relaxation is, as a pure function of the state
// before it, the minimum over each horizontal run of foreground, then over
// each vertical run, then (connectivity 2) the diagonal relaxes (1,1),
// (1,-1), (-1,1), (-1,-1), each reading the state the previous one left;
// neighbours outside the tile read as background. Background is
// INF = 2^30. A tile stops after the first relaxation that changes nothing
// or after 1 + max_iters relaxations, whichever comes first. No union-find:
// the passes, and with them the caps, are the TPU's.
//
// What bounds it: the relaxations. The bytes per call are the mask in and
// the int32 labels out (and, per round after the first, the labels of the
// round before); each relaxation is a few integer minima per pixel of the
// tile, so the work is relaxations x pixels, and every relaxation is a
// chain of dependent passes over the tile. On the H100 this core is bound
// by the instructions of those passes on the CUDA cores (~75 a pixel in a
// full relaxation: the scans, the run bookkeeping, the dirty flags), ~19 us
// for a full relaxation of a 128 x 256 band (phase timers read on an H100,
// PERF.md).
//
// Design (geometry: ops/cc.py::CcTiling; the launcher refuses any other).
// A tile's rows are cut into N bands (N in 1, 2, 4, 8, 16: the smallest
// whose band fits a block's shared memory, doubled while the grid still
// fits the card in one wave and a band keeps 32 rows), one block of 1024
// threads per band, the N blocks of a tile one thread-block cluster. A
// band's int32 labels, its mask bits, its dirty rows and columns and its
// column segments' records live in shared memory, and beside them what the
// other blocks read (the band's records and edge rows, through distributed
// shared memory); where no N fits (tile 1024 and larger, or rows of some
// 10,000 pixels) both live in a global scratch (one region per block, the
// other blocks read it past L1; the same code, compiled for each place, so
// that accesses to shared memory are shared-memory instructions) and N is
// the largest that the tile's height allows, up to 16. No tile width is
// refused.
// - Row runs (rows never cross a band): a warp per row, 8 consecutive
//   pixels a lane. A row of at most 256 pixels in one pass: each lane's
//   run minima, then a forward and a backward shuffle segmented scan carry
//   runs across lanes. Longer rows in chunks of 256: a forward pass stores
//   the prefix minima from each run's start (a carry across chunks), a
//   backward pass gives each pixel the prefix at its run's end, which is
//   the run's minimum. Value and "passes through" flag travel in one
//   shuffle. Rows that nothing changed since the last row runs are skipped
//   (dirty flags): that saves work and changes no pass.
// - Column runs: every thread a segment of seg_len (<= 64) rows of one
//   column of its band (its mask bits one 64-bit word), walked forward
//   (running minima in place; the segment's head and tail run minima and
//   its first background row recorded) and backward (each run's minimum).
//   Between the walks each block publishes, per column, its band's head and
//   tail run minima and whether the band's column is all foreground; after
//   a cluster barrier the backward walk chains the records of the segments
//   above and below in its band and, past the band's edge, those of the
//   other bands (through distributed shared memory), so a run crosses
//   segments and bands in both directions within the pass. A column of the
//   band that nothing lowered since its last column runs is skipped but for
//   its end runs (dirty flags; see column_runs).
// - Diagonal steps (connectivity 2): a thread per column walks the band's
//   rows away from the row it reads (bottom-up for dy = 1), so that row is
//   still the state before the step; the neighbouring column's value comes
//   from the neighbouring lane by a shuffle, at a warp's edge from a copy of
//   that column taken before the step, and beyond the band from the
//   neighbouring band's edge row, copied before the step (two copies that
//   alternate) and read from the other block.
// - Change detection without a copy: every step takes a minimum that
//   includes the pixel's own value, so labels only fall, and a relaxation
//   changed the tile exactly when some step lowered some pixel; that is
//   OR-ed over the cluster once per relaxation.
// - K5's rounds: the border-min is fused into the seeds. A block's seed at
//   a foreground pixel is the minimum of the previous round's labels over
//   the pixel and its 4 or 8 neighbours, read from the global labels of the
//   round before (so across tile borders too); the round changed the mask
//   exactly when some seed fell below the previous label or the tile's
//   first relaxation changed something. Round k writes labels[k % 2] and
//   sets flags[k % 3]; block 0 clears flags[(k + 1) % 3] (three words, so
//   that no block clears a word that another may still read). Two drivers
//   of the same kernel: a launch per round, whose flag the host reads, or,
//   when every tile's cluster can be resident at once, one cooperative
//   launch (the runtime places every block at once or refuses it) running
//   all rounds with a grid-wide barrier between them (a barrier still open
//   after 2 s traps instead of hanging the card).
//
// counts (int64[2], optional): += relaxations of every tile (summed over
// tiles and rounds), += 1 per round.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPass = 0x80000000u;  // "the run passes through" in bit 31
constexpr int kChunk = 256;              // pixels of a row a warp takes at once (8 a lane)
constexpr int kBatch = 4;                // words of 32 mask pixels a warp loads at once
constexpr int kMaxSeg = 64;              // rows of a column segment (its mask bits: one word)

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) & ~size_t(15); }

// The band geometry of a th x tw tile on clusters of n blocks (the numbers
// of ops/cc.py::CcTiling): the byte offsets of the band's region (in shared
// memory or in a global scratch) and of the region that always lives in
// shared memory (read by the other blocks of the cluster).
struct Geo {
    int n, bh, ls, wpr, seg_len, segs, seg_items;
    // band region: labels [bh][ls], mask bits [bh][wpr], dirty rows [bh],
    // dirty columns [2][ls] (by relaxation parity), segment records (head,
    // tail, first background row) [3][seg_items], segment mask bits (bit i
    // = row i of the segment) [seg_items] of 64 bits, column copies
    // [bh][wpr]
    int o_mask, o_dirty, o_cdirty, o_seg, o_sbits, o_col, band_bytes;
    // peer region, right after the band region and where it lives (the
    // part the other blocks of the cluster read): band records (head,
    // tail, full) [3][tw], edge rows [2][ls]
    int o_rows, peer_bytes;
};

constexpr int kFlagBytes = 16;  // the changed flag, always in shared memory

__host__ __device__ inline Geo geometry(int th, int tw, int n) {
    Geo g;
    g.n = n;
    g.bh = (th + n - 1) / n;
    g.ls = (tw + 7) / 8 * 8;
    g.wpr = (tw + 31) / 32;
    const int cols = tw < kThreads ? kThreads / tw : 1;
    g.seg_len = (g.bh + cols - 1) / cols;
    if (g.seg_len > kMaxSeg) g.seg_len = kMaxSeg;
    g.segs = (g.bh + g.seg_len - 1) / g.seg_len;
    g.seg_items = g.segs * tw;
    size_t o = r16(static_cast<size_t>(g.bh) * g.ls * 4);
    g.o_mask = static_cast<int>(o);
    o += r16(static_cast<size_t>(g.bh) * g.wpr * 4);
    g.o_dirty = static_cast<int>(o);
    o += r16(static_cast<size_t>(g.bh));
    g.o_cdirty = static_cast<int>(o);
    o += r16(2 * static_cast<size_t>(g.ls));
    g.o_seg = static_cast<int>(o);
    o += r16(3 * static_cast<size_t>(g.seg_items) * 4);
    g.o_sbits = static_cast<int>(o);
    o += r16(static_cast<size_t>(g.seg_items) * 8);
    g.o_col = static_cast<int>(o);
    o += r16(static_cast<size_t>(g.bh) * g.wpr * 4);
    g.band_bytes = static_cast<int>(o);
    size_t s = r16(3 * static_cast<size_t>(tw) * 4);
    g.o_rows = static_cast<int>(s);
    s += r16(2 * static_cast<size_t>(g.ls) * 4);
    g.peer_bytes = static_cast<int>(s);
    return g;
}

struct Params {
    const uint8_t* mask;   // (b, h, w)
    int* lbl0;             // (b, h, w): round k writes lbl0 (k even) or lbl1
    int* lbl1;
    unsigned char* scratch;  // global band regions (null: in shared memory)
    int* flags;            // [4]: round flags [3], the cluster size seen; or null
    unsigned* bar;         // grid barrier counter (device rounds)
    long long* counts;     // [2] or null
    int h, w, th, tw;
    int conn, max_iters, max_outer;
    int round;             // the round a launch of the host driver runs
    int device_rounds;     // 1: all rounds in this launch
    Geo g;
};

__device__ __forceinline__ void load8(const int* p, int (&v)[8]) {
    const int4 a = *reinterpret_cast<const int4*>(p);
    const int4 b = *reinterpret_cast<const int4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(int* p, const int (&v)[8]) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(p + 4) = make_int4(v[4], v[5], v[6], v[7]);
}

// the column flags of a lane's 8 pixels (8-byte aligned)
__device__ __forceinline__ void mark8(uint8_t* cd) {
    *reinterpret_cast<uint2*>(cd) = make_uint2(0x01010101u, 0x01010101u);
}

// One block's view of its band.
struct Band {
    int* lbl;        // [bh][ls]
    uint32_t* mbits; // [bh][wpr]
    uint8_t* dirty;  // [bh]
    uint8_t* cdirty; // [2][ls]
    int* seg_head;   // [seg_items] each
    int* seg_tail;
    int* seg_fbg;
    uint64_t* sbits; // [seg_items]
    int* colc;       // [bh][wpr]
    int* rec;        // head [tw], tail [tw], full [tw] (read by the cluster)
    int* rows;       // [2][ls] edge rows (read by the cluster)
    int* flag;       // changed (read by the cluster)
    int rank, n, rows_n, tw, ls, wpr, seg_len, segs;
    int stride;      // ints from one block's global regions to the next's
};

// The peer region of block q of the cluster at `own`'s place in this
// block's: through distributed shared memory, or (regions in the global
// scratch, consecutive by rank) in global memory, read past L1 (pv) since
// the cluster barrier orders the writes at L2.
template <bool kShared>
__device__ __forceinline__ int* peer(const Band& B, cg::cluster_group& cl, int* own, int q) {
    if constexpr (kShared) return cl.map_shared_rank(own, q);
    else return own + static_cast<ptrdiff_t>(q - B.rank) * B.stride;
}

template <bool kShared>
__device__ __forceinline__ int pv(const int* p) {
    if constexpr (kShared) return *p;
    else return __ldcg(p);
}

__device__ __forceinline__ bool fg_at(const Band& B, int r, int c) {
    return (B.mbits[r * B.wpr + (c >> 5)] >> (c & 31)) & 1u;
}

// Row runs over the band's rows that changed since the last row runs (all
// of them in a propagate's first relaxation). Returns whether a pixel fell.
// Marks in cd ([ls]) the columns of every lane's 8 pixels where it lowers one.
__device__ __forceinline__ bool row_runs(const Band& B, bool first, uint8_t* cd) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nchunk = (B.ls + kChunk - 1) / kChunk;
    bool ch = false;
    for (int r = warp; r < B.rows_n; r += kWarps) {
        int d = 0;
        if (lane == 0) {
            d = first || B.dirty[r];
            B.dirty[r] = 0;
        }
        if (!__shfl_sync(kFull, d, 0)) continue;
        int* row = B.lbl + static_cast<size_t>(r) * B.ls;
        const uint32_t* mrow = B.mbits + r * B.wpr;
        if (nchunk == 1) {  // the whole row at once: run minima in the lane, both scans
            const int x0 = 8 * lane;
            int v[8];
            uint32_t mb = 0;
            if (x0 < B.ls) {
                load8(row + x0, v);
                mb = (mrow[x0 >> 5] >> (x0 & 31)) & 0xFFu;
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = kInf;
            }
            bool fell = false;  // a pixel of the lane lowered
            int acc = kInf;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                acc = (mb >> i) & 1u ? min(acc, v[i]) : kInf;
                fell |= acc != v[i];
                v[i] = acc;
            }
#pragma unroll
            for (int i = 6; i >= 0; --i) {
                if ((mb >> i) & (mb >> (i + 1)) & 1u) {
                    fell |= v[i + 1] != v[i];
                    v[i] = v[i + 1];
                }
            }
            const bool full = mb == 0xFFu;
            uint32_t tl = static_cast<uint32_t>(v[7]) | (full ? kPass : 0u);
            uint32_t hr = static_cast<uint32_t>(v[0]) | (full ? kPass : 0u);
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const uint32_t o = __shfl_up_sync(kFull, tl, s);
                const uint32_t q = __shfl_down_sync(kFull, hr, s);
                if (lane >= s && (tl & kPass)) tl = min(o & ~kPass, tl & ~kPass) | (o & kPass);
                if (lane + s < 32 && (hr & kPass)) hr = min(q & ~kPass, hr & ~kPass) | (q & kPass);
            }
            int from_left = static_cast<int>(__shfl_up_sync(kFull, tl, 1) & ~kPass);
            int from_right = static_cast<int>(__shfl_down_sync(kFull, hr, 1) & ~kPass);
            if (lane == 0) from_left = kInf;
            if (lane == 31) from_right = kInf;
            const int first_bg = full ? 8 : __ffs(~mb & 0xFFu) - 1;
            const int last_bg = full ? -1 : 31 - __clz(~mb & 0xFFu);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                int nv = v[i];
                if (i < first_bg) nv = min(nv, from_left);
                if (i > last_bg) nv = min(nv, from_right);
                fell |= nv != v[i];
                v[i] = nv;
            }
            if (fell) {
                store8(row + x0, v);
                ch = true;
                mark8(cd + x0);
            }
            continue;
        }
        // forward: prefix minima from each run's start
        int carry = kInf;
#pragma unroll 1
        for (int c = 0; c < nchunk; ++c) {
            const int x0 = c * kChunk + 8 * lane;
            int v[8];
            uint32_t mb = 0;
            if (x0 < B.ls) {
                load8(row + x0, v);
                mb = (mrow[x0 >> 5] >> (x0 & 31)) & 0xFFu;
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = kInf;
            }
            // f (in v): prefix minima within the lane's pixels
            bool fell = false;
            int acc = kInf;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                acc = (mb >> i) & 1u ? min(acc, v[i]) : kInf;
                fell |= acc != v[i];
                v[i] = acc;
            }
            const bool full = mb == 0xFFu;
            uint32_t tl = static_cast<uint32_t>(v[7]) | (full ? kPass : 0u);
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const uint32_t o = __shfl_up_sync(kFull, tl, s);
                if (lane >= s && (tl & kPass)) tl = min(o & ~kPass, tl & ~kPass) | (o & kPass);
            }
            const uint32_t o = __shfl_up_sync(kFull, tl, 1);
            int from_left = static_cast<int>(o & ~kPass);
            if (lane == 0 || (o & kPass)) from_left = lane == 0 ? carry : min(from_left, carry);
            const int first_bg = full ? 8 : __ffs(~mb & 0xFFu) - 1;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (i < first_bg && from_left < v[i]) {
                    v[i] = from_left;
                    fell = true;
                }
            }
            carry = __shfl_sync(kFull, (mb >> 7) & 1u ? v[7] : kInf, 31);
            if (fell) {
                store8(row + x0, v);
                ch = true;
                mark8(cd + x0);
            }
        }
        // backward: each pixel takes the prefix at its run's end
        carry = kInf;
#pragma unroll 1
        for (int c = nchunk - 1; c >= 0; --c) {
            const int x0 = c * kChunk + 8 * lane;
            int p[8];
            uint32_t mb = 0;
            if (x0 < B.ls) {
                load8(row + x0, p);
                mb = (mrow[x0 >> 5] >> (x0 & 31)) & 0xFFu;
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) p[i] = kInf;
            }
            // each pixel of the lane the prefix at the end of its run in the lane
            bool fell = false;
#pragma unroll
            for (int i = 6; i >= 0; --i) {
                if ((mb >> i) & (mb >> (i + 1)) & 1u) {
                    fell |= p[i + 1] != p[i];
                    p[i] = p[i + 1];
                }
            }
            const bool full = mb == 0xFFu;
            uint32_t hr = static_cast<uint32_t>(p[0]) | (full ? kPass : 0u);
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const uint32_t q = __shfl_down_sync(kFull, hr, s);
                if (lane + s < 32 && (hr & kPass)) hr = min(q & ~kPass, hr & ~kPass) | (q & kPass);
            }
            const uint32_t q = __shfl_down_sync(kFull, hr, 1);
            int from_right = static_cast<int>(q & ~kPass);
            if (lane == 31 || (q & kPass)) from_right = lane == 31 ? carry : min(from_right, carry);
            const int last_bg = full ? -1 : 31 - __clz(~mb & 0xFFu);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (i > last_bg && from_right < p[i]) {
                    p[i] = from_right;
                    fell = true;
                }
            }
            carry = __shfl_sync(kFull, mb & 1u ? p[0] : kInf, 0);
            if (fell) {
                store8(row + x0, p);
                ch = true;
                mark8(cd + x0);
            }
        }
    }
    return ch;
}

// Column runs over the band (forward walks, band records, cluster barrier,
// backward walks). A column of the band that nothing lowered since the last
// column runs (cd clear, and not the first relaxation) is uniform over each
// of its runs: its forward walks are skipped (its segment records stay as
// they were, which changes no run minimum: records only fall, and a value a
// run took from another segment is still in that segment's record), and
// its backward walks lower only the runs that touch a segment's ends.
// Clears nd, the column flags of the next relaxation. Returns whether a
// pixel fell.
template <bool kShared>
__device__ __forceinline__ bool column_runs(const Band& B, cg::cluster_group& cl, bool first,
                                            const uint8_t* cd, uint8_t* nd) {
    bool ch = false;
    const int items = B.segs * B.tw;
    // forward: running minima in place; each segment's head and tail run
    // minima and its first background row
    for (int it = threadIdx.x; it < items; it += kThreads) {
        const int seg = it / B.tw, col = it - seg * B.tw;
        const int ra = seg * B.seg_len, rb = max(ra, min(ra + B.seg_len, B.rows_n));
        if (seg == 0) nd[col] = 0;
        if (!first && !cd[col]) continue;
        const uint64_t sb = B.sbits[it];
        const int fbg = ~sb == 0 ? rb : min(rb, ra + __ffsll(static_cast<long long>(~sb)) - 1);
        int acc = kInf, head = kInf;
        uint64_t bits = sb;
        int v = ra < rb ? B.lbl[ra * B.ls + col] : kInf;
        for (int r = ra; r < rb; ++r) {  // the next row's load issued before this row's store
            const int vn = r + 1 < rb ? B.lbl[(r + 1) * B.ls + col] : kInf;
            const bool fg = bits & 1u;
            bits >>= 1;
            acc = fg ? min(acc, v) : kInf;
            if (fg && acc != v) {
                B.lbl[r * B.ls + col] = acc;
                B.dirty[r] = 1;
                ch = true;
            }
            if (r < fbg) head = acc;
            v = vn;
        }
        B.seg_head[it] = head;
        B.seg_tail[it] = acc;
        B.seg_fbg[it] = fbg;
    }
    __syncthreads();
    if (B.n > 1) {
        // the band's records: its head run (down from the top), its tail
        // run (up from the bottom), all foreground
        for (int col = threadIdx.x; col < B.tw; col += kThreads) {
            int head = kInf, tail = kInf, full = 1;
            for (int s = 0; s < B.segs; ++s) {
                const int it = s * B.tw + col;
                head = min(head, B.seg_head[it]);
                const int rb = max(s * B.seg_len, min((s + 1) * B.seg_len, B.rows_n));
                if (B.seg_fbg[it] != rb) {
                    full = 0;
                    break;
                }
            }
            for (int s = B.segs - 1; s >= 0; --s) {
                const int it = s * B.tw + col;
                tail = min(tail, B.seg_tail[it]);
                const int rb = max(s * B.seg_len, min((s + 1) * B.seg_len, B.rows_n));
                if (B.seg_fbg[it] != rb) break;
            }
            B.rec[col] = head;
            B.rec[B.tw + col] = tail;
            B.rec[2 * B.tw + col] = full;
        }
        cl.sync();
    }
    // backward: each run's minimum, with the runs reaching the segment from
    // the segments and bands above and below
    for (int it = threadIdx.x; it < items; it += kThreads) {
        const int seg = it / B.tw, col = it - seg * B.tw;
        const int ra = seg * B.seg_len, rb = max(ra, min(ra + B.seg_len, B.rows_n));
        if (ra >= rb) continue;
        const int fbg = B.seg_fbg[it];
        int top = kInf, bottom = kInf;
        if (fbg > ra) {  // the head run touches the segment's top
            bool open = true;
            for (int k = seg - 1; k >= 0 && open; --k) {
                const int ik = k * B.tw + col;
                top = min(top, B.seg_tail[ik]);
                open = B.seg_fbg[ik] == min((k + 1) * B.seg_len, B.rows_n);
            }
            for (int q = B.rank - 1; q >= 0 && open; --q) {
                const int* rec = peer<kShared>(B, cl, B.rec, q);
                top = min(top, pv<kShared>(rec + B.tw + col));
                open = pv<kShared>(rec + 2 * B.tw + col) != 0;
            }
        }
        const uint64_t sb = B.sbits[it];
        if ((sb >> (rb - 1 - ra)) & 1u) {  // the tail run touches the segment's bottom
            bool open = true;
            for (int k = seg + 1; k < B.segs && open; ++k) {
                const int ik = k * B.tw + col;
                const int ka = k * B.seg_len, kb = max(ka, min(ka + B.seg_len, B.rows_n));
                bottom = min(bottom, B.seg_head[ik]);
                open = B.seg_fbg[ik] == kb;
            }
            for (int q = B.rank + 1; q < B.n && open; ++q) {
                const int* rec = peer<kShared>(B, cl, B.rec, q);
                bottom = min(bottom, pv<kShared>(rec + col));
                open = pv<kShared>(rec + 2 * B.tw + col) != 0;
            }
        }
        if (!first && !cd[col]) {  // uniform runs: only those at the ends can fall
            const bool tail_open = (sb >> (rb - 1 - ra)) & 1u;
            int* at = B.lbl + col;
            if (fbg > ra) {  // the head run (the whole segment if fbg == rb)
                const int v = at[ra * B.ls];
                const int nv = min(min(v, top), fbg == rb ? bottom : kInf);
                if (nv < v) {
                    for (int r = ra; r < fbg; ++r) {
                        at[r * B.ls] = nv;
                        B.dirty[r] = 1;
                    }
                    ch = true;
                }
            }
            if (tail_open && fbg < rb) {  // the tail run
                const int v = at[(rb - 1) * B.ls];
                if (bottom < v) {
                    for (int r = rb - 1; r >= ra && ((sb >> (r - ra)) & 1u); --r) {
                        at[r * B.ls] = bottom;
                        B.dirty[r] = 1;
                    }
                    ch = true;
                }
            }
            continue;
        }
        int rm = kInf;
        bool below = false;
        uint64_t bits = __brevll(sb) >> (64 - (rb - ra));  // bit 0: row rb - 1
        int v = B.lbl[(rb - 1) * B.ls + col];
        for (int r = rb - 1; r >= ra; --r) {
            const int vn = r > ra ? B.lbl[(r - 1) * B.ls + col] : kInf;
            const bool fg = bits & 1u;
            bits >>= 1;
            if (fg) {
                if (!below) {
                    rm = v;
                    if (r == rb - 1) rm = min(rm, bottom);
                    if (r < fbg) rm = min(rm, top);
                }
                if (rm != v) {
                    B.lbl[r * B.ls + col] = rm;
                    B.dirty[r] = 1;
                    ch = true;
                }
            }
            below = fg;
            v = vn;
        }
    }
    return ch;
}

// One diagonal step b[y][x] = where(fg, min(a[y][x], a[y - dy][x - dx]), INF)
// over the band, a = the state before the step. `par` picks the edge-row
// copy. Marks the columns it lowers in nd. Returns whether a pixel fell.
template <bool kShared>
__device__ __forceinline__ bool diagonal_step(const Band& B, cg::cluster_group& cl, int dy,
                                              int dx, int par, uint8_t* nd) {
    const int lane = threadIdx.x & 31;
    __syncthreads();  // the previous step's writes are in
    // copies: at each warp's edge the neighbouring column it reads, and the
    // edge row the neighbouring band reads
    for (int i = threadIdx.x; i < B.rows_n * B.wpr; i += kThreads) {
        const int r = i / B.wpr, k = i - r * B.wpr;
        const int c = dx == 1 ? 32 * k - 1 : 32 * k + 32;
        B.colc[i] = c >= 0 && c < B.tw ? B.lbl[r * B.ls + c] : kInf;
    }
    const int edge = dy == 1 ? B.rows_n - 1 : 0;
    for (int x = threadIdx.x; x < B.ls; x += kThreads)
        B.rows[par * B.ls + x] = B.rows_n > 0 ? B.lbl[edge * B.ls + x] : kInf;
    if (B.n > 1) {
        cl.sync();
    } else {
        __syncthreads();
    }
    const int nb_rank = B.rank - dy;
    const int* far = nb_rank >= 0 && nb_rank < B.n
                         ? peer<kShared>(B, cl, B.rows, nb_rank) + par * B.ls : nullptr;
    bool ch = false;
    const int span = (B.tw + 31) / 32 * 32;
    for (int col = threadIdx.x; col < span; col += kThreads) {  // warp-uniform bounds
        const bool in = col < B.tw;
        const int grp = col >> 5;
        const int nc = col - dx;  // the column read
        const bool nc_in = nc >= 0 && nc < B.tw;
        const bool edge_lane = dx == 1 ? lane == 0 : lane == 31;
        int y = dy == 1 ? B.rows_n - 1 : 0;
        int cur = in && B.rows_n > 0 ? B.lbl[y * B.ls + col] : kInf;
        for (int t = 0; t < B.rows_n; ++t, y -= dy) {
            const int yr = y - dy;  // the row read
            int nb;
            int nxt = kInf;
            if (yr < 0 || yr >= B.rows_n) {  // uniform: the neighbouring band's edge row
                nb = far != nullptr && nc_in ? pv<kShared>(far + nc) : kInf;
            } else {
                nxt = in ? B.lbl[yr * B.ls + col] : kInf;  // also the next row's own value
                nb = dx == 1 ? __shfl_up_sync(kFull, nxt, 1) : __shfl_down_sync(kFull, nxt, 1);
                if (edge_lane) nb = B.colc[yr * B.wpr + grp];
            }
            if (in && nb < cur && fg_at(B, y, col)) {
                B.lbl[y * B.ls + col] = nb;
                B.dirty[y] = 1;
                nd[col] = 1;
                ch = true;
            }
            cur = nxt;
        }
    }
    return ch;
}

// One relaxation of the tile; returns whether it changed the tile (the
// same in every block of the cluster). par: the relaxation's parity, which
// picks its column flags (marked by its row runs and by the diagonal steps
// of the relaxation before).
template <bool kShared>
__device__ __forceinline__ bool relax(const Band& B, cg::cluster_group& cl, int conn, bool first,
                                      int par) {
    uint8_t* cd = B.cdirty + par * B.ls;
    uint8_t* nd = B.cdirty + (par ^ 1) * B.ls;
    bool ch = row_runs(B, first, cd);
    __syncthreads();
    ch |= column_runs<kShared>(B, cl, first, cd, nd);
    if (conn == 2) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k)  // (1,1), (1,-1), (-1,1), (-1,-1)
            ch |= diagonal_step<kShared>(B, cl, k < 2 ? 1 : -1, k & 1 ? -1 : 1, k & 1, nd);
    }
    int any = __syncthreads_or(ch);
    if (B.n > 1) {
        if (threadIdx.x == 0) *B.flag = any;
        cl.sync();
        any = __syncthreads_or(threadIdx.x < B.n ? *cl.map_shared_rank(B.flag, threadIdx.x) : 0);
    }
    return any != 0;
}

// every block of the grid has arrived `target` times in all (thread 0 of
// each block arrives once a call); traps after 2 s instead of hanging
__device__ void grid_barrier(unsigned* bar, unsigned target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(bar, 1u);
        uint64_t t0;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
        while (true) {
            unsigned v;
            asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
            if (v >= target) break;
            uint64_t t;
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
            if (t - t0 > 2000000000ull) __trap();
            __nanosleep(64);
        }
        __threadfence();
    }
    __syncthreads();
}

// kShared: the band and peer regions in shared memory (so that every
// access to them is a shared-memory one), else in the global scratch (one
// band_bytes + peer_bytes region a block); the changed flag always in
// shared memory.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1) cc_cluster_kernel(const Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cl = cg::this_cluster();
    const Geo& g = p.g;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rank = static_cast<int>(blockIdx.x) % g.n;
    const int tx = static_cast<int>(blockIdx.x) / g.n, ty = blockIdx.y;
    const long long block_id =
        (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    const int region = g.band_bytes + g.peer_bytes;
    unsigned char* band = kShared ? smem : p.scratch + block_id * region;
    unsigned char* sh = band + g.band_bytes;
    Band B;
    B.lbl = reinterpret_cast<int*>(band);
    B.mbits = reinterpret_cast<uint32_t*>(band + g.o_mask);
    B.dirty = band + g.o_dirty;
    B.cdirty = band + g.o_cdirty;
    B.seg_head = reinterpret_cast<int*>(band + g.o_seg);
    B.seg_tail = B.seg_head + g.seg_items;
    B.seg_fbg = B.seg_tail + g.seg_items;
    B.sbits = reinterpret_cast<uint64_t*>(band + g.o_sbits);
    B.colc = reinterpret_cast<int*>(band + g.o_col);
    B.rec = reinterpret_cast<int*>(sh);
    B.rows = reinterpret_cast<int*>(sh + g.o_rows);
    B.flag = reinterpret_cast<int*>(kShared ? smem + region : smem);
    B.rank = rank;
    B.n = g.n;
    B.rows_n = max(0, min(g.bh, p.th - rank * g.bh));
    B.tw = p.tw;
    B.ls = g.ls;
    B.wpr = g.wpr;
    B.seg_len = g.seg_len;
    B.segs = g.segs;
    B.stride = region / 4;
    const int y0 = ty * p.th + rank * g.bh, x0 = tx * p.tw;  // the band's origin in the mask
    const long long img = static_cast<long long>(blockIdx.z) * p.h * p.w;
    const bool block0 = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
    const unsigned n_blocks = gridDim.x * gridDim.y * gridDim.z;
    if (block0 && threadIdx.x == 0 && p.flags != nullptr)
        p.flags[3] = static_cast<int>(cl.num_blocks());  // the cluster size it ran on

    for (int k = p.device_rounds ? 0 : p.round;; ++k) {
        const int* prev = k == 0 ? nullptr : (k & 1 ? p.lbl0 : p.lbl1) + img;
        // seeds and mask bits; whether a seed fell below the last round's
        // label. A warp takes kWords words of 32 pixels at once, every load
        // of them issued before any is used (fewer with the band in global
        // memory, whose 64-bit addresses take more registers).
        constexpr int kWords = kShared ? kBatch : kBatch / 2;
        bool lower = false;
        for (int r = warp; r < B.rows_n; r += kWarps) {
            const int Y = y0 + r;
            for (int j0 = 0; j0 < g.wpr; j0 += kWords) {
                bool fg[kWords];
                int s[kWords], own[kWords];
#pragma unroll
                for (int u = 0; u < kWords; ++u) {
                    const int x = 32 * (j0 + u) + lane, X = x0 + x;
                    const bool in = j0 + u < g.wpr && x < p.tw && Y < p.h && X < p.w;
                    const long long at = static_cast<long long>(Y) * p.w + X;
                    fg[u] = in && p.mask[img + at];
                    own[u] = kInf;
                    s[u] = in ? static_cast<int>(at) : kInf;
                    if (prev != nullptr && in) {  // background labels are INF: read them all
                        own[u] = __ldcg(prev + at);
                        s[u] = own[u];
#pragma unroll
                        for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
                            for (int dx = -1; dx <= 1; ++dx) {
                                if ((dy == 0 && dx == 0) || (p.conn == 1 && dy != 0 && dx != 0))
                                    continue;
                                const int yy = Y + dy, xx = X + dx;
                                const long long nb = at + static_cast<long long>(dy) * p.w + dx;
                                if (yy >= 0 && yy < p.h && xx >= 0 && xx < p.w)
                                    s[u] = min(s[u], __ldcg(prev + nb));
                            }
                        }
                    }
                }
#pragma unroll
                for (int u = 0; u < kWords; ++u) {
                    const uint32_t word = __ballot_sync(kFull, fg[u]);
                    const int j = j0 + u, x = 32 * j + lane;
                    if (j >= g.wpr) break;  // uniform over the warp
                    if (lane == 0) B.mbits[r * g.wpr + j] = word;
                    const int v = fg[u] ? s[u] : kInf;
                    lower |= v < own[u] && fg[u] && prev != nullptr;
                    if (x < g.ls) B.lbl[r * g.ls + x] = v;
                }
            }
        }
        // the round changed the mask where a seed fell or the tile's first
        // relaxation changed something: flags[k % 3] is set as soon as
        // either is known (nothing kept live across the relaxations)
        const bool set_flag = k >= 1 && p.flags != nullptr && threadIdx.x == 0;
        if (__syncthreads_or(lower) && set_flag) p.flags[k % 3] = 1;
        for (int it = threadIdx.x; it < g.seg_items; it += kThreads) {
            const int seg = it / p.tw, col = it - seg * p.tw;
            const int ra = seg * g.seg_len, rb = min(ra + g.seg_len, B.rows_n);
            uint64_t sb = 0;
            for (int r = ra; r < rb; ++r)
                sb |= static_cast<uint64_t>(fg_at(B, r, col)) << (r - ra);
            B.sbits[it] = sb;
        }

        int relaxes = 0;
        while (true) {
            const bool ch = relax<kShared>(B, cl, p.conn, relaxes == 0, relaxes & 1);
            if (relaxes == 0 && ch && set_flag) p.flags[k % 3] = 1;
            ++relaxes;
            if (!ch || relaxes >= 1 + p.max_iters) break;
        }

        // the labels out
        int* dst = (k & 1 ? p.lbl1 : p.lbl0) + img;
        for (int r = warp; r < B.rows_n; r += kWarps) {
            const int Y = y0 + r;
            if (Y >= p.h) break;
            for (int x = lane; x < p.tw && x0 + x < p.w; x += 32)
                dst[static_cast<long long>(Y) * p.w + x0 + x] = B.lbl[r * g.ls + x];
        }
        if (threadIdx.x == 0) {
            if (p.flags != nullptr && block0) p.flags[(k + 1) % 3] = 0;
            if (p.counts != nullptr) {
                if (rank == 0)
                    atomicAdd(reinterpret_cast<unsigned long long*>(p.counts),
                              static_cast<unsigned long long>(relaxes));
                if (block0) atomicAdd(reinterpret_cast<unsigned long long*>(p.counts + 1), 1ull);
            }
        }
        if (!p.device_rounds) break;
        grid_barrier(p.bar, static_cast<unsigned>(k + 1) * n_blocks);
        if (k >= 1 && (!__ldcg(p.flags + k % 3) || k >= p.max_outer)) break;
    }
    if (g.n > 1) cl.sync();  // no block leaves while another may read its shared memory
}

// clusters of n; cooperative: the runtime makes every block of the grid
// resident at once, or refuses the launch (the device-rounds driver's grid
// barrier needs that, also while other work holds multiprocessors)
cudaLaunchConfig_t launch_config(dim3 grid, int n, int smem, cudaStream_t st,
                                 cudaLaunchAttribute (&attr)[2], bool cooperative) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = cooperative ? 2 : 1;
    return cfg;
}

using Kernel = void (*)(Params);

Kernel kernel_of(int shared) { return shared ? cc_cluster_kernel<true> : cc_cluster_kernel<false>; }

// a kernel's attributes on the current device: the largest shared memory
// asked for there so far, and clusters of 16
cudaError_t prepare(int shared, int smem) {
    static int allowed[kPgmMaxDevices][2];  // per device: that smem + 1 (0: none yet)
    const int dev = pgm_device();
    if (dev < 0) return cudaErrorInvalidDevice;
    if (smem < allowed[dev][shared != 0]) return cudaSuccess;
    cudaError_t e = pgm_set_smem(kernel_of(shared), static_cast<size_t>(smem));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel_of(shared),
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) allowed[dev][shared != 0] = smem + 1;
    return e;
}

bool valid_cluster(int n) { return n == 1 || n == 2 || n == 4 || n == 8 || n == 16; }

}  // namespace

// Clusters of n blocks with smem bytes of shared memory each (bands in
// shared memory or not) that the card holds at once (0 on an error): the
// device-rounds driver needs every tile's cluster resident.
PGM_EXPORT size_t cc_max_clusters(int n, int smem, int shared) {
    if (!valid_cluster(n) || prepare(shared, smem) != cudaSuccess) return 0;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = launch_config(dim3(n), n, smem, nullptr, attr, false);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel_of(shared), &cfg) != cudaSuccess) return 0;
    return static_cast<size_t>(clusters);
}

// One launch of the core. mask (b, h, w) uint8; lbl0, lbl1 (b, h, w) int32
// (round k writes lbl0 if k is even, else lbl1, and reads the other);
// scratch: band_bytes + the peer region's bytes per block when the bands
// are not in shared memory;
// flags int32[4] (round flags, then the cluster size the kernel ran on) or
// null; bar uint32 (zeroed) for device rounds; counts
// int64[2] or null. Tiles th x tw (K6: th = h, tw = w, one tile an image).
// round: the round of this launch (host driver); device_rounds: run all
// rounds here. n, bh, ls, seg_len, segs, shared, smem, band_bytes: the
// geometry of ops/cc.py::CcTiling, checked against this file's.
PGM_EXPORT int cc_label_launch(const void* mask, void* lbl0, void* lbl1, void* scratch,
                               void* flags, void* bar, void* counts, int b, int h, int w, int th,
                               int tw, int conn, int max_iters, int max_outer, int round,
                               int device_rounds, int n, int bh, int ls, int seg_len, int segs,
                               int shared, int smem, int band_bytes, void* stream) {
    if (b <= 0 || h <= 0 || w <= 0 || th <= 0 || tw <= 0 || (conn != 1 && conn != 2) ||
        max_iters < 0 || round < 0 || !valid_cluster(n) ||
        static_cast<long long>(h) * w >= kInf)
        return static_cast<int>(cudaErrorInvalidValue);
    const Geo g = geometry(th, tw, n);
    const int want_smem = kFlagBytes + (shared ? g.band_bytes + g.peer_bytes : 0);
    if (bh != g.bh || ls != g.ls || seg_len != g.seg_len || segs != g.segs || smem != want_smem ||
        band_bytes != g.band_bytes || (!shared && scratch == nullptr) ||
        (device_rounds && (flags == nullptr || bar == nullptr)) || (round > 0 && flags == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
    if (tiles_x * n > 0x7fffffffLL || tiles_y > 65535 || b > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = prepare(shared, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    Params p;
    p.mask = static_cast<const uint8_t*>(mask);
    p.lbl0 = static_cast<int*>(lbl0);
    p.lbl1 = static_cast<int*>(lbl1);
    p.scratch = static_cast<unsigned char*>(scratch);
    p.flags = static_cast<int*>(flags);
    p.bar = static_cast<unsigned*>(bar);
    p.counts = static_cast<long long*>(counts);
    p.h = h;
    p.w = w;
    p.th = th;
    p.tw = tw;
    p.conn = conn;
    p.max_iters = max_iters;
    p.max_outer = max_outer;
    p.round = round;
    p.device_rounds = device_rounds;
    p.g = g;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg =
        launch_config(dim3(static_cast<unsigned>(tiles_x * n), static_cast<unsigned>(tiles_y), b),
                      n, smem, static_cast<cudaStream_t>(stream), attr, device_rounds != 0);
    e = cudaLaunchKernelEx(&cfg, kernel_of(shared), p);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
