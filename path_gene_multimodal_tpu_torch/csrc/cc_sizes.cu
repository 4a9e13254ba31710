// Connected components + per-pixel component sizes + dense ids, per tile,
// for the H100.
//
// Replaces the TPU kernel `pallas_cc_sizes`
// (path_gene_multimodal_tpu/ops/pallas/cc_sizes.py:174, pallas_call at
// :197) and, with `gate`, the `big` branch of `pallas_cc_sizes_adaptive`
// (:223).
//
// Contract (identical outputs): 4-connected labels = the minimum linear
// pixel index reached by the TPU kernel's relaxation (INF = 2^30 on
// background); the per-pixel size of its component; dense ids 1..N for the
// components of size >= min_size, ordered by root pixel index; a root of
// rank >= s_slots gets size 0 and dense id 0. `n_roots` counts the roots
// (pixels whose label is their own index) of each tile.
//
// The relaxation is the TPU kernel's own: each pass takes the minimum over
// every horizontal run of foreground, then over every vertical run, and the
// passes repeat until nothing changes, at most 1 + max_iters (= 257) times.
// An exact union-find would differ from that only on components that need
// more than 257 passes (deep spirals), so the pass structure, and with it
// the cap, is kept: the outputs stay identical to the TPU's on every input.
//
// What bounds it: the bytes (1 B of mask in, 3 x 4 B out per pixel); a
// tile needs a few passes of two run-minimum scans each. On the global route
// a tile is one block's, so one SM's: its passes read and write device
// memory (or L2) at one SM's rate, and a batch of fewer tiles than SMs
// leaves SMs idle.
//
// Two routes, chosen by the tile's geometry (ops/cc_sizes.py::
// CcSizesTiling.shared): the shared route below, for tiles of up to 65,536
// pixels with sides up to 1024, and the global route (further down, before
// the launchers) for every other tile the TPU kernel takes (h * w < 2^24).
// On either route, where the slot counts and dense ids do not fit shared
// memory beside the rest, they live in device memory (`tables`, int32, 2
// s_slots words a tile; the kernel's kDevTables instantiations), so any
// s_slots runs; the passes do not change.
//
// Shared route: one block of 1024 threads per tile, the labels as uint16 pixel
// indices in shared memory (a 256 x 256 tile's fit; rows padded to a
// multiple of 8 for 16-byte loads), the mask and the roots as bit planes.
// Row runs: one warp per row, PER consecutive pixels a lane (8 at W <=
// 256), the run minima within a lane's pixels, then a forward and a
// backward warp-shuffle segmented min scan that carries runs across lanes
// (the TPU kernel's Hillis-Steele scans). Column runs: every thread, a
// column segment of seg_len rows each (4 x 64 at 256^2), walked forward
// (running minima in place) and backward (each run's minimum) with no
// branch on the data but predicates; each segment's top and bottom run
// minima go through shared memory between the two walks, and each thread
// combines those of its column's other segments, so a run crosses segments
// in both directions within the pass. A row that the last column runs did
// not change, and a column that these row runs did not change, is at its
// runs' minima and is skipped (dirty flags), which saves work in the later
// passes and changes no pass. Roots are ranked by a block scan over
// per-row counts; each pixel's slot (its root's rank, if under s_slots) is
// resolved once, in place of its label, and serves the counts and both
// outputs. Counts are shared atomics, one per run of equal slots in a
// lane's pixels. With `gate`, the block first reads the n_roots
// of an earlier call at `gate_slots` slots and returns at once unless some
// tile overflowed them: `lax.cond` of the adaptive TPU wrapper without a
// trip to the host. Geometry: ops/cc_sizes.py::CcSizesTiling; each
// launcher refuses any other.
//
// counts (int64[2], optional): += relaxation passes of every tile, max=
// passes of one tile.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 1 << 30;
constexpr uint16_t kNone = 0xFFFF;

struct Layout {
    size_t mask, roots, rowc, dirty, seg, cnt, dn, total;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int h, int w, int ls, int wpr, int s_slots) {
    Layout l;
    l.mask = static_cast<size_t>(h) * ls * 2;  // labels first; rows of 16-byte multiples
    l.roots = l.mask + static_cast<size_t>(h) * wpr * 4;
    l.rowc = l.roots + static_cast<size_t>(h) * wpr * 4;
    l.dirty = l.rowc + static_cast<size_t>(h) * 4;  // rows (2 x h), then columns (2 x w)
    l.seg = l.dirty + round16(2 * static_cast<size_t>(h + w));
    l.cnt = l.seg + 3 * kThreads * 4;
    l.dn = l.cnt + static_cast<size_t>(s_slots) * 4;
    l.total = l.dn + round16(static_cast<size_t>(s_slots) * 2);
    return l;
}

// The PER labels of a lane's chunk of a row (16-byte loads within the row).
template <int PER>
__device__ __forceinline__ void load_chunk(const uint16_t* row, int c0, int ls, int (&v)[PER]) {
#pragma unroll
    for (int g = 0; g < PER / 8; ++g) {
        uint4 x = make_uint4(0, 0, 0, 0);
        if (c0 + 8 * g < ls) x = *reinterpret_cast<const uint4*>(row + c0 + 8 * g);
        const uint32_t p[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            v[8 * g + 2 * i] = p[i] & 0xFFFF;
            v[8 * g + 2 * i + 1] = p[i] >> 16;
        }
    }
}

template <int PER>
__device__ __forceinline__ void store_chunk(uint16_t* row, int c0, int ls, const int (&v)[PER]) {
#pragma unroll
    for (int g = 0; g < PER / 8; ++g) {
        if (c0 + 8 * g >= ls) break;
        uint32_t p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            p[i] = static_cast<uint32_t>(v[8 * g + 2 * i]) |
                   (static_cast<uint32_t>(v[8 * g + 2 * i + 1]) << 16);
        *reinterpret_cast<uint4*>(row + c0 + 8 * g) = make_uint4(p[0], p[1], p[2], p[3]);
    }
}

// The mask bits of a lane's chunk (bit i = pixel c0 + i).
template <int PER>
__device__ __forceinline__ uint32_t chunk_bits(const uint32_t* bits_row, int c0, int ls) {
    if (c0 >= ls) return 0u;
    const uint32_t word = bits_row[c0 >> 5];
    return PER == 32 ? word : (word >> (c0 & 31)) & ((1u << (PER & 31)) - 1u);
}

// Packed (value, passes-through) pairs of the row scans: a value of at
// most 0x1FFFF (no run: kNoRun) and the flag in bit 31.
constexpr uint32_t kNoRun = 0x1FFFF, kPass = 0x80000000u;

// One pass over the rows that changed since the last row pass (all rows in
// the first pass): every run of foreground takes its minimum. The columns
// of the pixels it changes are marked in col_dirty.
template <int PER>
__device__ bool row_runs(uint16_t* lbl, const uint32_t* mbits, const uint8_t* row_dirty,
                         uint8_t* col_dirty, bool all, int h, int ls, int wpr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c0 = PER * lane;
    bool ch = false;
    for (int r = warp; r < h; r += kWarps) {
        if (!all && !row_dirty[r]) continue;  // uniform over the warp
        uint16_t* row = lbl + static_cast<size_t>(r) * ls;
        const uint32_t mb = chunk_bits<PER>(mbits + r * wpr, c0, ls);
        int v[PER];
        load_chunk<PER>(row, c0, ls, v);
        // run minima within the chunk: forward running minima, then each
        // run's last value backwards over the run
        int m[PER];
        int acc = kNoRun;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            acc = (mb >> i) & 1u ? min(acc, v[i]) : kNoRun;
            m[i] = acc;
        }
#pragma unroll
        for (int i = PER - 2; i >= 0; --i)
            if (((mb >> i) & 1u) && ((mb >> (i + 1)) & 1u)) m[i] = m[i + 1];
        const uint32_t full_bits = PER == 32 ? ~0u : (1u << (PER & 31)) - 1u;
        const bool full = mb == full_bits;
        const int first_bg = full ? PER : __ffs(~mb) - 1;     // pixels before it: head run
        const int last_bg = full ? -1 : 31 - __clz(~mb & full_bits);  // after it: tail run
        // segmented scans across lanes (Hillis-Steele): the run reaching
        // each lane from the left (its tail run's value, passing through
        // full lanes) and from the right (the head run's)
        uint32_t tl = static_cast<uint32_t>(m[PER - 1]) | (full ? kPass : 0u);
        uint32_t hr = static_cast<uint32_t>(m[0]) | (full ? kPass : 0u);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t o = __shfl_up_sync(0xffffffffu, tl, d);
            const uint32_t q = __shfl_down_sync(0xffffffffu, hr, d);
            if (lane >= d && (tl & kPass))
                tl = min(o & ~kPass, tl & ~kPass) | (o & kPass);
            if (lane + d < 32 && (hr & kPass))
                hr = min(q & ~kPass, hr & ~kPass) | (q & kPass);
        }
        int from_left = static_cast<int>(__shfl_up_sync(0xffffffffu, tl, 1) & ~kPass);
        int from_right = static_cast<int>(__shfl_down_sync(0xffffffffu, hr, 1) & ~kPass);
        if (lane == 0) from_left = kNoRun;
        if (lane == 31) from_right = kNoRun;
        bool mine = false;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            if (!((mb >> i) & 1u)) continue;
            int nv = m[i];
            if (i < first_bg) nv = min(nv, from_left);
            if (i > last_bg) nv = min(nv, from_right);
            if (nv != v[i]) {
                v[i] = nv;
                col_dirty[c0 + i] = 1;
                mine = true;
            }
        }
        if (mine) {
            store_chunk<PER>(row, c0, ls, v);
            ch = true;
        }
    }
    return ch;
}

// The gated launch of the adaptive call: false (the block returns at once)
// unless some tile of an earlier call overflowed its gate_slots slots.
__device__ bool gate_open(const int* gate, int gate_slots, int batch) {
    if (gate == nullptr) return true;
    __shared__ int any_over;
    if (threadIdx.x == 0) any_over = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < batch; i += blockDim.x)
        if (gate[i] > gate_slots) any_over = 1;
    __syncthreads();
    return any_over != 0;
}

// Dense ids: the inclusive count of the kept slots (those of the first
// min(roots, s_slots) with at least min_size pixels), in slot order, 0 for
// the others; each thread owns a run of consecutive slots.
template <typename DN>
__device__ void dense_ids(const int* cnt, DN* dn, int roots, int s_slots, int min_size,
                          int* warp_tot) {
    const int n_used = min(roots, s_slots);
    const int per = (s_slots + kThreads - 1) / kThreads;
    const int s0 = threadIdx.x * per, s1 = min(s0 + per, s_slots);
    int k = 0;
    for (int s = s0; s < s1; ++s) k += (s < n_used && cnt[s] >= min_size) ? 1 : 0;
    int run = pgm_block_inclusive_scan(k, warp_tot) - k;
    for (int s = s0; s < s1; ++s) {
        const bool keep = s < n_used && cnt[s] >= min_size;
        run += keep ? 1 : 0;
        dn[s] = static_cast<DN>(keep ? run : 0);
    }
}

// counts[0] += passes, counts[1] = max(counts[1], passes)
__device__ void add_passes(long long* counts, int passes) {
    atomicAdd(reinterpret_cast<unsigned long long*>(counts), passes);
    atomicMax(counts + 1, static_cast<long long>(passes));
}

// kDevTables: the slot counts and dense ids (int32) in `tables`, 2 s_slots
// words a tile, instead of shared memory.
template <int PER, bool kDevTables>
__global__ void __launch_bounds__(kThreads, 1)
cc_sizes_kernel(const uint8_t* __restrict__ mask_in, int* __restrict__ lbl_out,
                int* __restrict__ sizes_out, int* __restrict__ dense_out,
                int* __restrict__ n_roots_out, long long* counts, int h, int w, int ls, int wpr,
                int seg_len, int s_slots, int min_size, int max_iters,
                const int* __restrict__ gate, int gate_slots, int batch, int* tables) {
    if (!gate_open(gate, gate_slots, batch)) return;
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L = layout(h, w, ls, wpr, kDevTables ? 0 : s_slots);
    uint16_t* lbl = reinterpret_cast<uint16_t*>(smem);
    uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + L.mask);
    uint32_t* rbits = reinterpret_cast<uint32_t*>(smem + L.roots);
    int* rowc = reinterpret_cast<int*>(smem + L.rowc);
    uint8_t* row_dirty = smem + L.dirty;        // [2][h], by pass parity
    uint8_t* col_dirty = row_dirty + 2 * h;     // [2][w]
    int* seg_head = reinterpret_cast<int*>(smem + L.seg);
    int* seg_tail = seg_head + kThreads;
    int* seg_full = seg_tail + kThreads;
    const int b = blockIdx.x;
    using DN = typename std::conditional<kDevTables, int, uint16_t>::type;
    int* cnt = kDevTables ? tables + 2LL * b * s_slots : reinterpret_cast<int*>(smem + L.cnt);
    DN* dn = kDevTables ? reinterpret_cast<DN*>(cnt + s_slots) : reinterpret_cast<DN*>(smem + L.dn);
    __shared__ int warp_tot[32];
    __shared__ int total_roots;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c0 = PER * lane;
    const long long base = static_cast<long long>(b) * h * w;

    // labels = pixel indices; the mask as bits (each lane PER pixels of a
    // row, the words put together across the lanes that share them)
    for (int r = warp; r < h; r += kWarps) {
        const uint8_t* src = mask_in + base + static_cast<long long>(r) * w;
        uint32_t bits = 0;
        int v[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            if (c0 + i < w && src[c0 + i]) bits |= 1u << i;
            v[i] = r * w + c0 + i;
        }
        uint32_t word = PER == 32 ? bits : bits << (c0 & 31);
#pragma unroll
        for (int d = 1; d < 32 / PER; d <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, d);
        if ((c0 & 31) == 0 && (c0 >> 5) < wpr) mbits[r * wpr + (c0 >> 5)] = word;
        if (c0 < ls) store_chunk<PER>(lbl + static_cast<size_t>(r) * ls, c0, ls, v);
    }
    for (int s = threadIdx.x; s < s_slots; s += kThreads) cnt[s] = 0;
    for (int i = threadIdx.x; i < 2 * (h + w); i += kThreads) row_dirty[i] = 0;
    __syncthreads();

    // this thread's column segment
    const int segs = (h + seg_len - 1) / seg_len;
    const int seg = threadIdx.x / w, col = threadIdx.x - seg * w;
    const bool has_seg = seg < segs;
    const int ra = seg * seg_len, rb = min(ra + seg_len, h);
    const uint32_t cbit = 1u << (col & 31);
    const int cword = col >> 5;
    auto fg_at = [&](int r) { return (mbits[r * wpr + cword] & cbit) != 0u; };

    // relaxation: row runs, then column runs, to a fixpoint (capped). A row
    // (column) that no pixel of the last column (row) runs changed is at its
    // runs' minima already and is skipped: that saves work, not passes.
    int passes = 0;
    while (true) {
        const int par = passes & 1;
        const bool first = passes == 0;
        uint8_t* rd = row_dirty + par * h;     // marked by these column runs
        uint8_t* cd = col_dirty + par * w;     // marked by these row runs
        if (threadIdx.x < w) col_dirty[(par ^ 1) * w + threadIdx.x] = 0;
        bool ch = row_runs<PER>(lbl, mbits, row_dirty + (par ^ 1) * h, cd, first, h, ls, wpr);
        __syncthreads();
        if (threadIdx.x < h) row_dirty[(par ^ 1) * h + threadIdx.x] = 0;
        const bool mine = has_seg && (first || cd[col]);
        // forward sweep: running minima from each run's start in place, the
        // segment's head and tail runs' minima
        int first_bg = rb;
        if (mine) {
            int acc = kInf, head = kInf;
            for (int r = ra; r < rb; ++r) {
                const bool fg = fg_at(r);
                const int v = lbl[r * ls + col];
                acc = fg ? min(acc, v) : kInf;
                if (fg && acc != v) {
                    lbl[r * ls + col] = static_cast<uint16_t>(acc);
                    rd[r] = 1;
                    ch = true;
                }
                if (!fg && first_bg == rb) first_bg = r;
                if (first_bg == rb) head = acc;
            }
            seg_head[threadIdx.x] = head;
            seg_tail[threadIdx.x] = acc;
            seg_full[threadIdx.x] = first_bg == rb;
        }
        __syncthreads();
        // backward sweep: each run's minimum (its last running minimum, the
        // runs of the segments above and below that reach it) over the run
        if (mine) {
            int top = kInf, bottom = kInf;
            for (int k = seg - 1; k >= 0; --k) {
                top = min(top, seg_tail[k * w + col]);
                if (!seg_full[k * w + col]) break;
            }
            for (int k = seg + 1; k < segs; ++k) {
                bottom = min(bottom, seg_head[k * w + col]);
                if (!seg_full[k * w + col]) break;
            }
            int rm = kInf;
            bool below = false;
            for (int r = rb - 1; r >= ra; --r) {
                const bool fg = fg_at(r);
                if (fg) {
                    const int v = lbl[r * ls + col];
                    if (!below) {
                        rm = v;
                        if (r == rb - 1) rm = min(rm, bottom);
                        if (r < first_bg) rm = min(rm, top);
                    }
                    if (rm != v) {
                        lbl[r * ls + col] = static_cast<uint16_t>(rm);
                        rd[r] = 1;
                        ch = true;
                    }
                }
                below = fg;
            }
        }
        ++passes;
        if (!__syncthreads_or(ch) || passes >= 1 + max_iters) break;
    }

    // the labels out; roots counted per row
    for (int r = warp; r < h; r += kWarps) {
        for (int c = lane; c < w; c += 32) {
            const bool m = (mbits[r * wpr + (c >> 5)] >> (c & 31)) & 1u;
            lbl_out[base + static_cast<long long>(r) * w + c] = m ? lbl[r * ls + c] : kInf;
        }
        const uint32_t mb = chunk_bits<PER>(mbits + r * wpr, c0, ls);
        int v[PER];
        load_chunk<PER>(lbl + static_cast<size_t>(r) * ls, c0, ls, v);
        int k = 0;
#pragma unroll
        for (int i = 0; i < PER; ++i) k += ((mb >> i) & 1u) && v[i] == r * w + c0 + i;
        k = __reduce_add_sync(0xffffffffu, k);
        if (lane == 0) rowc[r] = k;
    }
    __syncthreads();
    {
        const int own = threadIdx.x < h ? rowc[threadIdx.x] : 0;
        const int incl = pgm_block_inclusive_scan(own, warp_tot);
        if (threadIdx.x < h) rowc[threadIdx.x] = incl - own;
        if (threadIdx.x == h - 1) {
            n_roots_out[b] = incl;
            total_roots = incl;
        }
    }
    __syncthreads();

    // roots: their slot (rank, if under s_slots) in place of their label, and
    // their bit in the root plane. A root has no foreground pixel left of it
    // or above it, so a tile of at most 65,536 pixels has at most 32,768
    // roots and a slot never reaches kNone, whatever s_slots.
    for (int r = warp; r < h; r += kWarps) {
        uint16_t* row = lbl + static_cast<size_t>(r) * ls;
        const uint32_t mb = chunk_bits<PER>(mbits + r * wpr, c0, ls);
        int v[PER];
        load_chunk<PER>(row, c0, ls, v);
        uint32_t rb_ = 0;
#pragma unroll
        for (int i = 0; i < PER; ++i)
            if (((mb >> i) & 1u) && v[i] == r * w + c0 + i) rb_ |= 1u << i;
        const int k = __popc(rb_);
        int incl = k;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += o;
        }
        int rank = rowc[r] + incl - k;
        if (rb_) {
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                if ((rb_ >> i) & 1u) {
                    v[i] = rank < s_slots ? rank : kNone;
                    ++rank;
                }
            }
            store_chunk<PER>(row, c0, ls, v);
        }
        uint32_t word = PER == 32 ? rb_ : rb_ << (c0 & 31);
#pragma unroll
        for (int d = 1; d < 32 / PER; d <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, d);
        if ((c0 & 31) == 0 && (c0 >> 5) < wpr) rbits[r * wpr + (c0 >> 5)] = word;
    }
    __syncthreads();

    // every other pixel: its root's slot in place of its label (root entries
    // already hold theirs and are not written here); none on background,
    // past the row's end or where the label's pixel is no root (the
    // relaxation cap bound)
    const float inv_w = 1.0f / static_cast<float>(w);
    for (int r = warp; r < h; r += kWarps) {
        for (int c = lane; c < ls; c += 32) {
            const int wd = r * wpr + (c >> 5);
            const uint32_t bit = 1u << (c & 31);
            if (c < w && (rbits[wd] & bit)) continue;
            int s = kNone;
            if (c < w && (mbits[wd] & bit)) {
                const int v = lbl[r * ls + c];
                int vr = __float2int_rz(static_cast<float>(v) * inv_w);
                int vc = v - vr * w;
                if (vc < 0) {
                    --vr;
                    vc += w;
                } else if (vc >= w) {
                    ++vr;
                    vc -= w;
                }
                if ((rbits[vr * wpr + (vc >> 5)] >> (vc & 31)) & 1u) s = lbl[vr * ls + vc];
            }
            lbl[r * ls + c] = static_cast<uint16_t>(s);
        }
    }
    __syncthreads();

    // component counts: one shared atomic per run of equal slots in a lane's
    // chunk
    for (int r = warp; r < h; r += kWarps) {
        if (c0 >= ls) continue;
        int v[PER];
        load_chunk<PER>(lbl + static_cast<size_t>(r) * ls, c0, ls, v);
#pragma unroll
        for (int i = 0; i < PER; ++i)
            if (c0 + i >= ls) v[i] = kNone;
        int run = v[0], n = 1;
#pragma unroll
        for (int i = 1; i < PER; ++i) {
            if (v[i] == run) {
                ++n;
            } else {
                if (run != kNone) atomicAdd(&cnt[run], n);
                run = v[i];
                n = 1;
            }
        }
        if (run != kNone) atomicAdd(&cnt[run], n);
    }
    __syncthreads();

    dense_ids(cnt, dn, total_roots, s_slots, min_size, warp_tot);
    __syncthreads();

    for (int r = warp; r < h; r += kWarps) {
        for (int c = lane; c < w; c += 32) {
            const int s = lbl[r * ls + c];
            const long long p = base + static_cast<long long>(r) * w + c;
            sizes_out[p] = s != kNone ? cnt[s] : 0;
            dense_out[p] = s != kNone ? dn[s] : 0;
        }
    }
    if (counts != nullptr && threadIdx.x == 0) add_passes(counts, passes);
}

// ------------------------------------------------------------ global route
//
// Tiles the shared route cannot hold (more than 65,536 pixels or a side over
// 1024, up to 2^24 pixels): one block of 1024 threads per tile still, the
// labels int32 in device memory (the output buffer itself, INF on
// background, so the mask is the labels' own), the dirty flags of rows and
// columns in a scratch of 2 (h + w) bytes a tile, the segment records and
// the slot tables in shared memory. The passes are the shared route's, so
// labels and pass counts are the same on every input, the cap included: row
// runs, then column runs, each a run minimum over the labels as the phase
// found them, a row or column the last phase did not change skipped.
// A phase walks its lines (rows or columns) in segments: each round takes
// lpr = 1024 / segs lines, thread (segment, line) walks its segment forward
// (running minima in place, its head and tail runs' minima and whether it is
// all foreground into shared records), then, after a barrier, backward (each
// run its minimum, the runs of the neighbouring segments of its line that
// reach it joined through the records), eight loads at a time. Then the
// roots are ranked by a block scan over the tile in row-major chunks, each
// pixel's slot (its root's rank under s_slots, else none) goes into the
// sizes buffer, the slot counts are warp-aggregated shared atomics, and the
// outputs are written from the slots.

struct Lines {
    long long line_stride, px_stride;  // offset of line l and of its pixel i
    int lines, len, segs, seg_len;
};

constexpr int kGroup = 8;  // labels loaded ahead in a segment walk

// One run-minimum phase over the lines: every run of foreground along a line
// takes its minimum. `dirty_in` (null: every line) names the lines to run;
// the cross index of each changed pixel is marked in `dirty_out`. Every
// thread of the block calls it.
__device__ bool line_runs(int* lbl, const Lines L, const uint8_t* dirty_in, uint8_t* dirty_out,
                          int* seg_head, int* seg_tail, int* seg_full) {
    const int lpr = kThreads / L.segs;
    const int seg = threadIdx.x / lpr, li = threadIdx.x - seg * lpr;
    bool ch = false;
    for (int l0 = 0; l0 < L.lines; l0 += lpr) {
        const int l = l0 + li;
        const bool mine = seg < L.segs && l < L.lines && (dirty_in == nullptr || dirty_in[l]);
        const int ra = seg * L.seg_len, rb = min(ra + L.seg_len, L.len);
        int* line = lbl + l * L.line_stride;
        int first_bg = rb;
        if (mine) {
            int acc = kInf, head = kInf;
            for (int r0 = ra; r0 < rb; r0 += kGroup) {
                int v[kGroup];
#pragma unroll
                for (int k = 0; k < kGroup; ++k)
                    v[k] = r0 + k < rb ? line[(r0 + k) * L.px_stride] : kInf;
#pragma unroll
                for (int k = 0; k < kGroup; ++k) {
                    const int r = r0 + k;
                    if (r >= rb) break;
                    const bool fg = v[k] < kInf;
                    acc = fg ? min(acc, v[k]) : kInf;
                    if (fg && acc != v[k]) {
                        line[r * L.px_stride] = acc;
                        dirty_out[r] = 1;
                        ch = true;
                    }
                    if (!fg && first_bg == rb) first_bg = r;
                    if (first_bg == rb) head = acc;
                }
            }
            seg_head[threadIdx.x] = head;
            seg_tail[threadIdx.x] = acc;
            seg_full[threadIdx.x] = first_bg == rb;
        }
        __syncthreads();
        if (mine) {
            int top = kInf, bottom = kInf;
            for (int k = seg - 1; k >= 0; --k) {
                top = min(top, seg_tail[k * lpr + li]);
                if (!seg_full[k * lpr + li]) break;
            }
            for (int k = seg + 1; k < L.segs; ++k) {
                bottom = min(bottom, seg_head[k * lpr + li]);
                if (!seg_full[k * lpr + li]) break;
            }
            int rm = kInf;
            bool below = false;
            for (int r1 = rb - 1; r1 >= ra; r1 -= kGroup) {
                int v[kGroup];
#pragma unroll
                for (int k = 0; k < kGroup; ++k)
                    v[k] = r1 - k >= ra ? line[(r1 - k) * L.px_stride] : kInf;
#pragma unroll
                for (int k = 0; k < kGroup; ++k) {
                    const int r = r1 - k;
                    if (r < ra) break;
                    const bool fg = v[k] < kInf;
                    if (fg) {
                        if (!below) {
                            rm = v[k];
                            if (r == rb - 1) rm = min(rm, bottom);
                            if (r < first_bg) rm = min(rm, top);
                        }
                        if (rm != v[k]) {
                            line[r * L.px_stride] = rm;
                            dirty_out[r] = 1;
                            ch = true;
                        }
                    }
                    below = fg;
                }
            }
        }
        __syncthreads();  // the records are the next round's
    }
    return ch;
}

template <bool kDevTables>
__global__ void __launch_bounds__(kThreads, 1)
cc_sizes_global_kernel(const uint8_t* __restrict__ mask_in, int* __restrict__ lbl_out,
                       int* __restrict__ sizes_out, int* __restrict__ dense_out,
                       int* __restrict__ n_roots_out, long long* counts,
                       uint8_t* __restrict__ scratch, int h, int w, Lines rows, Lines cols,
                       int s_slots, int min_size, int max_iters, const int* __restrict__ gate,
                       int gate_slots, int batch, int* tables) {
    if (!gate_open(gate, gate_slots, batch)) return;
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    int* seg_head = reinterpret_cast<int*>(smem);
    int* seg_tail = seg_head + kThreads;
    int* seg_full = seg_tail + kThreads;
    int* cnt = kDevTables ? tables + 2LL * b * s_slots : seg_full + kThreads;
    int* dn = cnt + s_slots;
    __shared__ int warp_tot[32];

    const int lane = threadIdx.x & 31;
    const int n = h * w;
    const long long base = static_cast<long long>(b) * n;
    int* lbl = lbl_out + base;
    int* slot = sizes_out + base;  // each pixel's slot until the sizes are known
    uint8_t* row_dirty = scratch + static_cast<long long>(b) * 2 * (h + w);  // [2][h], by parity
    uint8_t* col_dirty = row_dirty + 2 * h;                                   // [2][w]

    for (int p = threadIdx.x; p < n; p += kThreads) lbl[p] = mask_in[base + p] ? p : kInf;
    for (int i = threadIdx.x; i < 2 * (h + w); i += kThreads) row_dirty[i] = 0;
    for (int s = threadIdx.x; s < s_slots; s += kThreads) cnt[s] = 0;
    __syncthreads();

    // relaxation: row runs, then column runs, to a fixpoint (capped)
    int passes = 0;
    while (true) {
        const int par = passes & 1;
        const bool first = passes == 0;
        for (int i = threadIdx.x; i < w; i += kThreads) col_dirty[(par ^ 1) * w + i] = 0;
        bool ch = line_runs(lbl, rows, first ? nullptr : row_dirty + (par ^ 1) * h,
                            col_dirty + par * w, seg_head, seg_tail, seg_full);
        for (int i = threadIdx.x; i < h; i += kThreads) row_dirty[(par ^ 1) * h + i] = 0;
        ch |= line_runs(lbl, cols, first ? nullptr : col_dirty + par * w, row_dirty + par * h,
                        seg_head, seg_tail, seg_full);
        ++passes;
        if (!__syncthreads_or(ch) || passes >= 1 + max_iters) break;
    }

    // roots ranked in row-major order: 16 consecutive pixels a thread, a
    // block scan a chunk; a root's slot (its rank, if under s_slots) into
    // the slot buffer
    constexpr int kPer = 16;
    int total = 0;
    for (int c0 = 0; c0 < n; c0 += kThreads * kPer) {
        const int p0 = c0 + threadIdx.x * kPer;
        int k = 0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) k += p0 + i < n && lbl[p0 + i] == p0 + i;
        const int incl = pgm_block_inclusive_scan(k, warp_tot);
        int rank = total + incl - k;
        if (k) {
            for (int i = 0; i < kPer; ++i) {
                if (p0 + i < n && lbl[p0 + i] == p0 + i) {
                    slot[p0 + i] = rank < s_slots ? rank : -1;
                    ++rank;
                }
            }
        }
        total += warp_tot[kWarps - 1];  // the chunk's roots
        __syncthreads();                 // ... read by all before the next scan
    }
    if (threadIdx.x == 0) n_roots_out[b] = total;

    // every other pixel: its root's slot; none on background or where the
    // label's pixel is no root (the relaxation cap bound)
    for (int p = threadIdx.x; p < n; p += kThreads) {
        const int v = lbl[p];
        if (v == p) continue;
        slot[p] = v < kInf && lbl[v] == v ? slot[v] : -1;
    }
    __syncthreads();

    // component counts: one shared atomic per group of lanes with one slot
    for (int p0 = 0; p0 < n; p0 += kThreads) {
        const int p = p0 + threadIdx.x;
        const int s = p < n ? slot[p] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, s);
        if (s >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[s], __popc(peers));
    }
    __syncthreads();

    dense_ids(cnt, dn, total, s_slots, min_size, warp_tot);
    __syncthreads();

    for (int p = threadIdx.x; p < n; p += kThreads) {
        const int s = slot[p];
        slot[p] = s >= 0 ? cnt[s] : 0;
        dense_out[base + p] = s >= 0 ? dn[s] : 0;
    }
    if (counts != nullptr && threadIdx.x == 0) add_passes(counts, passes);
}

int pixels_per_lane(int ls) { return ls <= 256 ? 8 : (ls <= 512 ? 16 : 32); }

// Shared memory of the shared route; s_slots 0 with the tables in device
// memory.
size_t smem_bytes(int h, int w, int s_slots) {
    return layout(h, w, (w + 7) / 8 * 8, (w + 31) / 32, s_slots).total;
}

template <int PER>
cudaError_t run_shared(bool dev_tables, int smem, int b, cudaStream_t st,
                       const uint8_t* mask, int* lbl, int* sizes, int* dense, int* n_roots,
                       long long* counts, int h, int w, int ls, int wpr, int seg_len, int s_slots,
                       int min_size, int max_iters, const int* gate, int gate_slots, int* tables) {
    void (*kernel)(const uint8_t*, int*, int*, int*, int*, long long*, int, int, int, int, int,
                   int, int, int, const int*, int, int, int*) =
        dev_tables ? cc_sizes_kernel<PER, true> : cc_sizes_kernel<PER, false>;
    cudaError_t e = pgm_set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<b, kThreads, smem, st>>>(mask, lbl, sizes, dense, n_roots, counts, h, w, ls, wpr,
                                      seg_len, s_slots, min_size, max_iters, gate, gate_slots, b,
                                      tables);
    return cudaGetLastError();
}

}  // namespace

// mask (B, H, W) uint8; lbl, sizes, dense (B, H, W) int32, n_roots (B,) int32;
// tables: null (the slot counts and dense ids in shared memory) or a device
// scratch of B x 2 s_slots int32 (any s_slots). ls, per, seg_len, smem: the
// launch geometry of ops/cc_sizes.py::CcSizesTiling.
PGM_EXPORT int cc_sizes_launch(const void* mask, void* lbl, void* sizes, void* dense,
                               void* n_roots, void* counts, int b, int h, int w, int s_slots,
                               int min_size, int max_iters, const void* gate, int gate_slots,
                               int threads, int ls, int per, int seg_len, int smem, void* tables,
                               void* stream) {
    const int wpr = (w + 31) / 32;
    const int cols = w < kThreads ? kThreads / w : 1;
    const bool dev = tables != nullptr;
    if (threads != kThreads || b <= 0 || h <= 0 || w <= 0 || h > 1024 || w > 1024 ||
        h * w > 65536 || s_slots <= 0 || (!dev && s_slots >= kNone) || ls != (w + 7) / 8 * 8 ||
        per != pixels_per_lane(ls) || seg_len != (h + cols - 1) / cols ||
        static_cast<size_t>(smem) != smem_bytes(h, w, dev ? 0 : s_slots))
        return static_cast<int>(cudaErrorInvalidValue);
    auto run = per == 8 ? run_shared<8> : (per == 16 ? run_shared<16> : run_shared<32>);
    return static_cast<int>(run(dev, smem, b, static_cast<cudaStream_t>(stream),
                                static_cast<const uint8_t*>(mask), static_cast<int*>(lbl),
                                static_cast<int*>(sizes), static_cast<int*>(dense),
                                static_cast<int*>(n_roots), static_cast<long long*>(counts), h, w,
                                ls, wpr, seg_len, s_slots, min_size, max_iters,
                                static_cast<const int*>(gate), gate_slots,
                                static_cast<int*>(tables)));
}

namespace {

// A phase's split of its lines into segments: as many segments a line as
// the block has threads for its lines (at least one, at most a pixel each).
bool line_split_ok(const Lines& L) {
    const int cap = L.lines >= kThreads ? 1 : min(kThreads / L.lines, L.len);
    const int seg_len = (L.len + cap - 1) / cap;
    return L.seg_len == seg_len && L.segs == (L.len + seg_len - 1) / seg_len;
}

// s_slots 0 with the tables in device memory
size_t global_smem_bytes(int s_slots) { return size_t(3) * kThreads * 4 + size_t(s_slots) * 8; }

}  // namespace

// The global route: tiles of 65,537 .. 2^24 - 1 pixels, or a side over
// 1024. mask (B, H, W) uint8; lbl, sizes, dense (B, H, W) int32; n_roots
// (B,) int32; scratch (B, 2 (H + W)) uint8; tables as cc_sizes_launch's.
// row_segs, row_seg_len, col_segs, col_seg_len, smem: the launch geometry
// of ops/cc_sizes.py::CcSizesTiling.
PGM_EXPORT int cc_sizes_global_launch(const void* mask, void* lbl, void* sizes, void* dense,
                                      void* n_roots, void* counts, void* scratch, int b, int h,
                                      int w, int s_slots, int min_size, int max_iters,
                                      const void* gate, int gate_slots, int threads,
                                      int row_segs, int row_seg_len, int col_segs,
                                      int col_seg_len, int smem, void* tables, void* stream) {
    const Lines rows{w, 1, h, w, row_segs, row_seg_len};
    const Lines cols{1, w, w, h, col_segs, col_seg_len};
    const long long px = static_cast<long long>(h) * w;
    const bool dev = tables != nullptr;
    if (threads != kThreads || b <= 0 || h <= 0 || w <= 0 || px >= (1LL << 24) ||
        (h <= 1024 && w <= 1024 && px <= 65536) || s_slots <= 0 ||
        !line_split_ok(rows) || !line_split_ok(cols) ||
        static_cast<size_t>(smem) != global_smem_bytes(dev ? 0 : s_slots))
        return static_cast<int>(cudaErrorInvalidValue);
    void (*kernel)(const uint8_t*, int*, int*, int*, int*, long long*, uint8_t*, int, int, Lines,
                   Lines, int, int, int, const int*, int, int, int*) =
        dev ? cc_sizes_global_kernel<true> : cc_sizes_global_kernel<false>;
    cudaError_t e = pgm_set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mask), static_cast<int*>(lbl), static_cast<int*>(sizes),
        static_cast<int*>(dense), static_cast<int*>(n_roots), static_cast<long long*>(counts),
        static_cast<uint8_t*>(scratch), h, w, rows, cols, s_slots, min_size, max_iters,
        static_cast<const int*>(gate), gate_slots, b, static_cast<int*>(tables));
    return static_cast<int>(cudaGetLastError());
}
