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
// tile needs a few passes of two run-minimum scans each.
//
// Design: one block of 1024 threads per tile, the labels as uint16 pixel
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
// trip to the host. Geometry: ops/cc_sizes.py::CcSizesTiling; the launcher
// refuses any other.
//
// counts (int64[2], optional): += relaxation passes of every tile, max=
// passes of one tile.
#include "common.cuh"

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

template <int PER>
__global__ void __launch_bounds__(kThreads, 1)
cc_sizes_kernel(const uint8_t* __restrict__ mask_in, int* __restrict__ lbl_out,
                int* __restrict__ sizes_out, int* __restrict__ dense_out,
                int* __restrict__ n_roots_out, long long* counts, int h, int w, int ls, int wpr,
                int seg_len, int s_slots, int min_size, int max_iters,
                const int* __restrict__ gate, int gate_slots, int batch) {
    if (gate != nullptr) {
        __shared__ int any_over;
        if (threadIdx.x == 0) any_over = 0;
        __syncthreads();
        for (int i = threadIdx.x; i < batch; i += blockDim.x)
            if (gate[i] > gate_slots) any_over = 1;
        __syncthreads();
        if (!any_over) return;
    }
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L = layout(h, w, ls, wpr, s_slots);
    uint16_t* lbl = reinterpret_cast<uint16_t*>(smem);
    uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + L.mask);
    uint32_t* rbits = reinterpret_cast<uint32_t*>(smem + L.roots);
    int* rowc = reinterpret_cast<int*>(smem + L.rowc);
    uint8_t* row_dirty = smem + L.dirty;        // [2][h], by pass parity
    uint8_t* col_dirty = row_dirty + 2 * h;     // [2][w]
    int* seg_head = reinterpret_cast<int*>(smem + L.seg);
    int* seg_tail = seg_head + kThreads;
    int* seg_full = seg_tail + kThreads;
    int* cnt = reinterpret_cast<int*>(smem + L.cnt);
    uint16_t* dn = reinterpret_cast<uint16_t*>(smem + L.dn);
    __shared__ int warp_tot[32];
    __shared__ int total_roots;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c0 = PER * lane;
    const int b = blockIdx.x;
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
    // their bit in the root plane
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

    // dense ids: inclusive count of the kept slots, in slot order (each
    // thread owns a run of consecutive slots)
    {
        const int n_used = min(total_roots, s_slots);
        const int per = (s_slots + kThreads - 1) / kThreads;
        const int s0 = threadIdx.x * per, s1 = min(s0 + per, s_slots);
        int k = 0;
        for (int s = s0; s < s1; ++s) k += (s < n_used && cnt[s] >= min_size) ? 1 : 0;
        int run = pgm_block_inclusive_scan(k, warp_tot) - k;
        for (int s = s0; s < s1; ++s) {
            const bool keep = s < n_used && cnt[s] >= min_size;
            run += keep ? 1 : 0;
            dn[s] = static_cast<uint16_t>(keep ? run : 0);
        }
    }
    __syncthreads();

    for (int r = warp; r < h; r += kWarps) {
        for (int c = lane; c < w; c += 32) {
            const int s = lbl[r * ls + c];
            const long long p = base + static_cast<long long>(r) * w + c;
            sizes_out[p] = s != kNone ? cnt[s] : 0;
            dense_out[p] = s != kNone ? dn[s] : 0;
        }
    }
    if (counts != nullptr && threadIdx.x == 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(counts), passes);
        atomicMax(counts + 1, static_cast<long long>(passes));
    }
}

int pixels_per_lane(int ls) { return ls <= 256 ? 8 : (ls <= 512 ? 16 : 32); }

size_t smem_bytes(int h, int w, int s_slots) {
    return layout(h, w, (w + 7) / 8 * 8, (w + 31) / 32, s_slots).total;
}

}  // namespace

// mask (B, H, W) uint8; lbl, sizes, dense (B, H, W) int32, n_roots (B,) int32.
// ls, per, seg_len, smem: the launch geometry of
// ops/cc_sizes.py::CcSizesTiling.
PGM_EXPORT int cc_sizes_launch(const void* mask, void* lbl, void* sizes, void* dense,
                               void* n_roots, void* counts, int b, int h, int w, int s_slots,
                               int min_size, int max_iters, const void* gate, int gate_slots,
                               int threads, int ls, int per, int seg_len, int smem,
                               void* stream) {
    const int wpr = (w + 31) / 32;
    const int cols = w < kThreads ? kThreads / w : 1;
    if (threads != kThreads || b <= 0 || h <= 0 || w <= 0 || h > 1024 || w > 1024 ||
        h * w > 65536 || s_slots <= 0 || s_slots >= kNone || ls != (w + 7) / 8 * 8 ||
        per != pixels_per_lane(ls) || seg_len != (h + cols - 1) / cols ||
        static_cast<size_t>(smem) != smem_bytes(h, w, s_slots))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    void (*kernel)(const uint8_t*, int*, int*, int*, int*, long long*, int, int, int, int, int,
                   int, int, int, const int*, int, int) =
        per == 8 ? cc_sizes_kernel<8> : (per == 16 ? cc_sizes_kernel<16> : cc_sizes_kernel<32>);
    cudaError_t e = pgm_set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<b, kThreads, smem, st>>>(
        static_cast<const uint8_t*>(mask), static_cast<int*>(lbl), static_cast<int*>(sizes),
        static_cast<int*>(dense), static_cast<int*>(n_roots), static_cast<long long*>(counts), h,
        w, ls, wpr, seg_len, s_slots, min_size, max_iters, static_cast<const int*>(gate),
        gate_slots, b);
    return static_cast<int>(cudaGetLastError());
}
