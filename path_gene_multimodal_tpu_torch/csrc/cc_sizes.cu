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
// What bounds it here: the serial run scans. A pass is two sequential
// sweeps of 256 pixels per row and per column; a tile needs a handful of
// passes. Bytes are small (1 B mask in, 3 x 4 B out per pixel).
//
// Design: one block per tile, state in shared memory. Pixel indices of a
// 256 x 256 tile fit uint16, so the labels take 128 KB and the mask 64 KB
// (the int32 labels alone, 256 KB, would not fit). Rows are padded so that
// the thread-per-row sweeps hit distinct banks. After the relaxation the
// root pixels get their rank (a block prefix sum over per-row root counts)
// stored in place of their label, so a pixel finds its slot through its
// label without a second 64 K-entry table. Component counts are shared
// atomics on the slot table (s_slots ints). With `gate`, the block first
// reads the n_roots of an earlier call at `gate_slots` slots and returns at
// once unless some tile overflowed them: that is `lax.cond` of the adaptive
// TPU wrapper without a trip to the host.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kInf = 1 << 30;
constexpr uint16_t kNoSlot = 0xFFFF;

__global__ void __launch_bounds__(kThreads)
cc_sizes_kernel(const uint8_t* __restrict__ mask_in, int* __restrict__ lbl_out,
                int* __restrict__ sizes_out, int* __restrict__ dense_out,
                int* __restrict__ n_roots_out, int h, int w, int s_slots, int min_size,
                int max_iters, const int* __restrict__ gate, int gate_slots,
                int batch) {
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
    const int ls = w + 2;  // uint16 row stride: odd word stride
    const int ms = w + 4;  // uint8 row stride: odd word stride
    uint16_t* lbl = reinterpret_cast<uint16_t*>(smem);
    uint8_t* msk = smem + static_cast<size_t>(h) * ls * 2;
    int* cnt = reinterpret_cast<int*>(msk + ((static_cast<size_t>(h) * ms + 15) & ~size_t(15)));
    int* rowc = cnt + s_slots;  // per-row root counts (h ints)
    __shared__ int warp_tot[32];
    __shared__ int changed;
    __shared__ int total_roots;

    const int b = blockIdx.x;
    const long long base = static_cast<long long>(b) * h * w;
    const int n = h * w;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        const int r = p / w, c = p % w;
        msk[r * ms + c] = mask_in[base + p] ? 1 : 0;
        lbl[r * ls + c] = static_cast<uint16_t>(p);
    }
    __syncthreads();

    // relaxation: row runs, then column runs, to a fixpoint (capped)
    int passes = 0;
    while (true) {
        if (threadIdx.x == 0) changed = 0;
        __syncthreads();
        int ch = 0;
        if (threadIdx.x < h) {
            const int r = threadIdx.x;
            uint16_t* L = lbl + r * ls;
            const uint8_t* M = msk + r * ms;
            int j = 0;
            while (j < w) {
                if (!M[j]) { ++j; continue; }
                const int a = j;
                uint16_t m = L[j];
                for (++j; j < w && M[j]; ++j) m = min(m, L[j]);
                for (int k = a; k < j; ++k)
                    if (L[k] != m) { L[k] = m; ch = 1; }
            }
        }
        __syncthreads();
        if (threadIdx.x < w) {
            const int c = threadIdx.x;
            int i = 0;
            while (i < h) {
                if (!msk[i * ms + c]) { ++i; continue; }
                const int a = i;
                uint16_t m = lbl[i * ls + c];
                for (++i; i < h && msk[i * ms + c]; ++i) m = min(m, lbl[i * ls + c]);
                for (int k = a; k < i; ++k)
                    if (lbl[k * ls + c] != m) { lbl[k * ls + c] = m; ch = 1; }
            }
        }
        if (ch) changed = 1;
        __syncthreads();
        ++passes;
        const int again = changed;
        __syncthreads();
        if (!again || passes >= 1 + max_iters) break;
    }

    // roots and their row-major ranks
    if (threadIdx.x < h) {
        const int r = threadIdx.x;
        int k = 0;
        for (int c = 0; c < w; ++c)
            k += (msk[r * ms + c] && lbl[r * ls + c] == r * w + c) ? 1 : 0;
        rowc[r] = k;
    }
    __syncthreads();
    const int mine = threadIdx.x < h ? rowc[threadIdx.x] : 0;
    const int incl = pgm_block_inclusive_scan(mine, warp_tot);
    if (threadIdx.x == h - 1) {
        n_roots_out[b] = incl;
        total_roots = incl;
    }
    if (threadIdx.x < h) {
        const int r = threadIdx.x;
        int rank = incl - mine;
        for (int c = 0; c < w; ++c) {
            if (msk[r * ms + c] && lbl[r * ls + c] == r * w + c) {
                msk[r * ms + c] = 2;  // root marker; its label is its index
                lbl[r * ls + c] = rank < s_slots ? static_cast<uint16_t>(rank) : kNoSlot;
                ++rank;
            }
        }
    }
    for (int s = threadIdx.x; s < s_slots; s += blockDim.x) cnt[s] = 0;
    __syncthreads();

    // a pixel's slot: its own (roots) or its label's, if that pixel is a root
    auto slot_of = [&](int r, int c, int* label) -> int {
        const uint8_t m = msk[r * ms + c];
        if (m == 0) { *label = kInf; return -1; }
        const uint16_t v = lbl[r * ls + c];
        if (m == 2) { *label = r * w + c; return v == kNoSlot ? -1 : v; }
        *label = v;
        const int rr = v / w, rc = v % w;
        if (msk[rr * ms + rc] != 2) return -1;
        const uint16_t s = lbl[rr * ls + rc];
        return s == kNoSlot ? -1 : s;
    };
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int label;
        const int s = slot_of(p / w, p % w, &label);
        if (s >= 0) atomicAdd(&cnt[s], 1);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int label;
        const int s = slot_of(p / w, p % w, &label);
        lbl_out[base + p] = label;
        sizes_out[base + p] = s >= 0 ? cnt[s] : 0;
    }
    __syncthreads();

    // dense ids: inclusive count of the kept slots, in slot order, written
    // over the counts (each thread owns a run of consecutive slots)
    const int n_used = min(total_roots, s_slots);
    const int per = (s_slots + blockDim.x - 1) / blockDim.x;
    const int s0 = threadIdx.x * per;
    const int s1 = min(s0 + per, s_slots);
    int k = 0;
    for (int s = s0; s < s1; ++s) k += (s < n_used && cnt[s] >= min_size) ? 1 : 0;
    int run = pgm_block_inclusive_scan(k, warp_tot) - k;
    for (int s = s0; s < s1; ++s) {
        const bool keep = s < n_used && cnt[s] >= min_size;
        run += keep ? 1 : 0;
        cnt[s] = keep ? run : 0;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int label;
        const int s = slot_of(p / w, p % w, &label);
        dense_out[base + p] = s >= 0 ? cnt[s] : 0;
    }
}

}  // namespace

PGM_EXPORT size_t cc_sizes_smem_bytes(int h, int w, int s_slots) {
    const size_t lbl = static_cast<size_t>(h) * (w + 2) * 2;
    const size_t msk = (static_cast<size_t>(h) * (w + 4) + 15) & ~size_t(15);
    return lbl + msk + static_cast<size_t>(s_slots + h) * 4;
}

PGM_EXPORT int cc_sizes_launch(const void* mask, void* lbl, void* sizes, void* dense,
                               void* n_roots, int b, int h, int w, int s_slots,
                               int min_size, int max_iters, const void* gate,
                               int gate_slots, void* stream) {
    const size_t smem = cc_sizes_smem_bytes(h, w, s_slots);
    cudaError_t e = pgm_set_smem(cc_sizes_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cc_sizes_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mask), static_cast<int*>(lbl),
        static_cast<int*>(sizes), static_cast<int*>(dense), static_cast<int*>(n_roots),
        h, w, s_slots, min_size, max_iters, static_cast<const int*>(gate), gate_slots, b);
    return static_cast<int>(cudaGetLastError());
}
