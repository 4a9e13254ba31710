// Connected-component labeling for the H100: one seeded per-tile fixpoint
// core, launched over a batch of tiles (K6) or over the tiles of one large
// mask between global border-min exchanges (K5).
//
// Replaces two TPU kernels of path_gene_multimodal_tpu/ops/pallas/cc.py:
//   K6  pallas_label_components        (:112, pallas_call :122): per tile,
//       seeds = pixel linear index, at most 1 + max_iters relaxations;
//   K5  pallas_label_components_tiled  (:146, pallas_call :180): one mask,
//       padded to tile multiples, seeds = original-width linear indices;
//       propagate (the fixpoint in every tile x tile block) alternated with
//       a one-pixel border-min over the whole mask (:190-201), the rounds
//       driven by the host (ops/cc.py) until nothing changes.
//
// Contract (identical outputs to the Pallas kernels and to the plain
// versions in ops/cc.py): a relaxation is, as a pure function of the
// previous state, the minimum over each horizontal run of foreground, then
// over each vertical run, then (connectivity 2) the diagonal relaxes
// (1,1), (1,-1), (-1,1), (-1,-1), each reading the state the previous one
// wrote; neighbours outside the tile read as background. Background is
// INF = 2^30. A tile stops after the first relaxation that changes nothing
// or after 1 + max_iters relaxations, whichever comes first.
//
// What bounds it here: the relaxation count. The bytes per call are the
// 1-byte mask in and the int32 labels out; every relaxation sweeps the
// whole tile again, so the work is relaxations x pixels, of scalar integer
// min operations.
//
// Design: one block of 1024 threads per tile. A 512^2 tile's int32 labels
// are 1 MB, more than the 227 KB of shared memory, so the state lives in
// global memory (three label buffers: current, next, and the diagonal
// steps' scratch), where a tile stays in L2 between steps. Rows: one warp
// per row, 32 pixels per step, a segmented min scan by shuffles with the
// run carried from chunk to chunk, forward then backward (the backward scan
// of the forward prefix minima is the run minimum). Columns: one thread per
// column walks down and up. Every pass issues a group of loads (16 chunks of
// a row, 8 rows of a column, 4 pixels) before it uses them, so that their
// latencies overlap: a walk that loads, updates and stores one value at a
// time waits on L2 at every step. Diagonal steps double-buffer;
// __syncthreads separates every step, and __syncthreads_or gives the tile's
// "changed" flag. Each block adds its relaxation count to a device counter;
// block (0, 0, 0) adds 1 to the round counter. Splitting a tile over a
// thread-block cluster (all SMs busy on a 4-tile mask) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct TileArgs {
    const uint8_t* mask;  // tile origin; row stride ld
    const int* seeds;     // tile origin, or null: seed = (row0 + y) * seed_w + col0 + x
    const int* prev;      // tile origin, or null: compare the result with it
    int* out;
    int* tmp;
    int* tmp2;
    int th, tw, ld;
    int row0, col0, seed_w;
};

__device__ __forceinline__ int seed_at(const TileArgs& t, int y, int x) {
    if (t.seeds != nullptr) return t.seeds[y * t.ld + x];
    return (t.row0 + y) * t.seed_w + t.col0 + x;
}

// Inclusive segmented min scan over the warp's 32 values, forward (lane 0
// first) or backward; background lanes (f) start a segment with INF. Lanes
// with no segment start at or before them take `carry`, the run value
// entering the chunk. Returns the lane's value; `carry` becomes the value
// leaving the chunk.
template <bool FWD>
__device__ __forceinline__ int seg_scan(int v, bool f, int& carry) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const int nv = FWD ? __shfl_up_sync(kFull, v, s) : __shfl_down_sync(kFull, v, s);
        const int nf = FWD ? __shfl_up_sync(kFull, static_cast<int>(f), s)
                           : __shfl_down_sync(kFull, static_cast<int>(f), s);
        if (FWD ? lane >= s : lane + s < 32) {
            if (!f) v = min(v, nv);
            f = f || nf;
        }
    }
    if (!f) v = min(v, carry);
    carry = __shfl_sync(kFull, v, FWD ? 31 : 0);
    return v;
}

// dst = run minimum of src along rows (INF off the mask). src == null reads
// the seeds. A warp owns a row and walks it in segments of kSeg chunks of 32
// pixels: each segment's loads are issued together into registers, then
// scanned chunk by chunk (forward prefix minima, then a backward scan of
// them, which gives each run's minimum).
constexpr int kSeg = 16;

__device__ void rows_pass(const TileArgs& t, const int* src, int* dst) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nseg = (t.tw + 32 * kSeg - 1) / (32 * kSeg);
    for (int y = warp; y < t.th; y += kWarps) {
        const uint8_t* m = t.mask + y * t.ld;
        const int* s = src != nullptr ? src + y * t.ld : nullptr;
        int* d = dst + y * t.ld;
        int carry = kInf;
        for (int g = 0; g < nseg; ++g) {  // forward
            const int x0 = g * 32 * kSeg + lane;
            int v[kSeg];
            unsigned fg = 0;
#pragma unroll
            for (int k = 0; k < kSeg; ++k) {
                const int x = x0 + 32 * k;
                v[k] = kInf;
                if (x < t.tw) {
                    fg |= (m[x] ? 1u : 0u) << k;
                    v[k] = s != nullptr ? s[x] : seed_at(t, y, x);
                }
            }
#pragma unroll
            for (int k = 0; k < kSeg; ++k) {
                if (x0 - lane + 32 * k >= t.tw) break;  // warp-uniform
                const bool f = !((fg >> k) & 1u);
                v[k] = seg_scan<true>(f ? kInf : v[k], f, carry);
            }
#pragma unroll
            for (int k = 0; k < kSeg; ++k)
                if (x0 + 32 * k < t.tw) d[x0 + 32 * k] = v[k];
        }
        carry = kInf;
        for (int g = nseg - 1; g >= 0; --g) {  // backward
            const int x0 = g * 32 * kSeg + lane;
            int v[kSeg];
            unsigned fg = 0;
#pragma unroll
            for (int k = 0; k < kSeg; ++k) {
                const int x = x0 + 32 * k;
                v[k] = kInf;
                if (x < t.tw) {
                    fg |= (m[x] ? 1u : 0u) << k;
                    v[k] = d[x];
                }
            }
#pragma unroll
            for (int k = kSeg - 1; k >= 0; --k) {
                if (x0 - lane + 32 * k >= t.tw) continue;  // warp-uniform
                const bool f = !((fg >> k) & 1u);
                v[k] = seg_scan<false>(f ? kInf : v[k], f, carry);
            }
#pragma unroll
            for (int k = 0; k < kSeg; ++k)
                if (x0 + 32 * k < t.tw) d[x0 + 32 * k] = v[k];
        }
    }
}

// dst = run minimum of dst along columns, in place (a thread owns a column;
// kRows rows' loads issued together). With `compare`, returns whether any
// final value differs from `old` (null: the seeds).
constexpr int kRows = 8;

__device__ int cols_pass(const TileArgs& t, int* dst, const int* old, bool compare) {
    int ch = 0;
    for (int x = threadIdx.x; x < t.tw; x += kThreads) {
        int run = kInf;
        for (int y0 = 0; y0 < t.th; y0 += kRows) {  // down
            int v[kRows];
            bool fg[kRows];
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
                const int p = (y0 + j) * t.ld + x;
                fg[j] = y0 + j < t.th && t.mask[p];
                v[j] = y0 + j < t.th ? dst[p] : kInf;
            }
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
                run = fg[j] ? min(run, v[j]) : kInf;
                if (fg[j]) dst[(y0 + j) * t.ld + x] = run;
            }
        }
        run = kInf;
        for (int y0 = t.th - 1; y0 >= 0; y0 -= kRows) {  // up
            int v[kRows], o[kRows];
            bool fg[kRows];
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
                const int y = y0 - j;
                const int p = y * t.ld + x;
                fg[j] = y >= 0 && t.mask[p];
                v[j] = y >= 0 ? dst[p] : kInf;
                o[j] = compare && fg[j] ? (old != nullptr ? old[p] : seed_at(t, y, x)) : 0;
            }
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
                run = fg[j] ? min(run, v[j]) : kInf;
                if (fg[j]) {
                    dst[(y0 - j) * t.ld + x] = run;
                    if (compare && run != o[j]) ch = 1;
                }
            }
        }
    }
    return ch;
}

// b = where(mask, min(a, a shifted by (dy, dx)), INF): b[y][x] reads
// a[y - dy][x - dx], INF outside the tile. kDiag pixels per thread per step,
// loads first.
constexpr int kDiag = 4;

__device__ int diag_pass(const TileArgs& t, const int* a, int* b, int dy, int dx,
                         const int* old, bool compare) {
    int ch = 0;
    const int n = t.th * t.tw;
    for (int i0 = threadIdx.x; i0 < n; i0 += kDiag * kThreads) {
        int v[kDiag], o[kDiag], pos[kDiag];
#pragma unroll
        for (int k = 0; k < kDiag; ++k) {
            const int i = i0 + k * kThreads;
            pos[k] = -1;
            v[k] = kInf;
            o[k] = 0;
            if (i >= n) continue;
            const int y = i / t.tw, x = i - y * t.tw;
            const int p = y * t.ld + x;
            pos[k] = p;
            if (t.mask[p]) {
                v[k] = a[p];
                const int yy = y - dy, xx = x - dx;
                if (yy >= 0 && yy < t.th && xx >= 0 && xx < t.tw) v[k] = min(v[k], a[yy * t.ld + xx]);
                if (compare) o[k] = (old != nullptr ? old[p] : seed_at(t, y, x)) != v[k];
            }
        }
#pragma unroll
        for (int k = 0; k < kDiag; ++k) {
            if (pos[k] < 0) continue;
            b[pos[k]] = v[k];
            ch |= o[k];
        }
    }
    return ch;
}

// One relaxation src -> dst (src null: the seeds). Returns this thread's
// "changed" (the caller reduces it over the block).
__device__ int relax(const TileArgs& t, const int* src, int* dst, int conn) {
    rows_pass(t, src, dst);
    __syncthreads();
    int ch = cols_pass(t, dst, src, conn == 1);
    if (conn == 2) {
        __syncthreads();
        const int dys[4] = {1, 1, -1, -1}, dxs[4] = {1, -1, 1, -1};
        int* a = dst;
        int* b = t.tmp2;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            ch = diag_pass(t, a, b, dys[k], dxs[k], src, k == 3);
            __syncthreads();
            int* s = a;
            a = b;
            b = s;
        }  // four steps: the result is back in dst
    }
    return ch;
}

__global__ void __launch_bounds__(kThreads)
cc_tile_kernel(const uint8_t* __restrict__ mask, const int* seeds, const int* prev, int* out,
               int* tmp, int* tmp2, int* flag, long long* counters, int th, int tw, int ld,
               long long batch_stride, int seed_w, int conn, int max_iters) {
    const long long base = blockIdx.z * batch_stride +
                           static_cast<long long>(blockIdx.y) * th * ld +
                           static_cast<long long>(blockIdx.x) * tw;
    TileArgs t;
    t.mask = mask + base;
    t.seeds = seeds != nullptr ? seeds + base : nullptr;
    t.prev = prev != nullptr ? prev + base : nullptr;
    t.out = out + base;
    t.tmp = tmp + base;
    t.tmp2 = tmp2 + base;
    t.th = th;
    t.tw = tw;
    t.ld = ld;
    t.row0 = blockIdx.y * th;
    t.col0 = blockIdx.x * tw;
    t.seed_w = seed_w;

    int* cur = t.out;
    int* nxt = t.tmp;
    int changed = __syncthreads_or(relax(t, nullptr, cur, conn));
    int relaxes = 1;
    for (int i = 0; changed && i < max_iters; ++i) {
        changed = __syncthreads_or(relax(t, cur, nxt, conn));
        ++relaxes;
        int* s = cur;
        cur = nxt;
        nxt = s;
    }

    // the result into out, and whether it differs from prev
    int diff = 0;
    if (cur != t.out || t.prev != nullptr) {
        const int n = th * tw;
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int y = i / tw, x = i - y * tw;
            const int p = y * ld + x;
            const int v = cur[p];
            if (cur != t.out) t.out[p] = v;
            if (t.prev != nullptr && v != t.prev[p]) diff = 1;
        }
    }
    diff = __syncthreads_or(diff);
    if (threadIdx.x == 0) {
        if (diff && flag != nullptr) atomicExch(flag, 1);
        if (counters != nullptr) {
            atomicAdd(reinterpret_cast<unsigned long long*>(counters),
                      static_cast<unsigned long long>(relaxes));
            if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
                atomicAdd(reinterpret_cast<unsigned long long*>(counters + 1), 1ull);
        }
    }
}

// maskp = mask padded with background to (ph, pw); seeds = y * w + x on the
// foreground, INF elsewhere
__global__ void cc_seed_kernel(const uint8_t* __restrict__ mask, uint8_t* __restrict__ maskp,
                               int* __restrict__ seeds, int h, int w, int ph, int pw) {
    const long long n = static_cast<long long>(ph) * pw;
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        const int y = static_cast<int>(i / pw), x = static_cast<int>(i % pw);
        const bool fg = y < h && x < w && mask[static_cast<long long>(y) * w + x];
        maskp[i] = fg ? 1 : 0;
        seeds[i] = fg ? y * w + x : kInf;
    }
}

// out = where(mask, min(lbl, its 4 or 8 neighbours), INF) over the whole
// padded mask (INF beyond it)
__global__ void cc_border_min_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ lbl,
                                     int* __restrict__ out, int ph, int pw, int conn) {
    const long long n = static_cast<long long>(ph) * pw;
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        int v = kInf;
        if (mask[i]) {
            const int y = static_cast<int>(i / pw), x = static_cast<int>(i % pw);
            v = lbl[i];
            for (int dy = -1; dy <= 1; ++dy) {
                const int yy = y + dy;
                if (yy < 0 || yy >= ph) continue;
                for (int dx = -1; dx <= 1; ++dx) {
                    if ((dy == 0 && dx == 0) || (conn == 1 && dy != 0 && dx != 0)) continue;
                    const int xx = x + dx;
                    if (xx < 0 || xx >= pw) continue;
                    v = min(v, lbl[static_cast<long long>(yy) * pw + xx]);
                }
            }
        }
        out[i] = v;
    }
}

int grid_for(long long n) {
    const long long blocks = (n + 255) / 256;
    return static_cast<int>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace

// K6. mask (B, H, W) uint8; out, tmp, tmp2 (B, H, W) int32; counters
// (relaxations, rounds) int64 or null.
PGM_EXPORT int cc_label_batch_launch(const void* mask, void* out, void* tmp, void* tmp2,
                                     void* counters, int b, int h, int w, int conn,
                                     int max_iters, void* stream) {
    if (b <= 0 || h <= 0 || w <= 0 || (conn != 1 && conn != 2) || max_iters < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cc_tile_kernel<<<dim3(1, 1, b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mask), nullptr, nullptr, static_cast<int*>(out),
        static_cast<int*>(tmp), static_cast<int*>(tmp2), nullptr,
        static_cast<long long*>(counters), h, w, w, static_cast<long long>(h) * w, w, conn,
        max_iters);
    return static_cast<int>(cudaGetLastError());
}

// K5, first launch: mask (h, w) uint8 -> maskp (ph, pw) uint8, seeds (ph, pw).
PGM_EXPORT int cc_seed_launch(const void* mask, void* maskp, void* seeds, int h, int w, int ph,
                              int pw, void* stream) {
    cc_seed_kernel<<<grid_for(static_cast<long long>(ph) * pw), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(maskp),
        static_cast<int*>(seeds), h, w, ph, pw);
    return static_cast<int>(cudaGetLastError());
}

// K5, one round's propagate: the fixpoint in every tile of (ph, pw) from
// seeds into out (tmp, tmp2: scratch); flag = 1 if out differs from prev
// (prev null: flag left 0).
PGM_EXPORT int cc_propagate_launch(const void* maskp, const void* seeds, const void* prev,
                                   void* out, void* tmp, void* tmp2, void* flag, void* counters,
                                   int ph, int pw, int tile, int conn, int max_iters,
                                   void* stream) {
    if (tile <= 0 || ph % tile || pw % tile || (conn != 1 && conn != 2) || max_iters < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    cc_tile_kernel<<<dim3(pw / tile, ph / tile, 1), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(maskp), static_cast<const int*>(seeds),
        static_cast<const int*>(prev), static_cast<int*>(out), static_cast<int*>(tmp),
        static_cast<int*>(tmp2), static_cast<int*>(flag), static_cast<long long*>(counters),
        tile, tile, pw, 0, 0, conn, max_iters);
    return static_cast<int>(cudaGetLastError());
}

// K5, the border-min exchange: lbl (ph, pw) -> out (ph, pw).
PGM_EXPORT int cc_border_min_launch(const void* maskp, const void* lbl, void* out, int ph, int pw,
                                    int conn, void* stream) {
    cc_border_min_kernel<<<grid_for(static_cast<long long>(ph) * pw), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(maskp), static_cast<const int*>(lbl), static_cast<int*>(out),
        ph, pw, conn);
    return static_cast<int>(cudaGetLastError());
}
