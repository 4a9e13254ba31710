// Marker watershed flood (synchronous level-set growth), per tile, for the
// H100.
//
// Replaces the TPU kernel `pallas_marker_watershed`
// (path_gene_multimodal_tpu/ops/pallas/flood.py:131, pallas_call at :147).
//
// Contract (identical outputs): quantise dist to q = clip(int(dist * 63),
// 0, 63); for each level from 63 down to 0, phase 1 grows the established
// fronts (excluding markers whose own q equals the level), phase 2 grows
// all; a phase is a run of SYNCHRONOUS steps -- an unlabeled pixel inside
// mask & (q >= level) takes the minimum label among its 8 neighbours that
// were labeled before the step and have q >= level (and are not fresh
// markers in phase 1) -- of at most 1 + max_rounds steps (= 65, the Pallas
// kernel's count; the XLA flood of the JAX package runs 64), ending early at
// a fixpoint. Labels are any int32 < INF = 2^30 (dense ids or min-index
// labels); INF marks unlabeled pixels.
//
// Synchronous means double-buffered: an in-place update would let a label
// cross several pixels in one step (Gauss-Seidel) and would change which
// front wins a plateau (ops/watershed.py:119-123 of the JAX package).
//
// What bounds it here: the step count. Every tile runs at least 128 steps
// (64 levels x 2 phases), each a barrier plus a sweep over 65,536 pixels;
// the bytes per step are the label buffers and a 1-byte code per pixel.
//
// Design (first version): one block per tile, 1024 threads, the two label
// buffers (int32, 2 x 256 KB per tile) and the packed per-pixel code
// (q | mask << 6 | marker << 7) in global memory, where one tile's state
// stays in L2 between steps; __syncthreads plus a shared "changed" flag end
// each step. Keeping the state in shared memory (uint16 ids) or splitting a
// tile over a thread-block cluster is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kInf = 1 << 30;
constexpr uint8_t kMask = 1u << 6;
constexpr uint8_t kMarker = 1u << 7;

__global__ void __launch_bounds__(kThreads)
flood_kernel(const float* __restrict__ dist, const int* __restrict__ markers,
             const uint8_t* __restrict__ mask, int* __restrict__ out,
             int* __restrict__ scratch, uint8_t* __restrict__ code, int h, int w,
             int levels, int max_rounds) {
    __shared__ int changed;
    const int b = blockIdx.x;
    const int n = h * w;
    const long long base = static_cast<long long>(b) * n;
    int* cur = out + base;
    int* nxt = scratch + base;
    uint8_t* cd = code + base;

    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int q = static_cast<int>(dist[base + p] * static_cast<float>(levels - 1));
        q = min(max(q, 0), levels - 1);
        const int m = markers[base + p];
        const bool is_marker = m < kInf;
        cd[p] = static_cast<uint8_t>(q) | (mask[base + p] ? kMask : 0) |
                (is_marker ? kMarker : 0);
        cur[p] = is_marker ? m : kInf;
    }
    __syncthreads();

    for (int level = levels - 1; level >= 0; --level) {
        for (int phase = 0; phase < 2; ++phase) {
            int steps = 0;
            while (true) {
                if (threadIdx.x == 0) changed = 0;
                __syncthreads();
                int ch = 0;
                for (int p = threadIdx.x; p < n; p += blockDim.x) {
                    int v = cur[p];
                    if (v == kInf) {
                        const uint8_t c = cd[p];
                        if ((c & kMask) && (c & 63) >= level) {
                            const int r = p / w, col = p % w;
                            int best = kInf;
                            for (int dy = -1; dy <= 1; ++dy) {
                                const int rr = r + dy;
                                if (rr < 0 || rr >= h) continue;
                                for (int dx = -1; dx <= 1; ++dx) {
                                    const int cc = col + dx;
                                    if ((dy == 0 && dx == 0) || cc < 0 || cc >= w) continue;
                                    const int np = rr * w + cc;
                                    const int ln = cur[np];
                                    if (ln >= best) continue;
                                    const uint8_t cn = cd[np];
                                    const int qn = cn & 63;
                                    if (qn < level) continue;
                                    if (phase == 0 && (cn & kMarker) && qn == level) continue;
                                    best = ln;
                                }
                            }
                            if (best < kInf) {
                                v = best;
                                ch = 1;
                            }
                        }
                    }
                    nxt[p] = v;
                }
                if (ch) changed = 1;
                __syncthreads();
                int* t = cur;
                cur = nxt;
                nxt = t;
                ++steps;
                const int again = changed;
                __syncthreads();
                if (!again || steps >= 1 + max_rounds) break;
            }
        }
    }
    if (cur != out + base) {
        for (int p = threadIdx.x; p < n; p += blockDim.x) out[base + p] = cur[p];
    }
}

}  // namespace

PGM_EXPORT int flood_launch(const void* dist, const void* markers, const void* mask,
                            void* out, void* scratch, void* code, int b, int h, int w,
                            int levels, int max_rounds, void* stream) {
    flood_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dist), static_cast<const int*>(markers),
        static_cast<const uint8_t*>(mask), static_cast<int*>(out),
        static_cast<int*>(scratch), static_cast<uint8_t*>(code), h, w, levels,
        max_rounds);
    return static_cast<int>(cudaGetLastError());
}
