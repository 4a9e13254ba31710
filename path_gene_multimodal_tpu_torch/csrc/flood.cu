// Marker watershed flood (synchronous level-set growth), per tile, for the
// H100.
//
// Replaces the TPU kernel `pallas_marker_watershed`
// (path_gene_multimodal_tpu/ops/pallas/flood.py:131, pallas_call at :147).
//
// Contract (identical outputs): quantise dist to q = clip(int(dist * (levels
// - 1)), 0, levels - 1); for each level from levels - 1 down to 0, phase 0
// grows the established fronts (excluding markers whose own q equals the
// level), phase 1 grows all; a phase is a run of SYNCHRONOUS steps -- an
// unlabeled pixel inside mask & (q >= level) takes the minimum label among
// its 8 neighbours that were labeled before the step and have q >= level
// (and are not fresh markers in phase 0) -- of at most 1 + max_rounds steps
// (= 65, the Pallas kernel's count; the XLA flood of the JAX package runs
// 64), ending after the first step that changes nothing. Labels are any int32
// < INF = 2^30 (dense ids or min-index labels); INF marks unlabeled pixels.
//
// What bounds it: the steps. Every tile runs at least 2 * levels of them,
// each a test of every pixel and a barrier; the bytes (dist, markers and
// mask in, labels out) are ~13 per pixel once.
//
// Design: one block per tile; the tile's state as 1-bit planes (a 32-bit
// word holds 32 pixels of a row; a row takes ceil(W / 32) words whose bits
// past W stay 0 in every plane): q as nq bit-slices (6 up to 64 levels, the
// instantiation the main path runs; else the bit length of levels - 1, up
// to 31, in an instantiation that takes nq at run time), mask, marker,
// labelled, U = eligible & ~labelled, and the active plane A = labelled & (q
// >= level) (minus fresh markers in phase 0), double-buffered. A step computes, a word
// at a time, cand = U & dilate8(A) with shifts that carry bits across words,
// and only the set bits of cand read labels: the min over their active
// neighbours, whose labels (in `out`, the one label buffer) never change
// during the step, since growth only turns INF into a label. So the label
// buffer is touched where pixels grow, not in every step. A grows by cand
// into the other buffer (an in-place update would let a label cross several
// pixels in one step); __syncthreads_or ends the step and gives the "changed"
// flag. At 256^2 the 12 planes of 64 levels take 96 KB of shared memory; a
// tile whose planes do not fit keeps them in global memory (`scratch`),
// same code.
// Geometry: ops/flood.py::FloodTiling; the launcher refuses any other.
//
// counts (int64[3], optional): += steps of every tile, max= steps of one
// tile, += pixels grown.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kInf = 1 << 30;
constexpr int kMaxSlices = 31;  // q's bit-slices: levels - 1 < 2^31
// plane order: q bit-slices 0..nq-1, mask, marker, labelled, U, A (two
// buffers); nq is 6 for levels <= 64 (the main path's instantiation, NQ = 6)
// and (levels - 1)'s bit length above (NQ = 0: nq a runtime argument)

// Horizontal 3-dilation of a row word, bits carried in from its neighbours.
__device__ __forceinline__ uint32_t hdil(uint32_t l, uint32_t m, uint32_t r) {
    return m | (m << 1) | (l >> 31) | (m >> 1) | (r << 31);
}

// Bit (b + dx) of the row whose words are l, m, r (dx in -1..1).
__device__ __forceinline__ bool bit_at(uint32_t l, uint32_t m, uint32_t r, int b, int dx) {
    const int bb = b + dx;
    if (bb < 0) return l >> 31;
    if (bb > 31) return r & 1u;
    return (m >> bb) & 1u;
}

template <bool kShared, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
flood_kernel(const float* __restrict__ dist, const int* __restrict__ markers,
             const uint8_t* __restrict__ mask, int* out, uint32_t* scratch,
             long long* counts, int h, int w, int wpr, int levels, int max_rounds, int nq_arg) {
    extern __shared__ __align__(16) uint32_t smem_planes[];
    const int nq = NQ ? NQ : nq_arg;
    const int kMask = nq, kMarker = nq + 1, kLab = nq + 2, kUnl = nq + 3, kAct = nq + 4;
    const int words = h * wpr;
    uint32_t* planes = kShared ? smem_planes
                               : scratch + static_cast<size_t>(blockIdx.x) * (nq + 6) * words;
    auto plane = [&](int i) { return planes + static_cast<size_t>(i) * words; };
    const long long base = static_cast<long long>(blockIdx.x) * h * w;
    int* lbl = out + base;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int kWarps = kThreads / 32;

    // planes from the inputs: one warp per row word, a lane per pixel, a
    // ballot per plane; labels start as the markers (INF elsewhere)
    for (int k = warp; k < words; k += kWarps) {
        const int r = k / wpr, c = (k - r * wpr) * 32 + lane;
        int q = 0;
        bool m = false, mk = false;
        if (c < w) {
            const long long p = base + static_cast<long long>(r) * w + c;
            q = static_cast<int>(dist[p] * static_cast<float>(levels - 1));
            q = min(max(q, 0), levels - 1);
            m = mask[p] != 0;
            const int v = markers[p];
            mk = v < kInf;
            lbl[p - base] = mk ? v : kInf;
        }
        if constexpr (NQ == 6) {
            // lane i < 8 keeps plane i's word, lane 8 the labelled one (the
            // markers), lane 9 zeroes A
            uint32_t mine = 0u;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const bool bit = i < 6 ? (q >> i) & 1 : (i == kMask ? m : mk);
                const uint32_t word = __ballot_sync(0xffffffffu, bit);
                if (lane == i || (lane == kLab && i == kMarker)) mine = word;
            }
            if (lane < 9) plane(lane == 8 ? kLab : lane)[k] = mine;
            if (lane == 9) plane(kAct)[k] = 0u;
        } else {
            // up to 33 planes: lane 0 writes each ballot's word, lane 1 the
            // labelled one (the markers), lane 2 zeroes A
            for (int i = 0; i < nq + 2; ++i) {
                const bool bit = i < nq ? (q >> i) & 1 : (i == kMask ? m : mk);
                const uint32_t word = __ballot_sync(0xffffffffu, bit);
                if (lane == 0) plane(i)[k] = word;
                if (lane == 1 && i == kMarker) plane(kLab)[k] = word;
            }
            if (lane == 2) plane(kAct)[k] = 0u;
        }
    }
    __syncthreads();

    // this thread's words: k = threadIdx.x + i * kThreads, (row, word) kept
    // incrementally
    const int r0 = threadIdx.x / wpr, j0 = threadIdx.x - r0 * wpr;
    const int dr = kThreads / wpr, dj = kThreads - dr * wpr;
    int steps_total = 0;
    unsigned grown = 0;
    int cur = 0;  // the A buffer the next step reads

    for (int level = levels - 1; level >= 0; --level) {
        for (int phase = 0; phase < 2; ++phase) {
            // phase start: fold the last phase's growth into labelled, then
            // A = labelled & K and U = eligible & ~labelled, K = q >= level
            // (minus fresh markers, q == level, in phase 0)
            for (int k = threadIdx.x; k < words; k += kThreads) {
                uint32_t ge = ~0u, eq = ~0u;
#pragma unroll
                for (int b = 0; b < (NQ ? NQ : kMaxSlices); ++b) {
                    if (!NQ && b >= nq) break;
                    const uint32_t qb = plane(b)[k];
                    const bool one = (level >> b) & 1;
                    ge = one ? (qb & ge) : (qb | ge);
                    eq &= one ? qb : ~qb;
                }
                const uint32_t lab = plane(kLab)[k] | plane(kAct + cur)[k];
                const uint32_t fresh = plane(kMarker)[k] & eq;
                const uint32_t keep = phase == 0 ? (ge & ~fresh) : ge;
                plane(kLab)[k] = lab;
                plane(kAct)[k] = lab & keep;
                plane(kUnl)[k] = plane(kMask)[k] & ge & ~lab;
            }
            cur = 0;
            __syncthreads();

            int steps = 0;
            while (true) {
                const uint32_t* A = plane(kAct + cur);
                uint32_t* An = plane(kAct + 1 - cur);
                uint32_t* U = plane(kUnl);
                int any = 0;
                int r = r0, j = j0;
                for (int k = threadIdx.x; k < words; k += kThreads) {
                    const uint32_t u = U[k], am = A[k];
                    uint32_t cand = 0;
                    if (u) {
                        const bool left = j > 0, right = j + 1 < wpr;
                        const bool up = r > 0, down = r + 1 < h;
                        const uint32_t al = left ? A[k - 1] : 0u, ar = right ? A[k + 1] : 0u;
                        const uint32_t ul = up && left ? A[k - wpr - 1] : 0u;
                        const uint32_t um = up ? A[k - wpr] : 0u;
                        const uint32_t ur = up && right ? A[k - wpr + 1] : 0u;
                        const uint32_t dl = down && left ? A[k + wpr - 1] : 0u;
                        const uint32_t dm = down ? A[k + wpr] : 0u;
                        const uint32_t dr_ = down && right ? A[k + wpr + 1] : 0u;
                        cand = u & (hdil(ul, um, ur) | hdil(al, am, ar) | hdil(dl, dm, dr_));
                        if (cand) {
                            U[k] = u & ~cand;
                            any = 1;
                            grown += __popc(cand);
                            for (uint32_t bits = cand; bits; bits &= bits - 1) {
                                const int b = __ffs(bits) - 1;
                                const int c = j * 32 + b;
                                int best = kInf;
#pragma unroll
                                for (int dy = -1; dy <= 1; ++dy) {
                                    const uint32_t wl = dy < 0 ? ul : (dy == 0 ? al : dl);
                                    const uint32_t wm = dy < 0 ? um : (dy == 0 ? am : dm);
                                    const uint32_t wr = dy < 0 ? ur : (dy == 0 ? ar : dr_);
#pragma unroll
                                    for (int dx = -1; dx <= 1; ++dx) {
                                        if ((dy || dx) && bit_at(wl, wm, wr, b, dx))
                                            best = min(best, lbl[(r + dy) * w + c + dx]);
                                    }
                                }
                                lbl[r * w + c] = best;
                            }
                        }
                    }
                    An[k] = am | cand;
                    r += dr;
                    j += dj;
                    if (j >= wpr) {
                        j -= wpr;
                        ++r;
                    }
                }
                cur ^= 1;
                ++steps;
                const int changed = __syncthreads_or(any);
                if (!changed || steps >= 1 + max_rounds) break;
            }
            steps_total += steps;
        }
    }

    if (counts != nullptr) {
        const unsigned g = __reduce_add_sync(0xffffffffu, grown);
        if (lane == 0 && g) atomicAdd(reinterpret_cast<unsigned long long*>(counts + 2), g);
        if (threadIdx.x == 0) {
            atomicAdd(reinterpret_cast<unsigned long long*>(counts), steps_total);
            atomicMax(counts + 1, static_cast<long long>(steps_total));
        }
    }
}

// q's bit-slices at `levels` levels: 6 up to 64 levels (the NQ = 6
// instantiation), else the bit length of levels - 1
int slices(int levels) {
    int n = 0;
    while (n < kMaxSlices && (levels - 1) >> n) ++n;
    return levels <= 64 ? 6 : n;
}

size_t plane_bytes(int h, int w, int nq) {
    return static_cast<size_t>(nq + 6) * h * ((w + 31) / 32) * 4;
}

template <int NQ>
cudaError_t run(const float* d, const int* mk, const uint8_t* m, int* o, uint32_t* sc,
                long long* cn, int b, int h, int w, int wpr, int levels, int max_rounds, int nq,
                int smem, cudaStream_t st) {
    if (smem) {
        cudaError_t e = pgm_set_smem(flood_kernel<true, NQ>, smem);
        if (e != cudaSuccess) return e;
        flood_kernel<true, NQ><<<b, kThreads, smem, st>>>(d, mk, m, o, sc, cn, h, w, wpr, levels,
                                                          max_rounds, nq);
    } else {
        flood_kernel<false, NQ><<<b, kThreads, 0, st>>>(d, mk, m, o, sc, cn, h, w, wpr, levels,
                                                        max_rounds, nq);
    }
    return cudaGetLastError();
}

}  // namespace

// dist (B, H, W) f32, markers (B, H, W) int32 (>= INF: none), mask (B, H, W)
// uint8; out (B, H, W) int32. threads, wpr, planes, smem: the launch
// geometry of ops/flood.py::FloodTiling (planes = q's slices + 6; smem 0:
// the planes in `scratch`, planes * H * wpr words per tile).
PGM_EXPORT int flood_launch(const void* dist, const void* markers, const void* mask, void* out,
                            void* scratch, void* counts, int b, int h, int w, int levels,
                            int max_rounds, int threads, int wpr, int planes, int smem,
                            void* stream) {
    const int nq = levels >= 1 ? slices(levels) : 0;
    if (threads != kThreads || wpr != (w + 31) / 32 || b <= 0 || h <= 0 || w <= 0 ||
        levels < 1 || max_rounds < 0 || planes != nq + 6 ||
        (smem != 0 && static_cast<size_t>(smem) != plane_bytes(h, w, nq)) ||
        (smem == 0 && scratch == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* d = static_cast<const float*>(dist);
    const int* mk = static_cast<const int*>(markers);
    const uint8_t* m = static_cast<const uint8_t*>(mask);
    int* o = static_cast<int*>(out);
    uint32_t* sc = static_cast<uint32_t*>(scratch);
    long long* cn = static_cast<long long*>(counts);
    return static_cast<int>(nq == 6 ? run<6>(d, mk, m, o, sc, cn, b, h, w, wpr, levels, max_rounds,
                                             nq, smem, st)
                                    : run<0>(d, mk, m, o, sc, cn, b, h, w, wpr, levels, max_rounds,
                                             nq, smem, st));
}
