// The HoverNeXt decoder conv kernel for the H100.
//
// Replaces one TPU kernel of path_gene_multimodal_tpu/ops/pallas/decoder.py
// (the final-stage kernels are csrc/upsample_conv.cu, K9 and K10, and
// csrc/conv64.cu, K8 and K11):
//   K7  fused_decoder_conv     (:168, pallas_call :220): skip concat by split
//       weights + 3x3 SAME conv + bias + LayerNorm (eps 1e-6, two-pass
//       variance) + GELU -> bf16.
//
// Numerics follow the TPU kernel: bf16 inputs, weights and vectors, f32
// accumulation, bf16 outputs. GELU by flag (pgm_gelu: tanh, or the
// Abramowitz-Stegun erf of the TPU kernel).
//
// What bounds it here: operations. At HoverNeXt-tiny widths the convs do
// 9 * cin * cout multiply-adds per output pixel, 5.7 TFLOP per 512-image
// batch over the 8 calls.
//
// Design: an implicit GEMM. A block owns BM consecutive output pixels of one
// image and ALL cout channels (cout <= 384), so the epilogue sees whole pixel
// rows: the LayerNorm over cout needs no second pass. K runs over (source,
// tap, 32-channel chunk); each step stages a BM x 32 input tile and a
// 32 x cout weight tile in shared memory with
// cp.async (a ring of three: the next two steps' copies fly while this
// step's bf16 wmma products run, one barrier per step). Zero padding is
// cp.async's zero fill. K7's second source (the skip) reads its weight rows
// at an offset of cx inside the one (3, 3, cx + cs, cout) tensor, so the
// concat is never built. The epilogue stages the f32 accumulators
// through shared memory (64 x 384 x 4 = 96 KB at K7 dec0, above the 48 KB
// default, hence the dynamic shared memory attribute), one warp per pixel.
// All offsets into activations are 64-bit. Not yet here: wgmma, TMA, a
// persistent schedule.
#include "common.cuh"

#include <climits>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;        // input channels per K step
constexpr int kLdA = kBK + 8;  // shared row stride of the input tile (bf16)
constexpr int kStages = 3;     // cp.async ring depth

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

struct Src {
    const bf16* x;  // NHWC
    int cin;
    int row0;       // first weight row of this source within a tap
};

struct ConvArgs {
    Src src[2];
    int nsrc;
    const bf16* w;    // (3, 3, ktap, cout): row tap * ktap + row0 + ci
    int ktap;
    int h, w_;        // conv (output) spatial size
    const bf16* bias;                  // (cout,)
    const bf16* lng;  const bf16* lnb;  // (cout,) LayerNorm, or null
    bf16* out;        // (B, h, w_, cout)
    int exact;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = ok ? 16 : 0;  // 0: zero-fill the 16 bytes
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN>
struct Smem {
    static constexpr int kLdB = BN + 8;  // bf16
    static constexpr int kLdE = BN + 4;  // f32
    static constexpr size_t a_bytes = size_t(BM) * kLdA * 2;
    static constexpr size_t b_bytes = size_t(kBK) * kLdB * 2;
    static constexpr size_t pipe = kStages * (a_bytes + b_bytes);
    static constexpr size_t e_bytes = size_t(BM) * kLdE * 4;
    // the pipeline ring, later the f32 epilogue tile
    static constexpr size_t total = align128(pipe > e_bytes ? pipe : e_bytes);
};

// WM x WN warps, each owning FM x FN 16x16 accumulator tiles: the block
// covers BM = 16 FM WM pixels and BN = 16 FN WN = cout channels.
template <int WM, int WN, int FM, int FN>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(const ConvArgs a) {
    constexpr int BM = 16 * FM * WM;
    constexpr int BN = 16 * FN * WN;
    using S = Smem<BM, BN>;
    static_assert(WM * WN == kWarps, "8 warps");
    extern __shared__ __align__(128) unsigned char smem[];
    // stage i: input tile at i * (a + b) bytes, weight tile right after it
    auto As = [&](int i) {
        return reinterpret_cast<bf16*>(smem + i * (S::a_bytes + S::b_bytes));
    };
    auto Bs = [&](int i) {
        return reinterpret_cast<bf16*>(smem + i * (S::a_bytes + S::b_bytes) + S::a_bytes);
    };
    float* E = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp / WN, wn = warp % WN;
    const int hw = a.h * a.w_;
    const int tiles = (hw + BM - 1) / BM;
    const long long img = blockIdx.x / tiles;
    const int p0 = (blockIdx.x % tiles) * BM;

    const int nsteps = 9 * (a.src[0].cin / kBK) + (a.nsrc > 1 ? 9 * (a.src[1].cin / kBK) : 0);

    // The thread's input-tile chunks: rows tid/4 + 64 j, channels c8..c8+7 of
    // each step; their pixels' (y, x), y = INT_MIN/2 past the image's end.
    constexpr int kAPer = BM * (kBK / 8) / kThreads;
    static_assert(kAPer * kThreads == BM * (kBK / 8), "whole input-tile chunks per thread");
    const int c8 = (tid % (kBK / 8)) * 8;
    int py[kAPer], px[kAPer];
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
        const int p = p0 + tid / (kBK / 8) + j * (kThreads / (kBK / 8));
        py[j] = p < hw ? p / a.w_ : INT_MIN / 2;
        px[j] = p % a.w_;
    }

    // the next step to load: source, tap, first channel; advanced per load
    // (fields picked without indexing the parameter struct, which would
    // copy it to local memory)
    const bf16* lx = a.src[0].x;
    int lcin = a.src[0].cin, lrow0 = a.src[0].row0, ltap = 0, lk0 = 0;

    auto load_next = [&](int buf) {
        const int dy = ltap / 3 - 1, dx = ltap % 3 - 1;
#pragma unroll
        for (int j = 0; j < kAPer; ++j) {
            const int r = tid / (kBK / 8) + j * (kThreads / (kBK / 8));
            const int y = py[j] + dy, x = px[j] + dx;
            const bool ok = y >= 0 && y < a.h && x >= 0 && x < a.w_;
            bf16* dst = As(buf) + r * kLdA + c8;
            const bf16* g = ok ? lx + ((img * a.h + y) * a.w_ + x) * lcin + lk0 + c8 : lx;
            cp_async16(dst, g, ok);
        }
        const bf16* wrow = a.w + (static_cast<size_t>(ltap) * a.ktap + lrow0 + lk0) * BN;
        for (int i = tid; i < kBK * (BN / 8); i += kThreads) {
            const int r = i / (BN / 8), cb8 = (i % (BN / 8)) * 8;
            cp_async16(Bs(buf) + r * S::kLdB + cb8, wrow + static_cast<size_t>(r) * BN + cb8, true);
        }
        lk0 += kBK;
        if (lk0 == lcin) {
            lk0 = 0;
            if (++ltap == 9) {  // on to the second source (K7's skip)
                ltap = 0;
                lx = a.src[1].x;
                lcin = a.src[1].cin;
                lrow0 = a.src[1].row0;
            }
        }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // one commit group per step (empty past the end), so that waiting for
    // all but the newest group leaves this step's tiles complete
    for (int i = 0; i < kStages - 1; ++i) {
        if (i < nsteps) load_next(i);
        cp_async_commit();
    }
    for (int step = 0; step < nsteps; ++step) {
        const int buf = step % kStages;
        cp_async_wait<kStages - 2>();
        // also: every warp is done with the stage the next load overwrites
        __syncthreads();
        if (step + kStages - 1 < nsteps) load_next((step + kStages - 1) % kStages);
        cp_async_commit();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
            for (int i = 0; i < FM; ++i)
                wmma::load_matrix_sync(af[i], As(buf) + (wm * FM + i) * 16 * kLdA + kk * 16, kLdA);
#pragma unroll
            for (int j = 0; j < FN; ++j)
                wmma::load_matrix_sync(bfr[j], Bs(buf) + kk * 16 * S::kLdB + (wn * FN + j) * 16,
                                       S::kLdB);
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring becomes the epilogue tile

    // epilogue: f32 tile -> bias [-> LN] -> GELU, one warp per pixel
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
            wmma::store_matrix_sync(E + (wm * FM + i) * 16 * S::kLdE + (wn * FN + j) * 16,
                                    acc[i][j], S::kLdE, wmma::mem_row_major);
    __syncthreads();
    constexpr int PER = BN / 32;
    for (int r = warp; r < BM; r += kWarps) {
        const int p = p0 + r;
        if (p >= hw) continue;
        float v[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int ch = lane + 32 * k;
            v[k] = E[r * S::kLdE + ch] + __bfloat162float(a.bias[ch]);
        }
        if (a.lng != nullptr) {
            float s = 0.0f;
#pragma unroll
            for (int k = 0; k < PER; ++k) s += v[k];
            for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            const float mu = s / BN;
            float q = 0.0f;
#pragma unroll
            for (int k = 0; k < PER; ++k) q += (v[k] - mu) * (v[k] - mu);
            for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
            const float rs = rsqrtf(q / BN + 1e-6f);
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int ch = lane + 32 * k;
                v[k] = (v[k] - mu) * rs * __bfloat162float(a.lng[ch]) +
                       __bfloat162float(a.lnb[ch]);
            }
        }
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int ch = lane + 32 * k;
            a.out[(img * hw + p) * BN + ch] = __float2bfloat16(pgm_gelu(v[k], a.exact));
        }
    }
}

template <int WM, int WN, int FM, int FN>
cudaError_t run(const ConvArgs& a, int batch, cudaStream_t st) {
    constexpr int BM = 16 * FM * WM;
    const size_t smem = Smem<BM, 16 * FN * WN>::total;
    auto kernel = conv3x3_kernel<WM, WN, FM, FN>;
    cudaError_t e = pgm_set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const long long blocks = static_cast<long long>(batch) * ((a.h * a.w_ + BM - 1) / BM);
    if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(a);
    return cudaGetLastError();
}

// Tile shapes by cout (the block holds all of cout): 64 x 384, 64 x 192,
// 128 x 96, 128 x 64 pixels x channels.
cudaError_t dispatch(const ConvArgs& a, int batch, int cout, cudaStream_t st) {
    for (int s = 0; s < a.nsrc; ++s)
        if (a.src[s].cin <= 0 || a.src[s].cin % kBK) return cudaErrorInvalidValue;
    switch (cout) {
        case 384: return run<1, 8, 4, 3>(a, batch, st);
        case 192: return run<2, 4, 2, 3>(a, batch, st);
        case 96: return run<4, 2, 2, 3>(a, batch, st);
        case 64: return run<4, 2, 2, 2>(a, batch, st);
        default: return cudaErrorInvalidValue;
    }
}

ConvArgs args(const void* x, int cin, const void* w, const void* b, void* out, int h, int w_,
              int exact) {
    ConvArgs a{};
    a.src[0] = Src{static_cast<const bf16*>(x), cin, 0};
    a.nsrc = 1;
    a.w = static_cast<const bf16*>(w);
    a.ktap = cin;
    a.h = h;
    a.w_ = w_;
    a.bias = static_cast<const bf16*>(b);
    a.out = static_cast<bf16*>(out);
    a.exact = exact;
    return a;
}

}  // namespace

// K7. x (B, H, W, cx), skip (B, H, W, cs) or null with cs = 0, w (3, 3,
// cx + cs, cout), vectors (cout,), ln_scale/ln_bias null for no LayerNorm;
// out (B, H, W, cout). All bf16.
PGM_EXPORT int decoder_conv_launch(const void* x, const void* skip, const void* w, const void* b,
                                   const void* lng, const void* lnb, void* out, int batch, int h,
                                   int w_, int cx, int cs, int cout, int exact, void* stream) {
    ConvArgs a = args(x, cx, w, b, out, h, w_, exact);
    if (cs > 0) {
        a.src[1] = Src{static_cast<const bf16*>(skip), cs, cx};
        a.nsrc = 2;
    }
    a.ktap = cx + cs;
    a.lng = static_cast<const bf16*>(lng);
    a.lnb = static_cast<const bf16*>(lnb);
    return static_cast<int>(dispatch(a, batch, cout, static_cast<cudaStream_t>(stream)));
}
