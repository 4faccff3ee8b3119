// Flash attention at head dims past 128, forward and backward, on the CUDA
// cores: plain C entry points for ctypes.
//
// K1, K2 and K3 (flash_fwd.cu, flash_bwd.cu) are tensor-core kernels with
// the head dim a template parameter up to 128, their accumulators in
// registers; the wrappers pad a head dim d <= 128 to the next instance. The
// Pallas kernels they replace (`multimodal_eeg_fmri_tpu/ops/attention.py`,
// pallas_call at :248, :311 and :339) pad D to the next multiple of 128 and
// so take any D. These three kernels compute the same functions at any D
// above 128 (the true D, unpadded); the wrappers send them head dims past
// 256, and those in (128, 256] to the tensor-core kernels of
// flash_fwd_split.cu and flash_bwd_split.cu:
// - mmef_flash_fwd_wide (K1's function): O = softmax(Q K^T * scale) V and
//   lse, by online softmax (running max m, sum l, accumulator) over key tiles;
// - mmef_flash_bwd_dq_wide (K3's): dQ = dS K * scale;
// - mmef_flash_bwd_dkv_wide (K2's): dV = P^T dO, dK = dS^T Q * scale;
// with P = exp(S - lse) and dS = P * (dO V^T - Delta), Delta = rowsum(dO * O)
// - g_lse from the caller, as in flash_bwd.cu. f32 mode scales q before the
// forward's dot and every backward dot after it, as K1-K3 do; BF16_OPS rounds
// the product operands (q, k, v, dO, and p, dS) to bf16 and sums in f32.
//
// Design: one warp per output row (a query row for the forward and dQ, a key
// row for dK/dV), `warps` rows a block, grid (B*H, rows / warps). Each warp
// keeps its row's operands and f32 sums in shared memory, lane l owning the
// elements l, l + 32, .... The other side streams through in tiles of 32
// rows (keys, or queries for dK/dV), staged by the whole block in chunks of
// DC = 128 columns (coalesced loads; the rows padded by one float, so that
// lane l reading row l and lane l reading column l both hit 32 banks).
// Lane l takes the tile's row l for the scores: a dot product over D, chunk
// by chunk, with no cross-lane sum; the tile's softmax statistics take one
// shuffle reduction each. The sums over the tile's rows (O, dQ, dK, dV) run
// with lane l at column l, the tile's 32 probabilities (or dS) broadcast from
// shared memory. Where D needs more than one chunk the tile is staged again
// for that pass. Every sum runs in a fixed order, so results repeat run to
// run. The cost is the CUDA cores' f32 rate, with no tensor core: fine for
// head dims the main paths do not use. `warps` is the most of 8, 4, 2, 1
// whose shared memory stays within 100 KB (two blocks an SM), else 1 up to
// the 227 KB of an SM; a head dim whose single warp does not fit (past
// 12,448 for dK/dV) is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                // rows of the streamed side a tile
constexpr int DC = 128;                 // columns a staged chunk
constexpr int PITCH = DC + 1;           // a staged row's floats
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr size_t GOOD_SMEM = 100 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// a product operand: rounded to bf16 in the bf16-operand mode
template <bool BF16_OPS>
__device__ __forceinline__ float op(float x) {
    return BF16_OPS ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// Stage rows [r0, r0 + TILE) x columns [c0, c0 + dc) of a (rows, D) matrix
// with row stride `st` into `dst` (PITCH floats a row), as product operands;
// rows past `rows` as zeros. The whole block takes part.
template <typename T, bool BF16_OPS>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t st, int r0,
                                      int rows, int c0, int dc) {
    for (int i = threadIdx.x; i < TILE * dc; i += blockDim.x) {
        const int r = i / dc, c = i - r * dc;
        const int row = r0 + r;
        dst[r * PITCH + c] =
            row < rows ? op<BF16_OPS>(to_f32(src[row * st + c0 + c])) : 0.f;
    }
}

// A warp's row of D elements from global memory into shared memory, as a
// product operand times `mul`.
template <typename T, bool BF16_OPS>
__device__ __forceinline__ void load_row(float* dst, const T* src, int D, float mul) {
    for (int d = threadIdx.x & 31; d < D; d += 32) dst[d] = op<BF16_OPS>(to_f32(src[d])) * mul;
}

template <typename T, bool BF16_OPS>
__global__ void flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                      const T* __restrict__ v, T* __restrict__ o,
                                      float* __restrict__ lse, int H, int Tq, int Tk, int D,
                                      int64_t qsb, int64_t qsh, int64_t qst,
                                      int64_t ksb, int64_t ksh, int64_t kst,
                                      int64_t vsb, int64_t vsh, int64_t vst, float scale) {
    extern __shared__ float wide_smem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int row = blockIdx.y * warps + warp;
    const bool live = row < Tq;        // every warp stays for the block's syncs
    float* tile = wide_smem;                           // TILE x PITCH
    float* sq = tile + TILE * PITCH + (size_t)warp * 2 * D;
    float* acc = sq + D;
    float* sp = wide_smem + TILE * PITCH + (size_t)warps * 2 * D + warp * TILE;
    if (live) {
        // f32 mode scales q before the dot, the bf16 mode after it
        load_row<T, BF16_OPS>(sq, q + b * qsb + h * qsh + row * qst, D,
                              BF16_OPS ? 1.f : scale);
        for (int d = lane; d < D; d += 32) acc[d] = 0.f;
    }
    const T* kb = k + b * ksb + h * ksh;
    const T* vb = v + b * vsb + h * vsh;
    const int chunks = (D + DC - 1) / DC;
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < Tk; j0 += TILE) {
        float s = 0.f;                 // lane: the score of key j0 + lane
        for (int c = 0; c < chunks; ++c) {
            const int c0 = c * DC, dc = min(DC, D - c0);
            __syncthreads();
            stage<T, BF16_OPS>(tile, kb, kst, j0, Tk, c0, dc);
            __syncthreads();
            if (live)
                for (int d = 0; d < dc; ++d) s += sq[c0 + d] * tile[lane * PITCH + d];
        }
        if (BF16_OPS) s *= scale;
        if (j0 + lane >= Tk) s = -INFINITY;
        // the tile holds at least one key below Tk: m_new is finite
        const float m_new = fmaxf(m, warp_max(s));
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + warp_sum(p);
        m = m_new;
        sp[lane] = op<BF16_OPS>(p);
        __syncwarp();
        for (int c = 0; c < chunks; ++c) {
            const int c0 = c * DC, dc = min(DC, D - c0);
            __syncthreads();
            stage<T, BF16_OPS>(tile, vb, vst, j0, Tk, c0, dc);
            __syncthreads();
            if (live)
                for (int d = lane; d < dc; d += 32) {
                    float a = acc[c0 + d] * alpha;
#pragma unroll 8
                    for (int j = 0; j < TILE; ++j) a += sp[j] * tile[j * PITCH + d];
                    acc[c0 + d] = a;
                }
        }
        __syncwarp();
    }
    if (!live) return;
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + ((int64_t)bh * Tq + row) * D;
    for (int d = lane; d < D; d += 32) store(orow + d, acc[d] / lc);
    if (lane == 0) lse[(int64_t)bh * Tq + row] = m + logf(lc);
}

template <typename T, bool BF16_OPS>
__global__ void flash_wide_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ g,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dq,
                                         int H, int Tq, int Tk, int D,
                                         int64_t qsb, int64_t qsh, int64_t qst,
                                         int64_t ksb, int64_t ksh, int64_t kst,
                                         int64_t vsb, int64_t vsh, int64_t vst,
                                         int64_t gsb, int64_t gsh, int64_t gst, float scale) {
    extern __shared__ float wide_smem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int row = blockIdx.y * warps + warp;
    const bool live = row < Tq;
    float* tk = wide_smem;                             // K tile, TILE x PITCH
    float* tv = tk + TILE * PITCH;                     // V tile
    float* sq = tv + TILE * PITCH + (size_t)warp * 3 * D;
    float* sg = sq + D;
    float* acc = sg + D;
    float* sds = wide_smem + 2 * TILE * PITCH + (size_t)warps * 3 * D + warp * TILE;
    float lse_r = 0.f, delta_r = 0.f;
    if (live) {
        load_row<T, BF16_OPS>(sq, q + b * qsb + h * qsh + row * qst, D, 1.f);
        load_row<T, BF16_OPS>(sg, g + b * gsb + h * gsh + row * gst, D, 1.f);
        for (int d = lane; d < D; d += 32) acc[d] = 0.f;
        lse_r = lse[(int64_t)bh * Tq + row];
        delta_r = delta[(int64_t)bh * Tq + row];
    }
    const T* kb = k + b * ksb + h * ksh;
    const T* vb = v + b * vsb + h * vsh;
    const int chunks = (D + DC - 1) / DC;
    for (int j0 = 0; j0 < Tk; j0 += TILE) {
        float s = 0.f, dp = 0.f;       // lane: key j0 + lane
        for (int c = 0; c < chunks; ++c) {
            const int c0 = c * DC, dc = min(DC, D - c0);
            __syncthreads();
            stage<T, BF16_OPS>(tk, kb, kst, j0, Tk, c0, dc);
            stage<T, BF16_OPS>(tv, vb, vst, j0, Tk, c0, dc);
            __syncthreads();
            if (live)
                for (int d = 0; d < dc; ++d) {
                    s += sq[c0 + d] * tk[lane * PITCH + d];
                    dp += sg[c0 + d] * tv[lane * PITCH + d];
                }
        }
        const float p = j0 + lane < Tk ? expf(s * scale - lse_r) : 0.f;
        sds[lane] = op<BF16_OPS>(p * (dp - delta_r));
        __syncwarp();
        for (int c = 0; c < chunks; ++c) {
            const int c0 = c * DC, dc = min(DC, D - c0);
            if (chunks > 1) {          // one chunk: the K tile is staged already
                __syncthreads();
                stage<T, BF16_OPS>(tk, kb, kst, j0, Tk, c0, dc);
                __syncthreads();
            }
            if (live)
                for (int d = lane; d < dc; d += 32) {
                    float a = acc[c0 + d];
#pragma unroll 8
                    for (int j = 0; j < TILE; ++j) a += sds[j] * tk[j * PITCH + d];
                    acc[c0 + d] = a;
                }
        }
        __syncwarp();
    }
    if (!live) return;
    T* out = dq + ((int64_t)bh * Tq + row) * D;
    for (int d = lane; d < D; d += 32) store(out + d, acc[d] * scale);
}

template <typename T, bool BF16_OPS>
__global__ void flash_wide_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                          const T* __restrict__ v, const T* __restrict__ g,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          T* __restrict__ dk, T* __restrict__ dv,
                                          int H, int Tq, int Tk, int D,
                                          int64_t qsb, int64_t qsh, int64_t qst,
                                          int64_t ksb, int64_t ksh, int64_t kst,
                                          int64_t vsb, int64_t vsh, int64_t vst,
                                          int64_t gsb, int64_t gsh, int64_t gst, float scale) {
    extern __shared__ float wide_smem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int row = blockIdx.y * warps + warp;         // a key
    const bool live = row < Tk;
    float* tq = wide_smem;                             // Q tile, TILE x PITCH
    float* tg = tq + TILE * PITCH;                     // dO tile
    float* sk = tg + TILE * PITCH + (size_t)warp * 4 * D;
    float* sv = sk + D;
    float* ak = sv + D;
    float* av = ak + D;
    float* sp = wide_smem + 2 * TILE * PITCH + (size_t)warps * 4 * D + warp * 2 * TILE;
    float* sds = sp + TILE;
    if (live) {
        load_row<T, BF16_OPS>(sk, k + b * ksb + h * ksh + row * kst, D, 1.f);
        load_row<T, BF16_OPS>(sv, v + b * vsb + h * vsh + row * vst, D, 1.f);
        for (int d = lane; d < D; d += 32) ak[d] = av[d] = 0.f;
    }
    const T* qb = q + b * qsb + h * qsh;
    const T* gb = g + b * gsb + h * gsh;
    const float* lse_bh = lse + (int64_t)bh * Tq;
    const float* delta_bh = delta + (int64_t)bh * Tq;
    const int chunks = (D + DC - 1) / DC;
    for (int i0 = 0; i0 < Tq; i0 += TILE) {
        float s = 0.f, dp = 0.f;       // lane: query i0 + lane
        for (int c = 0; c < chunks; ++c) {
            const int c0 = c * DC, dc = min(DC, D - c0);
            __syncthreads();
            stage<T, BF16_OPS>(tq, qb, qst, i0, Tq, c0, dc);
            stage<T, BF16_OPS>(tg, gb, gst, i0, Tq, c0, dc);
            __syncthreads();
            if (live)
                for (int d = 0; d < dc; ++d) {
                    s += tq[lane * PITCH + d] * sk[c0 + d];
                    dp += tg[lane * PITCH + d] * sv[c0 + d];
                }
        }
        const int i = i0 + lane;
        const float p = i < Tq ? expf(s * scale - lse_bh[i]) : 0.f;
        sp[lane] = op<BF16_OPS>(p);
        sds[lane] = i < Tq ? op<BF16_OPS>(p * (dp - delta_bh[i])) : 0.f;
        __syncwarp();
        for (int c = 0; c < chunks; ++c) {
            const int c0 = c * DC, dc = min(DC, D - c0);
            if (chunks > 1) {          // one chunk: both tiles are staged already
                __syncthreads();
                stage<T, BF16_OPS>(tq, qb, qst, i0, Tq, c0, dc);
                stage<T, BF16_OPS>(tg, gb, gst, i0, Tq, c0, dc);
                __syncthreads();
            }
            if (live)
                for (int d = lane; d < dc; d += 32) {
                    float a_k = ak[c0 + d], a_v = av[c0 + d];
#pragma unroll 8
                    for (int j = 0; j < TILE; ++j) {
                        a_v += sp[j] * tg[j * PITCH + d];
                        a_k += sds[j] * tq[j * PITCH + d];
                    }
                    ak[c0 + d] = a_k;
                    av[c0 + d] = a_v;
                }
        }
        __syncwarp();
    }
    if (!live) return;
    T* dkr = dk + ((int64_t)bh * Tk + row) * D;
    T* dvr = dv + ((int64_t)bh * Tk + row) * D;
    for (int d = lane; d < D; d += 32) {
        store(dkr + d, ak[d] * scale);
        store(dvr + d, av[d]);
    }
}

// (warps a block, dynamic shared bytes) for `tiles` staged tiles, `rows` f32
// rows of D a warp and `extra` floats a warp; warps = 0 when one warp does
// not fit an SM
void shape_of(int D, int tiles, int rows, int extra, int& warps, size_t& smem) {
    const size_t fixed = (size_t)tiles * TILE * PITCH * sizeof(float);
    const size_t per_warp = ((size_t)rows * D + extra) * sizeof(float);
    for (warps = 8; warps > 1 && fixed + warps * per_warp > GOOD_SMEM; warps >>= 1) {}
    if (fixed + warps * per_warp > MAX_SMEM) warps = 0;
    smem = fixed + warps * per_warp;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
    // above the 48 KB default a kernel must ask for its dynamic shared memory
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

// B*H runs on the grid's x axis (2^31 - 1 blocks), the rows in blocks of
// `warps` on its y axis (65,535)
bool bad_sizes(int B, int H, int rows, int other, int warps) {
    return B <= 0 || H <= 0 || rows <= 0 || other <= 0 || warps <= 0
        || (int64_t)B * H > INT32_MAX || (rows + warps - 1) / warps > 65535;
}

template <typename T, bool BF16_OPS>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                int H, int Tq, int Tk, int D, float scale, const int64_t* st,
                cudaStream_t stream) {
    int warps;
    size_t smem;
    shape_of(D, 1, 2, TILE, warps, smem);
    if (bad_sizes(B, H, Tq, Tk, warps)) return cudaErrorInvalidValue;
    auto kernel = flash_wide_fwd_kernel<T, BF16_OPS>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tq + warps - 1) / warps);
    kernel<<<grid, 32 * warps, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), H, Tq, Tk, D,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
    return cudaGetLastError();
}

template <typename T, bool BF16_OPS>
cudaError_t bwd(bool dkv, const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* out0, void* out1, int B, int H,
                int Tq, int Tk, int D, float scale, const int64_t* st,
                cudaStream_t stream) {
    int warps;
    size_t smem;
    shape_of(D, 2, dkv ? 4 : 3, dkv ? 2 * TILE : TILE, warps, smem);
    const int rows = dkv ? Tk : Tq;
    if (bad_sizes(B, H, rows, dkv ? Tq : Tk, warps)) return cudaErrorInvalidValue;
    dim3 grid(B * H, (rows + warps - 1) / warps);
    if (dkv) {
        auto kernel = flash_wide_bwd_dkv_kernel<T, BF16_OPS>;
        cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        kernel<<<grid, 32 * warps, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(g), static_cast<const float*>(lse),
            static_cast<const float*>(delta), static_cast<T*>(out0), static_cast<T*>(out1),
            H, Tq, Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
            st[9], st[10], st[11], scale);
    } else {
        auto kernel = flash_wide_bwd_dq_kernel<T, BF16_OPS>;
        cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        kernel<<<grid, 32 * warps, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(g), static_cast<const float*>(lse),
            static_cast<const float*>(delta), static_cast<T*>(out0), H, Tq, Tk, D,
            st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
            st[11], scale);
    }
    return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_ops(int bf16_ops, bool dkv, const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta, void* out0,
                    void* out1, int B, int H, int Tq, int Tk, int D, float scale,
                    const int64_t* st, cudaStream_t s) {
    return bf16_ops
        ? bwd<T, true>(dkv, q, k, v, g, lse, delta, out0, out1, B, H, Tq, Tk, D, scale, st, s)
        : bwd<T, false>(dkv, q, k, v, g, lse, delta, out0, out1, B, H, Tq, Tk, D, scale, st, s);
}

int bwd_entry(bool dkv, const void* q, const void* k, const void* v, const void* g,
              const void* lse, const void* delta, void* out0, void* out1, int B, int H,
              int Tq, int Tk, int D, int is_bf16, int bf16_ops, float scale,
              const int64_t* st, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(is_bf16
        ? bwd_ops<__nv_bfloat16>(bf16_ops, dkv, q, k, v, g, lse, delta, out0, out1, B, H,
                                 Tq, Tk, D, scale, st, s)
        : bwd_ops<float>(bf16_ops, dkv, q, k, v, g, lse, delta, out0, out1, B, H, Tq, Tk,
                         D, scale, st, s));
}

}  // namespace

// Arguments as mmef_flash_fwd (flash_fwd.cu), D any head dim (the true one:
// no padding), scale 1/sqrt(D).
extern "C" int mmef_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int Tq, int Tk, int D,
                                   int is_bf16, int bf16_ops, float scale,
                                   const int64_t* strides, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)(bf16_ops
            ? fwd<__nv_bfloat16, true>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, strides, s)
            : fwd<__nv_bfloat16, false>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, strides, s));
    return (int)(bf16_ops
        ? fwd<float, true>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, strides, s)
        : fwd<float, false>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, strides, s));
}

// Arguments as mmef_flash_bwd_dkv (flash_bwd.cu), D any head dim.
extern "C" int mmef_flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int B,
                                       int H, int Tq, int Tk, int D, int is_bf16,
                                       int bf16_ops, float scale, const int64_t* strides,
                                       void* stream) {
    return bwd_entry(true, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D, is_bf16,
                     bf16_ops, scale, strides, stream);
}

// Arguments as mmef_flash_bwd_dq (flash_bwd.cu), D any head dim.
extern "C" int mmef_flash_bwd_dq_wide(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int H, int Tq, int Tk, int D,
                                      int is_bf16, int bf16_ops, float scale,
                                      const int64_t* strides, void* stream) {
    return bwd_entry(false, q, k, v, dout, lse, delta, dq, nullptr, B, H, Tq, Tk, D,
                     is_bf16, bf16_ops, scale, strides, stream);
}
