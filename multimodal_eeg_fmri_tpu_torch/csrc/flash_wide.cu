// Flash attention's forward at head dims past 256 on the CUDA cores: a
// plain C entry point for ctypes.
//
// Replaces, past head dim 256, the Pallas TPU kernel K1 of
// `multimodal_eeg_fmri_tpu/ops/attention.py` (`_fwd_kernel` :63,
// pallas_call at :248), whose wrapper pads D to the next multiple of 128 and
// so takes any D. K1 runs on the tensor cores up to 128 (flash_fwd.cu) and
// in (128, 256] (flash_fwd_split.cu); K2 and K3 past 256 on the tensor cores
// too (flash_bwd_deep.cu). This kernel computes K1's function at any D above
// 128 (the true D, unpadded); the wrapper sends it head dims past 256:
// - mmef_flash_fwd_wide: O = softmax(Q K^T * scale) V and lse, by online
//   softmax (running max m, sum l, accumulator) over key tiles.
// f32 mode scales q before the dot, as K1 does; BF16_OPS rounds the product
// operands (q, k, v and p) to bf16 and sums in f32.
//
// Design: one warp per query row, `warps` rows a block, grid (B*H,
// rows / warps). Each warp keeps its row of q and its f32 accumulator in
// shared memory, lane l owning the elements l, l + 32, .... The keys stream
// through in tiles of 32 rows, staged by the whole block in chunks of
// DC = 128 columns (coalesced loads; the rows padded by one float, so that
// lane l reading row l and lane l reading column l both hit 32 banks).
// Lane l takes the tile's key l for the scores: a dot product over D, chunk
// by chunk, with no cross-lane sum; the tile's softmax statistics take one
// shuffle reduction each. The sum over the tile's keys runs with lane l at
// column l, the tile's 32 probabilities broadcast from shared memory. Where
// D needs more than one chunk the tile is staged again for that pass. Every
// sum runs in a fixed order, so results repeat run to run. The cost is the
// CUDA cores' f32 rate, with no tensor core: 2% of its f32 bound at
// (8, 4, 512, 320) (PERF.md), the next kernel to redesign. `warps` is the
// most of 8, 4, 2, 1 whose shared memory stays within 100 KB (two blocks an
// SM), else 1 up to the 227 KB of an SM.

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

// (warps a block, dynamic shared bytes): one staged tile, and a warp's row
// of q, its accumulator and its tile of probabilities; warps = 0 when one
// warp does not fit an SM
void shape_of(int D, int& warps, size_t& smem) {
    const size_t fixed = (size_t)TILE * PITCH * sizeof(float);
    const size_t per_warp = ((size_t)2 * D + TILE) * sizeof(float);
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
    shape_of(D, warps, smem);
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
