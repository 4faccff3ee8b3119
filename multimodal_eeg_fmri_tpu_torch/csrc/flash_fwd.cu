// Flash-attention forward for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces the Pallas TPU kernel `multimodal_eeg_fmri_tpu/ops/attention.py:
// _fwd_kernel` (driven by `_flash_forward`). It computes, per (batch, head),
// the non-causal O = softmax(Q K^T / sqrt(D)) V and the per-row logsumexp,
// with online softmax: running max m, running sum l and the accumulator in
// f32, rescaled as each key tile arrives. Keys past Tk are masked to -inf.
//
// Design, as opposed to the TPU original:
// - One thread block per (query tile of BQ rows, batch*head). On the TPU the
//   key tiles streamed through the innermost, sequential grid axis and the
//   running state lived in VMEM scratch; here blocks run in no order, so the
//   key tiles stream through a loop inside the block, staged through shared
//   memory, and the running state lives in registers.
// - The head dim D is a template parameter (16, 32, 64, 128) and is never
//   padded; T is not padded either: the ragged query and key edges are masked
//   in the kernel. lse is written directly as (B, H, Tq) f32 instead of the
//   TPU's 128-lane broadcast.
// - Q, K and V are read through their strides (last dim contiguous), so the
//   (B, T, H, D) projections of the caller need no transposing copy.
// - BF16_OPS mirrors `compute_dtype=bfloat16`: the q/k tiles and p/v tiles
//   are rounded to bf16 (products exact in f32, f32 sums), the scale applies
//   after the q.k dot, and m, l and lse stay f32.
//
// What bounds it on the card: at the serving slice's shapes (B*H = 32,
// T = 256 or 512, D = 32) the work is ~67 MFLOP per call, which is nothing
// for an H100; the kernel is bound by latency and launch cost. The design
// answers that with 64-row query tiles, which give 128 (T = 256) or 256
// (T = 512) blocks, enough to put work on every one of the 132 SMs, where one
// block per (batch*head) would occupy 32; and by reading the inputs in place,
// so one launch is the whole of the attention core. The dot products run on
// the CUDA cores from shared memory, not on the tensor cores: wgmma, TMA and
// warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;      // threads that share one query row
constexpr int KPT = BK / TPR;          // keys of a tile scored by one thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

template <int D>
constexpr size_t smem_bytes() {
    // Q, K and V tiles with rows padded by one float against bank conflicts,
    // plus the tile of probabilities
    return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 int64_t qsb, int64_t qsh, int64_t qst,
                 int64_t ksb, int64_t ksh, int64_t kst,
                 int64_t vsb, int64_t vsh, int64_t vst, float scale) {
    constexpr int LD = D + 1;
    constexpr int LDP = BK + 1;
    constexpr int DPT = D / TPR;       // output columns owned by one thread
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sK = sQ + BQ * LD;
    float* sV = sK + BK * LD;
    float* sP = sV + BK * LD;

    const int tid = threadIdx.x;
    const int r = tid / TPR;           // query row within the tile
    const int g = tid % TPR;           // lane within the row's group
    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int q0 = blockIdx.x * BQ;

    const T* qb = q + b * qsb + h * qsh;
    const T* kb = k + b * ksb + h * ksh;
    const T* vb = v + b * vsb + h * vsh;

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int row = i / D, col = i % D;
        float x = 0.f;
        if (q0 + row < Tq) x = to_f32(qb[(int64_t)(q0 + row) * qst + col]);
        sQ[row * LD + col] = BF16_OPS ? round_bf16(x) : x * scale;
    }

    float m = -INFINITY, l = 0.f;
    float acc[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

    const float* qrow = sQ + r * LD;
    float* prow = sP + r * LDP;

    for (int k0 = 0; k0 < Tk; k0 += BK) {
        __syncthreads();  // the previous tile is consumed; Q is in place
        for (int i = tid; i < BK * D; i += THREADS) {
            const int row = i / D, col = i % D;
            float kx = 0.f, vx = 0.f;
            if (k0 + row < Tk) {
                kx = to_f32(kb[(int64_t)(k0 + row) * kst + col]);
                vx = to_f32(vb[(int64_t)(k0 + row) * vst + col]);
            }
            sK[row * LD + col] = BF16_OPS ? round_bf16(kx) : kx;
            sV[row * LD + col] = BF16_OPS ? round_bf16(vx) : vx;
        }
        __syncthreads();

        // scores of this thread's keys g, g+TPR, ... against its query row
        float s[KPT];
#pragma unroll
        for (int c = 0; c < KPT; ++c) s[c] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float qd = qrow[d];
#pragma unroll
            for (int c = 0; c < KPT; ++c)
                s[c] = fmaf(qd, sK[(g + c * TPR) * LD + d], s[c]);
        }
        float tile_max = -INFINITY;
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
            if (BF16_OPS) s[c] *= scale;
            if (k0 + g + c * TPR >= Tk) s[c] = -INFINITY;
            tile_max = fmaxf(tile_max, s[c]);
        }
        // the TPR threads of a row are neighbouring lanes of one warp
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
            tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
        // finite: every tile holds at least one key below Tk
        const float m_new = fmaxf(m, tile_max);
        const float alpha = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
            const float p = expf(s[c] - m_new);
            psum += p;
            prow[g + c * TPR] = BF16_OPS ? round_bf16(p) : p;
        }
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
            psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l = alpha * l + psum;
        m = m_new;
        __syncwarp();  // the row's probabilities are visible to its group

#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
        // masked keys have p = 0 and V = 0
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            const float p = prow[j];
#pragma unroll
            for (int i = 0; i < DPT; ++i)
                acc[i] = fmaf(p, sV[j * LD + g + i * TPR], acc[i]);
        }
    }

    const int row = q0 + r;
    if (row < Tq) {
        const float lc = fmaxf(l, 1e-30f);
        T* orow = o + ((int64_t)bh * Tq + row) * D;
#pragma unroll
        for (int i = 0; i < DPT; ++i) store(&orow[g + i * TPR], acc[i] / lc);
        if (g == 0) lse[(int64_t)bh * Tq + row] = l > 0.f ? m + logf(lc) : INFINITY;
    }
}

template <int D, typename T, bool BF16_OPS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int H, int Tq, int Tk, const int64_t* st, cudaStream_t stream) {
    auto kernel = flash_fwd_kernel<D, T, BF16_OPS>;
    constexpr size_t smem = smem_bytes<D>();
    static bool configured = false;  // the attribute is set once per instance
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    dim3 grid((Tq + BQ - 1) / BQ, B * H);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), H, Tq, Tk,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        (float)(1.0 / sqrt((double)D)));
    return cudaGetLastError();
}

template <typename T, bool BF16_OPS>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int H, int Tq, int Tk, int D, const int64_t* st,
                       cudaStream_t stream) {
    switch (D) {
        case 16: return launch<16, T, BF16_OPS>(q, k, v, o, lse, B, H, Tq, Tk, st, stream);
        case 32: return launch<32, T, BF16_OPS>(q, k, v, o, lse, B, H, Tq, Tk, st, stream);
        case 64: return launch<64, T, BF16_OPS>(q, k, v, o, lse, B, H, Tq, Tk, st, stream);
        case 128: return launch<128, T, BF16_OPS>(q, k, v, o, lse, B, H, Tq, Tk, st, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q, k, v: (B, H, T, D) with element strides (batch, head, time) given in
// `strides` as q's three, then k's, then v's; the last dim is contiguous.
// o: contiguous (B, H, Tq, D) of the input type; lse: contiguous (B, H, Tq)
// f32. is_bf16 selects bf16 storage (else f32); bf16_ops the bf16 tile
// operands. Returns the cudaError_t of the launch.
extern "C" int mmef_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int H, int Tq, int Tk, int D,
                              int is_bf16, int bf16_ops, const int64_t* strides,
                              void* stream) {
    if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)(bf16_ops
            ? dispatch_d<__nv_bfloat16, true>(q, k, v, o, lse, B, H, Tq, Tk, D, strides, s)
            : dispatch_d<__nv_bfloat16, false>(q, k, v, o, lse, B, H, Tq, Tk, D, strides, s));
    return (int)(bf16_ops
        ? dispatch_d<float, true>(q, k, v, o, lse, B, H, Tq, Tk, D, strides, s)
        : dispatch_d<float, false>(q, k, v, o, lse, B, H, Tq, Tk, D, strides, s));
}
