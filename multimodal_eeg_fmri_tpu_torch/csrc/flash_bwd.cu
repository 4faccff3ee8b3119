// Flash-attention backward for Hopper (sm_90a), plain C entry points for ctypes.
//
// Replaces the two Pallas TPU kernels of `multimodal_eeg_fmri_tpu/ops/
// attention.py:_flash_backward` (:274-362):
// - K2, `_bwd_dkv_kernel` (:121-170, pallas_call at :311) -> mmef_flash_bwd_dkv
// - K3, `_bwd_dq_kernel` (:173-211, pallas_call at :339)  -> mmef_flash_bwd_dq
// Both recompute, tile by tile, S = Q K^T * scale (scale after the dot),
// P = exp(S - lse), dP = dO V^T and dS = P * (dP - Delta), from the forward's
// per-row logsumexp lse and Delta = rowsum(dO * O) - g_lse, which the caller
// computes (the JAX package does it in XLA, outside any Pallas kernel).
// K2 sums dV = P^T dO and dK = dS^T Q * scale over the query tiles; K3 sums
// dQ = dS K * scale over the key tiles. Nothing of size (Tq, Tk) is stored.
//
// Why two kernels and no atomics: dK/dV are sums over queries and dQ a sum
// over keys. One kernel that owns a key tile would have to add its share of
// dQ into rows that every other key tile's block also writes (atomics, in an
// order that changes from run to run); one that owns a query tile would do
// the same for dK/dV. Two kernels let each block own its output rows: K2 one
// block per (64-key tile, b*h) looping over query tiles, K3 one block per
// (64-query tile, b*h) looping over key tiles. Each writes its rows once, in
// f32 sums taken in a fixed order, at the price of computing S and dP twice.
//
// Design, as opposed to the TPU original: the TPU streams the non-resident
// operand through the innermost, sequential grid axis and accumulates in
// VMEM scratch; here blocks run in no order, so the stream is a loop inside
// the block, staged through shared memory, and the sums live in registers.
// T is not padded: the ragged query and key edges are masked in the kernel
// (a padded query row gets lse = +inf, hence P = 0, as the TPU kernel
// arranges at :110-113). The head dim D is a template parameter (16, 32, 64,
// 128). q, k, v and dO are read through their strides with the last dim
// contiguous, so the caller's (B, T, H, D) projections and the dO that
// autograd hands over need no copy. BF16_OPS mirrors `compute_dtype=
// bfloat16`: q, k, v and dO are rounded to bf16, and so are P before dV and
// dS before dK and dQ (:136-139, 153, 163); every sum and lse/Delta stay f32.
//
// What bounds it on the card: at the training slice's shapes (B*H = 32,
// T = 256 or 512, D = 32) K2 does 8*B*H*Tq*Tk*D and K3 6*B*H*Tq*Tk*D flops
// (0.5 and 0.4 GFLOP at T = 512), a few microseconds of work for an H100:
// like the forward, they are bound by latency and launch cost, not by bytes.
// 64-row tiles give 128 (T = 256) or 256 (T = 512) blocks across the 132 SMs.
// The products run on the CUDA cores from shared memory; mma.sync/wgmma and
// TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;      // threads that share one tile row
constexpr int KPT = BK / TPR;          // keys of a tile scored by one thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

// Stage rows [t0, t0 + 64) of one (batch, head) of a (B, H, T, D) tensor into
// a shared tile of 64 rows padded by one float; rows past T are zero.
template <int D, typename T, bool BF16_OPS>
__device__ __forceinline__ void load_tile(float* tile, const T* base, int64_t st,
                                          int t0, int T_len) {
    for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
        const int row = i / D, col = i % D;
        float x = 0.f;
        if (t0 + row < T_len) x = to_f32(base[(int64_t)(t0 + row) * st + col]);
        tile[row * (D + 1) + col] = BF16_OPS ? round_bf16(x) : x;
    }
}

// Scores and dP of query row r against keys g, g+TPR, ... of the staged tile:
// s = q.k * scale and dp = dO.v, both f32.
template <int D>
__device__ __forceinline__ void scores(const float* qrow, const float* dorow,
                                       const float* sK, const float* sV, int g,
                                       float scale, float (&s)[KPT], float (&dp)[KPT]) {
    constexpr int LD = D + 1;
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
        const float qd = qrow[d], gd = dorow[d];
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
            s[c] = fmaf(qd, sK[(g + c * TPR) * LD + d], s[c]);
            dp[c] = fmaf(gd, sV[(g + c * TPR) * LD + d], dp[c]);
        }
    }
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] *= scale;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
    // K, V, Q and dO tiles, the P and dS tiles, lse and Delta of the Q tile
    return sizeof(float) * (size_t)(4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
    // Q, dO, K and V tiles and the dS tile
    return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * (BK + 1));
}

// K2: one block per (key tile, batch*head); query tiles stream.
template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                     int64_t qsb, int64_t qsh, int64_t qst,
                     int64_t ksb, int64_t ksh, int64_t kst,
                     int64_t vsb, int64_t vsh, int64_t vst,
                     int64_t gsb, int64_t gsh, int64_t gst, float scale) {
    constexpr int LD = D + 1;
    constexpr int LDP = BK + 1;
    constexpr int DPT = D / TPR;       // output columns owned by one thread
    extern __shared__ float smem[];
    float* sK = smem;
    float* sV = sK + BK * LD;
    float* sQ = sV + BK * LD;
    float* sdO = sQ + BQ * LD;
    float* sP = sdO + BQ * LD;
    float* sdS = sP + BQ * LDP;
    float* sLse = sdS + BQ * LDP;
    float* sDelta = sLse + BQ;

    const int tid = threadIdx.x;
    const int r = tid / TPR;           // query row while scoring, key row while summing
    const int g = tid % TPR;
    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int k0 = blockIdx.x * BK;

    load_tile<D, T, BF16_OPS>(sK, k + b * ksb + h * ksh, kst, k0, Tk);
    load_tile<D, T, BF16_OPS>(sV, v + b * vsb + h * vsh, vst, k0, Tk);
    const T* qb = q + b * qsb + h * qsh;
    const T* gb = dout + b * gsb + h * gsh;
    const float* lse_bh = lse + (int64_t)bh * Tq;
    const float* delta_bh = delta + (int64_t)bh * Tq;

    float acc_dk[DPT], acc_dv[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    for (int q0 = 0; q0 < Tq; q0 += BQ) {
        __syncthreads();  // the previous Q, dO, P and dS tiles are consumed
        load_tile<D, T, BF16_OPS>(sQ, qb, qst, q0, Tq);
        load_tile<D, T, BF16_OPS>(sdO, gb, gst, q0, Tq);
        if (tid < BQ) {
            const bool valid = q0 + tid < Tq;
            // a padded query row: lse = +inf gives P = 0
            sLse[tid] = valid ? lse_bh[q0 + tid] : INFINITY;
            sDelta[tid] = valid ? delta_bh[q0 + tid] : 0.f;
        }
        __syncthreads();

        float s[KPT], dp[KPT];
        scores<D>(sQ + r * LD, sdO + r * LD, sK, sV, g, scale, s, dp);
        const float lse_r = sLse[r], delta_r = sDelta[r];
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
            const int j = g + c * TPR;
            const float p = k0 + j < Tk ? expf(s[c] - lse_r) : 0.f;
            const float ds = p * (dp[c] - delta_r);
            sP[r * LDP + j] = BF16_OPS ? round_bf16(p) : p;
            sdS[r * LDP + j] = BF16_OPS ? round_bf16(ds) : ds;
        }
        __syncthreads();

        // dV[r] += sum_i P[i, r] dO[i];  dK[r] += sum_i dS[i, r] Q[i]
#pragma unroll 4
        for (int i = 0; i < BQ; ++i) {
            const float p = sP[i * LDP + r], ds = sdS[i * LDP + r];
#pragma unroll
            for (int c = 0; c < DPT; ++c) {
                acc_dv[c] = fmaf(p, sdO[i * LD + g + c * TPR], acc_dv[c]);
                acc_dk[c] = fmaf(ds, sQ[i * LD + g + c * TPR], acc_dk[c]);
            }
        }
    }

    const int key = k0 + r;
    if (key < Tk) {
        T* dk_row = dk + ((int64_t)bh * Tk + key) * D;
        T* dv_row = dv + ((int64_t)bh * Tk + key) * D;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
            store(&dk_row[g + c * TPR], acc_dk[c] * scale);
            store(&dv_row[g + c * TPR], acc_dv[c]);
        }
    }
}

// K3: one block per (query tile, batch*head); key tiles stream.
template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Tq, int Tk,
                    int64_t qsb, int64_t qsh, int64_t qst,
                    int64_t ksb, int64_t ksh, int64_t kst,
                    int64_t vsb, int64_t vsh, int64_t vst,
                    int64_t gsb, int64_t gsh, int64_t gst, float scale) {
    constexpr int LD = D + 1;
    constexpr int LDP = BK + 1;
    constexpr int DPT = D / TPR;
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sdO = sQ + BQ * LD;
    float* sK = sdO + BQ * LD;
    float* sV = sK + BK * LD;
    float* sdS = sV + BK * LD;

    const int tid = threadIdx.x;
    const int r = tid / TPR;           // query row within the tile
    const int g = tid % TPR;
    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int q0 = blockIdx.x * BQ;
    const int row = q0 + r;

    load_tile<D, T, BF16_OPS>(sQ, q + b * qsb + h * qsh, qst, q0, Tq);
    load_tile<D, T, BF16_OPS>(sdO, dout + b * gsb + h * gsh, gst, q0, Tq);
    const T* kb = k + b * ksb + h * ksh;
    const T* vb = v + b * vsb + h * vsh;
    // a padded query row: lse = +inf gives P = 0
    const float lse_r = row < Tq ? lse[(int64_t)bh * Tq + row] : INFINITY;
    const float delta_r = row < Tq ? delta[(int64_t)bh * Tq + row] : 0.f;

    float acc[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
    float* dsrow = sdS + r * LDP;

    for (int k0 = 0; k0 < Tk; k0 += BK) {
        __syncthreads();  // the previous K and V tiles are consumed; Q, dO in place
        load_tile<D, T, BF16_OPS>(sK, kb, kst, k0, Tk);
        load_tile<D, T, BF16_OPS>(sV, vb, vst, k0, Tk);
        __syncthreads();

        float s[KPT], dp[KPT];
        scores<D>(sQ + r * LD, sdO + r * LD, sK, sV, g, scale, s, dp);
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
            const int j = g + c * TPR;
            const float p = k0 + j < Tk ? expf(s[c] - lse_r) : 0.f;
            const float ds = p * (dp[c] - delta_r);
            dsrow[j] = BF16_OPS ? round_bf16(ds) : ds;
        }
        // the TPR threads of a row are neighbouring lanes of one warp
        __syncwarp();

        // dQ[r] += sum_j dS[r, j] K[j]; masked keys have dS = 0 and K = 0
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            const float ds = dsrow[j];
#pragma unroll
            for (int c = 0; c < DPT; ++c)
                acc[c] = fmaf(ds, sK[j * LD + g + c * TPR], acc[c]);
        }
    }

    if (row < Tq) {
        T* dq_row = dq + ((int64_t)bh * Tq + row) * D;
#pragma unroll
        for (int c = 0; c < DPT; ++c) store(&dq_row[g + c * TPR], acc[c] * scale);
    }
}

struct Args {
    const void *q, *k, *v, *dout, *lse, *delta;
    void *out0, *out1;                 // dK and dV for K2; dQ (and unused) for K3
    int B, H, Tq, Tk;
    const int64_t* st;                 // q, k, v, dO strides (batch, head, time)
    cudaStream_t stream;
};

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool& configured) {
    if (configured) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) configured = true;
    return err;
}

template <int D, typename T, bool BF16_OPS>
cudaError_t launch_dkv(const Args& a) {
    auto kernel = flash_bwd_dkv_kernel<D, T, BF16_OPS>;
    constexpr size_t smem = dkv_smem_bytes<D>();
    static bool configured = false;    // the attribute is set once per instance
    cudaError_t err = configure(kernel, smem, configured);
    if (err != cudaSuccess) return err;
    const int64_t* st = a.st;
    dim3 grid((a.Tk + BK - 1) / BK, a.B * a.H);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.Tq, a.Tk,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], (float)(1.0 / sqrt((double)D)));
    return cudaGetLastError();
}

template <int D, typename T, bool BF16_OPS>
cudaError_t launch_dq(const Args& a) {
    auto kernel = flash_bwd_dq_kernel<D, T, BF16_OPS>;
    constexpr size_t smem = dq_smem_bytes<D>();
    static bool configured = false;
    cudaError_t err = configure(kernel, smem, configured);
    if (err != cudaSuccess) return err;
    const int64_t* st = a.st;
    dim3 grid((a.Tq + BQ - 1) / BQ, a.B * a.H);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.out0), a.H, a.Tq, a.Tk,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], (float)(1.0 / sqrt((double)D)));
    return cudaGetLastError();
}

template <bool DKV, typename T, bool BF16_OPS>
cudaError_t by_head_dim(int D, const Args& a) {
    switch (D) {
        case 16: return DKV ? launch_dkv<16, T, BF16_OPS>(a) : launch_dq<16, T, BF16_OPS>(a);
        case 32: return DKV ? launch_dkv<32, T, BF16_OPS>(a) : launch_dq<32, T, BF16_OPS>(a);
        case 64: return DKV ? launch_dkv<64, T, BF16_OPS>(a) : launch_dq<64, T, BF16_OPS>(a);
        case 128: return DKV ? launch_dkv<128, T, BF16_OPS>(a) : launch_dq<128, T, BF16_OPS>(a);
        default: return cudaErrorInvalidValue;
    }
}

template <bool DKV>
int dispatch(int D, int is_bf16, int bf16_ops, const Args& a) {
    if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.B * a.H > 65535)
        return (int)cudaErrorInvalidValue;
    if (is_bf16)
        return (int)(bf16_ops ? by_head_dim<DKV, __nv_bfloat16, true>(D, a)
                              : by_head_dim<DKV, __nv_bfloat16, false>(D, a));
    return (int)(bf16_ops ? by_head_dim<DKV, float, true>(D, a)
                          : by_head_dim<DKV, float, false>(D, a));
}

}  // namespace

// q, dO: (B, H, Tq, D); k, v: (B, H, Tk, D), with element strides (batch,
// head, time) given in `strides` as q's three, then k's, v's and dO's; the
// last dim is contiguous. lse and delta: contiguous (B, H, Tq) f32. dk, dv:
// contiguous (B, H, Tk, D) of the input type. is_bf16 selects bf16 storage
// (else f32); bf16_ops the bf16 tile operands. Returns the cudaError_t of the
// launch.
extern "C" int mmef_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int Tq, int Tk,
                                  int D, int is_bf16, int bf16_ops,
                                  const int64_t* strides, void* stream) {
    const Args a{q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, strides,
                 static_cast<cudaStream_t>(stream)};
    return dispatch<true>(D, is_bf16, bf16_ops, a);
}

// As mmef_flash_bwd_dkv; dq: contiguous (B, H, Tq, D) of the input type.
extern "C" int mmef_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int H, int Tq, int Tk, int D,
                                 int is_bf16, int bf16_ops, const int64_t* strides,
                                 void* stream) {
    const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, H, Tq, Tk, strides,
                 static_cast<cudaStream_t>(stream)};
    return dispatch<false>(D, is_bf16, bf16_ops, a);
}
