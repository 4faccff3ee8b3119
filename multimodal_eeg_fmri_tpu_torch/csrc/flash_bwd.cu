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
// block per (b*h, 64-key tile) looping over query tiles, K3 one block per
// (b*h, 64-query tile) looping over key tiles. Each writes its rows once, in
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
// Both run on the tensor cores (flash_mma.cuh), 4 warps of 16 rows a
// block. f32 mode is 3xTF32 (a TF32 part and a TF32 residual of each
// operand, three m16n8k8 products, f32 accuracy), the bf16 mode m16n8k16
// bf16 products with f32 sums.
// - K2 takes FlashAttention-2's backward layout: the warps' 16 keys are the
//   M side of S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out of the
//   mma accumulators as the rows of dV += P^T dO and dK += dS^T Q and feed
//   those products' A operand from registers; Q, dO, lse and Delta are
//   double-buffered by cp.async. K and V stay in registers as split
//   fragments for the whole loop at D = 32 (D <= 64 in bf16).
// - K3 is the forward's skeleton (flash_fwd.cu) with one more product and no
//   online softmax: the warps' 16 queries are the M side of S = Q K^T and
//   dP = dO V^T, dS = P (dP - Delta) is formed in the accumulators and fed
//   from there as the A operand of dQ += dS K, with K's rows read in key_of
//   order. K and V tiles are double-buffered by cp.async; Q and dO stay in
//   registers as values at D = 32 (D <= 64 in bf16), lse and Delta of the
//   lane's two rows for the whole loop.
// Wider than that, Q, dO (K3) or K, V (K2) are read from shared memory at
// each step, where registers would run out. A view whose base or row stride
// is not 16-byte aligned is staged by element loads.
//
// What bounds them on the card: at the training slice's shapes (B*H = 32,
// T = 256 or 512, D = 32) K2 does 8*B*H*Tq*Tk*D and K3 6*B*H*Tq*Tk*D flops
// (2.1 and 1.6 GFLOP at T = 512) against a few MB of inputs and outputs:
// operations bound them. 3xTF32 on the tensor cores (495/3 = 165 TFLOP/s)
// is the fastest f32-accurate route for them, 2.5x the CUDA cores' f32 peak
// (67 TFLOP/s). 64-row tiles give 128 (T = 256) or 256 (T = 512) blocks
// across the 132 SMs. wgmma and TMA are left for later work.

#include <math.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 128;           // 4 warps of 16 rows (keys in K2, queries in K3)

using namespace flash_mma;

template <int D, typename T>
constexpr size_t dkv_smem_bytes() {
    // lse and Delta, two buffers each; the K and V tiles; two buffers each
    // of the Q and dO tiles
    return sizeof(float) * 4 * BQ + sizeof(T) * (size_t)(2 * BK + 4 * BQ) * pitch<D, T>();
}

template <int D, typename T>
constexpr size_t dq_smem_bytes() {
    // the Q and dO tiles; two buffers each of the K and V tiles
    return sizeof(T) * (size_t)(2 * BQ + 4 * BK) * pitch<D, T>();
}

// K2: one block per (batch*head on grid x, 64-key tile on y), 16 keys a
// warp; query tiles stream. At least one block an SM, as K1 (flash_fwd.cu):
// registers before occupancy.
template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                     int64_t qsb, int64_t qsh, int64_t qst,
                     int64_t ksb, int64_t ksh, int64_t kst,
                     int64_t vsb, int64_t vsh, int64_t vst,
                     int64_t gsb, int64_t gsh, int64_t gst, float scale, int vec) {
    constexpr int LD = pitch<D, T>();
    constexpr int CH = chunk<BF16_OPS>();
    constexpr int NC = D / CH;         // depth chunks of S^T = K Q^T and dP^T = V dO^T
    constexpr int NS = BQ / 8;         // 8-query column blocks of S^T
    constexpr int NO = D / 8;          // 8-column blocks of dK and dV
    constexpr bool KV_REGS = BF16_OPS ? D <= 64 : D <= 32;
    extern __shared__ __align__(16) unsigned char flash_smem[];
    float* sLse = reinterpret_cast<float*>(flash_smem);  // two buffers
    float* sDelta = sLse + 2 * BQ;                        // two buffers
    T* sK = reinterpret_cast<T*>(sDelta + 2 * BQ);
    T* sV = sK + BK * LD;
    T* sQ = sV + BK * LD;              // two buffers
    T* sdO = sQ + 2 * BQ * LD;         // two buffers

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;         // B·H on x, up to 2^31 − 1 blocks
    const int b = bh / H, h = bh % H;
    const int k0 = blockIdx.y * BK;
    const T* qb = q + b * qsb + h * qsh;
    const T* gb = dout + b * gsb + h * gsh;
    const float* lse_bh = lse + (int64_t)bh * Tq;
    const float* delta_bh = delta + (int64_t)bh * Tq;
    const T* sKw = sK + warp * 16 * LD;  // the warp's 16 keys
    const T* sVw = sV + warp * 16 * LD;

    auto stage_queries = [&](int it) {
        const int buf = it & 1, r0 = it * BQ;
        stage_tile<BQ, D, THREADS>(sQ + buf * BQ * LD, qb, qst, r0, Tq, vec & 1);
        stage_tile<BQ, D, THREADS>(sdO + buf * BQ * LD, gb, gst, r0, Tq, vec & 8);
        const int i = threadIdx.x;
        if (i < BQ) {
            if (r0 + i < Tq) {
                cp_async4(sLse + buf * BQ + i, lse_bh + r0 + i);
                cp_async4(sDelta + buf * BQ + i, delta_bh + r0 + i);
            } else {                   // a padded query row: lse = +inf gives P = 0
                sLse[buf * BQ + i] = INFINITY;
                sDelta[buf * BQ + i] = 0.f;
            }
        }
    };
    stage_tile<BK, D, THREADS>(sK, k + b * ksb + h * ksh, kst, k0, Tk, vec & 2);
    stage_tile<BK, D, THREADS>(sV, v + b * vsb + h * vsh, vst, k0, Tk, vec & 4);
    stage_queries(0);
    cp_async_commit();

    auto kv_chunk = [&](const T* tile, int c) {
        return load_a<BF16_OPS>([&](int r, int kk) {
            return to_f32(tile[r * LD + c * CH + kk]);
        });
    };
    AFrag<BF16_OPS> kf[KV_REGS ? NC : 1], vf[KV_REGS ? NC : 1];
    float acc_dk[NO][4], acc_dv[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
    // keys past Tk get P = 0 (their rows are never written)
    const bool key_ok[2] = {k0 + warp * 16 + g < Tk, k0 + warp * 16 + g + 8 < Tk};

    const int n_tiles = (Tq + BQ - 1) / BQ;
    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) stage_queries(it + 1);
        cp_async_commit();
        cp_async_wait<1>();            // this tile (and, at first, K and V) has landed
        __syncthreads();
        if constexpr (KV_REGS) {
            if (it == 0) {
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    kf[c] = kv_chunk(sKw, c);
                    vf[c] = kv_chunk(sVw, c);
                }
            }
        }
        const T* cQ = sQ + (it & 1) * BQ * LD;
        const T* cdO = sdO + (it & 1) * BQ * LD;
        const float* cLse = sLse + (it & 1) * BQ;
        const float* cDelta = sDelta + (it & 1) * BQ;

        // S^T and dP^T: keys down the rows, this tile's queries across
        float s[NS][4], dp[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            AFrag<BF16_OPS> ka, va;
            if constexpr (KV_REGS) {
                ka = kf[c];
                va = vf[c];
            } else {
                ka = kv_chunk(sKw, c);
                va = kv_chunk(sVw, c);
            }
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                mma<BF16_OPS>(s[j], ka, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cQ[(j * 8 + n) * LD + c * CH + kk]);
                }));
                mma<BF16_OPS>(dp[j], va, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cdO[(j * 8 + n) * LD + c * CH + kk]);
                }));
            }
        }

        // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - Delta), in place
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const float2 lse_q = *reinterpret_cast<const float2*>(cLse + j * 8 + 2 * t);
            const float2 delta_q = *reinterpret_cast<const float2*>(cDelta + j * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = key_ok[e >> 1]
                    ? expf(s[j][e] * scale - ((e & 1) ? lse_q.y : lse_q.x)) : 0.f;
                dp[j][e] = p * (dp[j][e] - ((e & 1) ? delta_q.y : delta_q.x));
                s[j][e] = p;
            }
        }

        // dV += P^T dO and dK += dS^T Q, the A operands from the registers
        // above; padded query rows have P = dS = 0 and Q = dO = 0
#pragma unroll
        for (int c = 0; c < BQ / CH; ++c) {
            const AFrag<BF16_OPS> pa = a_from_acc<BF16_OPS>(&s[c * (CH / 8)]);
            const AFrag<BF16_OPS> da = a_from_acc<BF16_OPS>(&dp[c * (CH / 8)]);
#pragma unroll
            for (int j = 0; j < NO; ++j) {
                mma<BF16_OPS>(acc_dv[j], pa, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cdO[(c * CH + key_of(kk)) * LD + j * 8 + n]);
                }));
                mma<BF16_OPS>(acc_dk[j], da, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cQ[(c * CH + key_of(kk)) * LD + j * 8 + n]);
                }));
            }
        }
        __syncthreads();               // the buffers are free for the tile after next
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = k0 + warp * 16 + g + 8 * r;
        if (key < Tk) {
            T* dk_row = dk + ((int64_t)bh * Tk + key) * D + 2 * t;
            T* dv_row = dv + ((int64_t)bh * Tk + key) * D + 2 * t;
#pragma unroll
            for (int j = 0; j < NO; ++j) {
                store2(dk_row + j * 8, acc_dk[j][2 * r] * scale, acc_dk[j][2 * r + 1] * scale);
                store2(dv_row + j * 8, acc_dv[j][2 * r], acc_dv[j][2 * r + 1]);
            }
        }
    }
}

// K3: one block per (batch*head on grid x, 64-query tile on y), 16 queries
// a warp; key tiles stream, double-buffered. At least one block an SM, as
// K1 and K2.
template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Tq, int Tk,
                    int64_t qsb, int64_t qsh, int64_t qst,
                    int64_t ksb, int64_t ksh, int64_t kst,
                    int64_t vsb, int64_t vsh, int64_t vst,
                    int64_t gsb, int64_t gsh, int64_t gst, float scale, int vec) {
    constexpr int LD = pitch<D, T>();
    constexpr int CH = chunk<BF16_OPS>();
    constexpr int NC = D / CH;         // depth chunks of S = Q K^T and dP = dO V^T
    constexpr int NS = BK / 8;         // 8-key column blocks of S
    constexpr int NO = D / 8;          // 8-column blocks of dQ
    constexpr bool QG_REGS = BF16_OPS ? D <= 64 : D <= 32;
    extern __shared__ __align__(16) unsigned char flash_smem[];
    T* sQ = reinterpret_cast<T*>(flash_smem);
    T* sdO = sQ + BQ * LD;
    T* sK = sdO + BQ * LD;             // two buffers
    T* sV = sK + 2 * BK * LD;          // two buffers

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;         // B·H on x, up to 2^31 − 1 blocks
    const int b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * BQ;
    const T* kb = k + b * ksb + h * ksh;
    const T* vb = v + b * vsb + h * vsh;
    const T* sQw = sQ + warp * 16 * LD;  // the warp's 16 query rows
    const T* sdOw = sdO + warp * 16 * LD;

    stage_tile<BQ, D, THREADS>(sQ, q + b * qsb + h * qsh, qst, q0, Tq, vec & 1);
    stage_tile<BQ, D, THREADS>(sdO, dout + b * gsb + h * gsh, gst, q0, Tq, vec & 8);
    stage_tile<BK, D, THREADS>(sK, kb, kst, 0, Tk, vec & 2);
    stage_tile<BK, D, THREADS>(sV, vb, vst, 0, Tk, vec & 4);
    cp_async_commit();

    // lse and Delta of the lane's rows g and g+8; a padded query row gets
    // lse = +inf, hence P = 0
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        lse_r[r] = row < Tq ? lse[(int64_t)bh * Tq + row] : INFINITY;
        delta_r[r] = row < Tq ? delta[(int64_t)bh * Tq + row] : 0.f;
    }

    auto row_chunk = [&](const T* tile, int c) {
        return gather_a<BF16_OPS>([&](int r, int kk) {
            return to_f32(tile[r * LD + c * CH + kk]);
        });
    };
    AKept<BF16_OPS> qk[QG_REGS ? NC : 1], gk[QG_REGS ? NC : 1];
    float acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    const int n_tiles = (Tk + BK - 1) / BK;
    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) {
            const int nb = (it + 1) & 1, k1 = (it + 1) * BK;
            stage_tile<BK, D, THREADS>(sK + nb * BK * LD, kb, kst, k1, Tk, vec & 2);
            stage_tile<BK, D, THREADS>(sV + nb * BK * LD, vb, vst, k1, Tk, vec & 4);
        }
        cp_async_commit();
        cp_async_wait<1>();            // this tile (and, at first, Q and dO) has landed
        __syncthreads();
        if constexpr (QG_REGS) {
            if (it == 0) {
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    qk[c] = keep<BF16_OPS>(row_chunk(sQw, c));
                    gk[c] = keep<BF16_OPS>(row_chunk(sdOw, c));
                }
            }
        }
        const T* cK = sK + (it & 1) * BK * LD;
        const T* cV = sV + (it & 1) * BK * LD;

        // S and dP: the warp's queries down the rows, this tile's keys across
        float s[NS][4], dp[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            AFrag<BF16_OPS> qa, ga;
            if constexpr (QG_REGS) {
                qa = frag(qk[c]);
                ga = frag(gk[c]);
            } else {
                qa = a_from_vals<BF16_OPS>(row_chunk(sQw, c));
                ga = a_from_vals<BF16_OPS>(row_chunk(sdOw, c));
            }
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                mma<BF16_OPS>(s[j], qa, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cK[(j * 8 + n) * LD + c * CH + kk]);
                }));
                mma<BF16_OPS>(dp[j], ga, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cV[(j * 8 + n) * LD + c * CH + kk]);
                }));
            }
        }

        // P = exp(S scale - lse), zero for keys past Tk, and dS = P (dP - Delta)
        // in place of dP
        const int key0 = it * BK + 2 * t;  // the key of s[0][0]
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = key0 + j * 8 + (e & 1) < Tk
                    ? expf(s[j][e] * scale - lse_r[e >> 1]) : 0.f;
                dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
            }
        }

        // dQ += dS K, dS from the registers above; masked keys have dS = 0
        // and K = 0
#pragma unroll
        for (int c = 0; c < BK / CH; ++c) {
            const AFrag<BF16_OPS> da = a_from_acc<BF16_OPS>(&dp[c * (CH / 8)]);
#pragma unroll
            for (int j = 0; j < NO; ++j)
                mma<BF16_OPS>(acc[j], da, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cK[(c * CH + key_of(kk)) * LD + j * 8 + n]);
                }));
        }
        __syncthreads();               // the buffers are free for the tile after next
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row < Tq) {
            T* dq_row = dq + ((int64_t)bh * Tq + row) * D + 2 * t;
#pragma unroll
            for (int j = 0; j < NO; ++j)
                store2(dq_row + j * 8, acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
        }
    }
}

struct Args {
    const void *q, *k, *v, *dout, *lse, *delta;
    void *out0, *out1;                 // dK and dV for K2; dQ (and unused) for K3
    int B, H, Tq, Tk;
    float scale;                       // one over the root of the true head dim
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
    constexpr size_t smem = dkv_smem_bytes<D, T>();
    static bool configured = false;    // the attribute is set once per instance
    cudaError_t err = configure(kernel, smem, configured);
    if (err != cudaSuccess) return err;
    const int64_t* st = a.st;
    const void* inputs[] = {a.q, a.k, a.v, a.dout};
    dim3 grid(a.B * a.H, (a.Tk + BK - 1) / BK);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.Tq, a.Tk,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], a.scale,
        aligned_rows_mask(inputs, st, sizeof(T)));
    return cudaGetLastError();
}

template <int D, typename T, bool BF16_OPS>
cudaError_t launch_dq(const Args& a) {
    auto kernel = flash_bwd_dq_kernel<D, T, BF16_OPS>;
    constexpr size_t smem = dq_smem_bytes<D, T>();
    static bool configured = false;
    cudaError_t err = configure(kernel, smem, configured);
    if (err != cudaSuccess) return err;
    const int64_t* st = a.st;
    const void* inputs[] = {a.q, a.k, a.v, a.dout};
    dim3 grid(a.B * a.H, (a.Tq + BQ - 1) / BQ);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.out0), a.H, a.Tq, a.Tk,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], a.scale,
        aligned_rows_mask(inputs, st, sizeof(T)));
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
    if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0
        || (int64_t)a.B * a.H > INT32_MAX || (a.Tq + BQ - 1) / BQ > 65535
        || (a.Tk + BK - 1) / BK > 65535)
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
// (else f32); bf16_ops the bf16 tile operands. D and scale as in
// mmef_flash_fwd. Returns the cudaError_t of the launch.
extern "C" int mmef_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int Tq, int Tk,
                                  int D, int is_bf16, int bf16_ops, float scale,
                                  const int64_t* strides, void* stream) {
    const Args a{q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, scale, strides,
                 static_cast<cudaStream_t>(stream)};
    return dispatch<true>(D, is_bf16, bf16_ops, a);
}

// As mmef_flash_bwd_dkv; dq: contiguous (B, H, Tq, D) of the input type.
extern "C" int mmef_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int H, int Tq, int Tk, int D,
                                 int is_bf16, int bf16_ops, float scale,
                                 const int64_t* strides, void* stream) {
    const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, H, Tq, Tk, scale,
                 strides, static_cast<cudaStream_t>(stream)};
    return dispatch<false>(D, is_bf16, bf16_ops, a);
}
