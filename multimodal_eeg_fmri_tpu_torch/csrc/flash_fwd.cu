// Flash-attention forward for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces the Pallas TPU kernel `multimodal_eeg_fmri_tpu/ops/attention.py:
// _fwd_kernel` (driven by `_flash_forward`). It computes, per (batch, head),
// the non-causal O = softmax(Q K^T / sqrt(D)) V and the per-row logsumexp,
// with online softmax: running max m, running sum l and the accumulator in
// f32, rescaled as each key tile arrives. Keys past Tk are masked to -inf.
//
// Design, as opposed to the TPU original:
// - One block of 4 warps per (64-row query tile, batch*head), 16 query rows
//   a warp. On the TPU the key tiles streamed through the innermost,
//   sequential grid axis and the running state lived in VMEM scratch; here
//   blocks run in no order, so the 64-key tiles stream through a loop inside
//   the block, double-buffered in shared memory by 16-byte cp.async (the next
//   tile's copy in flight while this tile's products run), and the running
//   state lives in registers.
// - The products run on the tensor cores, warp-level mma.sync
//   (flash_mma.cuh). f32 mode is 3xTF32: each operand is split into a TF32
//   part and a TF32 residual and three m16n8k8 products are summed, small
//   terms first, which keeps f32 accuracy (one TF32 pass would miss the
//   2e-5 gate by 20x). BF16_OPS mirrors `compute_dtype=bfloat16` exactly:
//   m16n8k16 products of bf16-rounded q/k and p/v with f32 sums, the scale
//   applied after the q.k dot (f32 mode scales q before it), m, l and lse f32.
// - Q stays in registers for the whole key loop, as its values in f32 mode
//   (split at each use: half the registers of the split fragments) and as
//   packed fragments in bf16 mode; at D = 128 it is read from the shared
//   tile at each step. S and the softmax state stay in the mma
//   accumulators; the row max and sum run over a row's 4 lanes by shuffles.
//   P passes from the S accumulators into the A operand of P.V in registers,
//   with V's rows read in the order that mapping implies (key_of).
// - Shared rows are padded by 16 bytes: in f32 every fragment read hits 32
//   distinct banks.
// - The head dim D is a template parameter (16, 32, 64, 128) and is never
//   padded; T is not padded either: rows past Tq or Tk are staged as zeros and
//   the keys past Tk masked. lse is written directly as (B, H, Tq) f32.
// - Q, K and V are read through their strides (last dim contiguous), so the
//   (B, T, H, D) projections of the caller need no transposing copy; a view
//   whose base or strides are not 16-byte aligned is staged by element loads.
//
// What bounds it on the card: at the main path's shapes (B*H = 32, T = 256
// or 512, D = 32) a call does 4*B*H*T^2*D = 1.07 GFLOP (T = 512) against
// 4.3 MB of inputs and outputs, so it is bound by operations. The fastest
// f32-accurate route for them is 3xTF32 on the tensor cores (495/3 = 165
// TFLOP/s at 700 W), 2.5x the f32 peak of the CUDA cores where the previous
// design ran; this design puts them there, and its 64-row tiles give 128
// (T = 256) or 256 (T = 512) blocks across the 132 SMs. wgmma, TMA and warp
// specialisation, the road to the full tensor-core rate, are left for later.

#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int BQ = 64;                 // query rows per block, 16 a warp
constexpr int BK = 64;                 // keys per shared-memory tile
constexpr int THREADS = 128;

template <int D, typename T>
constexpr size_t smem_bytes() {
    // the Q tile and two buffers each of the K and V tiles
    return sizeof(T) * (size_t)(BQ + 4 * BK) * pitch<D, T>();
}

// At least one block an SM: ptxas may then take up to 255 registers where it
// would otherwise spill to fit more blocks, which the 128-256 blocks of the
// main path's grids do not need.
template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 int64_t qsb, int64_t qsh, int64_t qst,
                 int64_t ksb, int64_t ksh, int64_t kst,
                 int64_t vsb, int64_t vsh, int64_t vst, float scale, int vec) {
    constexpr int LD = pitch<D, T>();
    constexpr int CH = chunk<BF16_OPS>();
    constexpr int NC = D / CH;         // depth chunks of S = Q K^T
    constexpr int NS = BK / 8;         // 8-key column blocks of S
    constexpr int NO = D / 8;          // 8-column blocks of O
    constexpr bool Q_REGS = D <= 64;
    extern __shared__ __align__(16) unsigned char flash_smem[];
    T* sQ = reinterpret_cast<T*>(flash_smem);
    T* sK = sQ + BQ * LD;              // two buffers
    T* sV = sK + 2 * BK * LD;          // two buffers

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;         // B·H on x, up to 2^31 − 1 blocks
    const int b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * BQ;
    const T* kb = k + b * ksb + h * ksh;
    const T* vb = v + b * vsb + h * vsh;
    const T* sQw = sQ + warp * 16 * LD;  // the warp's 16 query rows

    stage_tile<BQ, D, THREADS>(sQ, q + b * qsb + h * qsh, qst, q0, Tq, vec & 1);
    stage_tile<BK, D, THREADS>(sK, kb, kst, 0, Tk, vec & 2);
    stage_tile<BK, D, THREADS>(sV, vb, vst, 0, Tk, vec & 4);
    cp_async_commit();

    // f32 mode scales q before the dot, the bf16 mode after it
    auto q_chunk = [&](int c) {
        return gather_a<BF16_OPS>([&](int r, int kk) {
            const float x = to_f32(sQw[r * LD + c * CH + kk]);
            return BF16_OPS ? x : x * scale;
        });
    };
    AKept<BF16_OPS> qk[Q_REGS ? NC : 1];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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
        cp_async_wait<1>();            // this tile (and, at first, Q) has landed
        __syncthreads();
        if constexpr (Q_REGS) {
            if (it == 0) {
#pragma unroll
                for (int c = 0; c < NC; ++c) qk[c] = keep<BF16_OPS>(q_chunk(c));
            }
        }
        const T* cK = sK + (it & 1) * BK * LD;
        const T* cV = sV + (it & 1) * BK * LD;

        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            AFrag<BF16_OPS> a;
            if constexpr (Q_REGS) a = frag(qk[c]);
            else a = a_from_vals<BF16_OPS>(q_chunk(c));
#pragma unroll
            for (int j = 0; j < NS; ++j)
                mma<BF16_OPS>(s[j], a, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cK[(j * 8 + n) * LD + c * CH + kk]);
                }));
        }

        // online softmax of rows g (s[j][0..1]) and g + 8 (s[j][2..3])
        const int key0 = it * BK + 2 * t;  // the key of s[0][0]
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = BF16_OPS ? s[j][e] * scale : s[j][e];
                if (key0 + j * 8 + (e & 1) >= Tk) x = -INFINITY;
                s[j][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            // finite: every tile holds at least one key below Tk
            const float m_new = fmaxf(m[r], quad_max(mx[r]));
            alpha[r] = expf(m[r] - m_new);
            m[r] = m_new;
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(s[j][e] - m[e >> 1]);
                l[e >> 1] += p;        // the lane's share; the quad sums at the end
                s[j][e] = p;
            }
        }
#pragma unroll
        for (int j = 0; j < NO; ++j) {
            acc[j][0] *= alpha[0];
            acc[j][1] *= alpha[0];
            acc[j][2] *= alpha[1];
            acc[j][3] *= alpha[1];
        }

        // O += P V, P from the S registers; masked keys have p = 0 and V = 0
#pragma unroll
        for (int c = 0; c < BK / CH; ++c) {
            const AFrag<BF16_OPS> a = a_from_acc<BF16_OPS>(&s[c * (CH / 8)]);
#pragma unroll
            for (int j = 0; j < NO; ++j)
                mma<BF16_OPS>(acc[j], a, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cV[(c * CH + key_of(kk)) * LD + j * 8 + n]);
                }));
        }
        __syncthreads();               // the buffers are free for the tile after next
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row < Tq) {
            const float lc = fmaxf(l[r], 1e-30f);
            T* orow = o + ((int64_t)bh * Tq + row) * D + 2 * t;
#pragma unroll
            for (int j = 0; j < NO; ++j)
                store2(orow + j * 8, acc[j][2 * r] / lc, acc[j][2 * r + 1] / lc);
            if (t == 0)
                lse[(int64_t)bh * Tq + row] = l[r] > 0.f ? m[r] + logf(lc) : INFINITY;
        }
    }
}

template <int D, typename T, bool BF16_OPS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int H, int Tq, int Tk, float scale, const int64_t* st,
                   cudaStream_t stream) {
    auto kernel = flash_fwd_kernel<D, T, BF16_OPS>;
    constexpr size_t smem = smem_bytes<D, T>();
    static bool configured = false;  // the attribute is set once per instance
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const void* inputs[] = {q, k, v};
    dim3 grid(B * H, (Tq + BQ - 1) / BQ);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), H, Tq, Tk,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        scale, aligned_rows_mask(inputs, st, sizeof(T)));
    return cudaGetLastError();
}

template <typename T, bool BF16_OPS>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int H, int Tq, int Tk, int D, float scale,
                       const int64_t* st, cudaStream_t stream) {
    switch (D) {
        case 16: return launch<16, T, BF16_OPS>(q, k, v, o, lse, B, H, Tq, Tk, scale, st, stream);
        case 32: return launch<32, T, BF16_OPS>(q, k, v, o, lse, B, H, Tq, Tk, scale, st, stream);
        case 64: return launch<64, T, BF16_OPS>(q, k, v, o, lse, B, H, Tq, Tk, scale, st, stream);
        case 128: return launch<128, T, BF16_OPS>(q, k, v, o, lse, B, H, Tq, Tk, scale, st, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q, k, v: (B, H, T, D) with element strides (batch, head, time) given in
// `strides` as q's three, then k's, then v's; the last dim is contiguous.
// o: contiguous (B, H, Tq, D) of the input type; lse: contiguous (B, H, Tq)
// f32. is_bf16 selects bf16 storage (else f32); bf16_ops the bf16 tile
// operands. D is a kernel instance's head dim; scale multiplies the logits
// (one over the root of the true head dim d <= D, where the caller zero-pads
// q, k and v from d to D). Returns the cudaError_t of the launch.
extern "C" int mmef_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int H, int Tq, int Tk, int D,
                              int is_bf16, int bf16_ops, float scale,
                              const int64_t* strides, void* stream) {
    if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || (int64_t)B * H > INT32_MAX
        || (Tq + BQ - 1) / BQ > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)(bf16_ops
            ? dispatch_d<__nv_bfloat16, true>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, strides, s)
            : dispatch_d<__nv_bfloat16, false>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, strides, s));
    return (int)(bf16_ops
        ? dispatch_d<float, true>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, strides, s)
        : dispatch_d<float, false>(q, k, v, o, lse, B, H, Tq, Tk, D, scale, strides, s));
}
