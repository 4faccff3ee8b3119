// Flash-attention backward past head dim 128 on Hopper's tensor cores
// (sm_90a), plain C entry points for ctypes.
//
// Replaces, for head dims in (128, 256], the two Pallas TPU kernels of
// `multimodal_eeg_fmri_tpu/ops/attention.py:_flash_backward`:
// - K2, `_bwd_dkv_kernel` (:121, pallas_call at :311) -> mmef_flash_bwd_dkv_split
// - K3, `_bwd_dq_kernel` (:173, pallas_call at :339)  -> mmef_flash_bwd_dq_split
// They compute the functions of flash_bwd.cu's K2 and K3, in the same three
// modes (f32 storage as 3xTF32, bf16 storage, BF16_OPS), from the caller's
// lse and Delta (g_lse folded in): S = Q K^T * scale (after the dot),
// P = exp(S - lse), dP = dO V^T, dS = P (dP - Delta); K2 sums dV = P^T dO
// and dK = dS^T Q * scale over the query tiles, K3 dQ = dS K * scale over
// the key tiles. Each block owns its output rows and writes them once, the
// sums in a fixed order, so results repeat bit for bit; no atomics.
//
// Why not flash_bwd.cu's kernels with a wider D: they keep a warp's 16 rows
// of every D-wide output in its registers (K2 spills already at D = 128),
// and their 64-row tiles of four D-wide operands outgrow shared memory.
// The wrapper zero-pads a head dim in (128, 256] to the instance 192 or 256
// and passes the true scale 1/sqrt(d) (ops/attention.py); past 256
// flash_bwd_deep.cu runs.
//
// Design (8 warps, a block per (b*h on grid x, 32 owned rows on y)):
// - The owned side stays in shared memory: K and V rows in K2, Q and dO rows
//   in K3. The other side streams in 32-row tiles (Q, dO, lse and Delta in
//   K2; K and V in K3), double-buffered by 16-byte cp.async: the next tile's
//   copy is in flight while this tile's products run. At D = 256 in f32 that
//   is 2 x 32 KB resident and 4 x 32 KB streamed, 204 KB of the 227 KB: one
//   block an SM (bf16 storage: 108 KB, but 175-203 registers a thread keep
//   it at one block too).
// - Score side: the (32 owned x 32 streamed) tiles S and dP do not grow with
//   D. Each warp takes one 16 x 8 fragment of both, summed over all of D
//   from shared memory (m16n8k8 3xTF32, or m16n8k16 bf16) in two chains of
//   alternate chunks, forms P and dS in its registers, and writes them once
//   to shared memory in fragment order: a lane's four accumulator values as
//   one float4, which the other warps read back as the A operand of the
//   D-wide products in 16-byte loads (the streamed rows then taken in key_of
//   order, so that the B reads below hit 32 banks).
// - D-wide side: the outputs are split by column slice over the warps, D/8
//   columns each (24 or 32), all 32 rows: dK and dV take 48-64 f32 registers
//   a lane in K2, dQ 24-32 in K3, so no warp holds all of D and nothing
//   spills. Each warp multiplies the shared P^T and dS^T (or dS) into its
//   own columns of dO and Q (or K), read from the streamed tile.
//
// What bounds it on the card: operations. K2 does 8*B*H*Tq*Tk*D flops and
// K3 6*B*H*Tq*Tk*D (at (8, 4, 512, 256): 17.2 and 12.9 GFLOP) against a few
// tens of MB; at 3xTF32's 165 TFLOP/s (f32 storage) or bf16's 989 that is
// 0.104 and 0.078 ms in f32. The design puts every product on the tensor
// cores and keeps the score side's work from growing with the D-wide side:
// per streamed tile each warp reads its score fragment's operands over D
// and the shared 32 x 32 P and dS once. The 32-row tiles give 512 blocks at
// B*H = 32, T = 512 (3.9 waves over 132 SMs). On the H100 this reaches
// 15-19% of the f32 bound at D = 256, as K2 and K3 do at D <= 128; 16
// warps a block, or the owned rows kept split into TF32 parts in shared
// memory, ran no faster (PERF.md), and the bf16-operand mode, a third of
// the mma, only 2.1-2.2x faster: the mma.sync rate and the split's ALU work
// share the limit.
// wgmma and TMA are left for later work.

#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int BR = 32;                 // owned rows a block: keys in K2, queries in K3
constexpr int BS = 32;                 // rows a streamed tile: queries in K2, keys in K3
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = BR / 16;            // 16-row blocks of the score tile
constexpr int NT = BS / 8;             // 8-column blocks of the score tile
constexpr int FRAG_FLOATS = MT * NT * 32 * 4;  // one 32 x 32 tile in fragment order
static_assert(MT * NT == WARPS, "one score fragment a warp");

struct Params {
    const void *q, *k, *v, *dout;
    const float *lse, *delta;
    void *out0, *out1;                 // dK and dV for K2; dQ for K3
    int H, Tq, Tk;
    int64_t st[12];                    // q, k, v, dO strides (batch, head, time)
    float scale;                       // one over the root of the true head dim
    int vec;                           // aligned_rows_mask of q, k, v, dO
};

template <int D, typename T, bool DKV>
constexpr size_t smem_bytes() {
    // P^T (K2) and dS in fragment order; K2's lse and Delta, two buffers
    // each; the two owned tiles; two buffers each of the two streamed tiles
    return sizeof(float) * ((DKV ? 2 : 1) * FRAG_FLOATS + (DKV ? 4 * BS : 0))
        + sizeof(T) * (size_t)(2 * BR + 4 * BS) * pitch<D, T>();
}

// K2 (DKV) and K3 in one body. "Owned" rows are the block's (keys in K2,
// queries in K3), "streamed" rows the loop's tiles. The score products are
// X1 = owned1 streamed1^T and X2 = owned2 streamed2^T: S^T = K Q^T and
// dP^T = V dO^T in K2, S = Q K^T and dP = dO V^T in K3.
template <int D, typename T, bool BF16_OPS, bool DKV>
__device__ __forceinline__ void bwd_split(const Params& p) {
    constexpr int LD = pitch<D, T>();
    constexpr int CH = chunk<BF16_OPS>();
    constexpr int CW = D / WARPS;      // output columns a warp owns
    constexpr int NO = CW / 8;         // their 8-column blocks
    static_assert(CW % 8 == 0 && D % CH == 0, "head dim");
    extern __shared__ __align__(16) unsigned char split_smem[];
    float* sP = reinterpret_cast<float*>(split_smem);  // P^T, fragment order (K2)
    float* sDS = sP + (DKV ? FRAG_FLOATS : 0);         // dS^T or dS, fragment order
    float* sLse = sDS + FRAG_FLOATS;                   // K2: two buffers
    float* sDelta = sLse + (DKV ? 2 * BS : 0);         // K2: two buffers
    T* sO1 = reinterpret_cast<T*>(sDelta + (DKV ? 2 * BS : 0));
    T* sO2 = sO1 + BR * LD;
    T* sS1 = sO2 + BR * LD;            // two buffers
    T* sS2 = sS1 + 2 * BS * LD;        // two buffers

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;         // B·H on x, up to 2^31 − 1 blocks
    const int b = bh / p.H, h = bh % p.H;
    const int r0 = blockIdx.y * BR;
    const int n_owned = DKV ? p.Tk : p.Tq, n_streamed = DKV ? p.Tq : p.Tk;
    // the strides are read at constant indices only: a kernel parameter
    // whose address is taken is copied to the stack
    auto base = [&](const void* x, int i) {
        return static_cast<const T*>(x) + b * p.st[3 * i] + h * p.st[3 * i + 1];
    };
    // tensor index (q 0, k 1, v 2, dO 3) of owned1, owned2, streamed1, streamed2
    constexpr int O1 = DKV ? 1 : 0, O2 = DKV ? 2 : 3, S1 = DKV ? 0 : 1, S2 = DKV ? 3 : 2;
    const void* const ptrs[4] = {p.q, p.k, p.v, p.dout};
    const T* o1 = base(ptrs[O1], O1);
    const T* o2 = base(ptrs[O2], O2);
    const T* s1 = base(ptrs[S1], S1);
    const T* s2 = base(ptrs[S2], S2);
    const float* lse_bh = p.lse + (int64_t)bh * p.Tq;
    const float* delta_bh = p.delta + (int64_t)bh * p.Tq;

    auto stage_streamed = [&](int it) {
        const int buf = it & 1, s0 = it * BS;
        stage_tile<BS, D, THREADS>(sS1 + buf * BS * LD, s1, p.st[3 * S1 + 2], s0, n_streamed,
                                   p.vec & (1 << S1));
        stage_tile<BS, D, THREADS>(sS2 + buf * BS * LD, s2, p.st[3 * S2 + 2], s0, n_streamed,
                                   p.vec & (1 << S2));
        if constexpr (DKV) {
            const int i = threadIdx.x;
            if (i < BS) {
                if (s0 + i < p.Tq) {
                    cp_async4(sLse + buf * BS + i, lse_bh + s0 + i);
                    cp_async4(sDelta + buf * BS + i, delta_bh + s0 + i);
                } else {               // a padded query row: lse = +inf gives P = 0
                    sLse[buf * BS + i] = INFINITY;
                    sDelta[buf * BS + i] = 0.f;
                }
            }
        }
    };
    stage_tile<BR, D, THREADS>(sO1, o1, p.st[3 * O1 + 2], r0, n_owned, p.vec & (1 << O1));
    stage_tile<BR, D, THREADS>(sO2, o2, p.st[3 * O2 + 2], r0, n_owned, p.vec & (1 << O2));
    stage_streamed(0);
    cp_async_commit();

    // the warp's score fragment: owned rows 16 m + (g, g + 8), streamed
    // columns 8 j + (2t, 2t + 1)
    const int m = warp / NT, j = warp % NT;
    const T* sO1w = sO1 + m * 16 * LD;
    const T* sO2w = sO2 + m * 16 * LD;
    bool owned_ok[2];                  // K2: keys past Tk get P = 0
    float lse_r[2], delta_r[2];        // K3: a padded query row gets lse = +inf
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + m * 16 + g + 8 * r;
        owned_ok[r] = row < n_owned;
        if constexpr (!DKV) {
            lse_r[r] = row < p.Tq ? lse_bh[row] : INFINITY;
            delta_r[r] = row < p.Tq ? delta_bh[row] : 0.f;
        }
    }

    const int col0 = warp * CW;        // the warp's output columns
    float acc1[MT][NO][4];             // dV in K2, dQ in K3
    float acc2[DKV ? MT : 1][DKV ? NO : 1][4];  // dK in K2
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int jo = 0; jo < NO; ++jo)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc1[mm][jo][e] = 0.f;
                if constexpr (DKV) acc2[mm][jo][e] = 0.f;
            }

    const int n_tiles = (n_streamed + BS - 1) / BS;
    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) stage_streamed(it + 1);
        cp_async_commit();
        cp_async_wait<1>();            // this tile (and, at first, the owned rows) has landed
        __syncthreads();
        const T* cS1 = sS1 + (it & 1) * BS * LD;
        const T* cS2 = sS2 + (it & 1) * BS * LD;

        // X1 and X2 of the warp's fragment, summed over D in two chains of
        // alternate chunks (a chain of 3xTF32 products is three dependent
        // mma a chunk)
        float y1[2][4] = {}, y2[2][4] = {};
#pragma unroll
        for (int c = 0; c < D / CH; ++c) {
            const AFrag<BF16_OPS> a1 = load_a<BF16_OPS>([&](int r, int kk) {
                return to_f32(sO1w[r * LD + c * CH + kk]);
            });
            const AFrag<BF16_OPS> a2 = load_a<BF16_OPS>([&](int r, int kk) {
                return to_f32(sO2w[r * LD + c * CH + kk]);
            });
            mma<BF16_OPS>(y1[c & 1], a1, load_b<BF16_OPS>([&](int kk, int n) {
                return to_f32(cS1[(j * 8 + n) * LD + c * CH + kk]);
            }));
            mma<BF16_OPS>(y2[c & 1], a2, load_b<BF16_OPS>([&](int kk, int n) {
                return to_f32(cS2[(j * 8 + n) * LD + c * CH + kk]);
            }));
        }
        float x1[4], x2[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            x1[e] = y1[0][e] + y1[1][e];
            x2[e] = y2[0][e] + y2[1][e];
        }

        // P = exp(S scale - lse) and dS = P (dP - Delta), written once in
        // fragment order
        float pv[4], dsv[4];
        const int col = j * 8 + 2 * t;  // streamed column of x[0]
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float pe, dl;
            if constexpr (DKV) {       // lse and Delta by query (column)
                pe = owned_ok[e >> 1]
                    ? expf(x1[e] * p.scale - sLse[(it & 1) * BS + col + (e & 1)]) : 0.f;
                dl = sDelta[(it & 1) * BS + col + (e & 1)];
            } else {                   // by query (row); keys past Tk masked
                pe = it * BS + col + (e & 1) < p.Tk
                    ? expf(x1[e] * p.scale - lse_r[e >> 1]) : 0.f;
                dl = delta_r[e >> 1];
            }
            pv[e] = pe;
            dsv[e] = pe * (x2[e] - dl);
        }
        const int slot = ((m * NT + j) * 32 + lane) * 4;
        *reinterpret_cast<float4*>(sDS + slot) = make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
        if constexpr (DKV)
            *reinterpret_cast<float4*>(sP + slot) = make_float4(pv[0], pv[1], pv[2], pv[3]);
        __syncthreads();               // the tile's P and dS are whole

        // the warp's columns: dV += P^T dO and dK += dS^T Q (K2), dQ += dS K
        // (K3), over the tile's streamed rows in key_of order; padded rows
        // have P = dS = 0 and zero operands
#pragma unroll
        for (int c = 0; c < BS / CH; ++c) {
            AFrag<BF16_OPS> da[MT], pa[DKV ? MT : 1];
#pragma unroll
            for (int mm = 0; mm < MT; ++mm) {
                da[mm] = a_from_frags<BF16_OPS, NT>(sDS, mm, c);
                if constexpr (DKV) pa[mm] = a_from_frags<BF16_OPS, NT>(sP, mm, c);
            }
#pragma unroll
            for (int jo = 0; jo < NO; ++jo) {
                const int cc = col0 + jo * 8;
                // streamed1 is Q in K2 (for dK) and K in K3 (for dQ)
                const BFrag<BF16_OPS> b1 = load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cS1[(c * CH + key_of(kk)) * LD + cc + n]);
                });
                if constexpr (DKV) {
                    const BFrag<BF16_OPS> b2 = load_b<BF16_OPS>([&](int kk, int n) {
                        return to_f32(cS2[(c * CH + key_of(kk)) * LD + cc + n]);
                    });
#pragma unroll
                    for (int mm = 0; mm < MT; ++mm) {
                        mma<BF16_OPS>(acc1[mm][jo], pa[mm], b2);
                        mma<BF16_OPS>(acc2[mm][jo], da[mm], b1);
                    }
                } else {
#pragma unroll
                    for (int mm = 0; mm < MT; ++mm) mma<BF16_OPS>(acc1[mm][jo], da[mm], b1);
                }
            }
        }
        __syncthreads();               // the buffers are free for the tile after next
    }

    T* out0 = static_cast<T*>(p.out0);
    T* out1 = static_cast<T*>(p.out1);
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + mm * 16 + g + 8 * r;
            if (row >= n_owned) continue;
            const int64_t at = ((int64_t)bh * n_owned + row) * D + col0 + 2 * t;
#pragma unroll
            for (int jo = 0; jo < NO; ++jo) {
                const float* a1 = acc1[mm][jo];
                if constexpr (DKV) {
                    const float* a2 = acc2[mm][jo];
                    store2(out0 + at + jo * 8, a2[2 * r] * p.scale, a2[2 * r + 1] * p.scale);
                    store2(out1 + at + jo * 8, a1[2 * r], a1[2 * r + 1]);
                } else {
                    store2(out0 + at + jo * 8, a1[2 * r] * p.scale, a1[2 * r + 1] * p.scale);
                }
            }
        }
}

// At least one block an SM: registers before occupancy, as K1-K3.
template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_split_kernel(const Params p) {
    bwd_split<D, T, BF16_OPS, true>(p);
}

template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_split_kernel(const Params p) {
    bwd_split<D, T, BF16_OPS, false>(p);
}

template <int D, typename T, bool BF16_OPS, bool DKV>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
    auto kernel = DKV ? flash_bwd_dkv_split_kernel<D, T, BF16_OPS>
                      : flash_bwd_dq_split_kernel<D, T, BF16_OPS>;
    constexpr size_t smem = smem_bytes<D, T, DKV>();
    static bool configured = false;    // the attribute is set once per instance
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const void* inputs[] = {p.q, p.k, p.v, p.dout};
    p.vec = aligned_rows_mask(inputs, p.st, sizeof(T));
    dim3 grid(B * p.H, ((DKV ? p.Tk : p.Tq) + BR - 1) / BR);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool DKV, typename T, bool BF16_OPS>
cudaError_t by_head_dim(int D, const Params& p, int B, cudaStream_t s) {
    switch (D) {
        case 192: return launch<192, T, BF16_OPS, DKV>(p, B, s);
        case 256: return launch<256, T, BF16_OPS, DKV>(p, B, s);
        default: return cudaErrorInvalidValue;
    }
}

template <bool DKV>
int dispatch(int D, int is_bf16, int bf16_ops, int B, const Params& p, void* stream) {
    if (B <= 0 || p.H <= 0 || p.Tq <= 0 || p.Tk <= 0 || (int64_t)B * p.H > INT32_MAX
        || ((DKV ? p.Tk : p.Tq) + BR - 1) / BR > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)(bf16_ops ? by_head_dim<DKV, __nv_bfloat16, true>(D, p, B, s)
                              : by_head_dim<DKV, __nv_bfloat16, false>(D, p, B, s));
    return (int)(bf16_ops ? by_head_dim<DKV, float, true>(D, p, B, s)
                          : by_head_dim<DKV, float, false>(D, p, B, s));
}

Params params(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* out0, void* out1, int H,
              int Tq, int Tk, float scale, const int64_t* strides) {
    Params p{q, k, v, dout, static_cast<const float*>(lse),
             static_cast<const float*>(delta), out0, out1, H, Tq, Tk, {}, scale, 0};
    for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
    return p;
}

}  // namespace

// Arguments as mmef_flash_bwd_dkv (flash_bwd.cu), D = 192 or 256 (the
// wrapper pads a head dim in (128, 256] to one of them; scale is the true
// one); other D return cudaErrorInvalidValue.
extern "C" int mmef_flash_bwd_dkv_split(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int B,
                                        int H, int Tq, int Tk, int D, int is_bf16,
                                        int bf16_ops, float scale, const int64_t* strides,
                                        void* stream) {
    return dispatch<true>(D, is_bf16, bf16_ops, B,
                          params(q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, scale,
                                 strides),
                          stream);
}

// As mmef_flash_bwd_dkv_split; dq: contiguous (B, H, Tq, D) of the input type.
extern "C" int mmef_flash_bwd_dq_split(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dq, int B, int H, int Tq,
                                       int Tk, int D, int is_bf16, int bf16_ops,
                                       float scale, const int64_t* strides, void* stream) {
    return dispatch<false>(D, is_bf16, bf16_ops, B,
                           params(q, k, v, dout, lse, delta, dq, nullptr, H, Tq, Tk, scale,
                                  strides),
                           stream);
}
