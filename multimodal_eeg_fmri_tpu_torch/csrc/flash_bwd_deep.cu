// Flash-attention backward past head dim 256 on Hopper's tensor cores
// (sm_90a), plain C entry points for ctypes.
//
// Replaces, for head dims past 256, the two Pallas TPU kernels of
// `multimodal_eeg_fmri_tpu/ops/attention.py:_flash_backward`:
// - K2, `_bwd_dkv_kernel` (:121, pallas_call at :311) -> mmef_flash_bwd_dkv_deep
// - K3, `_bwd_dq_kernel` (:173, pallas_call at :339)  -> mmef_flash_bwd_dq_deep
// They compute the functions of flash_bwd_split.cu's K2 and K3, in the same
// three modes (f32 storage as 3xTF32, bf16 storage, BF16_OPS), from the
// caller's lse and Delta (g_lse folded in): S = Q K^T * scale (after the
// dot), P = exp(S - lse), dP = dO V^T, dS = P (dP - Delta); K2 sums
// dV = P^T dO and dK = dS^T Q * scale over the query tiles, K3
// dQ = dS K * scale over the key tiles. Each block owns its output rows and
// columns and writes them once, the sums in a fixed order, so results
// repeat bit for bit; no atomics. The wrapper zero-pads the head dim to a
// multiple of CK = 64 and passes the true scale 1/sqrt(d) (ops/attention.py):
// one instance a mode serves every head dim from 257 to the port's limit.
//
// Why not flash_bwd_split.cu's kernels with a wider D: they keep the owned
// rows' whole width in shared memory beside two buffers of the streamed
// rows (204 KB of the 227 KB at D = 256 in f32) and give each warp D/8
// output columns of all 32 rows in registers (48-64 a lane in K2 at 256).
// Both grow with D. Here neither does:
// - Score side: the (32 owned x 32 streamed) tiles S and dP do not grow
//   with D. They are summed over D in chunks of CK columns: each chunk
//   stages CK columns of the four operands (the owned rows too, so nothing
//   of width D stays resident) through a ring of STAGES buffers filled by
//   16-byte cp.async, STAGES - 1 chunks in flight while one is multiplied.
//   Each warp sums one 16 x 8 fragment of S and of dP (m16n8k8 3xTF32, or
//   m16n8k16 bf16) in two chains of alternate depth steps, forms P and dS
//   in its registers after the last chunk, and writes them once to shared
//   memory in fragment order, from where every warp reads them back as the
//   A operand of the D-wide products (flash_mma.cuh, a_from_frags).
// - D-wide side: a block owns a column slice of at most NO = 8 chunks (512
//   columns), warp w the 8-column block w of each of its chunks, so the
//   accumulators take 128 f32 registers a lane in K2 (dK and dV) and 64 in
//   K3. After the score chunks of a streamed tile, the slice's chunks of
//   the streamed rows (Q and dO in K2, K in K3) come through the same ring,
//   PER chunks to a buffer, and each warp multiplies the shared P^T and
//   dS^T (or dS) into its columns, each depth step's P and dS fragments
//   loaded once for all the buffer's chunks. Head dims past 512 take more
//   blocks on the grid's z axis, one per slice, each recomputing the score
//   side: at two slices (D in (512, 1024]) that is 1.5x K2's products and
//   1.67x K3's.
//
// What bounds it on the card: operations. K2 does 8*B*H*Tq*Tk*D flops and
// K3 6*B*H*Tq*Tk*D (at (8, 4, 512, 320): 21.5 and 16.1 GFLOP) against a few
// tens of MB; at 3xTF32's 165 TFLOP/s (f32 storage) that is 0.130 and
// 0.098 ms. The design keeps every product on the tensor cores; what it
// adds over the split kernels is the owned rows' chunks staged again for
// each streamed tile (from L2) and a barrier a ring stage. On the H100 it
// reaches 9-10% of the f32 bound at D = 320 and 512 (PERF.md); with slices
// of 256 columns K2 took 1.47x longer at 320. wgmma and TMA are left for
// later work.

#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int BR = 32;                 // owned rows a block: keys in K2, queries in K3
constexpr int BS = 32;                 // rows a streamed tile: queries in K2, keys in K3
constexpr int CK = 64;                 // columns a staged chunk
constexpr int STAGES = 3;              // ring buffers: STAGES - 1 chunks in flight
constexpr int NO = 8;                  // chunks a column slice: 512 columns
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = BR / 16;            // 16-row blocks of the score tile
constexpr int NT = BS / 8;             // 8-column blocks of the score tile
constexpr int FRAG_FLOATS = MT * NT * 32 * 4;  // one 32 x 32 tile in fragment order
static_assert(MT * NT == WARPS, "one score fragment a warp");
static_assert(CK / 8 == WARPS, "one 8-column block of a chunk a warp");


struct Params {
    const void *q, *k, *v, *dout;
    const float *lse, *delta;
    void *out0, *out1;                 // dK and dV for K2; dQ for K3
    int H, Tq, Tk;
    int D;                             // the padded head dim, a multiple of CK
    int n_slices;                      // column slices, on the grid's z axis
    int64_t st[12];                    // q, k, v, dO strides (batch, head, time)
    float scale;                       // one over the root of the true head dim
    int vec;                           // aligned_rows_mask of q, k, v, dO
};

// A ring buffer: four tiles of 32 rows of a chunk (owned1, owned2,
// streamed1, streamed2 of a score chunk; streamed1 and streamed2 of two
// slice chunks in K2, streamed1 of four in K3).
template <typename T>
__host__ __device__ constexpr int stage_elems() {
    return 4 * BR * pitch<CK, T>();
}

template <typename T, bool DKV>
constexpr size_t smem_bytes() {
    // P^T (K2) and dS in fragment order, then the ring
    return sizeof(float) * (DKV ? 2 : 1) * FRAG_FLOATS
        + sizeof(T) * (size_t)STAGES * stage_elems<T>();
}

// K2 (DKV) and K3 in one body. "Owned" rows are the block's (keys in K2,
// queries in K3), "streamed" rows the loop's tiles. The score products are
// X1 = owned1 streamed1^T and X2 = owned2 streamed2^T: S^T = K Q^T and
// dP^T = V dO^T in K2, S = Q K^T and dP = dO V^T in K3.
template <typename T, bool BF16_OPS, bool DKV>
__device__ __forceinline__ void bwd_deep(const Params& p) {
    constexpr int LD = pitch<CK, T>();
    constexpr int CH = chunk<BF16_OPS>();
    constexpr int SLOT = BR * LD;      // a tile of 32 rows of a chunk
    constexpr int STAGE = 4 * SLOT;
    constexpr int PER = DKV ? 2 : 4;   // slice chunks a ring buffer holds
    static_assert(BR == BS && CK % (2 * CH) == 0 && BS % CH == 0 && NO % PER == 0, "tiles");
    extern __shared__ __align__(16) unsigned char deep_smem[];
    float* sP = reinterpret_cast<float*>(deep_smem);  // P^T, fragment order (K2)
    float* sDS = sP + (DKV ? FRAG_FLOATS : 0);        // dS^T or dS, fragment order
    T* ring = reinterpret_cast<T*>(sDS + FRAG_FLOATS);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;         // B·H on x, up to 2^31 − 1 blocks
    const int b = bh / p.H, h = bh % p.H;
    const int r0 = blockIdx.y * BR;
    const int n_owned = DKV ? p.Tk : p.Tq, n_streamed = DKV ? p.Tq : p.Tk;
    // the block's column slice: chunks [first, first + n_mine) of the D / CK
    // (at most NO: the host takes n_slices = ceil(D / CK / NO))
    const int n_chunks = p.D / CK;
    const int first = (int)blockIdx.z * n_chunks / p.n_slices;
    const int n_mine = ((int)blockIdx.z + 1) * n_chunks / p.n_slices - first;
    // ring stages a streamed tile: its score chunks, then its slice chunks,
    // PER to a ring buffer
    const int per_tile = n_chunks + (n_mine + PER - 1) / PER;
    const int n_tiles = (n_streamed + BS - 1) / BS;
    const int n_stages = n_tiles * per_tile;
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

    // Stage s of the block's sequence into its ring buffer: a score chunk
    // (CK columns of owned1, owned2, streamed1 and streamed2, a slot each),
    // or up to PER chunks of the slice (streamed1, and streamed2 in K2).
    auto fetch = [&](int s) {
        T* buf = ring + (s % STAGES) * STAGE;
        const int it = s / per_tile, c = s - it * per_tile;
        const int s0 = it * BS;
        if (c < n_chunks) {
            const int col = c * CK;
            stage_tile<BR, CK, THREADS>(buf, o1 + col, p.st[3 * O1 + 2], r0, n_owned,
                                        p.vec & (1 << O1));
            stage_tile<BR, CK, THREADS>(buf + SLOT, o2 + col, p.st[3 * O2 + 2], r0,
                                        n_owned, p.vec & (1 << O2));
            stage_tile<BS, CK, THREADS>(buf + 2 * SLOT, s1 + col, p.st[3 * S1 + 2], s0,
                                        n_streamed, p.vec & (1 << S1));
            stage_tile<BS, CK, THREADS>(buf + 3 * SLOT, s2 + col, p.st[3 * S2 + 2], s0,
                                        n_streamed, p.vec & (1 << S2));
            return;
        }
        const int i0 = (c - n_chunks) * PER;
        for (int i = 0; i < PER && i0 + i < n_mine; ++i) {
            const int col = (first + i0 + i) * CK;
            T* slot = buf + (DKV ? 2 * i : i) * SLOT;
            stage_tile<BS, CK, THREADS>(slot, s1 + col, p.st[3 * S1 + 2], s0, n_streamed,
                                        p.vec & (1 << S1));
            if constexpr (DKV)
                stage_tile<BS, CK, THREADS>(slot + SLOT, s2 + col, p.st[3 * S2 + 2], s0,
                                            n_streamed, p.vec & (1 << S2));
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_stages) fetch(s);
        cp_async_commit();
    }
    int stage = 0;                     // the next stage to consume
    // wait for it, refill the buffer consumed before it with the stage
    // STAGES - 1 ahead, and return its buffer
    auto advance = [&]() -> const T* {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (stage + STAGES - 1 < n_stages) fetch(stage + STAGES - 1);
        cp_async_commit();
        return ring + (stage++ % STAGES) * STAGE;
    };

    // the warp's score fragment: owned rows 16 m + (g, g + 8), streamed
    // columns 8 j + (2t, 2t + 1)
    const int m = warp / NT, j = warp % NT;
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

    for (int it = 0; it < n_tiles; ++it) {
        const int col = j * 8 + 2 * t;  // streamed column of x[0]
        float lse_c[2], delta_c[2];    // K2: by query (column); padded: P = 0
        if constexpr (DKV) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int qi = it * BS + col + e;
                lse_c[e] = qi < p.Tq ? lse_bh[qi] : INFINITY;
                delta_c[e] = qi < p.Tq ? delta_bh[qi] : 0.f;
            }
        }

        // X1 and X2 of the warp's fragment, summed over the score chunks in
        // two chains of alternate depth steps (a chain of 3xTF32 products
        // is three dependent mma a step)
        float y1[2][4] = {}, y2[2][4] = {};
        for (int c = 0; c < n_chunks; ++c) {
            const T* buf = advance();
            const T* cO1 = buf + m * 16 * LD;
            const T* cO2 = buf + SLOT + m * 16 * LD;
            const T* cS1 = buf + 2 * SLOT + j * 8 * LD;
            const T* cS2 = buf + 3 * SLOT + j * 8 * LD;
#pragma unroll
            for (int kc = 0; kc < CK / CH; ++kc) {
                const AFrag<BF16_OPS> a1 = load_a<BF16_OPS>([&](int r, int kk) {
                    return to_f32(cO1[r * LD + kc * CH + kk]);
                });
                const AFrag<BF16_OPS> a2 = load_a<BF16_OPS>([&](int r, int kk) {
                    return to_f32(cO2[r * LD + kc * CH + kk]);
                });
                mma<BF16_OPS>(y1[kc & 1], a1, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cS1[n * LD + kc * CH + kk]);
                }));
                mma<BF16_OPS>(y2[kc & 1], a2, load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cS2[n * LD + kc * CH + kk]);
                }));
            }
        }

        // P = exp(S scale - lse) and dS = P (dP - Delta), written once in
        // fragment order; the next stage's barrier makes them whole (and
        // the last chunk's barrier of the tile before saw them read)
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x1 = y1[0][e] + y1[1][e], x2 = y2[0][e] + y2[1][e];
            float pe, dl;
            if constexpr (DKV) {       // lse and Delta by query (column)
                pe = owned_ok[e >> 1] ? expf(x1 * p.scale - lse_c[e & 1]) : 0.f;
                dl = delta_c[e & 1];
            } else {                   // by query (row); keys past Tk masked
                pe = it * BS + col + (e & 1) < p.Tk ? expf(x1 * p.scale - lse_r[e >> 1])
                                                    : 0.f;
                dl = delta_r[e >> 1];
            }
            pv[e] = pe;
            dsv[e] = pe * (x2 - dl);
        }
        const int slot = ((m * NT + j) * 32 + lane) * 4;
        *reinterpret_cast<float4*>(sDS + slot) = make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
        if constexpr (DKV)
            *reinterpret_cast<float4*>(sP + slot) = make_float4(pv[0], pv[1], pv[2], pv[3]);

        // the warp's 8 columns of each chunk of the slice: dV += P^T dO and
        // dK += dS^T Q (K2), dQ += dS K (K3), over the tile's streamed rows
        // in key_of order, PER chunks a ring buffer; each depth step's P
        // and dS fragments serve all the buffer's chunks. Padded rows have
        // P = dS = 0 and zero operands
#pragma unroll
        for (int j0 = 0; j0 < NO; j0 += PER) {
            if (j0 >= n_mine) break;   // the same for the whole block
            const T* buf = advance() + warp * 8;
#pragma unroll
            for (int c = 0; c < BS / CH; ++c) {
                AFrag<BF16_OPS> da[MT], pa[DKV ? MT : 1];
#pragma unroll
                for (int mm = 0; mm < MT; ++mm) {
                    da[mm] = a_from_frags<BF16_OPS, NT>(sDS, mm, c);
                    if constexpr (DKV) pa[mm] = a_from_frags<BF16_OPS, NT>(sP, mm, c);
                }
#pragma unroll
                for (int i = 0; i < PER; ++i) {
                    const int jo = j0 + i;
                    if (jo >= n_mine) break;
                    // streamed1 is Q in K2 (for dK) and K in K3 (for dQ)
                    const T* cS1 = buf + (DKV ? 2 * i : i) * SLOT;
                    const BFrag<BF16_OPS> b1 = load_b<BF16_OPS>([&](int kk, int n) {
                        return to_f32(cS1[(c * CH + key_of(kk)) * LD + n]);
                    });
                    if constexpr (DKV) {
                        const BFrag<BF16_OPS> b2 = load_b<BF16_OPS>([&](int kk, int n) {
                            return to_f32(cS1[SLOT + (c * CH + key_of(kk)) * LD + n]);
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
        }
    }

    T* out0 = static_cast<T*>(p.out0);
    T* out1 = static_cast<T*>(p.out1);
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + mm * 16 + g + 8 * r;
            if (row >= n_owned) continue;
            const int64_t at = ((int64_t)bh * n_owned + row) * p.D + warp * 8 + 2 * t;
#pragma unroll
            for (int jo = 0; jo < NO; ++jo) {
                if (jo >= n_mine) break;
                const int64_t o = at + (int64_t)(first + jo) * CK;
                const float* a1 = acc1[mm][jo];
                if constexpr (DKV) {
                    const float* a2 = acc2[mm][jo];
                    store2(out0 + o, a2[2 * r] * p.scale, a2[2 * r + 1] * p.scale);
                    store2(out1 + o, a1[2 * r], a1[2 * r + 1]);
                } else {
                    store2(out0 + o, a1[2 * r] * p.scale, a1[2 * r + 1] * p.scale);
                }
            }
        }
}

// At least one block an SM: registers before occupancy, as K1-K3.
template <typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_deep_kernel(const Params p) {
    bwd_deep<T, BF16_OPS, true>(p);
}

template <typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_deep_kernel(const Params p) {
    bwd_deep<T, BF16_OPS, false>(p);
}

template <typename T, bool BF16_OPS, bool DKV>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
    auto kernel = DKV ? flash_bwd_dkv_deep_kernel<T, BF16_OPS>
                      : flash_bwd_dq_deep_kernel<T, BF16_OPS>;
    constexpr size_t smem = smem_bytes<T, DKV>();
    static bool configured = false;    // the attribute is set once per instance
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const void* inputs[] = {p.q, p.k, p.v, p.dout};
    p.vec = aligned_rows_mask(inputs, p.st, sizeof(T));
    dim3 grid(B * p.H, ((DKV ? p.Tk : p.Tq) + BR - 1) / BR, p.n_slices);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool DKV>
int dispatch(int is_bf16, int bf16_ops, int B, Params p, void* stream) {
    if (B <= 0 || p.H <= 0 || p.Tq <= 0 || p.Tk <= 0 || p.D <= 0 || p.D % CK != 0
        || (int64_t)B * p.H > INT32_MAX || ((DKV ? p.Tk : p.Tq) + BR - 1) / BR > 65535)
        return (int)cudaErrorInvalidValue;
    p.n_slices = (p.D / CK + NO - 1) / NO;
    if (p.n_slices > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)(bf16_ops ? launch<__nv_bfloat16, true, DKV>(p, B, s)
                              : launch<__nv_bfloat16, false, DKV>(p, B, s));
    return (int)(bf16_ops ? launch<float, true, DKV>(p, B, s)
                          : launch<float, false, DKV>(p, B, s));
}

Params params(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* out0, void* out1, int H,
              int Tq, int Tk, int D, float scale, const int64_t* strides) {
    Params p{q, k, v, dout, static_cast<const float*>(lse),
             static_cast<const float*>(delta), out0, out1, H, Tq, Tk, D, 0, {}, scale, 0};
    for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
    return p;
}

}  // namespace

// Arguments as mmef_flash_bwd_dkv (flash_bwd.cu); D a multiple of 64 (the
// wrapper pads a head dim past 256 to one; scale is the true one); dk, dv
// contiguous (B, H, Tk, D). Another D returns cudaErrorInvalidValue.
extern "C" int mmef_flash_bwd_dkv_deep(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int B,
                                       int H, int Tq, int Tk, int D, int is_bf16,
                                       int bf16_ops, float scale, const int64_t* strides,
                                       void* stream) {
    return dispatch<true>(is_bf16, bf16_ops, B,
                          params(q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, D, scale,
                                 strides),
                          stream);
}

// As mmef_flash_bwd_dkv_deep; dq: contiguous (B, H, Tq, D) of the input type.
extern "C" int mmef_flash_bwd_dq_deep(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int H, int Tq, int Tk, int D,
                                      int is_bf16, int bf16_ops, float scale,
                                      const int64_t* strides, void* stream) {
    return dispatch<false>(is_bf16, bf16_ops, B,
                           params(q, k, v, dout, lse, delta, dq, nullptr, H, Tq, Tk, D,
                                  scale, strides),
                           stream);
}
