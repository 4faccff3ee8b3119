// Flash-attention forward past head dim 256 on Hopper's tensor cores
// (sm_90a), plain C entry point for ctypes.
//
// Replaces, for head dims past 256, the Pallas TPU kernel K1,
// `multimodal_eeg_fmri_tpu/ops/attention.py:_fwd_kernel` (:63, pallas_call at
// :248 in `_flash_forward`) -> mmef_flash_fwd_deep. It computes the function
// of flash_fwd_split.cu's K1 in the same three modes (f32 storage as 3xTF32,
// bf16 storage, BF16_OPS): per (batch, head), O = softmax(Q K^T * scale) V
// and the per-row lse = m + log l, by online softmax (running max m, running
// sum l and the accumulator in f32, rescaled as each key tile arrives), keys
// past Tk masked to -inf, O = acc / max(l, 1e-30) in q's dtype. f32 mode
// scales q before the q.k dot, BF16_OPS after it; BF16_OPS rounds q, k, p
// and v to bf16 and keeps every sum in f32. Each block owns its query rows
// and output columns and writes them once, every sum in a fixed order, so
// results repeat bit for bit; no atomics. The wrapper zero-pads the head dim
// to a multiple of CK = 64 and passes the true scale 1/sqrt(d)
// (ops/attention.py): the zero columns add nothing to Q K^T and give zero
// output columns, and one instance a mode serves every head dim from 257 to
// the port's limit.
//
// Why not flash_fwd_split.cu with a wider D: it keeps the owned rows of Q
// (the whole width) and two buffers of K and V in shared memory (210 KB of
// the 227 KB at D = 256 in f32) and gives each warp D/8 output columns of
// all its rows in registers. Both grow with D. Here neither does; the
// structure is flash_bwd_deep.cu's K3 with the split K1's row statistics:
// - Block: 8 warps, BR = 64 owned query rows, grid (B*H on x, Tq / 64 on y,
//   column slices on z).
// - Score side: the (64 x 32) S tile of a key tile does not grow with D. It
//   is summed over D in chunks of CK columns: each ring buffer takes a
//   chunk of Q (the owned rows, staged again for each key tile, so nothing
//   of width D stays resident) and of K, filled by 16-byte cp.async,
//   STAGES - 1 buffers in flight while one is multiplied, one barrier a
//   buffer. Each warp sums two 16 x 8 fragments of one column block
//   (m16n8k8 3xTF32, or m16n8k16 bf16), the K operand loaded once for both,
//   each chunk in two chains of alternate depth steps started at zero, the
//   chunks' sums added in f32 (the mma accumulator truncates, and carried
//   across D its error grew with D).
// - Row statistics, as flash_fwd_split.cu forms them: a row's 32 keys lie
//   across 4 warps. Each warp writes its fragments' row maxima to shared
//   memory; after a barrier every lane forms, for each row it accumulates,
//   the tile's max from the 4 partials in a fixed order, the new running
//   max and the rescale exp(m_old - m_new). The warps then write
//   P = exp(S - m_new) once to shared memory in fragment order (a lane's
//   four values as one float4) and their row sums beside it; after the next
//   barrier every lane updates its rows' l = l exp(m_old - m_new) + the four
//   partial sums, again in a fixed order. Every warp thus holds the same m
//   and l for the same row.
// - D-wide side: a block owns a column slice of at most NO = 8 chunks (512
//   columns), warp w the 8-column block w of each of its chunks, all 64
//   rows: 128 f32 accumulators a lane. After the score chunks of a key
//   tile, the slice's chunks of V come through the same ring, VPER to a
//   buffer (the next buffer's barrier makes P and the row sums whole), and
//   each warp rescales its columns by its rows' exp(m_old - m_new) and adds
//   P V, P read back from shared memory as the A operand (flash_mma.cuh,
//   a_from_frags), each depth step's P fragments loaded once for all the
//   buffer's chunks.
// - Past 512 columns more blocks run on the grid's z axis, one per slice.
//   Each recomputes S, m and l by the same instructions on the same data, so
//   every slice holds the same statistics bit for bit; only slice 0 writes
//   lse. Every key tile holds at least one key below Tk, so a row's tile
//   max, and with it m after the first tile, is finite.
//
// What bounds it on the card: operations. It does 4*B*H*Tq*Tk*D flops (at
// (8, 4, 512, 320): 10.7 GFLOP) against a few tens of MB; at 3xTF32's 165
// TFLOP/s (f32 storage) that is 0.065 ms. The design keeps both products on
// the tensor cores; what it adds over the split K1 is Q's chunks staged
// again for each key tile (from L2), a barrier a ring buffer and, past 512
// columns, the score side once per slice (at two slices 1.5x the products).
// 64 owned rows, against 32 (one score fragment a warp, 64 accumulators),
// halve the K and V staging and the barriers a query row and let each K
// and V fragment feed two products: on the H100 they took 0.69-0.80x the
// time in every mode and shape timed, at 245-254 registers against 190-196,
// no spill (PERF.md). wgmma and TMA are left for later work.

#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int BR = 64;                 // owned query rows a block
constexpr int BS = 32;                 // keys a streamed tile
constexpr int CK = 64;                 // columns a staged chunk
constexpr int STAGES = 3;              // ring buffers: STAGES - 1 in flight
constexpr int NO = 8;                  // chunks a column slice: 512 columns
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = BR / 16;            // 16-row blocks of the score tile
constexpr int NT = BS / 8;             // 8-column blocks of the score tile
constexpr int FPW = MT * NT / WARPS;   // score fragments a warp
constexpr int FRAG_FLOATS = MT * NT * 32 * 4;  // one S tile in fragment order
constexpr int QS = BR / BS;            // 32-row slots of a chunk of Q
constexpr int SLOTS = 4;               // 32-row slots a ring buffer
constexpr int SC = SLOTS / (QS + 1);   // score chunks a buffer: Q's and K's
constexpr int VPER = SLOTS;            // V chunks a buffer
static_assert(BR % BS == 0 && MT * NT % WARPS == 0 && WARPS % NT == 0 && SC >= 1,
              "whole score fragments a warp, all in one column block");
static_assert(CK / 8 == WARPS, "one 8-column block of a chunk a warp");

struct Params {
    const void *q, *k, *v;
    void* o;
    float* lse;
    int H, Tq, Tk;
    int D;                             // the padded head dim, a multiple of CK
    int n_slices;                      // column slices, on the grid's z axis
    int64_t st[9];                     // q, k, v strides (batch, head, time)
    float scale;                       // one over the root of the true head dim
    int vec;                           // aligned_rows_mask of q, k, v
};

template <typename T>
constexpr size_t smem_bytes() {
    // P in fragment order; the row maxima and sums of each of the NT column
    // blocks; the ring
    return sizeof(float) * (FRAG_FLOATS + 2 * NT * BR)
        + sizeof(T) * (size_t)STAGES * SLOTS * BS * pitch<CK, T>();
}

// At least one block an SM: registers before occupancy, as K1-K3.
template <typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_deep_kernel(const Params p) {
    constexpr int LD = pitch<CK, T>();
    constexpr int CH = chunk<BF16_OPS>();
    constexpr int SLOT = BS * LD;      // a tile of 32 rows of a chunk
    constexpr int STAGE = SLOTS * SLOT;
    static_assert(CK % (2 * CH) == 0 && BS % CH == 0, "tiles");
    extern __shared__ __align__(16) unsigned char deep_fwd_smem[];
    float* sP = reinterpret_cast<float*>(deep_fwd_smem);  // P, fragment order
    float* sMax = sP + FRAG_FLOATS;    // [NT][BR]: each column block's row maxima
    float* sSum = sMax + NT * BR;      // [NT][BR]: and its row sums of P
    T* ring = reinterpret_cast<T*>(sSum + NT * BR);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;         // B·H on x, up to 2^31 − 1 blocks
    const int b = bh / p.H, h = bh % p.H;
    const int r0 = blockIdx.y * BR;
    // the block's column slice: chunks [first, first + n_mine) of the D / CK
    // (at most NO: the host takes n_slices = ceil(D / CK / NO))
    const int n_chunks = p.D / CK;
    // in 64 bits: z · n_chunks passes 2^31 past D = 2^23
    const int first = (int)((int64_t)blockIdx.z * n_chunks / p.n_slices);
    const int n_mine =
        (int)(((int64_t)blockIdx.z + 1) * n_chunks / p.n_slices) - first;
    // ring stages a key tile: its score buffers, SC chunks each, then its
    // slice's V chunks, VPER to a buffer
    const int n_score = (n_chunks + SC - 1) / SC;
    const int per_tile = n_score + (n_mine + VPER - 1) / VPER;
    const int n_tiles = (p.Tk + BS - 1) / BS;
    const int n_stages = n_tiles * per_tile;
    // the strides are read at constant indices only: a kernel parameter
    // whose address is taken is copied to the stack
    const T* qb = static_cast<const T*>(p.q) + b * p.st[0] + h * p.st[1];
    const T* kb = static_cast<const T*>(p.k) + b * p.st[3] + h * p.st[4];
    const T* vb = static_cast<const T*>(p.v) + b * p.st[6] + h * p.st[7];

    // Stage s of the block's sequence into its ring buffer: up to SC score
    // chunks (CK columns of the owned rows of Q, QS slots, and of the key
    // tile, one slot), or up to VPER chunks of the slice of V.
    auto fetch = [&](int s) {
        T* buf = ring + (s % STAGES) * STAGE;
        const int it = s / per_tile, c = s - it * per_tile;
        const int s0 = it * BS;
        if (c < n_score) {
            for (int i = 0; i < SC && c * SC + i < n_chunks; ++i) {
                const int col = (c * SC + i) * CK;
                T* at = buf + i * (QS + 1) * SLOT;
                stage_tile<BR, CK, THREADS>(at, qb + col, p.st[2], r0, p.Tq, p.vec & 1);
                stage_tile<BS, CK, THREADS>(at + QS * SLOT, kb + col, p.st[5], s0, p.Tk,
                                            p.vec & 2);
            }
            return;
        }
        const int i0 = (c - n_score) * VPER;
        for (int i = 0; i < VPER && i0 + i < n_mine; ++i)
            stage_tile<BS, CK, THREADS>(buf + i * SLOT, vb + (first + i0 + i) * CK, p.st[8],
                                        s0, p.Tk, p.vec & 4);
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

    // the warp's score fragments i: query rows 16 m(i) + (g, g + 8), keys
    // 8 j + (2t, 2t + 1) of the tile
    const int j = warp % NT;
    auto m_of = [&](int i) { return warp / NT + i * (WARPS / NT); };

    // the lane's accumulator rows 16 mm + g + 8 r of the warp's columns,
    // and their statistics
    float acc[MT][NO][4];
    float m_run[MT][2], l_run[MT][2];
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            m_run[mm][r] = -INFINITY;
            l_run[mm][r] = 0.f;
        }
#pragma unroll
        for (int jo = 0; jo < NO; ++jo)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mm][jo][e] = 0.f;
    }

    for (int it = 0; it < n_tiles; ++it) {
        // S of the warp's fragments: each chunk's sum in two chains of
        // alternate depth steps (a chain of 3xTF32 products is three
        // dependent mma a step), started at zero, then added to the running
        // sum in plain f32 adds. The mma accumulator does not round to
        // nearest: carried over all of D, its error grew with D (at 12,800,
        // 8.9e-5 in O against 1.9e-6 at 320); a chunk's 12 accumulations a
        // chain keep it at a short sum's. f32 mode scales q before the dot
        float x_sum[FPW][4] = {};
        for (int cs = 0; cs < n_score; ++cs) {
            const T* buf = advance();
#pragma unroll
            for (int i = 0; i < SC; ++i) {
                if (cs * SC + i >= n_chunks) break;  // the same for the whole block
                const T* cQ = buf + i * (QS + 1) * SLOT;
                const T* cK = cQ + QS * SLOT + j * 8 * LD;
                float y[FPW][2][4] = {};
#pragma unroll
                for (int kc = 0; kc < CK / CH; ++kc) {
                    const BFrag<BF16_OPS> bk = load_b<BF16_OPS>([&](int kk, int n) {
                        return to_f32(cK[n * LD + kc * CH + kk]);
                    });
#pragma unroll
                    for (int f = 0; f < FPW; ++f) {
                        const T* cQw = cQ + m_of(f) * 16 * LD;
                        mma<BF16_OPS>(y[f][kc & 1], load_a<BF16_OPS>([&](int r, int kk) {
                            const float x = to_f32(cQw[r * LD + kc * CH + kk]);
                            return BF16_OPS ? x : x * p.scale;
                        }), bk);
                    }
                }
#pragma unroll
                for (int f = 0; f < FPW; ++f)
#pragma unroll
                    for (int e = 0; e < 4; ++e) x_sum[f][e] += y[f][0][e] + y[f][1][e];
            }
        }
        // the bf16 mode scales after the dot; keys past Tk get -inf
        const int key0 = it * BS + j * 8 + 2 * t;  // the key of s[f][0]
        float s[FPW][4];
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = x_sum[f][e];
                s[f][e] = key0 + (e & 1) < p.Tk ? (BF16_OPS ? x * p.scale : x) : -INFINITY;
                mx[e >> 1] = fmaxf(mx[e >> 1], s[f][e]);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = quad_max(mx[r]);
                if (t == 0) sMax[j * BR + m_of(f) * 16 + g + 8 * r] = mx[r];
            }
        }
        __syncthreads();               // the tile's row maxima are whole

        // every lane: the new running max of its rows and their rescale;
        // finite, since every tile holds at least one key below Tk
        float alpha[MT][2];
#pragma unroll
        for (int mm = 0; mm < MT; ++mm)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = mm * 16 + g + 8 * r;
                float m_new = m_run[mm][r];
#pragma unroll
                for (int jj = 0; jj < NT; ++jj) m_new = fmaxf(m_new, sMax[jj * BR + row]);
                alpha[mm][r] = expf(m_run[mm][r] - m_new);
                m_run[mm][r] = m_new;
            }

        // P = exp(S - m_new) of the warp's fragments, written once in
        // fragment order, and their row sums (masked keys give p = 0); a
        // fragment's rows picked by selects, since a register array indexed
        // by the warp's m would go to local memory. The next ring buffer's
        // barrier makes them whole.
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
            const int m = m_of(f);
            float m_frag[2] = {m_run[0][0], m_run[0][1]};
#pragma unroll
            for (int mm = 1; mm < MT; ++mm)
                if (m == mm) {
                    m_frag[0] = m_run[mm][0];
                    m_frag[1] = m_run[mm][1];
                }
            float pv[4], ps[2] = {0.f, 0.f};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                pv[e] = expf(s[f][e] - m_frag[e >> 1]);
                ps[e >> 1] += pv[e];
            }
            *reinterpret_cast<float4*>(sP + ((m * NT + j) * 32 + lane) * 4) =
                make_float4(pv[0], pv[1], pv[2], pv[3]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                ps[r] = quad_sum(ps[r]);
                if (t == 0) sSum[j * BR + m * 16 + g + 8 * r] = ps[r];
            }
        }

        // the warp's 8 columns of each chunk of the slice: l and acc
        // rescaled, then acc += P V over the tile's keys in key_of order,
        // VPER chunks a ring buffer; padded keys have p = 0 and V = 0
#pragma unroll
        for (int j0 = 0; j0 < NO; j0 += VPER) {
            if (j0 >= n_mine) break;   // the same for the whole block
            const T* buf = advance() + warp * 8;
            if (j0 == 0) {
#pragma unroll
                for (int mm = 0; mm < MT; ++mm)
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        const int row = mm * 16 + g + 8 * r;
                        float sum = sSum[row];
#pragma unroll
                        for (int jj = 1; jj < NT; ++jj) sum += sSum[jj * BR + row];
                        l_run[mm][r] = l_run[mm][r] * alpha[mm][r] + sum;
#pragma unroll
                        for (int jo = 0; jo < NO; ++jo) {
                            acc[mm][jo][2 * r] *= alpha[mm][r];
                            acc[mm][jo][2 * r + 1] *= alpha[mm][r];
                        }
                    }
            }
#pragma unroll
            for (int c = 0; c < BS / CH; ++c) {
                AFrag<BF16_OPS> pa[MT];
#pragma unroll
                for (int mm = 0; mm < MT; ++mm) pa[mm] = a_from_frags<BF16_OPS, NT>(sP, mm, c);
#pragma unroll
                for (int i = 0; i < VPER; ++i) {
                    const int jo = j0 + i;
                    if (jo >= n_mine) break;
                    const T* cV = buf + i * SLOT;
                    const BFrag<BF16_OPS> bv = load_b<BF16_OPS>([&](int kk, int n) {
                        return to_f32(cV[(c * CH + key_of(kk)) * LD + n]);
                    });
#pragma unroll
                    for (int mm = 0; mm < MT; ++mm) mma<BF16_OPS>(acc[mm][jo], pa[mm], bv);
                }
            }
        }
    }

    T* out = static_cast<T*>(p.o);
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + mm * 16 + g + 8 * r;
            if (row >= p.Tq) continue;
            const float lc = fmaxf(l_run[mm][r], 1e-30f);
            const int64_t at = ((int64_t)bh * p.Tq + row) * p.D + warp * 8 + 2 * t;
#pragma unroll
            for (int jo = 0; jo < NO; ++jo) {
                if (jo >= n_mine) break;
                store2(out + at + (int64_t)(first + jo) * CK, acc[mm][jo][2 * r] / lc,
                       acc[mm][jo][2 * r + 1] / lc);
            }
            if (blockIdx.z == 0 && warp == 0 && t == 0)
                p.lse[(int64_t)bh * p.Tq + row] = m_run[mm][r] + logf(lc);
        }
}

template <typename T, bool BF16_OPS>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
    auto kernel = flash_fwd_deep_kernel<T, BF16_OPS>;
    constexpr size_t smem = smem_bytes<T>();
    static bool configured = false;    // the attribute is set once per instance
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const void* inputs[] = {p.q, p.k, p.v};
    p.vec = aligned_rows_mask(inputs, p.st, sizeof(T));
    dim3 grid(B * p.H, (p.Tq + BR - 1) / BR, p.n_slices);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// Arguments as mmef_flash_fwd (flash_fwd.cu); D a multiple of 64 (the
// wrapper pads a head dim past 256 to one; scale is the true one); o
// contiguous (B, H, Tq, D) of the input type. Another D returns
// cudaErrorInvalidValue.
extern "C" int mmef_flash_fwd_deep(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int Tq, int Tk, int D,
                                   int is_bf16, int bf16_ops, float scale,
                                   const int64_t* strides, void* stream) {
    if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D % CK != 0
        || (int64_t)B * H > INT32_MAX || (Tq + BR - 1) / BR > 65535
        || (D / CK + NO - 1) / NO > 65535)
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, o, static_cast<float*>(lse), H, Tq, Tk, D, (D / CK + NO - 1) / NO,
             {}, scale, 0};
    for (int i = 0; i < 9; ++i) p.st[i] = strides[i];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)(bf16_ops ? launch<__nv_bfloat16, true>(p, B, s)
                              : launch<__nv_bfloat16, false>(p, B, s));
    return (int)(bf16_ops ? launch<float, true>(p, B, s) : launch<float, false>(p, B, s));
}
