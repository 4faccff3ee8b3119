// Flash-attention forward past head dim 128 on Hopper's tensor cores
// (sm_90a), plain C entry point for ctypes.
//
// Replaces, for head dims in (128, 256], the Pallas TPU kernel K1,
// `multimodal_eeg_fmri_tpu/ops/attention.py:_fwd_kernel` (:63, pallas_call at
// :248 in `_flash_forward`) -> mmef_flash_fwd_split. It computes the function
// of flash_fwd.cu's K1 in the same three modes (f32 storage as 3xTF32, bf16
// storage, BF16_OPS): per (batch, head), O = softmax(Q K^T * scale) V and the
// per-row lse = m + log l, by online softmax (running max m, running sum l
// and the accumulator in f32, rescaled as each key tile arrives), keys past
// Tk masked to -inf, O = acc / max(l, 1e-30) in q's dtype. f32 mode scales q
// before the q.k dot, BF16_OPS after it; BF16_OPS rounds q, k, p and v to
// bf16 and keeps every sum in f32. Each block owns its query rows and writes
// them once, every sum in a fixed order, so results repeat bit for bit.
//
// Why not flash_fwd.cu with a wider D: it keeps a warp's 16 rows of the
// D-wide accumulator in its registers (D/2 floats a lane: 128 at D = 256)
// and its 64-row tiles of three D-wide operands outgrow shared memory. The
// wrapper zero-pads a head dim in (128, 256] to the instance 192 or 256 and
// passes the true scale 1/sqrt(d) (ops/attention.py): the zero columns add
// nothing to Q K^T and give zero output columns. Past 256
// flash_fwd_deep.cu runs.
//
// Design (8 warps, a block per (b*h on grid x, 64 owned query rows on y)),
// the structure of flash_bwd_split.cu's K3 with the online softmax added:
// - Q's 64 rows stay in shared memory; K and V stream in 32-row tiles,
//   double-buffered by 16-byte cp.async (the next tile's copy in flight while
//   this tile's products run). At D = 256 in f32 that is 67 KB resident and
//   4 x 33 KB streamed, 210 KB of the 227 KB: one block an SM.
// - Score side: the 64 x 32 S tile does not grow with D. Each warp takes two
//   16 x 8 fragments of one column block, summed over all of D from shared
//   memory (m16n8k8 3xTF32, or m16n8k16 bf16) in two chains each of
//   alternate chunks, the K operand loaded once for both.
// - Row statistics: a row's 32 keys lie across 4 warps. Each warp writes its
//   fragments' row maxima to shared memory; after a barrier every lane forms,
//   for each of the 8 rows it accumulates below, the tile's max from the 4
//   partials in a fixed order, and the new running max and the rescale
//   exp(m_old - m_new). The score warps then form P = exp(S - m_new), write
//   it once to shared memory in fragment order (a lane's four accumulator
//   values as one float4) and their row sums beside it; after a second
//   barrier every lane updates its rows' l = l exp(m_old - m_new) + the four
//   partial sums, again in a fixed order. Every warp thus holds the same m
//   and l for the same row, and no warp waits on another for them.
// - D-wide side: the accumulator is split by column slice over the warps,
//   D/8 columns each (24 or 32), all 64 rows: 48-64 f32 registers a lane.
//   Each warp rescales its slice by its rows' exp(m_old - m_new) and adds
//   P V for its columns: P read back from shared memory as the A operand in
//   16-byte loads (the keys then in key_of order), V from the streamed tile.
//
// What bounds it on the card: operations. It does 4*B*H*Tq*Tk*D flops (at
// (8, 2, 2048, 256): 68.7 GFLOP) against 134 MB of inputs and outputs; at
// 3xTF32's 165 TFLOP/s (f32 storage) that is 0.42 ms. The design puts both
// products on the tensor cores and keeps the score side's work from growing
// with the D-wide side. 64 owned rows, against 32, halve the K and V
// staging and the barriers a query row and let each K and V fragment feed
// two products: on the H100 they took 14-31% less time in every mode and
// shape timed (PERF.md), at 182-228 registers against 134-159. The 64-row
// tiles give 512 blocks at (8, 2, 2048) and 256 at (8, 4, 512) (1.9 waves
// over 132 SMs).
// wgmma, TMA and warp specialisation are left for later work.

#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int BR = 64;                 // owned query rows a block
constexpr int BS = 32;                 // keys a streamed tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = BR / 16;            // 16-row blocks of the score tile
constexpr int NT = BS / 8;             // 8-column blocks of the score tile
constexpr int FPW = MT * NT / WARPS;   // score fragments a warp
constexpr int FRAG_FLOATS = MT * NT * 32 * 4;  // one S tile in fragment order
static_assert(BR % 16 == 0 && MT * NT % WARPS == 0 && WARPS % NT == 0,
              "whole score fragments a warp, all in one column block");

struct Params {
    const void *q, *k, *v;
    void* o;
    float* lse;
    int H, Tq, Tk;
    int64_t st[9];                     // q, k, v strides (batch, head, time)
    float scale;                       // one over the root of the true head dim
    int vec;                           // aligned_rows_mask of q, k, v
};

template <int D, typename T>
constexpr size_t smem_bytes() {
    // P in fragment order; the row maxima and sums of each of the NT column
    // blocks; the Q tile; two buffers each of the K and V tiles
    return sizeof(float) * (FRAG_FLOATS + 2 * NT * BR)
        + sizeof(T) * (size_t)(BR + 4 * BS) * pitch<D, T>();
}

// At least one block an SM: registers before occupancy, as K1-K3.
template <int D, typename T, bool BF16_OPS>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_split_kernel(const Params p) {
    constexpr int LD = pitch<D, T>();
    constexpr int CH = chunk<BF16_OPS>();
    constexpr int CW = D / WARPS;      // output columns a warp owns
    constexpr int NO = CW / 8;         // their 8-column blocks
    static_assert(CW % 8 == 0 && D % CH == 0, "head dim");
    extern __shared__ __align__(16) unsigned char split_smem[];
    float* sP = reinterpret_cast<float*>(split_smem);  // P, fragment order
    float* sMax = sP + FRAG_FLOATS;    // [NT][BR]: each column block's row maxima
    float* sSum = sMax + NT * BR;      // [NT][BR]: and its row sums of P
    T* sQ = reinterpret_cast<T*>(sSum + NT * BR);
    T* sK = sQ + BR * LD;              // two buffers
    T* sV = sK + 2 * BS * LD;          // two buffers

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;         // B·H on x, up to 2^31 − 1 blocks
    const int b = bh / p.H, h = bh % p.H;
    const int r0 = blockIdx.y * BR;
    // the strides are read at constant indices only: a kernel parameter
    // whose address is taken is copied to the stack
    const T* qb = static_cast<const T*>(p.q) + b * p.st[0] + h * p.st[1];
    const T* kb = static_cast<const T*>(p.k) + b * p.st[3] + h * p.st[4];
    const T* vb = static_cast<const T*>(p.v) + b * p.st[6] + h * p.st[7];

    auto stage_kv = [&](int it) {
        const int buf = it & 1, s0 = it * BS;
        stage_tile<BS, D, THREADS>(sK + buf * BS * LD, kb, p.st[5], s0, p.Tk, p.vec & 2);
        stage_tile<BS, D, THREADS>(sV + buf * BS * LD, vb, p.st[8], s0, p.Tk, p.vec & 4);
    };
    stage_tile<BR, D, THREADS>(sQ, qb, p.st[2], r0, p.Tq, p.vec & 1);
    stage_kv(0);
    cp_async_commit();

    // the warp's score fragments i: query rows 16 m(i) + (g, g + 8), keys
    // 8 j + (2t, 2t + 1) of the tile
    const int j = warp % NT;
    auto m_of = [&](int i) { return warp / NT + i * (WARPS / NT); };
    const int col0 = warp * CW;        // the warp's output columns

    // the lane's accumulator rows 16 mm + g + 8 r, and their statistics
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

    const int n_tiles = (p.Tk + BS - 1) / BS;
    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) stage_kv(it + 1);
        cp_async_commit();
        cp_async_wait<1>();            // this tile (and, at first, Q) has landed
        __syncthreads();
        const T* cK = sK + (it & 1) * BS * LD;
        const T* cV = sV + (it & 1) * BS * LD;

        // S of the warp's fragments over D, each in two chains of alternate
        // chunks (a chain of 3xTF32 products is three dependent mma a
        // chunk); f32 mode scales q before the dot
        float y[FPW][2][4] = {};
#pragma unroll
        for (int c = 0; c < D / CH; ++c) {
            const BFrag<BF16_OPS> bk = load_b<BF16_OPS>([&](int kk, int n) {
                return to_f32(cK[(j * 8 + n) * LD + c * CH + kk]);
            });
#pragma unroll
            for (int i = 0; i < FPW; ++i) {
                const T* sQw = sQ + m_of(i) * 16 * LD;
                mma<BF16_OPS>(y[i][c & 1], load_a<BF16_OPS>([&](int r, int kk) {
                    const float x = to_f32(sQw[r * LD + c * CH + kk]);
                    return BF16_OPS ? x : x * p.scale;
                }), bk);
            }
        }
        // the bf16 mode scales after the dot; keys past Tk get -inf
        const int key0 = it * BS + j * 8 + 2 * t;  // the key of s[i][0]
        float s[FPW][4];
#pragma unroll
        for (int i = 0; i < FPW; ++i) {
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = y[i][0][e] + y[i][1][e];
                s[i][e] = key0 + (e & 1) < p.Tk ? (BF16_OPS ? x * p.scale : x) : -INFINITY;
                mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = quad_max(mx[r]);
                if (t == 0) sMax[j * BR + m_of(i) * 16 + g + 8 * r] = mx[r];
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
        // by the warp's m would go to local memory
#pragma unroll
        for (int i = 0; i < FPW; ++i) {
            const int m = m_of(i);
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
                pv[e] = expf(s[i][e] - m_frag[e >> 1]);
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
        __syncthreads();               // the tile's P and row sums are whole

        // the warp's columns: l and acc rescaled, then acc += P V over the
        // tile's keys in key_of order; padded keys have p = 0 and V = 0
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
#pragma unroll
        for (int c = 0; c < BS / CH; ++c) {
            AFrag<BF16_OPS> pa[MT];
#pragma unroll
            for (int mm = 0; mm < MT; ++mm) pa[mm] = a_from_frags<BF16_OPS, NT>(sP, mm, c);
#pragma unroll
            for (int jo = 0; jo < NO; ++jo) {
                const int cc = col0 + jo * 8;
                const BFrag<BF16_OPS> bv = load_b<BF16_OPS>([&](int kk, int n) {
                    return to_f32(cV[(c * CH + key_of(kk)) * LD + cc + n]);
                });
#pragma unroll
                for (int mm = 0; mm < MT; ++mm) mma<BF16_OPS>(acc[mm][jo], pa[mm], bv);
            }
        }
        __syncthreads();               // the buffers are free for the tile after next
    }

    T* out = static_cast<T*>(p.o);
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + mm * 16 + g + 8 * r;
            if (row >= p.Tq) continue;
            const float lc = fmaxf(l_run[mm][r], 1e-30f);
            const int64_t at = ((int64_t)bh * p.Tq + row) * D + col0 + 2 * t;
#pragma unroll
            for (int jo = 0; jo < NO; ++jo)
                store2(out + at + jo * 8, acc[mm][jo][2 * r] / lc,
                       acc[mm][jo][2 * r + 1] / lc);
            if (warp == 0 && t == 0)
                p.lse[(int64_t)bh * p.Tq + row] = m_run[mm][r] + logf(lc);
        }
}

template <int D, typename T, bool BF16_OPS>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
    auto kernel = flash_fwd_split_kernel<D, T, BF16_OPS>;
    constexpr size_t smem = smem_bytes<D, T>();
    static bool configured = false;    // the attribute is set once per instance
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const void* inputs[] = {p.q, p.k, p.v};
    p.vec = aligned_rows_mask(inputs, p.st, sizeof(T));
    dim3 grid(B * p.H, (p.Tq + BR - 1) / BR);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T, bool BF16_OPS>
cudaError_t by_head_dim(int D, const Params& p, int B, cudaStream_t s) {
    switch (D) {
        case 192: return launch<192, T, BF16_OPS>(p, B, s);
        case 256: return launch<256, T, BF16_OPS>(p, B, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Arguments as mmef_flash_fwd (flash_fwd.cu), D = 192 or 256 (the wrapper
// pads a head dim in (128, 256] to one of them; scale is the true one);
// other D return cudaErrorInvalidValue.
extern "C" int mmef_flash_fwd_split(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int Tq, int Tk, int D,
                                    int is_bf16, int bf16_ops, float scale,
                                    const int64_t* strides, void* stream) {
    if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || (int64_t)B * H > INT32_MAX
        || (Tq + BR - 1) / BR > 65535)
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, o, static_cast<float*>(lse), H, Tq, Tk, {}, scale, 0};
    for (int i = 0; i < 9; ++i) p.st[i] = strides[i];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)(bf16_ops ? by_head_dim<__nv_bfloat16, true>(D, p, B, s)
                              : by_head_dim<__nv_bfloat16, false>(D, p, B, s));
    return (int)(bf16_ops ? by_head_dim<float, true>(D, p, B, s)
                          : by_head_dim<float, false>(D, p, B, s));
}
