// Tensor-core pieces shared by the flash kernels (flash_fwd.cu, flash_bwd.cu,
// flash_fwd_split.cu, flash_bwd_split.cu, flash_bwd_deep.cu):
// warp-level mma.sync fragments, the 3xTF32 split, and cp.async tile staging.
//
// One warp computes C (16 x 8, f32) += A (16 x depth) * B (depth x 8) in
// chunks of the depth: 8 deep with m16n8k8 TF32 operands (f32 mode, run as
// 3xTF32), 16 deep with m16n8k16 bf16 operands (bf16-operand mode). Lane l
// holds row g = l / 4 and column t = l % 4 of a quad:
// - C: c[0] = (g, 2t), c[1] = (g, 2t+1), c[2] = (g+8, 2t), c[3] = (g+8, 2t+1);
// - A is read at rows g and g+8, B at column g, both at depths t and t+4
//   of each 8-deep slice (and 8+t, 12+t in a bf16 chunk).
// A sum over the depth may take its terms in any order, so the bf16 layout,
// whose registers hold depth pairs (2t, 2t+1), is fed the depths (t, t+4) of
// the TF32 layout: A and B agree, and both read the same shared-memory
// addresses in either mode. A product whose depth is the columns of an earlier
// product's C (P.V after S = Q.K^T) takes A straight from those registers;
// its B rows are then read in the order key_of() gives.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash_mma {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// Two neighbouring outputs of one row, written as one 8- or 4-byte store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x = big + small to about 21 bits, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));
}

// bf16(lo) in the low half, bf16(hi) in the high half, rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// One depth chunk of A: TF32 big parts in r[0..3], small parts in r[4..7];
// or four registers of bf16 pairs.
template <bool BF16>
struct AFrag { uint32_t r[BF16 ? 4 : 8]; };

// One depth chunk of B: TF32 big r[0..1], small r[2..3]; or two bf16 pairs.
template <bool BF16>
struct BFrag { uint32_t r[BF16 ? 2 : 4]; };

template <bool BF16>
__host__ __device__ constexpr int chunk() { return BF16 ? 16 : 8; }

// Depth position k of a chunk -> column of the C fragments it came from
// (a_from_acc): depths t and t+4 are columns 2t and 2t+1 of each 8 columns.
__device__ __forceinline__ int key_of(int k) {
    return (k >> 3) * 8 + (k & 3) * 2 + ((k >> 2) & 1);
}

// The values of an A chunk that a lane holds, in register order.
template <bool BF16>
struct AVals { float x[BF16 ? 8 : 4]; };

// A chunk from its values: split into TF32 parts, or packed in bf16 pairs.
template <bool BF16>
__device__ __forceinline__ AFrag<BF16> a_from_vals(const AVals<BF16>& v) {
    AFrag<BF16> a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if constexpr (BF16) a.r[i] = pack_bf16(v.x[2 * i], v.x[2 * i + 1]);
        else split(v.x[i], a.r[i], a.r[i + 4]);
    }
    return a;
}

// The A values from at(r, k), the element at row r (0..15) and depth k.
template <bool BF16, typename F>
__device__ __forceinline__ AVals<BF16> gather_a(F at) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    if constexpr (BF16)
        return {{at(g, t), at(g, t + 4), at(g + 8, t), at(g + 8, t + 4),
                 at(g, t + 8), at(g, t + 12), at(g + 8, t + 8), at(g + 8, t + 12)}};
    else
        return {{at(g, t), at(g + 8, t), at(g, t + 4), at(g + 8, t + 4)}};
}

template <bool BF16, typename F>
__device__ __forceinline__ AFrag<BF16> load_a(F at) {
    return a_from_vals<BF16>(gather_a<BF16>(at));
}

// What a kernel keeps of an A chunk that it reuses: the values in f32 mode
// (half the registers of their TF32 parts), the fragment in bf16 mode (half
// the registers of its values). frag() turns it into the fragment.
template <bool BF16>
using AKept = typename std::conditional<BF16, AFrag<true>, AVals<false>>::type;

template <bool BF16>
__device__ __forceinline__ AKept<BF16> keep(const AVals<BF16>& v) {
    if constexpr (BF16) return a_from_vals<true>(v);
    else return v;
}
__device__ __forceinline__ AFrag<true> frag(const AFrag<true>& a) { return a; }
__device__ __forceinline__ AFrag<false> frag(const AVals<false>& v) {
    return a_from_vals<false>(v);
}

// B chunk from at(k, n), the element at depth k and column n (0..7).
template <bool BF16, typename F>
__device__ __forceinline__ BFrag<BF16> load_b(F at) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    BFrag<BF16> b;
    if constexpr (BF16) {
        b.r[0] = pack_bf16(at(t, g), at(t + 4, g));
        b.r[1] = pack_bf16(at(t + 8, g), at(t + 12, g));
    } else {
        split(at(t, g), b.r[0], b.r[2]);
        split(at(t + 4, g), b.r[1], b.r[3]);
    }
    return b;
}

// A chunk whose depth runs over the columns of C fragments c[0] (and c[1]
// in bf16): depth k is column key_of(k).
template <bool BF16>
__device__ __forceinline__ AFrag<BF16> a_from_acc(const float (*c)[4]) {
    if constexpr (BF16)
        return a_from_vals<BF16>({{c[0][0], c[0][1], c[0][2], c[0][3],
                                   c[1][0], c[1][1], c[1][2], c[1][3]}});
    else
        return a_from_vals<BF16>({{c[0][0], c[0][2], c[0][1], c[0][3]}});
}

// The A chunk c (chunk<BF16>() deep) of rows [16 m, 16 m + 16) of a tile of
// NT 8-column blocks written in fragment order: the float4 at
// ((m NT + j) 32 + lane) 4 holds what lane `lane` had in its accumulator of
// fragment (m, j), so a_from_acc reads the chunk's depth in key_of order.
// The split and deep kernels hand P (and dS) from the warps that form them
// to every warp this way.
template <bool BF16, int NT>
__device__ __forceinline__ AFrag<BF16> a_from_frags(const float* tile, int m, int c) {
    constexpr int PER = chunk<BF16>() / 8;
    const int lane = threadIdx.x & 31;
    float acc[PER][4];
#pragma unroll
    for (int h = 0; h < PER; ++h) {
        const float4 x = *reinterpret_cast<const float4*>(
            tile + ((m * NT + c * PER + h) * 32 + lane) * 4);
        acc[h][0] = x.x;
        acc[h][1] = x.y;
        acc[h][2] = x.z;
        acc[h][3] = x.w;
    }
    return a_from_acc<BF16>(acc);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b: 3xTF32 (small.big + big.small, then big.big) or one bf16 mma
template <bool BF16>
__device__ __forceinline__ void mma(float (&c)[4], const AFrag<BF16>& a,
                                    const BFrag<BF16>& b) {
    if constexpr (BF16) {
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]),
              "r"(b.r[0]), "r"(b.r[1]));
    } else {
        mma_tf32(c, a.r[4], a.r[5], a.r[6], a.r[7], b.r[0], b.r[1]);
        mma_tf32(c, a.r[0], a.r[1], a.r[2], a.r[3], b.r[2], b.r[3]);
        mma_tf32(c, a.r[0], a.r[1], a.r[2], a.r[3], b.r[0], b.r[1]);
    }
}

// Sum over the 4 lanes of a quad, which share rows g and g+8.
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row pitch in elements of a shared tile of D columns: 16 bytes of padding,
// so that rows start 16-byte aligned for cp.async and, in f32, the fragment
// reads above hit 32 distinct banks: with a pitch of 4 mod 8 words, rows g
// at depth t (A, and B read as a transpose) and rows key_of(t) at column g
// (B after a_from_acc) fall on 32 different banks.
template <int D, typename T>
__host__ __device__ constexpr int pitch() { return D + 16 / (int)sizeof(T); }

// Stage rows [r0, r0 + ROWS) of a (T_len, D) matrix whose rows are `st`
// elements apart into a shared tile of pitch<D, T>(); rows past T_len are
// zero. With `vec` (base and stride 16-byte aligned) the copy is 16-byte
// cp.async, to be waited for; otherwise element loads, done on return.
template <int ROWS, int D, int THREADS, typename T>
__device__ __forceinline__ void stage_tile(T* tile, const T* base, int64_t st, int r0,
                                           int T_len, bool vec) {
    constexpr int LD = pitch<D, T>();
    if (vec) {
        constexpr int PER = 16 / (int)sizeof(T);   // elements per 16-byte copy
        constexpr int CPR = D / PER;               // copies per row
        for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
            const int row = i / CPR, col = (i % CPR) * PER;
            T* dst = tile + row * LD + col;
            if (r0 + row < T_len)
                cp_async16(dst, base + (int64_t)(r0 + row) * st + col);
            else
                *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
    } else {
        for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
            const int row = i / D, col = i % D;
            tile[row * LD + col] = r0 + row < T_len
                ? base[(int64_t)(r0 + row) * st + col] : zero<T>();
        }
    }
}

// Bit i set where every row of tensor i, a (B, H, T, D) view, starts on a
// 16-byte boundary (the condition of stage_tile's vec); `st` holds three
// element strides (batch, head, time) per tensor, in the order of `ptrs`.
template <int N>
inline int aligned_rows_mask(const void* const (&ptrs)[N], const int64_t* st,
                             size_t elem) {
    int mask = 0;
    for (int i = 0; i < N; ++i) {
        bool aligned = reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
        for (int j = 0; j < 3; ++j)
            aligned = aligned && (st[3 * i + j] * (int64_t)elem) % 16 == 0;
        mask |= (int)aligned << i;
    }
    return mask;
}

}  // namespace flash_mma
