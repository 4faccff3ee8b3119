// S1: cascaded biquad filtering (sosfilt) for Hopper (sm_90a), plain C entry
// point for ctypes.
//
// Replaces the `lax.scan` of `multimodal_eeg_fmri_tpu/ops/signal.py:sosfilt`
// (no Pallas kernel: on the TPU the scan body was S fused biquads of vector
// FMAs over the batched trailing dims). For a time-major (T, M) float32 signal
// whose M series fall in G equal groups, each with its own cascade of S
// second-order sections, every step t and section s computes
//     out = b0*y + z0;  z0 = b1*y - a1*out + z1;  z1 = b2*y - a2*out;  y = out
// rounding each multiply, add and subtract to float32 in that order, as the
// JAX scan body and the port's plain version (`ops/signal.py:sosfilt_plain`)
// do: no FMA contraction, so the kernel and its plain version agree bit for
// bit on the card. The state starts from zi (G, S, 2, M/G) or zeros and is
// written to zf (G, S, 2, M/G) when asked, so a stream can carry it across
// chunks. Grouping lets one launch filter one chunk through several bands
// (the streaming featurizer's five).
//
// Design: one thread per series, its 2*S state and 5*S coefficients in
// registers; a warp spans 32 neighbouring series, so each time step's load
// and store is one coalesced 128-byte transaction. The coefficients travel in
// the launch's parameter block (no device copy, no allocation). Each thread
// holds a tile of TB time steps in registers and issues the loads of the next
// tile before it filters this one, so the load latency overlaps the
// recurrence. A whole tile runs with no bounds check between its steps, so
// that its steps form one block of code that the compiler schedules
// together (a warp issues in order); only the last, partial tile checks each
// step.
//
// What bounds it on the card: the bytes are 2*T*M*4 (each sample read and
// written once), 5.9 MB at the featurizer's (2554, 288): 1.8 us at 3.35 TB/s;
// the 9*S*T*M operations take less at 67 TFLOP/s. But the recurrence is a
// dependency chain of T*S biquads per series, and M = 288 series fill under
// ten warps of the card's 132 SMs: the chain, not the bytes, sets the time. A
// time-parallel scan (chunks of T solved as a linear recurrence, then joined)
// is the road past it, left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// S1's limits; mmef_sosfilt returns cudaErrorInvalidValue past them
constexpr int MAX_SECTIONS = 8;      // per cascade
constexpr int MAX_COEFF_SETS = 128;  // sections in all groups together
constexpr int THREADS = 64;
constexpr int TB = 16;               // time steps per register tile

struct Coeffs {
    float c[MAX_COEFF_SETS][6];      // b0 b1 b2 a0 a1 a2 per (group, section)
};

__device__ __forceinline__ void load_tile(float (&buf)[TB], const float* x,
                                          int t0, int T, int64_t M, int m) {
#pragma unroll
    for (int i = 0; i < TB; ++i)
        buf[i] = t0 + i < T ? __ldg(x + (int64_t)(t0 + i) * M + m) : 0.f;
}

// One series' cascade: its coefficients and state, in registers.
template <int S>
struct Cascade {
    float b0[S], b1[S], b2[S], a1[S], a2[S], z0[S], z1[S];

    // One sample through the S sections, each operation rounded to float32.
    __device__ __forceinline__ float step(float yk) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const float out = __fadd_rn(__fmul_rn(b0[s], yk), z0[s]);
            z0[s] = __fadd_rn(__fsub_rn(__fmul_rn(b1[s], yk), __fmul_rn(a1[s], out)),
                              z1[s]);
            z1[s] = __fsub_rn(__fmul_rn(b2[s], yk), __fmul_rn(a2[s], out));
            yk = out;
        }
        return yk;
    }
};

template <int S>
__global__ void __launch_bounds__(THREADS)
sosfilt_kernel(const float* __restrict__ x, float* __restrict__ y,
               const float* __restrict__ zi, float* __restrict__ zf,
               const Coeffs coeffs, int T, int M, int Mg) {
    const int m = blockIdx.x * THREADS + threadIdx.x;
    if (m >= M) return;
    const int g = m / Mg, j = m - g * Mg;
    Cascade<S> f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const float* c = coeffs.c[g * S + s];
        f.b0[s] = c[0]; f.b1[s] = c[1]; f.b2[s] = c[2]; f.a1[s] = c[4]; f.a2[s] = c[5];
        const int64_t i0 = (int64_t)(g * S + s) * 2 * Mg + j;  // zi[g][s][0][j]
        f.z0[s] = zi ? zi[i0] : 0.f;
        f.z1[s] = zi ? zi[i0 + Mg] : 0.f;
    }
    const int t_full = T - T % TB;
    float cur[TB], nxt[TB];
    load_tile(cur, x, 0, T, M, m);
    for (int t0 = 0; t0 < T; t0 += TB) {
        load_tile(nxt, x, t0 + TB, T, M, m);
        if (t0 < t_full) {
            // a whole tile: no check between its steps
#pragma unroll
            for (int i = 0; i < TB; ++i)
                y[(int64_t)(t0 + i) * M + m] = f.step(cur[i]);
        } else {
#pragma unroll
            for (int i = 0; i < TB; ++i)
                if (t0 + i < T) y[(int64_t)(t0 + i) * M + m] = f.step(cur[i]);
        }
#pragma unroll
        for (int i = 0; i < TB; ++i) cur[i] = nxt[i];
    }
    if (zf) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int64_t i0 = (int64_t)(g * S + s) * 2 * Mg + j;
            zf[i0] = f.z0[s];
            zf[i0 + Mg] = f.z1[s];
        }
    }
}

template <int S>
cudaError_t launch(const float* x, float* y, const float* zi, float* zf,
                   const Coeffs& c, int T, int M, int Mg, cudaStream_t stream) {
    sosfilt_kernel<S><<<(M + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        x, y, zi, zf, c, T, M, Mg);
    return cudaGetLastError();
}

}  // namespace

// x, y: (T, M) float32 on the card; zi, zf: (G, S, 2, M/G) float32 on the card
// or null (zeros in, nothing out); coeffs: G*S*6 float32 in HOST memory, row
// (b0 b1 b2 a0 a1 a2) per (group, section). Returns a cudaError_t.
extern "C" int mmef_sosfilt(const void* x, void* y, const void* zi, void* zf,
                            const float* coeffs, int G, int S, int T, int M,
                            void* stream) {
    if (G < 1 || S < 1 || S > MAX_SECTIONS || G * S > MAX_COEFF_SETS || T < 1 ||
        M < 1 || M % G != 0)
        return (int)cudaErrorInvalidValue;
    Coeffs c;
    for (int i = 0; i < G * S; ++i)
        for (int k = 0; k < 6; ++k) c.c[i][k] = coeffs[i * 6 + k];
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    const float* zif = static_cast<const float*>(zi);
    float* zff = static_cast<float*>(zf);
    const int Mg = M / G;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (S) {
        case 1: return (int)launch<1>(xf, yf, zif, zff, c, T, M, Mg, s);
        case 2: return (int)launch<2>(xf, yf, zif, zff, c, T, M, Mg, s);
        case 3: return (int)launch<3>(xf, yf, zif, zff, c, T, M, Mg, s);
        case 4: return (int)launch<4>(xf, yf, zif, zff, c, T, M, Mg, s);
        case 5: return (int)launch<5>(xf, yf, zif, zff, c, T, M, Mg, s);
        case 6: return (int)launch<6>(xf, yf, zif, zff, c, T, M, Mg, s);
        case 7: return (int)launch<7>(xf, yf, zif, zff, c, T, M, Mg, s);
        default: return (int)launch<8>(xf, yf, zif, zff, c, T, M, Mg, s);
    }
}
