// S1: cascaded biquad filtering (sosfilt) for Hopper (sm_90a) as a chunked
// time-parallel scan; plain C entry point for ctypes.
//
// Replaces the `lax.scan` of `multimodal_eeg_fmri_tpu/ops/signal.py:sosfilt`
// (no Pallas kernel: on the TPU the scan body was S fused biquads of vector
// FMAs over the batched trailing dims). For a time-major (T, M) float32 signal
// whose M series fall in G equal groups, each with its own cascade of S
// second-order sections, every step t and section s computes
//     out = b0*y + z0;  z0 = b1*y - a1*out + z1;  z1 = b2*y - a2*out;  y = out
// rounding each multiply, add and subtract to float32 in that order, as the
// JAX scan body and the port's plain versions (`ops/signal.py`) do: no FMA
// contraction. The state starts from zi (G, S, 2, M/G) or zeros and is
// written to zf (G, S, 2, M/G) when asked, so a stream can carry it across
// chunks. Grouping lets one launch filter one chunk through several bands
// (the streaming featurizer's five).
//
// What bounds it on the card: the bytes are 2*T*M*4 (each sample read and
// written once), 5.9 MB at the featurizer's (2554, 288): 1.8 us at 3.35 TB/s;
// the 9*S*T*M operations take less at 67 TFLOP/s. But the recurrence is a
// dependency chain of T steps per series, and one thread per series leaves
// the featurizer's M = 288 series in under ten warps of the card's 132 SMs,
// each walking 2554 steps at ~100 cycles a step: the chain, not the bytes,
// sets the time.
//
// Design: the recurrence is linear in its state s (the 2S values z0, z1 of
// each section, in that order), so over a chunk of L steps
//     s_{c+1} = A^L s_c + e_c,
// where A is the cascade's zero-input step and e_c the chunk's end state from
// a zero start. The time axis is cut into C = ceil(T/L) chunks, L a multiple
// of the 16-step tile, and three kernels run one after the other:
//  1. sosfilt_local_kernel, over (series, chunk): chunks 0..C-2 from a zero
//     state, keeping only e_c;
//  2. sosfilt_carry_kernel, over series and the 2S state components (lanes of
//     one warp, sharing the state by shuffles), walking
//     the chunks in order: s_{c+1} = A^L s_c + e_c in double, each multiply
//     and add rounded in a fixed order: row i adds the two products of each
//     section's columns, then sums those pairs section by section, then adds
//     e_c (A^L is block lower triangular: a section's state never reaches an
//     earlier section, so row i stops at its own section); s_c is rounded to
//     float;
//  3. sosfilt_rerun_kernel, over (series, chunk): each chunk again from s_c
//     (chunk 0 from zi), writing y, and zf from the last chunk.
// Inside a chunk y is the sequential recurrence's own arithmetic; only the
// start states carry the carry's rounding. Each thread's chain shrinks from T
// steps to 2L steps plus the C-step carry, and M*C threads fill the card.
// With C = 1 only phase 3 runs, from zi: the one-thread-per-series kernel,
// bit for bit. The wrapper (`ops/signal.py:sosfilt_cuda`) picks L
// (`sosfilt_schedule`), builds A^L on the host in double and keeps it on the
// card per coefficient set, and allocates the (C-1, 2S, M) scratch that holds
// e_c and then s_{c+1}; the kernels allocate nothing.
//
// Within a chunk each thread keeps its 2*S state and 5*S coefficients in
// registers; a warp spans 32 neighbouring series, so each time step's load
// and store is one coalesced 128-byte transaction. The coefficients travel in
// the launch's parameter block. Each thread holds a tile of TB time steps in
// registers and issues the loads of the next tile before it filters this one;
// a whole tile runs with no bounds check between its steps, so that its steps
// form one block of code that the compiler schedules together; only a last,
// partial tile checks each step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// S1's limits; mmef_sosfilt returns cudaErrorInvalidValue past them
constexpr int MAX_SECTIONS = 8;      // per cascade
constexpr int MAX_COEFF_SETS = 128;  // sections in all groups together
constexpr int MAX_CHUNKS = 65535;    // the grid's y dimension
constexpr int THREADS = 64;
constexpr int TB = 16;               // time steps per register tile
constexpr int CARRY_THREADS = 128;   // threads per carry block
constexpr int CB = 8;                // carry steps per batch of loads

struct Coeffs {
    float c[MAX_COEFF_SETS][6];      // b0 b1 b2 a0 a1 a2 per (group, section)
};

__device__ __forceinline__ void load_tile(float (&buf)[TB], const float* x,
                                          int t0, int t_end, int64_t M, int m) {
#pragma unroll
    for (int i = 0; i < TB; ++i)
        buf[i] = t0 + i < t_end ? __ldg(x + (int64_t)(t0 + i) * M + m) : 0.f;
}

// One series' cascade: its coefficients and state, in registers.
template <int S>
struct Cascade {
    float b0[S], b1[S], b2[S], a1[S], a2[S], z0[S], z1[S];

    __device__ __forceinline__ void load(const Coeffs& coeffs, int g) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const float* c = coeffs.c[g * S + s];
            b0[s] = c[0]; b1[s] = c[1]; b2[s] = c[2]; a1[s] = c[4]; a2[s] = c[5];
        }
    }

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

    // Steps [t_begin, t_end) of series m, writing y when WRITE.
    template <bool WRITE>
    __device__ __forceinline__ void run(const float* x, float* y, int t_begin,
                                        int t_end, int64_t M, int m) {
        const int t_full = t_end - (t_end - t_begin) % TB;
        float cur[TB], nxt[TB];
        load_tile(cur, x, t_begin, t_end, M, m);
        for (int t0 = t_begin; t0 < t_end; t0 += TB) {
            load_tile(nxt, x, t0 + TB, t_end, M, m);
            if (t0 < t_full) {
                // a whole tile: no check between its steps
#pragma unroll
                for (int i = 0; i < TB; ++i) {
                    const float out = step(cur[i]);
                    if (WRITE) y[(int64_t)(t0 + i) * M + m] = out;
                }
            } else {
#pragma unroll
                for (int i = 0; i < TB; ++i)
                    if (t0 + i < t_end) {
                        const float out = step(cur[i]);
                        if (WRITE) y[(int64_t)(t0 + i) * M + m] = out;
                    }
            }
#pragma unroll
            for (int i = 0; i < TB; ++i) cur[i] = nxt[i];
        }
    }
};

// Phase 1: chunk blockIdx.y (< C-1, so whole) from a zero state; its end
// state goes to w[c][2s+k][m].
template <int S>
__global__ void __launch_bounds__(THREADS)
sosfilt_local_kernel(const float* __restrict__ x, float* __restrict__ w,
                     const Coeffs coeffs, int M, int Mg, int L) {
    const int m = blockIdx.x * THREADS + threadIdx.x;
    if (m >= M) return;
    const int c = blockIdx.y;
    Cascade<S> f;
    f.load(coeffs, m / Mg);
#pragma unroll
    for (int s = 0; s < S; ++s) f.z0[s] = f.z1[s] = 0.f;
    f.template run<false>(x, nullptr, c * L, (c + 1) * L, M, m);
    float* e = w + (int64_t)c * 2 * S * M + m;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        e[(int64_t)(2 * s) * M] = f.z0[s];
        e[(int64_t)(2 * s + 1) * M] = f.z1[s];
    }
}

// Phase 2: W neighbouring lanes of a warp (W the power of two >= 2S) hold
// one series' state, lane i its component i; each step every lane gathers
// s_c from its series' lanes by shuffles (no shared memory, no barrier) and
// computes its own row. w[c] holds e_c on entry and the rounded s_{c+1} on
// exit; each thread reads its own element before it overwrites it. The e_c
// are loaded CB chunks at a time, a batch ahead of the steps that use them,
// so that a load's latency hides behind CB carry steps.
template <int S>
__global__ void __launch_bounds__(CARRY_THREADS)
sosfilt_carry_kernel(const float* __restrict__ zi, float* __restrict__ w,
                     const double* __restrict__ carry, int M, int Mg, int C) {
    constexpr int N = 2 * S;
    constexpr int W = N <= 2 ? 2 : N <= 4 ? 4 : N <= 8 ? 8 : 16;
    const int64_t t = (int64_t)blockIdx.x * CARRY_THREADS + threadIdx.x;
    const int m = (int)(t / W), i = (int)(t % W);
    const bool live = m < M && i < N;  // the others still join the shuffles
    const int mc = m < M ? m : M - 1, ic = i < N ? i : N - 1;
    const int g = mc / Mg, j = mc - g * Mg;
    const int last = ic / 2;           // row i sums sections 0 .. i/2
    const int base = (threadIdx.x & 31) & ~(W - 1);   // the series' lane 0
    double p[N];
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = __ldg(carry + ((int64_t)g * N + ic) * N + k);
    double si = zi ? (double)__ldg(zi + ((int64_t)g * N + ic) * Mg + j) : 0.0;
    const int64_t stride = (int64_t)N * M;
    float* wi = w + (int64_t)ic * M + mc;
    const int steps = C - 1;
    float e[CB], e_next[CB];
#pragma unroll
    for (int u = 0; u < CB; ++u) e_next[u] = u < steps ? wi[u * stride] : 0.f;
    for (int c0 = 0; c0 < steps; c0 += CB) {
#pragma unroll
        for (int u = 0; u < CB; ++u) {
            e[u] = e_next[u];
            const int c = c0 + CB + u;
            e_next[u] = c < steps ? wi[c * stride] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < CB; ++u) {
            const int c = c0 + u;
            if (c < steps) {          // the same for every thread
                double sk[N];
#pragma unroll
                for (int k = 0; k < N; ++k)
                    sk[k] = __shfl_sync(0xffffffffu, si, base + k);
                double acc = 0.0;
#pragma unroll
                for (int q = 0; q < S; ++q) {
                    if (q > last) break;
                    const double pair = __dadd_rn(__dmul_rn(p[2 * q], sk[2 * q]),
                                                  __dmul_rn(p[2 * q + 1], sk[2 * q + 1]));
                    acc = q == 0 ? pair : __dadd_rn(acc, pair);
                }
                si = __dadd_rn(acc, (double)e[u]);
                if (live) wi[c * stride] = __double2float_rn(si);
            }
        }
    }
}

// Phase 3: chunk blockIdx.y from its start state (zi or zeros for chunk 0,
// w[c-1] after it), writing y, and zf from the last chunk.
template <int S>
__global__ void __launch_bounds__(THREADS)
sosfilt_rerun_kernel(const float* __restrict__ x, float* __restrict__ y,
                     const float* __restrict__ zi, const float* __restrict__ w,
                     float* __restrict__ zf, const Coeffs coeffs, int T, int M,
                     int Mg, int L) {
    const int m = blockIdx.x * THREADS + threadIdx.x;
    if (m >= M) return;
    const int c = blockIdx.y;
    const int g = m / Mg, j = m - g * Mg;
    Cascade<S> f;
    f.load(coeffs, g);
    if (c == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int64_t i0 = (int64_t)(g * S + s) * 2 * Mg + j;  // zi[g][s][0][j]
            f.z0[s] = zi ? zi[i0] : 0.f;
            f.z1[s] = zi ? zi[i0 + Mg] : 0.f;
        }
    } else {
        const float* s0 = w + (int64_t)(c - 1) * 2 * S * M + m;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            f.z0[s] = s0[(int64_t)(2 * s) * M];
            f.z1[s] = s0[(int64_t)(2 * s + 1) * M];
        }
    }
    const int t_end = c + 1 == (int)gridDim.y ? T : (c + 1) * L;
    f.template run<true>(x, y, c * L, t_end, M, m);
    if (zf && t_end == T) {
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
                   const double* carry, float* w, const Coeffs& c, int T,
                   int M, int Mg, int L, int C, cudaStream_t stream) {
    const unsigned blocks = (M + THREADS - 1) / THREADS;
    if (C > 1) {
        sosfilt_local_kernel<S><<<dim3(blocks, C - 1), THREADS, 0, stream>>>(
            x, w, c, M, Mg, L);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        constexpr int W = 2 * S <= 2 ? 2 : 2 * S <= 4 ? 4 : 2 * S <= 8 ? 8 : 16;
        sosfilt_carry_kernel<S><<<(unsigned)(((int64_t)M * W + CARRY_THREADS - 1)
                                             / CARRY_THREADS),
                                  CARRY_THREADS, 0, stream>>>(zi, w, carry, M, Mg, C);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    sosfilt_rerun_kernel<S><<<dim3(blocks, C), THREADS, 0, stream>>>(
        x, y, zi, w, zf, c, T, M, Mg, L);
    return cudaGetLastError();
}

}  // namespace

// x, y: (T, M) float32 on the card; zi, zf: (G, S, 2, M/G) float32 on the card
// or null (zeros in, nothing out); coeffs: G*S*6 float32 in HOST memory, row
// (b0 b1 b2 a0 a1 a2) per (group, section); L: the chunk length, L >= T for
// the sequential schedule, else a multiple of 16; carry: (G, 2S, 2S) float64
// A^L and w: (C-1, 2S, M) float32 scratch on the card, C = ceil(T/L), both
// null when L >= T. Launches 3 kernels (1 when L >= T) on the stream; returns
// a cudaError_t.
extern "C" int mmef_sosfilt(const void* x, void* y, const void* zi, void* zf,
                            const float* coeffs, const void* carry, void* w,
                            int G, int S, int T, int M, int L, void* stream) {
    if (G < 1 || S < 1 || S > MAX_SECTIONS || G * S > MAX_COEFF_SETS || T < 1 ||
        M < 1 || M % G != 0 || L < 1)
        return (int)cudaErrorInvalidValue;
    if (L > T) L = T;
    const int C = (T + L - 1) / L;
    if (C > 1 && (L % TB != 0 || C > MAX_CHUNKS || !carry || !w))
        return (int)cudaErrorInvalidValue;
    Coeffs c;
    for (int i = 0; i < G * S; ++i)
        for (int k = 0; k < 6; ++k) c.c[i][k] = coeffs[i * 6 + k];
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    const float* zif = static_cast<const float*>(zi);
    float* zff = static_cast<float*>(zf);
    const double* cd = static_cast<const double*>(carry);
    float* wf = static_cast<float*>(w);
    const int Mg = M / G;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (S) {
        case 1: return (int)launch<1>(xf, yf, zif, zff, cd, wf, c, T, M, Mg, L, C, s);
        case 2: return (int)launch<2>(xf, yf, zif, zff, cd, wf, c, T, M, Mg, L, C, s);
        case 3: return (int)launch<3>(xf, yf, zif, zff, cd, wf, c, T, M, Mg, L, C, s);
        case 4: return (int)launch<4>(xf, yf, zif, zff, cd, wf, c, T, M, Mg, L, C, s);
        case 5: return (int)launch<5>(xf, yf, zif, zff, cd, wf, c, T, M, Mg, L, C, s);
        case 6: return (int)launch<6>(xf, yf, zif, zff, cd, wf, c, T, M, Mg, L, C, s);
        case 7: return (int)launch<7>(xf, yf, zif, zff, cd, wf, c, T, M, Mg, L, C, s);
        default: return (int)launch<8>(xf, yf, zif, zff, cd, wf, c, T, M, Mg, L, C, s);
    }
}
