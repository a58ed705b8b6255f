// Stacked-factor mode contraction: the grouped sum-of-products apply on its
// physical modes, for Hopper (sm_90a).
//
// Layout.  A lane of the product basis, row-major over its modes, viewed
// about one mode of width N as (pre, N, post); m lanes, lane-major, one lane
// every lane_stride elements.  A launch contracts S terms on that mode:
//   F        (S, N, N)  the terms' factors on the mode, row-major: F[s, i, j]
//   x[s]     term s's input lane stack; equal pointers are one input
//   y[s]     term s's output lane stack (y[0] alone when the terms sum)
// computing, for every lane k, p < pre, i < N, q < post,
//   t_s[k, p, i, q] = sum_j F[s, i, j] * x[s][k, p, j, q]
// and then either  y[s] = t_s  for every s (a fan-out from one x, or a
// term's next mode, in place when x[s] == y[s]), or, with sum_out,
//   y[0] = sum_s t_s (+ y[0] when beta)
// with the term sum in registers (the fan-in).  A grouped SoP term touches
// two to four modes of width 17 or so, so the apply is a chain of such
// contractions per group of terms (ops/operators.py plans them).
//
// It replaces no Pallas kernel: the JAX package left the sum-of-products
// apply to XLA (einsum over stacked, Kronecker-fused factors).  The port's
// fused form multiplied 289-wide Kronecker products that are mostly
// kron(A, I) or kron(I, B); this kernel contracts the physical modes alone.
//
// What bounds it.  An output element costs N FMAs per term against 8 bytes
// (f64) read per term and 8 written: at N <= 32 that is far below the card's
// balance, so a launch costs its HBM bytes -- each input read once, each
// output written once.  The design serves that:
//  * one launch per role over every lane, whatever S: the terms' inputs and
//    outputs are a table of addresses, so a fan-out reads x once for all
//    its terms and a fan-in reads y once and writes it once;
//  * the factors of all S terms (zero-padded to NMAX = ceil(N / 4) * 4
//    rows, transposed so that a thread's output rows for one j are
//    contiguous) sit in shared memory, read as 16-byte broadcasts;
//  * each thread owns one column (p, q) of a tile of 256: its N inputs, and
//    N sums in registers across the term loop; no split over j, no atomics,
//    a fixed order: deterministic;
//  * post >= 32 (direct): a tile's columns are consecutive (p, q), so each
//    of a warp's N loads and stores is contiguous in q; each thread copies
//    its column of the next term, or of the next tile, into a second tile
//    (cp.async) while it multiplies the current one, with no barrier;
//  * post < 32 (slab): a tile is 256 / post whole (N, post) slabs, one
//    contiguous range, loaded and stored linearly through shared memory
//    (rows padded to an odd stride: no bank conflicts at post = 1), so the
//    narrow modes stay coalesced;
//  * a fan-in is a persistent grid (the blocks the card holds, each
//    walking tiles), which loads the factors once a block; the other roles
//    run a block a tile, which measured faster for them (PERF.md).
// Measured on an H100 SXM at n = 17^6 in f64 (PERF.md): 63-68 % of the byte
// bound in every role and mode; the same kernel with the FMAs taken out
// was no faster, so the memory system, not the arithmetic, sets the rest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// A tile's row stride: odd, so that rows j and j + 1 of one column (the
// slab mode's linear order at post = 1) fall in different banks.
constexpr int TP = THREADS + 1;
constexpr int MAX_TERMS = 32;
constexpr int MAX_WIDTH = 32;
// The factors a launch may bring (the caller splits larger stacks); with
// two of the widest tiles (N = 32: 64 KB each in f64) a block takes at most
// 176 KB of shared memory.
constexpr int FACTOR_BYTES = 48 * 1024;

struct Terms {
    const void* x[MAX_TERMS];
    void* y[MAX_TERMS];
};

template <typename T> struct Vec;
template <> struct Vec<double> { using type = double2; static constexpr int W = 2; };
template <> struct Vec<float> { using type = float4; static constexpr int W = 4; };

__device__ __forceinline__ void madd(double* a, double2 f, double x) {
    a[0] = fma(f.x, x, a[0]);
    a[1] = fma(f.y, x, a[1]);
}

__device__ __forceinline__ void madd(float* a, float4 f, float x) {
    a[0] = fmaf(f.x, x, a[0]);
    a[1] = fmaf(f.y, x, a[1]);
    a[2] = fmaf(f.z, x, a[2]);
    a[3] = fmaf(f.w, x, a[3]);
}

// n / d for n < 2^31 by a multiply and a shift (d fixed per launch): the
// slab mode maps each element of its linear range to (slab, row, column).
struct FastDiv {
    unsigned m, s;
    FastDiv(unsigned d) : s(0) {
        while ((1u << s) < d) ++s;
        m = (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
    }
    __device__ __forceinline__ unsigned operator()(unsigned n) const {
        return (__umulhi(n, m) + n) >> s;
    }
};

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(dst), "l"(gmem), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Each block walks tiles t += gridDim.x, 256 columns (direct) or P whole
// slabs (slab) of one lane, tile-major over the lanes.  A column c's inputs
// sit in a shared tile as tile[j * TP + c].
// Direct: two tiles; each thread copies its own column (cp.async) for the
// next term, or the next tile's first term, while it multiplies the
// current one, with no barrier.  Slab: one input tile filled linearly by
// the block, and an output tile that stages the results for the linear
// store.
template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS, 2)
sop_contract_kernel(const T* __restrict__ F, Terms terms, int S, int N,
                    long long pre, int post, long long lane_stride,
                    int sum_out, int beta, int P, long long per_lane,
                    long long total, FastDiv by_slab, FastDiv by_post) {
    using V = typename Vec<T>::type;
    constexpr int W = Vec<T>::W;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Ft = reinterpret_cast<T*>(smem_raw);      // (S, N, NMAX)
    T* tiles = Ft + S * N * NMAX;                // 2 x (N, TP)
    const int tid = threadIdx.x;
    const int slab_len = N * post;               // slab mode only: < 1024

    for (int e = tid; e < S * N * NMAX; e += THREADS) {
        const int s = e / (N * NMAX), r = e - s * N * NMAX;
        const int j = r / NMAX, i = r - j * NMAX;
        Ft[e] = i < N ? F[(s * N + i) * N + j] : T(0);
    }

    T acc[NMAX];
    auto zero = [&]() {
#pragma unroll
        for (int i = 0; i < NMAX; ++i) acc[i] = T(0);
    };
    auto multiply = [&](const T* tile, int s) {   // acc += F_s column c
        const T* Fs = Ft + s * N * NMAX;
        for (int j = 0; j < N; ++j) {
            const T xj = tile[j * TP + tid];
            const V* fr = reinterpret_cast<const V*>(Fs + j * NMAX);
#pragma unroll
            for (int v = 0; v < NMAX / W; ++v) madd(acc + v * W, fr[v], xj);
        }
    };
    auto to_y = [&](T* Y) {                        // y (+)= acc, own column
#pragma unroll
        for (int i = 0; i < NMAX; ++i) {
            if (i < N) {
                T v = acc[i];
                if (beta) v += Y[(long long)i * post];
                Y[(long long)i * post] = v;
            }
        }
    };

    if (!P) {                                     // direct mode
        // element offset of tile t's column c, and whether it exists
        auto column = [&](long long t, long long& off, bool& ok) {
            const long long lane = t / per_lane;
            const long long g = (t - lane * per_lane) * THREADS + tid;
            const long long p = g / post;
            ok = t < total && g < pre * post;
            off = lane * lane_stride + p * N * post + (g - p * post);
        };
        auto fetch = [&](T* tile, const void* x, long long off, bool ok) {
            const T* X = reinterpret_cast<const T*>(x) + off;
            if (ok) {
                for (int j = 0; j < N; ++j)
                    cp_async(tile + j * TP + tid,
                             X + (long long)j * post);
            }
            cp_commit();
        };
        long long t = blockIdx.x, off, next_off;
        bool ok, next_ok;
        column(t, off, ok);
        fetch(tiles, terms.x[0], off, ok);
        __syncthreads();                          // the factors
        int b = 0;
        for (; t < total; t += gridDim.x) {
            column(t + gridDim.x, next_off, next_ok);
            for (int s = 0; s < S; ++s) {
                T* other = tiles + (b ^ 1) * N * TP;
                bool load;
                if (s + 1 < S) {
                    load = terms.x[s + 1] != terms.x[s];
                    if (load) fetch(other, terms.x[s + 1], off, ok);
                } else {
                    load = t + gridDim.x < total;
                    if (load) fetch(other, terms.x[0], next_off, next_ok);
                }
                if (!load) cp_commit();
                cp_wait<1>();
                if (!sum_out || s == 0) zero();
                multiply(tiles + b * N * TP, s);
                if (!sum_out && ok) {
                    T* Y = reinterpret_cast<T*>(terms.y[s]) + off;
#pragma unroll
                    for (int i = 0; i < NMAX; ++i)
                        if (i < N) Y[(long long)i * post] = acc[i];
                }
                if (load) b ^= 1;
            }
            if (sum_out && ok) to_y(reinterpret_cast<T*>(terms.y[0]) + off);
            off = next_off;
            ok = next_ok;
        }
        return;
    }

    // slab mode: the tile index of element f of a block's linear range
    auto slot = [&](int f) {
        const int sl = (int)by_slab((unsigned)f), r = f - sl * slab_len;
        const int j = (int)by_post((unsigned)r);
        return j * TP + sl * post + (r - j * post);
    };
    T* in = tiles;
    T* out = tiles + N * TP;
    __syncthreads();                              // the factors
    for (long long t = blockIdx.x; t < total; t += gridDim.x) {
        const long long lane = t / per_lane;
        const long long p0 = (t - lane * per_lane) * P;
        const int np = pre - p0 < P ? (int)(pre - p0) : P;
        const long long base = lane * lane_stride + p0 * slab_len;
        const int count = np * slab_len;
        for (int s = 0; s < S; ++s) {
            if (s == 0 || terms.x[s] != terms.x[s - 1]) {
                const T* X = reinterpret_cast<const T*>(terms.x[s]) + base;
                __syncthreads();                  // the tile is free
                for (int f = tid; f < count; f += THREADS)
                    cp_async(in + slot(f), X + f);
                cp_commit();
                cp_wait<0>();
                __syncthreads();
            }
            if (!sum_out || s == 0) zero();
            multiply(in, s);
            if (sum_out) continue;
            T* Y = reinterpret_cast<T*>(terms.y[s]) + base;
#pragma unroll
            for (int i = 0; i < NMAX; ++i)
                if (i < N) out[i * TP + tid] = acc[i];
            __syncthreads();
            for (int f = tid; f < count; f += THREADS) Y[f] = out[slot(f)];
            __syncthreads();                      // out is free
        }
        if (!sum_out) continue;
        T* Y = reinterpret_cast<T*>(terms.y[0]) + base;
#pragma unroll
        for (int i = 0; i < NMAX; ++i)
            if (i < N) out[i * TP + tid] = acc[i];
        __syncthreads();
        for (int f = tid; f < count; f += THREADS) {
            T v = out[slot(f)];
            if (beta) v += Y[f];
            Y[f] = v;
        }
        __syncthreads();
    }
}

template <typename T, int NMAX>
int launch_width(const void* F, const Terms& terms, int S, int N,
                 long long pre, int post, int m, long long lane_stride,
                 int sum_out, int beta, void* stream) {
    auto kernel = sop_contract_kernel<T, NMAX>;
    // blocks the card holds at once for each (S, N): a fan-in's grid
    static int resident[MAX_TERMS + 1][4];
    static int sms = 0;
    if (!sms) {
        const int most = FACTOR_BYTES + 2 * MAX_WIDTH * TP
                         * (int)sizeof(T);
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        int dev = 0;
        if (e == cudaSuccess) e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return (int)e;
    }
    const size_t smem = ((size_t)S * N * NMAX + 2 * (size_t)N * TP)
                        * sizeof(T);
    int& per_sm = resident[S][(N - 1) % 4];
    if (!per_sm) {
        cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, THREADS, smem);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    }
    const int P = post < 32 ? THREADS / post : 0;
    const long long per_lane = P ? (pre + P - 1) / P
                                 : (pre * post + THREADS - 1) / THREADS;
    const long long total = per_lane * m;
    const long long cap = sum_out ? (long long)per_sm * sms : total;
    const long long blocks = total < cap ? total : cap;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const T*>(F), terms, S, N, pre, post, lane_stride,
        sum_out, beta, P, per_lane, total, FastDiv(P ? N * post : 1),
        FastDiv(P ? post : 1));
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* F, const long long* xs, const long long* ys, int S,
           int N, long long pre, long long post, int m, long long lane_stride,
           int sum_out, int beta, void* stream) {
    if (S < 1 || S > MAX_TERMS || N < 1 || N > MAX_WIDTH || m < 1
        || pre < 1 || post < 1 || post > 0x7fffffffLL
        || (size_t)S * N * ((N + 3) / 4 * 4) * sizeof(T) > (size_t)FACTOR_BYTES)
        return (int)cudaErrorInvalidValue;
    Terms terms;
    for (int s = 0; s < MAX_TERMS; ++s) {
        terms.x[s] = s < S ? reinterpret_cast<const void*>(xs[s]) : nullptr;
        terms.y[s] = s < (sum_out ? 1 : S)
                     ? reinterpret_cast<void*>(ys[s]) : nullptr;
    }
    const int p = (int)post;
    switch ((N + 3) / 4) {
        case 1: return launch_width<T, 4>(F, terms, S, N, pre, p, m, lane_stride, sum_out, beta, stream);
        case 2: return launch_width<T, 8>(F, terms, S, N, pre, p, m, lane_stride, sum_out, beta, stream);
        case 3: return launch_width<T, 12>(F, terms, S, N, pre, p, m, lane_stride, sum_out, beta, stream);
        case 4: return launch_width<T, 16>(F, terms, S, N, pre, p, m, lane_stride, sum_out, beta, stream);
        case 5: return launch_width<T, 20>(F, terms, S, N, pre, p, m, lane_stride, sum_out, beta, stream);
        case 6: return launch_width<T, 24>(F, terms, S, N, pre, p, m, lane_stride, sum_out, beta, stream);
        case 7: return launch_width<T, 28>(F, terms, S, N, pre, p, m, lane_stride, sum_out, beta, stream);
        default: return launch_width<T, 32>(F, terms, S, N, pre, p, m, lane_stride, sum_out, beta, stream);
    }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches ONE kernel on the
// given stream, does not synchronise, allocates nothing, and returns the
// CUDA error code of the launch (0 = cudaSuccess); an argument out of range
// returns cudaErrorInvalidValue without a launch.  xs and ys are host arrays
// of S device addresses (ys: one when sum_out); the caller checks shapes,
// types, devices and contiguity, 1 <= S <= 32, 1 <= N <= 32, and that the
// factors fit FACTOR_BYTES (S * N * ceil(N / 4) * 4 elements).
extern "C" {

int sop_contract_f32(const void* F, const long long* xs, const long long* ys,
                     int S, int N, long long pre, long long post, int m,
                     long long lane_stride, int sum_out, int beta,
                     void* stream) {
    return launch<float>(F, xs, ys, S, N, pre, post, m, lane_stride, sum_out,
                         beta, stream);
}

int sop_contract_f64(const void* F, const long long* xs, const long long* ys,
                     int S, int N, long long pre, long long post, int m,
                     long long lane_stride, int sum_out, int beta,
                     void* stream) {
    return launch<double>(F, xs, ys, S, N, pre, post, m, lane_stride, sum_out,
                          beta, stream);
}

const char* sop_contract_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
