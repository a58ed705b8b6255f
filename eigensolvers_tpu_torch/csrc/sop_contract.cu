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
//
// The pair role (sop_pair_kernel).  A chain of one-mode contractions sends
// each multi-mode term through a slot: written by its first mode, read back
// by its last, two passes over n a term.  The pair role contracts a term's
// two lowest modes a < b in one pass: on the view (pre, Na, mid, Nb, post)
// of a lane, S terms sharing (a, b) compute
//   t_s[k, p, i, r, j, q] = sum_{u, v} B_s[j, v] A_s[i, u] x[k, p, u, r, v, q]
// (mode a first, then b), each written to its slot (a term with more
// modes: the first nslot terms) or summed into y (+ y when beta).
//
// What bounds it.  Its bytes are x read once, y read and written once and
// each slot written once.  Against them, 2 (Na + Nb) flops an element a
// term: at N = 17 and S = 5 that is 14 flops a byte, above the CUDA cores'
// f64 balance (34 TFLOP/s : 3.35 TB/s) and near the FP64 tensor cores'.
// A first design on the CUDA cores ran at 8-16 % of the byte bound; one
// on the tensor cores whose warps all copied and computed by turns ran
// its copies and its products one after the other, neither overlapping.
// The design:
//  * the products on the FP64 tensor cores (mma.sync m16n8k4, as B3's f64
//    route): a tile of 8 consecutive columns (p, r, q) of a lane, every
//    (u, v) of each, is an (Nb * 8) x Na matrix for mode a and, through U
//    in shared memory, an (Na * 8) x Nb one for mode b; at N = 17 the
//    padding of a width to whole 8 x 4 fragments wastes 40 % of the
//    products, which the tensor cores' rate pays for;
//  * f32 takes the same route: its factors, x, y and slots are read and
//    written as f32, and its products and term sums are f64 (the tensor
//    cores have no f32 product but TF32's, which drops 13 bits), so an f32
//    term rounds once, at its store, where the one-mode roles round at
//    each f32 FMA: an f32 operator is no less exact than with f32 FMAs;
//  * warp specialisation: one producer warp starts every cp.async (the
//    next tile's x into a second buffer where two fit, this tile's y), and
//    the consumer warps, PAIR_MT m-tiles each, meet at a barrier of their
//    own, so a copy that stalls while the memory system is busy never
//    holds up the products;
//  * no branch in the inner loops (a padding row or k-step reads finite
//    data that a zero factor cancels), shared-memory offsets computed once
//    a thread, the factors of all S terms in shared memory, and the term
//    sum in registers: y is read and written once a tile, each element by
//    one thread in a fixed order, with no atomics.
// Measured on an H100 SXM at n = 17^6 in f64, 3 lanes (PERF.md): a launch
// of one or two terms runs at 52-58 % of its byte bound, and each term
// beyond adds ~0.27 ms, twice the tensor cores' bound for its products.

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
    FastDiv() : m(1), s(0) {}
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

// ---------------------------------------------------------------------------
// The pair role.  A launch: S terms on modes a < b of the (pre, Na, mid, Nb,
// post) view, one input x, the first nslot terms to their slots, the rest
// summed into y.  A lane's columns are its pre * mid * post positions
// (p, r, q) in order, g = (p * mid + r) * post + q; a tile is 8 of them,
// every (j, l) of each: (Na, Nb, 8).

// D += A B for one 16 x 8 x 4 tile in IEEE f64, in the fragment order of
// the PTX ISA: a0 = A[g][q], a1 = A[g+8][q]; b0 = B[q][g]; d0 d1 =
// D[g][2q, 2q+1], d2 d3 = D[g+8][2q, 2q+1] (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void mma16(double (&d)[4], double a0, double a1,
                                      double b0) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(b0));
}

constexpr int PAIR_MT = 3;              // m-tiles a warp, in each stage
constexpr int PAIR_MAX_THREADS = 224;   // 16 m-tiles (N = 32) / 3: 6 + 1 warps
constexpr int PAIR_SMEM_MAX = 227 * 1024;
// The factors a launch keeps in shared memory, in f64, each (N, pair_row(N))
// with zeros past column N (the caller splits larger stacks).
constexpr int PAIR_FACTOR_BYTES = 48 * 1024;

// a factor's row stride in shared memory: whole k-steps of 4, and 4 or 12
// (mod 16) doubles, so that a fragment's 8 rows use distinct banks in pairs
__host__ __device__ inline int pair_row(int N) {
    const int r = (N + 3) / 4 * 4;
    return r % 8 ? r : r + 4;
}

struct PairArgs {
    const void* A;           // (S, Na, Na)
    const void* B;           // (S, Nb, Nb)
    const void* x;
    void* y;                 // the sum's output (terms nslot..S-1)
    void* out[MAX_TERMS];    // term s < nslot: its slot
    int S, nslot, Na, Nb, beta, SJ, SU, nbuf;
    long long cols, post, mid, sP, sj, sR, lane_stride, per_lane, total;
    FastDiv by_nb, by_post, by_mid;
};

// The pair kernel: a persistent grid of blocks walks the tiles.  A block
// is W consumer warps and one producer warp.  The producer copies
// (cp.async) this tile's y into shared memory, and the next tile's x into
// a second buffer where two fit, while the consumers work on this tile:
// for each term, on the FP64 tensor cores,
//   mode a:  U^T[(l, c), i] = sum_j X^T[(l, c), j] A^T[j, i], rows two l
//            at a time, PAIR_MT m-tiles a warp, into U (shared, f64);
//   mode b:  T^T[(i, c), k] = sum_l U^T[(i, c), l] B^T[l, k], rows two i
//            at a time, into sums that stay in registers across the terms.
// The consumers meet at a barrier of their own, so the producer's copies
// (which stall a warp while the memory system is busy) never hold up the
// products.  The inner loops branch once, before a last k-step that is
// all past N (2 ceil(N / 8) k-steps, of which ceil(N / 4) are real; a
// factor fragment past N is zero, so a fragment row or column past N adds
// nothing), a row index past Na or Nb reads the last real row (finite,
// cancelled by the zero factor), and a warp's m-tile past the last repeats
// it (its results are not stored).  x and y are read and written once a
// tile, each element by one thread in a fixed order.
template <typename T, int NA8, int NB8>
__global__ void __launch_bounds__(PAIR_MAX_THREADS, 1)
sop_pair_kernel(PairArgs a) {
    constexpr int MT = PAIR_MT;
    constexpr int KSA = 2 * NA8, KSB = 2 * NB8;  // k-steps of the stages
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int Na = a.Na, Nb = a.Nb, S = a.S, SJ = a.SJ, SU = a.SU;
    const int RA = pair_row(Na), RB = pair_row(Nb);
    const int KA = (Na + 3) / 4, KB = (Nb + 3) / 4;
    double* Fa = reinterpret_cast<double*>(smem_raw);    // (S, Na, RA)
    double* Fb = Fa + S * Na * RA;                       // (S, Nb, RB)
    double* U = Fb + S * Nb * RB;                        // (i, l, c): i SU
    T* tiles = reinterpret_cast<T*>(U + Na * SU);        // y, x (, x): j SJ
    const int xlen = Na * SJ, nbuf = a.nbuf;
    T* Yt = tiles;
    tiles += xlen;
    const int tid = threadIdx.x, W = (blockDim.x >> 5) - 1;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
    const bool producer = warp == W;
    const int M1 = (Nb + 1) / 2, M2 = (Na + 1) / 2;
    const bool read_y = a.beta && S > a.nslot;
    {
        const T* A = reinterpret_cast<const T*>(a.A);
        const T* B = reinterpret_cast<const T*>(a.B);
        for (int e = tid; e < S * Na * RA; e += blockDim.x) {
            const int r = e / RA, j = e - r * RA;        // r = s Na + i
            Fa[e] = j < Na ? (double)A[r * Na + j] : 0.0;
        }
        for (int e = tid; e < S * Nb * RB; e += blockDim.x) {
            const int r = e / RB, l = e - r * RB;        // r = s Nb + k
            Fb[e] = l < Nb ? (double)B[r * Nb + l] : 0.0;
        }
    }
    // this thread's shared-memory offsets
    int xj[KSA], ul[KSB];                 // the k-steps' rows j and l
#pragma unroll
    for (int ks = 0; ks < KSA; ++ks)
        xj[ks] = (4 * ks + q < Na ? 4 * ks + q : Na - 1) * SJ;
#pragma unroll
    for (int ks = 0; ks < KSB; ++ks)
        ul[ks] = (4 * ks + q < Nb ? 4 * ks + q : Nb - 1) * 8 + g;
    const int fa = g * RA + q, fb = g * RB + q;   // a fragment's (g, q)
    // the last n-tile's row g is real
    const bool ga = (NA8 - 1) * 8 + g < Na, gb = (NB8 - 1) * 8 + g < Nb;
    auto consumers_sync = [&]() {
        asm volatile("bar.sync 1, %0;\n" :: "r"(W * 32) : "memory");
    };

    // element offset of column c of tile t (its (p, r, q) in its lane), or
    // -1 past the lane's last column
    auto column = [&](long long t, int c) -> long long {
        const long long lane_i = t / a.per_lane;
        const long long col = (t - lane_i * a.per_lane) * 8 + c;
        if (col >= a.cols) return -1;
        const long long u = a.by_post((unsigned)col);
        const long long p = a.by_mid((unsigned)u);
        return lane_i * a.lane_stride + p * a.sP + (u - p * a.mid) * a.sR
               + (col - u * a.post);
    };
    // the producer's lane copies column lane % 8 of every fourth row
    auto load = [&](const void* src, long long t, T* tile) {
        const T* V = reinterpret_cast<const T*>(src);
        const int c = lane & 7;
        const long long base = column(t, c);
        if (base >= 0) {
            for (int row = lane >> 3; row < Na * Nb; row += 4) {
                const int j = (int)a.by_nb((unsigned)row), l = row - j * Nb;
                cp_async(tile + j * SJ + l * 8 + c,
                         V + base + j * a.sj + (long long)l * a.post);
            }
        }
        cp_commit();
    };

    double acc[MT][NB8][4];
    long long t = blockIdx.x;
    if (producer && nbuf == 2 && t < a.total) load(a.x, t, tiles);
    int b = 0;
    for (; t < a.total; t += gridDim.x, b ^= nbuf - 1) {
        if (producer) {
            if (nbuf == 1) load(a.x, t, tiles);
            cp_wait<0>();                         // x of tile t
        }
        __syncthreads();                          // x of tile t; the last
                                                  // tile's reads are done
        if (producer) {
            if (read_y) load(a.y, t, Yt);
            else cp_commit();
            const long long tn = t + gridDim.x;
            if (nbuf == 2 && tn < a.total)
                load(a.x, tn, tiles + (b ^ 1) * xlen);
            else cp_commit();
            cp_wait<1>();                         // y of tile t
            __syncthreads();                      // y
            continue;
        }
        const T* Xt = tiles + b * xlen;
        const long long colg = column(t, g);      // this thread's outputs
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int nt = 0; nt < NB8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0;
        for (int s = 0; s < S; ++s) {
            {                                     // mode a, into U
                const double* F = Fa + s * Na * RA + fa;
                double f[NA8][KSA];               // A^T[j][i] = A[i][j]
#pragma unroll
                for (int nt = 0; nt < NA8; ++nt)
#pragma unroll
                    for (int ks = 0; ks < KSA; ++ks)
                        f[nt][ks] = ks < KA && (nt + 1 < NA8 || ga)
                                    ? F[nt * 8 * RA + ks * 4] : 0.0;
#pragma unroll
                for (int mi = 0; mi < MT; ++mi) {
                    const int m = warp + mi * W;
                    const int mt = m < M1 ? m : M1 - 1;
                    const int l0 = 2 * mt;
                    const int o0 = l0 * 8 + g;
                    const int o1 = (l0 + 1 < Nb ? l0 + 1 : l0) * 8 + g;
                    double d[NA8][4];
#pragma unroll
                    for (int nt = 0; nt < NA8; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) d[nt][e] = 0.0;
#pragma unroll
                    for (int ks = 0; ks < KSA; ++ks) {
                        if (ks + 1 == KSA && KA < KSA) break;
                        const double a0 = (double)Xt[xj[ks] + o0];
                        const double a1 = (double)Xt[xj[ks] + o1];
#pragma unroll
                        for (int nt = 0; nt < NA8; ++nt)
                            mma16(d[nt], a0, a1, f[nt][ks]);
                    }
                    if (m < M1) {
#pragma unroll
                        for (int nt = 0; nt < NA8; ++nt)
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int i = nt * 8 + 2 * q + e;
                                if (i < Na) {
                                    U[i * SU + o0] = d[nt][e];
                                    if (l0 + 1 < Nb)
                                        U[i * SU + o0 + 8] = d[nt][2 + e];
                                }
                            }
                    }
                }
            }
            consumers_sync();                     // U
            {                                     // mode b, into the sums
                const double* F = Fb + s * Nb * RB + fb;
                double f[NB8][KSB];               // B^T[l][k] = B[k][l]
#pragma unroll
                for (int nt = 0; nt < NB8; ++nt)
#pragma unroll
                    for (int ks = 0; ks < KSB; ++ks)
                        f[nt][ks] = ks < KB && (nt + 1 < NB8 || gb)
                                    ? F[nt * 8 * RB + ks * 4] : 0.0;
#pragma unroll
                for (int ks = 0; ks < KSB; ++ks) {
                    if (ks + 1 == KSB && KB < KSB) break;
#pragma unroll
                    for (int mi = 0; mi < MT; ++mi) {
                        const int m = warp + mi * W;
                        const int i0 = 2 * (m < M2 ? m : M2 - 1);
                        const int i1 = i0 + 1 < Na ? i0 + 1 : i0;
                        const double a0 = U[i0 * SU + ul[ks]];
                        const double a1 = U[i1 * SU + ul[ks]];
#pragma unroll
                        for (int nt = 0; nt < NB8; ++nt)
                            mma16(acc[mi][nt], a0, a1, f[nt][ks]);
                    }
                }
            }
            if (s < a.nslot && colg >= 0) {       // a slot: store, restart
                T* O = reinterpret_cast<T*>(a.out[s]) + colg;
#pragma unroll
                for (int mi = 0; mi < MT; ++mi) {
                    const int i0 = 2 * (warp + mi * W);
#pragma unroll
                    for (int nt = 0; nt < NB8; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int i = i0 + (e >> 1);
                            const int k = nt * 8 + 2 * q + (e & 1);
                            if (i < Na && k < Nb)
                                O[i * a.sj + k * a.post] = (T)acc[mi][nt][e];
                            acc[mi][nt][e] = 0.0;
                        }
                }
            }
            consumers_sync();                     // U is free
        }
        __syncthreads();                          // y of tile t
        if (S > a.nslot && colg >= 0) {           // the sum: y (+)= it
            T* Y = reinterpret_cast<T*>(a.y) + colg;
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
                const int i0 = 2 * (warp + mi * W);
#pragma unroll
                for (int nt = 0; nt < NB8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = i0 + (e >> 1);
                        const int k = nt * 8 + 2 * q + (e & 1);
                        if (i >= Na || k >= Nb) continue;
                        double v = acc[mi][nt][e];
                        if (read_y) v += (double)Yt[i * SJ + k * 8 + g];
                        Y[i * a.sj + k * a.post] = (T)v;
                    }
            }
        }
    }
    if (producer) cp_wait<0>();
}

// shared memory of a pair launch: the factors (padded) and U in f64, a y
// tile and nbuf x tiles, each plane padded so that a warp's fragment loads
// and stores use distinct banks
template <typename T>
size_t pair_smem(int S, int Na, int Nb, int nbuf, int& SJ, int& SU) {
    const int row = Nb * 8;
    SU = row + 4;                   // 2 SU = 8 (mod 16) doubles
    SJ = row + (row % 16 ? 0 : 8);  // 8 (mod 16) doubles; 8 or 24 (mod 32) floats
    return ((size_t)S * (Na * pair_row(Na) + Nb * pair_row(Nb))
            + (size_t)Na * SU) * sizeof(double)
           + (1 + nbuf) * (size_t)Na * SJ * sizeof(T);
}

template <typename T, int NA8, int NB8>
int pair_launch_width(PairArgs& a, int threads, size_t smem, void* stream) {
    auto kernel = sop_pair_kernel<T, NA8, NB8>;
    static int sms = 0;
    if (!sms) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            PAIR_SMEM_MAX);
        int dev = 0;
        if (e == cudaSuccess) e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return (int)e;
    }
    // blocks the card holds at once, by (threads, smem): a few shapes a run
    static long long keys[16];
    static int per_sm_of[16];
    const long long key = (long long)threads << 32 | (long long)smem;
    int per_sm = 0;
    for (int k = 0; k < 16 && keys[k]; ++k)
        if (keys[k] == key) per_sm = per_sm_of[k];
    if (!per_sm) {
        cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, smem);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        for (int k = 0; k < 16; ++k)
            if (!keys[k] || k == 15) {
                keys[k] = key;
                per_sm_of[k] = per_sm;
                break;
            }
    }
    const long long cap = (long long)per_sm * sms;
    const long long blocks = a.total < cap ? a.total : cap;
    kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, int NA8>
int pair_launch_b(PairArgs& a, int threads, size_t smem, void* stream) {
    switch ((a.Nb + 7) / 8) {
        case 1: return pair_launch_width<T, NA8, 1>(a, threads, smem, stream);
        case 2: return pair_launch_width<T, NA8, 2>(a, threads, smem, stream);
        case 3: return pair_launch_width<T, NA8, 3>(a, threads, smem, stream);
        default: return pair_launch_width<T, NA8, 4>(a, threads, smem, stream);
    }
}

template <typename T>
int launch_pair(const void* A, const void* B, const void* x,
                const long long* outs, void* y, int S, int nslot, int Na,
                int Nb, long long pre, long long mid, long long post, int m,
                long long lane_stride, int beta, int* launched,
                void* stream) {
    *launched = 0;
    if (S < 1 || nslot < 0 || nslot > S || (nslot < S && !y) || Na < 1
        || Na > MAX_WIDTH || Nb < 1 || Nb > MAX_WIDTH || m < 1 || pre < 1
        || mid < 1 || post < 1 || pre * mid > 0x7fffffffLL
        || pre * mid * post > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    // the terms a launch holds: their factors within PAIR_FACTOR_BYTES, the
    // launch (one x tile) within PAIR_SMEM_MAX
    PairArgs a;
    int step = (int)(PAIR_FACTOR_BYTES / ((Na * pair_row(Na)
                                           + Nb * pair_row(Nb))
                                          * sizeof(double)));
    step = step < MAX_TERMS ? step : MAX_TERMS;
    while (step > 1 && pair_smem<T>(step, Na, Nb, 1, a.SJ, a.SU)
                       > (size_t)PAIR_SMEM_MAX)
        --step;
    if (step < 1 || pair_smem<T>(step, Na, Nb, 1, a.SJ, a.SU)
                    > (size_t)PAIR_SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    a.x = x; a.y = y; a.Na = Na; a.Nb = Nb;
    a.cols = pre * mid * post;
    a.post = post; a.mid = mid;
    a.sR = Nb * post; a.sj = mid * a.sR; a.sP = Na * a.sj;
    a.lane_stride = lane_stride;
    a.per_lane = (a.cols + 7) / 8;
    a.total = a.per_lane * m;
    a.by_nb = FastDiv(Nb);
    a.by_post = FastDiv((unsigned)post);
    a.by_mid = FastDiv((unsigned)mid);
    // consumer warps: the m-tiles of the larger stage, PAIR_MT a warp; and
    // the producer
    const int mt = ((Na > Nb ? Na : Nb) + 1) / 2;
    const int threads = ((mt + PAIR_MT - 1) / PAIR_MT + 1) * 32;
    // runs of `step` terms in order; a run after one that summed into y
    // adds to it
    for (int s0 = 0; s0 < S; s0 += step) {
        const int k = S - s0 < step ? S - s0 : step;
        const int ks = nslot - s0 < 0 ? 0 : nslot - s0 < k ? nslot - s0 : k;
        a.A = static_cast<const T*>(A) + (size_t)s0 * Na * Na;
        a.B = static_cast<const T*>(B) + (size_t)s0 * Nb * Nb;
        for (int s = 0; s < MAX_TERMS; ++s)
            a.out[s] = s < ks ? reinterpret_cast<void*>(outs[s0 + s])
                              : nullptr;
        a.S = k; a.nslot = ks;
        a.beta = beta || s0 > nslot;
        a.nbuf = 2;                 // one x tile where two do not fit
        size_t smem = pair_smem<T>(k, Na, Nb, 2, a.SJ, a.SU);
        if (smem > (size_t)PAIR_SMEM_MAX) {
            a.nbuf = 1;
            smem = pair_smem<T>(k, Na, Nb, 1, a.SJ, a.SU);
        }
        int code;
        switch ((Na + 7) / 8) {
            case 1: code = pair_launch_b<T, 1>(a, threads, smem, stream); break;
            case 2: code = pair_launch_b<T, 2>(a, threads, smem, stream); break;
            case 3: code = pair_launch_b<T, 3>(a, threads, smem, stream); break;
            default: code = pair_launch_b<T, 4>(a, threads, smem, stream);
        }
        if (code) return code;
        ++*launched;
    }
    return 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches ONE kernel on the
// given stream, does not synchronise, allocates nothing, and returns the
// CUDA error code of the launch (0 = cudaSuccess); an argument out of range
// returns cudaErrorInvalidValue without a launch.  xs and ys are host arrays
// of S device addresses (ys: one when sum_out); the caller checks shapes,
// types, devices and contiguity, 1 <= S <= 32, 1 <= N <= 32, and that the
// factors fit FACTOR_BYTES (S * N * ceil(N / 4) * 4 elements).  sop_pair
// is the exception: it launches the kernel once for each run of terms whose
// factors and tiles fit a block's shared memory, in order, and counts the
// launches in *launched; outs holds the nslot slots, and the caller checks
// shapes, types, devices and contiguity, S >= 1 and 1 <= Na, Nb <= 32.
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

int sop_pair_f32(const void* A, const void* B, const void* x,
                 const long long* outs, void* y, int S, int nslot, int Na,
                 int Nb, long long pre, long long mid, long long post, int m,
                 long long lane_stride, int beta, int* launched,
                 void* stream) {
    return launch_pair<float>(A, B, x, outs, y, S, nslot, Na, Nb, pre, mid,
                              post, m, lane_stride, beta, launched,
                              stream);
}

int sop_pair_f64(const void* A, const void* B, const void* x,
                 const long long* outs, void* y, int S, int nslot, int Na,
                 int Nb, long long pre, long long mid, long long post, int m,
                 long long lane_stride, int beta, int* launched,
                 void* stream) {
    return launch_pair<double>(A, B, x, outs, y, S, nslot, Na, Nb, pre, mid,
                               post, m, lane_stride, beta, launched,
                               stream);
}

const char* sop_contract_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
