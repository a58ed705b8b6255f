// Block-ELL sparse matrix times a stack of m vectors, for Hopper (sm_90a).
//
// Layout (the BSROperator's storage, shared with bsr_spmv.cu):
//   dataT (nrb, nbpr, B, B)  blocks stored per-block TRANSPOSED:
//                            dataT[r, t, j, i] = H[r*B + i, idx[r, t]*B + j]
//   idx   (nrb, nbpr) int32  block-column id of each stored block
//   X     (m, ncb*B)         the m right-hand sides, lane-major (one row per
//                            vector), each zero-padded to whole blocks: ncb
//                            block columns (ncb = nrb for a square operator;
//                            a rank's block rows of a row-sharded operator
//                            read the whole gathered X, ncb > nrb)
//   Y     (m, nrb*B)         output, lane-major
// computing  Y[k, r*B + i] = sum_t sum_j dataT[r, t, j, i] * X[k, idx[r, t]*B + j].
//
// bsr_spmm_{f32,f64}  replace eigensolvers_tpu/ops/sparse.py::_bsr_matmat_xla
//   (XLA gather + einsum, :294; every vmapped BSR matvec reaches it through
//   the custom_vmap rules at :488-537).  Its "high" (bf16x3) form is
//   bsr_spmm_split.cu, on the tensor cores.
//
// What bounds them.  Each dataT element carries 2m flops per itemsize
// bytes.  Up to m = 16 that is far below the card's balance, so an apply
// costs the HBM bytes of dataT read once (0.36 ms in f32 at the slice's
// 1.21 GB, 0.72 ms in f64), whatever m is -- provided dataT IS read once.
// At m = 32 in f32 the FMAs (19.3 GFLOP, 0.29 ms at 67 TFLOP/s) come close
// to the bytes (0.38 ms): the FMA pipe must run at ~3/4 of its peak while
// HBM streams at full rate, and every shared-memory load and every stall
// at a barrier eats into that margin.  f64 at m = 32 stands the same (0.57
// ms of FMAs on the CUDA cores against 0.76 ms of bytes).  On an H100 SXM
// the kernel reaches its byte bound most closely up to m = 16 and least at
// m = 32, where the FMAs set the pace (times in PERF.md).
//
// Design.  One CTA per (block-row r, 128 output rows i from ib, LN = NL*TL
// lanes from k0), with 128/TR threads over i times NL groups of TL lanes:
// each thread holds a 2-D register tile of TR output rows x TL lanes.  All
// LN lanes share one read of dataT, so up to 32 lanes (TR = 4, TL = 8,
// NL = 4) cost one read of the blocks; more lanes run as chunks of 32 on
// the grid's z axis, B > 128 as CTAs of 128 rows on its y axis.  The CTA
// walks the nbpr terms in slabs of KS rows j (SB bytes of dataT, 16-32 KB);
// a slab is contiguous in j and i and is streamed with cp.async (16 B a
// thread where B and the base allow it, narrower copies otherwise) into a
// two-slot shared-memory ring, so one slab is in flight while the other is
// multiplied.  The slab's gathered x values travel in the same copy group,
// lane-major as X stores them, zero-filled past B and past m, and the
// block column of the next slab is loaded a step ahead, so no thread waits
// on a load of its own.  The tile is fed from shared memory in chunks of
// V = 16 / itemsize rows j: one wide load of TR consecutive i per row j
// and one 16-byte load of V consecutive j per lane; a warp holds all NL
// groups of lanes for 32/NL row groups, so its wide loads are contiguous
// (A) or few and in distinct banks (x).  At TR = 4, TL = 8 in f32 that is
// 12 shared loads per 128 FMAs, where a 1-D tile of 32 lanes needs 8 + 1
// per 32.  A whole slab is one unrolled straight line of FMAs, which the
// compiler schedules against the next chunk's loads (the largest gain at
// m = 32); deeper rings, larger slabs and wider tiles (8 x 8) were slower
// or even in f32 (PERF.md).  The tile and slab come from m (launch).
// Sums are FMA chains in the working type, in the order t, j: no TF32, no
// tensor cores, no atomics, deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IB = 128;               // output rows i of a CTA
constexpr int STAGES = 2;             // slabs in the shared-memory ring

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

// N elements of T loaded or stored as one access of N * sizeof(T) bytes.
template <typename T, int N>
struct alignas(N * sizeof(T)) Vec {
    T v[N];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES) : "memory");
}

// Copy BYTES of which the first `valid` are read from src; the rest of
// the destination is filled with zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES), "r"(valid)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A slab of SB bytes of dataT: KS rows j of the CTA's IB columns i.
template <typename T, int SB>
struct Slab {
    static constexpr int V = 16 / sizeof(T);     // elements in 16 bytes
    static constexpr int KS = SB / (IB * (int)sizeof(T));
    static_assert(KS % V == 0 && KS >= V, "slab depth");
};

// One CTA: NI = 128/TR threads over the output rows times NL groups of TL
// lanes; a warp holds all NL groups of lanes (tl = thread % NL) for 32/NL
// consecutive ti.  Thread (ti, tl) owns rows ib + g*NI*W + ti*W + e (g <
// TR/W, e < W: its TR rows as pieces of W = min(TR, V) consecutive rows,
// so that the pieces of a warp's wide load are contiguous) and lanes
// k0 + tl*TL + l.  The x ring holds lane k at k*KS + (k/TL)*V, so that
// the NL lanes a warp loads at once fall in distinct banks.
template <typename T, int TR, int TL, int NL, int SB>
__global__ void __launch_bounds__(IB / TR * NL)
bsr_spmm_kernel(const T* __restrict__ dataT, const int* __restrict__ idx,
                const T* __restrict__ X, T* __restrict__ Y, int nbpr, int B,
                int m, long long ldx, long long ldy, int vec, int xvec) {
    constexpr int SZ = sizeof(T);
    constexpr int V = Slab<T, SB>::V;
    constexpr int KS = Slab<T, SB>::KS;
    constexpr int NI = IB / TR;          // threads over i
    constexpr int NTHR = NI * NL;        // threads of the CTA
    constexpr int LN = NL * TL;          // lanes of the CTA
    constexpr int W = TR < V ? TR : V;   // rows of one wide A load
    constexpr int G = TR / W;            // wide A loads per row j
    constexpr int XSTAGE = LN * KS + NL * V;          // x ring slot
    static_assert(32 % NL == 0 && KS * IB / V % NTHR == 0, "CTA shape");
    extern __shared__ __align__(16) unsigned char smem[];
    T* ring = reinterpret_cast<T*>(smem);             // [STAGES][KS][IB]
    T* xring = ring + STAGES * KS * IB;                // [STAGES][XSTAGE]

    const int r = blockIdx.x;
    const int ib = blockIdx.y * IB;
    const int k0 = blockIdx.z * LN;
    const int tid = threadIdx.x;
    const int tl = tid % NL;
    const int ti = tid / NL;
    const int cols = min(IB, B - ib);
    const int nslab = (B + KS - 1) / KS;
    const int nsteps = nbpr * nslab;
    const long long row0 = (long long)r * nbpr;

    // Start the copy of slab s (term s / nslab, rows j0..j0 + rows) and of
    // its x values into ring slot s % STAGES, and commit a group (empty
    // past the end).  x past B or m is zero-filled; the rows past B of a
    // partial last chunk of V are zeroed too, since stale ring data could
    // hold an inf.  Columns past B are left stale: they feed only rows i
    // that are not stored.
    int c_next = idx[row0];   // block column of the next slab, a step ahead
    int t_next = 0, j_next = 0;          // its term and first row j
    auto issue = [&](int s) {
        if (s < nsteps) {
            const int t = t_next;
            const int j0 = j_next;
            if ((j_next += KS) >= B) {
                j_next = 0;
                ++t_next;
            }
            const int rows = min(KS, B - j0);
            const T* src0 = dataT + ((row0 + t) * B + j0) * (long long)B + ib;
            T* dst0 = ring + (s % STAGES) * KS * IB;
            if (vec == V) {             // 16-byte chunk c: row c / (IB/V)
#pragma unroll
                for (int p = 0; p < KS * IB / V / NTHR; ++p) {
                    const int c = tid + p * NTHR;
                    const int jr = c / (IB / V);
                    const int cc = c % (IB / V) * V;
                    if (jr < rows && cc < cols)
                        cp_async16(dst0 + jr * IB + cc,
                                   src0 + (long long)jr * B + cc);
                }
            } else {                    // narrower copies of odd shapes
                const int cpr = cols / vec;
                for (int c = tid; c < rows * cpr; c += NTHR) {
                    const int jr = c / cpr;
                    const int cc = (c - jr * cpr) * vec;
                    const T* src = src0 + (long long)jr * B + cc;
                    T* dst = dst0 + jr * IB + cc;
                    if (SZ * vec == 8)
                        cp_async_ca<8>(dst, src);
                    else
                        cp_async_ca<SZ>(dst, src);
                }
            }
            const int pad = ((rows + V - 1) / V) * V - rows;
            for (int c = tid; c < pad * IB; c += NTHR)
                dst0[(rows + c / IB) * IB + c % IB] = T(0);
            const long long xc = (long long)c_next * B + j0;
            if (s + 1 < nsteps) c_next = idx[row0 + t_next];
            T* xdst = xring + (s % STAGES) * XSTAGE;
            for (int e = tid * xvec; e < LN * KS; e += NTHR * xvec) {
                const int q = e / KS;
                const int jj = e % KS;
                const int valid = k0 + q < m
                    ? SZ * max(0, min(xvec, B - j0 - jj)) : 0;
                const T* src = valid ? X + (k0 + q) * ldx + xc + jj : X;
                T* dst = xdst + e + q / TL * V;
                if (xvec == V)
                    cp_async_zfill<16>(dst, src, valid);
                else
                    cp_async_zfill<SZ>(dst, src, valid);
            }
        }
        cp_async_commit();
    };

    T acc[TR][TL];
#pragma unroll
    for (int e = 0; e < TR; ++e)
#pragma unroll
        for (int l = 0; l < TL; ++l) acc[e][l] = T(0);

    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    // a thread whose rows or lanes all lie past B or m only copies and syncs
    const bool busy = ti * W < cols && k0 + tl * TL < m;

    int j_cur = 0;                       // first row j of slab s
    for (int s = 0; s < nsteps; ++s) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();        // slab s has landed; the slot of slab
        issue(s + STAGES - 1);  // s - 1 is free for slab s + STAGES - 1
        if (busy) {
            const T* a_s = ring + (s % STAGES) * KS * IB + ti * W;
            const T* x_s = xring + (s % STAGES) * XSTAGE + tl * (TL * KS + V);
            // rows j0 + ch*V .. + V - 1 of the slab into the tile
            auto mult = [&](int ch) {
                Vec<T, W> a[V][G];
#pragma unroll
                for (int jj = 0; jj < V; ++jj)
#pragma unroll
                    for (int g = 0; g < G; ++g)
                        a[jj][g] = *reinterpret_cast<const Vec<T, W>*>(
                            a_s + (ch * V + jj) * IB + g * NI * W);
#pragma unroll
                for (int l = 0; l < TL; ++l) {
                    const Vec<T, V> x = *reinterpret_cast<const Vec<T, V>*>(
                        x_s + l * KS + ch * V);
#pragma unroll
                    for (int jj = 0; jj < V; ++jj)
#pragma unroll
                        for (int g = 0; g < G; ++g)
#pragma unroll
                            for (int e = 0; e < W; ++e)
                                acc[g * W + e][l] = fma_t(
                                    a[jj][g].v[e], x.v[jj], acc[g * W + e][l]);
                }
            };
            if (B - j_cur >= KS) {      // a whole slab: one straight line
#pragma unroll
                for (int ch = 0; ch < KS / V; ++ch) mult(ch);
            } else {
                const int nch = (B - j_cur + V - 1) / V;
#pragma unroll 1
                for (int ch = 0; ch < nch; ++ch) mult(ch);
            }
        }
        if ((j_cur += KS) >= B) j_cur = 0;
    }

    if (!busy) return;
    // pieces of W rows as one store where each is all in or all past B (Y
    // is 16-byte aligned, and so is every piece then)
    const bool wide = B % W == 0;
#pragma unroll
    for (int l = 0; l < TL; ++l) {
        const int k = k0 + tl * TL + l;
        if (k >= m) break;
        T* y = Y + k * ldy + (long long)r * B;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int i = ib + g * NI * W + ti * W;
            if (wide) {
                if (i < B) {
                    Vec<T, W> o;
#pragma unroll
                    for (int e = 0; e < W; ++e) o.v[e] = acc[g * W + e][l];
                    *reinterpret_cast<Vec<T, W>*>(y + i) = o;
                }
            } else {
#pragma unroll
                for (int e = 0; e < W; ++e)
                    if (i + e < B) y[i + e] = acc[g * W + e][l];
            }
        }
    }
}

template <typename T, int TR, int TL, int NL, int SB>
int launch_tile(const void* dataT, const void* idx, const void* X, void* Y,
                int nrb, int ncb, int nbpr, int B, int m, int vec,
                int xvec, void* stream) {
    constexpr int KS = Slab<T, SB>::KS;
    constexpr int LN = NL * TL;
    const auto kernel = bsr_spmm_kernel<T, TR, TL, NL, SB>;
    const size_t bytes =
        (size_t)STAGES * (KS * IB + LN * KS + NL * Slab<T, SB>::V) * sizeof(T);
    if (bytes > 48 * 1024) {             // above the default, ask first
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nrb, (B + IB - 1) / IB, (m + LN - 1) / LN);
    kernel<<<grid, IB / TR * NL, bytes, (cudaStream_t)stream>>>(
        (const T*)dataT, (const int*)idx, (const T*)X, (T*)Y, nbpr, B, m,
        (long long)ncb * B, (long long)nrb * B, vec, xvec);
    return (int)cudaGetLastError();
}

// The widest copy (elements, at most 16 bytes) that B and the base address
// allow: a slab row starts a multiple of B elements past the base.
template <typename T>
int pick_vec(const void* p, int B) {
    for (int v = 16 / sizeof(T); v > 1; v /= 2)
        if (B % v == 0 && (uintptr_t)p % (v * sizeof(T)) == 0) return v;
    return 1;
}

// The tile for m lanes: TR rows x TL lanes a thread in NL groups of lanes,
// LN = NL * TL lanes a CTA, the smallest LN that holds them up to 32 (more
// lanes run as chunks of 32); and the slab bytes SB, 32 KB but for the
// 32-lane tile, which measured faster with 16 KB.
template <typename T>
int launch(const void* dataT, const void* idx, const void* X, void* Y,
           int nrb, int ncb, int nbpr, int B, int m, void* stream) {
    const int vec = pick_vec<T>(dataT, B);
    const int xvec = B % (16 / sizeof(T)) == 0 && (uintptr_t)X % 16 == 0
                     ? 16 / sizeof(T) : 1;
    if (m <= 1)
        return launch_tile<T, 1, 1, 1, 32768>(dataT, idx, X, Y, nrb, ncb,
                                              nbpr, B, m, vec, xvec, stream);
    if (m <= 2)
        return launch_tile<T, 2, 1, 2, 32768>(dataT, idx, X, Y, nrb, ncb,
                                              nbpr, B, m, vec, xvec, stream);
    if (m <= 4)
        return launch_tile<T, 4, 1, 4, 32768>(dataT, idx, X, Y, nrb, ncb,
                                              nbpr, B, m, vec, xvec, stream);
    if (m <= 8)
        return launch_tile<T, 4, 2, 4, 32768>(dataT, idx, X, Y, nrb, ncb,
                                              nbpr, B, m, vec, xvec, stream);
    if (m <= 16)
        return launch_tile<T, 4, 4, 4, 32768>(dataT, idx, X, Y, nrb, ncb,
                                              nbpr, B, m, vec, xvec, stream);
    return launch_tile<T, 4, 8, 4, 16384>(dataT, idx, X, Y, nrb, ncb, nbpr,
                                          B, m, vec, xvec, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches ONE kernel on the
// given stream, does not synchronise, allocates nothing, and returns the
// CUDA error code of the launch (0 = cudaSuccess).  The caller checks
// shapes, types, devices and contiguity, 1 <= B <= 1024, m >= 1, every
// block-column id below ncb, and that the grid fits (nrb <= 2^31 - 1,
// ceil(m / 32) <= 65535), and passes a 16-byte aligned Y.
extern "C" {

int bsr_spmm_f32(const void* dataT, const void* idx, const void* X, void* Y,
                 int nrb, int ncb, int nbpr, int B, int m, void* stream) {
    return launch<float>(dataT, idx, X, Y, nrb, ncb, nbpr, B, m, stream);
}

int bsr_spmm_f64(const void* dataT, const void* idx, const void* X, void* Y,
                 int nrb, int ncb, int nbpr, int B, int m, void* stream) {
    return launch<double>(dataT, idx, X, Y, nrb, ncb, nbpr, B, m, stream);
}

const char* bsr_spmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
