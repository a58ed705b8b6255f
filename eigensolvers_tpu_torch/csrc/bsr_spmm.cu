// Block-ELL sparse matrix times a stack of m vectors, for Hopper (sm_90a).
//
// Layout (the BSROperator's storage, shared with bsr_spmm_split.cu):
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
//   the custom_vmap rules at :488-537), and with m = 1 the Pallas kernel
//   _bsr_matvec_pallas (:405, pallas_call :440): the package's single-vector
//   apply (ops/sparse.py::bsr_matvec) is this kernel's one-lane tile.  Its
//   "high" (bf16x3) form is bsr_spmm_split.cu, on the tensor cores.
//
// What bounds them.  Each dataT element carries 2m flops per itemsize
// bytes.  Up to m = 16 that is far below the card's balance, so an apply
// costs the HBM bytes of dataT read once (0.36 ms in f32 at the slice's
// 1.21 GB, 0.72 ms in f64), whatever m is -- provided dataT IS read once.
// At m = 32 in f32 the flops (19.3 GFLOP, 0.29 ms at 67 TFLOP/s) come close
// to the bytes (0.38 ms), and from m = 48 on they set the bound (0.43 ms at
// 48, 0.58 at 64); on the CUDA cores the FMA pipe must then run near its
// peak while HBM streams at full rate, and every shared-memory load and
// every stall at a barrier eats into that margin.  In f64 the FP64 tensor
// cores (DMMA, 67 TFLOP/s) keep the bytes the bound up to m = 64 (0.78 ms
// at 48), where the CUDA cores (34 TFLOP/s) would not.
//
// Design: two routes, one grid.  Every CTA covers one block row r, 128
// output rows i from ib and LN lanes from k0, and reads its block row's
// dataT once for those lanes.  The grid's x axis runs over block rows x
// lane chunks with the chunk fastest, so the chunks of one block row run
// side by side and a later chunk finds the blocks in L2; B > 128 runs as
// CTAs of 128 rows on its y axis.  The CTA walks the nbpr terms in slabs of
// KS rows j; a slab is contiguous in j and i and is streamed with cp.async
// (16 B a thread where B and the base allow it, narrower copies otherwise)
// into a two-slot shared-memory ring, so one slab is in flight while the
// other is multiplied.  The slab's gathered x values travel in the same
// copy group, lane-major as X stores them, zero-filled past B and past m,
// and the block column of the next slab is loaded a step ahead, so no
// thread waits on a load of its own.  Sums run in a fixed order over t and
// j in each thread or warp: no split over j, no atomics, deterministic.
//
// * CUDA cores (bsr_spmm_kernel; up to 16 lanes): each thread
//   holds a 2-D register tile of TR output rows x TL lanes, 128/TR threads
//   over i times NL groups of TL lanes.  The tile is fed from shared memory
//   in chunks of V = 16 / itemsize rows j: one wide load of TR consecutive
//   i per row j and one 16-byte load of V consecutive j per lane; a warp
//   holds all NL groups of lanes for 32/NL row groups, so its wide loads
//   are contiguous (A) or few and in distinct banks (x).  A whole slab is
//   one unrolled straight line of FMAs in the working type.
// * FP64 tensor cores (bsr_spmm_mma_kernel; from 17 lanes, f64 and f32):
//   8 warps, 4 over i (32 rows each) times 2 over the lanes (8 FN lanes
//   each), each warp a 2 x FN array of mma.sync.m16n8k4 f64 tiles with the
//   sums in registers: C is 128 rows x LN = 16 FN lanes (16, 32, 48 or 64),
//   and m lanes run as ceil(m / 64) chunks of equal width.  A is the stored
//   block as (i x j): the ring keeps it as dataT holds it, row j contiguous
//   in i.  B is the x slab (j x lanes).  The order of rows within a 16-row
//   tile is free as long as A and C agree, so the warp takes logical rows g
//   and g + 8 from i = 2g and 2g + 1: a0 a1 are then one 16-byte load, and
//   the ring's row pad (32 bytes) and the x lane pad (4 elements) put a
//   warp's fragment loads in distinct banks.  The products and the sums
//   are IEEE f64; an f32 stack is widened to f64 in registers and its sum
//   rounded to f32 at the store, which is more exact than an f32 FMA chain
//   and meets the same 1e-5.  No TF32, no bf16.
//
// Measured on an H100 SXM in tools/bench_spmm.py's turns (PERF.md): the
// tensor cores beat the CUDA-core tiles from 17 lanes up in both types
// (f64 0.88 against 1.11 ms at m = 17, 1.08 against 2.20 at 48; f32 0.45
// against 0.57 at 17, 0.78 against 1.12 at 64), and the 32-lane CUDA-core
// tile and its chunks of 32 went; up to 16 lanes the two are within the
// noise of the turns, and the CUDA-core tiles stay.  In f32 above 32
// lanes, CUDA-core tiles with one read for 48 or 64 lanes (8 x 6 and 8 x
// 8: 14 and 16 shared loads per 192 and 256 FMAs) took 0.81 and 1.05 ms at
// m = 48 and 64, the widened DMMA 0.65 and 0.89 in the same turns.
// m16n8k4 beat m16n8k8 (whose fragments spill at 64 lanes); 32 KB slabs in
// two slots beat 16 KB in three; 8 warps as 4 x 2 beat 8 x 1 and 16 warps;
// a third slot, 64 KB slabs or one CTA an SM were slower at 64 and 96
// lanes (64 KB slabs were faster at 48 f64 lanes alone, 0.97 against 1.09
// ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IB = 128;      // output rows i of a CTA
constexpr int MMA_FROM = 17;       // the fewest lanes on the tensor cores
constexpr int STAGES = 2;          // slots of the shared-memory ring
constexpr int MMA_SLAB = 32768;    // bytes of dataT a slab, tensor cores
constexpr int MMA_CTAS_PER_SM = 2; // their launch bound
constexpr int MMA_WI = 4;          // warps over i
constexpr int MMA_WL = 2;          // warps over the lanes

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

// D += A B for one 16 x 8 x 4 tile in IEEE f64, in the fragment order of
// the PTX ISA: a0 = A[g][q], a1 = A[g+8][q]; b0 = B[q][g]; d0 d1 =
// D[g][2q, 2q+1], d2 d3 = D[g+8][2q, 2q+1] (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0,
                                        double a1, double b0) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(b0));
}

// Start the copy of one slab into a ring slot: rows j0 .. j0 + rows of the
// CTA's IB columns i of term t (AS elements a row in the ring), zero rows
// from `rows` up to the next multiple of PK (stale ring data could hold an
// inf), and the slab's x values of LN lanes, lane q at q * XS + (q / XG) *
// V in the x slot, zero-filled past B and m.  Columns past B are left
// stale: they feed only rows i that are not stored.  Advances the cursor
// (t, j0) and loads the next slab's block column c if `more`.
template <typename T, int KS, int AS, int PK, int LN, int XS, int XG,
          int NTHR>
__device__ __forceinline__ void issue_slab(
        T* dst0, T* xdst, const T* __restrict__ dataT,
        const int* __restrict__ idx, const T* __restrict__ X,
        long long row0, int ib, int cols, int B, int m, int k0,
        long long ldx, int vec, int xvec, bool more, int& t_next,
        int& j_next, int& c_next, int tid) {
    constexpr int SZ = sizeof(T);
    constexpr int V = 16 / SZ;
    const int t = t_next;
    const int j0 = j_next;
    if ((j_next += KS) >= B) {
        j_next = 0;
        ++t_next;
    }
    const int rows = min(KS, B - j0);
    const T* src0 = dataT + ((row0 + t) * B + j0) * (long long)B + ib;
    if (vec == V) {             // 16-byte chunk c: row c / (IB/V)
#pragma unroll
        for (int p = 0; p < KS * IB / V / NTHR; ++p) {
            const int c = tid + p * NTHR;
            const int jr = c / (IB / V);
            const int cc = c % (IB / V) * V;
            if (jr < rows && cc < cols)
                cp_async16(dst0 + jr * AS + cc, src0 + (long long)jr * B + cc);
        }
    } else {                    // narrower copies of odd shapes
        const int cpr = cols / vec;
        for (int c = tid; c < rows * cpr; c += NTHR) {
            const int jr = c / cpr;
            const int cc = (c - jr * cpr) * vec;
            const T* src = src0 + (long long)jr * B + cc;
            T* dst = dst0 + jr * AS + cc;
            if (SZ * vec == 8)
                cp_async_ca<8>(dst, src);
            else
                cp_async_ca<SZ>(dst, src);
        }
    }
    const int pad = ((rows + PK - 1) / PK) * PK - rows;
    for (int c = tid; c < pad * IB; c += NTHR)
        dst0[(rows + c / IB) * AS + c % IB] = T(0);
    const long long xc = (long long)c_next * B + j0;
    if (more) c_next = idx[row0 + t_next];
    for (int e = tid * xvec; e < LN * KS; e += NTHR * xvec) {
        const int q = e / KS;
        const int jj = e % KS;
        const int valid = k0 + q < m
            ? SZ * max(0, min(xvec, B - j0 - jj)) : 0;
        const T* src = valid ? X + (k0 + q) * ldx + xc + jj : X;
        T* dst = xdst + q * XS + q / XG * V + jj;
        if (xvec == V)
            cp_async_zfill<16>(dst, src, valid);
        else
            cp_async_zfill<SZ>(dst, src, valid);
    }
}

// ---------------------------------------------------------------------------
// The CUDA-core route.  One CTA: NI = 128/TR threads over the output rows
// times NL groups of TL lanes; a warp holds all NL groups of lanes (tl =
// thread % NL) for 32/NL consecutive ti.  Thread (ti, tl) owns rows ib +
// g*NI*W + ti*W + e (g < TR/W, e < W: its TR rows as pieces of W = min(TR,
// V) consecutive rows, so that the pieces of a warp's wide load are
// contiguous) and lanes tl*TL + l.  The x ring holds lane k at k*KS +
// (k/TL)*V, so that the NL lanes a warp loads at once fall in distinct
// banks.  SB: the slab's bytes of dataT.
// ---------------------------------------------------------------------------
template <typename T, int TR, int TL, int NL, int SB>
__global__ void __launch_bounds__(IB / TR * NL)
bsr_spmm_kernel(const T* __restrict__ dataT, const int* __restrict__ idx,
                const T* __restrict__ X, T* __restrict__ Y, int nbpr, int B,
                int m, long long ldx, long long ldy, int vec, int xvec) {
    constexpr int V = 16 / sizeof(T);    // elements in 16 bytes
    constexpr int KS = SB / (IB * (int)sizeof(T));
    constexpr int NI = IB / TR;          // threads over i
    constexpr int NTHR = NI * NL;        // threads of the CTA
    constexpr int LN = NL * TL;          // lanes of the CTA
    constexpr int W = TR < V ? TR : V;   // rows of one wide A load
    constexpr int G = TR / W;            // wide A loads per row j
    constexpr int XSTAGE = LN * KS + NL * V;          // x ring slot
    static_assert(KS % V == 0 && KS >= V, "slab depth");
    static_assert(32 % NL == 0 && KS * IB / V % NTHR == 0, "CTA shape");
    extern __shared__ __align__(16) unsigned char smem[];
    T* ring = reinterpret_cast<T*>(smem);             // [STAGES][KS][IB]
    T* xring = ring + STAGES * KS * IB;                // [STAGES][XSTAGE]

    const int r = blockIdx.x;
    const int ib = blockIdx.y * IB;
    const int tid = threadIdx.x;
    const int tl = tid % NL;
    const int ti = tid / NL;
    const int cols = min(IB, B - ib);
    const int nslab = (B + KS - 1) / KS;
    const int nsteps = nbpr * nslab;
    const long long row0 = (long long)r * nbpr;

    int c_next = idx[row0];   // block column of the next slab, a step ahead
    int t_next = 0, j_next = 0;          // its term and first row j
    auto issue = [&](int s) {
        if (s < nsteps)
            issue_slab<T, KS, IB, V, LN, KS, TL, NTHR>(
                ring + (s % STAGES) * KS * IB, xring + (s % STAGES) * XSTAGE,
                dataT, idx, X, row0, ib, cols, B, m, 0, ldx, vec, xvec,
                s + 1 < nsteps, t_next, j_next, c_next, tid);
        cp_async_commit();
    };

    T acc[TR][TL];
#pragma unroll
    for (int e = 0; e < TR; ++e)
#pragma unroll
        for (int l = 0; l < TL; ++l) acc[e][l] = T(0);

    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    // a thread whose rows or lanes all lie past B or m only copies and syncs
    const bool busy = ti * W < cols && tl * TL < m;

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
        const int k = tl * TL + l;
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

// ---------------------------------------------------------------------------
// The tensor-core route.  MMA_WI x MMA_WL = 4 x 2 warps: warp w takes rows
// ib + wi*16*FM + [0, 16*FM) (wi = w % WI) and lanes k0 + wl*8*FN + [0,
// 8*FN) (wl = w / WI) as FM x FN tiles of 16 x 8 (FM = 2, FN = LN / 16);
// logical row g (g + 8) of a tile is its row 2g (2g + 1),
// and logical k q of a k-step is row j = kk + q.  T is the stored type;
// the products and sums are f64.  The ring's rows are 128 elements and 32
// bytes long and the x lanes KS + 4 elements, so that the four rows j (the
// 4 or 8 lanes) that one phase of a warp's fragment loads reads fall in
// distinct banks.
// ---------------------------------------------------------------------------
template <typename T, int LN, int KS>
__global__ void __launch_bounds__(32 * MMA_WI * MMA_WL, MMA_CTAS_PER_SM)
bsr_spmm_mma_kernel(const T* __restrict__ dataT, const int* __restrict__ idx,
                    const T* __restrict__ X, T* __restrict__ Y, int nbpr,
                    int B, int m, int nchunk, long long ldx, long long ldy,
                    int vec, int xvec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int WI = MMA_WI, WL = MMA_WL;
    constexpr int FM = IB / 16 / WI, FN = LN / 8 / WL;
    static_assert(FN * 8 * WL == LN, "lanes");
    constexpr int NTHR = 32 * WI * WL;
    constexpr int AS = IB + 32 / sizeof(T);
    constexpr int XS = KS + 4;
    constexpr int ASTAGE = KS * AS;
    constexpr int XSTAGE = LN * XS;
    static_assert(16 * FM * WI == IB && KS % 4 == 0 && KS % V == 0,
                  "tile shape");
    static_assert(KS * IB / V % NTHR == 0, "CTA shape");
    extern __shared__ __align__(16) unsigned char smem[];
    T* ring = reinterpret_cast<T*>(smem);             // [STAGES][KS][AS]
    T* xring = ring + STAGES * ASTAGE;                 // [STAGES][LN][XS]

    const int r = blockIdx.x / nchunk;
    const int k0 = (blockIdx.x - r * nchunk) * LN;
    const int ib = blockIdx.y * IB;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int q = lane % 4;
    const int wi = tid / 32 % WI;
    const int wl = tid / 32 / WI;
    const int cols = min(IB, B - ib);
    const int nslab = (B + KS - 1) / KS;
    const int nsteps = nbpr * nslab;
    const long long row0 = (long long)r * nbpr;

    int c_next = idx[row0];
    int t_next = 0, j_next = 0;
    auto issue = [&](int s) {
        if (s < nsteps)
            issue_slab<T, KS, AS, 4, LN, XS, LN, NTHR>(
                ring + (s % STAGES) * ASTAGE, xring + (s % STAGES) * XSTAGE,
                dataT, idx, X, row0, ib, cols, B, m, k0, ldx, vec, xvec,
                s + 1 < nsteps, t_next, j_next, c_next, tid);
        cp_async_commit();
    };

    double acc[FM][FN][4];
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[fm][fn][e] = 0.0;

    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    // a warp whose rows or lanes all lie past B or m only copies and syncs
    const bool busy = wi * 16 * FM < cols && k0 + wl * 8 * FN < m;

    int j_cur = 0;
    for (int s = 0; s < nsteps; ++s) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        issue(s + STAGES - 1);
        if (busy) {
            const T* a_s = ring + (s % STAGES) * ASTAGE + q * AS
                           + wi * 16 * FM + 2 * g;
            const T* x_s = xring + (s % STAGES) * XSTAGE
                           + (wl * 8 * FN + g) * XS + q;
            // rows kk .. kk + 3 of the slab into the tiles
            auto step = [&](int kk) {
                Vec<T, 2> a[FM];
                T b[FN];
#pragma unroll
                for (int fm = 0; fm < FM; ++fm)
                    a[fm] = *reinterpret_cast<const Vec<T, 2>*>(
                        a_s + kk * AS + fm * 16);
#pragma unroll
                for (int fn = 0; fn < FN; ++fn) b[fn] = x_s[fn * 8 * XS + kk];
#pragma unroll
                for (int fm = 0; fm < FM; ++fm)
#pragma unroll
                    for (int fn = 0; fn < FN; ++fn)
                        mma_f64(acc[fm][fn], a[fm].v[0], a[fm].v[1], b[fn]);
            };
            if (B - j_cur >= KS) {      // a whole slab
#pragma unroll
                for (int kk = 0; kk < KS; kk += 4) step(kk);
            } else {
                const int nk = (B - j_cur + 3) / 4;
#pragma unroll 1
                for (int s2 = 0; s2 < nk; ++s2) step(s2 * 4);
            }
        }
        if ((j_cur += KS) >= B) j_cur = 0;
    }

    if (!busy) return;
    // d0 d1 (d2 d3): rows i (i + 1) of lanes 2q, 2q + 1; both rows as one
    // store where B is even (then i + 1 < B with i, and Y is aligned)
    const bool wide = B % 2 == 0;
#pragma unroll
    for (int fm = 0; fm < FM; ++fm) {
        const int i = ib + wi * 16 * FM + fm * 16 + 2 * g;
        if (i >= B) continue;
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int k = k0 + wl * 8 * FN + fn * 8 + 2 * q + e;
                if (k >= m) continue;
                T* y = Y + k * ldy + (long long)r * B + i;
                if (wide) {
                    Vec<T, 2> o;
                    o.v[0] = T(acc[fm][fn][e]);
                    o.v[1] = T(acc[fm][fn][2 + e]);
                    *reinterpret_cast<Vec<T, 2>*>(y) = o;
                } else {
                    y[0] = T(acc[fm][fn][e]);
                    if (i + 1 < B) y[1] = T(acc[fm][fn][2 + e]);
                }
            }
    }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;    // above the default, ask first
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int TR, int TL, int NL, int SB>
int launch_tile(const void* dataT, const void* idx, const void* X, void* Y,
                int nrb, int ncb, int nbpr, int B, int m, int vec,
                int xvec, void* stream) {
    constexpr int KS = SB / (IB * (int)sizeof(T));
    constexpr int LN = NL * TL;
    const auto kernel = bsr_spmm_kernel<T, TR, TL, NL, SB>;
    const size_t bytes = (size_t)STAGES
        * (KS * IB + LN * KS + NL * (16 / sizeof(T))) * sizeof(T);
    const int e = allow_smem(kernel, bytes);
    if (e != 0) return e;
    const dim3 grid(nrb, (B + IB - 1) / IB);
    kernel<<<grid, IB / TR * NL, bytes, (cudaStream_t)stream>>>(
        (const T*)dataT, (const int*)idx, (const T*)X, (T*)Y, nbpr, B, m,
        (long long)ncb * B, (long long)nrb * B, vec, xvec);
    return (int)cudaGetLastError();
}

template <typename T, int LN>
int launch_mma(const void* dataT, const void* idx, const void* X, void* Y,
               int nrb, int ncb, int nbpr, int B, int m, int vec, int xvec,
               void* stream) {
    constexpr int KS = MMA_SLAB / (IB * (int)sizeof(T));
    constexpr int AS = IB + 32 / sizeof(T);
    constexpr int XS = KS + 4;
    const auto kernel = bsr_spmm_mma_kernel<T, LN, KS>;
    const size_t bytes = (size_t)STAGES * (KS * AS + LN * XS) * sizeof(T);
    // ceil(m / LN) chunks of each block row on the grid's x axis, the
    // chunk fastest
    const long long nchunk = (m + LN - 1) / LN;
    if (nchunk * nrb > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    const int e = allow_smem(kernel, bytes);
    if (e != 0) return e;
    const dim3 grid((unsigned)(nchunk * nrb), (B + IB - 1) / IB);
    kernel<<<grid, 32 * MMA_WI * MMA_WL, bytes, (cudaStream_t)stream>>>(
        (const T*)dataT, (const int*)idx, (const T*)X, (T*)Y, nbpr, B, m,
        (int)nchunk, (long long)ncb * B, (long long)nrb * B, vec, xvec);
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

// The route and tile for m lanes.  Tensor cores from MMA_FROM lanes on:
// the m lanes in ceil(m / 64) chunks of equal width, each CTA 16, 32, 48
// or 64 lanes, the smallest that holds a chunk.  CUDA cores below: TR rows
// x TL lanes a thread in NL groups of lanes, LN = NL * TL lanes a CTA, the
// smallest LN that holds them, and 32 KB slabs.
template <typename T>
int launch(const void* dataT, const void* idx, const void* X, void* Y,
           int nrb, int ncb, int nbpr, int B, int m, void* stream) {
    static_assert(MMA_FROM <= 17, "the CUDA-core tiles hold 16 lanes");
    const int vec = pick_vec<T>(dataT, B);
    const int xvec = B % (16 / sizeof(T)) == 0 && (uintptr_t)X % 16 == 0
                     ? 16 / sizeof(T) : 1;
    if (m >= MMA_FROM) {
        const int nchunk = (m + 63) / 64;
        switch (((m + nchunk - 1) / nchunk + 15) / 16) {
            case 1:
                return launch_mma<T, 16>(dataT, idx, X, Y, nrb, ncb, nbpr, B,
                                        m, vec, xvec, stream);
            case 2:
                return launch_mma<T, 32>(dataT, idx, X, Y, nrb, ncb, nbpr, B,
                                        m, vec, xvec, stream);
            case 3:
                return launch_mma<T, 48>(dataT, idx, X, Y, nrb, ncb, nbpr, B,
                                        m, vec, xvec, stream);
            default:
                return launch_mma<T, 64>(dataT, idx, X, Y, nrb, ncb, nbpr, B,
                                        m, vec, xvec, stream);
        }
    }
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
    return launch_tile<T, 4, 4, 4, 32768>(dataT, idx, X, Y, nrb, ncb, nbpr,
                                          B, m, vec, xvec, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches ONE kernel on the
// given stream, does not synchronise, allocates nothing, and returns the
// CUDA error code of the launch (0 = cudaSuccess).  The caller checks
// shapes, types, devices and contiguity, 1 <= B <= 1024, m >= 1, every
// block-column id below ncb, and that the grid fits (nrb * ceil(m / 64) <=
// 2^31 - 1; the launch refuses a larger one), and passes a 16-byte aligned
// Y.
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
