// Block-ELL sparse matrix times a stack of m vectors at "high" precision
// (bf16x3), on Hopper's bf16 tensor cores (sm_90a).
//
// Layout (the BSROperator's storage, shared with bsr_spmv.cu/bsr_spmm.cu):
//   hiT, loT (nrb, nbpr, B, B) bf16  the f32 blocks split into hi = bf16(a)
//                            and lo = bf16(a - hi), stored per-block
//                            TRANSPOSED: hiT[r, t, j, i] ~ H[r*B + i, idx[r, t]*B + j]
//   idx   (nrb, nbpr) int32  block-column id of each stored block
//   X     (m, ncb*B) f32     the m right-hand sides, lane-major: ncb block
//                            columns (ncb = nrb for a square operator; a
//                            rank's block rows of a row-sharded one read
//                            the whole gathered X, ncb > nrb)
//   Y     (m, nrb*B) f32     output, lane-major
// computing, with each x element split the same way (xh = bf16(x),
// xl = bf16(x - xh)),
//   Y[k, r*B + i] = sum_t sum_j xh*hi + xh*lo + xl*hi    (xl*lo dropped).
//
// bsr_spmm_split_f32 replaces the bf16x3 form of the JAX package's XLA
//   _bsr_matmat_xla (eigensolvers_tpu/ops/sparse.py:525-537), and, launched
//   with m = 1, the Pallas kernel _bsr_matvec_pallas_split (pallas_call at
//   sparse.py:479), which ran the same three bf16 passes on the TPU's matrix
//   unit with f32 accumulation (sparse.py:388-394).
//
// What bounds it: hi + lo are the f32 block bytes, read once per apply; the
// 6*m flops per element are far below the tensor cores' flop/byte balance
// for m <= 32, so an apply costs the HBM bytes of hi + lo.  On CUDA cores
// the three products cost 3*m FMAs, two conversions and 2*m shared loads
// per element, which set the pace from m = 8 on; here they are
// mma.sync.m16n8k16 (bf16 in, f32 out) and cost next to nothing.
//
// Design.  One CTA per (block-row r, 16*W output rows i, 8*NT lanes).  Each
// of its W warps owns 16 output rows: the MMA's M is i, its K is j, its N
// the lanes, 8 at a time.  The CTA walks the nbpr terms in slabs of KS rows
// j; a slab of hi and of lo is contiguous in j and i, and is streamed with
// cp.async (16 B a thread where B % 8 == 0, narrower copies otherwise)
// into a two-slot shared-memory ring: one slab is in flight while the
// other is multiplied.  Slabs of 64 rows (hi + lo: 32 KB at B = 128) keep
// the barriers per byte few and let 2-3 CTAs share an SM; deeper rings and
// thinner slabs measured slower at the slice shape.  The slab's gathered x
// values (f32, lane-major: X is already the [n][k] layout of the "col" B
// operand) travel in the same copy group, zero-filled past B and past m,
// so no thread waits on a load of its own.  The stored block is A
// (A[i, j] = hiT[j, i]) in column-major
// order, so A fragments come from ldmatrix.trans; rows of the ring are
// padded by 16 B so that its eight row addresses fall in distinct banks.
// Each warp splits its B fragments into bf16 hi/lo in registers.  One
// __syncthreads per slab.  All lanes up to 8*NT = 32 share one read of
// hi/lo; more lanes run as chunks of 32 on the grid's z axis.
//
// Rounding: each 16-deep K-step's three products are summed by the tensor
// core from zero and added to the running f32 sum with an ordinary add, so
// the tensor core's own accumulation spans 48 exact products, and the sum
// over K-steps and terms is round-to-nearest.  No TF32: the MMA inputs are
// the bf16 halves themselves.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KS = 64;       // rows j of a slab (four K-steps of 16)
constexpr int STAGES = 2;    // slabs in the shared-memory ring
constexpr int APAD = 8;      // bf16 padding of each ring row (16 B)
constexpr int XPAD = 8;      // f32 padding of each x row (32 B)

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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)) : "memory");
}

// Two f32 values -> their bf16 halves, packed as an MMA operand register
// (first value in the low 16 bits): hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(const float* v, uint32_t& hi,
                                       uint32_t& lo) {
    const float2 x = *reinterpret_cast<const float2*>(v);
    const __nv_bfloat162 h = __float22bfloat162_rn(x);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l =
        __float22bfloat162_rn(make_float2(x.x - hf.x, x.y - hf.y));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d += A (16x16, row) * B (16x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One CTA: W warps of 16 output rows, NT tiles of 8 lanes.
template <int W, int NT>
__global__ void __launch_bounds__(32 * W)
bsr_spmm_split_tc(const __nv_bfloat16* __restrict__ hiT,
                  const __nv_bfloat16* __restrict__ loT,
                  const int* __restrict__ idx, const float* __restrict__ X,
                  float* __restrict__ Y, int nbpr, int B, int m,
                  long long ldx, long long ldy, int vec, int xvec) {
    constexpr int IW = 16 * W;          // output rows i of the CTA
    constexpr int AS = IW + APAD;       // ring row stride (bf16)
    constexpr int LN = 8 * NT;          // lanes of the CTA
    constexpr int XS = KS + XPAD;       // x ring row stride (f32)
    constexpr int NTHR = 32 * W;
    constexpr int CPR = IW / 8;         // 16-byte chunks of a full ring row
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
    // [STAGES][LN][XS]: the f32 x values of each slab, lane-major
    float* xring = reinterpret_cast<float*>(ring + STAGES * 2 * KS * AS);

    const int r = blockIdx.x;
    const int ib = blockIdx.y * IW;
    const int k0 = blockIdx.z * LN;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int cols = min(IW, B - ib);
    const int nslab = (B + KS - 1) / KS;
    const int nsteps = nbpr * nslab;
    const long long row0 = (long long)r * nbpr;

    // Start the copy of slab s (term s / nslab, rows j0..j0 + rows) and
    // of its x values into ring slot s % STAGES, and commit a group (empty
    // past the end).  x past B or m is zero-filled; rows of a partial last
    // K-step are zeroed too, since stale ring data could hold an inf.
    auto issue = [&](int s) {
        if (s < nsteps) {
            const int t = s / nslab;
            const int j0 = (s - t * nslab) * KS;
            const int rows = min(KS, B - j0);
            const long long src0 = ((row0 + t) * B + j0) * (long long)B + ib;
            __nv_bfloat16* dst0 = ring + (s % STAGES) * 2 * KS * AS;
            if (vec == 8) {             // chunk c of the slab: shifts only
#pragma unroll
                for (int p = 0; p < 2 * KS * CPR / NTHR; ++p) {
                    const int c = tid + p * NTHR;
                    const int h = c / (KS * CPR);
                    const int jr = c / CPR % KS;
                    const int cc = c % CPR * 8;
                    if (jr < rows && cc < cols)
                        cp_async16(dst0 + (h * KS + jr) * AS + cc,
                                   (h ? loT : hiT) + src0
                                   + (long long)jr * B + cc);
                }
            } else {                    // narrower copies of odd shapes
                const int cpr = cols / vec;
                const int per = rows * cpr;
                for (int c = tid; c < 2 * per; c += NTHR) {
                    const int h = c >= per;
                    const int rc = c - h * per;
                    const int jr = rc / cpr;
                    const int cc = (rc - jr * cpr) * vec;
                    const __nv_bfloat16* src = (h ? loT : hiT) + src0
                                               + (long long)jr * B + cc;
                    __nv_bfloat16* dst = dst0 + (h * KS + jr) * AS + cc;
                    switch (vec) {
                        case 4: cp_async_ca<8>(dst, src); break;
                        case 2: cp_async_ca<4>(dst, src); break;
                        default: *dst = *src;
                    }
                }
            }
            const int pad = ((rows + 15) & ~15) - rows;
            for (int c = tid; c < 2 * pad * IW; c += NTHR) {
                const int h = c / (pad * IW);
                const int rc = c - h * pad * IW;
                dst0[(h * KS + rows + rc / IW) * AS + rc % IW] =
                    __float2bfloat16(0.0f);
            }
            const long long xc = (long long)idx[row0 + t] * B + j0;
            float* xdst = xring + (s % STAGES) * LN * XS;
            for (int e = tid * xvec; e < LN * KS; e += NTHR * xvec) {
                const int q = e / KS;
                const int jj = e % KS;
                const int valid = k0 + q < m
                    ? 4 * max(0, min(xvec, B - j0 - jj)) : 0;
                const float* src = valid ? X + (k0 + q) * ldx + xc + jj : X;
                if (xvec == 4)
                    cp_async_zfill<16>(xdst + q * XS + jj, src, valid);
                else
                    cp_async_zfill<4>(xdst + q * XS + jj, src, valid);
            }
        }
        cp_async_commit();
    };

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    // ldmatrix.trans row addresses of this lane for A, four 8x8 matrices
    // in fragment order: rows j of the ring, (i 0-7, j 0-7), (i 8-15,
    // j 0-7), (i 0-7, j 8-15), (i 8-15, j 8-15).  The B fragment of lane
    // (g, q) is x[lane g][j 2q, 2q + 1] and [j 2q + 8, 2q + 9], split here.
    const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * AS + warp * 16
                      + ((lane >> 3) & 1) * 8;
    const int g = lane >> 2;
    const int q = lane & 3;
    const bool busy = ib + warp * 16 < B;   // a warp past B only syncs

    for (int s = 0; s < nsteps; ++s) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();        // slab s has landed; the slot of slab
        issue(s + STAGES - 1);  // s - 1 is free for slab s + STAGES - 1
        if (busy) {
            const int t = s / nslab;
            const int ksteps = (min(KS, B - (s - t * nslab) * KS) + 15) >> 4;
            const __nv_bfloat16* a_s = ring + (s % STAGES) * 2 * KS * AS
                                       + a_off;
            const float* x_s = xring + (s % STAGES) * LN * XS + g * XS + 2 * q;
            for (int kk = 0; kk < ksteps; ++kk) {
                uint32_t ah[4], al[4];
                ldsm_x4_trans(ah, a_s + kk * 16 * AS);
                ldsm_x4_trans(al, a_s + (KS + kk * 16) * AS);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    uint32_t xh0, xl0, xh1, xl1;
                    split2(x_s + n * 8 * XS + kk * 16, xh0, xl0);
                    split2(x_s + n * 8 * XS + kk * 16 + 8, xh1, xl1);
                    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    mma_bf16(d, ah, xh0, xh1);     // hi * xh
                    mma_bf16(d, al, xh0, xh1);     // lo * xh
                    mma_bf16(d, ah, xl0, xl1);     // hi * xl
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
                }
            }
        }
    }

    // D fragment: (row g, lanes 2q, 2q + 1), (row g + 8, the same lanes)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int k = k0 + n * 8 + 2 * q + (e & 1);
            const int i = ib + warp * 16 + g + (e >> 1) * 8;
            if (k < m && i < B) Y[k * ldy + (long long)r * B + i] = acc[n][e];
        }
}

template <int W, int NT>
int launch(const void* hiT, const void* loT, const void* idx, const void* X,
           void* Y, int nrb, int ncb, int nbpr, int B, int m, int vec,
           int xvec, void* stream) {
    constexpr int IW = 16 * W;
    constexpr int LN = 8 * NT;
    const auto kernel = bsr_spmm_split_tc<W, NT>;
    const size_t bytes = (size_t)STAGES * (2 * KS * (IW + APAD) * 2
                                           + LN * (KS + XPAD) * 4);
    if (bytes > 48 * 1024) {             // above the default, ask first
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nrb, (B + IW - 1) / IW, (m + LN - 1) / LN);
    kernel<<<grid, 32 * W, bytes, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)hiT, (const __nv_bfloat16*)loT,
        (const int*)idx, (const float*)X, (float*)Y, nbpr, B, m,
        (long long)ncb * B, (long long)nrb * B, vec, xvec);
    return (int)cudaGetLastError();
}

// Lanes per CTA: 8, 16 or 32.
template <int W>
int launch_nt(const void* hiT, const void* loT, const void* idx,
              const void* X, void* Y, int nrb, int ncb, int nbpr, int B,
              int m, int vec, int xvec, void* stream) {
    if (m <= 8)
        return launch<W, 1>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m, vec,
                            xvec, stream);
    if (m <= 16)
        return launch<W, 2>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m, vec,
                            xvec, stream);
    return launch<W, 4>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m, vec,
                        xvec, stream);
}

// The widest copy (elements) that B and both base addresses allow: a slab
// row starts at a multiple of B elements from its base.
int pick_vec(const void* hiT, const void* loT, int B) {
    const uintptr_t p = (uintptr_t)hiT | (uintptr_t)loT;
    for (int v = 8; v > 1; v /= 2)
        if (B % v == 0 && p % (2 * v) == 0) return v;
    return 1;
}

// x in 16-byte copies where every x block (c*B + j0, j0 a multiple of KS)
// starts 16-byte aligned, else one f32 at a time.
int pick_xvec(const void* X, int B) {
    return B % 4 == 0 && (uintptr_t)X % 16 == 0 ? 4 : 1;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  The launch is on the given
// stream, does not synchronise, allocates nothing, and returns the CUDA
// error code of the launch (0 = cudaSuccess).  The caller checks shapes,
// types, devices and contiguity, 1 <= B <= 1024, m >= 1, every block-column
// id below ncb, and that the grid fits (nrb <= 2^31 - 1, ceil(m / 32) <=
// 65535).
extern "C" {

int bsr_spmm_split_f32(const void* hiT, const void* loT, const void* idx,
                       const void* X, void* Y, int nrb, int ncb, int nbpr,
                       int B, int m, void* stream) {
    const int vec = pick_vec(hiT, loT, B);
    const int xvec = pick_xvec(X, B);
    const int bp = (B + 15) / 16 * 16;     // B rounded up to the MMA's 16
    if (bp > 64)
        return launch_nt<8>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m, vec,
                            xvec, stream);
    if (bp > 32)
        return launch_nt<4>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m, vec,
                            xvec, stream);
    if (bp > 16)
        return launch_nt<2>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m, vec,
                            xvec, stream);
    return launch_nt<1>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m, vec,
                        xvec, stream);
}

const char* bsr_spmm_split_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
