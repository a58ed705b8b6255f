// Block-ELL sparse matrix times a stack of m vectors at "high" precision
// (bf16x3), on Hopper's bf16 tensor cores (sm_90a).
//
// Layout (the BSROperator's storage, shared with bsr_spmm.cu):
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
//   _bsr_matmat_xla (eigensolvers_tpu/ops/sparse.py:295, reached at HIGH
//   through _bsr_matvec_best_split's vmap rule, :525-537), and, launched
//   with m = 1, the Pallas kernel _bsr_matvec_pallas_split (pallas_call at
//   sparse.py:479), which ran the same three bf16 passes on the TPU's matrix
//   unit with f32 accumulation (sparse.py:388-394).
//
// What bounds it: hi + lo are the f32 block bytes, read once per apply, and
// carry 6*m bf16 flops per 4 bytes: 96 flops a byte at m = 64, a third of
// the H100's ~295 bf16 flops per byte of HBM, and 192 at m = 128.  So an
// apply costs the HBM bytes of ONE read of hi + lo at every m the solvers
// use -- provided the blocks are read once, whatever m is, and the tensor
// cores are fed without the CUDA cores or shared memory in the way.  The
// gathered x values are the other stream: each block row reads its nbpr
// x blocks for all m lanes, nbpr * n * m * 4 bytes an apply from L2 (as
// many as hi + lo at the slice's m = 128).  In tools/bench_spmm.py's turns
// on the H100 the blocks and the gathers together moved at most ~3.3 TB/s
// (32 to 64 lanes), so above 64 lanes that traffic, not the block bytes
// alone, sets the pace.
//
// Two routes, one grid: one CTA per (block-row r, lane chunk, rows i of
// the CTA), the grid's x axis running over block rows x lane chunks with
// the chunk fastest, so the chunks of one block row run side by side and a
// later chunk finds the blocks in L2.  Each CTA walks the nbpr terms in
// slabs of KS rows j; a slab of hi and of lo is contiguous in j and i and
// is streamed with cp.async into a shared-memory ring while an earlier
// slab is multiplied.  x is split into bf16 hi/lo once per CTA and slab,
// never once per warp, and zero-filled past B and past m.
//
// * mma.sync (bsr_spmm_split_tc; up to 32 lanes, and every m on shapes the
//   wgmma route does not take): W warps of 16 output rows i, each holding
//   all the CTA's lanes as NT tiles of 8 (mma.sync.m16n8k16: M is i, K is
//   j, N the lanes; up to 8*MAX_NT = 64 lanes a CTA, chunks of equal width
//   beyond).  Slabs of 64 rows in a two-slot ring (16 B a thread where B %
//   8 == 0, narrower copies otherwise); the stored block is A (A[i, j] =
//   hiT[j, i]) in column-major order, so A fragments come from
//   ldmatrix.trans, rows of the ring padded by 16 B so that its eight row
//   addresses fall in distinct banks.  The threads load the next slab's x
//   values into registers while the warps multiply the current slab, then
//   split them and store both halves lane-major ([lane][j], the "col"
//   layout of B) into a two-slot x ring; the B fragments of two 8-lane
//   tiles are then one ldmatrix.x4 for each half.  One __syncthreads a slab.
// * wgmma (bsr_spmm_split_wg; WG_FROM lanes on, where B % 8 == 0, B > 64
//   and blocks and x are 16-byte aligned): two warpgroups of 64 rows i,
//   up to WG_MAX = 128 lanes a CTA, the three products of a K-step three
//   asynchronous m64nNk16 wgmma from 128-byte-swizzled shared memory (see
//   its comment).  Up to 64 lanes two CTAs share an SM; wider, one CTA an
//   SM keeps two slabs in flight.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, in tools/bench_spmm.py's
// turns (PERF.md): mma.sync tiles of 48 and 64 lanes (one read) took 0.57
// and 0.66 ms at m = 48 and 64 at best (128 registers, two CTAs an SM),
// the wgmma route 0.52 and 0.58; wgmma without swizzle (core matrices in
// 128 contiguous bytes) took 0.72 and 0.77.  Above 64 lanes four
// warpgroups of 64 lanes, and chunks of 64 lanes, lost to two warpgroups
// of all 128 lanes (0.84 and 0.90 against 0.83 ms at m = 96).
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

constexpr int MAX_NT = 8;    // 8-lane tiles of a CTA: lanes of one read / 8
constexpr int APAD = 8;      // bf16 padding of each ring row (16 B)
constexpr int WG_FROM = 33;  // lanes from which the wgmma route runs
constexpr int WG_MAX = 128;  // lanes of one CTA on the wgmma route

// Rows j of a slab: four K-steps of 16, fewer where a block has fewer
// rows (W warps cover B <= 16 W), so a thread's share of the x slab stays
// small.
__host__ __device__ constexpr int slab_rows(int W) {
    return W >= 4 ? 64 : 16 * W;
}

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

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy BYTES of which the first `valid` are read from src; the rest of
// the destination is filled with zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES), "r"(valid)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Four f32 values -> their bf16 halves, packed in order (first value in
// the low 16 bits): hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split4(float4 v, uint2& hi, uint2& lo) {
    const __nv_bfloat162 h0 = __float22bfloat162_rn(make_float2(v.x, v.y));
    const __nv_bfloat162 h1 = __float22bfloat162_rn(make_float2(v.z, v.w));
    const float2 f0 = __bfloat1622float2(h0);
    const float2 f1 = __bfloat1622float2(h1);
    hi = make_uint2(bits(h0), bits(h1));
    lo = make_uint2(
        bits(__float22bfloat162_rn(make_float2(v.x - f0.x, v.y - f0.y))),
        bits(__float22bfloat162_rn(make_float2(v.z - f1.x, v.w - f1.y))));
}

// d += A (16x16, row) * B (16x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving accesses of v across this point (the
// registers of an asynchronous wgmma).
__device__ __forceinline__ void reg_fence(float& v) {
    asm volatile("" : "+f"(v) :: "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (LBO, SBO), layout type 1.
// Its atoms (8 rows of 128 bytes, the 16-byte chunk c of row r stored at
// c ^ r) start 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
           | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
           | (uint64_t)1 << 62;
}

// D (64 x N, f32, N / 2 registers a thread) = A (64 x 16) * B (16 x N)
// (+ D unless scale_d is 0), A and B bf16 from shared memory through
// descriptors: A M-major (transposed), B K-major.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
    static_assert(N == 48 || N == 64 || N == 96 || N == 128, "shape");
    if constexpr (N == 48) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %26, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23"
            "}, %24, %25, p, 1, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
              "+f"(d[22]), "+f"(d[23])
            : "l"(a), "l"(b), "r"(scale_d));
    } else if constexpr (N == 64) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
              "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
              "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(a), "l"(b), "r"(scale_d));
    } else if constexpr (N == 96) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %50, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47"
            "}, %48, %49, p, 1, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
              "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
              "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
              "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
              "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
              "+f"(d[46]), "+f"(d[47])
            : "l"(a), "l"(b), "r"(scale_d));
    } else if constexpr (N == 128) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
              "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
              "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
              "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
              "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
              "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
              "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
              "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(scale_d));
    }
}

// One CTA: W warps of 16 output rows, NT tiles of 8 lanes.
template <int W, int NT>
__global__ void __launch_bounds__(32 * W, 2)
bsr_spmm_split_tc(const __nv_bfloat16* __restrict__ hiT,
                  const __nv_bfloat16* __restrict__ loT,
                  const int* __restrict__ idx, const float* __restrict__ X,
                  float* __restrict__ Y, int nbpr, int B, int m, int nchunk,
                  long long ldx, long long ldy, int vec, int xvec) {
    constexpr int IW = 16 * W;          // output rows i of the CTA
    constexpr int KS = slab_rows(W);    // rows j of a slab
    constexpr int AS = IW + APAD;       // block ring row stride (bf16)
    constexpr int LN = 8 * NT;          // lanes of the CTA
    constexpr int XS = KS + APAD;       // x ring row stride (bf16)
    constexpr int NTHR = 32 * W;
    constexpr int CPR = IW / 8;         // 16-byte chunks of a full ring row
    constexpr int XG = LN * KS / 4;     // groups of 4 x values in a slab
    constexpr int XP = (XG + NTHR - 1) / NTHR;   // ... a thread's share
    extern __shared__ __align__(16) unsigned char smem[];
    // [2][hi, lo][KS][AS]: the slabs of the blocks
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
    // [2][hi, lo][LN][XS]: the split x values of each slab, lane-major
    __nv_bfloat16* xring = ring + 2 * 2 * KS * AS;

    const int r = blockIdx.x / nchunk;
    const int k0 = (blockIdx.x - r * nchunk) * LN;
    const int ib = blockIdx.y * IW;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int cols = min(IW, B - ib);
    const int nslab = (B + KS - 1) / KS;
    const int nsteps = nbpr * nslab;
    const long long row0 = (long long)r * nbpr;

    // Start the copy of slab s's blocks (term s / nslab, rows j0..j0 +
    // rows) into ring slot s & 1 and commit it.  Rows of a partial last
    // K-step are zeroed, since stale ring data could hold an inf.
    auto issue = [&](int s) {
        const int t = s / nslab;
        const int j0 = (s - t * nslab) * KS;
        const int rows = min(KS, B - j0);
        const long long src0 = ((row0 + t) * B + j0) * (long long)B + ib;
        __nv_bfloat16* dst0 = ring + (s & 1) * 2 * KS * AS;
        if (vec == 8) {                 // chunk c of the slab: shifts only
#pragma unroll
            for (int p = 0; p < 2 * KS * CPR / NTHR; ++p) {
                const int c = tid + p * NTHR;
                const int h = c / (KS * CPR);
                const int jr = c / CPR % KS;
                const int cc = c % CPR * 8;
                if (jr < rows && cc < cols)
                    cp_async16(dst0 + (h * KS + jr) * AS + cc,
                               (h ? loT : hiT) + src0 + (long long)jr * B
                               + cc);
            }
        } else {                        // narrower copies of odd shapes
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
        cp_async_commit();
    };

    // This thread's share of slab s's x values: groups c = tid + p * NTHR
    // of 4 consecutive j of lane c / (KS / 4), zero past B and past m.
    float4 xv[XP];
    auto load_x = [&](int s) {
        const int t = s / nslab;
        const int j0 = (s - t * nslab) * KS;
        const long long xc = (long long)idx[row0 + t] * B + j0;
#pragma unroll
        for (int p = 0; p < XP; ++p) {
            const int c = tid + p * NTHR;
            const int q = c / (KS / 4);
            const int jj = c % (KS / 4) * 4;
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (c < XG && k0 + q < m) {
                const float* src = X + (k0 + q) * ldx + xc + jj;
                const int valid = B - j0 - jj;
                if (xvec == 4) {        // B % 4 == 0: all four or none
                    if (valid > 0)
                        v = __ldg(reinterpret_cast<const float4*>(src));
                } else {
                    if (valid > 0) v.x = __ldg(src);
                    if (valid > 1) v.y = __ldg(src + 1);
                    if (valid > 2) v.z = __ldg(src + 2);
                    if (valid > 3) v.w = __ldg(src + 3);
                }
            }
            xv[p] = v;
        }
    };
    // Split the loaded values and store them into x ring slot `slot`.
    auto store_x = [&](int slot) {
        __nv_bfloat16* xh = xring + slot * 2 * LN * XS;
#pragma unroll
        for (int p = 0; p < XP; ++p) {
            const int c = tid + p * NTHR;
            if (c < XG) {
                const int off = c / (KS / 4) * XS + c % (KS / 4) * 4;
                uint2 h, l;
                split4(xv[p], h, l);
                *reinterpret_cast<uint2*>(xh + off) = h;
                *reinterpret_cast<uint2*>(xh + LN * XS + off) = l;
            }
        }
    };

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

    issue(0);
    load_x(0);
    store_x(0);
    // ldmatrix row addresses of this lane.  A (.trans), four 8x8 matrices
    // in fragment order: rows j of the ring, (i 0-7, j 0-7), (i 8-15,
    // j 0-7), (i 0-7, j 8-15), (i 8-15, j 8-15).  B, two 8-lane tiles n and
    // n + 1: (tile n, j 0-7), (tile n, j 8-15), (tile n + 1, j 0-7), (tile
    // n + 1, j 8-15), rows the lanes: fragment b0 b1 of tile n, then of
    // tile n + 1 (.x2 for a last odd tile: the first two).
    const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * AS + warp * 16
                      + ((lane >> 3) & 1) * 8;
    const int b_off = ((NT > 1 ? (lane >> 4) << 3 : 0) + (lane & 7)) * XS
                      + ((lane >> 3) & 1) * 8;
    const bool busy = ib + warp * 16 < B;   // a warp past B only copies

    for (int s = 0; s < nsteps; ++s) {
        cp_async_wait<0>();
        __syncthreads();        // slab s has landed in slot s & 1; the
        const bool next = s + 1 < nsteps;   // other slot's readers are done
        if (next) {
            issue(s + 1);
            load_x(s + 1);      // in flight while slab s is multiplied
        }
        if (busy) {
            const int t = s / nslab;
            const int ksteps = (min(KS, B - (s - t * nslab) * KS) + 15) >> 4;
            const __nv_bfloat16* a_s = ring + (s & 1) * 2 * KS * AS + a_off;
            const __nv_bfloat16* x_s = xring + (s & 1) * 2 * LN * XS + b_off;
            for (int kk = 0; kk < ksteps; ++kk) {
                uint32_t ah[4], al[4];
                ldsm_x4_trans(ah, a_s + kk * 16 * AS);
                ldsm_x4_trans(al, a_s + (KS + kk * 16) * AS);
#pragma unroll
                for (int n = 0; n < NT; n += 2) {
                    uint32_t xh[4], xl[4];
                    const __nv_bfloat16* b = x_s + n * 8 * XS + kk * 16;
                    if (n + 1 < NT) {
                        ldsm_x4(xh, b);
                        ldsm_x4(xl, b + LN * XS);
                    } else {
                        ldsm_x2(xh, b);
                        ldsm_x2(xl, b + LN * XS);
                    }
#pragma unroll
                    for (int u = 0; u < 2 && n + u < NT; ++u) {
                        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                        mma_bf16(d, ah, xh[2 * u], xh[2 * u + 1]);  // hi xh
                        mma_bf16(d, al, xh[2 * u], xh[2 * u + 1]);  // lo xh
                        mma_bf16(d, ah, xl[2 * u], xl[2 * u + 1]);  // hi xl
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[n + u][e] += d[e];
                    }
                }
            }
        }
        if (next) store_x((s + 1) & 1);     // read after the next barrier
    }

    // D fragment: (row g, lanes 2q, 2q + 1), (row g + 8, the same lanes)
    const int g = lane >> 2;
    const int q = lane & 3;
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
           void* Y, int nrb, int ncb, int nbpr, int B, int m, int nchunk,
           int vec, int xvec, void* stream) {
    constexpr int IW = 16 * W;
    constexpr int KS = slab_rows(W);
    constexpr int LN = 8 * NT;
    const auto kernel = bsr_spmm_split_tc<W, NT>;
    const size_t bytes = (size_t)2 * 2 * (KS * (IW + APAD) + LN * (KS + APAD))
                         * sizeof(__nv_bfloat16);
    if (bytes > 48 * 1024) {             // above the default, ask first
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    if ((long long)nchunk * nrb > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)(nchunk * nrb), (B + IW - 1) / IW);
    kernel<<<grid, 32 * W, bytes, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)hiT, (const __nv_bfloat16*)loT,
        (const int*)idx, (const float*)X, (float*)Y, nbpr, B, m, nchunk,
        (long long)ncb * B, (long long)nrb * B, vec, xvec);
    return (int)cudaGetLastError();
}

// The m lanes in ceil(m / (8 MAX_NT)) chunks of equal width, each CTA 8,
// 16, 32, 48 or 64 lanes, the fewest that hold a chunk.
template <int W>
int launch_nt(const void* hiT, const void* loT, const void* idx,
              const void* X, void* Y, int nrb, int ncb, int nbpr, int B,
              int m, int vec, int xvec, void* stream) {
    const int nchunk = (m + 8 * MAX_NT - 1) / (8 * MAX_NT);
    const int tiles = ((m + nchunk - 1) / nchunk + 7) / 8;
#define SPLIT_LAUNCH(NT)                                                    \
    if (tiles <= NT)                                                        \
        return launch<W, NT>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m,     \
                             nchunk, vec, xvec, stream);
    SPLIT_LAUNCH(1)
    SPLIT_LAUNCH(2)
    SPLIT_LAUNCH(4)
    SPLIT_LAUNCH(6)
#undef SPLIT_LAUNCH
    return launch<W, MAX_NT>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m,
                             nchunk, vec, xvec, stream);
}

// The wgmma route (B % 8 == 0, B > 64, 16-byte aligned blocks and x,
// WG_FROM lanes or more): two warpgroups of 64 output rows i, N lanes, the
// three products of a K-step as three m64nNk16 wgmma from shared memory,
// both operands 128-byte swizzled.  A (i x j) is M-major: row j of the
// slab holds i 64 w .. 64 w + 63 of warpgroup w in 128 bytes at w * KS *
// 128 + j * 128, chunk i / 8 % 8 at (i / 8 % 8) ^ (j % 8); its 8-row atoms
// are 1024 bytes apart in j (SBO).  B (j x lanes) is K-major: lane n's KS
// = 64 split values in 128 bytes at (n / 8) * 1024 + (n % 8) * 128, chunk
// j / 8 at (j / 8) ^ (n % 8); a K-step starts 32 bytes further.  Each
// K-step's products are summed from zero by the tensor core in a register
// tile D and added to the running sums.
//
// The blocks and the slab's gathered x values (f32, zero past B and past
// m, staged lane-major with the 16-byte chunk c of lane q at c ^ (q % 8))
// stream through a ring of STAGES slabs, one cp.async group a slab, STAGES
// - 1 in flight while one is multiplied; the staged x values are split
// into bf16 hi/lo once, by all threads, into the x tile the wgmma read, so
// no registers hold x across the products.  Two barriers a slab: after
// the copies land, and after the split.
constexpr int WG_KS = 64;                   // rows j of a slab

// The ring depth and CTAs an SM of an N-lane CTA: up to 64 lanes two CTAs
// share an SM, each with one slab in flight; wider, one CTA an SM keeps
// two slabs in flight.
__host__ __device__ constexpr int wg_stages(int N) { return N <= 64 ? 2 : 3; }
__host__ __device__ constexpr int wg_ctas(int N) { return N <= 64 ? 2 : 1; }

template <int N>
constexpr size_t wg_smem_bytes() {          // ring, x tile, alignment
    return (size_t)wg_stages(N) * (2 * WG_KS * 128 * 2 + N * WG_KS * 4)
           + (size_t)2 * N * WG_KS * 2 + 1024;
}

template <int N>
__global__ void __launch_bounds__(256, wg_ctas(N))
bsr_spmm_split_wg(const __nv_bfloat16* __restrict__ hiT,
                  const __nv_bfloat16* __restrict__ loT,
                  const int* __restrict__ idx, const float* __restrict__ X,
                  float* __restrict__ Y, int nbpr, int B, int m, int nchunk,
                  long long ldx, long long ldy) {
    constexpr int KS = WG_KS;
    constexpr int STAGES = wg_stages(N);
    constexpr int SLAB = 2 * KS * 128 * 2;  // bytes of a slab, hi and lo
    constexpr int STAGE = SLAB + N * KS * 4;    // ... and its staged x
    constexpr int XT = N * KS * 2;          // bytes of a half x tile
    constexpr int XG = N * KS / 4;          // groups of 4 x values a slab
    constexpr int ND = N / 2;               // accumulators a thread
    extern __shared__ __align__(16) unsigned char smem[];
    // ring [STAGES][hi, lo, staged x f32 [N][KS]], x tile [hi, lo], from
    // the first 1024-byte boundary
    unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
    unsigned char* xtile = ring + STAGES * STAGE;

    const int r = blockIdx.x / nchunk;
    const int k0 = (blockIdx.x - r * nchunk) * N;
    const int ib = blockIdx.y * 128;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int wg = warp >> 2;
    const int cols = min(128, B - ib);
    const int nslab = (B + KS - 1) / KS;
    const int nsteps = nbpr * nslab;
    const long long row0 = (long long)r * nbpr;

    // Start the copy of slab s's blocks and x values into ring slot s %
    // STAGES and commit it (an empty group past the end); B % 8 == 0, so
    // a partial last K-step has 8 rows, zeroed.  x group c of 4 values:
    // lane q = (c / 8 / (KS / 4)) * 8 + c % 8, rows j from jj = c / 8 %
    // (KS / 4) * 4.
    auto issue = [&](int s) {
        if (s < nsteps) {
            const int t = s / nslab;
            const int j0 = (s - t * nslab) * KS;
            const int rows = min(KS, B - j0);
            const long long src0 =
                ((row0 + t) * B + j0) * (long long)B + ib;
            unsigned char* dst0 = ring + (s % STAGES) * STAGE;
#pragma unroll
            for (int p = 0; p < 2 * KS * 16 / 256; ++p) {
                const int c = tid + p * 256;    // half h, row jr, i 8ic..
                const int h = c / (KS * 16);
                const int jr = c / 16 % KS;
                const int ic = c % 16;
                if (jr < rows && ic * 8 < cols)
                    cp_async16(dst0 + h * (SLAB / 2) + (ic >> 3) * KS * 128
                               + jr * 128 + (((ic & 7) ^ (jr & 7)) << 4),
                               (h ? loT : hiT) + src0 + (long long)jr * B
                               + ic * 8);
            }
            if (rows & 15)      // rows .. rows + 7 of both halves and atoms
                for (int c = tid; c < 4 * 64; c += 256)
                    *reinterpret_cast<uint4*>(
                        dst0 + (c >> 6) * KS * 128 + rows * 128
                        + (c & 63) * 16) = make_uint4(0, 0, 0, 0);
            float* stage = reinterpret_cast<float*>(dst0 + SLAB);
            const long long xc = (long long)idx[row0 + t] * B + j0;
            for (int c = tid; c < XG; c += 256) {
                const int q = c / 8 / (KS / 4) * 8 + (c & 7);
                const int jj = c / 8 % (KS / 4) * 4;
                const bool valid = k0 + q < m && jj < rows;
                cp_async_zfill<16>(
                    stage + q * KS + ((jj >> 2) ^ (c & 7)) * 4,
                    valid ? X + (k0 + q) * ldx + xc + jj : X,
                    valid ? 16 : 0);
            }
        }
        cp_async_commit();
    };
    // Split slab s's staged x values into the x tile.
    auto split_x = [&](int s) {
        const float* stage =
            reinterpret_cast<const float*>(ring + (s % STAGES) * STAGE + SLAB);
        for (int c = tid; c < XG; c += 256) {
            const int q = c / 8 / (KS / 4) * 8 + (c & 7);
            const int n = c & 7;
            const int jj = c / 8 % (KS / 4) * 4;
            const int off = q / 8 * 1024 + n * 128 + (((jj >> 3) ^ n) << 4)
                            + (jj & 7) * 2;
            uint2 h, l;
            split4(*reinterpret_cast<const float4*>(
                       stage + q * KS + ((jj >> 2) ^ n) * 4), h, l);
            *reinterpret_cast<uint2*>(xtile + off) = h;
            *reinterpret_cast<uint2*>(xtile + XT + off) = l;
        }
    };

    float acc[ND], d[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[e] = d[e] = 0.0f;

    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    const uint32_t a_base = smem_u32(ring) + wg * KS * 128;
    const uint32_t x_base = smem_u32(xtile);
    const bool busy = ib + wg * 64 < B;     // a warpgroup past B only copies

    for (int s = 0; s < nsteps; ++s) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();        // slab s's blocks and x have landed
        split_x(s);
        fence_proxy_async();    // this thread's copies and x tile stores
        __syncthreads();        // x tile ready; slot s - 1 free
        issue(s + STAGES - 1);
        if (busy) {
            const int t = s / nslab;
            const int ksteps = (min(KS, B - (s - t * nslab) * KS) + 15) >> 4;
            const uint32_t a_s = a_base + (s % STAGES) * STAGE;
            for (int kk = 0; kk < ksteps; ++kk) {
                const uint32_t a = a_s + kk * 2 * 1024;
                const uint32_t b = x_base + kk * 32;
                const uint64_t ah = smem_desc(a, KS * 128, 1024);
                const uint64_t al = smem_desc(a + SLAB / 2, KS * 128, 1024);
                const uint64_t xh = smem_desc(b, 16, 1024);
                const uint64_t xl = smem_desc(b + XT, 16, 1024);
#pragma unroll
                for (int e = 0; e < ND; ++e) reg_fence(d[e]);
                wgmma_fence();
                wgmma_bf16<N>(d, ah, xh, 0);    // hi * xh, from zero
                wgmma_bf16<N>(d, al, xh, 1);    // lo * xh
                wgmma_bf16<N>(d, ah, xl, 1);    // hi * xl
                wgmma_commit();
                wgmma_wait_all();
#pragma unroll
                for (int e = 0; e < ND; ++e) {
                    reg_fence(d[e]);
                    acc[e] += d[e];
                }
            }
        }
    }
    cp_async_wait<0>();         // the empty groups past the end

    // D fragment of warp w of the warpgroup: rows 16 w + g and + 8, lanes
    // 8 c + 2 q and + 1 in registers 4 c .. 4 c + 3
    const int g = lane >> 2;
    const int q = lane & 3;
#pragma unroll
    for (int e = 0; e < ND; ++e) {
        const int k = k0 + (e >> 2) * 8 + 2 * q + (e & 1);
        const int i = ib + wg * 64 + (warp & 3) * 16 + g + ((e >> 1) & 1) * 8;
        if (k < m && i < B) Y[k * ldy + (long long)r * B + i] = acc[e];
    }
}

template <int N>
int launch_wg(const void* hiT, const void* loT, const void* idx,
              const void* X, void* Y, int nrb, int ncb, int nbpr, int B,
              int m, int nchunk, void* stream) {
    const auto kernel = bsr_spmm_split_wg<N>;
    const size_t bytes = wg_smem_bytes<N>();
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if ((long long)nchunk * nrb > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)(nchunk * nrb), (B + 127) / 128);
    kernel<<<grid, 256, bytes, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)hiT, (const __nv_bfloat16*)loT,
        (const int*)idx, (const float*)X, (float*)Y, nbpr, B, m, nchunk,
        (long long)ncb * B, (long long)nrb * B);
    return (int)cudaGetLastError();
}

// The wgmma route's m >= WG_FROM lanes in ceil(m / WG_MAX) chunks of equal
// width, so more than 32 lanes a chunk: each CTA 48, 64, 96 or 128 lanes,
// the fewest that hold a chunk.
int launch_wg_n(const void* hiT, const void* loT, const void* idx,
                const void* X, void* Y, int nrb, int ncb, int nbpr, int B,
                int m, void* stream) {
    static_assert(WG_FROM > 32 && (WG_MAX == 64 || WG_MAX == 128),
                  "chunk width");
    const int nchunk = (m + WG_MAX - 1) / WG_MAX;
    const int w = (m + nchunk - 1) / nchunk;
#define WG_LAUNCH(N)                                                        \
    if (w <= N)                                                             \
        return launch_wg<N>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m,      \
                            nchunk, stream);
    WG_LAUNCH(48)
    WG_LAUNCH(64)
    WG_LAUNCH(96)
#undef WG_LAUNCH
    return launch_wg<128>(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m, nchunk,
                          stream);
}

// The widest copy (elements) that B and both base addresses allow: a slab
// row starts at a multiple of B elements from its base.
int pick_vec(const void* hiT, const void* loT, int B) {
    const uintptr_t p = (uintptr_t)hiT | (uintptr_t)loT;
    for (int v = 8; v > 1; v /= 2)
        if (B % v == 0 && p % (2 * v) == 0) return v;
    return 1;
}

// x in 16-byte loads where every x block (c*B + j0, j0 a multiple of 4)
// starts 16-byte aligned, else one f32 at a time.
int pick_xvec(const void* X, int B) {
    return B % 4 == 0 && (uintptr_t)X % 16 == 0 ? 4 : 1;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  The launch is on the given
// stream, does not synchronise, allocates nothing, and returns the CUDA
// error code of the launch (0 = cudaSuccess).  The caller checks shapes,
// types, devices and contiguity, 1 <= B <= 1024, m >= 1, every block-column
// id below ncb, and that the grid fits (nrb * ceil(m / 64) <= 2^31 - 1;
// the launch refuses a larger one).
extern "C" {

int bsr_spmm_split_f32(const void* hiT, const void* loT, const void* idx,
                       const void* X, void* Y, int nrb, int ncb, int nbpr,
                       int B, int m, void* stream) {
    const int vec = pick_vec(hiT, loT, B);
    const int xvec = pick_xvec(X, B);
    const int bp = (B + 15) / 16 * 16;     // B rounded up to the MMA's 16
    if (m >= WG_FROM && B > 64 && vec == 8 && xvec == 4)
        return launch_wg_n(hiT, loT, idx, X, Y, nrb, ncb, nbpr, B, m,
                           stream);
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
