// Block-ELL sparse matrix times a stack of m vectors, for Hopper (sm_90a).
//
// Layout (the BSROperator's storage, shared with bsr_spmv.cu):
//   dataT (nrb, nbpr, B, B)  blocks stored per-block TRANSPOSED:
//                            dataT[r, t, j, i] = H[r*B + i, idx[r, t]*B + j]
//   idx   (nrb, nbpr) int32  block-column id of each stored block
//   X     (m, nrb*B)         the m right-hand sides, lane-major (one row per
//                            vector), each zero-padded to whole blocks
//   Y     (m, nrb*B)         output, lane-major
// computing  Y[k, r*B + i] = sum_t sum_j dataT[r, t, j, i] * X[k, idx[r, t]*B + j].
//
// bsr_spmm_{f32,f64}  replace eigensolvers_tpu/ops/sparse.py::_bsr_matmat_xla
//   (XLA gather + einsum, :294; every vmapped BSR matvec reaches it through
//   the custom_vmap rules at :488-537).  Its "high" (bf16x3) form is
//   bsr_spmm_split.cu, on the tensor cores.
//
// What bounds them: at m <= 8 each dataT element carries 2m flops per
// itemsize bytes, far below the card's flop/byte balance, so an apply costs
// the HBM bytes of dataT read once -- the same as one single-vector SpMV,
// not m of them.  Design against that bound: the single-vector kernel's
// schedule (one thread block per block-row r, one thread per output row i,
// so a warp's dataT loads are consecutive in i and coalesced), with MR
// accumulators per thread.  MR (1, 2, 4 or 8) is a template parameter; the
// m vectors are cut into chunks of MR along the grid's y axis, so m above 8
// runs in chunks of 8.  The MR x-blocks of each term are staged once in
// shared memory, interleaved as xs[j*MR + q] so that one thread reads the
// MR values of a row j with wide broadcast loads; each dataT element is
// loaded once per chunk and used MR times.  Sums are FMA chains in the
// working type: no TF32 and no tensor cores.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

template <typename T, int MR>
__global__ void bsr_spmm_kernel(const T* __restrict__ dataT,
                                const int* __restrict__ idx,
                                const T* __restrict__ X,
                                T* __restrict__ Y, int nbpr, int B, int m,
                                long long npad) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* xs = reinterpret_cast<T*>(smem);          // (B, MR), row j = xs[j*MR]
    const int r = blockIdx.x;
    const int k0 = blockIdx.y * MR;
    const int i = threadIdx.x;
    T acc[MR];
#pragma unroll
    for (int q = 0; q < MR; ++q) acc[q] = T(0);
    for (int t = 0; t < nbpr; ++t) {
        const long long c = idx[(long long)r * nbpr + t];
        __syncthreads();               // previous term's xs fully consumed
#pragma unroll
        for (int q = 0; q < MR; ++q) {
            const int k = k0 + q;
            xs[i * MR + q] = k < m ? X[k * npad + c * B + i] : T(0);
        }
        __syncthreads();
        const T* blk = dataT + ((long long)r * nbpr + t) * B * B + i;
#pragma unroll 4
        for (int j = 0; j < B; ++j) {
            const T a = blk[(long long)j * B];
            const T* xj = xs + j * MR;
#pragma unroll
            for (int q = 0; q < MR; ++q) acc[q] = fma_t(a, xj[q], acc[q]);
        }
    }
#pragma unroll
    for (int q = 0; q < MR; ++q) {
        const int k = k0 + q;
        if (k < m) Y[k * npad + (long long)r * B + i] = acc[q];
    }
}

// Launch one kernel instance with `bytes` of dynamic shared memory; above
// the default 48 KB (f64 with MR = 8 and B = 1024 needs 64 KB) the kernel
// must first be allowed to take it.
template <typename Kernel, typename... Args>
int launch_with_smem(Kernel kernel, dim3 grid, int threads, size_t bytes,
                     void* stream, Args... args) {
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

// MR for m vectors: the smallest of 1, 2, 4, 8 that holds them, capped at 8.
int pick_mr(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8; }

template <typename T, int MR>
int launch_mr(const void* dataT, const void* idx, const void* X, void* Y,
              int nrb, int nbpr, int B, int m, void* stream) {
    const dim3 grid(nrb, (m + MR - 1) / MR);
    return launch_with_smem(bsr_spmm_kernel<T, MR>, grid, B,
                            (size_t)MR * B * sizeof(T), stream,
                            (const T*)dataT, (const int*)idx, (const T*)X,
                            (T*)Y, nbpr, B, m, (long long)nrb * B);
}

template <typename T>
int launch(const void* dataT, const void* idx, const void* X, void* Y,
           int nrb, int nbpr, int B, int m, void* stream) {
    switch (pick_mr(m)) {
        case 1: return launch_mr<T, 1>(dataT, idx, X, Y, nrb, nbpr, B, m, stream);
        case 2: return launch_mr<T, 2>(dataT, idx, X, Y, nrb, nbpr, B, m, stream);
        case 4: return launch_mr<T, 4>(dataT, idx, X, Y, nrb, nbpr, B, m, stream);
        default: return launch_mr<T, 8>(dataT, idx, X, Y, nrb, nbpr, B, m, stream);
    }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches ONE kernel on the
// given stream, does not synchronise, allocates nothing, and returns the
// CUDA error code of the launch (0 = cudaSuccess).  The caller checks
// shapes, types, devices and contiguity, 1 <= B <= 1024, m >= 1, and that
// m * nrb * B fits the grid (nrb <= 2^31 - 1, ceil(m / 8) <= 65535).
extern "C" {

int bsr_spmm_f32(const void* dataT, const void* idx, const void* X, void* Y,
                 int nrb, int nbpr, int B, int m, void* stream) {
    return launch<float>(dataT, idx, X, Y, nrb, nbpr, B, m, stream);
}

int bsr_spmm_f64(const void* dataT, const void* idx, const void* X, void* Y,
                 int nrb, int nbpr, int B, int m, void* stream) {
    return launch<double>(dataT, idx, X, Y, nrb, nbpr, B, m, stream);
}

const char* bsr_spmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
