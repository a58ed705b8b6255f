// Block-ELL sparse matrix-vector products for Hopper (sm_90a).
//
// Layout (the BSROperator's storage, shared with the JAX package):
//   dataT (nrb, nbpr, B, B)  blocks stored per-block TRANSPOSED:
//                            dataT[r, t, j, i] = H[r*B + i, idx[r, t]*B + j]
//   idx   (nrb, nbpr) int32  block-column id of each stored block
//   x     (nrb*B,)           input, zero-padded to whole blocks
//   y     (nrb*B,)           output
// computing  y[r*B + i] = sum_t sum_j dataT[r, t, j, i] * x[idx[r, t]*B + j].
//
// bsr_spmv_{f32,f64}  replace eigensolvers_tpu/ops/sparse.py::
//   _bsr_matvec_pallas ("highest" precision; Pallas launch at sparse.py:440).
// The "high" (bf16x3) form, _bsr_matvec_pallas_split (launch at :479), is
// bsr_spmm_split.cu launched with one vector.
//
// What bounds them: each matvec streams every stored block once, so the
// cost is the HBM bytes of dataT (nrb*nbpr*B*B*itemsize), read exactly once;
// there is B*B*nbpr*2 flops per B*B*nbpr*itemsize bytes, far below the
// card's flop/byte balance.  x is small (one vector) and is re-read from L2.
// Design against that bound: one thread block per block-row r and one
// thread per output row i, so the threads of a warp read consecutive i of
// one (j) row of a transposed block -- every dataT load is coalesced and
// every byte is touched once.  The x-block of each term is staged once in
// shared memory and broadcast to all threads.  The TPU kernel's sequential
// term grid axis becomes the loop over t inside the block, and its scalar
// prefetch becomes each block reading its own idx row; nothing is carried
// between blocks, so there are no atomics and no padding of nrb.  Sums are
// FMA chains in the working type: no TF32 and no tensor cores.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

template <typename T>
__global__ void bsr_spmv_kernel(const T* __restrict__ dataT,
                                const int* __restrict__ idx,
                                const T* __restrict__ x,
                                T* __restrict__ y, int nbpr, int B) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* xs = reinterpret_cast<T*>(smem);
    const int r = blockIdx.x;
    const int i = threadIdx.x;
    T acc = T(0);
    for (int t = 0; t < nbpr; ++t) {
        const long long c = idx[(long long)r * nbpr + t];
        __syncthreads();               // previous term's xs fully consumed
        xs[i] = x[c * B + i];
        __syncthreads();
        const T* blk = dataT + ((long long)r * nbpr + t) * B * B + i;
#pragma unroll 8
        for (int j = 0; j < B; ++j) {
            acc = fma_t(blk[(long long)j * B], xs[j], acc);
        }
    }
    y[(long long)r * B + i] = acc;
}

template <typename T>
int launch(const void* dataT, const void* idx, const void* x, void* y,
           int nrb, int nbpr, int B, void* stream) {
    bsr_spmv_kernel<T><<<nrb, B, B * sizeof(T), (cudaStream_t)stream>>>(
        (const T*)dataT, (const int*)idx, (const T*)x, (T*)y, nbpr, B);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, allocates nothing, and returns the
// cudaGetLastError() code of the launch (0 = cudaSuccess).  The caller
// checks shapes, types, devices and contiguity, and 1 <= B <= 1024.
extern "C" {

int bsr_spmv_f32(const void* dataT, const void* idx, const void* x, void* y,
                 int nrb, int nbpr, int B, void* stream) {
    return launch<float>(dataT, idx, x, y, nrb, nbpr, B, stream);
}

int bsr_spmv_f64(const void* dataT, const void* idx, const void* x, void* y,
                 int nrb, int nbpr, int B, void* stream) {
    return launch<double>(dataT, idx, x, y, nrb, nbpr, B, stream);
}

const char* bsr_spmv_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
