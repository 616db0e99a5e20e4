// Batched Cholesky with the inverse factor (kernel K2).
//
// Replaces the Pallas kernel `_chol_inv_kernel` / `chol_inv_blocks`
// (bark_tpu/ops/pallas_chol.py): for each SPD matrix A of a (G, BK, BK)
// batch it returns L with A = L L^T and E = L^-1, both from one column loop
// (forward elimination of [A | I]). The sampler's refresh factors both MH
// branches of every chain at once (G = 2 x chains = 128 at 64 chains), and
// the E of the selected branch is its K^-1 factor, so no triangular solve
// with N right-hand sides remains.
//
// What bounds it on the H100: the column recursion is sequential -- BK
// steps, each a rank-1 update of the trailing block, (BK^3)/3 FMAs for L
// and as many again for E. At BK = 50 that is ~80 K FMAs a matrix: latency,
// not throughput, is the limit.
//
// Design: one thread block per matrix (128 blocks fill 128 of the 132
// SMs); the working matrix, the E accumulator and the current column live
// in dynamic shared memory (2 BK^2 + BK words: 128 KB at BK = 128, hence
// cudaFuncSetAttribute). The working matrix has a row stride of BK + 1 so
// that reading a column is free of bank conflicts. Per column j: every
// thread reads the pivot, one barrier, the column of L is scaled (cached in
// `col`) and row j of E is scaled, one barrier, then the trailing rank-1
// update of the lower triangle and the elimination of E below row j, one
// barrier. A non-positive pivot gives NaN, as jnp.linalg.cholesky does, and
// the NaN spreads through L and E so the caller's MLL is NaN and the MH
// step rejects. Any BK <= 128 is taken as is.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBk = 128;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kMaxDevices = 64;

size_t smem_bytes(int bk) {
  return (size_t)(bk * (bk + 1) + bk * bk + bk) * sizeof(float);
}

__global__ void chol_inv_kernel(const float* __restrict__ in,
                                float* __restrict__ lout,
                                float* __restrict__ eout, int bk) {
  extern __shared__ float smem[];
  const int ld = bk + 1;
  float* a = smem;             // working matrix, row stride ld
  float* e = a + bk * ld;      // inverse accumulator, row stride bk
  float* col = e + bk * bk;    // current column of L
  const long long off = (long long)blockIdx.x * bk * bk;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nth = kThreadsX * kThreadsY;

  for (int idx = tid; idx < bk * bk; idx += nth) {
    const int r = idx / bk;
    const int c = idx % bk;
    a[r * ld + c] = in[off + idx];
    e[idx] = (r == c) ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < bk; ++j) {
    const float d = a[j * ld + j];
    __syncthreads();  // the pivot is read everywhere before it is overwritten
    const float inv = 1.0f / sqrtf(d);
    for (int i = j + tid; i < bk; i += nth) {
      const float v = (i == j) ? sqrtf(d) : a[i * ld + j] * inv;
      a[i * ld + j] = v;
      col[i] = v;
    }
    for (int k = tid; k <= j; k += nth) e[j * bk + k] *= inv;
    __syncthreads();
    for (int i = j + 1 + threadIdx.y; i < bk; i += kThreadsY) {
      const float li = col[i];
      for (int k = j + 1 + threadIdx.x; k <= i; k += kThreadsX) {
        a[i * ld + k] -= li * col[k];
      }
      for (int k = threadIdx.x; k <= j; k += kThreadsX) {
        e[i * bk + k] -= li * e[j * bk + k];
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < bk * bk; idx += nth) {
    const int r = idx / bk;
    const int c = idx % bk;
    lout[off + idx] = (c <= r) ? a[r * ld + c] : 0.0f;
    eout[off + idx] = (c <= r) ? e[idx] : 0.0f;
  }
}

}  // namespace

// C entry point: in, l, e are device pointers to (g, bk, bk) float32
// row-major batches. Returns the cudaError_t of the launch (0 on success).
extern "C" int bark_chol_inv(const float* in, float* l, float* e, int g, int bk,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bk < 1 || bk > kMaxBk) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  // the shared-memory opt-in above 48 KB is an attribute of each device
  static bool configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(chol_inv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxBk));
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  chol_inv_kernel<<<g, dim3(kThreadsX, kThreadsY), smem_bytes(bk),
                    (cudaStream_t)stream>>>(in, l, e, bk);
  return (int)cudaGetLastError();
}
