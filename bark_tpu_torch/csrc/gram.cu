// Leaf-agreement counts of a forest, batched over chains (kernel K1).
//
// Replaces the Pallas kernel `_gram_kernel` / `counts_from_leaves_pallas`
// (bark_tpu/ops/pallas_gram.py), and with it the one-hot Gram matmul
// (bark_tpu/forest.py gram_from_leaves) on the sampler's path:
//
//   out[b, i, j] = count_t(l1[b, i, t] == l2[b, j, t]) / m * mask1[i] * mask2[j]
//
// What bounds it on the H100: integer compare-accumulates, N*M*m per chain
// (64 chains x 50 x 50 x 50 = 8e6 at the sampler's headline size) -- a few
// microseconds of work; the inputs are leaf ids (N*m int32, 10 KB at
// N = m = 50) and the output N*M float32. At these sizes the launch and
// the fill of 132 SMs dominate, not bytes or operations.
//
// Design: one 32x32 output tile per block, blockIdx.z is the chain. The
// tile's 32 rows of both leaf-id matrices are staged in shared memory in
// passes of 64 trees (any m), padded by one word per row so the column
// reads are free of bank conflicts. Each of the 32x8 threads owns four
// outputs of one column and counts in registers; the row operand is a
// warp-wide broadcast. Edges are handled by bounds checks. The count is an
// integer, so the result is exact: counts / m is an IEEE division, then
// the masks multiply in the same order as the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // output tile edge (rows and columns)
constexpr int kRows = 8;   // thread rows; each thread owns kTile / kRows outputs
constexpr int kTk = 64;    // trees staged per pass

__global__ void gram_kernel(const int* __restrict__ l1,
                            const int* __restrict__ l2,
                            const float* __restrict__ mask1,
                            long long mask1_bstride,
                            const float* __restrict__ mask2,
                            long long mask2_bstride,
                            float* __restrict__ out, int n, int mcols, int m) {
  __shared__ int s1[kTile][kTk + 1];
  __shared__ int s2[kTile][kTk + 1];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int* a = l1 + (long long)b * n * m;
  const int* c = l2 + (long long)b * mcols * m;

  int acc[kTile / kRows];
#pragma unroll
  for (int k = 0; k < kTile / kRows; ++k) acc[k] = 0;

  for (int t0 = 0; t0 < m; t0 += kTk) {
    const int tk = min(kTk, m - t0);
    for (int idx = ty * kTile + tx; idx < kTile * kTk; idx += kTile * kRows) {
      const int r = idx / kTk;
      const int t = idx % kTk;
      const int gi = i0 + r;
      const int gj = j0 + r;
      s1[r][t] = (gi < n && t < tk) ? a[(long long)gi * m + t0 + t] : 0;
      s2[r][t] = (gj < mcols && t < tk) ? c[(long long)gj * m + t0 + t] : 0;
    }
    __syncthreads();
    for (int t = 0; t < tk; ++t) {
      const int v = s2[tx][t];
#pragma unroll
      for (int k = 0; k < kTile / kRows; ++k) acc[k] += (s1[ty + k * kRows][t] == v);
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= mcols) return;
  const float mf = (float)m;
  const float mj = mask2 ? mask2[b * mask2_bstride + j] : 1.0f;
#pragma unroll
  for (int k = 0; k < kTile / kRows; ++k) {
    const int i = i0 + ty + k * kRows;
    if (i < n) {
      const float mi = mask1 ? mask1[b * mask1_bstride + i] : 1.0f;
      out[((long long)b * n + i) * mcols + j] = (float)acc[k] / mf * mi * mj;
    }
  }
}

}  // namespace

// C entry point. Pointers are device pointers; a null mask means all ones.
// A mask batch stride of 0 shares one (N,) mask across the batch. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int bark_gram(const int* l1, const int* l2, const float* mask1,
                         long long mask1_bstride, const float* mask2,
                         long long mask2_bstride, float* out, int batch, int n,
                         int mcols, int m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || n == 0 || mcols == 0) return 0;
  const dim3 block(kTile, kRows);
  const dim3 grid((mcols + kTile - 1) / kTile, (n + kTile - 1) / kTile, batch);
  gram_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      l1, l2, mask1, mask1_bstride, mask2, mask2_bstride, out, n, mcols, m);
  return (int)cudaGetLastError();
}

// Message for an error code returned by the entry points.
extern "C" const char* bark_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
