// The dense move scan (kernel K3): every chain's m rank-2 tree moves in one
// launch.
//
// Replaces no Pallas kernel: the reference leaves its sequential move scan
// to XLA (`tree_move`, bark_tpu/fitting/sampler.py:688, under `lax.scan` at
// :1027). Its torch form (`fitting/sampler._scan_plain`, the
// twin) launches ~45 small kernels a move on (C, N, N) and smaller tensors,
// ~2,250 a step at m = 50, and the step is bound by the host's launch rate:
// the device's work is 8 m N^2 flops a chain, ~1 MFLOP at N = 50.
//
// Per chain c, from the carried K^-1 (N x N), y, and the moves' 0/+-1
// update patterns W_pat[j] (N x 2) scaled by h = sqrt(scale / 2m):
//   seed:  v_y = K^-1 y, quad = v_y^T y, mll = (-quad - logdet + corr) / 2
//          (the scan's own quadratic and logdet, never the refresh's MLL);
//   move j, W = h W_pat[j]:  V = K^-1 W, G = W^T V, t = W^T v_y, the 2x2
//          capacitance M = diag(1, -1) + G and its inverse, u = M^-1 t,
//          quad' = quad - t^T u, logdet' = logdet + log(-det M), the
//          proposal's MLL (-inf where denom2 = -det M / (1 + G00) <= 1e-6),
//          log alpha = log q + beta (mll' - mll), accept where
//          log u <= min(log alpha, 0) (a NaN log alpha rejects); on an
//          accept K^-1 -= (V M^-1) V^T and v_y -= V u.
// The same formulas, guards and order as the twin's `_capacitance_inverse`,
// `_rank2_terms` and `_accept`; only the MLL difference is tempered by beta.
//
// Design: one thread block per chain, so every chain's 50 moves run side by
// side on their own SM and the loop never leaves the chip. The block holds
// K^-1 in shared memory for all m moves as its packed lower triangle,
// N (N + 1) / 2 floats: 130,560 B at N = 255, where a square float32 K^-1
// (260,100 B) would not fit the 232,448 B a block may use above N ~ 238.
// The packed form covers every padded N of the dense tier (1-255) in one
// layout and one launch, and halves the update; a two-block cluster
// splitting the rows would cover it too, at the price of distributed shared
// memory reads in every product. K^-1 is symmetric, so its lower triangle
// is all the scan reads (the twin's rounding leaves the carried K^-1
// symmetric to within its round-off).
//
// Thread i < N owns row i: it computes V[i] = K^-1[i, :] W, skipping the
// columns where both patterns are zero (a branch uniform across the block;
// the patterns are leaf indicators, mostly zero) and keeps v_y[i] in a
// register. G and t are block reductions (warp shuffles, then one partial
// per warp in shared memory); every thread sums the partials in the same
// order, so each holds the same bits of the 2x2 algebra and the decision,
// with no broadcast. V is staged in shared memory before the reduction's
// barrier, so an accepted update needs no barrier of its own: one warp per
// row r of the triangle forms V[r] M^-1 and subtracts its products with
// V[k], k <= r. Two barriers a move. The next move's patterns, log q and u
// are loaded a move ahead. Pad rows have zero patterns and stay inert.
//
// Precision: float32 storage and arithmetic on the CUDA cores, as the twin,
// but for the row sums of K^-1 W and K^-1 y, which accumulate in double and
// round once to float32; no TF32, bf16 or tensor cores (a reduced-precision
// product that decides the MLL brings back the reference's matmul-precision
// bias). A thread sums its row in order, over up to 255 entries of K^-1
// (~1/noise, of both signs): in float32 such sums put log alpha up to 1e-3
// off the float64 loop's at N = 255 on an NVIDIA H100, 4x the twin's cuBLAS
// sums; accumulated in double, under the twin's (PERF.md, Findings). The
// reductions (warp shuffles, a tree) and FMA contraction differ from the
// twin's products by round-off.
//
// Bounded by latency, not bytes or flops: 2 barriers, a reduction and a
// serial 2x2 algebra per move, m moves in order.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 255;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSums = 5;  // G00, G11, G01, t0, t1
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// floats of shared memory at N: the triangle, y, W and V (float2 each),
// the per-warp partials
size_t smem_bytes(int n) {
  return (size_t)(pad4(tri(n)) + pad4(n) + 2 * 2 * pad4(n) + kMaxWarps * kSums) *
         sizeof(float);
}

int threads_for(int n) { return n <= 32 ? 32 : ((n + 31) / 32) * 32; }

// entry (i, k) of the symmetric matrix from its packed lower triangle
__device__ __forceinline__ float sym(const float* p, int i, int k) {
  const int a = max(i, k), b = min(i, k);
  return p[tri(a) + b];
}

template <int K>
__device__ __forceinline__ void warp_sum(float (&v)[K]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < K; ++q) v[q] += __shfl_down_sync(kFull, v[q], off);
  }
}

// Block-wide sum of K values: every thread returns the same sums. One
// barrier; `red` must not be rewritten before every thread has returned.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red, int lane, int warp,
                                          int warps) {
  warp_sum(v);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) red[warp * kSums + q] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = 0.0f;
  for (int w = 0; w < warps; ++w) {
#pragma unroll
    for (int q = 0; q < K; ++q) v[q] += red[w * kSums + q];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
move_scan_kernel(const float* __restrict__ kinv, const float* __restrict__ y,
                 const float2* __restrict__ wpat, const float* __restrict__ h,
                 const float* __restrict__ logdet_in, const float* __restrict__ corr_in,
                 const float* __restrict__ logq, const float* __restrict__ u_accept,
                 const float* __restrict__ beta_in, unsigned char* __restrict__ accept_out,
                 float* __restrict__ log_alpha_out, int n, int m) {
  extern __shared__ __align__(16) float smem[];
  float* P = smem;                                       // packed lower K^-1
  float* ys = P + pad4(tri(n));                          // y
  float2* ws = reinterpret_cast<float2*>(ys + pad4(n));  // W of the move
  float2* vs = ws + pad4(n);                             // V of the move
  float* red = reinterpret_cast<float*>(vs + pad4(n));   // per-warp partials

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const bool row = tid < n;
  const int i = tid;

  const float* K = kinv + (size_t)c * n * n;
  for (int r = warp; r < n; r += warps) {
    for (int k = lane; k <= r; k += 32) P[tri(r) + k] = K[(size_t)r * n + k];
  }
  for (int k = tid; k < n; k += blockDim.x) ys[k] = y[k];

  const float2* wp = wpat + (size_t)c * m * n;
  const float* lq_c = logq + (size_t)c * m;
  const float* u_c = u_accept + (size_t)c * m;
  const float hh = h[c], corr = corr_in[c], be = beta_in[c];
  float logdet = logdet_in[c];
  float2 p_next = make_float2(0.0f, 0.0f);
  if (row && m > 0) p_next = wp[i];
  float lq_next = m > 0 ? lq_c[0] : 0.0f;
  float u_next = m > 0 ? u_c[0] : 1.0f;
  __syncthreads();

  // the seed: v_y = K^-1 y and quad = v_y^T y
  float vy = 0.0f;
  if (row) {
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc = fma((double)sym(P, i, k), (double)ys[k], acc);
    vy = (float)acc;
  }
  float q1[1] = {row ? vy * ys[i] : 0.0f};
  block_sum(q1, red, lane, warp, warps);
  float quad = q1[0];
  float cur = 0.5f * ((-quad - logdet) + corr);

  for (int j = 0; j < m; ++j) {
    const float2 p = p_next;
    const float lq = lq_next, lu = logf(u_next);
    if (j + 1 < m) {
      if (row) p_next = wp[(size_t)(j + 1) * n + i];
      lq_next = lq_c[j + 1];
      u_next = u_c[j + 1];
    }
    const float w0 = hh * p.x, w1 = hh * p.y;
    if (row) ws[i] = make_float2(w0, w1);
    __syncthreads();  // W visible; the last move's update of K^-1 done

    float v0 = 0.0f, v1 = 0.0f;
    if (row) {
      double d0 = 0.0, d1 = 0.0;
      for (int k = 0; k < n; ++k) {
        const float2 wk = ws[k];
        if (wk.x == 0.0f && wk.y == 0.0f) continue;
        const double a = sym(P, i, k);
        d0 = fma(a, (double)wk.x, d0);
        d1 = fma(a, (double)wk.y, d1);
      }
      v0 = (float)d0;
      v1 = (float)d1;
      vs[i] = make_float2(v0, v1);
    }
    float s[kSums] = {w0 * v0, w1 * v1, w0 * v1, w0 * vy, w1 * vy};
    block_sum(s, red, lane, warp, warps);  // also makes V visible

    // the 2x2 algebra, in every thread alike
    const float A = s[0], B = s[1], Cc = s[2], t0 = s[3], t1 = s[4];
    const float denom1 = 1.0f + A;
    const float detM = denom1 * (B - 1.0f) - Cc * Cc;
    const float denom2 = -detM / denom1;
    const float m00 = (B - 1.0f) / detM, m01 = -Cc / detM, m11 = denom1 / detM;
    const float logdet2 = logdet + logf(-detM);
    const float u0 = m00 * t0 + m01 * t1, u1 = m01 * t0 + m11 * t1;
    const float quad2 = quad - (t0 * u0 + t1 * u1);
    float mll2 = 0.5f * ((-quad2 - logdet2) + corr);
    if (!(denom2 > 1e-6f)) mll2 = -CUDART_INF_F;
    const float log_alpha = lq + be * (mll2 - cur);
    const bool acc = (lu <= log_alpha) && (lu <= 0.0f);  // false for a NaN log alpha
    if (tid == 0) {
      accept_out[(size_t)c * m + j] = acc ? 1 : 0;
      log_alpha_out[(size_t)c * m + j] = log_alpha;
    }
    if (!acc) continue;
    logdet = logdet2;
    quad = quad2;
    cur = mll2;
    if (row) vy -= v0 * u0 + v1 * u1;
    for (int r = warp; r < n; r += warps) {
      const float2 vr = vs[r];
      const float a0 = vr.x * m00 + vr.y * m01, a1 = vr.x * m01 + vr.y * m11;
      float* pr = P + tri(r);
      for (int k = lane; k <= r; k += 32) {
        const float2 vk = vs[k];
        pr[k] -= a0 * vk.x + a1 * vk.y;
      }
    }
  }
}

}  // namespace

// C entry point: device pointers to float32 kinv (c, n, n) (its lower
// triangle is read), y (n,), wpat (c, m, n, 2), h, logdet, corr and beta
// (c,), logq and u (c, m); writes accept (c, m) bytes 0/1 and log_alpha
// (c, m) float32. Returns the cudaError_t of the launch (0 on success).
extern "C" int bark_move_scan(const float* kinv, const float* y, const float* wpat,
                              const float* h, const float* logdet, const float* corr,
                              const float* logq, const float* u, const float* beta,
                              unsigned char* accept, float* log_alpha, int c, int n, int m,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > kMaxN || m < 0 || c < 0) return (int)cudaErrorInvalidValue;
  if (c == 0 || m == 0) return 0;
  // the shared-memory opt-in above 48 KB is an attribute of each device
  static bool configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(move_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxN));
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  move_scan_kernel<<<c, threads_for(n), smem_bytes(n), (cudaStream_t)stream>>>(
      kinv, y, reinterpret_cast<const float2*>(wpat), h, logdet, corr, logq, u, beta, accept,
      log_alpha, n, m);
  return (int)cudaGetLastError();
}
