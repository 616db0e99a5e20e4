// Batched Cholesky with the inverse factor (kernel K2), blocked inside one
// kernel for any BK <= 256.
//
// Replaces the Pallas kernel `_chol_inv_kernel` (bark_tpu/ops/pallas_chol.py:55,
// launched by `chol_inv_blocks`): for each SPD matrix A of a (G, BK, BK)
// batch it returns L with A = L L^T and E = L^-1, from one sweep that
// eliminates [A | I] as the Pallas kernel does. The sampler's refresh factors
// both MH branches of every chain at once (G = 2 x chains = 128 at 64
// chains), and the E of the selected branch is its K^-1 factor.
//
// What bounded the first design: one column loop over the whole matrix,
// three block-wide barriers per column and a read-modify-write of one shared
// word per FMA, BK <= 128 only. On an NVIDIA H100 80GB HBM3 at 700 W it took
// 0.2574 ms at (128, 128, 128) against cuSOLVER's 0.2988 ms, ~2 us per
// column: barrier and shared-memory latency, not arithmetic (~0.7 M FMA for
// L per matrix at BK = 128). Above 128 the host blocked it in ~15 launches:
// 0.9038 ms at (128, 200, 200) against cuSOLVER's 0.6603 ms.
//
// Design: one thread block (16 warps) per matrix; 128 matrices fill 128 of
// the 132 SMs in one wave. BK is padded in shared memory to NT = ceil(BK/32)
// tiles with an identity block (inert: blockdiag(A, I) factors to
// blockdiag(L, I)). Shared memory holds the lower triangle of A as 32 x 32
// tiles with row stride 36 (16-byte rows, read 4 floats at a time), plus
// one scratch tile per tile row and one staging tile: at BK = 256,
// (36 + 8 + 1) x 32 x 36 x 4 B = 207,360 B of the 232,448 a block may opt
// into. E has no matrix of its own: its tiles are built in the slots of A's
// tiles as they retire. After panel p, slot (i, j < p) holds the elimination
// state of E, slot (i, j > p) the Schur complement of A.
//
// Loads: cp.async brings panel 0's tile column first; the other columns are
// in flight while the first diagonal tile is factored and its panel solved.
// Each tile of L and E is stored to global memory as soon as it is final.
//
// Per 32-wide panel p, right-looking, three barriers:
//   A. one warp factors the diagonal tile with a 32-column loop in registers
//      and shuffles, giving L_pp and D = L_pp^-1 together (the Pallas
//      kernel's column loop on [A_pp | I]); D replaces A_pp. Meanwhile the
//      other warps move E's column p-1 from scratch into its slots.
//   B. one warp per tile, in place: L_ip = A_ip D^T (a product, not a
//      triangular solve) and the final E_pj = D R_pj for j < p.
//   C. every tile of the rows below the panel, one warp per tile: the
//      trailing update A_ij -= L_ip L_jp^T (j > p), the elimination
//      R_ij -= L_ip E_pj (j < p), and the new E column R_ip = -L_ip D into
//      scratch (slot (i, p) still holds L_ip, which the others read).
// 24 barriers at BK = 256, where the first design took 768. A warp's tile
// product holds an 8 x 4 block of outputs per lane and makes twelve 16-byte
// shared reads per 128 FMA, free of bank conflicts. Accumulation is FP32 on
// the CUDA cores: no TF32 (a single TF32 pass would bring back the
// reference's matmul-precision bias).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, against cuSOLVER (the
// plain version): see PERF.md. Per-phase clocks at BK = 256 put ~1/3 of the
// time in the serial diagonal factorization (A); overlapping it with C
// (lookahead), broadcasting through shared memory instead of shuffles, or
// inverting the diagonal tile after the column loop all measured slower.
//
// A pivot that is <= 0 or NaN sets a flag in shared memory; the block stops
// and writes NaN over all of that matrix's L and E, as the plain version
// (and jnp.linalg.cholesky) gives, so the caller's MLL is NaN and the MH
// step rejects. The other matrices of the batch are untouched.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // panel width and tile edge
constexpr int kLd = kTile + 4;            // row stride of a tile in shared memory
constexpr int kTileWords = kTile * kLd;
constexpr int kMaxTiles = 8;
constexpr int kMaxBk = kTile * kMaxTiles;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }

size_t smem_bytes(int nt) {
  return (size_t)(tri(nt) + nt + 1) * kTileWords * sizeof(float);
}

// slot of the lower tile (i, j), i >= j
__device__ __forceinline__ float* slot(float* s, int i, int j) {
  return s + (tri(i) + j) * kTileWords;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block-wide: start loading tile (ti, tj) of A; outside BK, the identity.
__device__ void load_tile(float* t, const float* a, int bk, int ti, int tj,
                          int tid) {
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    const int gr = ti * kTile + r, gc = tj * kTile + c;
    if (gr < bk && gc < bk) {
      cp_async4(t + r * kLd + c, a + gr * bk + gc);
    } else {
      t[r * kLd + c] = (gr == gc) ? 1.0f : 0.0f;
    }
  }
}

// One warp: store tile t to block (ti, tj) of out, inside BK (coalesced rows).
__device__ void store_tile(float* out, const float* t, int bk, int ti, int tj,
                           int lane) {
  const int gc = tj * kTile + lane;
  if (gc >= bk) return;
  for (int r = 0; r < kTile && ti * kTile + r < bk; ++r) {
    out[(ti * kTile + r) * bk + gc] = t[r * kLd + lane];
  }
}

// A lane's outputs of a warp's tile: rows ry + 4 i; columns cx + 8 u when Y
// is read transposed, 4 cx + u otherwise (each choice free of bank conflicts
// for 16-byte reads along k).
using Acc = float[8][4];

template <bool kTransY>
__device__ __forceinline__ int acc_col(int cx, int u) {
  return kTransY ? cx + 8 * u : 4 * cx + u;
}

template <bool kTransY>
__device__ __forceinline__ void read_acc(Acc& acc, const float* t, int ry, int cx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = t[(ry + 4 * i) * kLd + acc_col<kTransY>(cx, u)];
}

template <bool kTransY>
__device__ __forceinline__ void write_acc(float* t, const Acc& acc, int ry, int cx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) t[(ry + 4 * i) * kLd + acc_col<kTransY>(cx, u)] = acc[i][u];
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc += X Y (or X Y^T with kTransY); subtracted instead with kSub. Four
// steps of k per 16-byte read of each X row (and Y row when transposed).
template <bool kTransY, bool kSub>
__device__ __forceinline__ void tile_mma(Acc& acc, const float* x, const float* y,
                                         int ry, int cx) {
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xv[i] = *reinterpret_cast<const float4*>(x + (ry + 4 * i) * kLd + k);
    }
    float4 yt[4];
    if (kTransY) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        yt[u] = *reinterpret_cast<const float4*>(y + (cx + 8 * u) * kLd + k);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float yv[4];
      if (kTransY) {
#pragma unroll
        for (int u = 0; u < 4; ++u) yv[u] = comp(yt[u], q);
      } else {
        const float4 v = *reinterpret_cast<const float4*>(y + (k + q) * kLd + 4 * cx);
        yv[0] = v.x; yv[1] = v.y; yv[2] = v.z; yv[3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xq = kSub ? -comp(xv[i], q) : comp(xv[i], q);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(xq, yv[u], acc[i][u]);
      }
    }
  }
}

// One warp factors the diagonal tile t (lower part read): lane l holds row l
// of the working tile and of E. Leaves D = L^-1 in t and L in stage, both with
// zeros above the diagonal; returns false if a pivot was not positive.
__device__ bool factor_diag(float* t, float* stage, int lane) {
  float w[kTile], e[kTile];
#pragma unroll
  for (int k = 0; k < kTile; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(t + lane * kLd + k);
    w[k] = v.x; w[k + 1] = v.y; w[k + 2] = v.z; w[k + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < kTile; ++k) e[k] = (k == lane) ? 1.0f : 0.0f;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const float d = __shfl_sync(kFull, w[j], j);
    ok = ok && (d > 0.0f);  // false for NaN too
    const float s = sqrtf(d);
    const float inv = 1.0f / s;
    const float lj = (lane > j) ? w[j] * inv : 0.0f;  // L[lane][j], strict
    w[j] = (lane == j) ? s : lj;
#pragma unroll
    for (int k = 0; k <= j; ++k) e[k] = (lane == j) ? e[k] * inv : e[k];
#pragma unroll
    for (int k = j + 1; k < kTile; ++k) {
      w[k] = fmaf(-lj, __shfl_sync(kFull, lj, k), w[k]);
    }
#pragma unroll
    for (int k = 0; k <= j; ++k) {
      e[k] = fmaf(-lj, __shfl_sync(kFull, e[k], j), e[k]);
    }
  }
  // scalar stores: 16-byte ones here made ptxas spill registers
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    t[lane * kLd + k] = e[k];
    stage[lane * kLd + k] = w[k];
  }
  __syncwarp();
  return ok;
}

__global__ void __launch_bounds__(kThreads, 1)
    chol_inv_kernel(const float* __restrict__ in, float* __restrict__ lout,
                    float* __restrict__ eout, int bk) {
  extern __shared__ float smem[];
  __shared__ int bad;
  const int nt = (bk + kTile - 1) / kTile;
  float* scratch = smem + tri(nt) * kTileWords;  // E's new column, per tile row
  float* stage = scratch + nt * kTileWords;      // L of the diagonal tile
  const long long off = (long long)blockIdx.x * bk * bk;
  const float* a = in + off;
  float* lo = lout + off;
  float* eo = eout + off;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ry = lane / 8, cx = lane % 8;
  if (tid == 0) bad = 0;

  for (int i = 0; i < nt; ++i) load_tile(slot(smem, i, 0), a, bk, i, 0, tid);
  cp_async_commit();
  for (int i = 1; i < nt; ++i) {
    for (int j = 1; j <= i; ++j) load_tile(slot(smem, i, j), a, bk, i, j, tid);
  }
  cp_async_commit();
  // tiles above the diagonal are zero in both outputs
  for (int i = 0; i < nt; ++i) {
    for (int j = i + 1; j < nt; ++j) {
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int gr = i * kTile + e / kTile, gc = j * kTile + e % kTile;
        if (gr < bk && gc < bk) {
          lo[gr * bk + gc] = 0.0f;
          eo[gr * bk + gc] = 0.0f;
        }
      }
    }
  }
  cp_async_wait_all_but_one();
  __syncthreads();

  for (int p = 0; p < nt; ++p) {
    float* d = slot(smem, p, p);
    // A. factor the diagonal tile; the other warps move E's column p-1 home
    if (warp == 0) {
      if (!factor_diag(d, stage, lane) && lane == 0) bad = 1;
      store_tile(lo, stage, bk, p, p, lane);
      store_tile(eo, d, bk, p, p, lane);
    } else if (p > 0) {
      const int words = (nt - p) * kTile * kTile;
      for (int idx = tid - 32; idx < words; idx += kThreads - 32) {
        const int i = p + idx / (kTile * kTile);
        const int rc = idx % (kTile * kTile);
        const int w = (rc / kTile) * kLd + rc % kTile;
        slot(smem, i, p - 1)[w] = scratch[i * kTileWords + w];
      }
    }
    __syncthreads();
    if (bad) break;

    // B. in place, one warp per tile: L_ip = A_ip D^T, E_pj = D R_pj
    for (int job = warp; job < nt - 1; job += kWarps) {
      Acc acc;
      zero_acc(acc);
      const bool panel = job < nt - 1 - p;
      const int ti = panel ? p + 1 + job : p;
      const int tj = panel ? p : job - (nt - 1 - p);
      float* t = slot(smem, ti, tj);
      if (panel) {
        tile_mma<true, false>(acc, t, d, ry, cx);
        __syncwarp();
        write_acc<true>(t, acc, ry, cx);
      } else {
        tile_mma<false, false>(acc, d, t, ry, cx);
        __syncwarp();
        write_acc<false>(t, acc, ry, cx);
      }
      __syncwarp();
      store_tile(panel ? lo : eo, t, bk, ti, tj, lane);
    }
    if (p == 0) cp_async_wait_all();
    __syncthreads();

    // C. every tile (i > p, j <= i), one warp per tile
    const int first = tri(p + 1);
    const int jobs = tri(nt) - first;
    for (int job = warp; job < jobs; job += kWarps) {
      const int s = first + job;
      int i = p + 1;
      while (tri(i + 1) <= s) ++i;
      const int j = s - tri(i);
      const float* li = slot(smem, i, p);
      Acc acc;
      if (j == p) {  // the new column of E: R_ip = -L_ip D
        zero_acc(acc);
        tile_mma<false, true>(acc, li, d, ry, cx);
        write_acc<false>(scratch + i * kTileWords, acc, ry, cx);
      } else if (j > p) {  // trailing update of A
        float* t = slot(smem, i, j);
        read_acc<true>(acc, t, ry, cx);
        tile_mma<true, true>(acc, li, slot(smem, j, p), ry, cx);
        write_acc<true>(t, acc, ry, cx);
      } else {  // elimination of E's row i by row p
        float* t = slot(smem, i, j);
        read_acc<false>(acc, t, ry, cx);
        tile_mma<false, true>(acc, li, slot(smem, p, j), ry, cx);
        write_acc<false>(t, acc, ry, cx);
      }
    }
    __syncthreads();
  }

  cp_async_wait_all();  // still pending only if the first pivot failed
  __syncthreads();
  if (bad) {
    const float nan = __int_as_float(0x7fc00000);
    for (int idx = tid; idx < bk * bk; idx += kThreads) {
      lo[idx] = nan;
      eo[idx] = nan;
    }
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
                               (int)smem_bytes(kMaxTiles));
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  const int nt = (bk + kTile - 1) / kTile;
  chol_inv_kernel<<<g, kThreads, smem_bytes(nt), (cudaStream_t)stream>>>(in, l, e,
                                                                        bk);
  return (int)cudaGetLastError();
}
