// Leaf-agreement counts of a forest, batched over chains (kernel K1).
//
// Replaces the Pallas kernel `_gram_kernel` / `counts_from_leaves_pallas`
// (bark_tpu/ops/pallas_gram.py), and with it the one-hot Gram matmul
// (bark_tpu/forest.py gram_from_leaves) on the sampler's path:
//
//   out[b, i, j] = count_t(l1[b, i, t] == l2[b, j, t]) / m * mask1[i] * mask2[j]
//
// What bounds it on the H100. The function moves its int32 leaf ids in and
// its float32 Gram out: at (64, 200, 200), m = 50, 12.8 MB (one leaves read)
// to 15.4 MB, 3.8-4.6 us at 3.35 TB/s. It does N * M * m compares per chain,
// 128 M there. A compare of two int32 ids costs about 3 instructions, and
// even four ids packed into the bytes of a word cost 5 instructions per 4
// compares (the xor / and / add / and / dp4a zero-byte test): either way the
// SMs' issue rate, not the bytes, would bound the kernel. So the ids are
// bit-sliced, and the compare count per instruction is what the design buys:
//
// - Bit planes. Leaf ids are node slots in [0, node_limit), so P bits hold
//   one (P = 6 for node_limit <= 64, 16 for <= 65536). A
//   32-bit plane word holds bit p of the ids of 32 consecutive trees of one
//   row. Two rows agree on tree t where every plane agrees, so
//   eq &= ~(a_p ^ b_p) over the P planes (one LOP3 each) leaves one bit per
//   agreeing tree, and __popc counts them: P + 2 instructions for 32
//   compares (0.25 per compare at P = 6). Trees past m start cleared in eq,
//   so pads need no special value.
// - A plane pass. Each leaves tensor is sliced once per call by a small
//   kernel, a warp per 8 rows of one 32-tree word: each lane loads one id a
//   row (128 coalesced bytes), P __ballot_sync give the P planes, and lane p
//   writes plane p to a scratch buffer the wrapper allocates, plane-major
//   ([chain, word, plane, row], rows padded to a multiple of 64). A Gram
//   tile then stages its planes with 16-byte copies; no tile converts ids.
// - Register micro-tiles. A block owns a T x T output tile of one chain and
//   each thread an R x R micro-tile (T = 32 with R = 4, T = 16 with R = 2). The planes lie plane-major in shared memory (s[word][plane][row],
//   rows padded by 4 words), so a thread reads a plane of its R rows and of
//   its R columns with two vector loads for R^2 LOP3s. Warps whose rows all
//   lie past the edge skip the compares.
// - Symmetric calls (the sampler passes the same leaves and mask twice): the
//   jobs are the tile pairs ti <= tj; an off-diagonal job writes each value
//   at (i, j) and at (j, i), the mirror computed in the plain version's
//   order (count / m * mask1[j] * mask2[i]), so float masks stay bit-exact.
//   That halves the compares. A job takes its rows from the later tile, so
//   a ragged last tile is on the rows, where whole warps skip it.
// - Epilogue. count / m is read from a table of the m + 1 IEEE quotients
//   that the plane pass writes, then the masks multiply, in the plain
//   version's order; 16-byte (R = 4) or 8-byte stores where the
//   row length allows.
//
// The launch plan (planes, tile, jobs, symmetric flag) is made in Python
// (bark_tpu_torch/ops/gram.py, launch_plan) and passed in whole.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4;     // 32-tree words staged per pass (128 trees)
constexpr int kPlaneRows = 8;  // rows per warp in the plane pass (8 warps a block)
// rows per plane-pass block; plane rows are padded to a multiple of it (and
// so of the largest tile, 32)
constexpr int kRowPad = 8 * kPlaneRows;

struct Leaves {
  const int* ids;  // trees adjacent (tree stride 1)
  long long bs;    // batch stride, in elements
  int rs;          // row stride (the wrapper checks a chain's extent fits an int)
};

// The plane pass: planes[((b * words + w) * P + p) * rows_pad + r] has bit t
// set where bit p of the id of chain b, row r, tree 32 w + t is set (trees
// past m and rows past the end are 0). A block takes kRowPad rows of one
// (b, w), a warp kPlaneRows of them: lane t loads tree 32 w + t of each row
// (128 coalesced bytes a row), P ballots a row give its planes, and lane p
// writes plane p of its rows with 16-byte stores.
template <int P>
__global__ void __launch_bounds__(256)
gram_planes_kernel(Leaves l, int rows, int m, int words, int rows_pad,
                   uint32_t* __restrict__ planes, float* __restrict__ quot) {
  if (quot && blockIdx.x == 0)  // quot[c] = c / m, the IEEE quotient
    for (int c = threadIdx.x; c <= m; c += blockDim.x) quot[c] = (float)c / (float)m;
  constexpr int kRows = kPlaneRows;
  const int chunks = rows_pad / kRowPad;
  const int bw = blockIdx.x / chunks;  // b * words + w
  const int row0 = (blockIdx.x - bw * chunks) * kRowPad + threadIdx.x / 32 * kRows;
  const int b = bw / words;
  const int lane = threadIdx.x % 32;
  const int t = 32 * (bw - b * words) + lane;
  const int* base = l.ids + b * l.bs + t;
  int id[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    id[r] = (t < m && row0 + r < rows) ? __ldg(base + (row0 + r) * l.rs) : 0;
  uint32_t mine[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    mine[r] = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t plane = __ballot_sync(0xFFFFFFFFu, (id[r] >> p) & 1);
      if (lane == p) mine[r] = plane;
    }
  }
  if (lane < P) {
    uint4* dst = reinterpret_cast<uint4*>(planes + ((long long)bw * P + lane) * rows_pad + row0);
#pragma unroll
    for (int v = 0; v < kRows / 4; ++v)
      dst[v] = make_uint4(mine[4 * v], mine[4 * v + 1], mine[4 * v + 2], mine[4 * v + 3]);
  }
}

// Copy the planes of rows [row0, row0 + T) x words [w0, w0 + kw) of chain b
// into s[w][p][r], 16 bytes a thread at a time.
template <int P, int T, int NT>
__device__ __forceinline__ void stage(uint32_t (*s)[P][T + 4], const uint32_t* planes,
                                      int rows_pad, int words, int b, int row0, int w0,
                                      int kw, int tid) {
  constexpr int kVecs = T / 4;  // uint4 per (word, plane)
  for (int i = tid; i < kw * P * kVecs; i += NT) {
    const int v = i % kVecs;
    const int wp = i / kVecs;  // w * P + p
    const uint32_t* src =
        planes + ((long long)(b * words + w0) * P + wp) * rows_pad + row0 + 4 * v;
    *reinterpret_cast<uint4*>(&s[wp / P][wp % P][4 * v]) =
        __ldg(reinterpret_cast<const uint4*>(src));
  }
}

template <int R>
__device__ __forceinline__ void load_words(uint32_t (&v)[R], const uint32_t* p);

template <>
__device__ __forceinline__ void load_words<4>(uint32_t (&v)[4], const uint32_t* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <>
__device__ __forceinline__ void load_words<2>(uint32_t (&v)[2], const uint32_t* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = q.x; v[1] = q.y;
}

// Store v[0..R) at row[j..j+R), the part inside [0, len).
template <int R>
__device__ __forceinline__ void store_row(float* row, int j, int len, const float (&v)[R]) {
  if constexpr (R == 4) {
    if ((len & 3) == 0 && j < len) {
      *reinterpret_cast<float4*>(row + j) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  } else {
    if ((len & 1) == 0 && j < len) {
      *reinterpret_cast<float2*>(row + j) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (j + q < len) row[j + q] = v[q];
}

// Job blockIdx.x: chain b, rows [i0, i0 + T) x columns [j0, j0 + T). A plain
// call walks the tile grid row by row (`cols` tiles a row); a symmetric one
// walks the pairs ti <= tj of its `cols` x `cols` tiles, rows from tj, and
// mirrors the off-diagonal ones.
// The register caps are the tightest without spills (ptxas): 12 blocks of 64
// threads an SM (80 registers) for 6 planes; 16 planes take what they need.
template <int P, int T, int R>
__global__ void __launch_bounds__((T / R) * (T / R), P > 8 ? 1 : 12)
gram_kernel(const uint32_t* __restrict__ planes1, const uint32_t* __restrict__ planes2,
            int rows_pad1, int rows_pad2, const float* __restrict__ quot,
            const float* __restrict__ mask1, long long mask1_bs,
            const float* __restrict__ mask2, long long mask2_bs, float* __restrict__ out,
            int n, int mcols, int m, int symmetric, int tiles, int cols) {
  constexpr int kSide = T / R;
  constexpr int kThreads = kSide * kSide;
  __shared__ __align__(16) uint32_t s1[kChunk][P][T + 4];
  __shared__ __align__(16) uint32_t s2[kChunk][P][T + 4];

  const int b = blockIdx.x / tiles;
  int t = blockIdx.x - b * tiles;
  int i0, j0;
  bool mirror = false;
  if (symmetric) {
    int ti = 0;
    while (t >= cols - ti) {
      t -= cols - ti;
      ++ti;
    }
    i0 = (ti + t) * T;
    j0 = ti * T;
    mirror = t != 0;
  } else {
    i0 = t / cols * T;
    j0 = t % cols * T;
  }

  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid % kSide;
  const int words = (m + 31) / 32;

  // a warp whose rows all lie past the edge skips the compares
  const bool active = i0 + (tid / 32) * (32 / kSide) * R < n;
  int acc[R][R];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int q = 0; q < R; ++q) acc[k][q] = 0;

  for (int w0 = 0; w0 < words; w0 += kChunk) {
    const int kw = min(kChunk, words - w0);
    stage<P, T, kThreads>(s1, planes1, rows_pad1, words, b, i0, w0, kw, tid);
    stage<P, T, kThreads>(s2, planes2, rows_pad2, words, b, j0, w0, kw, tid);
    __syncthreads();
    for (int w = 0; w < (active ? kw : 0); ++w) {
      const int valid = m - 32 * (w0 + w);  // trees in this word
      uint32_t eq[R][R];
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int q = 0; q < R; ++q) eq[k][q] = valid >= 32 ? 0xFFFFFFFFu : (1u << valid) - 1u;
#pragma unroll(P > 8 ? 4 : P)  // 16 planes unrolled whole spill registers
      for (int p = 0; p < P; ++p) {
        uint32_t x[R], y[R];
        load_words<R>(x, &s1[w][p][ty * R]);
        load_words<R>(y, &s2[w][p][tx * R]);
#pragma unroll
        for (int k = 0; k < R; ++k)
#pragma unroll
          for (int q = 0; q < R; ++q) eq[k][q] &= ~(x[k] ^ y[q]);
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int q = 0; q < R; ++q) acc[k][q] += __popc(eq[k][q]);
    }
    __syncthreads();
  }

  // epilogue: count / m, then the row mask, then the column mask
  const int ib = i0 + ty * R;
  const int jb = j0 + tx * R;
  float mi[R], mj[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    mi[k] = (mask1 && ib + k < n) ? mask1[b * mask1_bs + ib + k] : 1.0f;
    mj[k] = (mask2 && jb + k < mcols) ? mask2[b * mask2_bs + jb + k] : 1.0f;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (ib + k >= n) break;
    float v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = __ldg(quot + acc[k][q]) * mi[k] * mj[q];
    store_row<R>(out + ((long long)b * n + ib + k) * mcols, jb, mcols, v);
  }
  if (!mirror) return;
  // the transposed block: out[jc, ir] = count / m * mask1[jc] * mask2[ir]
#pragma unroll
  for (int k = 0; k < R; ++k) {
    mi[k] = (mask2 && ib + k < mcols) ? mask2[b * mask2_bs + ib + k] : 1.0f;
    mj[k] = (mask1 && jb + k < n) ? mask1[b * mask1_bs + jb + k] : 1.0f;
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (jb + q >= n) break;
    float v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = __ldg(quot + acc[k][q]) * mj[q] * mi[k];
    store_row<R>(out + ((long long)b * n + jb + q) * mcols, ib, mcols, v);
  }
}

// The plane pass for each distinct operand, then the Gram tiles.
template <int P, int T, int R>
cudaError_t launch(cudaStream_t stream, const Leaves& l1, const Leaves& l2, uint32_t* planes1,
                   uint32_t* planes2, float* quot, int batch, const float* mask1, long long mask1_bs,
                   const float* mask2, long long mask2_bs, float* out, int n, int mcols, int m,
                   int symmetric, int jobs, int tiles, int cols) {
  const int words = (m + 31) / 32;
  const int pad1 = (n + kRowPad - 1) / kRowPad * kRowPad;
  const int pad2 = (mcols + kRowPad - 1) / kRowPad * kRowPad;
  gram_planes_kernel<P><<<batch * words * (pad1 / kRowPad), 256, 0, stream>>>(
      l1, n, m, words, pad1, planes1, quot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || symmetric == 0) {
    if (err != cudaSuccess) return err;
    gram_planes_kernel<P><<<batch * words * (pad2 / kRowPad), 256, 0, stream>>>(
        l2, mcols, m, words, pad2, planes2, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  gram_kernel<P, T, R><<<jobs, (T / R) * (T / R), 0, stream>>>(
      planes1, symmetric ? planes1 : planes2, pad1, pad2, quot, mask1, mask1_bs, mask2, mask2_bs,
      out, n, mcols, m, symmetric, tiles, cols);
  return cudaGetLastError();
}

}  // namespace

// C entry point. Pointers are device pointers; strides are in elements (a
// chain's rows fit an int; trees are adjacent); a null mask means all ones,
// and a mask batch stride of 0 shares one (N,) mask across the batch.
// planes1 / planes2 are scratch of batch * ceil(m / 32) * planes * (N or M
// rounded up to kRowPad) words (planes2 unused by a symmetric call), quot of m + 1
// floats. The planes
// (6 or 16), tile (32 or 16), symmetric flag, jobs (batch x tiles per
// chain, one block each), tiles per chain and column tiles come from the
// launch plan. Returns the cudaError_t of the launches (0 on success).
extern "C" int bark_gram(const int* l1, long long l1_bs, int l1_rs, const int* l2,
                         long long l2_bs, int l2_rs, uint32_t* planes1, uint32_t* planes2,
                         float* quot,
                         const float* mask1, long long mask1_bs, const float* mask2,
                         long long mask2_bs, float* out, int batch, int n, int mcols, int m,
                         int planes, int tile, int symmetric, int jobs, int tiles, int cols,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (jobs == 0) return 0;
  if (symmetric && n != mcols) return (int)cudaErrorInvalidValue;
  const Leaves a{l1, l1_bs, l1_rs};
  const Leaves c{l2, l2_bs, l2_rs};
  cudaStream_t s = (cudaStream_t)stream;
#define BARK_GRAM_CASE(P, T, R)                                                         \
  if (planes == P && tile == T)                                                         \
    return (int)launch<P, T, R>(s, a, c, planes1, planes2, quot, batch, mask1, mask1_bs, mask2, \
                                mask2_bs, out, n, mcols, m, symmetric, jobs, tiles, cols);
  BARK_GRAM_CASE(6, 32, 4)
  BARK_GRAM_CASE(6, 16, 2)
  BARK_GRAM_CASE(16, 32, 4)
  BARK_GRAM_CASE(16, 16, 2)
#undef BARK_GRAM_CASE
  return (int)cudaErrorInvalidValue;
}

// Message for an error code returned by the entry points.
extern "C" const char* bark_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
