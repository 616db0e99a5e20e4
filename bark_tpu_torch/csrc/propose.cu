// The proposal batch (kernel K4): every (chain, tree) grow/prune/change
// proposal of a sampler step and its new leaves, in one launch.
//
// Replaces no Pallas kernel: the reference leaves the batch to XLA
// (`_propose_all_trees`, bark_tpu/fitting/sampler.py, over
// `propose_tree_packed` of bark_tpu/fitting/proposals.py). Its torch form
// (`fitting/sampler._propose_torch`, the twin: `propose_tree_packed`
// under `subspace_mode="walk"`, then `_incremental_leaves`) launches ~900
// small elementwise and gather kernels a step and syncs with the host 5
// times, and the step is bound by the host's launch rate. The device's work
// is tiny: at 64 chains x 50 trees of 64 slots and N = 50 the batch reads
// and writes ~16 MB (every tree copied into the proposed forest, the noise,
// the leaves), ~5 us at 3.35 TB/s. So the kernel is bound by latency: a
// short serial walk per tree, hidden behind thousands of independent
// trees.
//
// Per pair (chain c, tree j), with the packed tree (node_limit rows of 8
// int32: is_leaf, feature, threshold bits, left, right, parent, depth,
// active), its ProposalNoise draws, and the constants as launch arguments
// (the normalised move cdf, alpha, log alpha and beta in float32, max_depth):
//   move:  (u_move >= cdf0) + (u_move >= cdf1): grow 0, prune 1, change 2;
//   node:  the Gumbel argmax of g_node over the terminal nodes (grow) or
//          the singly-internal ones (prune, change); the first index on a
//          tie, 0 on an empty set, as `masked_choice_gumbel`;
//   split: a feature from u_feat, its bounds at the node by the walk of
//          `node_subspace_packed` (at most max_depth parents, the
//          categorical complement against the next power of two of the
//          current upper bound), then `_sample_split_from_bounds`: the
//          categorical rank scattered into the available mask, the integer
//          draw, the continuous lb + u (ub - lb) in float64 rounded once;
//   log q: the transition ratio from the terminal and singly-internal
//          counts and the depth-prior ratio, float32 in the twin's order
//          (-inf on a reject: empty set, degenerate split, full tree, node
//          at the depth cap, which leave the tree as it was);
//   edit:  the grow's two fresh slots (the first two inactive) and parent
//          row, the prune's children deactivated, the change's rule;
//   leaves: each point's leaf under the proposed tree from its current
//          leaf, as `_incremental_leaves` (the split's categorical bit test
//          or x <= threshold), written with the current leaves transposed.
// The same formulas, guards and order as the twin; every output but
// log q is bit-identical with it, and log q differs at most by the
// rounding of logf and powf.
//
// Design: one warp a pair, a block of 32 threads, so 3,200 pairs are 3,200
// blocks, resident at once (32 a multiprocessor) with nothing to wait for
// between them. The block copies its tree into shared memory with 16-byte
// loads (2 KB at 64 slots, 32 KB at the largest, 1,024). Every lane then
// forms the masks of its slots; ballots and popcounts give the counts, the
// first two inactive slots (find-first-set) and the valid set, and a
// shuffle butterfly the Gumbel argmax, so all 32 lanes hold the same
// decision with no broadcast. The walk follows one feature only: the twin
// intersects each feature's bounds on its own and reads only the drawn
// feature's (lb, ub), so two scalars per trip through shared memory give
// its bits (every lane walks alike; the reads broadcast). A prune reads no
// bounds and skips it. Lane 0 edits the shared tree, the warp stores it
// with 16-byte stores and strides over the N points for the leaves. N is
// only a loop bound and node_limit one of the mask loop, so one launch
// serves every N (the dense tier, the BO buckets, the leaf tier) and every
// node_limit up to 1,024.
//
// Precision: the bounds and X in their own type (float32 or float64, a
// template each, as the twin promotes), the log ratio in float32, with
// `__f*_rn` intrinsics where the twin rounds each operation on its own, so
// that no product is contracted into a fused multiply-add the twin does
// not make.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxNodes = 1024;
constexpr int kCat = 0, kInt = 1;          // FEAT_CAT, FEAT_INT
constexpr int kGrow = 0, kPrune = 1;       // GROW, PRUNE
constexpr int kCatBits = 25;               // MAX_CATEGORIES + 1: the bits `fitting/bits` scans
constexpr unsigned kFull = 0xffffffffu;

// torch's left shift: 0 for a shift below 0 or of 32 and more
__device__ __forceinline__ int shl(int a, int s) {
  return (s < 0 || s >= 32) ? 0 : (int)((unsigned)a << s);
}

// bits.next_power_of_2: 1 << (the number of k < 25 with 1 << k <= x)
__device__ __forceinline__ int next_pow2(int x) {
  return 1 << (x >= 1 ? min(32 - __clz(x), kCatBits) : 0);
}

// bits.scatter_bits: the low bits of r, in order, into the set bits of the
// low 25 of mask; 0 where the mask has fewer than two bits (c < 2)
__device__ __forceinline__ int scatter_bits(int r, int mask, int c) {
  int out = 0, rank = 0;
  for (int i = 0; i < kCatBits; ++i) {
    if ((mask >> i) & 1) {
      if ((r >> rank) & 1) out |= 1 << i;
      ++rank;
    }
  }
  return c < 2 ? 0 : out;
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// torch.minimum / torch.maximum: a NaN operand wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ double nan_min(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}

// torch.pow(float32 tensor, beta): its exponents 2, 3 and 0.5 by products
// and a square root, any other through powf
__device__ __forceinline__ float pow_beta(float x, float beta) {
  if (beta == 2.0f) return __fmul_rn(x, x);
  if (beta == 3.0f) return __fmul_rn(__fmul_rn(x, x), x);
  if (beta == 0.5f) return __fsqrt_rn(x);
  return powf(x, beta);
}

__device__ __forceinline__ bool leaf_at(const int* t, int s, int nl) {
  return (unsigned)s < (unsigned)nl && t[s * 8] != 0;
}

// an active decision node whose both children are leaves
__device__ __forceinline__ bool singly_internal(const int* t, int s, int nl) {
  if ((unsigned)s >= (unsigned)nl) return false;
  const int* row = t + s * 8;
  return row[7] != 0 && row[0] == 0 && leaf_at(t, row[3], nl) && leaf_at(t, row[4], nl);
}

// one trip of `traversal._walk_bounds` for the drawn feature: the parent's
// split (thr, the side) narrows (lo, hi)
template <typename TB>
__device__ __forceinline__ void walk_trip(TB& lo, TB& hi, float thr, bool is_left, int ftype) {
  if (ftype == kCat) {
    const int thr_i = (int)thr, ub_i = (int)hi;
    hi = (TB)(is_left ? (thr_i & ub_i) : ((next_pow2(ub_i) - 1 - thr_i) & ub_i));
  } else if (is_left) {
    hi = nan_min((TB)thr, hi);
  } else {
    lo = nan_max(add_rn((TB)thr, ftype == kInt ? (TB)1 : (TB)0), lo);
  }
}

// `proposals._sample_split_from_bounds` for one feature of type ftype
template <typename TB>
__device__ __forceinline__ TB draw_split(TB lb, TB ub, int ftype, float u_cat, float u_int,
                                         float u_cont) {
  if (ftype == kCat) {
    const int mask = (int)ub, c = __popc(mask);
    const int span = max(shl(1, c) - 1 - 1, 1);
    const int r = 1 + min((int)__fmul_rn(u_cat, (float)span), span - 1);
    return (TB)scatter_bits(r, mask, c);
  }
  if (ftype == kInt) {
    const int lb_i = (int)lb, ub_i = (int)ub;
    const int draw =
        lb_i + min((int)__fmul_rn(u_int, (float)(ub_i - lb_i)), max(ub_i - lb_i - 1, 0));
    return (TB)(lb_i == ub_i ? ub_i : draw);
  }
  // u (ub - lb) is exact in float64 for float32 bounds, so the sum rounds once
  return (TB)__dadd_rn((double)lb, __dmul_rn((double)u_cont, (double)sub_rn(ub, lb)));
}

struct Constants {
  float cdf0, cdf1, alpha, log_alpha, beta;
  int max_depth;
};

template <typename TB, typename TX>
__global__ void __launch_bounds__(kThreads)
propose_kernel(const int4* __restrict__ packed, const float* __restrict__ u_move,
               const float* __restrict__ g_node, const float* __restrict__ u_feat,
               const float* __restrict__ u_cat, const float* __restrict__ u_int,
               const float* __restrict__ u_cont, const TB* __restrict__ bounds,
               const int* __restrict__ feat_types, const TX* __restrict__ X,
               const int* __restrict__ leaves, long long ls_c, long long ls_n, long long ls_m,
               int4* __restrict__ new_packed, float* __restrict__ log_q_out,
               int* __restrict__ move_out, int* __restrict__ node_out,
               int* __restrict__ cur_out, int* __restrict__ new_out, int m, int nl, int d,
               int n_pts, Constants k) {
  extern __shared__ int4 tree4[];
  int* t = reinterpret_cast<int*>(tree4);
  const int b = blockIdx.x, lane = threadIdx.x;
  const int chain = b / m, j = b - chain * m;

  const int4* src = packed + (size_t)b * nl * 2;
  for (int i = lane; i < 2 * nl; i += kThreads) tree4[i] = src[i];
  __syncwarp();

  const float um = u_move[b];
  const int move = (um >= k.cdf0 ? 1 : 0) + (um >= k.cdf1 ? 1 : 0);
  const bool grow = move == kGrow, prune = move == kPrune;

  // the masks, slot s = base + lane; every lane ends with the same counts
  const float* g = g_node + (size_t)b * nl;
  int n_term = 0, n_si = 0, n_valid = 0, n_free = 0, i1 = -1, i2 = -1;
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int base = 0; base < nl; base += kThreads) {
    const int s = base + lane;
    bool term = false, si = false, free_slot = false;
    if (s < nl) {
      const int* row = t + s * 8;
      term = row[7] != 0 && row[0] != 0;
      si = singly_internal(t, s, nl);
      free_slot = row[7] == 0;
    }
    const bool valid = grow ? term : si;
    const unsigned bt = __ballot_sync(kFull, term), bs = __ballot_sync(kFull, si);
    const unsigned bv = __ballot_sync(kFull, valid), bf = __ballot_sync(kFull, free_slot);
    n_term += __popc(bt);
    n_si += __popc(bs);
    n_valid += __popc(bv);
    n_free += __popc(bf);
    if (bf != 0u) {
      if (i1 < 0) {
        i1 = base + __ffs(bf) - 1;
        const unsigned rest = bf & (bf - 1u);
        if (rest != 0u) i2 = base + __ffs(rest) - 1;
      } else if (i2 < 0) {
        i2 = base + __ffs(bf) - 1;
      }
    }
    if (valid) {  // a lane's slots in ascending order: the first maximum stays
      const float v = g[s];
      if (v > best) {
        best = v;
        best_i = s;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {  // the larger value, then the lower slot
    const float ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  const int node = best_i == 0x7fffffff ? 0 : best_i;  // argmax of all -inf: slot 0
  i1 = max(i1, 0);
  i2 = max(i2, 0);

  const int* row_n = t + node * 8;
  const int l_old = row_n[3], r_old = row_n[4], parent_n = row_n[5], depth_n = row_n[6];
  const int feat = min((int)__fmul_rn(u_feat[b], (float)d), d - 1);
  const int ftype = feat_types[feat];

  TB thr = (TB)0;
  bool invalid_split = false;
  if (!prune) {  // a prune draws no split
    TB lo = bounds[2 * feat], hi = bounds[2 * feat + 1];
    int at = node;
    for (int trip = 0; trip < k.max_depth && at != 0; ++trip) {
      const int parent = t[at * 8 + 5];
      if ((unsigned)parent >= (unsigned)nl) break;
      const int* prow = t + parent * 8;
      if (prow[1] == feat) walk_trip(lo, hi, __int_as_float(prow[2]), at == prow[3], ftype);
      at = parent;
    }
    thr = draw_split(lo, hi, ftype, u_cat[b], u_int[b], u_cont[b]);
    invalid_split = (ftype == kCat && thr == (TB)0) || (ftype == kInt && thr == hi);
  }
  const bool reject = n_valid == 0 || (!prune && invalid_split) ||
                      (grow && (n_free < 2 || depth_n + 1 > k.max_depth));

  float log_q = -CUDART_INF_F;
  if (!reject) {
    float q = 0.0f, pr = 0.0f;
    if (grow || prune) {
      const float w0 = (float)n_term, w1 = (float)n_si;
      if (grow) {
        const bool parent_was_si = node != 0 && singly_internal(t, parent_n, nl);
        const float w1_star = __fsub_rn(__fadd_rn(w1, 1.0f), parent_was_si ? 1.0f : 0.0f);
        q = __fsub_rn(logf(w0), logf(w1_star));
      } else {
        q = __fsub_rn(logf(w1), logf(fmaxf(__fsub_rn(w0, 1.0f), 1.0f)));
      }
      // log alpha + 2 log(1 - alpha / (2 + d)^beta) - log((1 + d)^beta - alpha)
      const float df = (float)depth_n;
      const float a = __fmul_rn(__frcp_rn(pow_beta(__fadd_rn(df, 2.0f), k.beta)), k.alpha);
      const float s1 = __fadd_rn(k.log_alpha, __fmul_rn(logf(__fsub_rn(1.0f, a)), 2.0f));
      pr = __fsub_rn(s1, logf(__fsub_rn(pow_beta(__fadd_rn(df, 1.0f), k.beta), k.alpha)));
      if (prune) pr = -pr;
    }
    log_q = __fadd_rn(q, pr);
  }

  __syncwarp();  // every lane has read the tree as it was
  if (lane == 0) {
    if (!reject) {
      if (grow) {
        const int child[8] = {1, 0, 0, 0, 0, node, depth_n + 1, 1};
        const int par[8] = {0, feat, __float_as_int((float)thr), i1, i2, parent_n, depth_n, 1};
        for (int q = 0; q < 8; ++q) t[i1 * 8 + q] = child[q];
        for (int q = 0; q < 8; ++q) t[i2 * 8 + q] = child[q];
        for (int q = 0; q < 8; ++q) t[node * 8 + q] = par[q];
      } else if (prune) {
        t[l_old * 8 + 7] = 0;
        t[r_old * 8 + 7] = 0;
        t[node * 8] = 1;
      } else {
        t[node * 8 + 1] = feat;
        t[node * 8 + 2] = __float_as_int((float)thr);
      }
    }
    log_q_out[b] = log_q;
    move_out[b] = move;
    node_out[b] = node;
  }
  __syncwarp();

  int4* dst = new_packed + (size_t)b * nl * 2;
  for (int i = lane; i < 2 * nl; i += kThreads) dst[i] = tree4[i];

  // the leaves under the proposed tree, from the node's row after the edit
  const int* row_new = t + node * 8;
  const int f_new = min(max(row_new[1], 0), d - 1);
  const bool is_cat = feat_types[f_new] == kCat;
  const float thr_new = __int_as_float(row_new[2]);
  const int thr_new_i = (int)thr_new, to_left = row_new[3], to_right = row_new[4];
  const int* lv = leaves + chain * ls_c + j * ls_m;
  int* cur_dst = cur_out + (size_t)b * n_pts;
  int* new_dst = new_out + (size_t)b * n_pts;
  for (int i = lane; i < n_pts; i += kThreads) {
    const int cur = lv[i * ls_n];
    const TX x = X[(size_t)i * d + f_new];
    const bool left = is_cat ? (shl(1, min(max((int)x, 0), 31)) & thr_new_i) != 0
                             : x <= (TX)thr_new;
    const int split_to = left ? to_left : to_right;
    const bool at_children = cur == l_old || cur == r_old;
    int nv;
    if (grow) {
      nv = cur == node ? split_to : cur;
    } else if (prune) {
      nv = at_children ? node : cur;
    } else {
      nv = at_children ? split_to : cur;
    }
    cur_dst[i] = cur;
    new_dst[i] = nv;
  }
}

// the C entry's arguments, as the kernel takes them but for the type of
// the bounds and of X
struct Args {
  const void* packed;
  const float *u_move, *g_node, *u_feat, *u_cat, *u_int, *u_cont;
  const void* bounds;
  const int* feat_types;
  const void* X;
  const int* leaves;
  long long ls_c, ls_n, ls_m;
  void* new_packed;
  float* log_q;
  int *move, *node, *cur_leaves, *new_leaves;
  int m, nl, d, n;
};

template <typename TB, typename TX>
cudaError_t launch(const Args& a, const Constants& k, int pairs, cudaStream_t stream) {
  propose_kernel<TB, TX><<<pairs, kThreads, (size_t)a.nl * 8 * sizeof(int), stream>>>(
      static_cast<const int4*>(a.packed), a.u_move, a.g_node, a.u_feat, a.u_cat, a.u_int,
      a.u_cont, static_cast<const TB*>(a.bounds), a.feat_types, static_cast<const TX*>(a.X),
      a.leaves, a.ls_c, a.ls_n, a.ls_m, static_cast<int4*>(a.new_packed), a.log_q, a.move,
      a.node, a.cur_leaves, a.new_leaves, a.m, a.nl, a.d, a.n, k);
  return cudaGetLastError();
}

}  // namespace

// C entry point: device pointers to int32 packed (c, m, nl, 8) (16-byte
// aligned), float32 u_move, u_feat, u_cat, u_int, u_cont (c, m) and g_node
// (c, m, nl), bounds (d, 2) and X (n, d) in float32 or float64 (flags
// bounds_f64, x_f64), int32 feat_types (d,), int32 leaves (c, n, m) with
// element strides ls_*; writes new_packed (c, m, nl, 8), log_q (c, m)
// float32, move and node (c, m) int32, the current and proposed leaves
// (c, m, n) int32. Returns the cudaError_t of the launch (0 on success).
extern "C" int bark_propose(const void* packed, const float* u_move, const float* g_node,
                            const float* u_feat, const float* u_cat, const float* u_int,
                            const float* u_cont, const void* bounds, const int* feat_types,
                            const void* X, const int* leaves, long long ls_c, long long ls_n,
                            long long ls_m, void* new_packed, float* log_q, int* move,
                            int* node, int* cur_leaves, int* new_leaves, int c, int m, int nl,
                            int d, int n, int max_depth, float cdf0, float cdf1, float alpha,
                            float log_alpha, float beta, int bounds_f64, int x_f64,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (c < 0 || m < 1 || nl < 1 || nl > kMaxNodes || d < 1 || n < 0 || max_depth < 0)
    return (int)cudaErrorInvalidValue;
  if (c == 0) return 0;
  const Constants k{cdf0, cdf1, alpha, log_alpha, beta, max_depth};
  const Args a{packed, u_move, g_node, u_feat, u_cat, u_int, u_cont, bounds, feat_types, X,
               leaves, ls_c, ls_n, ls_m, new_packed, log_q, move, node, cur_leaves, new_leaves,
               m, nl, d, n};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bounds_f64) {
    err = x_f64 ? launch<double, double>(a, k, c * m, s) : launch<double, float>(a, k, c * m, s);
  } else {
    err = x_f64 ? launch<float, double>(a, k, c * m, s) : launch<float, float>(a, k, c * m, s);
  }
  return (int)err;
}
