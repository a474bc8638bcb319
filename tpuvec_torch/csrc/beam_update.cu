// Level-0 HNSW beam search on the card: one beam iteration for B queries
// (beam_update_kernel), and the whole level-0 loop of a query batch in one
// launch (beam_search_level0_kernel). Both run the same iteration step, the
// __device__ functions dedup / merge / frontier below, on a beam and a
// window held in shared memory.
//
// Replaces the Pallas TPU kernel tpuvec/ops/pallas_beam.py:beam_update
// (pallas_call at :144, body _beam_update_math at :45-107) and, in the loop
// kernel, the XLA while_loop around it, tpuvec/index/search.py:336-357
// (body_p / cond_p: the adjacency gather, _gather_vecs and _node_dist at
// :52-68, gathered_internal at tpuvec/ops/distance.py:179-213). The
// contracts are in tpuvec_torch/ops/beam.py, whose beam_update_plain and
// beam_loop_plain are the plain versions.
//
// The iteration step (S = EF + W entries; one block of kThreads per query):
//   1. dedup: one warp per window entry; its lanes stride over the beam ids
//      (and, with E > 1, the earlier window ids) and combine with
//      __any_sync. All fresh flags are computed before a barrier and the
//      masking ((+inf, -1) for duplicates and ids < 0) comes after it, so no
//      warp reads an id that another has already masked.
//   2. merge, stable and O(S log S): the W window entries are ranked among
//      themselves by (distance, position) with W^2 compares in shared memory
//      (W <= 64 on the main path). Beam entry j goes to slot
//      j + #{window w : d_w < d_j}, a binary search over the sorted window;
//      window entry w to slot wrank(w) + #{beam j : d_j <= d_w}, a binary
//      search over the beam, which is sorted ascending by contract. That is
//      the stable sort of beam ++ window, ties included (beam before window,
//      the window in its order), so it equals beam_update_plain bit for bit.
//   3. frontier: warp ballots turn the unexpanded flags into bit words; each
//      thread ranks its own slot by a popcount prefix over the words, so the
//      first E unexpanded slots are selected in parallel. `active` is the
//      definition of ops/beam.py:frontier.
//
// beam_update_kernel is load -> step -> store. Its bound: per launch it
// reads beam_d, beam_i, beam_x, nbrs, nd and writes the three beam arrays,
// cand and active once, B * (18*EF + 8*W + 4*E + 1) bytes, against 3.35 TB/s:
// 0.11 us at the search shape (B=256, EF=64, W=32, E=1), 1.6 us at the
// construction shape (B=1024, EF=256, W=64, E=2).
//
// beam_search_level0_kernel runs the whole level-0 loop of one query in one
// block. The query row, the beam and the window live in shared memory. Each
// iteration reads the E frontier adjacency rows of adj0 (ids < 0 give a
// window of -1), dedups the window, and only then reads the vector rows of
// the fresh entries: warps take the fresh rows in turn and read each with
// 16-byte loads, kRowChunk loads per lane issued before any is reduced, so a
// row's loads are in flight together. Then the shared step. A query stops
// when it is inactive or has run max_iters iterations.
//
// The kernel is a template on the row form (F32Rows, Int8Rows, WordRows
// below; ops/beam.py:_loop_form picks one from the rows' dtype and the
// metric). Each reads a row as 16-byte vectors and computes the JAX
// package's internal distance (tpuvec/ops/distance.py:gathered_internal):
//   f32 rows (Dp a multiple of 4): |q|^2 + |n|^2 - 2 q.n clamped at 0 (L2
//     and normalized cosine), sum |q - n| (L1), or 1 - q.n / (|q| |n|)
//     (cosine of unnormalized rows), in float32;
//   int8 rows (Dp a multiple of 16; 128 in the index): the same three forms
//     on exact int32 sums, q.n and |n|^2 by __dp4a and L1 by __vabsdiffs4,
//     so squared L2 is the integer sum((q - n)^2) that the JAX package
//     accumulates in int32, cast to float once at the end;
//   packed bit words (int32 holding uint32 bits, Dp words a multiple of 4;
//     8 in the index): Hamming, the sum of __popc(q ^ n), cast to float.
// Integer distances are exact, so on int8 (squared L2, L1) and word rows
// the kernel equals beam_loop_plain bit for bit; float sums run in another
// order than the plain loop's bmm.
//
// Each row form also has a masked form (template flag kMasked), the filtered
// search: the JAX package's body_m and its post-loop dedup and sort
// (tpuvec/index/search.py:295-316 and :363-383), which that package runs in
// XLA, not Pallas. The beam and the frontier run exactly as in the unmasked
// form. A second buffer of KP slots (Results, in shared memory after the
// Step's arrays, seeded by the caller) collects the nodes that pass the
// node mask: each iteration, before the beam's merge, the fresh window is
// copied with every entry whose mask byte is 0 set to (+inf, -1), and the
// same stable merge (buffer before window) keeps the KP smallest. The mask
// is one byte a node, shared by the batch and read with __ldg: at 1M nodes
// it is 1 MB, so it stays in the 50 MB L2. The buffer is not deduplicated
// inside the loop (a node evicted from the beam and met again is collected
// twice, as in the JAX package); after the loop each block keeps the first
// occurrence of each id and writes the KP slots ranked by (distance,
// position), the stable sort. The flag is a template parameter so that the
// unmasked forms compile as before: under __launch_bounds__(256, 4) every
// form is held at 64 registers, and any code the unmasked forms do not run
// stays out of them.
//
// Why a per-block loop equals the lock-step loops of the JAX package and of
// beam_loop_plain: those advance the whole batch until every query is
// inactive or the batch has run max_iters iterations. An inactive query's
// window is all -1, so its update is a fixed point (the beam, the flags and
// `active` stay as they are; test_inactive_query_is_a_fixed_point), and a
// query that goes inactive stays inactive. The iteration cap counts the
// same iterations for every query. So each query's final beam is the beam
// after min(its first inactive iteration, max_iters) updates, whether the
// batch runs together or every query runs alone, and the per-query count of
// iterations run is the number of updates that query made while active.
//
// Bound of the loop kernel: bytes. What it must move is the distinct vector
// and adjacency rows that the batch's loop reads, each once, plus q and the
// beams in and out. A query against W rows is a matrix-vector product, so
// tensor cores do not serve it, and the few FLOPs per byte keep it far from
// the float32 rate; int8 and word rows move 4x and 32x fewer bytes a row
// for the same work (a word row is 128 B at 1024 dims, an adjacency row
// of 32 ids also 128 B). The launch has one block per query: B=256 (search) is
// about 2 blocks per SM of the 132, B=1024 (construction) about 8. The
// chain of two dependent reads per iteration (adjacency, then vectors), and
// the step's barriers, set the time of an iteration. Later work: prefetch
// the next frontier's adjacency rows, run several queries per block, TMA
// row loads into a shared-memory ring, and clusters.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxE = 64;
constexpr int kRowChunk = 8;  // 16-byte loads of a row in flight per lane

// distance forms of the loop kernel (ops/beam.py:_loop_form)
constexpr int kSqL2 = 0;
constexpr int kL1 = 1;
constexpr int kCosine = 2;
constexpr int kHamming = 3;

// row forms of the loop kernel (ops/beam.py:_ROWS)
constexpr int kRowsF32 = 0;
constexpr int kRowsInt8 = 1;
constexpr int kRowsWords = 2;

// One query's beam and window in shared memory.
struct Step {
  float* d;          // [EF] beam in, ascending
  int32_t* i;        // [EF]
  uint8_t* x;        // [EF] expanded
  float* od;         // [EF] beam out
  int32_t* oi;       // [EF]
  uint8_t* ox;       // [EF]
  float* wd;         // [W] window distances
  int32_t* wi;       // [W] window ids
  float* sorted_wd;  // [W] window distances, ascending
  int32_t* wrank;    // [W] rank of each window entry
  int32_t* flist;    // [W] positions of the fresh window entries
  uint32_t* words;   // [ceil(max(EF, W) / 32)] ballot words
  int32_t* cand;     // [E] next frontier
  int32_t* active;   // [1]
  unsigned char* qq; // [1] |q|^2, in the row form's accumulator type
  uint8_t* fresh;    // [W]
};

__host__ __device__ inline unsigned char* take(unsigned char* base, size_t* off, size_t bytes) {
  unsigned char* p = base ? base + *off : nullptr;
  *off += bytes;
  return p;
}

// Carves the shared memory: the query row (row_bytes, rounded up to 16) first,
// so it and what follows stay 16-byte aligned, then the 4-byte arrays, then
// the byte arrays. Returns the bytes needed; fills `s` and `q` when `base`
// is not null.
__host__ __device__ size_t layout(unsigned char* base, int ef, int w, int e,
                                  size_t row_bytes, Step* s, unsigned char** q) {
  const size_t n_words = ((ef > w ? ef : w) + 31) / 32;
  size_t off = 0;
  unsigned char* sq = take(base, &off, (row_bytes + 15) / 16 * 16);
  Step t;
  t.d = reinterpret_cast<float*>(take(base, &off, 4 * ef));
  t.od = reinterpret_cast<float*>(take(base, &off, 4 * ef));
  t.i = reinterpret_cast<int32_t*>(take(base, &off, 4 * ef));
  t.oi = reinterpret_cast<int32_t*>(take(base, &off, 4 * ef));
  t.wd = reinterpret_cast<float*>(take(base, &off, 4 * w));
  t.wi = reinterpret_cast<int32_t*>(take(base, &off, 4 * w));
  t.sorted_wd = reinterpret_cast<float*>(take(base, &off, 4 * w));
  t.wrank = reinterpret_cast<int32_t*>(take(base, &off, 4 * w));
  t.flist = reinterpret_cast<int32_t*>(take(base, &off, 4 * w));
  t.words = reinterpret_cast<uint32_t*>(take(base, &off, 4 * n_words));
  t.cand = reinterpret_cast<int32_t*>(take(base, &off, 4 * e));
  t.active = reinterpret_cast<int32_t*>(take(base, &off, 4));
  t.qq = take(base, &off, 4);
  t.x = take(base, &off, ef);
  t.ox = take(base, &off, ef);
  t.fresh = take(base, &off, w);
  if (base) {
    *s = t;
    if (q) *q = sq;
  }
  return off;
}

// The masked loop kernel's result buffer, carved after the Step's arrays.
struct Results {
  float* d;    // [KP] buffer in, ascending
  int32_t* i;  // [KP]
  float* od;   // [KP] buffer out
  int32_t* oi; // [KP]
  float* wd;   // [W] window distances, +inf where the node fails the mask
  int32_t* wi; // [W] window ids, -1 where the node fails the mask
};

// Carves the Results at byte `off` (rounded up to 16) of the shared
// memory; returns the bytes needed in all, and fills `r` when `base` is not
// null.
__host__ __device__ size_t layout_results(unsigned char* base, size_t off, int kp, int w,
                                          Results* r) {
  off = (off + 15) / 16 * 16;
  Results t;
  t.d = reinterpret_cast<float*>(take(base, &off, 4 * kp));
  t.od = reinterpret_cast<float*>(take(base, &off, 4 * kp));
  t.i = reinterpret_cast<int32_t*>(take(base, &off, 4 * kp));
  t.oi = reinterpret_cast<int32_t*>(take(base, &off, 4 * kp));
  t.wd = reinterpret_cast<float*>(take(base, &off, 4 * w));
  t.wi = reinterpret_cast<int32_t*>(take(base, &off, 4 * w));
  if (base) *r = t;
  return off;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// words[r / 32] bit r % 32 = flag(r), for r < n. The loop bound is the
// same for every thread, so every lane of a warp reaches the ballot.
template <class Flag>
__device__ __forceinline__ void ballot_words(uint32_t* words, int n, Flag flag) {
  for (int r0 = 0; r0 < n; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    const bool f = r < n && flag(r);
    const uint32_t bits = __ballot_sync(0xffffffffu, f);
    if (lane_id() == 0 && r < n) words[r >> 5] = bits;
  }
}

// Number of set bits before position r.
__device__ __forceinline__ int bits_before(const uint32_t* words, int r) {
  int c = 0;
  for (int k = 0; k < (r >> 5); ++k) c += __popc(words[k]);
  return c + __popc(words[r >> 5] & ((1u << (r & 31)) - 1u));
}

__device__ __forceinline__ int count_less(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_less_equal(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// 1. dedup of the window (s.wi) against the beam ids (s.i) and, with
//    E > 1, the earlier window ids. Non-fresh entries become (+inf, -1).
__device__ void dedup(const Step& s, int ef, int w, int e) {
  const int lane = lane_id();
  for (int j = warp_id(); j < w; j += kWarps) {
    const int32_t id = s.wi[j];  // the same for the whole warp
    bool hit = false;
    if (id >= 0) {
      for (int k = lane; k < ef; k += 32) hit |= s.i[k] == id;
      if (e > 1) {
        for (int k = lane; k < j; k += 32) hit |= s.wi[k] == id;
      }
    }
    hit = __any_sync(0xffffffffu, hit);
    if (lane == 0) s.fresh[j] = (id >= 0 && !hit) ? 1 : 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    if (!s.fresh[j]) {
      s.wd[j] = INFINITY;
      s.wi[j] = -1;
    }
  }
  __syncthreads();
}

// 2. stable merge of the beam (s.d, s.i, s.x) and the window (s.wd, s.wi)
//    into the EF smallest (s.od, s.oi, s.ox); +inf slots marked expanded.
//    kFlags false: the expanded flags are neither read nor written (the
//    masked form's result buffer, which has none).
template <bool kFlags = true>
__device__ void merge(const Step& s, int ef, int w) {
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const float dj = s.wd[j];
    int r = 0;
    for (int k = 0; k < w; ++k) {
      const float dk = s.wd[k];
      r += (dk < dj) || (dk == dj && k < j);
    }
    s.wrank[j] = r;
    s.sorted_wd[r] = dj;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ef; j += blockDim.x) {
    const float dj = s.d[j];
    const int slot = j + count_less(s.sorted_wd, w, dj);
    if (slot < ef) {
      s.od[slot] = dj;
      s.oi[slot] = s.i[j];
      if constexpr (kFlags) s.ox[slot] = (s.x[j] || !isfinite(dj)) ? 1 : 0;
    }
  }
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const float dj = s.wd[j];
    const int slot = s.wrank[j] + count_less_equal(s.d, ef, dj);
    if (slot < ef) {
      s.od[slot] = dj;
      s.oi[slot] = s.wi[j];
      if constexpr (kFlags) s.ox[slot] = isfinite(dj) ? 0 : 1;
    }
  }
  __syncthreads();
}

// 3. the next frontier of the merged beam: the first E unexpanded slots,
//    selected (and marked expanded) only when the query is active.
__device__ void frontier(const Step& s, int ef, int e) {
  ballot_words(s.words, ef, [&](int r) { return !s.ox[r] && isfinite(s.od[r]); });
  __syncthreads();
  const int n_words = (ef + 31) >> 5;
  int first = -1, total = 0;
  for (int k = 0; k < n_words; ++k) {
    const uint32_t bits = s.words[k];
    if (first < 0 && bits) first = k * 32 + __ffs(bits) - 1;
    total += __popc(bits);
  }
  const float best = first >= 0 ? s.od[first] : INFINITY;
  const float worst = s.od[ef - 1];
  const bool act = isfinite(best) && (best <= worst || !isfinite(worst));
  if (act) {
    for (int r = threadIdx.x; r < ef; r += blockDim.x) {
      if ((s.words[r >> 5] >> (r & 31)) & 1u) {
        const int k = bits_before(s.words, r);
        if (k < e) {
          s.cand[k] = s.oi[r];
          s.ox[r] = 1;
        }
      }
    }
  }
  const int n_sel = act ? (total < e ? total : e) : 0;
  for (int k = n_sel + threadIdx.x; k < e; k += blockDim.x) s.cand[k] = -1;
  if (threadIdx.x == 0) *s.active = act ? 1 : 0;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
beam_update_kernel(const float* __restrict__ beam_d,
                   const int32_t* __restrict__ beam_i,
                   const uint8_t* __restrict__ beam_x,
                   const int32_t* __restrict__ nbrs,
                   const float* __restrict__ nd,
                   float* __restrict__ out_d,
                   int32_t* __restrict__ out_i,
                   uint8_t* __restrict__ out_x,
                   int32_t* __restrict__ cand,
                   uint8_t* __restrict__ active,
                   int ef, int w, int e) {
  extern __shared__ __align__(16) unsigned char smem[];
  Step s;
  layout(smem, ef, w, e, 0, &s, nullptr);
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t ob = static_cast<size_t>(q) * ef;
  const size_t ow = static_cast<size_t>(q) * w;

  for (int j = tid; j < ef; j += blockDim.x) {
    s.d[j] = beam_d[ob + j];
    s.i[j] = beam_i[ob + j];
    s.x[j] = beam_x[ob + j] ? 1 : 0;
  }
  for (int j = tid; j < w; j += blockDim.x) {
    s.wi[j] = nbrs[ow + j];
    s.wd[j] = nd[ow + j];
  }
  __syncthreads();

  dedup(s, ef, w, e);
  merge(s, ef, w);
  frontier(s, ef, e);

  for (int j = tid; j < ef; j += blockDim.x) {
    out_d[ob + j] = s.od[j];
    out_i[ob + j] = s.oi[j];
    out_x[ob + j] = s.ox[j];
  }
  for (int k = tid; k < e; k += blockDim.x) cand[static_cast<size_t>(q) * e + k] = s.cand[k];
  if (tid == 0) active[q] = *s.active ? 1 : 0;
}

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row forms. Each reads a row as 16-byte vectors (Vec) of kPerVec
// elements. A lane folds its vectors into two partial sums (a, b) with
// add(), the warp adds them up, and finish() turns them and |q|^2 into the
// internal distance. norm_part() is one lane's part of |q|^2.
struct F32Rows {
  using Elem = float;
  using Vec = float4;
  using Acc = float;
  static constexpr int kPerVec = 4;

  // a = q.n and b = |n|^2, or a = sum |q - n| for L1
  __device__ static void add(int metric, const Vec& x, const Vec& v, Acc& a, Acc& b) {
    if (metric == kL1) {
      a += fabsf(x.x - v.x) + fabsf(x.y - v.y) + fabsf(x.z - v.z) + fabsf(x.w - v.w);
    } else {
      a = fmaf(x.x, v.x, fmaf(x.y, v.y, fmaf(x.z, v.z, fmaf(x.w, v.w, a))));
      b = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, b))));
    }
  }
  __device__ static float finish(int metric, Acc a, Acc b, Acc qq) {
    if (metric == kL1) return a;
    if (metric == kSqL2) return fmaxf(qq + b - 2.f * a, 0.f);
    const float denom = sqrtf(qq) * sqrtf(b);
    return 1.f - (denom > 0.f ? a / denom : 0.f);
  }
  __device__ static Acc norm_part(const Elem* sq, int dp, int lane) {
    float acc = 0.f;
    for (int c = lane; c < dp; c += 32) acc = fmaf(sq[c], sq[c], acc);
    return acc;
  }
};

struct Int8Rows {
  using Elem = int8_t;
  using Vec = int4;
  using Acc = int;
  static constexpr int kPerVec = 16;

  // sum |x - v| over the four int8 lanes of one word, added to acc
  __device__ static int abs_diff(int x, int v, int acc) {
    const unsigned d = __vabsdiffs4(static_cast<unsigned>(x), static_cast<unsigned>(v));
    return static_cast<int>(__dp4a(d, 0x01010101u, static_cast<unsigned>(acc)));
  }
  // a = q.n and b = |n|^2, or a = sum |q - n| for L1, all exact in int32
  __device__ static void add(int metric, const Vec& x, const Vec& v, Acc& a, Acc& b) {
    if (metric == kL1) {
      a = abs_diff(x.x, v.x, abs_diff(x.y, v.y, abs_diff(x.z, v.z, abs_diff(x.w, v.w, a))));
    } else {
      a = __dp4a(x.x, v.x, __dp4a(x.y, v.y, __dp4a(x.z, v.z, __dp4a(x.w, v.w, a))));
      b = __dp4a(v.x, v.x, __dp4a(v.y, v.y, __dp4a(v.z, v.z, __dp4a(v.w, v.w, b))));
    }
  }
  __device__ static float finish(int metric, Acc a, Acc b, Acc qq) {
    if (metric == kL1) return static_cast<float>(a);
    if (metric == kSqL2) return static_cast<float>(qq + b - 2 * a);  // = sum (q - n)^2
    const float denom = sqrtf(static_cast<float>(qq)) * sqrtf(static_cast<float>(b));
    return 1.f - (denom > 0.f ? static_cast<float>(a) / denom : 0.f);
  }
  __device__ static Acc norm_part(const Elem* sq, int dp, int lane) {
    const int4* q4 = reinterpret_cast<const int4*>(sq);
    int acc = 0;
    for (int c = lane; c < dp / kPerVec; c += 32) {
      const int4 x = q4[c];
      acc = __dp4a(x.x, x.x, __dp4a(x.y, x.y, __dp4a(x.z, x.z, __dp4a(x.w, x.w, acc))));
    }
    return acc;
  }
};

struct WordRows {
  using Elem = uint32_t;
  using Vec = uint4;
  using Acc = int;
  static constexpr int kPerVec = 4;

  // a = the differing bits (Hamming)
  __device__ static void add(int, const Vec& x, const Vec& v, Acc& a, Acc&) {
    a += __popc(x.x ^ v.x) + __popc(x.y ^ v.y) + __popc(x.z ^ v.z) + __popc(x.w ^ v.w);
  }
  __device__ static float finish(int, Acc a, Acc, Acc) { return static_cast<float>(a); }
  __device__ static Acc norm_part(const Elem*, int, int) { return 0; }
};

// Internal distance of the query row (shared memory) to one vector row in
// device memory, by one warp; every lane gets the result.
template <class R>
__device__ __forceinline__ float row_distance(const typename R::Elem* __restrict__ sq,
                                              const typename R::Elem* __restrict__ row,
                                              int dp, int metric, typename R::Acc qq) {
  using Vec = typename R::Vec;
  using Acc = typename R::Acc;
  const int lane = lane_id();
  const int nv = dp / R::kPerVec;
  const Vec* rv = reinterpret_cast<const Vec*>(row);
  const Vec* qv = reinterpret_cast<const Vec*>(sq);
  Acc a = 0, b = 0;
  for (int c0 = lane; c0 < nv; c0 += 32 * kRowChunk) {
    Vec v[kRowChunk];
#pragma unroll
    for (int u = 0; u < kRowChunk; ++u) {
      const int c = c0 + 32 * u;
      v[u] = c < nv ? __ldg(rv + c) : Vec{};
    }
#pragma unroll
    for (int u = 0; u < kRowChunk; ++u) {
      const int c = c0 + 32 * u;
      if (c < nv) R::add(metric, qv[c], v[u], a, b);
    }
  }
  a = warp_sum(a);
  if (metric != kL1 && metric != kHamming) b = warp_sum(b);
  return R::finish(metric, a, b, qq);
}

// At most 64 registers a thread, so 4 blocks fit an SM: the construction
// shape (B=1024, ~8 blocks per SM) then runs in fewer waves. Left to
// itself ptxas gives each row form ~80 registers and 3 blocks an SM, which
// is slower there (chip_smoke.py phase 3b; PERF.md has the times).
// Unmasked (kMasked false): node_mask, res_d and res_i are unused and
// out_d / out_i receive the beam [B, EF]. Masked: res_d / res_i are the
// seeded result buffers [B, KP] and out_d / out_i receive the final
// results [B, KP].
template <class R, bool kMasked>
__global__ void __launch_bounds__(kThreads, 4)
beam_search_level0_kernel(const typename R::Elem* __restrict__ q,
                          const typename R::Elem* __restrict__ vectors,
                          const int32_t* __restrict__ adj0,
                          const float* __restrict__ beam_d,
                          const int32_t* __restrict__ beam_i,
                          const uint8_t* __restrict__ beam_x,
                          const int32_t* __restrict__ cand,
                          const uint8_t* __restrict__ active,
                          const uint8_t* __restrict__ node_mask,
                          const float* __restrict__ res_d,
                          const int32_t* __restrict__ res_i,
                          float* __restrict__ out_d,
                          int32_t* __restrict__ out_i,
                          int32_t* __restrict__ iters,
                          int ef, int m0, int e, int dp, int metric, int max_iters, int kp) {
  using Elem = typename R::Elem;
  using Vec = typename R::Vec;
  using Acc = typename R::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = e * m0;
  Step s;
  unsigned char* qrow;
  [[maybe_unused]] const size_t step_bytes = layout(smem, ef, w, e, sizeof(Elem) * dp, &s, &qrow);
  [[maybe_unused]] Results r;
  Elem* sq = reinterpret_cast<Elem*>(qrow);
  const int qb = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int warp = warp_id();
  const size_t ob = static_cast<size_t>(qb) * ef;

  const Vec* qg = reinterpret_cast<const Vec*>(q + static_cast<size_t>(qb) * dp);
  for (int c = tid; c < dp / R::kPerVec; c += blockDim.x) reinterpret_cast<Vec*>(sq)[c] = qg[c];
  for (int j = tid; j < ef; j += blockDim.x) {
    s.d[j] = beam_d[ob + j];
    s.i[j] = beam_i[ob + j];
    s.x[j] = beam_x[ob + j] ? 1 : 0;
  }
  for (int k = tid; k < e; k += blockDim.x) s.cand[k] = cand[static_cast<size_t>(qb) * e + k];
  if (tid == 0) *s.active = active[qb] ? 1 : 0;
  if constexpr (kMasked) {
    layout_results(smem, step_bytes, kp, w, &r);
    const size_t orr = static_cast<size_t>(qb) * kp;
    for (int j = tid; j < kp; j += blockDim.x) {
      r.d[j] = res_d[orr + j];
      r.i[j] = res_i[orr + j];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const Acc acc = warp_sum(R::norm_part(sq, dp, lane));
    if (lane == 0) *reinterpret_cast<Acc*>(s.qq) = acc;
  }
  __syncthreads();
  const Acc qq = *reinterpret_cast<const Acc*>(s.qq);

  int it = 0;
  while (it < max_iters && *s.active) {
    // the frontier's adjacency rows -> window ids
    for (int j = tid; j < w; j += blockDim.x) {
      const int32_t c = s.cand[j / m0];
      s.wi[j] = c >= 0 ? __ldg(adj0 + static_cast<size_t>(c) * m0 + j % m0) : -1;
    }
    __syncthreads();
    dedup(s, ef, w, e);

    // compact the fresh entries, then their distances, a row per warp
    ballot_words(s.words, w, [&](int j) { return s.fresh[j] != 0; });
    __syncthreads();
    int n_fresh = 0;
    for (int k = 0; k < (w + 31) >> 5; ++k) n_fresh += __popc(s.words[k]);
    for (int j = tid; j < w; j += blockDim.x) {
      if (s.fresh[j]) s.flist[bits_before(s.words, j)] = j;
    }
    __syncthreads();
    for (int f = warp; f < n_fresh; f += kWarps) {
      const int j = s.flist[f];
      const Elem* row = vectors + static_cast<size_t>(s.wi[j]) * dp;
      const float dist = row_distance<R>(sq, row, dp, metric, qq);
      if (lane == 0) s.wd[j] = dist;
    }
    __syncthreads();

    if constexpr (kMasked) {
      // the fresh window with the nodes failing the mask at (+inf, -1),
      // merged into the result buffer by the beam's stable merge (which
      // shares the window scratch sorted_wd / wrank with the beam's)
      for (int j = tid; j < w; j += blockDim.x) {
        const int32_t id = s.wi[j];
        const bool allow = id >= 0 && __ldg(node_mask + id) != 0;
        r.wd[j] = allow ? s.wd[j] : INFINITY;
        r.wi[j] = allow ? id : -1;
      }
      __syncthreads();
      Step rs = s;
      rs.d = r.d; rs.i = r.i; rs.x = nullptr;
      rs.od = r.od; rs.oi = r.oi; rs.ox = nullptr;
      rs.wd = r.wd; rs.wi = r.wi;
      merge<false>(rs, kp, w);
      float* rd = r.d; r.d = r.od; r.od = rd;
      int32_t* ri = r.i; r.i = r.oi; r.oi = ri;
    }

    merge(s, ef, w);
    frontier(s, ef, e);
    float* td = s.d; s.d = s.od; s.od = td;
    int32_t* ti = s.i; s.i = s.oi; s.oi = ti;
    uint8_t* tx = s.x; s.x = s.ox; s.ox = tx;
    ++it;
  }

  if constexpr (kMasked) {
    // keep the first occurrence of each id, then write the slots ranked by
    // (distance, position): the stable ascending sort
    for (int j = tid; j < kp; j += blockDim.x) {
      const int32_t id = r.i[j];
      bool dup = false;
      if (id >= 0) {
        for (int k = 0; k < j; ++k) dup |= r.i[k] == id;
      }
      r.od[j] = dup ? INFINITY : r.d[j];
      r.oi[j] = dup ? -1 : id;
    }
    __syncthreads();
    const size_t orr = static_cast<size_t>(qb) * kp;
    for (int j = tid; j < kp; j += blockDim.x) {
      const float dj = r.od[j];
      int rank = 0;
      for (int k = 0; k < kp; ++k) {
        const float dk = r.od[k];
        rank += (dk < dj) || (dk == dj && k < j);
      }
      out_d[orr + rank] = dj;
      out_i[orr + rank] = r.oi[j];
    }
  } else {
    for (int j = tid; j < ef; j += blockDim.x) {
      out_d[ob + j] = s.d[j];
      out_i[ob + j] = s.i[j];
    }
  }
  if (tid == 0) iters[qb] = it;
}

bool bad_beam_shape(int b, int ef, int w, int e) {
  return b < 0 || ef < 1 || (ef & (ef - 1)) || w < 1 || e < 1 || e > kMaxE || e > ef;
}

// Returned by a launcher when a block would need more shared memory than
// the card gives; the wrapper raises ValueError for it.
constexpr int kSmemTooLarge = -1;

// 0 when `kernel` may have `smem` bytes of dynamic shared memory (allowed
// explicitly above 48 KB), kSmemTooLarge past the card's limit, else the
// CUDA error of the query.
template <class Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return kSmemTooLarge;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// Launches the loop kernel of row form R, masked or not; see
// tpuvec_beam_search_level0.
template <class R, bool kMasked>
int launch_level0(const void* q, const void* vectors, const void* adj0, const void* beam_d,
                  const void* beam_i, const void* beam_x, const void* cand, const void* active,
                  const void* node_mask, const void* res_d, const void* res_i,
                  void* out_d, void* out_i, void* iters, int b, int ef, int m0, int e, int dp,
                  int metric, int max_iters, int kp, cudaStream_t stream) {
  using Elem = typename R::Elem;
  size_t smem = layout(nullptr, ef, e * m0, e, sizeof(Elem) * dp, nullptr, nullptr);
  if (kMasked) smem = layout_results(nullptr, smem, kp, e * m0, nullptr);
  if (const int rc = allow_smem(beam_search_level0_kernel<R, kMasked>, smem)) return rc;
  beam_search_level0_kernel<R, kMasked><<<b, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(vectors),
      static_cast<const int32_t*>(adj0), static_cast<const float*>(beam_d),
      static_cast<const int32_t*>(beam_i), static_cast<const uint8_t*>(beam_x),
      static_cast<const int32_t*>(cand), static_cast<const uint8_t*>(active),
      static_cast<const uint8_t*>(node_mask), static_cast<const float*>(res_d),
      static_cast<const int32_t*>(res_i), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), static_cast<int32_t*>(iters), ef, m0, e, dp, metric,
      max_iters, kp);
  return static_cast<int>(cudaGetLastError());
}

using LaunchLevel0 = decltype(&launch_level0<F32Rows, false>);

template <class R>
LaunchLevel0 pick_level0(bool masked) {
  return masked ? launch_level0<R, true> : launch_level0<R, false>;
}

// Whether the loop kernel takes rows of form `rows` and `dp` elements with
// distance form `metric`: a row must be whole 16-byte loads, and Hamming
// runs on words only, every other form on f32 or int8 rows.
bool good_rows(int rows, int dp, int metric) {
  switch (rows) {
    case kRowsF32: return dp >= 4 && dp % 4 == 0 && metric >= kSqL2 && metric <= kCosine;
    case kRowsInt8: return dp >= 16 && dp % 16 == 0 && metric >= kSqL2 && metric <= kCosine;
    case kRowsWords: return dp >= 4 && dp % 4 == 0 && metric == kHamming;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(), or
// kSmemTooLarge.
int tpuvec_beam_update(const void* beam_d, const void* beam_i,
                       const void* beam_x, const void* nbrs, const void* nd,
                       void* out_d, void* out_i, void* out_x, void* cand,
                       void* active, int b, int ef, int w, int e,
                       void* stream) {
  if (bad_beam_shape(b, ef, w, e)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const size_t smem = layout(nullptr, ef, w, e, 0, nullptr, nullptr);
  if (const int rc = allow_smem(beam_update_kernel, smem)) return rc;
  beam_update_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(beam_d), static_cast<const int32_t*>(beam_i),
      static_cast<const uint8_t*>(beam_x), static_cast<const int32_t*>(nbrs),
      static_cast<const float*>(nd), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), static_cast<uint8_t*>(out_x),
      static_cast<int32_t*>(cand), static_cast<uint8_t*>(active), ef, w, e);
  return static_cast<int>(cudaGetLastError());
}

// The whole level-0 loop for b queries, one block each, on rows of form
// `rows` (kRowsF32 / kRowsInt8 / kRowsWords) with distance form `metric`.
// With node_mask null, out_d / out_i [b, ef] receive the beam and res_d,
// res_i and kp are unused. With node_mask ([cap] bytes, 1 = the node may be
// returned), res_d / res_i are the seeded result buffers [b, kp] and
// out_d / out_i [b, kp] receive the results (the masked form). Launches on
// `stream` and returns cudaGetLastError(), or kSmemTooLarge.
int tpuvec_beam_search_level0(const void* q, const void* vectors, const void* adj0,
                              const void* beam_d, const void* beam_i, const void* beam_x,
                              const void* cand, const void* active, const void* node_mask,
                              const void* res_d, const void* res_i,
                              void* out_d, void* out_i, void* iters,
                              int b, int ef, int m0, int e, int dp, int rows, int metric,
                              int max_iters, int kp, void* stream) {
  const bool masked = node_mask != nullptr;
  if (bad_beam_shape(b, ef, e * m0, e) || m0 < 1 || max_iters < 0 ||
      !good_rows(rows, dp, metric) || (masked && (kp < 1 || !res_d || !res_i))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const LaunchLevel0 launch = rows == kRowsF32    ? pick_level0<F32Rows>(masked)
                              : rows == kRowsInt8 ? pick_level0<Int8Rows>(masked)
                                                  : pick_level0<WordRows>(masked);
  return launch(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, node_mask, res_d,
                res_i, out_d, out_i, iters, b, ef, m0, e, dp, metric, max_iters, kp,
                static_cast<cudaStream_t>(stream));
}

const char* tpuvec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
