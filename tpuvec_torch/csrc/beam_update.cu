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
// block. The query row (Dp f32, Dp a multiple of 128, so rows align to 16
// bytes), the beam and the window live in shared memory. Each iteration
// reads the E frontier adjacency rows of adj0 (ids < 0 give a window of -1),
// dedups the window, and only then reads the vector rows of the fresh
// entries: warps take the fresh rows in turn and read each with 16-byte
// loads, kRowChunk float4 per lane issued before any is reduced, so a row's
// loads are in flight together. The distance is the JAX formula: |q|^2 +
// |n|^2 - 2 q.n clamped at 0 (L2 and normalized cosine), sum |q - n| (L1),
// or 1 - q.n / (|q| |n|) (cosine of unnormalized rows). Then the shared step.
// A query stops when it is inactive or has run max_iters iterations.
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
// the float32 rate. The launch has one block per query: B=256 (search) is
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
constexpr int kRowChunk = 8;  // float4 loads of a row in flight per lane

// metric forms of the loop kernel (ops/beam.py:_metric_form)
constexpr int kSqL2 = 0;
constexpr int kL1 = 1;
constexpr int kCosine = 2;

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
  float* qq;         // [1] |q|^2
  uint8_t* fresh;    // [W]
};

__host__ __device__ inline unsigned char* take(unsigned char* base, size_t* off, size_t bytes) {
  unsigned char* p = base ? base + *off : nullptr;
  *off += bytes;
  return p;
}

// Carves the shared memory: the query row (dp floats) first, so it stays
// 16-byte aligned, then the 4-byte arrays, then the byte arrays. Returns the
// bytes needed; fills `s` and `q` when `base` is not null.
__host__ __device__ size_t layout(unsigned char* base, int ef, int w, int e, int dp,
                                  Step* s, float** q) {
  const size_t n_words = ((ef > w ? ef : w) + 31) / 32;
  size_t off = 0;
  float* sq = reinterpret_cast<float*>(take(base, &off, sizeof(float) * dp));
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
  t.qq = reinterpret_cast<float*>(take(base, &off, 4));
  t.x = take(base, &off, ef);
  t.ox = take(base, &off, ef);
  t.fresh = take(base, &off, w);
  if (base) {
    *s = t;
    if (q) *q = sq;
  }
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
      s.ox[slot] = (s.x[j] || !isfinite(dj)) ? 1 : 0;
    }
  }
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const float dj = s.wd[j];
    const int slot = s.wrank[j] + count_less_equal(s.d, ef, dj);
    if (slot < ef) {
      s.od[slot] = dj;
      s.oi[slot] = s.wi[j];
      s.ox[slot] = isfinite(dj) ? 0 : 1;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Internal distance of the query row (shared memory) to one vector row in
// device memory, by one warp; every lane gets the result.
__device__ __forceinline__ float row_distance(const float* __restrict__ sq,
                                              const float* __restrict__ row,
                                              int dp, int metric, float qq) {
  const int lane = lane_id();
  const int nv = dp >> 2;
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(sq);
  float a = 0.f, b = 0.f;  // q.n and |n|^2, or sum |q - n| for L1
  for (int c0 = lane; c0 < nv; c0 += 32 * kRowChunk) {
    float4 v[kRowChunk];
#pragma unroll
    for (int u = 0; u < kRowChunk; ++u) {
      const int c = c0 + 32 * u;
      v[u] = c < nv ? __ldg(r4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kRowChunk; ++u) {
      const int c = c0 + 32 * u;
      if (c < nv) {
        const float4 x = q4[c];
        if (metric == kL1) {
          a += fabsf(x.x - v[u].x) + fabsf(x.y - v[u].y) + fabsf(x.z - v[u].z) +
               fabsf(x.w - v[u].w);
        } else {
          a = fmaf(x.x, v[u].x, fmaf(x.y, v[u].y, fmaf(x.z, v[u].z, fmaf(x.w, v[u].w, a))));
          b = fmaf(v[u].x, v[u].x,
                   fmaf(v[u].y, v[u].y, fmaf(v[u].z, v[u].z, fmaf(v[u].w, v[u].w, b))));
        }
      }
    }
  }
  a = warp_sum(a);
  if (metric == kL1) return a;
  b = warp_sum(b);
  if (metric == kSqL2) return fmaxf(qq + b - 2.f * a, 0.f);
  const float denom = sqrtf(qq) * sqrtf(b);
  return 1.f - (denom > 0.f ? a / denom : 0.f);
}

__global__ void __launch_bounds__(kThreads)
beam_search_level0_kernel(const float* __restrict__ q,
                          const float* __restrict__ vectors,
                          const int32_t* __restrict__ adj0,
                          const float* __restrict__ beam_d,
                          const int32_t* __restrict__ beam_i,
                          const uint8_t* __restrict__ beam_x,
                          const int32_t* __restrict__ cand,
                          const uint8_t* __restrict__ active,
                          float* __restrict__ out_d,
                          int32_t* __restrict__ out_i,
                          int32_t* __restrict__ iters,
                          int ef, int m0, int e, int dp, int metric, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = e * m0;
  Step s;
  float* sq;
  layout(smem, ef, w, e, dp, &s, &sq);
  const int qb = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int warp = warp_id();
  const size_t ob = static_cast<size_t>(qb) * ef;

  const float4* qg = reinterpret_cast<const float4*>(q + static_cast<size_t>(qb) * dp);
  for (int c = tid; c < (dp >> 2); c += blockDim.x) reinterpret_cast<float4*>(sq)[c] = qg[c];
  for (int j = tid; j < ef; j += blockDim.x) {
    s.d[j] = beam_d[ob + j];
    s.i[j] = beam_i[ob + j];
    s.x[j] = beam_x[ob + j] ? 1 : 0;
  }
  for (int k = tid; k < e; k += blockDim.x) s.cand[k] = cand[static_cast<size_t>(qb) * e + k];
  if (tid == 0) *s.active = active[qb] ? 1 : 0;
  __syncthreads();
  if (warp == 0) {
    float acc = 0.f;
    for (int c = lane; c < dp; c += 32) acc = fmaf(sq[c], sq[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) *s.qq = acc;
  }
  __syncthreads();
  const float qq = *s.qq;

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
      const float* row = vectors + static_cast<size_t>(s.wi[j]) * dp;
      const float dist = row_distance(sq, row, dp, metric, qq);
      if (lane == 0) s.wd[j] = dist;
    }
    __syncthreads();

    merge(s, ef, w);
    frontier(s, ef, e);
    float* td = s.d; s.d = s.od; s.od = td;
    int32_t* ti = s.i; s.i = s.oi; s.oi = ti;
    uint8_t* tx = s.x; s.x = s.ox; s.ox = tx;
    ++it;
  }

  for (int j = tid; j < ef; j += blockDim.x) {
    out_d[ob + j] = s.d[j];
    out_i[ob + j] = s.i[j];
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

// The whole level-0 loop for b queries, one block each. Launches on
// `stream` and returns cudaGetLastError(), or kSmemTooLarge.
int tpuvec_beam_search_level0(const void* q, const void* vectors, const void* adj0,
                              const void* beam_d, const void* beam_i, const void* beam_x,
                              const void* cand, const void* active,
                              void* out_d, void* out_i, void* iters,
                              int b, int ef, int m0, int e, int dp, int metric,
                              int max_iters, void* stream) {
  if (bad_beam_shape(b, ef, e * m0, e) || m0 < 1 || dp < 4 || (dp & 3) || max_iters < 0 ||
      metric < kSqL2 || metric > kCosine) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const size_t smem = layout(nullptr, ef, e * m0, e, dp, nullptr, nullptr);
  if (const int rc = allow_smem(beam_search_level0_kernel, smem)) return rc;
  beam_search_level0_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(vectors),
      static_cast<const int32_t*>(adj0), static_cast<const float*>(beam_d),
      static_cast<const int32_t*>(beam_i), static_cast<const uint8_t*>(beam_x),
      static_cast<const int32_t*>(cand), static_cast<const uint8_t*>(active),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i),
      static_cast<int32_t*>(iters), ef, m0, e, dp, metric, max_iters);
  return static_cast<int>(cudaGetLastError());
}

const char* tpuvec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
