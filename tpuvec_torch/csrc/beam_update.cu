// One level-0 HNSW beam-search iteration for B queries: dedup, merge, frontier.
//
// Replaces the Pallas TPU kernel tpuvec/ops/pallas_beam.py:beam_update
// (pallas_call at :144, body _beam_update_math at :45-107). Its contract is
// in tpuvec_torch/ops/beam.py, whose beam_update_plain is the plain version.
//
// Bound. Per launch the function reads beam_d, beam_i, beam_x, nbrs, nd and
// writes the three beam arrays, cand and active once:
//   B * (18*EF + 8*W + 4*E + 1) bytes (flags are one byte; with int32 flags,
//   as the Pallas kernel stores them, 4*B*(6*EF + 2*W + E + 1)),
// against 3.35 TB/s: 0.36 MB = 0.11 us at the search shape (B=256, EF=64,
// W=32, E=1) and 5.2 MB = 1.6 us at the construction shape (B=1024, EF=256,
// W=64, E=2). The work is a few compares per byte, so memory bounds it, and
// at these sizes a launch costs more than the traffic.
//
// Design. One thread block per query; the beam and the window (S = EF + W
// entries, S <= 320 on the main path) live in shared memory, so every
// intermediate of the iteration stays on chip and device memory sees each
// input and output once.
//   1. dedup: each window entry scans the beam ids, and with E > 1 the
//      earlier window ids; duplicates and ids < 0 become (+inf, -1).
//   2. merge by rank placement: an element's output slot is the number of
//      elements with a smaller (distance, position) key, beam positions
//      before window positions. This is the stable merge of the JAX
//      package's search path (rank_topk_merge_sorted, ops/sort.py:256-302);
//      the Pallas kernel's bitonic merge gives the same output on tie-free
//      input. O(S^2) compares per query, spread over the block's threads,
//      with no sequential stages.
//   3. frontier: warp ballots turn the unexpanded flags into bit words (a
//      block prefix sum in bit form); one thread walks the words for the
//      first E set bits; the smallest unexpanded distance is the first of
//      them, since the beam is sorted.
// wgmma, TMA and warp-level merges are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxE = 64;

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
  extern __shared__ unsigned char smem[];
  const int s = ef + w;
  const int n_words = (ef + 31) / 32;
  float* sh_d = reinterpret_cast<float*>(smem);            // [S] merge input
  int32_t* sh_i = reinterpret_cast<int32_t*>(sh_d + s);     // [S]
  float* so_d = reinterpret_cast<float*>(sh_i + s);         // [EF] merged
  int32_t* so_i = reinterpret_cast<int32_t*>(so_d + ef);    // [EF]
  uint32_t* words = reinterpret_cast<uint32_t*>(so_i + ef); // [EF/32] unexpanded bits
  uint8_t* sh_x = reinterpret_cast<uint8_t*>(words + n_words);  // [S]
  uint8_t* so_x = sh_x + s;                                  // [EF]
  uint8_t* fresh = so_x + ef;                                // [W]

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t ob = static_cast<size_t>(q) * ef;
  const size_t ow = static_cast<size_t>(q) * w;

  for (int j = tid; j < ef; j += blockDim.x) {
    sh_d[j] = beam_d[ob + j];
    sh_i[j] = beam_i[ob + j];
    sh_x[j] = beam_x[ob + j] ? 1 : 0;
  }
  for (int j = tid; j < w; j += blockDim.x) {
    sh_i[ef + j] = nbrs[ow + j];
    sh_d[ef + j] = nd[ow + j];
    sh_x[ef + j] = 0;
  }
  __syncthreads();

  // 1. dedup against the raw ids (flags first, masking after a barrier, so
  //    no thread reads an id another thread has already masked)
  for (int j = tid; j < w; j += blockDim.x) {
    const int32_t id = sh_i[ef + j];
    bool ok = id >= 0;
    for (int k = 0; ok && k < ef; ++k) ok = sh_i[k] != id;
    if (e > 1) {
      for (int k = 0; ok && k < j; ++k) ok = sh_i[ef + k] != id;
    }
    fresh[j] = ok ? 1 : 0;
  }
  __syncthreads();
  for (int j = tid; j < w; j += blockDim.x) {
    if (!fresh[j]) {
      sh_d[ef + j] = INFINITY;
      sh_i[ef + j] = -1;
    }
  }
  __syncthreads();

  // 2. rank placement: slot = #{k : (d_k, k) < (d_j, j)}
  for (int j = tid; j < s; j += blockDim.x) {
    const float dj = sh_d[j];
    int rank = 0;
    for (int k = 0; k < s; ++k) {
      const float dk = sh_d[k];
      rank += (dk < dj) || (dk == dj && k < j);
    }
    if (rank < ef) {
      so_d[rank] = dj;
      so_i[rank] = sh_i[j];
      so_x[rank] = (sh_x[j] || !isfinite(dj)) ? 1 : 0;
    }
  }
  __syncthreads();

  // 3. frontier: unexpanded bits by warp ballot, then the first E of them
  const int lane = tid & 31;
  for (int r0 = 0; r0 < ef; r0 += blockDim.x) {
    const int r = r0 + tid;
    const bool unexp = r < ef && !so_x[r] && isfinite(so_d[r]);
    const uint32_t bits = __ballot_sync(0xffffffffu, unexp);
    if (lane == 0 && r < ef) words[r >> 5] = bits;
  }
  __syncthreads();
  if (tid == 0) {
    int pos[kMaxE];
    int found = 0;
    for (int k = 0; k < n_words && found < e; ++k) {
      uint32_t bits = words[k];
      while (bits && found < e) {
        pos[found++] = k * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
      }
    }
    const float best = found > 0 ? so_d[pos[0]] : INFINITY;
    const float worst = so_d[ef - 1];
    const bool act = isfinite(best) && (best <= worst || !isfinite(worst));
    for (int k = 0; k < e; ++k) {
      int32_t c = -1;
      if (act && k < found) {
        c = so_i[pos[k]];
        so_x[pos[k]] = 1;
      }
      cand[static_cast<size_t>(q) * e + k] = c;
    }
    active[q] = act ? 1 : 0;
  }
  __syncthreads();

  for (int j = tid; j < ef; j += blockDim.x) {
    out_d[ob + j] = so_d[j];
    out_i[ob + j] = so_i[j];
    out_x[ob + j] = so_x[j];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
int tpuvec_beam_update(const void* beam_d, const void* beam_i,
                       const void* beam_x, const void* nbrs, const void* nd,
                       void* out_d, void* out_i, void* out_x, void* cand,
                       void* active, int b, int ef, int w, int e,
                       void* stream) {
  if (b < 0 || ef < 1 || w < 1 || e < 1 || e > kMaxE || e > ef) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const int s = ef + w;
  const size_t smem = static_cast<size_t>(s) * 9 + static_cast<size_t>(ef) * 9 +
                      static_cast<size_t>((ef + 31) / 32) * 4 + w;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  beam_update_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(beam_d), static_cast<const int32_t*>(beam_i),
      static_cast<const uint8_t*>(beam_x), static_cast<const int32_t*>(nbrs),
      static_cast<const float*>(nd), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), static_cast<uint8_t*>(out_x),
      static_cast<int32_t*>(cand), static_cast<uint8_t*>(active), ef, w, e);
  return static_cast<int>(cudaGetLastError());
}

const char* tpuvec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
