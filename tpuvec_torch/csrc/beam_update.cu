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
// The iteration step (EF beam slots, W window entries; one block of
// kThreads per query):
//   1. dedup: each window entry is taken by a group of G lanes (G = 256 /
//      next_pow2(W), 1..32, so the whole block is at work); the group's
//      lanes stride over the beam ids (and, with E > 1, the earlier window
//      ids) in 16-byte loads, four in flight, and combine by ballot. Each
//      warp claims places in the fresh list for its fresh entries with one
//      shared atomicAdd (a ballot's popcount), so the fresh list is in no
//      fixed order: each fresh entry keeps its window position j beside its
//      id, and the merge orders by (distance, j). Entries that are not
//      fresh are never written: they are (+inf, -1) in the plain update
//      and cannot reach the EF kept slots (below). Barrier.
//   2. merge, by counting, with no sorted copy of the fresh entries: fresh
//      entry f goes to slot #{fresh h before f by (distance, position)} +
//      #{beam j : d_j <= d_f}; beam entry j to slot j + #{fresh f : d_f <
//      d_j}. Each count is taken by the entry's group of lanes in 16-byte
//      loads, without branches, several in flight (merge_window,
//      merge_beam); the count over the beam, when it would take more than
//      four loads a lane, is a binary search (the beam is sorted ascending
//      by contract). That is the stable sort
//      of beam ++ window, ties included (beam before window, the window in
//      its order), kept to EF, so it equals beam_update_plain bit for bit:
//      an entry that is not fresh is (+inf, -1) there and sorts after all
//      EF beam entries (beam before window on ties), so it is never kept.
//      Barrier.
//   3. frontier, by warp 0 alone: a ballot a word of 32 slots marks the
//      unexpanded finite slots, a popcount prefix ranks them, the first E
//      become the next frontier, and the scan stops once it has E. `active`
//      is the definition of ops/beam.py:frontier.
//
// beam_update_kernel is load -> step -> store. Its bound: per launch it
// reads beam_d, beam_i, beam_x, nbrs, nd and writes the three beam arrays,
// cand and active once, B * (18*EF + 8*W + 4*E + 1) bytes, against 3.35 TB/s:
// 0.11 us at the search shape (B=256, EF=64, W=32, E=1), 1.6 us at the
// construction shape (B=1024, EF=256, W=64, E=2).
//
// beam_search_level0_kernel runs the whole level-0 loop of one query in one
// block, until the query is inactive or has run max_iters iterations. The
// query row, the beam, the window and a ring of R row slots live in shared
// memory. An iteration, after the previous one chose the frontier:
//   - warp 0 has read the frontier's adjacency rows into the window right
//     after choosing it (ids < 0 give -1), all of a lane's loads in flight
//     together (one barrier covers both);
//   - dedup, and in it the fresh vector rows, all requested before any is
//     reduced. Mechanism: Hopper's 1-D bulk copy, cp.async.bulk.
//     shared::cluster.global.mbarrier::complete_tx::bytes, one per row. The
//     lane that claims fresh place f (f < R) arms the mbarrier of its ring
//     slot with the row's bytes (mbarrier.arrive.expect_tx, arrival count
//     1) and issues the copy at once, so every fresh row of the iteration
//     is in flight together, and no row passes through registers. Barrier;
//   - the rows: the fresh rows take consecutive ring positions that run on
//     across iterations: position p is slot p % R, and its use of the slot
//     is lap p / R. Slot s belongs to warp s % 8, which waits on the slot's
//     mbarrier (mbarrier.try_wait.parity with the lap's parity), reduces the
//     row from shared memory against the query row, writes the distance to
//     fd[f], and, when the iteration has more fresh rows than slots,
//     refills the slot with the row R places on while the other slots
//     reduce. Phase discipline: each slot's k-th fill completes its
//     mbarrier's phase k, and only the owner warp waits on a slot, in
//     position order, having waited on phase k-1 before it waits on phase
//     k; so a parity never aliases a phase two behind. Every fill is
//     consumed in the iteration that issued it, so no copy is in flight
//     when the block exits. A refill writes a slot its warp has just read
//     and summed, after a __syncwarp (copy_row says why no proxy fence is
//     needed). No integer division runs in the loop. Every row form
//     qualifies: good_rows makes each row whole 16-byte vectors, and the
//     wrapper requires `vectors` to start on a 16-byte boundary. Barrier;
//   - the step's merge and frontier.
// Adjacency rows ahead in L2: measured and left out. A prefetch.global.L2
// of each 128-byte line of adj0[id] as soon as each fresh id was known (the
// next frontier is a beam entry, and every beam entry but the seeds was
// fresh once) paid for no row form: each form ran 0.6% faster to 2.6%
// slower with it (PERF.md §6, timed in turns against the same kernel
// without it). An adjacency row is m0 * 4 bytes, not always a multiple of
// 16, so a bulk copy into shared memory was not the means either.
// Ring size: the wrapper's launch plan (ops/beam.py:_loop_plan) passes R.
// It takes the whole window when the launch's blocks still fit in the
// waves the kernel needs without a ring (B=256 over 132 SMs needs 2 blocks
// an SM, about 113 KB each), else the most slots that keep those waves, and
// at least one; the launcher computes the block's bytes from R with
// layout() and returns kSmemTooLarge when the block does not fit.
//
// Block barriers per iteration of the loop kernel, unmasked: 10 in the
// design before the ring (the window read, two in dedup, three around the
// compaction and the row reads, two in the merge, two in the frontier);
// now 4 (after dedup, after the rows, after the merge, after the frontier
// and its window read). Masked: 13 before, the same 4 now, because the
// result buffer's merge runs in the beam's merge pass.
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
// node mask: each iteration the fresh entries whose mask byte is 1 are
// merged into the buffer in the beam's merge pass, by the same stable merge
// among themselves (buffer before window), keeping the KP smallest. The
// mask is one byte a node, shared by the batch and read with __ldg while
// the rows are in flight: at 1M nodes it is 1 MB, so it stays in the 50 MB
// L2. The buffer is not deduplicated inside the loop (a node evicted from
// the beam and met again is collected twice, as in the JAX package); after
// the loop each block keeps the first occurrence of each id and writes the
// KP slots ranked by (distance, position), the stable sort. The flag is a
// template parameter so that the unmasked forms carry no code of the
// masked ones.
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
// beams in and out (PERF.md §6, chip_smoke.py:_loop_bound). Tensor cores do
// not serve it: each query reads its own rows, so the work is a
// matrix-vector product, two multiply-adds per element of a 4-byte row
// (about 0.5 FLOP a byte; int8 and word rows 2 and ~0.75 operations a
// byte), far below the ~295 operations a byte where a tensor core would be
// the limit. What sets an iteration's time is its chain: frontier ->
// adjacency rows -> dedup -> the fresh rows (one round trip, all in
// flight) -> merge, four barriers apart; at f32 rows also the rows' own
// traffic, since queries that read the same row each read it (chip_smoke.py
// reports each phase's cycles; PERF.md §6 has them).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifdef TPUVEC_LOOP_CLOCKS
// Built only for measurement (chip_smoke.py --against NAME=PATH,-DTPUVEC_LOOP_CLOCKS):
// thread 0 of each block of the loop kernel adds the SM clock cycles of each
// phase of an iteration here: its own work in a phase, then its wait at the
// barrier after it for the rest of the block; [kPhases] counts the
// iterations. tpuvec_loop_clocks reads and clears them. Phases: dedup (and
// the copies' issue), its barrier; rows, barrier; merge_window, merge_beam,
// barrier; frontier (and the window read), barrier.
constexpr int kPhases = 9;
__device__ unsigned long long g_loop_clocks[kPhases + 1];
#define LOOP_CLOCK(k)                                                  \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long now = clock64();                                 \
      clocks[k] += static_cast<unsigned long long>(now - clock_last);  \
      clock_last = now;                                                \
    }                                                                  \
  } while (0)
#else
#define LOOP_CLOCK(k) \
  do {                \
  } while (0)
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxE = 64;
constexpr unsigned kFull = 0xffffffffu;

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
  int32_t* wi;       // [W] window ids
  int32_t* fid;      // [W] ids of the fresh entries, in the order dedup found them
  int32_t* fj;       // [W] their window positions
  float* fd;         // [W] their distances
  int32_t* cand;     // [E] next frontier
  int32_t* active;   // [1]
  int32_t* nf;       // [1] fresh entries found so far this iteration
  unsigned char* qq; // [1] |q|^2, in the row form's accumulator type
  uint8_t* fok;      // [W] fresh entry f passes the node mask (masked form)
};

// The masked loop kernel's result buffer.
struct Results {
  float* d;    // [KP] buffer in, ascending
  int32_t* i;  // [KP]
  float* od;   // [KP] buffer out
  int32_t* oi; // [KP]
};

__host__ __device__ inline unsigned char* take(unsigned char* base, size_t* off, size_t bytes) {
  unsigned char* p = base ? base + *off : nullptr;
  *off += (bytes + 15) / 16 * 16;  // every array starts on a 16-byte boundary
  return p;
}

// Carves the shared memory, each array 16-byte aligned: the query row
// (row_bytes), then `ring` row slots and their mbarriers, then the step's
// arrays, then, when kp > 0 (the masked form), the mask flags and the
// Results. Returns the bytes needed; fills the pointers when `base` is not
// null. ops/beam.py:_loop_smem mirrors it.
__host__ __device__ size_t layout(unsigned char* base, int ef, int w, int e, size_t row_bytes,
                                  int ring, int kp, Step* s, unsigned char** q,
                                  unsigned char** slots, uint64_t** bars, Results* r) {
  size_t off = 0;
  unsigned char* sq = take(base, &off, row_bytes);
  unsigned char* sl = take(base, &off, row_bytes * ring);
  uint64_t* sb = reinterpret_cast<uint64_t*>(take(base, &off, 8 * static_cast<size_t>(ring)));
  Step t;
  t.d = reinterpret_cast<float*>(take(base, &off, 4 * ef));
  t.od = reinterpret_cast<float*>(take(base, &off, 4 * ef));
  t.i = reinterpret_cast<int32_t*>(take(base, &off, 4 * ef));
  t.oi = reinterpret_cast<int32_t*>(take(base, &off, 4 * ef));
  t.wi = reinterpret_cast<int32_t*>(take(base, &off, 4 * w));
  t.fid = reinterpret_cast<int32_t*>(take(base, &off, 4 * w));
  t.fj = reinterpret_cast<int32_t*>(take(base, &off, 4 * w));
  t.fd = reinterpret_cast<float*>(take(base, &off, 4 * w));
  t.cand = reinterpret_cast<int32_t*>(take(base, &off, 4 * e));
  unsigned char* misc = take(base, &off, 16);  // active, nf, qq
  t.x = take(base, &off, ef);
  t.ox = take(base, &off, ef);
  t.fok = nullptr;
  Results u{};
  if (kp > 0) {
    t.fok = take(base, &off, w);
    u.d = reinterpret_cast<float*>(take(base, &off, 4 * kp));
    u.od = reinterpret_cast<float*>(take(base, &off, 4 * kp));
    u.i = reinterpret_cast<int32_t*>(take(base, &off, 4 * kp));
    u.oi = reinterpret_cast<int32_t*>(take(base, &off, 4 * kp));
  }
  if (base) {
    t.active = reinterpret_cast<int32_t*>(misc);
    t.nf = reinterpret_cast<int32_t*>(misc + 4);
    t.qq = misc + 8;
    if (s) *s = t;
    if (q) *q = sq;
    if (slots) *slots = sl;
    if (bars) *bars = sb;
    if (r) *r = u;
  }
  return off;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// log2 of the lanes G a group takes for n entries spread over the block:
// G a power of two from 1 to 32, G * next_pow2(n) <= kThreads where it can
// be. Groups are indexed by shifts: the loop has no integer division.
__device__ __forceinline__ int group_log2(int n) {
  const int lg = 8 - (n > 1 ? 32 - __clz(n - 1) : 0);  // kThreads = 1 << 8
  return lg < 0 ? 0 : (lg > 5 ? 5 : lg);
}

// Sum of v over the g lanes of this lane's group (g a power of two).
__device__ __forceinline__ int group_sum(int v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier with `count` arrivals a phase (one thread)
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Copies `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// `src` to shared `dst` with one bulk copy whose completion counts on `bar`;
// the calling thread is the phase's one arrival. No proxy fence: the only
// generic accesses to a slot are reads, and their values have been used
// (summed across the warp) before the __syncwarp or barrier that precedes
// the copy, as a consumer releases a stage by an mbarrier arrive alone in
// CUTLASS's bulk-copy pipelines.
__device__ __forceinline__ void copy_row(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void wait_row(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ bool has(const int4& x, int32_t id) {
  return (x.x == id) | (x.y == id) | (x.z == id) | (x.w == id);
}

// Whether any of a[0..len) equals id, read by the `g` lanes of a group,
// this lane being lane `sub` of it: whole 16-byte vectors, four loads in
// flight at a time (`a` is 16-byte aligned), then the tail. Stops early on
// a hit.
__device__ __forceinline__ bool any_equal(const int32_t* a, int len, int32_t id, int sub, int g) {
  const int4* a4 = reinterpret_cast<const int4*>(a);
  const int full = len >> 2;
  bool hit = false;
  int v = sub;
  for (; v + 3 * g < full && !hit; v += 4 * g) {
    const int4 x0 = a4[v], x1 = a4[v + g], x2 = a4[v + 2 * g], x3 = a4[v + 3 * g];
    hit = has(x0, id) | has(x1, id) | has(x2, id) | has(x3, id);
  }
  for (; v < full && !hit; v += g) hit = has(a4[v], id);
  for (int k = 4 * full + sub; k < len && !hit; k += g) hit = a[k] == id;
  return hit;
}

// 1. dedup of the window (s.wi) against the beam ids (s.i) and, with
//    E > 1, the earlier window ids. Calls visit(f, j, id) on the lane that
//    leads the group of each fresh window entry j, f its place in the
//    fresh list (claimed from *s.nf, which must be 0 before). The caller
//    puts a barrier after it.
template <class Visit>
__device__ void dedup(const Step& s, int ef, int w, int e, Visit visit) {
  const int lg = group_log2(w);
  const int g = 1 << lg;
  const int lane = lane_id();
  const int sub = lane & (g - 1);
  // this lane's group; written without a shift by 32 or a select on g, a
  // form the compiler gave the whole warp's mask for at g = 16
  const uint32_t group = (kFull >> (32 - g)) << (lane & ~(g - 1));
  for (int r0 = 0; r0 < w; r0 += kThreads >> lg) {
    const int j = r0 + static_cast<int>(threadIdx.x >> lg);
    const int32_t id = j < w ? s.wi[j] : -1;
    bool hit = false;
    if (id >= 0) {
      hit = any_equal(s.i, ef, id, sub, g);
      if (e > 1 && !hit) hit = any_equal(s.wi, j, id, sub, g);
    }
    const bool dup = (__ballot_sync(kFull, hit) & group) != 0;
    const bool fresh = sub == 0 && id >= 0 && !dup;
    const uint32_t bits = __ballot_sync(kFull, fresh);
    int base = 0;
    if (lane == 0 && bits) base = atomicAdd(s.nf, __popc(bits));
    base = __shfl_sync(kFull, base, 0);
    if (fresh) visit(base + __popc(bits & ((1u << lane) - 1u)), j, id);
  }
}

// Sum of pred(h, a[h]) over this lane's share of h < n, the `g` lanes of a
// group taking 16-byte vectors of `a` in turn (`a` is 16-byte aligned): the
// loads are independent, so a count is one round of shared-memory latency,
// not a chain of them as a binary search is.
template <class Pred>
__device__ __forceinline__ int count_where(const float* a, int n, int sub, int g, Pred pred) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  int c = 0;
#pragma unroll 4
  for (int v = sub; v < (n >> 2); v += g) {
    const float4 x = a4[v];
    c += pred(4 * v, x.x) + pred(4 * v + 1, x.y) + pred(4 * v + 2, x.z) + pred(4 * v + 3, x.w);
  }
  for (int h = (n & ~3) + sub; h < n; h += g) c += pred(h, a[h]);
  return c;
}

// #{j < n : a[j] <= v} for ascending a (16-byte aligned), on every lane of
// a group of g lanes that hold the same v: counted in 16-byte loads while
// that is at most four loads a lane (one round of shared-memory latency),
// else a binary search, the same on every lane of the group.
__device__ __forceinline__ int count_at_most(const float* a, int n, float v, int sub, int g) {
  if (n <= 16 * g) {
    return group_sum(count_where(a, n, sub, g, [&](int, float x) { return x <= v ? 1 : 0; }), g);
  }
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// 2. the stable merge of the beam (s.d, s.i, s.x) and the n fresh entries
//    (s.fid, s.fj, s.fd) into the EF smallest (s.od, s.oi, s.ox), in two
//    halves that write disjoint slots (merge_window, merge_beam); +inf
//    slots marked expanded. kMasked: the fresh entries that pass the mask
//    (s.fok) into the result buffer (r) the same way. The caller puts a
//    barrier after both.
//
//    merge_window: each fresh entry's rank among the fresh by (distance,
//    window position) (kMasked: also among those passing the mask, in the
//    high half), counted by the entry's group of lanes, plus #{beam j : d_j
//    <= d_f} (kMasked: the same in the buffer) by count_at_most.
template <bool kMasked>
__device__ void merge_window(const Step& s, const Results& r, int ef, int kp, int n) {
  const int lg = group_log2(n);
  const int g = 1 << lg;
  const int sub = lane_id() & (g - 1);
  for (int r0 = 0; r0 < n; r0 += kThreads >> lg) {
    const int f = r0 + static_cast<int>(threadIdx.x >> lg);
    const float df = f < n ? s.fd[f] : 0.f;
    const int jf = f < n ? s.fj[f] : 0;
    int less = 0;
    if (f < n) {  // branch-free: the positions (and mask flags) load beside the distances
      const int4* j4 = reinterpret_cast<const int4*>(s.fj);
      [[maybe_unused]] const uint32_t* ok4 = reinterpret_cast<const uint32_t*>(s.fok);
      less = count_where(s.fd, n, sub, g, [&](int h, float dh) {
        const int4 jv = j4[h >> 2];
        const int jh = (h & 3) == 0 ? jv.x : (h & 3) == 1 ? jv.y : (h & 3) == 2 ? jv.z : jv.w;
        const int before = (dh < df) | ((dh == df) & (jh < jf));
        if constexpr (kMasked) {
          const int ok = static_cast<int>((ok4[h >> 2] >> (8 * (h & 3))) & 1u);
          return before + ((before & ok) << 16);
        }
        return before;
      });
    }
    less = group_sum(less, g);
    // the beam's (and kMasked: the buffer's) entries at or below d_f; the
    // same on the group's lanes, and ignored where f >= n
    const int below = count_at_most(s.d, ef, df, sub, g);
    [[maybe_unused]] const int below_r = kMasked ? count_at_most(r.d, kp, df, sub, g) : 0;
    if (f < n && sub == 0) {
      const int slot = (less & 0xffff) + below;
      if (slot < ef) {
        s.od[slot] = df;
        s.oi[slot] = s.fid[f];
        s.ox[slot] = isfinite(df) ? 0 : 1;
      }
      if constexpr (kMasked) {
        const int rslot = (less >> 16) + below_r;
        if (s.fok[f] && rslot < kp) {
          r.od[rslot] = df;
          r.oi[rslot] = s.fid[f];
        }
      }
    }
  }
}

//    merge_beam: each beam entry j moves up by the fresh entries below it
//    (kMasked: each result buffer entry by those that pass the mask).
template <bool kMasked>
__device__ void merge_beam(const Step& s, const Results& r, int ef, int kp, int n) {
  const int lane = lane_id();
  {
    const int lg = group_log2(ef);
    const int g = 1 << lg;
    const int sub = lane & (g - 1);
    for (int r0 = 0; r0 < ef; r0 += kThreads >> lg) {
      const int j = r0 + static_cast<int>(threadIdx.x >> lg);
      const float dj = j < ef ? s.d[j] : 0.f;
      int shift = j < ef ? count_where(s.fd, n, sub, g, [&](int, float dh) { return dh < dj; }) : 0;
      shift = group_sum(shift, g);
      if (j < ef && sub == 0 && j + shift < ef) {
        s.od[j + shift] = dj;
        s.oi[j + shift] = s.i[j];
        s.ox[j + shift] = (s.x[j] || !isfinite(dj)) ? 1 : 0;
      }
    }
  }
  if constexpr (kMasked) {
    const int lg = group_log2(kp);
    const int g = 1 << lg;
    const int sub = lane & (g - 1);
    for (int r0 = 0; r0 < kp; r0 += kThreads >> lg) {
      const int j = r0 + static_cast<int>(threadIdx.x >> lg);
      const float dj = j < kp ? r.d[j] : 0.f;
      int shift = j < kp ? count_where(s.fd, n, sub, g,
                                       [&](int h, float dh) { return (dh < dj) & s.fok[h]; })
                         : 0;
      shift = group_sum(shift, g);
      if (j < kp && sub == 0 && j + shift < kp) {
        r.od[j + shift] = dj;
        r.oi[j + shift] = r.i[j];
      }
    }
  }
}

// 3. the next frontier of the merged beam (s.od, s.oi, s.ox), by warp 0
//    alone: the first E unexpanded finite slots, selected (and marked
//    expanded) only when the query is active. Returns `active` on every lane.
__device__ bool frontier(const Step& s, int ef, int e) {
  const int lane = lane_id();
  const float worst = s.od[ef - 1];
  bool act = false;
  int before = 0;  // unexpanded finite slots in the words scanned
  for (int r0 = 0; r0 < ef && before < e; r0 += 32) {
    const int r = r0 + lane;
    const bool open = r < ef && !s.ox[r] && isfinite(s.od[r]);
    const uint32_t bits = __ballot_sync(kFull, open);
    if (before == 0 && bits) {  // the best unexpanded slot decides `active`
      const float best = s.od[r0 + __ffs(bits) - 1];
      act = best <= worst || !isfinite(worst);
      if (!act) break;
    }
    if (open) {
      const int k = before + __popc(bits & ((1u << lane) - 1u));
      if (k < e) {
        s.cand[k] = s.oi[r];
        s.ox[r] = 1;
      }
    }
    before += __popc(bits);
  }
  const int n_sel = act ? (before < e ? before : e) : 0;
  for (int k = n_sel + lane; k < e; k += 32) s.cand[k] = -1;
  if (lane == 0) *s.active = act ? 1 : 0;
  return act;
}

// The frontier's adjacency rows into the window, by one warp (after
// frontier): ids < 0 give -1; four loads a lane in flight at a time.
// m0_inv = ceil(2^32 / m0): j / m0 = (j * m0_inv) >> 32, exact for j and
// m0 below 2^16 (W < 2048), so no integer division in the loop.
__device__ void load_window(const Step& s, const int32_t* __restrict__ adj0, int m0,
                            uint64_t m0_inv, int w) {
  for (int j0 = lane_id(); j0 < w; j0 += 4 * 32) {
    int32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 32 * u;
      const int k = static_cast<int>((static_cast<uint64_t>(j) * m0_inv) >> 32);
      const int32_t c = j < w ? s.cand[k] : -1;
      v[u] = c >= 0 ? __ldg(adj0 + static_cast<size_t>(c) * m0 + (j - k * m0)) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j0 + 32 * u < w) s.wi[j0 + 32 * u] = v[u];
    }
  }
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
  Results none{};
  layout(smem, ef, w, e, 0, 0, 0, &s, nullptr, nullptr, nullptr, nullptr);
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t ob = static_cast<size_t>(q) * ef;
  const size_t ow = static_cast<size_t>(q) * w;

  for (int j = tid; j < ef; j += blockDim.x) {
    s.d[j] = beam_d[ob + j];
    s.i[j] = beam_i[ob + j];
    s.x[j] = beam_x[ob + j] ? 1 : 0;
  }
  for (int j = tid; j < w; j += blockDim.x) s.wi[j] = nbrs[ow + j];
  if (tid == 0) *s.nf = 0;
  __syncthreads();

  dedup(s, ef, w, e, [&](int f, int j, int32_t id) {
    s.fid[f] = id;
    s.fj[f] = j;
    s.fd[f] = nd[ow + j];
  });
  __syncthreads();
  merge_window<false>(s, none, ef, 0, *s.nf);
  merge_beam<false>(s, none, ef, 0, *s.nf);
  __syncthreads();
  if (warp_id() == 0) frontier(s, ef, e);
  __syncthreads();

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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

// Internal distance of the query row to one row, both in shared memory, by
// one warp; every lane gets the result.
template <class R>
__device__ __forceinline__ float row_distance(const typename R::Vec* qv,
                                              const typename R::Vec* rv, int nv, int metric,
                                              typename R::Acc qq) {
  using Acc = typename R::Acc;
  Acc a = 0, b = 0;
  for (int c = lane_id(); c < nv; c += 32) R::add(metric, qv[c], rv[c], a, b);
  a = warp_sum(a);
  if (metric != kL1 && metric != kHamming) b = warp_sum(b);
  return R::finish(metric, a, b, qq);
}

// Moves ring position (f, slot, lap parity) forward to the first position
// at or after it whose slot belongs to `warp` (slot % kWarps == warp; the
// caller makes sure warp < ring).
__device__ __forceinline__ void next_owned(int& f, int& slot, uint32_t& par, int warp, int ring) {
  const int skip = (warp - slot) & (kWarps - 1);
  if (slot + skip < ring) {
    f += skip;
    slot += skip;
  } else {  // the next owned slot is `warp` itself, one lap on
    f += ring - slot + warp;
    slot = warp;
    par ^= 1u;
  }
}

// At most 64 registers a thread, so 4 blocks fit an SM where the shared
// memory allows (ops/beam.py:_loop_plan counts on it). Unmasked (kMasked
// false): node_mask, res_d and res_i are unused and out_d / out_i receive
// the beam [B, EF]. Masked: res_d / res_i are the seeded result buffers
// [B, KP] and out_d / out_i receive the final results [B, KP]. `ring` is
// the number of row slots, 1..W.
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
                          int ef, int m0, int e, int dp, int metric, int max_iters, int kp,
                          int ring) {
  using Elem = typename R::Elem;
  using Vec = typename R::Vec;
  using Acc = typename R::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = e * m0;
  const uint64_t m0_inv = ((uint64_t{1} << 32) + m0 - 1) / m0;
  const uint32_t row_bytes = sizeof(Elem) * dp;
  const int nv = dp / R::kPerVec;
  Step s;
  Results r{};
  unsigned char *qrow, *slots;
  uint64_t* bars;
  layout(smem, ef, w, e, row_bytes, ring, kMasked ? kp : 0, &s, &qrow, &slots, &bars, &r);
  const Vec* qv = reinterpret_cast<const Vec*>(qrow);
  const int qb = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int warp = warp_id();
  const size_t ob = static_cast<size_t>(qb) * ef;

  const Vec* qg = reinterpret_cast<const Vec*>(q + static_cast<size_t>(qb) * dp);
  for (int c = tid; c < nv; c += blockDim.x) reinterpret_cast<Vec*>(qrow)[c] = qg[c];
  for (int j = tid; j < ef; j += blockDim.x) {
    s.d[j] = beam_d[ob + j];
    s.i[j] = beam_i[ob + j];
    s.x[j] = beam_x[ob + j] ? 1 : 0;
  }
  for (int k = tid; k < e; k += blockDim.x) s.cand[k] = cand[static_cast<size_t>(qb) * e + k];
  if (tid == 0) {
    *s.active = active[qb] ? 1 : 0;
    *s.nf = 0;
    for (int k = 0; k < ring; ++k) bar_init(bars + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (kMasked) {
    const size_t orr = static_cast<size_t>(qb) * kp;
    for (int j = tid; j < kp; j += blockDim.x) {
      r.d[j] = res_d[orr + j];
      r.i[j] = res_i[orr + j];
    }
  }
  __syncthreads();
  // warp 0: |q|^2 and the first window
  if (warp == 0) {
    const Acc acc = warp_sum(R::norm_part(reinterpret_cast<const Elem*>(qrow), dp, lane));
    if (lane == 0) *reinterpret_cast<Acc*>(s.qq) = acc;
    if (*s.active) load_window(s, adj0, m0, m0_inv, w);
  }
  __syncthreads();
  const Acc qq = *reinterpret_cast<const Acc*>(s.qq);

  int head = 0;       // ring slot of the next fresh row
  uint32_t lap = 0;   // parity of that slot's lap
  int it = 0;
#ifdef TPUVEC_LOOP_CLOCKS
  unsigned long long clocks[kPhases] = {};
  long long clock_last = clock64();
#endif
  while (it < max_iters && *s.active) {
    // dedup; each fresh row's copy starts as soon as its place is claimed
    dedup(s, ef, w, e, [&](int f, int j, int32_t id) {
      s.fid[f] = id;
      s.fj[f] = j;
      if (f < ring) {
        const int slot = head + f < ring ? head + f : head + f - ring;
        copy_row(slots + static_cast<size_t>(slot) * row_bytes,
                 vectors + static_cast<size_t>(id) * dp, row_bytes, bars + slot);
      }
    });
    LOOP_CLOCK(0);
    __syncthreads();
    LOOP_CLOCK(1);
    const int n = *s.nf;
    if constexpr (kMasked) {  // while the rows are in flight
      for (int f = tid; f < n; f += blockDim.x) s.fok[f] = __ldg(node_mask + s.fid[f]) != 0;
    }

    // each warp reduces the rows of its slots, in ring order
    if (warp < ring) {
      int f = 0, slot = head;
      uint32_t par = lap;
      next_owned(f, slot, par, warp, ring);
      while (f < n) {
        const unsigned char* row = slots + static_cast<size_t>(slot) * row_bytes;
        wait_row(bars + slot, par);
        const float dist = row_distance<R>(qv, reinterpret_cast<const Vec*>(row), nv, metric, qq);
        if (lane == 0) s.fd[f] = dist;
        if (f + ring < n) {  // this slot's next row
          __syncwarp();
          if (lane == 0) {
            copy_row(slots + static_cast<size_t>(slot) * row_bytes,
                     vectors + static_cast<size_t>(s.fid[f + ring]) * dp, row_bytes,
                     bars + slot);
          }
        }
        ++f;
        if (++slot == ring) {
          slot = 0;
          par ^= 1u;
        }
        next_owned(f, slot, par, warp, ring);
      }
    }
    LOOP_CLOCK(2);
    __syncthreads();
    LOOP_CLOCK(3);
    if (n >= ring) {  // whole laps (rare: the plan sizes the ring for the window)
      lap ^= static_cast<uint32_t>((n / ring) & 1);
      head += n % ring;
    } else {
      head += n;
    }
    if (head >= ring) {
      head -= ring;
      lap ^= 1u;
    }
    if (tid == 0) *s.nf = 0;  // every thread has read n

    merge_window<kMasked>(s, r, ef, kp, n);
    LOOP_CLOCK(4);
    merge_beam<kMasked>(s, r, ef, kp, n);
    LOOP_CLOCK(5);
    __syncthreads();
    LOOP_CLOCK(6);
    // warp 0: the next frontier, then its adjacency rows into the window
    if (warp == 0 && frontier(s, ef, e)) {
      __syncwarp();
      load_window(s, adj0, m0, m0_inv, w);
    }
    LOOP_CLOCK(7);
    __syncthreads();
    LOOP_CLOCK(8);
    float* td = s.d; s.d = s.od; s.od = td;
    int32_t* ti = s.i; s.i = s.oi; s.oi = ti;
    uint8_t* tx = s.x; s.x = s.ox; s.ox = tx;
    if constexpr (kMasked) {
      float* rd = r.d; r.d = r.od; r.od = rd;
      int32_t* ri = r.i; r.i = r.oi; r.oi = ri;
    }
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
#ifdef TPUVEC_LOOP_CLOCKS
  if (tid == 0) {
    for (int k = 0; k < kPhases; ++k) atomicAdd(&g_loop_clocks[k], clocks[k]);
    atomicAdd(&g_loop_clocks[kPhases], static_cast<unsigned long long>(it));
  }
#endif
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

// Shared memory of one block of the loop kernel.
size_t level0_smem(int rows, bool masked, int ef, int m0, int e, int dp, int kp, int ring) {
  const size_t elem = rows == kRowsInt8 ? 1 : 4;
  return layout(nullptr, ef, e * m0, e, elem * dp, ring, masked ? kp : 0, nullptr, nullptr,
                nullptr, nullptr, nullptr);
}

// Launches the loop kernel of row form R, masked or not; see
// tpuvec_beam_search_level0.
template <class R, bool kMasked>
int launch_level0(const void* q, const void* vectors, const void* adj0, const void* beam_d,
                  const void* beam_i, const void* beam_x, const void* cand, const void* active,
                  const void* node_mask, const void* res_d, const void* res_i,
                  void* out_d, void* out_i, void* iters, int b, int ef, int m0, int e, int dp,
                  int metric, int max_iters, int kp, int ring, size_t smem,
                  cudaStream_t stream) {
  using Elem = typename R::Elem;
  if (const int rc = allow_smem(beam_search_level0_kernel<R, kMasked>, smem)) return rc;
  beam_search_level0_kernel<R, kMasked><<<b, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(vectors),
      static_cast<const int32_t*>(adj0), static_cast<const float*>(beam_d),
      static_cast<const int32_t*>(beam_i), static_cast<const uint8_t*>(beam_x),
      static_cast<const int32_t*>(cand), static_cast<const uint8_t*>(active),
      static_cast<const uint8_t*>(node_mask), static_cast<const float*>(res_d),
      static_cast<const int32_t*>(res_i), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), static_cast<int32_t*>(iters), ef, m0, e, dp, metric,
      max_iters, kp, ring);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the loop kernel of row form R an SM holds with `smem` bytes of
// shared memory, or kSmemTooLarge, or minus a CUDA error.
template <class R, bool kMasked>
int occupancy_level0(size_t smem) {
  if (const int rc = allow_smem(beam_search_level0_kernel<R, kMasked>, smem)) {
    return rc == kSmemTooLarge ? rc : -rc;
  }
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, beam_search_level0_kernel<R, kMasked>, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

using LaunchLevel0 = decltype(&launch_level0<F32Rows, false>);
using OccupancyLevel0 = decltype(&occupancy_level0<F32Rows, false>);

template <class R>
LaunchLevel0 pick_level0(bool masked) {
  return masked ? launch_level0<R, true> : launch_level0<R, false>;
}

template <class R>
OccupancyLevel0 pick_occupancy(bool masked) {
  return masked ? occupancy_level0<R, true> : occupancy_level0<R, false>;
}

// Whether the loop kernel takes rows of form `rows` and `dp` elements with
// distance form `metric`: a row must be whole 16-byte vectors (the bulk
// copy's unit), and Hamming runs on words only, every other form on f32 or
// int8 rows.
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
  const size_t smem = layout(nullptr, ef, w, e, 0, 0, 0, nullptr, nullptr, nullptr, nullptr,
                             nullptr);
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
// `rows` (kRowsF32 / kRowsInt8 / kRowsWords) with distance form `metric`,
// with `ring` row slots (1..W, W = e * m0; ops/beam.py:_loop_plan). With
// node_mask null, out_d / out_i [b, ef] receive the beam and res_d, res_i
// and kp are unused. With node_mask ([cap] bytes, 1 = the node may be
// returned), res_d / res_i are the seeded result buffers [b, kp] and
// out_d / out_i [b, kp] receive the results (the masked form). Launches on
// `stream` and returns cudaGetLastError(), or kSmemTooLarge.
int tpuvec_beam_search_level0(const void* q, const void* vectors, const void* adj0,
                              const void* beam_d, const void* beam_i, const void* beam_x,
                              const void* cand, const void* active, const void* node_mask,
                              const void* res_d, const void* res_i,
                              void* out_d, void* out_i, void* iters,
                              int b, int ef, int m0, int e, int dp, int rows, int metric,
                              int max_iters, int kp, int ring, void* stream) {
  const bool masked = node_mask != nullptr;
  if (bad_beam_shape(b, ef, e * m0, e) || m0 < 1 || max_iters < 0 ||
      !good_rows(rows, dp, metric) || (masked && (kp < 1 || !res_d || !res_i)) || ring < 1 ||
      ring > e * m0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const size_t smem = level0_smem(rows, masked, ef, m0, e, dp, kp, ring);
  const LaunchLevel0 launch = rows == kRowsF32    ? pick_level0<F32Rows>(masked)
                              : rows == kRowsInt8 ? pick_level0<Int8Rows>(masked)
                                                  : pick_level0<WordRows>(masked);
  return launch(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, node_mask, res_d,
                res_i, out_d, out_i, iters, b, ef, m0, e, dp, metric, max_iters, kp, ring, smem,
                static_cast<cudaStream_t>(stream));
}

// For a launch plan's check: writes the shared memory one block of the
// loop kernel takes at this shape to *smem_out (an int64) and returns how
// many blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or kSmemTooLarge, or minus a CUDA error.
int tpuvec_level0_occupancy(int rows, int masked, int ef, int m0, int e, int dp, int kp,
                            int ring, void* smem_out) {
  if (rows < kRowsF32 || rows > kRowsWords || ring < 1 || e < 1 || m0 < 1 || ef < 1) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = level0_smem(rows, masked != 0, ef, m0, e, dp, kp, ring);
  *static_cast<int64_t*>(smem_out) = static_cast<int64_t>(smem);
  const OccupancyLevel0 occ = rows == kRowsF32    ? pick_occupancy<F32Rows>(masked != 0)
                              : rows == kRowsInt8 ? pick_occupancy<Int8Rows>(masked != 0)
                                                  : pick_occupancy<WordRows>(masked != 0);
  return occ(smem);
}

#ifdef TPUVEC_LOOP_CLOCKS
// Copies the loop kernel's phase clocks (kPhases + 1 uint64: cycles of each
// phase summed over the blocks, then iterations) to `out` and clears them.
int tpuvec_loop_clocks(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_loop_clocks, sizeof(g_loop_clocks));
  if (err == cudaSuccess) {
    const unsigned long long zero[kPhases + 1] = {};
    err = cudaMemcpyToSymbol(g_loop_clocks, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif

const char* tpuvec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
