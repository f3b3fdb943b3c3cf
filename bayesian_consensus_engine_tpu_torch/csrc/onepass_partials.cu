// onepass_partials: one sources shard's one-pass sweep over its resident
// slot-major (K_loc, M) block, emitting the partials the cross-shard merge
// needs, in one launch.
//
// Replaces ops/pallas_settle.py::_onepass_partials_kernel of the JAX
// package (made by build_onepass_partials, pallas_call at
// pallas_settle.py:511), which runs once per shard of a mesh whose sources
// axis has more than one shard (parallel/sharded.py:776-857). Its plain
// version, which it is held against, is
// ops/partials_kernel.py::onepass_partials_reference.
//
// Layout. Slot k of market m sits at k * M + m. One thread owns one market
// and walks its K_loc slots in order, so adjacent threads touch adjacent
// addresses (coalesced); each slot is read and written by that thread only,
// so the state is updated in place. Up to K_loc = 64 the thread first loads
// its K_loc mask and exists bytes together into two 64-bit register masks,
// so those loads are all in flight at once.
//
// Per market, in one pass over its slots:
//   1. (views) the decayed read of the PRE-update state at now0
//      (read_phase): read_rel and read_conf written for every slot, cold
//      slots 0.50 / 0.25. The tie-break runs outside the kernel over these
//      views: a tie-break group can span shards, so no per-shard fold is
//      exact. Each view is computed from the slot's state before the step
//      loop below overwrites it;
//   2. (bands) the four f32 moments of each masked slot's read weight enter
//      the per-thread binary-counter tree of band_tree.cuh: the
//      adjacent-pair tree over pow2_at_least(K_loc) LOCAL leaves, so every
//      chunk_slots gives the same bits and the merge's tree over the shards'
//      roots rebuilds the global tree when K_loc is a power of two. The
//      kernel is instantiated per depth log2(pow2_at_least(K_loc)) up to 6
//      (K_loc <= 64) with the tree's levels in registers
//      (RegisterBandTree); a wider K_loc takes the run-time stack
//      (BandTree, local memory). Both push the same leaves in the same
//      order, padding leaves included, so the association and the bits are
//      the same;
//   3. the slot's whole `steps`-step loop in registers (settle_math.cuh),
//      the state written in place, and the LAST step's weight w, w*p and
//      w*conf (conf as that step reads it) added in slot order.
// Then the (3, M) raw sums, the (4, M) band roots and the (M,) count of
// masked slots. With steps == 0 (the zero-step mode) the state is left
// alone and the raw sums are zero; the caller writes the zero consensus of
// a zero-step program instead of normalising them.
//
// Masked-out slots (pad slots from pad_k among them: mask false, the cold
// prior) are neither read nor written by the loop, add nothing to any sum
// or count, and enter the band tree as +0.0 leaves; with the views on their
// state is read for the views only.
//
// Numerics. The state is bit-equal to the plain version (settle_math.cuh,
// _rn intrinsics and explicit FMAs); the views and band roots too. The raw
// sums are added in slot order, the plain version's torch.sum in its own
// order: they agree within a stated tolerance. Built without
// --use_fast_math.
//
// Bound. Device-memory bytes: the mask of every slot; per masked slot its
// probability and exists byte and, when its row exists, its stored
// reliability, confidence and stamp; with the views on, the exists byte and
// the stored state of every slot, and both views written; with steps > 0
// the settled reliability, confidence and stamp of every masked slot
// written (exists only where it turns true) and the outcome read; per
// market the three raw sums and the five band values written.
// ops/partials_kernel.py::bound_bytes counts exactly that. Beyond it, up
// to K_loc = 64, the kernel reads the exists byte of every slot (with the
// views off the bound counts only the masked slots'). Nothing else crosses
// device memory up to K_loc = 64: no scratch block, no tie-break inside,
// the band tree in registers.

#include <type_traits>

#include "band_tree.cuh"
#include "settle_math.cuh"

namespace {

using band_tree::BandTree;
using band_tree::RegisterBandTree;
using namespace settle_math;

constexpr int kThreads = 256;
constexpr int kMaxRegisterDepth = 6;  // K_loc <= 64: one 64-bit mask

// kDepth: log2 of pow2_at_least(K_loc) when it is at most
// kMaxRegisterDepth (the band tree in registers, the mask and exists bytes
// in register masks), or -1 for a wider K_loc (the run-time stack, the
// bytes read slot by slot).
template <typename T, int kDepth>
__global__ void __launch_bounds__(kThreads) onepass_partials_kernel(
    const T* __restrict__ probs,          // (K, M)
    const uint8_t* __restrict__ mask,     // (K, M) bool
    const uint8_t* __restrict__ outcome,  // (M,) bool
    T* __restrict__ rel,                  // (K, M) in place
    T* __restrict__ conf,
    T* __restrict__ days,
    uint8_t* __restrict__ exists,
    T* __restrict__ csums,                // (3, M): sum w, w*p, w*conf
    float* __restrict__ band_sums,        // (4, M), bands on
    int32_t* __restrict__ band_count,     // (M,), bands on
    T* __restrict__ read_rel,             // (K, M), views on
    T* __restrict__ read_conf,            // (K, M), views on
    int32_t* __restrict__ depth_out,      // (1,) or null: receives kDepth
    T now0, int64_t num_slots, int64_t num_markets, int64_t steps,
    bool with_views, bool with_bands) {
  constexpr bool kRegisters = kDepth >= 0;
  using Tree = typename std::conditional<
      kRegisters, RegisterBandTree<kRegisters ? kDepth : 0>, BandTree>::type;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= num_markets) return;
  // The instantiation this launch runs, for a caller that asks.
  if (depth_out != nullptr && m == 0) *depth_out = kDepth;
  const bool outcome_m = steps > 0 && outcome[m] != 0;
  const StepTimes<T> times = step_times(now0, steps > 0 ? steps : 1);

  T total_weight = T(0);
  T weighted_prob = T(0);
  T weighted_conf = T(0);
  int32_t valid_count = 0;
  Tree tree;

  uint64_t valid_bits = 0;
  uint64_t exists_bits = 0;
  if constexpr (kRegisters) {
    // The market's mask and exists bytes, all loads in flight at once.
#pragma unroll
    for (int k = 0; k < (1 << kDepth); ++k) {
      if (k < num_slots) {
        const int64_t idx = k * num_markets + m;
        if (mask[idx]) valid_bits |= uint64_t{1} << k;
        if (exists[idx]) exists_bits |= uint64_t{1} << k;
      }
    }
  }

  for (int64_t k = 0; k < num_slots; ++k) {
    const int64_t idx = k * num_markets + m;
    const bool valid = kRegisters ? ((valid_bits >> k) & 1) != 0 : mask[idx] != 0;
    if (!valid && !with_views) {
      if (with_bands) tree.push(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const bool existed =
        kRegisters ? ((exists_bits >> k) & 1) != 0 : exists[idx] != 0;
    // make_loop_math's sanitise: a cold slot starts from the prior.
    T r = T(kDefaultReliability);
    T c = T(kDefaultConfidence);
    T d = T(0);
    if (existed) {
      r = rel[idx];
      if (steps > 0 || with_views) c = conf[idx];
      if (with_views || with_bands || steps == 1) d = days[idx];
    }
    // The view of the PRE-update state, before the loop below moves r, c.
    const T view_rel = (with_views || with_bands)
        ? read_reliability(existed, r, d, now0) : T(0);
    if (with_views) {
      read_rel[idx] = view_rel;
      read_conf[idx] = c;
    }
    if (!valid) {
      if (with_bands) tree.push(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    ++valid_count;
    const T p = probs[idx];
    if (with_bands) {
      const float w = static_cast<float>(view_rel);
      const float pf = static_cast<float>(p);
      const float wp = __fmul_rn(w, pf);
      tree.push(w, wp, __fmul_rn(wp, pf), __fmul_rn(w, w));
    }
    if (steps > 0) {
      T last_conf;
      const T weight = settle_slot(r, c, d, p, outcome_m, steps, times, &last_conf);
      total_weight = add_rn(total_weight, weight);
      weighted_prob = add_rn(weighted_prob, mul_rn(p, weight));
      weighted_conf = add_rn(weighted_conf, mul_rn(last_conf, weight));
      rel[idx] = r;
      conf[idx] = c;
      days[idx] = times.now_last;
      if (!existed) exists[idx] = 1;
    }
  }

  csums[m] = total_weight;
  csums[num_markets + m] = weighted_prob;
  csums[2 * num_markets + m] = weighted_conf;
  if (with_bands) {
    tree.finish(num_slots, band_sums + m, num_markets);
    band_count[m] = valid_count;
  }
}

// The kernel of K_loc's band-tree depth. A launch given `depth_out`
// writes there the depth it ran (-1: the stack tree), so a caller can
// see which instantiation settled its shard.
template <typename T>
auto kernel_for(int64_t num_slots) -> decltype(&onepass_partials_kernel<T, -1>) {
  int depth = 0;
  while ((int64_t{1} << depth) < num_slots) ++depth;
  static_assert(kMaxRegisterDepth == 6, "one case per register depth");
  switch (depth) {
    case 0: return onepass_partials_kernel<T, 0>;
    case 1: return onepass_partials_kernel<T, 1>;
    case 2: return onepass_partials_kernel<T, 2>;
    case 3: return onepass_partials_kernel<T, 3>;
    case 4: return onepass_partials_kernel<T, 4>;
    case 5: return onepass_partials_kernel<T, 5>;
    case 6: return onepass_partials_kernel<T, 6>;
    default: return onepass_partials_kernel<T, -1>;
  }
}

template <typename T>
int launch(const void* probs, const void* mask, const void* outcome,
           void* rel, void* conf, void* days, void* exists, void* csums,
           void* band_sums, void* band_count, void* read_rel, void* read_conf,
           void* depth_out, double now0, int64_t num_slots,
           int64_t num_markets, int64_t steps, int with_views, int with_bands,
           void* stream) {
  if (num_markets > 0) {
    const int64_t blocks = (num_markets + kThreads - 1) / kThreads;
    kernel_for<T>(num_slots)<<<static_cast<unsigned int>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(probs), static_cast<const uint8_t*>(mask),
        static_cast<const uint8_t*>(outcome), static_cast<T*>(rel),
        static_cast<T*>(conf), static_cast<T*>(days),
        static_cast<uint8_t*>(exists), static_cast<T*>(csums),
        static_cast<float*>(band_sums), static_cast<int32_t*>(band_count),
        static_cast<T*>(read_rel), static_cast<T*>(read_conf),
        static_cast<int32_t*>(depth_out), static_cast<T>(now0), num_slots,
        num_markets, steps, with_views != 0, with_bands != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int onepass_partials_f32(
    const void* probs, const void* mask, const void* outcome, void* rel,
    void* conf, void* days, void* exists, void* csums, void* band_sums,
    void* band_count, void* read_rel, void* read_conf, void* depth_out,
    double now0, int64_t num_slots, int64_t num_markets, int64_t steps,
    int with_views, int with_bands, void* stream) {
  return launch<float>(probs, mask, outcome, rel, conf, days, exists, csums,
                       band_sums, band_count, read_rel, read_conf, depth_out,
                       now0, num_slots, num_markets, steps, with_views,
                       with_bands, stream);
}

// float64 state: the views and raw sums are float64, the band moments
// float32 (band_sums casts first), as the JAX package's XLA route has them.
extern "C" int onepass_partials_f64(
    const void* probs, const void* mask, const void* outcome, void* rel,
    void* conf, void* days, void* exists, void* csums, void* band_sums,
    void* band_count, void* read_rel, void* read_conf, void* depth_out,
    double now0, int64_t num_slots, int64_t num_markets, int64_t steps,
    int with_views, int with_bands, void* stream) {
  return launch<double>(probs, mask, outcome, rel, conf, days, exists, csums,
                        band_sums, band_count, read_rel, read_conf, depth_out,
                        now0, num_slots, num_markets, steps, with_views,
                        with_bands, stream);
}
