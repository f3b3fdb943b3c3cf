// onepass_settle: the analytics read, the ring tie-break, the raw band
// moments and N settle cycles over a resident slot-major (K, M) block, in
// one launch.
//
// Replaces ops/pallas_settle.py::_onepass_kernel of the JAX package
// (made by build_onepass_settle, pallas_call at pallas_settle.py:293),
// which computes what the one-device fused program
// (parallel/sharded.py:709-747) computes, in one sweep per tile. Its plain
// version, which it is held against, is
// ops/onepass_kernel.py::onepass_settle_reference.
//
// Layout. The block is slot-major (K, M): slot k of market m sits at
// k * M + m. One thread owns one market and walks its K slots in order
// 0 .. K-1, so adjacent threads touch adjacent addresses (coalesced). Each
// slot is read and written by that one thread only, so the state is
// updated in place, as the Pallas kernel's input/output aliases do. Slots
// whose mask is false are neither read nor written: make_loop_math leaves
// them bit-identical.
//
// Per market, in one pass over its slots:
//   1. the analytics read at now0 on the PRE-update state (read_phase):
//      decayed reliability and confidence, cold slots 0.50 / 0.25;
//   2. (tie-break) the slot's quantised key rint(p * 10^precision) and its
//      read reliability go to the scratch block; the confidence moments
//      are summed in slot order;
//   3. (bands) the four f32 moments w, w*p, w*p^2, w^2 enter a per-thread
//      binary-counter stack that adds adjacent pairs exactly as the
//      balanced tree of ops/uncertainty.py::band_sums does over
//      pow2_at_least(K) leaves padded with +0.0 (so every chunk_slots
//      gives the same bits, as there);
//   4. the slot's whole `steps`-step loop runs in registers (settle_math.cuh)
//      and only the last step's weight enters the consensus sums.
// Then the tie-break's group statistics: for each valid slot, the count,
// the weight sum (slot order) and the maximum reliability over the slots
// with its key, read back from the scratch block (K^2 comparisons per
// market); the two best distinct groups under (density desc, max
// reliability desc, smaller key) are kept as the slots are visited, which
// is what the JAX package's chunked top-2 fold computes for any chunk
// width. The tie-break exists in float32 only (the JAX reference has no
// float64 tie-break).
//
// Numerics. The state is bit-equal to the plain version (settle_math.cuh).
// Group weights, confidence moments and the consensus are summed in slot
// order and the band moments by the tree, all with _rn intrinsics; keys
// round half to even (rintf), as jnp.round does. Where XLA's CPU backend
// (the reference the tests run) rewrites or contracts an expression — the
// prediction's division by the constant scale becomes a multiplication by
// its reciprocal, and s2/n - mean^2 becomes a fused multiply-add — the
// kernel does the same, as the plain version does. Built without
// --use_fast_math, so division rounds correctly.
//
// Bound. Device-memory bytes: the mask of every slot; per masked slot its
// probability, exists byte and (when the row exists) the stored
// reliability, confidence and stamp, and, when steps > 0, the settled
// reliability, confidence and stamp written (exists only where it turns
// true); per market the outcome, the consensus, the six tie-break values
// and the five band values. ops/onepass_kernel.py::bound_bytes counts
// exactly that. The scratch block (8 bytes per masked slot, written once
// and read back K times from cache) is the price of a design that keeps
// no per-market array in registers; the bound does not count it.

#include <type_traits>

#include "band_tree.cuh"
#include "settle_math.cuh"

namespace {

using band_tree::BandTree;
using namespace settle_math;

constexpr int kThreads = 256;
constexpr int32_t kSentinel = 2147483647;

struct KeyWeight {
  int32_t key;
  float weight;
};

// ops/tiebreak.py::_lex_ge: does group a beat or tie group b?
__device__ __forceinline__ bool lex_ge(float ad, float ar, int32_t ak,
                                       float bd, float br, int32_t bk) {
  return (ad > bd) || (ad == bd && (ar > br || (ar == br && ak <= bk)));
}

// The tie-break's group statistics and top-two fold for market m, from the
// (key, read reliability) pairs its valid slots left in the scratch block.
// float32 only: the JAX reference has no float64 tie-break.
__device__ void tiebreak_groups(
    int64_t m, int64_t num_slots, int64_t num_markets,
    const uint8_t* __restrict__ mask, const KeyWeight* __restrict__ scratch,
    int32_t valid_count, float conf_sum, float conf_sq_sum, float recip,
    float* __restrict__ tb_prediction, float* __restrict__ tb_density,
    float* __restrict__ tb_max_rel, int32_t* __restrict__ tb_resolved_by,
    int32_t* __restrict__ tb_num_groups, float* __restrict__ tb_conf_var) {
  float d1 = -INFINITY, r1 = -INFINITY, d2 = -INFINITY, r2 = -INFINITY;
  int32_t k1 = kSentinel, k2 = kSentinel;
  float sum_inv = 0.0f;
  for (int64_t j = 0; j < num_slots; ++j) {
    const int64_t idx_j = j * num_markets + m;
    if (!mask[idx_j]) continue;
    const int32_t key = scratch[idx_j].key;
    int32_t count = 0;
    float group_weight = 0.0f;
    float max_rel = -INFINITY;
    for (int64_t i = 0; i < num_slots; ++i) {
      const int64_t idx_i = i * num_markets + m;
      if (!mask[idx_i]) continue;
      const KeyWeight other = scratch[idx_i];
      if (other.key != key) continue;
      ++count;
      group_weight = __fadd_rn(group_weight, other.weight);
      max_rel = other.weight > max_rel ? other.weight : max_rel;
    }
    const float size = static_cast<float>(count);
    sum_inv = __fadd_rn(sum_inv, __fdiv_rn(1.0f, size));
    if (key == k1 || key == k2) continue;  // a group already ranked
    const float density = __fdiv_rn(group_weight, size);
    if (lex_ge(density, max_rel, key, d1, r1, k1)) {
      d2 = d1; r2 = r1; k2 = k1;
      d1 = density; r1 = max_rel; k1 = key;
    } else if (lex_ge(density, max_rel, key, d2, r2, k2)) {
      d2 = density; r2 = max_rel; k2 = key;
    }
  }
  // XLA multiplies by the scale's float32 reciprocal instead of dividing.
  tb_prediction[m] =
      k1 != kSentinel ? __fmul_rn(static_cast<float>(k1), recip) : INFINITY;
  tb_density[m] = d1;
  tb_max_rel[m] = r1;
  tb_resolved_by[m] = k2 == kSentinel ? 0 : ((d1 == d2 && r1 == r2) ? 2 : 1);
  tb_num_groups[m] = static_cast<int32_t>(rintf(sum_inv));
  const float n = static_cast<float>(valid_count > 0 ? valid_count : 1);
  const float mean = __fdiv_rn(conf_sum, n);
  // s2/n - mean^2 as one fused multiply-add, as XLA contracts it.
  const float variance = __fmaf_rn(-mean, mean, __fdiv_rn(conf_sq_sum, n));
  tb_conf_var[m] = variance < 0.0f ? 0.0f : variance;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) onepass_settle_kernel(
    const T* __restrict__ probs,          // (K, M)
    const uint8_t* __restrict__ mask,     // (K, M) bool
    const uint8_t* __restrict__ outcome,  // (M,) bool
    T* __restrict__ rel,                  // (K, M) in place
    T* __restrict__ conf,
    T* __restrict__ days,
    uint8_t* __restrict__ exists,
    T* __restrict__ consensus,            // (M,)
    float* __restrict__ tb_prediction,    // (M,) each, tie-break on
    float* __restrict__ tb_density,
    float* __restrict__ tb_max_rel,
    int32_t* __restrict__ tb_resolved_by,
    int32_t* __restrict__ tb_num_groups,
    float* __restrict__ tb_conf_var,
    KeyWeight* __restrict__ scratch,      // (K, M), tie-break on
    float* __restrict__ band_sums,        // (4, M), bands on
    int32_t* __restrict__ band_count,     // (M,), bands on
    T now0, float scale, float recip, int64_t num_slots, int64_t num_markets,
    int64_t steps, bool with_tiebreak, bool with_bands) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= num_markets) return;
  const bool analytics = with_tiebreak || with_bands;
  const bool outcome_m = outcome[m] != 0;
  const StepTimes<T> times = step_times(now0, steps);

  T total_weight = T(0);
  T weighted_prob = T(0);
  int32_t valid_count = 0;
  float conf_sum = 0.0f;
  float conf_sq_sum = 0.0f;
  BandTree tree;

  for (int64_t k = 0; k < num_slots; ++k) {
    const int64_t idx = k * num_markets + m;
    if (!mask[idx]) {
      if (with_bands) tree.push(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    ++valid_count;
    const T p = probs[idx];
    const bool existed = exists[idx] != 0;
    // make_loop_math's sanitise: a cold slot starts from the prior.
    T r = T(kDefaultReliability);
    T c = T(kDefaultConfidence);
    T d = T(0);
    if (existed) {
      r = rel[idx];
      if (steps > 0 || with_tiebreak) c = conf[idx];
      if (analytics || steps == 1) d = days[idx];
    }

    if (analytics) {
      const float w = static_cast<float>(read_reliability(existed, r, d, now0));
      if (with_bands) {
        const float pf = static_cast<float>(p);
        const float wp = __fmul_rn(w, pf);
        tree.push(w, wp, __fmul_rn(wp, pf), __fmul_rn(w, w));
      }
      if (std::is_same<T, float>::value && with_tiebreak) {
        const float read_conf = static_cast<float>(c);
        conf_sum = __fadd_rn(conf_sum, read_conf);
        conf_sq_sum = __fadd_rn(conf_sq_sum, __fmul_rn(read_conf, read_conf));
        const float key = rintf(__fmul_rn(static_cast<float>(p), scale));
        scratch[idx] = KeyWeight{static_cast<int32_t>(key), w};
      }
    }

    if (steps > 0) {
      const T weight = settle_slot(r, c, d, p, outcome_m, steps, times);
      total_weight = add_rn(total_weight, weight);
      weighted_prob = add_rn(weighted_prob, mul_rn(p, weight));
      rel[idx] = r;
      conf[idx] = c;
      days[idx] = times.now_last;
      if (!existed) exists[idx] = 1;
    }
  }

  if (steps == 0) {
    consensus[m] = T(0);
  } else {
    consensus[m] = total_weight != T(0) ? weighted_prob / total_weight : T(NAN);
  }

  if (with_bands) {
    tree.finish(num_slots, band_sums + m, num_markets);
    band_count[m] = valid_count;
  }

  if constexpr (std::is_same<T, float>::value) {
    if (with_tiebreak) {
      tiebreak_groups(m, num_slots, num_markets, mask, scratch, valid_count,
                      conf_sum, conf_sq_sum, recip, tb_prediction, tb_density,
                      tb_max_rel, tb_resolved_by, tb_num_groups, tb_conf_var);
    }
  }
}

template <typename T>
int launch(const void* probs, const void* mask, const void* outcome,
           void* rel, void* conf, void* days, void* exists, void* consensus,
           void* tb_prediction, void* tb_density, void* tb_max_rel,
           void* tb_resolved_by, void* tb_num_groups, void* tb_conf_var,
           void* scratch, void* band_sums, void* band_count, double now0,
           double scale, double recip, int64_t num_slots, int64_t num_markets,
           int64_t steps, int with_tiebreak, int with_bands, void* stream) {
  if (num_markets > 0) {
    const int64_t blocks = (num_markets + kThreads - 1) / kThreads;
    onepass_settle_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(probs), static_cast<const uint8_t*>(mask),
        static_cast<const uint8_t*>(outcome), static_cast<T*>(rel),
        static_cast<T*>(conf), static_cast<T*>(days),
        static_cast<uint8_t*>(exists), static_cast<T*>(consensus),
        static_cast<float*>(tb_prediction), static_cast<float*>(tb_density),
        static_cast<float*>(tb_max_rel),
        static_cast<int32_t*>(tb_resolved_by),
        static_cast<int32_t*>(tb_num_groups),
        static_cast<float*>(tb_conf_var), static_cast<KeyWeight*>(scratch),
        static_cast<float*>(band_sums), static_cast<int32_t*>(band_count),
        static_cast<T>(now0), static_cast<float>(scale),
        static_cast<float>(recip), num_slots,
        num_markets, steps, with_tiebreak != 0, with_bands != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int onepass_settle_f32(
    const void* probs, const void* mask, const void* outcome, void* rel,
    void* conf, void* days, void* exists, void* consensus,
    void* tb_prediction, void* tb_density, void* tb_max_rel,
    void* tb_resolved_by, void* tb_num_groups, void* tb_conf_var,
    void* scratch, void* band_sums, void* band_count, double now0,
    double scale, double recip, int64_t num_slots, int64_t num_markets,
    int64_t steps, int with_tiebreak, int with_bands, void* stream) {
  return launch<float>(probs, mask, outcome, rel, conf, days, exists,
                       consensus, tb_prediction, tb_density, tb_max_rel,
                       tb_resolved_by, tb_num_groups, tb_conf_var, scratch,
                       band_sums, band_count, now0, scale, recip, num_slots,
                       num_markets, steps, with_tiebreak, with_bands, stream);
}

// float64 state: the tie-break is refused by the wrapper (the JAX reference
// has no float64 tie-break); the band moments are float32 as there.
extern "C" int onepass_settle_f64(
    const void* probs, const void* mask, const void* outcome, void* rel,
    void* conf, void* days, void* exists, void* consensus,
    void* tb_prediction, void* tb_density, void* tb_max_rel,
    void* tb_resolved_by, void* tb_num_groups, void* tb_conf_var,
    void* scratch, void* band_sums, void* band_count, double now0,
    double scale, double recip, int64_t num_slots, int64_t num_markets,
    int64_t steps, int with_tiebreak, int with_bands, void* stream) {
  if (with_tiebreak) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(probs, mask, outcome, rel, conf, days, exists,
                        consensus, tb_prediction, tb_density, tb_max_rel,
                        tb_resolved_by, tb_num_groups, tb_conf_var, scratch,
                        band_sums, band_count, now0, scale, recip, num_slots,
                        num_markets, steps, with_tiebreak, with_bands, stream);
}
