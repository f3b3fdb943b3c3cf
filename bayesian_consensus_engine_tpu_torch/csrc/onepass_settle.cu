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
//   0. (K <= 64) the market's K mask bytes, loaded together into a 64-bit
//      register mask, and each valid slot's stored row loaded beside its
//      exists byte rather than after it;
//   1. the analytics read at now0 on the PRE-update state (read_phase):
//      decayed reliability and confidence, cold slots 0.50 / 0.25;
//   2. (tie-break) the confidence moments are summed in slot order, and
//      (K <= 64) the slot's quantised key rint(p * 10^precision) and its
//      read reliability go to the thread's column of the block's dynamic
//      shared memory, laid out [slot][thread] in 4-byte words (keys, then
//      weights), so a warp's accesses fall in 32 distinct banks;
//   3. (bands) the four f32 moments w, w*p, w*p^2, w^2 enter a per-thread
//      binary-counter tree that adds adjacent pairs exactly as the
//      balanced tree of ops/uncertainty.py::band_sums does over
//      pow2_at_least(K) leaves padded with +0.0 (so every chunk_slots
//      gives the same bits, as there). The kernel is instantiated per
//      depth log2(pow2_at_least(K)) up to 6 (K <= 64) with the tree's
//      levels in registers (band_tree.cuh RegisterBandTree); a wider K
//      takes the same kernel with the run-time stack (BandTree, local
//      memory) and reads the valid slots from the mask;
//   4. the slot's whole `steps`-step loop runs in registers (settle_math.cuh)
//      and only the last step's weight enters the consensus sums.
// The tie-break's group statistics: for each group of valid slots with one
// key, the count, the weight sum (slot order) and the maximum reliability;
// the two best distinct groups under (density desc, max reliability desc,
// smaller key) are kept as the slots are visited, which is what the JAX
// package's chunked top-2 fold computes for any chunk width. One loop
// (tiebreak_groups) serves every K, over one of two sources of the pairs:
//   - K <= 64 (SharedPairs): after the pass, from shared memory, the valid
//     slots from the register mask. Each group is summed once, at its
//     first slot; its later slots are marked done in a register and only
//     add its 1/size to the slot-order sum, since folding a group again
//     changes nothing. The block has 256 threads while the pairs (8 bytes
//     a slot a thread) fit 48 KB (K <= 24), 128 up to K = 48 and 64 up to
//     K = 64, so no launch needs more shared memory than the default.
//   - a wider K (DevicePairs): before the pass, since the pass settles the
//     state in place, each pair recomputed from the pre-update state in
//     device memory; with nowhere to mark a slot done, every valid slot's
//     group is summed over all the valid slots (K^2). No shared memory, so
//     no K is too wide.
// The tie-break exists in float32 only (the JAX reference has no float64
// tie-break).

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
// exactly that; at K <= 64 the tie-break's pairs and the band tree never
// leave the SM. Beyond the bound the kernel reads a cold slot's stored
// cells, which it then ignores, and at K > 64 with the tie-break on it
// reads the pre-update state again for the group statistics (K^2 reads a
// market, mostly from L1).

#include <type_traits>

#include "band_tree.cuh"
#include "settle_math.cuh"

namespace {

using band_tree::BandTree;
using band_tree::RegisterBandTree;
using namespace settle_math;

constexpr int kThreads = 256;
constexpr size_t kSharedBytes = 48 * 1024;  // without an opt-in
constexpr int kMaxRegisterDepth = 6;  // K <= 64: one 64-bit valid mask
constexpr int32_t kSentinel = 2147483647;

// ops/tiebreak.py::_lex_ge: does group a beat or tie group b?
__device__ __forceinline__ bool lex_ge(float ad, float ar, int32_t ak,
                                       float bd, float br, int32_t bk) {
  return (ad > bd) || (ad == bd && (ar > br || (ar == br && ak <= bk)));
}

// A market's tie-break: the two best distinct groups so far under
// (density desc, max reliability desc, smaller key), the slot-order sum of
// 1/size over the valid slots, and the confidence moments.
struct Tiebreak {
  float d1 = -INFINITY, r1 = -INFINITY, d2 = -INFINITY, r2 = -INFINITY;
  int32_t k1 = kSentinel, k2 = kSentinel;
  float sum_inv = 0.0f;

  __device__ __forceinline__ void fold(float group_weight, float max_rel,
                                       int32_t key, int32_t count) {
    if (key == k1 || key == k2) return;  // a group already ranked
    const float density = __fdiv_rn(group_weight, static_cast<float>(count));
    if (lex_ge(density, max_rel, key, d1, r1, k1)) {
      d2 = d1; r2 = r1; k2 = k1;
      d1 = density; r1 = max_rel; k1 = key;
    } else if (lex_ge(density, max_rel, key, d2, r2, k2)) {
      d2 = density; r2 = max_rel; k2 = key;
    }
  }

  __device__ __forceinline__ void write(
      int64_t m, int32_t valid_count, float conf_sum, float conf_sq_sum,
      float recip, float* __restrict__ tb_prediction,
      float* __restrict__ tb_density, float* __restrict__ tb_max_rel,
      int32_t* __restrict__ tb_resolved_by, int32_t* __restrict__ tb_num_groups,
      float* __restrict__ tb_conf_var) const {
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
};

// 1/size, correctly rounded: the same bits as 1.0f / size.
__device__ __forceinline__ float inverse_size(int32_t count) {
  return __frcp_rn(static_cast<float>(count));
}

// The tie-break's group statistics over a market's valid slots, in slot
// order, from either source of the (key, read reliability) pairs below.
// A slot that `pairs` marks done belongs to a group already summed; its
// weight cell then holds the group's 1/size.
template <typename Pairs>
__device__ __forceinline__ void tiebreak_groups(Pairs& pairs, Tiebreak& tb) {
  for (auto j = pairs.slots(); j.more(); j.next()) {
    const auto slot = j.slot();
    if (pairs.done(slot)) {
      tb.sum_inv = __fadd_rn(tb.sum_inv, pairs.weight(slot));
      continue;
    }
    const int32_t key = pairs.key(slot);
    int32_t count = 0;
    float group_weight = 0.0f;
    float max_rel = -INFINITY;
    for (auto i = pairs.group(j); i.more(); i.next()) {
      if (pairs.key(i.slot()) != key) continue;
      const float weight = pairs.weight(i.slot());
      ++count;
      group_weight = __fadd_rn(group_weight, weight);
      max_rel = weight > max_rel ? weight : max_rel;
      pairs.join(i.slot());
    }
    const float inv = inverse_size(count);
    tb.sum_inv = __fadd_rn(tb.sum_inv, inv);
    pairs.close(slot, inv);
    tb.fold(group_weight, max_rel, key, count);
  }
}

// K <= 64: the pairs in the thread's shared-memory column (slot k at
// key_s[k * pitch] and w_s[k * pitch]), the valid slots in a register
// mask. A group's scan starts at its first slot and skips the slots
// already done; closing it marks its members done and gives its later
// slots' weight cells its 1/size.
struct SharedPairs {
  struct Bits {
    uint64_t rest;
    __device__ __forceinline__ bool more() const { return rest != 0; }
    __device__ __forceinline__ void next() { rest &= rest - 1; }
    __device__ __forceinline__ int slot() const {
      return __ffsll(static_cast<long long>(rest)) - 1;
    }
  };

  uint64_t valid;
  const int32_t* key_s;
  float* w_s;
  int pitch;
  uint64_t done_mask = 0;
  uint64_t members = 0;

  __device__ __forceinline__ Bits slots() const { return Bits{valid}; }
  __device__ __forceinline__ Bits group(const Bits& first) const {
    return Bits{first.rest & ~done_mask};
  }
  __device__ __forceinline__ bool done(int k) const {
    return ((done_mask >> k) & 1) != 0;
  }
  __device__ __forceinline__ int32_t key(int k) const { return key_s[k * pitch]; }
  __device__ __forceinline__ float weight(int k) const { return w_s[k * pitch]; }
  __device__ __forceinline__ void join(int k) { members |= uint64_t{1} << k; }
  __device__ __forceinline__ void close(int first, float inv) {
    done_mask |= members;
    for (uint64_t later = members & ~(uint64_t{1} << first); later != 0;
         later &= later - 1) {
      w_s[(__ffsll(static_cast<long long>(later)) - 1) * pitch] = inv;
    }
    members = 0;
  }
};

// K > 64: each pair recomputed from the pre-update state of market m in
// device memory, as the pass computes it (the key from the probability,
// the weight by read_reliability at now0). Nothing is marked done, so
// every valid slot's group is scanned over all the valid slots.
template <typename T>
struct DevicePairs {
  const T* probs;
  const uint8_t* mask;
  const T* rel;
  const T* days;
  const uint8_t* exists;
  T now0;
  float scale;
  int64_t m, num_markets, num_slots;

  struct Slots {
    const DevicePairs* pairs;
    int64_t k;
    __device__ __forceinline__ bool more() const { return k < pairs->num_slots; }
    __device__ __forceinline__ void next() {
      do ++k; while (k < pairs->num_slots && !pairs->mask[k * pairs->num_markets + pairs->m]);
    }
    __device__ __forceinline__ int64_t slot() const { return k; }
  };

  __device__ __forceinline__ Slots slots() const {
    Slots first{this, -1};
    first.next();
    return first;
  }
  __device__ __forceinline__ Slots group(const Slots&) const { return slots(); }
  __device__ __forceinline__ bool done(int64_t) const { return false; }
  __device__ __forceinline__ int32_t key(int64_t k) const {
    return static_cast<int32_t>(rintf(__fmul_rn(
        static_cast<float>(probs[k * num_markets + m]), scale)));
  }
  __device__ __forceinline__ float weight(int64_t k) const {
    const int64_t idx = k * num_markets + m;
    return exists[idx] ? static_cast<float>(read_reliability(true, rel[idx], days[idx], now0))
                       : static_cast<float>(T(kDefaultReliability));
  }
  __device__ __forceinline__ void join(int64_t) {}
  __device__ __forceinline__ void close(int64_t, float) {}
};

// kDepth: log2 of pow2_at_least(K) when it is at most kMaxRegisterDepth
// (the band tree in registers, the valid slots in a register mask, the
// tie-break's pairs in shared memory), or -1 for a wider K (the run-time
// stack, the mask read slot by slot, the pairs from device memory).
template <typename T, int kDepth>
__global__ void __launch_bounds__(kThreads) onepass_settle_kernel(
    const T* __restrict__ probs,          // (K, M)
    const uint8_t* __restrict__ mask,     // (K, M) bool
    const uint8_t* __restrict__ outcome,  // (M,) bool
    T* __restrict__ rel,                  // (K, M) in place
    T* __restrict__ conf,
    T* __restrict__ days,
    uint8_t* __restrict__ exists,
    T* __restrict__ consensus,            // (M,)
    // The tie-break's outputs as __restrict__ parameters: as a struct of
    // pointers they took 66 registers at depth 4 against 64, and an SM
    // held 3 blocks instead of 4.
    float* __restrict__ tb_prediction,    // (M,) each, tie-break on
    float* __restrict__ tb_density,
    float* __restrict__ tb_max_rel,
    int32_t* __restrict__ tb_resolved_by,
    int32_t* __restrict__ tb_num_groups,
    float* __restrict__ tb_conf_var,
    float* __restrict__ band_sums,        // (4, M), bands on
    int32_t* __restrict__ band_count,     // (M,), bands on
    T now0, float scale, float recip, int64_t num_slots, int64_t num_markets,
    int64_t steps, bool with_tiebreak, bool with_bands) {
  constexpr bool kRegisters = kDepth >= 0;
  using Tree = typename std::conditional<
      kRegisters, RegisterBandTree<kRegisters ? kDepth : 0>, BandTree>::type;
  // K <= 64: the tie-break's pairs, [slot][thread]: keys, then weights.
  extern __shared__ uint32_t pairs[];
  const int pitch = blockDim.x;
  int32_t* key_s = reinterpret_cast<int32_t*>(pairs) + threadIdx.x;
  float* w_s = reinterpret_cast<float*>(pairs) + num_slots * pitch + threadIdx.x;

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
  uint64_t valid_bits = 0;
  Tree tree;
  Tiebreak tb;

  if constexpr (!kRegisters && std::is_same<T, float>::value) {
    // K > 64: the group statistics first, while the state is pre-update.
    if (with_tiebreak) {
      DevicePairs<T> device_pairs{probs, mask, rel, days, exists, now0, scale,
                                  m, num_markets, num_slots};
      tiebreak_groups(device_pairs, tb);
    }
  }

  if constexpr (kRegisters) {
    // The market's mask bytes, all loads in flight at once, read once.
#pragma unroll
    for (int k = 0; k < (1 << kDepth); ++k) {
      if (k < num_slots && mask[k * num_markets + m]) valid_bits |= uint64_t{1} << k;
    }
  }

  for (int64_t k = 0; k < num_slots; ++k) {
    const int64_t idx = k * num_markets + m;
    const bool valid = kRegisters ? ((valid_bits >> k) & 1) != 0 : mask[idx] != 0;
    if (!valid) {
      if (with_bands) tree.push(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    ++valid_count;
    const T p = probs[idx];
    const bool existed = exists[idx] != 0;
    // The stored row is loaded beside the exists byte, not after it: the
    // slot is masked, so its cells are valid memory, and a cold slot's
    // values are not used. make_loop_math's sanitise: a cold slot starts
    // from the prior.
    const T stored_r = rel[idx];
    const T stored_c = steps > 0 || with_tiebreak ? conf[idx] : T(0);
    const T stored_d = analytics || steps == 1 ? days[idx] : T(0);
    T r = existed ? stored_r : T(kDefaultReliability);
    T c = existed && (steps > 0 || with_tiebreak) ? stored_c : T(kDefaultConfidence);
    T d = existed ? stored_d : T(0);

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
        if constexpr (kRegisters) {
          const float key = rintf(__fmul_rn(static_cast<float>(p), scale));
          key_s[k * pitch] = static_cast<int32_t>(key);
          w_s[k * pitch] = w;
        }
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
      if constexpr (kRegisters) {
        SharedPairs shared_pairs{valid_bits, key_s, w_s, pitch};
        tiebreak_groups(shared_pairs, tb);
      }
      tb.write(m, valid_count, conf_sum, conf_sq_sum, recip, tb_prediction,
               tb_density, tb_max_rel, tb_resolved_by, tb_num_groups,
               tb_conf_var);
    }
  }
}

// The kernel of K's band-tree depth.
template <typename T>
auto kernel_for(int64_t num_slots) -> decltype(&onepass_settle_kernel<T, -1>) {
  int depth = 0;
  while ((int64_t{1} << depth) < num_slots) ++depth;
  static_assert(kMaxRegisterDepth == 6, "one case per register depth");
  switch (depth) {
    case 0: return onepass_settle_kernel<T, 0>;
    case 1: return onepass_settle_kernel<T, 1>;
    case 2: return onepass_settle_kernel<T, 2>;
    case 3: return onepass_settle_kernel<T, 3>;
    case 4: return onepass_settle_kernel<T, 4>;
    case 5: return onepass_settle_kernel<T, 5>;
    case 6: return onepass_settle_kernel<T, 6>;
    default: return onepass_settle_kernel<T, -1>;
  }
}

template <typename T>
int launch(const void* probs, const void* mask, const void* outcome,
           void* rel, void* conf, void* days, void* exists, void* consensus,
           void* tb_prediction, void* tb_density, void* tb_max_rel,
           void* tb_resolved_by, void* tb_num_groups, void* tb_conf_var,
           void* band_sums, void* band_count, double now0, double scale,
           double recip, int64_t num_slots, int64_t num_markets,
           int64_t steps, int with_tiebreak, int with_bands, void* stream) {
  if (num_markets > 0) {
    // K <= 64 with the tie-break on: its pairs in shared memory, 8 bytes a
    // slot a thread, at most 32 KB a block (64 threads at K = 64).
    const bool shared_pairs =
        with_tiebreak && num_slots <= (int64_t{1} << kMaxRegisterDepth);
    const size_t per_thread = shared_pairs ? static_cast<size_t>(num_slots) * 8 : 0;
    int threads = kThreads;
    while (per_thread * threads > kSharedBytes) threads /= 2;
    const int64_t blocks = (num_markets + threads - 1) / threads;
    kernel_for<T>(num_slots)<<<static_cast<unsigned int>(blocks), threads,
                               per_thread * threads,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(probs), static_cast<const uint8_t*>(mask),
        static_cast<const uint8_t*>(outcome), static_cast<T*>(rel),
        static_cast<T*>(conf), static_cast<T*>(days),
        static_cast<uint8_t*>(exists), static_cast<T*>(consensus),
        static_cast<float*>(tb_prediction), static_cast<float*>(tb_density),
        static_cast<float*>(tb_max_rel),
        static_cast<int32_t*>(tb_resolved_by),
        static_cast<int32_t*>(tb_num_groups),
        static_cast<float*>(tb_conf_var),
        static_cast<float*>(band_sums), static_cast<int32_t*>(band_count),
        static_cast<T>(now0), static_cast<float>(scale),
        static_cast<float>(recip), num_slots, num_markets, steps,
        with_tiebreak != 0, with_bands != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int onepass_settle_f32(
    const void* probs, const void* mask, const void* outcome, void* rel,
    void* conf, void* days, void* exists, void* consensus,
    void* tb_prediction, void* tb_density, void* tb_max_rel,
    void* tb_resolved_by, void* tb_num_groups, void* tb_conf_var,
    void* band_sums, void* band_count, double now0, double scale,
    double recip, int64_t num_slots, int64_t num_markets, int64_t steps,
    int with_tiebreak, int with_bands, void* stream) {
  return launch<float>(probs, mask, outcome, rel, conf, days, exists,
                       consensus, tb_prediction, tb_density, tb_max_rel,
                       tb_resolved_by, tb_num_groups, tb_conf_var, band_sums,
                       band_count, now0, scale, recip, num_slots, num_markets,
                       steps, with_tiebreak, with_bands, stream);
}

// float64 state: the tie-break is refused by the wrapper (the JAX reference
// has no float64 tie-break); the band moments are float32 as there.
extern "C" int onepass_settle_f64(
    const void* probs, const void* mask, const void* outcome, void* rel,
    void* conf, void* days, void* exists, void* consensus,
    void* tb_prediction, void* tb_density, void* tb_max_rel,
    void* tb_resolved_by, void* tb_num_groups, void* tb_conf_var,
    void* band_sums, void* band_count, double now0, double scale,
    double recip, int64_t num_slots, int64_t num_markets, int64_t steps,
    int with_tiebreak, int with_bands, void* stream) {
  if (with_tiebreak) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(probs, mask, outcome, rel, conf, days, exists,
                        consensus, tb_prediction, tb_density, tb_max_rel,
                        tb_resolved_by, tb_num_groups, tb_conf_var, band_sums,
                        band_count, now0, scale, recip, num_slots, num_markets,
                        steps, with_tiebreak, with_bands, stream);
}
