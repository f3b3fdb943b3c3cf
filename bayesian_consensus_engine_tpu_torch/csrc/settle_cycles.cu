// settle_cycles: gather -> N settle cycles -> scatter, in one launch.
//
// Replaces ops/pallas_cycle.py::_fused_cycle_kernel of the JAX package
// (one settle cycle on a slot-major (K, TILE_M) tile) together with the
// gather, the N-step loop and the scatter that pipeline.py::_settle_math
// wraps around the cycle. Its plain version, which it is held against, is
// ops/settle_kernel.py::settle_cycles_reference.
//
// Layout. The plan block is slot-major (K, M): slot k of market m sits at
// k * M + m. One thread owns one market and walks its K slots in order
// 0 .. K-1, so adjacent threads read adjacent plan columns (coalesced),
// while the flat state is gathered and scattered through slot_rows.
//
// Why the whole step loop runs inside each slot. Slots of one market meet
// only in the consensus sums, and only the LAST step's consensus is kept
// (make_loop_math discards the middle ones). The state update reads the
// undecayed value and never the consensus. So each slot can run its own
// steps - 1 updates in registers, add its last-step weight to the market's
// sums, run the last update and scatter: the result is the same as
// stepping the whole block, device-memory traffic does not grow with
// steps, and no K is too large (no per-market array, no scratch).
//
// In place. Every real (mask=true) slot of a plan owns a distinct flat row
// (the builders intern one row per (source, market) pair and markets are
// unique in a plan), so exactly one thread reads and writes each row.
// Unmasked slots are neither read nor written: make_loop_math restores
// them bit-identical, which leaves their rows as they were.
//
// Numerics. The state math uses the _rn intrinsics, which nvcc may not
// contract into an FMA, so the stored reliability, confidence, stamp and
// existence are bit-equal to the plain version's separately rounded torch
// operations. Only the consensus differs: exp2 comes from CUDA's math
// library and the K-sum runs in slot order. Built without
// --use_fast_math (it would change exp2f and division and flush denormals).
//
// Bound. Device-memory bytes: per plan slot the mask is read; per real
// slot its row index, probability and its row's exists are read, the row's
// rel and conf only if it exists (and its stamp when steps == 1), and rel,
// conf, stamp and rel_touched are written (exists only where it turns
// true); per market the outcome and its rel_touched offset are read and
// the consensus written. The random row gather is what will
// hold the kernel back: each 4- or 8-byte access pulls a 32-byte sector.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kDefaultReliability = 0.50;
constexpr double kDefaultConfidence = 0.25;
constexpr double kHalfLifeDays = 30.0;
constexpr double kDecayFloor = 0.10;
constexpr double kBaseLearningRate = 0.15;
constexpr double kMaxUpdateStep = 0.10;
constexpr double kConfidenceGrowth = 0.10;
constexpr int kThreads = 256;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float exp2_(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2_(double x) { return exp2(x); }

// jnp.clip / torch.clamp: NaN passes through.
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// ops/decay.py::decayed_reliability_at on a slot that is eligible
// (exists and stamped): decay toward the floor, clamped, where time passed.
template <typename T>
__device__ __forceinline__ T decayed(T rel, T elapsed) {
  const T floor_ = T(kDecayFloor);
  const T factor = exp2_(-elapsed / T(kHalfLifeDays));
  const T value = add_rn(floor_, mul_rn(sub_rn(rel, floor_), factor));
  return elapsed > T(0) ? clip(value, floor_, T(1)) : rel;
}

// ops/update.py::outcome_update, reliability half.
template <typename T>
__device__ __forceinline__ T update_rel(T rel, T delta) {
  return clip(add_rn(rel, delta), T(0), T(1));
}

// ops/update.py::outcome_update, confidence half.
template <typename T>
__device__ __forceinline__ T grow_conf(T conf) {
  const T grown = add_rn(conf, mul_rn(sub_rn(T(1), conf), T(kConfidenceGrowth)));
  return grown > T(1) ? T(1) : grown;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) settle_cycles_kernel(
    const int32_t* __restrict__ slot_rows,      // (K, M), -1 = pad
    const T* __restrict__ probs,                // (K, M)
    const uint8_t* __restrict__ mask,           // (K, M) bool
    const uint8_t* __restrict__ outcome,        // (M,) bool
    const int64_t* __restrict__ touched_offsets,  // (M + 1,)
    T* __restrict__ rel,                        // (capacity,) in place
    T* __restrict__ conf,
    T* __restrict__ days,
    uint8_t* __restrict__ exists,
    T* __restrict__ consensus,                  // (M,)
    T* __restrict__ rel_touched,                // (num_touched,)
    T now0, int64_t num_slots, int64_t num_markets, int64_t steps) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= num_markets) return;
  int64_t t = touched_offsets[m];

  if (steps == 0) {
    // Nothing settles: the state stays, the consensus is zero, and the
    // touched reliabilities are the stored ones.
    for (int64_t k = 0; k < num_slots; ++k) {
      const int64_t idx = k * num_markets + m;
      if (!mask[idx]) continue;
      const int32_t row = slot_rows[idx];
      rel_touched[t++] = row >= 0 ? rel[row] : T(kDefaultReliability);
    }
    consensus[m] = T(0);
    return;
  }

  const bool outcome_m = outcome[m] != 0;
  // Step i runs at now0 + i, rounded in T, as make_loop_math computes it.
  const T now_last = add_rn(now0, T(steps - 1));
  // From step 1 on every masked slot carries the previous step's stamp,
  // so the last step's decay is one scalar (_fast_cycle_math).
  const T prev_last = add_rn(now0, T(steps - 2));
  T elapsed_last = sub_rn(now_last, prev_last);
  elapsed_last = elapsed_last < T(0) ? T(0) : elapsed_last;
  const bool eligible_last = prev_last > T(0);
  const T max_step = T(kMaxUpdateStep);

  T total_weight = T(0);
  T weighted_prob = T(0);
  for (int64_t k = 0; k < num_slots; ++k) {
    const int64_t idx = k * num_markets + m;
    if (!mask[idx]) continue;  // zero weight, state untouched
    const int32_t row = slot_rows[idx];

    // Gather, then make_loop_math's one-time sanitise of cold slots.
    bool existed = false;
    T r = T(kDefaultReliability);
    T c = T(kDefaultConfidence);
    T d = T(0);
    if (row >= 0 && exists[row]) {
      existed = true;
      r = rel[row];
      c = conf[row];
      if (steps == 1) d = days[row];  // only step 0's read needs the stamp
    }

    const T p = probs[idx];
    const bool correct = (p >= T(0.5)) == outcome_m;
    const T raw = mul_rn(T(kBaseLearningRate), correct ? T(1) : T(-1));
    const T delta = clip(raw, -max_step, max_step);

    // Steps 0 .. steps-2: their consensus is discarded, so only the
    // state moves.
    for (int64_t s = 0; s + 1 < steps; ++s) {
      r = update_rel(r, delta);
      c = grow_conf(c);
    }

    // The last step's decayed read: against the slot's own stamp when it
    // is step 0 (_cycle_math), against the scalar previous step otherwise.
    T weight;
    if (steps == 1) {
      T elapsed = sub_rn(now0, d);
      elapsed = elapsed < T(0) ? T(0) : elapsed;
      weight = d > T(0) ? decayed(r, elapsed) : r;
    } else {
      weight = eligible_last ? decayed(r, elapsed_last) : r;
    }
    total_weight = add_rn(total_weight, weight);
    weighted_prob = add_rn(weighted_prob, mul_rn(p, weight));

    r = update_rel(r, delta);
    c = grow_conf(c);

    if (row >= 0) {
      rel[row] = r;
      conf[row] = c;
      days[row] = now_last;
      if (!existed) exists[row] = 1;
    }
    rel_touched[t++] = r;
  }
  consensus[m] = total_weight != T(0) ? weighted_prob / total_weight : T(NAN);
}

template <typename T>
int launch(const void* slot_rows, const void* probs, const void* mask,
           const void* outcome, const void* touched_offsets, void* rel,
           void* conf, void* days, void* exists, void* consensus,
           void* rel_touched, double now0, int64_t num_slots,
           int64_t num_markets, int64_t steps, void* stream) {
  if (num_markets > 0) {
    const int64_t blocks = (num_markets + kThreads - 1) / kThreads;
    settle_cycles_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(slot_rows), static_cast<const T*>(probs),
        static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(outcome),
        static_cast<const int64_t*>(touched_offsets), static_cast<T*>(rel),
        static_cast<T*>(conf), static_cast<T*>(days),
        static_cast<uint8_t*>(exists), static_cast<T*>(consensus),
        static_cast<T*>(rel_touched), static_cast<T>(now0), num_slots,
        num_markets, steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int settle_cycles_f32(
    const void* slot_rows, const void* probs, const void* mask,
    const void* outcome, const void* touched_offsets, void* rel, void* conf,
    void* days, void* exists, void* consensus, void* rel_touched, double now0,
    int64_t num_slots, int64_t num_markets, int64_t steps, void* stream) {
  return launch<float>(slot_rows, probs, mask, outcome, touched_offsets, rel,
                       conf, days, exists, consensus, rel_touched, now0,
                       num_slots, num_markets, steps, stream);
}

extern "C" int settle_cycles_f64(
    const void* slot_rows, const void* probs, const void* mask,
    const void* outcome, const void* touched_offsets, void* rel, void* conf,
    void* days, void* exists, void* consensus, void* rel_touched, double now0,
    int64_t num_slots, int64_t num_markets, int64_t steps, void* stream) {
  return launch<double>(slot_rows, probs, mask, outcome, touched_offsets, rel,
                        conf, days, exists, consensus, rel_touched, now0,
                        num_slots, num_markets, steps, stream);
}
