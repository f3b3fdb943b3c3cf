// settle_math.cuh: the per-slot settle-cycle arithmetic the settle kernels
// share (settle_cycles.cu, onepass_settle.cu, onepass_partials.cu), as
// device functions.
//
// Each function is the CUDA form of one of the plain torch functions in
// ops/decay.py, ops/update.py and ops/cycle_math.py. The state math uses
// the _rn intrinsics, which nvcc may not contract into an FMA, and an
// explicit FMA where the plain version has one (ops/fma.py), so the stored
// reliability, confidence and stamp are bit-equal to the plain version's. exp2 comes from CUDA's
// math library; the kernels are built without --use_fast_math.
//
// The cycle's rates come from a policy type. RecordedRates holds the module
// constants at compile time and divides by the half-life as a reciprocal
// multiplication, as the main path's plain version does; every kernel uses
// it unless it says otherwise. LaneRates reads one replay lane's rates,
// widened to T, from the lane kernel's shared memory, and divides by the
// half-life (ops/cycle_math.py::CycleParams, ops/decay.py).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace settle_math {

constexpr double kDefaultReliability = 0.50;
constexpr double kDefaultConfidence = 0.25;
constexpr double kHalfLifeDays = 30.0;
constexpr double kDecayFloor = 0.10;
constexpr double kBaseLearningRate = 0.15;
constexpr double kMaxUpdateStep = 0.10;
constexpr double kConfidenceGrowth = 0.10;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp2_(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2_(double x) { return exp2(x); }

// jnp.clip / torch.clamp: NaN passes through.
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// The recorded rates, constants of the program.
template <typename T>
struct RecordedRates {
  // -t / h as a multiplication by the reciprocal, as XLA and the plain
  // version (ops/decay.py) compute it for the constant half-life.
  __device__ __forceinline__ T decay_exponent(T elapsed) const {
    return mul_rn(-elapsed, T(1.0 / kHalfLifeDays));
  }
  __device__ __forceinline__ T floor() const { return T(kDecayFloor); }
  __device__ __forceinline__ T base_learning_rate() const { return T(kBaseLearningRate); }
  __device__ __forceinline__ T max_update_step() const { return T(kMaxUpdateStep); }
  __device__ __forceinline__ T growth() const { return T(kConfidenceGrowth); }
};

// One replay lane's rates (half-life, floor, base learning rate, maximum
// step, confidence growth): the lane kernel's shared copy of its row of a
// (C, 5) float32 params tensor, widened to T. Each rate is read where it
// is used, so a thread keeps no lane's rates in registers from one lane to
// the next.
template <typename T>
struct LaneRates {
  const T* rates;  // (5,), shared memory

  __device__ __forceinline__ explicit LaneRates(const T* row) : rates(row) {}

  // A true division by the lane's half-life, as the JAX package's vmapped
  // replay step computes it and the plain version (ops/decay.py) does.
  __device__ __forceinline__ T decay_exponent(T elapsed) const {
    return div_rn(-elapsed, rates[0]);
  }
  __device__ __forceinline__ T floor() const { return rates[1]; }
  __device__ __forceinline__ T base_learning_rate() const { return rates[2]; }
  __device__ __forceinline__ T max_update_step() const { return rates[3]; }
  __device__ __forceinline__ T growth() const { return rates[4]; }
};

// ops/decay.py::decayed_reliability_at on a slot that is eligible
// (exists and stamped): decay toward the floor, clamped, where time passed.
template <typename T, typename Rates = RecordedRates<T>>
__device__ __forceinline__ T decayed(T rel, T elapsed, const Rates& rates = Rates()) {
  const T floor_ = rates.floor();
  const T factor = exp2_(rates.decay_exponent(elapsed));
  const T value = add_rn(floor_, mul_rn(sub_rn(rel, floor_), factor));
  return elapsed > T(0) ? clip(value, floor_, T(1)) : rel;
}

// ops/cycle_math.py::read_phase for one slot at `now`: the decayed stored
// reliability, or the cold-start prior for a slot whose row does not exist.
template <typename T, typename Rates = RecordedRates<T>>
__device__ __forceinline__ T read_reliability(bool exists, T rel, T days, T now,
                                              const Rates& rates = Rates()) {
  if (!exists) return T(kDefaultReliability);
  T elapsed = sub_rn(now, days);
  elapsed = elapsed < T(0) ? T(0) : elapsed;
  return days > T(0) ? decayed(rel, elapsed, rates) : rel;
}

// ops/update.py::outcome_update, reliability half.
template <typename T>
__device__ __forceinline__ T update_rel(T rel, T delta) {
  return clip(add_rn(rel, delta), T(0), T(1));
}

// ops/update.py::outcome_update, confidence half: one fused multiply-add,
// as XLA contracts it in the JAX package's fused settle program.
template <typename T, typename Rates = RecordedRates<T>>
__device__ __forceinline__ T grow_conf(T conf, const Rates& rates = Rates()) {
  const T grown = fma_rn(sub_rn(T(1), conf), rates.growth(), conf);
  return grown > T(1) ? T(1) : grown;
}

// The times every slot of a `steps`-step loop (steps >= 1) shares. Step i
// runs at now0 + i, rounded in T, as make_loop_math computes it. From step
// 1 on every masked slot carries the previous step's stamp, so the last
// step's decay is one scalar (_fast_cycle_math).
template <typename T>
struct StepTimes {
  T now0;
  T now_last;
  T elapsed_last;
  bool eligible_last;
};

template <typename T>
__device__ __forceinline__ StepTimes<T> step_times(T now0, int64_t steps) {
  StepTimes<T> t;
  t.now0 = now0;
  t.now_last = add_rn(now0, T(steps - 1));
  const T prev_last = add_rn(now0, T(steps - 2));
  const T elapsed = sub_rn(t.now_last, prev_last);
  t.elapsed_last = elapsed < T(0) ? T(0) : elapsed;
  t.eligible_last = prev_last > T(0);
  return t;
}

// One masked slot's whole `steps`-step loop (steps >= 1) in registers.
// `rel` and `conf` enter as the slot's sanitised state (the cold-start
// prior for a cold slot) and leave settled; `days` is its stamp (0 when
// cold), read only by step 0's decay when steps == 1. Steps 0 .. steps-2
// only move the state (their consensus is discarded); the return value is
// the last step's decayed read weight, which feeds the market's sums, and
// `last_conf`, when given, receives the confidence that step reads (the
// one before its update). `Steps` is the loop counter's type: int32_t
// where the caller knows steps fits it, int64_t otherwise. `rates` are the
// cycle's rates (RecordedRates unless a replay lane passes its own).
template <typename T, typename Steps, typename Rates = RecordedRates<T>>
__device__ __forceinline__ T settle_slot(T& rel, T& conf, T days, T prob,
                                         bool outcome, Steps steps,
                                         const StepTimes<T>& t,
                                         T* last_conf = nullptr,
                                         const Rates& rates = Rates()) {
  const bool correct = (prob >= T(0.5)) == outcome;
  const T raw = mul_rn(rates.base_learning_rate(), correct ? T(1) : T(-1));
  const T delta = clip(raw, -rates.max_update_step(), rates.max_update_step());
  for (Steps s = 0; s + 1 < steps; ++s) {
    rel = update_rel(rel, delta);
    conf = grow_conf(conf, rates);
  }
  // The last step's read: against the slot's own stamp when it is step 0
  // (_cycle_math), against the scalar previous step otherwise.
  const T weight = steps == 1
      ? read_reliability(true, rel, days, t.now0, rates)
      : (t.eligible_last ? decayed(rel, t.elapsed_last, rates) : rel);
  if (last_conf != nullptr) *last_conf = conf;
  rel = update_rel(rel, delta);
  conf = grow_conf(conf, rates);
  return weight;
}

}  // namespace settle_math
