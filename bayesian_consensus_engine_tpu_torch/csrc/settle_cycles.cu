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
// Numerics. The per-slot math lives in settle_math.cuh (shared with
// onepass_settle.cu): stored reliability, confidence, stamp and existence
// are bit-equal to the plain version's. Only the consensus differs: exp2
// comes from CUDA's math library and the K-sum runs in slot order.
//
// Bound. Device-memory bytes: per plan slot the mask is read; per real
// slot its row index, probability and its row's exists are read, the row's
// rel and conf only if it exists (and its stamp when steps == 1), and rel,
// conf, stamp and rel_touched are written (exists only where it turns
// true); per market the outcome and its rel_touched offset are read and
// the consensus written. The random row gather is what will
// hold the kernel back: each 4- or 8-byte access pulls a 32-byte sector.

#include "settle_math.cuh"

namespace {

using namespace settle_math;

constexpr int kThreads = 256;

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
  const StepTimes<T> times = step_times(now0, steps);

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
    const T weight = settle_slot(r, c, d, p, outcome_m, steps, times);
    total_weight = add_rn(total_weight, weight);
    weighted_prob = add_rn(weighted_prob, mul_rn(p, weight));

    if (row >= 0) {
      rel[row] = r;
      conf[row] = c;
      days[row] = times.now_last;
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
