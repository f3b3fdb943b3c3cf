// settle_cycles: gather -> N settle cycles -> scatter, in one launch.
//
// Replaces ops/pallas_cycle.py::_fused_cycle_kernel of the JAX package
// (one settle cycle on a slot-major (K, TILE_M) tile) together with the
// gather, the N-step loop and the scatter that pipeline.py::_settle_math
// wraps around the cycle. Its plain version, which it is held against, is
// ops/settle_kernel.py::settle_cycles_reference.
//
// Why the whole step loop runs inside each slot. Slots of one market meet
// only in the consensus sums, and only the LAST step's consensus is kept
// (make_loop_math discards the middle ones). The state update reads the
// undecayed value and never the consensus. So each slot can run its own
// steps - 1 updates in registers, give its last-step weight to the
// market's sums, run the last update and scatter: the result is the same
// as stepping the whole block, and device-memory traffic does not grow
// with steps.
//
// Layout: one lane per masked slot. The plan block is slot-major (K, M):
// slot k of market m sits at k * M + m. A block takes a tile of 256
// consecutive markets, one a thread, in three passes:
//   (a) one thread per market reads its K mask bytes (adjacent threads,
//       adjacent bytes: coalesced) and copies each masked slot's row index,
//       probability and the market's outcome into the block's shared stage,
//       in market-major, slot-ascending order: slot j of market m at
//       touched_offsets[m] - touched_offsets[m0] + j, the order rel_touched
//       is written in;
//   (b) one thread per staged slot gathers its row's state, runs its whole
//       step loop (settle_slot, settle_math.cuh), scatters the state and
//       writes rel_touched[t] at consecutive t. A plan interns a market's
//       rows next to each other, so the gather and scatter through the rows
//       are nearly contiguous too. Its last-step weight w and w*p go back
//       to the stage;
//   (c) one thread per market adds its slots' w and w*p from the stage in
//       slot order from 0 with add_rn, as the per-market walk does, so the
//       consensus has the walk's bits.
// What this buys is coalescing. With one thread per market walking its K
// slots (the layout before), a warp's stores at one slot (the state rows,
// rel_touched) fell about four elements apart. The idle lanes of that
// layout's step loop cost nothing measurable: on an H100 a 1-step settle
// took what a 20-step one did (PERF.md, section 6).
//
// No ceiling on K. The stage holds `stage_slots` slots of 2 * sizeof(T) + 5
// bytes (w and the probability, then w*p; the row index; the outcome), at
// most 48 KB, the default a block may use without an opt-in. launch() sizes
// it for a typical tile from the launch's own counts (stage_slots_for):
// 1.25 times the plan's mean masked slots a market over the tile's 256
// markets, plus 32, so that a tile of a Poisson plan rarely overflows it
// (f32 at 4 slots a market: 1,312 slots, 17 KB, so the stage does not cut
// the SM's blocks below what its threads allow). A tile with more masked
// slots than the stage holds takes the wide route: the per-market walk, one
// thread per market over its K slots, which needs no shared memory. Both
// routes run in the same launch; the route is a tile's, the same for every
// thread of the block. A plan of many slots a market (more than ~11 in f32)
// sends most tiles down the wide route, which is the one-thread-a-market
// kernel this design replaced. A launch given `routes` counts its tiles
// there by route and writes the stage's size, so a caller sees which route
// ran.
//
// In place. Every real (mask=true) slot of a plan owns a distinct flat row
// (the builders intern one row per (source, market) pair and markets are
// unique in a plan), so exactly one thread reads and writes each row.
// Unmasked slots are neither read nor written: make_loop_math restores
// them bit-identical, which leaves their rows as they were.
//
// Numerics. The per-slot math lives in settle_math.cuh (shared with
// onepass_settle.cu and onepass_partials.cu): stored reliability,
// confidence, stamp and existence are bit-equal to the plain version's.
// Only the consensus differs: exp2 comes from CUDA's math library and the
// K-sum runs in slot order. The step loop's counter is 32-bit (a 64-bit
// instantiation takes steps beyond 2^31 - 1).
//
// Replay lanes. settle_cycles_lanes advances C copies of the flat state
// (stacked (C, R), lane-major) through the same plan in one launch, each
// lane with its own rates from its row of a (C, 5) float32 params tensor.
// It writes each lane's consensus, (C, M), and no rel_touched. Its plain
// version is ops/settle_kernel.py::settle_cycles_lanes_reference. Its own
// kernel, settle_cycles_lanes_kernel below, stages a tile once for a group
// of lanes where the tile's rows allow. The main path's instantiations
// take RecordedRates, the constants.
//
// Bound. Device-memory bytes: per plan slot the mask is read; per real
// slot its row index, probability and its row's exists are read, the row's
// rel and conf only if it exists (and its stamp when steps == 1), and rel,
// conf, stamp and rel_touched are written (exists only where it turns
// true); per market the outcome and its rel_touched offset are read and
// the consensus written.

#include <cmath>

#include "settle_math.cuh"

namespace {

using namespace settle_math;

constexpr int kThreads = 256;
constexpr size_t kSharedBytes = 48 * 1024;  // without an opt-in

// The stage's bytes a slot: w and (probability, then w*p) in T, the row
// index, the outcome.
template <typename T>
constexpr size_t stage_bytes_per_slot() {
  return 2 * sizeof(T) + sizeof(int32_t) + 1;
}

// The stage's slots: 1.25 times a tile's mean masked slots, plus 32,
// rounded up to 32, and no more than `budget` bytes hold at
// `bytes_per_slot` (the main kernel's stage, or the lane kernel's).
template <typename T>
int stage_slots_for(int64_t num_markets, int64_t num_touched,
                    size_t bytes_per_slot = stage_bytes_per_slot<T>(),
                    size_t budget = kSharedBytes) {
  const double mean =
      static_cast<double>(num_touched) / static_cast<double>(num_markets);
  const int64_t need =
      static_cast<int64_t>(std::ceil(kThreads * mean * 1.25)) + 32;
  const int64_t rounded = (need + 31) / 32 * 32;
  const int64_t capacity = budget / bytes_per_slot;
  return static_cast<int>(rounded < capacity ? rounded : capacity);
}

template <typename T>
struct Stage {
  T* w;
  T* wp;
  int32_t* row;
  uint8_t* outcome;

  __device__ __forceinline__ Stage(unsigned char* base, int slots)
      : w(reinterpret_cast<T*>(base)),
        wp(reinterpret_cast<T*>(base) + slots),
        row(reinterpret_cast<int32_t*>(base + 2 * sizeof(T) * slots)),
        outcome(base + (2 * sizeof(T) + sizeof(int32_t)) * slots) {}
};

template <typename T>
struct Plan {
  const int32_t* __restrict__ slot_rows;      // (K, M), -1 = pad
  const T* __restrict__ probs;                // (K, M)
  const uint8_t* __restrict__ mask;           // (K, M) bool
  const uint8_t* __restrict__ outcome;        // (M,) bool
  const int64_t* __restrict__ touched_offsets;  // (M + 1,)
  int64_t num_slots, num_markets;
};

template <typename T>
struct FlatState {
  T* __restrict__ rel;                        // (capacity,) in place
  T* __restrict__ conf;
  T* __restrict__ days;
  uint8_t* __restrict__ exists;
};

// One masked slot: gather its row (a pad row -1 reads the cold-start
// defaults), settle `steps` cycles, scatter, and return the last step's
// read weight; `rel_out` receives the settled reliability. With steps == 0
// the state stays and the stored reliability is returned through rel_out.
template <typename T, typename Steps, typename Rates>
__device__ __forceinline__ T settle_one(const FlatState<T>& s, int32_t row,
                                        T p, bool outcome, Steps steps,
                                        const StepTimes<T>& times,
                                        const Rates& rates, T& rel_out) {
  if (steps == 0) {
    rel_out = row >= 0 ? s.rel[row] : T(kDefaultReliability);
    return T(0);
  }
  // Gather, then make_loop_math's one-time sanitise of cold slots.
  bool existed = false;
  T r = T(kDefaultReliability);
  T c = T(kDefaultConfidence);
  T d = T(0);
  if (row >= 0 && s.exists[row]) {
    existed = true;
    r = s.rel[row];
    c = s.conf[row];
    if (steps == 1) d = s.days[row];  // only step 0's read needs the stamp
  }
  const T weight = settle_slot(r, c, d, p, outcome, steps, times,
                               static_cast<T*>(nullptr), rates);
  if (row >= 0) {
    s.rel[row] = r;
    s.conf[row] = c;
    s.days[row] = times.now_last;
    if (!existed) s.exists[row] = 1;
  }
  rel_out = r;
  return weight;
}

// The market's consensus from its last-step sums (0 when nothing settles).
template <typename T, typename Steps>
__device__ __forceinline__ T consensus_of(T total_weight, T weighted_prob,
                                          Steps steps) {
  if (steps == 0) return T(0);
  return total_weight != T(0) ? weighted_prob / total_weight : T(NAN);
}

// The wide route: market m's K slots walked in order by one thread, its
// last-step sums added into total_weight and weighted_prob. rel_touched is
// written when kTouched (not by replay lanes).
template <typename T, typename Steps, typename Rates, bool kTouched>
__device__ __forceinline__ void walk_market(const Plan<T>& plan,
                                            const FlatState<T>& s, int64_t m,
                                            Steps steps,
                                            const StepTimes<T>& times,
                                            const Rates& rates,
                                            T* __restrict__ rel_touched,
                                            T& total_weight, T& weighted_prob) {
  int64_t t = plan.touched_offsets[m];
  const bool outcome_m = plan.outcome[m] != 0;
  for (int64_t k = 0; k < plan.num_slots; ++k) {
    const int64_t idx = k * plan.num_markets + m;
    if (!plan.mask[idx]) continue;  // zero weight, state untouched
    const T p = plan.probs[idx];
    T r;
    const T weight = settle_one(s, plan.slot_rows[idx], p, outcome_m, steps,
                                times, rates, r);
    total_weight = add_rn(total_weight, weight);
    weighted_prob = add_rn(weighted_prob, mul_rn(p, weight));
    if constexpr (kTouched) rel_touched[t++] = r;
  }
}

// The staged route of a tile whose tile_slots masked slots start at
// rel_touched position t0, in three passes; the sums of market m (this
// thread's) come back in total_weight and weighted_prob.
template <typename T, typename Steps, typename Rates, bool kTouched>
__device__ __forceinline__ void settle_staged(
    const Plan<T>& plan, const FlatState<T>& s, const Stage<T>& stage,
    int64_t t0, int64_t tile_slots, int64_t m, bool owns_market,
    Steps steps, const StepTimes<T>& times, const Rates& rates,
    T* __restrict__ rel_touched, T& total_weight, T& weighted_prob) {
  const int64_t num_markets = plan.num_markets;
  // (a) stage the market's masked slots, market-major, slot-ascending.
  int first = 0;
  int count = 0;
  if (owns_market) {
    first = static_cast<int>(plan.touched_offsets[m] - t0);
    const uint8_t outcome_m = plan.outcome[m];
    for (int64_t k = 0; k < plan.num_slots; ++k) {
      const int64_t idx = k * num_markets + m;
      if (!plan.mask[idx]) continue;
      const int pos = first + count++;
      if (pos < tile_slots) {  // offsets that disagree with the mask
        stage.row[pos] = plan.slot_rows[idx];
        stage.wp[pos] = plan.probs[idx];
        stage.outcome[pos] = outcome_m;
      }
    }
  }
  __syncthreads();

  // (b) one thread a staged slot.
  for (int j = threadIdx.x; j < tile_slots; j += kThreads) {
    const T p = stage.wp[j];
    T r;
    const T weight = settle_one(s, stage.row[j], p, stage.outcome[j] != 0,
                                steps, times, rates, r);
    if constexpr (kTouched) rel_touched[t0 + j] = r;
    stage.w[j] = weight;
    stage.wp[j] = mul_rn(p, weight);
  }
  __syncthreads();

  // (c) one thread a market: its sums in slot order.
  if (owns_market) {
    for (int j = first; j < first + count && j < tile_slots; ++j) {
      total_weight = add_rn(total_weight, stage.w[j]);
      weighted_prob = add_rn(weighted_prob, stage.wp[j]);
    }
  }
}

// Blocks an SM must be able to hold, which caps ptxas' registers a thread
// at 65536 / (kThreads * blocks). float64 asks for 4 (64 registers): left
// to itself ptxas gives it 48 and keeps a register on the stack around the
// float64 division's slow-path call. float32 asks for 8 (32 registers,
// every thread of an SM resident) with the 32-bit step counter, the main
// path's instantiation, and 6 (42 registers) with the 64-bit one: asked
// for only 1, ptxas gives the main path's instantiation 40 registers.
template <typename T, typename Steps>
constexpr int kMinBlocks = sizeof(T) == 8 ? 4 : (sizeof(Steps) == 4 ? 8 : 6);

// One tile of kThreads consecutive markets (blockIdx.x), with `rates`;
// rel_touched is written when kTouched.
template <typename T, typename Steps, typename Rates, bool kTouched>
__device__ __forceinline__ void settle_tile(
    const Plan<T>& plan, const FlatState<T>& s, T* __restrict__ consensus,
    T* __restrict__ rel_touched, int32_t* __restrict__ routes, T now0,
    Steps steps, int stage_slots, const Rates& rates) {
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  const Stage<T> stage(stage_bytes, stage_slots);
  const StepTimes<T> times = step_times(now0, steps > 0 ? steps : Steps(1));
  const int64_t num_markets = plan.num_markets;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t m_end = m0 + kThreads < num_markets ? m0 + kThreads : num_markets;
  const int64_t t0 = plan.touched_offsets[m0];
  const int64_t tile_slots = plan.touched_offsets[m_end] - t0;
  const int64_t m = m0 + threadIdx.x;
  const bool owns_market = m < m_end;
  const bool wide = tile_slots > stage_slots;
  if (routes != nullptr && threadIdx.x == 0) {
    atomicAdd(&routes[wide ? 1 : 0], 1);  // tiles: staged, wide
    if (blockIdx.x == 0) routes[2] = stage_slots;
  }

  // The market's last-step sums, from either route; one division below.
  T total_weight = T(0);
  T weighted_prob = T(0);
  if (wide) {
    // The wide route, the same for the whole block: a tile the stage
    // cannot hold.
    if (owns_market) {
      walk_market<T, Steps, Rates, kTouched>(plan, s, m, steps, times, rates,
                                             rel_touched, total_weight,
                                             weighted_prob);
    }
  } else {
    settle_staged<T, Steps, Rates, kTouched>(
        plan, s, stage, t0, tile_slots, m, owns_market, steps, times, rates,
        rel_touched, total_weight, weighted_prob);
  }
  if (owns_market) consensus[m] = consensus_of(total_weight, weighted_prob, steps);
}

// One block a tile of kThreads consecutive markets.
template <typename T, typename Steps>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, Steps>)
settle_cycles_kernel(
    Plan<T> plan, FlatState<T> s,
    T* __restrict__ consensus,                  // (M,)
    T* __restrict__ rel_touched,                // (num_touched,)
    int32_t* __restrict__ routes,               // (3,) or null
    T now0, Steps steps, int stage_slots) {
  settle_tile<T, Steps, RecordedRates<T>, true>(
      plan, s, consensus, rel_touched, routes, now0, steps, stage_slots,
      RecordedRates<T>());
}

// ---------------------------------------------------------------------------
// Replay lanes: a tile of kThreads markets, settled for a group of lanes by
// one block where its rows allow, else for one lane a block.
//
// What bounds it. Each lane's state crosses device memory once each way
// (the same bytes a lane as the main kernel's, without rel_touched), and
// the plan once a launch: lanes_bound_bytes (ops/settle_kernel.py). A
// layout that stages a tile once a lane reads the plan's (K, M) mask, row
// indices and probabilities C times, and one whose threads hold a lane's
// rates in registers keeps fewer warps resident than the main kernel.
//
// What the design does. A block stages a tile's masked slots once and then
// settles them for each lane it takes in turn:
//   (a) as settle_staged's pass (a): one thread a market copies its masked
//       slots' row index, probability and outcome into the stage, in
//       rel_touched order; the lanes' float32 rates go beside them, widened
//       to T (LaneRates reads each where it is used: 40 registers in
//       float32, six blocks an SM);
//   (b) for each lane, one thread a staged slot gathers the lane's row,
//       runs its step loop with the lane's rates, scatters, and leaves its
//       last-step weight w in the stage. Slot-fastest thread order keeps a
//       warp on one lane and on the rows of a few markets;
//   (c) one thread a market adds its slots' w and w * p in slot order from
//       0 with add_rn (w * p from the staged probability, as settle_staged
//       forms it), and writes consensus[lane, m].
// Two barriers a lane: after (b), and after (c) before the next lane's (b)
// overwrites the weights. The stage takes the main kernel's bytes a slot
// (w and the probability in T, the row index, the outcome); a tile whose
// slots overflow it takes the wide route, the per-market walk, for each
// lane.
//
// Which lanes a block takes depends on the tile's rows, which each block
// samples first (tile_in_row_order). The grid is (tiles, C), tiles fastest.
// Where a tile's markets lie in row order, a lane's rows of the tile are
// one contiguous run that no other tile touches, and the block of a
// group's first lane settles the whole group: the plan is read once a
// (tile, group), and the group's other blocks return at once. Where they
// do not (a batch whose markets come in another order than the store
// interned their rows), each market's run of rows shares its 32-byte
// sectors with markets of other tiles; blocks then take one lane each, so
// that a lane's tiles run close together in time and those sectors are
// still in L2 when the other tiles come to them. On the replay trace's
// drifted batches sharing the plan made a launch slower than one lane a
// block; on its batches in row order it halved the launch's time
// (PERF.md, section 6, scripts/time_lane_kernel.py).
//
// Lanes a group takes at most. The launch spreads C lanes evenly over
// ceil(C / kLaneGroup) groups: up to kLaneGroup lanes the plan of a tile in
// row order is read once; beyond, once a group, which keeps more blocks in
// flight when C is large and the tiles are few.
constexpr int kLaneGroup = 16;
constexpr int kLaneParams = 5;  // (half-life, floor, rate, step, growth)

// The rates' bytes at the front of the lane kernel's shared memory.
template <typename T>
constexpr size_t lane_rates_bytes() {
  return kLaneGroup * kLaneParams * sizeof(T);
}

// The lane stage's slots: as the main kernel's, within what the rates
// leave of kSharedBytes.
template <typename T>
int lane_stage_slots_for(int64_t num_markets, int64_t num_touched) {
  return stage_slots_for<T>(num_markets, num_touched,
                            stage_bytes_per_slot<T>(),
                            kSharedBytes - lane_rates_bytes<T>());
}

template <typename T>
size_t lane_shared_bytes(int stage_slots) {
  return lane_rates_bytes<T>() +
         static_cast<size_t>(stage_slots) * stage_bytes_per_slot<T>();
}

template <typename T>
struct LaneStage {
  T* rates;    // (kLaneGroup, kLaneParams)
  T* w;
  T* prob;
  int32_t* row;
  uint8_t* outcome;

  __device__ __forceinline__ LaneStage(unsigned char* base, int slots)
      : rates(reinterpret_cast<T*>(base)),
        w(rates + kLaneGroup * kLaneParams),
        prob(w + slots),
        row(reinterpret_cast<int32_t*>(prob + slots)),
        outcome(reinterpret_cast<uint8_t*>(row + slots)) {}
};

// Lane c's rows of the stacked state: each field's row starts c * stride
// into the flat (C, R) tensor.
template <typename T>
__device__ __forceinline__ FlatState<T> lane_state(const FlatState<T>& s,
                                                   int64_t offset) {
  return FlatState<T>{s.rel + offset, s.conf + offset, s.days + offset,
                      s.exists + offset};
}

// Whether a tile's markets lie in row order, judged on 32 of its market
// boundaries spread over the tile, one a lane: where both markets hold a
// row in slot 0, the second's must follow the first's rows (its slot 0
// row plus its masked slots) at all but a quarter of them. A plan whose
// store interned its rows in the plan's market order passes (a fresh
// store, a stream that lists its markets in a stable order); a batch that
// lists its markets in another order than the store's rows does not. Each
// warp samples the same boundaries and reaches the same answer, with no
// barrier, its loads in flight beside the tile's offsets. The answer moves
// no bit of the results.
template <typename T>
__device__ __forceinline__ bool tile_in_row_order(const Plan<T>& plan,
                                                  int64_t m0, int64_t m_end) {
  const int64_t gaps = m_end - m0 - 1;
  const int64_t a = m0 + (threadIdx.x & 31) * (gaps > 32 ? gaps / 32 : 1);
  bool sampled = false;
  bool broken = false;
  if (a + 1 < m_end) {
    const int64_t row = plan.slot_rows[a];
    const int64_t next = plan.slot_rows[a + 1];
    sampled = row >= 0 && next >= 0;
    broken = sampled && next != row + plan.touched_offsets[a + 1] -
                                       plan.touched_offsets[a];
  }
  return 4 * __popc(__ballot_sync(0xffffffffu, broken)) <=
         __popc(__ballot_sync(0xffffffffu, sampled));
}

// Blocks an SM must be able to hold: float32 6 (at most 40 registers, 48
// warps resident), float64 3 (at most 80: at 64, ptxas keeps 16 bytes on
// the stack around the float64 division's slow path).
template <typename T>
constexpr int kLaneMinBlocks = sizeof(T) == 8 ? 3 : 6;

// One block a (tile, lane): blockIdx.x is the tile of kThreads markets,
// blockIdx.y a lane. A tile in row order is settled for a group of up to
// group_lanes lanes by the block of the group's first lane; any other
// tile for one lane by each block. The route report is the main kernel's,
// (tiles staged, tiles wide, stage slots), its tiles summed over the
// lanes; given six slots it also counts the tiles, summed over the lanes,
// that a block settled for its group of lanes (routes[3]), and writes the
// shared bytes a block was launched with (routes[4]) and group_lanes
// (routes[5]).
template <typename T, typename Steps>
__global__ void __launch_bounds__(kThreads, kLaneMinBlocks<T>)
settle_cycles_lanes_kernel(
    Plan<T> plan, FlatState<T> s, int64_t lane_stride,
    const float* __restrict__ params,           // (C, 5)
    int num_lanes, int group_lanes,
    T* __restrict__ consensus,                  // (C, M)
    int32_t* __restrict__ routes,               // (route_slots,) or null
    int route_slots, T now0, Steps steps, int stage_slots) {
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  const LaneStage<T> stage(stage_bytes, stage_slots);
  const int64_t num_markets = plan.num_markets;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t m_end = m0 + kThreads < num_markets ? m0 + kThreads : num_markets;
  const int64_t m = m0 + threadIdx.x;
  // The tile's lanes: in row order, the group that starts at lane
  // blockIdx.y (the other blocks of the group have nothing to do);
  // scattered, lane blockIdx.y alone.
  const int c0 = static_cast<int>(blockIdx.y);
  const bool grouped = tile_in_row_order(plan, m0, m_end);
  int lanes = 1;
  if (grouped) {
    if (c0 % group_lanes != 0) return;
    lanes = min(group_lanes, num_lanes - c0);
  }
  if (threadIdx.x < lanes * kLaneParams) {
    stage.rates[threadIdx.x] =
        T(params[static_cast<int64_t>(c0) * kLaneParams + threadIdx.x]);
  }
  const StepTimes<T> times = step_times(now0, steps > 0 ? steps : Steps(1));
  const int64_t t0 = plan.touched_offsets[m0];
  const int64_t tile_slots = plan.touched_offsets[m_end] - t0;
  const bool owns_market = m < m_end;
  const bool wide = tile_slots > stage_slots;
  if (routes != nullptr && threadIdx.x == 0) {
    atomicAdd(&routes[wide ? 1 : 0], lanes);  // tiles, summed over lanes
    if (grouped && route_slots > 3) atomicAdd(&routes[3], lanes);
    if (blockIdx.x == 0 && blockIdx.y == 0) {
      routes[2] = stage_slots;
      if (route_slots > 3) {
        unsigned int shared;
        asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(shared));
        routes[4] = static_cast<int32_t>(shared);
        routes[5] = group_lanes;
      }
    }
  }

  if (wide) {
    // The wide route, the same for the whole block: the per-market walk,
    // a lane at a time.
    __syncthreads();  // the rates
    if (!owns_market) return;
    for (int lane = 0; lane < lanes; ++lane) {
      const int64_t c = c0 + lane;
      T total_weight = T(0);
      T weighted_prob = T(0);
      walk_market<T, Steps, LaneRates<T>, false>(
          plan, lane_state(s, c * lane_stride), m, steps, times,
          LaneRates<T>(stage.rates + lane * kLaneParams), nullptr,
          total_weight, weighted_prob);
      consensus[c * num_markets + m] =
          consensus_of(total_weight, weighted_prob, steps);
    }
    return;
  }

  // (a) stage the market's masked slots, market-major, slot-ascending.
  int first = 0;
  int count = 0;
  if (owns_market) {
    first = static_cast<int>(plan.touched_offsets[m] - t0);
    const uint8_t outcome_m = plan.outcome[m];
    for (int64_t k = 0; k < plan.num_slots; ++k) {
      const int64_t idx = k * num_markets + m;
      if (!plan.mask[idx]) continue;
      const int pos = first + count++;
      if (pos < tile_slots) {  // offsets that disagree with the mask
        stage.row[pos] = plan.slot_rows[idx];
        stage.prob[pos] = plan.probs[idx];
        stage.outcome[pos] = outcome_m;
      }
    }
  }
  __syncthreads();  // the stage and the rates

  for (int lane = 0; lane < lanes; ++lane) {
    const int64_t c = c0 + lane;
    // (b) one thread a staged slot, on lane c's rows with its rates.
    const FlatState<T> lane_s = lane_state(s, c * lane_stride);
    const LaneRates<T> rates(stage.rates + lane * kLaneParams);
    for (int j = threadIdx.x; j < tile_slots; j += kThreads) {
      T r;
      stage.w[j] = settle_one(lane_s, stage.row[j], stage.prob[j],
                              stage.outcome[j] != 0, steps, times, rates, r);
    }
    __syncthreads();
    // (c) one thread a market: its sums in slot order.
    if (owns_market) {
      T total_weight = T(0);
      T weighted_prob = T(0);
      for (int j = first; j < first + count && j < tile_slots; ++j) {
        total_weight = add_rn(total_weight, stage.w[j]);
        weighted_prob =
            add_rn(weighted_prob, mul_rn(stage.prob[j], stage.w[j]));
      }
      consensus[c * num_markets + m] =
          consensus_of(total_weight, weighted_prob, steps);
    }
    __syncthreads();  // the weights, before the next lane's (b)
  }
}

template <typename T, typename Steps>
int launch_steps(const Plan<T>& plan, const FlatState<T>& s, T* consensus,
                 T* rel_touched, int32_t* routes, T now0, Steps steps,
                 int stage_slots, cudaStream_t stream) {
  const size_t shared = static_cast<size_t>(stage_slots) * stage_bytes_per_slot<T>();
  const int64_t tiles = (plan.num_markets + kThreads - 1) / kThreads;
  settle_cycles_kernel<T, Steps><<<static_cast<unsigned int>(tiles), kThreads,
                                   shared, stream>>>(
      plan, s, consensus, rel_touched, routes, now0, steps, stage_slots);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a group at most: C spread evenly over ceil(C / kLaneGroup)
// groups (the last may hold fewer).
inline int group_lanes_for(int64_t num_lanes) {
  const int64_t groups = (num_lanes + kLaneGroup - 1) / kLaneGroup;
  return static_cast<int>((num_lanes + groups - 1) / groups);
}

template <typename T, typename Steps>
int launch_lanes_steps(const Plan<T>& plan, const FlatState<T>& s,
                       int64_t lane_stride, const float* params,
                       int64_t num_lanes, T* consensus, int32_t* routes,
                       int route_slots, T now0, Steps steps, int stage_slots,
                       cudaStream_t stream) {
  const int64_t tiles = (plan.num_markets + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(num_lanes));
  settle_cycles_lanes_kernel<T, Steps>
      <<<grid, kThreads, lane_shared_bytes<T>(stage_slots), stream>>>(
          plan, s, lane_stride, params, static_cast<int>(num_lanes),
          group_lanes_for(num_lanes), consensus, routes, route_slots, now0,
          steps, stage_slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Plan<T> plan_of(const void* slot_rows, const void* probs, const void* mask,
                const void* outcome, const void* touched_offsets,
                int64_t num_slots, int64_t num_markets) {
  return Plan<T>{
      static_cast<const int32_t*>(slot_rows), static_cast<const T*>(probs),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(outcome),
      static_cast<const int64_t*>(touched_offsets), num_slots, num_markets};
}

template <typename T>
FlatState<T> state_of(void* rel, void* conf, void* days, void* exists) {
  return FlatState<T>{static_cast<T*>(rel), static_cast<T*>(conf),
                      static_cast<T*>(days), static_cast<uint8_t*>(exists)};
}

template <typename T>
int launch(const void* slot_rows, const void* probs, const void* mask,
           const void* outcome, const void* touched_offsets, void* rel,
           void* conf, void* days, void* exists, void* consensus,
           void* rel_touched, double now0, int64_t num_slots,
           int64_t num_markets, int64_t num_touched, int64_t steps,
           void* routes, void* stream) {
  if (num_markets == 0) return static_cast<int>(cudaGetLastError());
  const int stage_slots = stage_slots_for<T>(num_markets, num_touched);
  const Plan<T> plan = plan_of<T>(slot_rows, probs, mask, outcome,
                                  touched_offsets, num_slots, num_markets);
  const FlatState<T> s = state_of<T>(rel, conf, days, exists);
  const auto cuda_stream = static_cast<cudaStream_t>(stream);
  const auto route_counts = static_cast<int32_t*>(routes);
  if (steps <= INT32_MAX) {
    return launch_steps<T, int32_t>(
        plan, s, static_cast<T*>(consensus), static_cast<T*>(rel_touched),
        route_counts, static_cast<T>(now0), static_cast<int32_t>(steps),
        stage_slots, cuda_stream);
  }
  return launch_steps<T, int64_t>(
      plan, s, static_cast<T*>(consensus), static_cast<T*>(rel_touched),
      route_counts, static_cast<T>(now0), steps, stage_slots, cuda_stream);
}

template <typename T>
int launch_lanes(const void* slot_rows, const void* probs, const void* mask,
                 const void* outcome, const void* touched_offsets, void* rel,
                 void* conf, void* days, void* exists, const void* params,
                 void* consensus, double now0, int64_t num_slots,
                 int64_t num_markets, int64_t num_touched, int64_t num_lanes,
                 int64_t lane_stride, int64_t steps, int64_t route_slots,
                 void* routes, void* stream) {
  if (num_markets == 0 || num_lanes == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (num_lanes > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int stage_slots = lane_stage_slots_for<T>(num_markets, num_touched);
  const Plan<T> plan = plan_of<T>(slot_rows, probs, mask, outcome,
                                  touched_offsets, num_slots, num_markets);
  const FlatState<T> s = state_of<T>(rel, conf, days, exists);
  const auto lane_params = static_cast<const float*>(params);
  const auto cuda_stream = static_cast<cudaStream_t>(stream);
  const auto route_counts = static_cast<int32_t*>(routes);
  if (steps <= INT32_MAX) {
    return launch_lanes_steps<T, int32_t>(
        plan, s, lane_stride, lane_params, num_lanes,
        static_cast<T*>(consensus), route_counts, static_cast<int>(route_slots),
        static_cast<T>(now0), static_cast<int32_t>(steps), stage_slots,
        cuda_stream);
  }
  return launch_lanes_steps<T, int64_t>(
      plan, s, lane_stride, lane_params, num_lanes, static_cast<T*>(consensus),
      route_counts, static_cast<int>(route_slots), static_cast<T>(now0), steps,
      stage_slots, cuda_stream);
}

}  // namespace

extern "C" int settle_cycles_f32(
    const void* slot_rows, const void* probs, const void* mask,
    const void* outcome, const void* touched_offsets, void* rel, void* conf,
    void* days, void* exists, void* consensus, void* rel_touched, double now0,
    int64_t num_slots, int64_t num_markets, int64_t num_touched,
    int64_t steps, void* routes, void* stream) {
  return launch<float>(slot_rows, probs, mask, outcome, touched_offsets, rel,
                       conf, days, exists, consensus, rel_touched, now0,
                       num_slots, num_markets, num_touched, steps, routes,
                       stream);
}

extern "C" int settle_cycles_f64(
    const void* slot_rows, const void* probs, const void* mask,
    const void* outcome, const void* touched_offsets, void* rel, void* conf,
    void* days, void* exists, void* consensus, void* rel_touched, double now0,
    int64_t num_slots, int64_t num_markets, int64_t num_touched,
    int64_t steps, void* routes, void* stream) {
  return launch<double>(slot_rows, probs, mask, outcome, touched_offsets, rel,
                        conf, days, exists, consensus, rel_touched, now0,
                        num_slots, num_markets, num_touched, steps, routes,
                        stream);
}

extern "C" int settle_cycles_lanes_f32(
    const void* slot_rows, const void* probs, const void* mask,
    const void* outcome, const void* touched_offsets, void* rel, void* conf,
    void* days, void* exists, const void* params, void* consensus,
    double now0, int64_t num_slots, int64_t num_markets, int64_t num_touched,
    int64_t num_lanes, int64_t lane_stride, int64_t steps,
    int64_t route_slots, void* routes, void* stream) {
  return launch_lanes<float>(slot_rows, probs, mask, outcome, touched_offsets,
                             rel, conf, days, exists, params, consensus, now0,
                             num_slots, num_markets, num_touched, num_lanes,
                             lane_stride, steps, route_slots, routes, stream);
}

extern "C" int settle_cycles_lanes_f64(
    const void* slot_rows, const void* probs, const void* mask,
    const void* outcome, const void* touched_offsets, void* rel, void* conf,
    void* days, void* exists, const void* params, void* consensus,
    double now0, int64_t num_slots, int64_t num_markets, int64_t num_touched,
    int64_t num_lanes, int64_t lane_stride, int64_t steps,
    int64_t route_slots, void* routes, void* stream) {
  return launch_lanes<double>(slot_rows, probs, mask, outcome,
                              touched_offsets, rel, conf, days, exists,
                              params, consensus, now0, num_slots, num_markets,
                              num_touched, num_lanes, lane_stride, steps,
                              route_slots, routes, stream);
}
