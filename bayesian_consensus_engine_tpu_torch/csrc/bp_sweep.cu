// bp_sweep: the damped belief-propagation sweep over a market graph, every
// sweep of a call in one persistent cooperative launch, with the early exit
// decided on the device.
//
// Replaces ops/pallas_bp.py::_bp_kernel of the JAX package (pallas_bp.py:109,
// pallas_call at :283), which computes ops/propagate.py::bp_sweep_math at
// axis_name=None: up to max_steps synchronous sweeps of the
// precision-weighted damped mix over (M, D) neighbour blocks, the residual
// max |dmean| of each sweep, and a stop once it is at or below tol. Its
// plain version, which it is held against bit for bit (mean, variance,
// iters_run, residual), is ops/bp_kernel.py::bp_sweep_reference.
//
// Design. The Pallas kernel runs a sequential (max_steps, tiles) grid with
// the whole moment vectors resident in VMEM; Hopper has neither. Here:
//   * one cooperative launch a call (cudaLaunchCooperativeKernel): as many
//     blocks as the SMs hold at once, never more than the rows need. Each
//     thread walks rows grid-stride and, for each, takes its D neighbours
//     kChunk at a time: the chunk's positions and weights are loaded
//     together, then its gathers of the neighbours' moments from the
//     previous sweep, and only then are they summed, left to right, so a
//     thread has a chunk's loads in flight instead of one.
//     cooperative_groups' grid.sync() between sweeps is the barrier that
//     Jacobi semantics need;
//   * between sweeps the moments live in two ping-pong buffers of the
//     kernel's own layout, (mean, variance) interleaved as a float2 on the
//     moments lane, so a neighbour's gather touches one 32-byte sector, not
//     two. Sweep 0 reads the caller's separate seed arrays; sweep i > 0
//     reads what sweep i - 1 wrote; the sweep at max_steps - 1 writes the
//     caller's separate out_m / out_s directly, every other one a ping-pong
//     buffer;
//   * the neighbour blocks are streamed with the evict-first cache hint
//     (ld.global.cs), so their 8 bytes a lane do not push the moment
//     vectors that the gathers read out of L2;
//   * the residual of sweep i is a max, exactly associative: a warp and
//     block max of the bit patterns of |dmean| (sign cleared, so a NaN
//     orders above +inf as an unsigned integer and is kept, as jnp.max
//     keeps it), then one atomicMax per block into res_bits[i];
//   * the early exit: after the barrier that ends sweep i, every block
//     reads the finished res_bits[i] and stops when it is not above tol (a
//     NaN residual stops, as the reference's while_loop condition does).
//     Every block reads the same word, so all stop at the same sweep;
//   * after the last barrier the same launch writes iters_run and the last
//     sweep's residual and, after an early exit, unpacks the ping-pong
//     buffer that sweep wrote into out_m / out_s.
// Launches per call: 1 (none when max_steps == 0, the identity).
//
// Numerics. The arithmetic is the reference's XLA CPU program's: lanes are
// summed left to right from 0; sum(w * nb) adds rounded products;
// sum((w * w) * nb_var) accumulates with a fused multiply-add; the mean
// blend is fma(lam, q, keep * v) and the variance blend
// fma(lam^2, q_s, keep^2 * s); with keep_fma they are fma(keep, v, lam * q)
// and fma(keep^2, s, lam^2 * q_s), XLA's contraction when a row has one lane
// or nothing reads the residual (the session's point lane). Every operation
// is an explicit _rn intrinsic, so nvcc's default -fmad contracts nothing
// else. Out-of-range neighbour positions clamp into [0, M), as the
// reference's gather does.
//
// Bound. Device-memory bytes: per sweep that runs, the neighbour blocks
// once (M * D * 8 B) and the moment vectors read and written once (M * 16 B
// on the moments lane, M * 8 B on the point lane), which is the traffic the
// reference accepts (pallas_bp.py:25-28); plus the audit pair.
// ops/bp_kernel.py::bound_bytes counts that. The gathers of neighbour
// moments count as cache hits: at 1M markets the interleaved vectors are
// 8 MB, under the 50 MB L2. What holds the kernel back is that gather: each
// neighbour read pulls a 32-byte sector from L2 for 8 useful bytes, and a
// row's gathers wait on its positions. Tried and not kept: staging a
// block's position and weight rows through shared memory with 16-byte
// loads (slower: a block barrier each tile) and 512-thread blocks (no
// change).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // neighbour lanes whose loads are issued together
constexpr float kVarEps = 1e-12f;

struct Blend {
  float lam, keep, lam2, keep2;
};

struct Params {
  const float* seed_m;
  const float* seed_s;
  float* out_m;
  float* out_s;
  float* pingpong;  // two buffers of M cells each; null when max_steps == 1
  const int32_t* idx;
  const float* w;
  unsigned int* res_bits;  // max_steps zeroed words
  int32_t* iters_run;
  float* residual;
  Blend blend;
  float tol;
  int adaptive;
  int keep_fma;
  int64_t max_steps;
  int64_t num_markets;
  int64_t degree;
};

// Exponent not all ones: neither an infinity nor a NaN.
__device__ __forceinline__ bool is_finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

// A market's moments between sweeps: (mean, variance) interleaved on the
// moments lane, the mean alone on the point lane.
template <bool kMoments>
struct Lane {
  using Cell = typename std::conditional<kMoments, float2, float>::type;

  // Plain loads: the buffers are written by other blocks between sweeps,
  // so they must not take the read-only (non-coherent) path.
  static __device__ __forceinline__ float2 get(const Cell* buf, int64_t j) {
    if constexpr (kMoments) {
      return buf[j];
    } else {
      return make_float2(buf[j], 0.0f);
    }
  }

  static __device__ __forceinline__ void put(Cell* buf, int64_t j, float2 v) {
    if constexpr (kMoments) {
      buf[j] = v;
    } else {
      buf[j] = v.x;
    }
  }
};

template <bool kMoments>
__global__ void __launch_bounds__(kThreads) bp_sweep_kernel(Params p) {
  using L = Lane<kMoments>;
  using Cell = typename L::Cell;
  cg::grid_group grid = cg::this_grid();
  const int64_t M = p.num_markets, D = p.degree;
  Cell* const even = reinterpret_cast<Cell*>(p.pingpong);
  Cell* const odd = even + M;
  const int64_t first_row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const Blend b = p.blend;
  __shared__ unsigned int warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int64_t ran = 0;
  while (ran < p.max_steps) {
    const int64_t i = ran;
    const bool seeds = i == 0;
    const bool last = i == p.max_steps - 1;
    const Cell* src = (i & 1) ? even : odd;  // what sweep i - 1 wrote
    Cell* dst = (i & 1) ? odd : even;
    unsigned int delta_bits = 0u;
    for (int64_t r = first_row; r < M; r += stride) {
      const float2 own = seeds
          ? make_float2(p.seed_m[r], kMoments ? p.seed_s[r] : 0.0f)
          : L::get(src, r);
      const float v = own.x, s = own.y;
      float wsum = 0.0f, wval = 0.0f, wvar = 0.0f;
      const int32_t* row_idx = p.idx + r * D;
      const float* row_w = p.w + r * D;
      // kChunk lanes at a time: their positions and weights, then their
      // gathers, are issued together before the sums use them in order.
      for (int64_t d0 = 0; d0 < D; d0 += kChunk) {
        int32_t j[kChunk];
        float wt[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const bool in_row = d0 + u < D;
          j[u] = in_row ? __ldcs(row_idx + d0 + u) : -1;
          wt[u] = in_row ? __ldcs(row_w + d0 + u) : 0.0f;
        }
        float2 nb[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int64_t jj = j[u] < M ? j[u] : M - 1;
          nb[u] = j[u] < 0 ? make_float2(0.0f, 0.0f)
              : seeds ? make_float2(p.seed_m[jj], kMoments ? p.seed_s[jj] : 0.0f)
                      : L::get(src, jj);
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (j[u] < 0) continue;  // padding: the lane adds +0.0 to every sum
          bool ok = is_finite(nb[u].x);
          float wd;
          if constexpr (kMoments) {
            ok = ok && is_finite(nb[u].y);
            const float prec = __frcp_rn(__fadd_rn(nb[u].y, kVarEps));
            wd = ok ? __fmul_rn(wt[u], prec) : 0.0f;
          } else {
            wd = ok ? wt[u] : 0.0f;
          }
          if (!ok) continue;  // w = 0: each sum adds +0.0
          wsum = __fadd_rn(wsum, wd);
          wval = __fadd_rn(wval, __fmul_rn(wd, nb[u].x));
          if constexpr (kMoments) wvar = __fmaf_rn(__fmul_rn(wd, wd), nb[u].y, wvar);
        }
      }
      const bool mixes = wsum > 0.0f && is_finite(v);
      const float denom = wsum > 0.0f ? wsum : 1.0f;
      const float q = __fdiv_rn(wval, denom);
      const float blended = p.keep_fma
          ? __fmaf_rn(b.keep, v, __fmul_rn(b.lam, q))
          : __fmaf_rn(b.lam, q, __fmul_rn(b.keep, v));
      float2 out = make_float2(mixes ? blended : v, 0.0f);
      if constexpr (kMoments) {
        const float q_s = __fdiv_rn(wvar, __fmul_rn(denom, denom));
        const float blended_s = p.keep_fma
            ? __fmaf_rn(b.keep2, s, __fmul_rn(b.lam2, q_s))
            : __fmaf_rn(b.lam2, q_s, __fmul_rn(b.keep2, s));
        out.y = mixes ? blended_s : s;
      }
      if (last) {
        p.out_m[r] = out.x;
        if constexpr (kMoments) p.out_s[r] = out.y;
      } else {
        L::put(dst, r, out);
      }
      if (mixes) {
        delta_bits = max(delta_bits,
                         __float_as_uint(__fsub_rn(out.x, v)) & 0x7fffffffu);
      }
    }
    // Block max of the bit patterns, then one atomic per block.
    for (int offset = 16; offset > 0; offset >>= 1) {
      delta_bits = max(delta_bits, __shfl_xor_sync(0xffffffffu, delta_bits, offset));
    }
    if (lane == 0) warp_max[warp] = delta_bits;
    __syncthreads();
    if (warp == 0) {
      delta_bits = lane < kThreads / 32 ? warp_max[lane] : 0u;
      for (int offset = 16; offset > 0; offset >>= 1) {
        delta_bits = max(delta_bits, __shfl_xor_sync(0xffffffffu, delta_bits, offset));
      }
      if (lane == 0) atomicMax(p.res_bits + i, delta_bits);
    }
    grid.sync();  // sweep i is written everywhere, res_bits[i] is final
    ++ran;
    if (p.adaptive && !(__uint_as_float(__ldcg(p.res_bits + i)) > p.tol)) break;
  }

  // The audit pair, and the result's home after an early exit.
  if (first_row == 0) {
    *p.iters_run = static_cast<int32_t>(ran);
    *p.residual = __uint_as_float(__ldcg(p.res_bits + ran - 1));
  }
  if (ran < p.max_steps) {
    const Cell* home = ((ran - 1) & 1) ? odd : even;
    for (int64_t r = first_row; r < M; r += stride) {
      const float2 cell = L::get(home, r);
      p.out_m[r] = cell.x;
      if constexpr (kMoments) p.out_s[r] = cell.y;
    }
  }
}

template <bool kMoments>
cudaError_t launch(Params params, cudaStream_t stream) {
  auto kernel = bp_sweep_kernel<kMoments>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int64_t cells = params.num_markets > 0 ? params.num_markets : 1;
  const int64_t needed = (cells + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  // A grid that cannot be resident at once is refused by the launch.
  const int64_t blocks = resident > 0 && resident < needed ? resident : needed;
  void* args[] = {&params};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(static_cast<unsigned int>(blocks)), dim3(kThreads), args, 0, stream);
}

}  // namespace

// Enqueues one cooperative launch of up to max_steps sweeps on `stream`;
// returns the launch's error (0 on success), none when max_steps <= 0. The
// seeds are read only; out_* receive the result; pingpong holds two
// buffers of M cells (float2 on the moments lane, float on the point lane)
// and may be null when max_steps == 1; res_bits holds max_steps zeroed
// words.
extern "C" int bp_sweep_f32(
    const void* seed_m, const void* seed_s, void* out_m, void* out_s,
    void* pingpong, const void* idx, const void* w, void* res_bits,
    void* iters_run, void* residual, double lam, double keep, double lam2,
    double keep2, double tol, int adaptive, int64_t max_steps,
    int64_t num_markets, int64_t degree, int moments, int keep_fma,
    void* stream) {
  if (max_steps <= 0) return 0;
  const Params params{
      static_cast<const float*>(seed_m), static_cast<const float*>(seed_s),
      static_cast<float*>(out_m), static_cast<float*>(out_s),
      static_cast<float*>(pingpong), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<unsigned int*>(res_bits),
      static_cast<int32_t*>(iters_run), static_cast<float*>(residual),
      Blend{static_cast<float>(lam), static_cast<float>(keep),
            static_cast<float>(lam2), static_cast<float>(keep2)},
      static_cast<float>(tol), adaptive, keep_fma, max_steps, num_markets,
      degree};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = moments ? launch<true>(params, s) : launch<false>(params, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error for the next call
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
