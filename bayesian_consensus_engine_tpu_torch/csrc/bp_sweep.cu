// bp_sweep: the damped belief-propagation sweep over a market graph, one
// launch per Jacobi sweep, with the early exit decided on the device.
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
//   * one thread per market row loops over its D neighbours left to right,
//     gathering their means (and variances) from the previous sweep;
//   * one launch per sweep: blocks run in no order, so the launch boundary
//     is the grid-wide barrier. Ping-pong buffers give Jacobi semantics:
//     sweep 0 reads the seeds, sweep i > 0 reads what sweep i - 1 wrote,
//     and sweep i writes `out` when (max_steps - 1 - i) is even, else `tmp`,
//     so that the last sweep writes `out`;
//   * the residual of sweep i is a max, exactly associative: a warp and
//     block max of the bit patterns of |dmean| (sign cleared, so a NaN
//     orders above +inf as an unsigned integer and is kept, as jnp.max
//     keeps it), then one atomicMax per block into res_bits[i];
//   * the early exit lives on the device: sweep i runs when i == 0 or
//     res_bits[i - 1] > tol (a NaN residual stops, as the reference's
//     while_loop condition does). A frozen sweep writes nothing, so its
//     residual slot stays +0.0 and, tol being > 0, every later sweep stays
//     frozen. The host enqueues all launches and reads nothing back;
//   * a last launch (bp_finalize) counts the sweeps that ran from the
//     residual slots, writes iters_run and the last run sweep's residual,
//     and, when that sweep wrote `tmp`, copies `tmp` to `out`.
// Launches per call: max_steps + 1 (none when max_steps == 0, the identity).
//
// Numerics. The arithmetic is the reference's XLA CPU program's: lanes are
// summed left to right from 0; sum(w * nb) adds rounded products;
// sum((w * w) * nb_var) accumulates with a fused multiply-add; the mean
// blend is fma(lam, q, keep * v) and the variance blend
// fma(lam^2, q_s, keep^2 * s); with keep_fma they are fma(keep, v, lam * q)
// and fma(keep^2, s, lam^2 * q_s), XLA's contraction when a row has one lane
// or nothing reads the residual (the session's point lane). Every operation
// is an explicit _rn intrinsic, so nvcc's default -fmad contracts nothing
// else. Out-of-range
// neighbour positions clamp into [0, M), as the reference's gather does.
//
// Bound. Device-memory bytes: per sweep that runs, the neighbour blocks
// once (M * D * 8 B) and the moment vectors read and written once (M * 16 B
// on the moments lane, M * 8 B on the point lane), which is the traffic the
// reference accepts (pallas_bp.py:25-28); plus the audit pair.
// ops/bp_kernel.py::bound_bytes counts that. The gathers of neighbour
// moments count as cache hits: at 1M markets the vectors are 8 MB, under
// the 50 MB L2. What holds the kernel back is that gather: each 4-byte
// neighbour read pulls a 32-byte sector from L2, and a thread's D index
// and weight reads are strided by D * 4 bytes across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kVarEps = 1e-12f;

struct Blend {
  float lam, keep, lam2, keep2;
};

// Exponent not all ones: neither an infinity nor a NaN.
__device__ __forceinline__ bool is_finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ bool frozen(const unsigned int* res_bits,
                                       int64_t sweep, int adaptive,
                                       float tol) {
  return adaptive && sweep > 0 && !(__uint_as_float(res_bits[sweep - 1]) > tol);
}

__global__ void __launch_bounds__(kThreads) bp_sweep_kernel(
    const float* __restrict__ src_m, const float* __restrict__ src_s,
    float* __restrict__ dst_m, float* __restrict__ dst_s,
    const int32_t* __restrict__ idx, const float* __restrict__ w,
    unsigned int* __restrict__ res_bits, int64_t sweep, int adaptive,
    float tol, Blend blend, int64_t num_markets, int64_t degree, int moments,
    int keep_fma) {
  if (frozen(res_bits, sweep, adaptive, tol)) return;  // uniform per launch
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned int delta_bits = 0u;
  if (r < num_markets) {
    const float v = src_m[r];
    const float s = moments ? src_s[r] : 0.0f;
    float wsum = 0.0f, wval = 0.0f, wvar = 0.0f;
    const int32_t* row_idx = idx + r * degree;
    const float* row_w = w + r * degree;
    for (int64_t d = 0; d < degree; ++d) {
      const int32_t j = row_idx[d];
      if (j < 0) continue;  // padding: the lane adds +0.0 to every sum
      const int64_t jj = j < num_markets ? j : num_markets - 1;
      const float nb = src_m[jj];
      bool ok = is_finite(nb);
      float nb_var = 0.0f, wd;
      if (moments) {
        nb_var = src_s[jj];
        ok = ok && is_finite(nb_var);
        const float prec = __frcp_rn(__fadd_rn(nb_var, kVarEps));
        wd = ok ? __fmul_rn(row_w[d], prec) : 0.0f;
      } else {
        wd = ok ? row_w[d] : 0.0f;
      }
      if (!ok) continue;  // w = 0: each sum adds +0.0
      wsum = __fadd_rn(wsum, wd);
      wval = __fadd_rn(wval, __fmul_rn(wd, nb));
      if (moments) wvar = __fmaf_rn(__fmul_rn(wd, wd), nb_var, wvar);
    }
    const bool mixes = wsum > 0.0f && is_finite(v);
    const float denom = wsum > 0.0f ? wsum : 1.0f;
    const float q = __fdiv_rn(wval, denom);
    const float blended = keep_fma
        ? __fmaf_rn(blend.keep, v, __fmul_rn(blend.lam, q))
        : __fmaf_rn(blend.lam, q, __fmul_rn(blend.keep, v));
    const float new_v = mixes ? blended : v;
    dst_m[r] = new_v;
    if (moments) {
      const float q_s = __fdiv_rn(wvar, __fmul_rn(denom, denom));
      const float blended_s = keep_fma
          ? __fmaf_rn(blend.keep2, s, __fmul_rn(blend.lam2, q_s))
          : __fmaf_rn(blend.lam2, q_s, __fmul_rn(blend.keep2, s));
      dst_s[r] = mixes ? blended_s : s;
    }
    if (mixes) delta_bits = __float_as_uint(__fsub_rn(new_v, v)) & 0x7fffffffu;
  }
  // Block max of the bit patterns, then one atomic per block.
  for (int offset = 16; offset > 0; offset >>= 1) {
    delta_bits = max(delta_bits, __shfl_xor_sync(0xffffffffu, delta_bits, offset));
  }
  __shared__ unsigned int warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = delta_bits;
  __syncthreads();
  if (warp == 0) {
    delta_bits = lane < kThreads / 32 ? warp_max[lane] : 0u;
    for (int offset = 16; offset > 0; offset >>= 1) {
      delta_bits = max(delta_bits, __shfl_xor_sync(0xffffffffu, delta_bits, offset));
    }
    if (lane == 0) atomicMax(res_bits + sweep, delta_bits);
  }
}

// The audit pair and the result's home: the sweeps that ran are 1 plus the
// count of leading residual slots above tol (all of them at fixed depth).
__global__ void __launch_bounds__(kThreads) bp_finalize_kernel(
    const float* __restrict__ tmp_m, const float* __restrict__ tmp_s,
    float* __restrict__ out_m, float* __restrict__ out_s,
    const unsigned int* __restrict__ res_bits, int32_t* __restrict__ iters_run,
    float* __restrict__ residual, int64_t max_steps, int adaptive, float tol,
    int64_t num_markets, int moments) {
  int64_t ran = max_steps;
  if (adaptive) {
    ran = 1;
    while (ran < max_steps && __uint_as_float(res_bits[ran - 1]) > tol) ++ran;
  }
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r == 0) {
    *iters_run = static_cast<int32_t>(ran);
    *residual = __uint_as_float(res_bits[ran - 1]);
  }
  const bool in_tmp = ((max_steps - ran) & 1) != 0;  // sweep ran-1 wrote tmp
  if (in_tmp && r < num_markets) {
    out_m[r] = tmp_m[r];
    if (moments) out_s[r] = tmp_s[r];
  }
}

}  // namespace

// Enqueues max_steps sweeps and the finalize on `stream`; returns the first
// launch error (cudaGetLastError after each launch), 0 on success. The
// seeds are read only; out_* receive the result, tmp_* are scratch (unused
// when max_steps == 1); res_bits holds max_steps zeroed words.
extern "C" int bp_sweep_f32(
    const void* seed_m, const void* seed_s, void* out_m, void* out_s,
    void* tmp_m, void* tmp_s, const void* idx, const void* w, void* res_bits,
    void* iters_run, void* residual, double lam, double keep, double lam2,
    double keep2, double tol, int adaptive, int64_t max_steps,
    int64_t num_markets, int64_t degree, int moments, int keep_fma,
    void* stream) {
  if (max_steps <= 0) return 0;
  const int64_t cells = num_markets > 0 ? num_markets : 1;
  const unsigned int blocks =
      static_cast<unsigned int>((cells + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Blend blend{static_cast<float>(lam), static_cast<float>(keep),
                    static_cast<float>(lam2), static_cast<float>(keep2)};
  const float tol_f = static_cast<float>(tol);
  float* buffers_m[2] = {static_cast<float*>(out_m), static_cast<float*>(tmp_m)};
  float* buffers_s[2] = {static_cast<float*>(out_s), static_cast<float*>(tmp_s)};
  const float* src_m = static_cast<const float*>(seed_m);
  const float* src_s = static_cast<const float*>(seed_s);
  for (int64_t i = 0; i < max_steps; ++i) {
    const int home = static_cast<int>((max_steps - 1 - i) & 1);  // 0 = out
    bp_sweep_kernel<<<blocks, kThreads, 0, s>>>(
        src_m, src_s, buffers_m[home], buffers_s[home],
        static_cast<const int32_t*>(idx), static_cast<const float*>(w),
        static_cast<unsigned int*>(res_bits), i, adaptive, tol_f, blend,
        num_markets, degree, moments, keep_fma);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_m = buffers_m[home];
    src_s = buffers_s[home];
  }
  bp_finalize_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(tmp_m), static_cast<const float*>(tmp_s),
      static_cast<float*>(out_m), static_cast<float*>(out_s),
      static_cast<const unsigned int*>(res_bits),
      static_cast<int32_t*>(iters_run), static_cast<float*>(residual),
      max_steps, adaptive, tol_f, num_markets, moments);
  return static_cast<int>(cudaGetLastError());
}
