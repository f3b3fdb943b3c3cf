// band_tree.cuh: the band moments' balanced tree, built one leaf at a time
// by the thread that owns a market (onepass_settle.cu, onepass_partials.cu).
//
// ops/uncertainty.py::band_sums adds the four moments of a market's slots
// by a fixed tree: the leaves padded with +0.0 to pow2_at_least(K), then
// adjacent pairs (leaf 2i with 2i+1) added level by level. A binary-counter
// stack gives the same association one leaf at a time: leaf i is added to
// its left neighbours once per trailing one bit of i, left operand first.
// After the padding leaves, stack[0] holds the root.
//
// Two forms of the same tree. BandTree keeps the stack in an array indexed
// at run time, so it lives in local memory (528 bytes a thread); it takes
// any width. RegisterBandTree<kDepth> is the tree of 2^kDepth leaves with
// one partial root per level at a static index, so it stays in registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace band_tree {

// The band tree of 2^31 leaves is 32 levels deep; its stack holds one
// partial root per level plus the incoming leaf.
constexpr int kTreeStack = 33;

struct BandTree {
  float stack[kTreeStack][4];
  int top = 0;
  int64_t leaves = 0;

  __device__ __forceinline__ void push(float w, float wp, float wpp, float ww) {
    float v[4] = {w, wp, wpp, ww};
    for (int64_t i = leaves; i & 1; i >>= 1) {
      --top;
      for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(stack[top][j], v[j]);
    }
    for (int j = 0; j < 4; ++j) stack[top][j] = v[j];
    ++top;
    ++leaves;
  }

  // Pad with zero leaves to the next power of two >= width (min 1) and
  // return the root's four sums through `out` (stride apart).
  __device__ __forceinline__ void finish(int64_t width, float* out,
                                         int64_t stride) {
    int64_t padded = 1;
    while (padded < width) padded *= 2;
    while (leaves < padded) push(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < 4; ++j) out[j * stride] = stack[0][j];
  }
};

// The tree of exactly 2^kDepth leaves. A push adds the leaf to the partial
// roots of the levels below its index's lowest zero bit, left operand
// first, and parks the sum at that level; the last leaf's sum is the root.
// Every level is visited by an unrolled, predicated cascade, so no index
// is computed at run time.
template <int kDepth>
struct RegisterBandTree {
  static_assert(kDepth >= 0 && kDepth < 31, "a tree of at most 2^30 leaves");
  float level[kDepth > 0 ? kDepth : 1][4];
  float root[4];
  int leaves = 0;

  __device__ __forceinline__ void push(float w, float wp, float wpp, float ww) {
    float v[4] = {w, wp, wpp, ww};
    const int carries = __ffs(~leaves) - 1;  // trailing one bits of the index
#pragma unroll
    for (int l = 0; l < kDepth; ++l) {
      if (l < carries) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(level[l][j], v[j]);
      } else if (l == carries) {
#pragma unroll
        for (int j = 0; j < 4; ++j) level[l][j] = v[j];
      }
    }
    if (carries == kDepth) {
#pragma unroll
      for (int j = 0; j < 4; ++j) root[j] = v[j];
    }
    ++leaves;
  }

  // Pad with zero leaves to 2^kDepth, the next power of two >= the
  // block's width, and return the root's four sums through `out` (stride
  // apart).
  __device__ __forceinline__ void finish(int64_t /*width*/, float* out,
                                         int64_t stride) {
    while (leaves < (1 << kDepth)) push(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j * stride] = root[j];
  }
};

}  // namespace band_tree
