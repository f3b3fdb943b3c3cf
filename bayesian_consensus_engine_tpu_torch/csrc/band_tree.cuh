// band_tree.cuh: the band moments' balanced tree, built one leaf at a time
// by the thread that owns a market (onepass_settle.cu, onepass_partials.cu).
//
// ops/uncertainty.py::band_sums adds the four moments of a market's slots
// by a fixed tree: the leaves padded with +0.0 to pow2_at_least(K), then
// adjacent pairs (leaf 2i with 2i+1) added level by level. A binary-counter
// stack gives the same association one leaf at a time: leaf i is added to
// its left neighbours once per trailing one bit of i, left operand first.
// After the padding leaves, stack[0] holds the root.

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

}  // namespace band_tree
