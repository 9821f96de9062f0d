// What csrc/cios_kernels.cu needs beyond cuda_host.h, for a host build
// (tests/test_torch_cios_host.py): the warp's other shuffles (up, down,
// xor, and 64-bit values as two 32-bit ones), __ballot_sync and
// __syncwarp as sync points of the block's fibers, dynamic shared memory
// as a function static (one block runs at a time), and the attributes and
// calls the launches use. The comb kernels' cp.async copies have no host
// form; the test strips them and runs only the kernels that use none.
#pragma once
#include "cuda_host.h"

#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))

typedef int cudaError_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
static inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }

struct uint4 {
  unsigned x, y, z, w;
};

static inline void __syncwarp(unsigned = 0xFFFFFFFFu) { sync_point(); }

// every thread's value through the slots, then the value of lane `src(lane)`
// of the thread's own warp (its own value where src returns -1)
template <class Src>
static inline uint32_t shuffle32(uint32_t v, Src src) {
  const unsigned t = threadIdx.x, parity = (*g_fibers)[t].syncs & 1;
  g_slots[parity][t] = v;
  sync_point();
  const int from = src((int)(t % 32));
  return from < 0 ? v : g_slots[parity][t - t % 32 + from];
}

static inline uint32_t __shfl_up_sync(unsigned, uint32_t v, unsigned d, int width = 32) {
  return shuffle32(v, [&](int l) { return l % width >= (int)d ? l - (int)d : -1; });
}
static inline uint32_t __shfl_down_sync(unsigned, uint32_t v, unsigned d, int width = 32) {
  return shuffle32(v, [&](int l) { return l % width + (int)d < width ? l + (int)d : -1; });
}
static inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int m, int width = 32) {
  return shuffle32(v, [&](int l) { return (l ^ m) / width == l / width ? l ^ m : -1; });
}

#define FSDKR_HOST_SHFL64(NAME, ARG)                                          \
  static inline uint64_t NAME(unsigned mask, uint64_t v, ARG a, int w = 32) { \
    const uint32_t lo = NAME(mask, (uint32_t)v, a, w);                        \
    const uint32_t hi = NAME(mask, (uint32_t)(v >> 32), a, w);                \
    return ((uint64_t)hi << 32) | lo;                                         \
  }
FSDKR_HOST_SHFL64(__shfl_sync, int)
FSDKR_HOST_SHFL64(__shfl_up_sync, unsigned)
FSDKR_HOST_SHFL64(__shfl_down_sync, unsigned)
FSDKR_HOST_SHFL64(__shfl_xor_sync, int)
#undef FSDKR_HOST_SHFL64

static inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned t = threadIdx.x, parity = (*g_fibers)[t].syncs & 1;
  g_slots[parity][t] = pred ? 1u : 0u;
  sync_point();
  unsigned out = 0;
  for (unsigned l = 0; l < 32; ++l) out |= g_slots[parity][t - t % 32 + l] << l;
  return out;
}

static inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
static inline int __ffs(int v) { return __builtin_ffs(v); }
static inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
