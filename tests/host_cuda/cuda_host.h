// The CUDA subset of csrc/ec_kernels.cu for a host build
// (tests/test_torch_ec_host.py). A block's threads are fibers on one host
// thread (ucontext), run in turns from one sync point to the next:
// __syncthreads is a sync point, a warp shuffle writes its value, syncs,
// then reads its source lane's (two slot buffers by the sync's parity, as
// a thread is never more than one sync ahead of another). __shared__
// arrays are function statics (one block runs at a time) and emu_launch
// runs a grid's blocks in turn.
#pragma once
#include <ucontext.h>

#include <cstdint>
#include <functional>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline int cudaGetLastError() { return cudaSuccess; }

struct Dim3 {
  unsigned x, y, z;
};
static Dim3 threadIdx, blockIdx, blockDim, gridDim;

struct HostFiber {
  ucontext_t ctx;
  std::vector<char> stack;
  unsigned syncs = 0;
  bool done = false;
};
static ucontext_t g_sched;
static std::vector<HostFiber>* g_fibers;
static const std::function<void()>* g_body;
static std::vector<uint32_t> g_slots[2];  // a shuffle value a thread, by sync parity

static inline void sync_point() {
  HostFiber& f = (*g_fibers)[threadIdx.x];
  ++f.syncs;
  swapcontext(&f.ctx, &g_sched);
}

static inline void __syncthreads() { sync_point(); }

static inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width = 32) {
  const unsigned t = threadIdx.x, parity = (*g_fibers)[t].syncs & 1;
  g_slots[parity][t] = v;
  sync_point();
  const unsigned lane = t % 32;
  return g_slots[parity][t - lane + (lane & ~(width - 1)) + (src & (width - 1))];
}

static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}

static void host_fiber_entry() {
  (*g_body)();
  (*g_fibers)[threadIdx.x].done = true;
}

static void emu_launch(unsigned grid, unsigned threads, const std::function<void()>& body) {
  constexpr size_t kStack = 1 << 18;
  gridDim = {grid, 1, 1};
  blockDim = {threads, 1, 1};
  g_body = &body;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx = {b, 0, 0};
    std::vector<HostFiber> fibers(threads);
    g_fibers = &fibers;
    g_slots[0].assign(threads, 0);
    g_slots[1].assign(threads, 0);
    for (HostFiber& f : fibers) {
      f.stack.resize(kStack);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = &g_sched;
      makecontext(&f.ctx, host_fiber_entry, 0);
    }
    for (bool running = true; running;) {
      running = false;
      for (unsigned t = 0; t < threads; ++t) {
        if (fibers[t].done) continue;
        threadIdx = {t, 0, 0};
        swapcontext(&g_sched, &fibers[t].ctx);
        running = true;
      }
    }
  }
}
