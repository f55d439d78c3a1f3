// The pieces of a single-pass scan with decoupled look-back that K4
// (pack.cu) and K6 (fsm.cu) share: a tile's 16-byte descriptor and the
// named barriers of a block whose look-back runs in a warp of its own.
#pragma once

#include <cuda_runtime.h>

namespace lookback {

// a tile's published state, in the high 32 bits of the descriptor's y
constexpr int kNone = 0, kAggregate = 1, kInclusive = 2;

// A tile's descriptor is one 16-byte word, stored and loaded whole (one
// v2.s64 access): a reader sees a state together with its payload, so
// neither side needs a fence for what the descriptor itself holds.  The
// accesses are volatile: they go to L2, so the spinning loads leave the
// SM's L1 alone, and the compiler may not hoist a load out of a spin
// loop (a look-back spinning on hoisted __ldcg loads hangs).
__device__ __forceinline__ longlong2 load_desc(const longlong2* p) {
  longlong2 v;
  asm volatile("ld.volatile.global.v2.s64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_desc(longlong2* p, long long x,
                                           long long y) {
  asm volatile("st.volatile.global.v2.s64 [%0], {%1, %2};" ::"l"(p),
               "l"(x), "l"(y)
               : "memory");
}

__device__ __forceinline__ int state_of(longlong2 d) {
  return (int)(d.y >> 32);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// One window of the warp's look-back: lane l waits for the descriptor
// of tile j - l (a tile before 0 reads as inclusive) until every tile
// from j back to the nearest inclusive one has published.  Returns the
// lane's descriptor; *incl = the lanes that hold an inclusive prefix.
__device__ __forceinline__ longlong2 window(long long j,
                                            const longlong2* desc,
                                            unsigned* incl) {
  const long long idx = j - (threadIdx.x & 31);
  for (;;) {
    const longlong2 d = idx >= 0
                            ? load_desc(desc + idx)
                            : make_longlong2(0, (long long)kInclusive << 32);
    const int f = state_of(d);
    *incl = __ballot_sync(0xffffffffu, f == kInclusive);
    // lanes up to the nearest inclusive prefix must have published
    const unsigned need = *incl ? *incl ^ (*incl - 1) : 0xffffffffu;
    if (!(__ballot_sync(0xffffffffu, f == kNone) & need)) return d;
  }
}

}  // namespace lookback
