// K5 fsm_sweep, K6 fsm_sync, K7 fsm_emit: Huffman decode of the type
// stream on Hopper (sm_90a).
//
// Replaces sz_tpu/tpu/fsm_kernel.py's three Pallas kernels (kernel A
// _fsm_call, kernel B _fsm_call_b, kernel C _compact_call).  The coded
// stream is cut into chunks of F bits (F = 1024, one 128-byte line, or
// the next multiple of 1024 at or above the longest code D), one thread
// per chunk.  A thread walks the Huffman tree bit by bit through the
// transition table trans[2*s + b] (bit 31 set: a leaf, symbol in the low
// 31 bits, the walk returns to the root; else the child node).  Bits at
// or past total_bits emit nothing.
//
// A walk that starts at a codeword boundary (at the root) ends its chunk
// at the first boundary at or past F; that boundary lies in [F, F + D),
// so the next chunk's true first boundary is one of D offsets.  Hence:
//
//   K5: for each offset j < D, walk from the root at j to the end of the
//       chunk: g[c][j] = the next chunk's first boundary offset, n[c][j]
//       = the symbols emitted.  Walks from different offsets meet at a
//       common boundary and coincide from there (self-synchronization),
//       so a later walk joins an earlier one where they meet (below).
//       A code that never self-synchronizes (a fixed-length code) keeps
//       D distinct walks: D * F steps a chunk, no more.
//   K6: one doubling step of the prefix composition of the chunk maps:
//       g'[c] = g[c] o g[c - step], n'[c] = n[c - step] + n[c] o g[c -
//       step].  ceil(log2 L) launches make g[c][0] the first boundary of
//       chunk c + 1 and n[c][0] the symbols of chunks 0..c, for every
//       stream: no rounds that depend on the data, no host sync between
//       them, no window.
//   K7: walk each chunk from its true first boundary and write each
//       symbol as int32 at the chunk's int64 offset; symbols at or past
//       n_sym (the byte padding's junk) are dropped.
//
// Bound on this card: the latency of the dependent table lookups, one
// per coded bit walked (each step needs the previous step's state), not
// bytes: the stream is read once per pass and the symbols written once.
// The design answers with parallelism: one independent walk per 1024
// bits keeps ~10^5 walks in flight at 512^3, and the table sits in
// dynamic shared memory when its 4 * ntrans bytes fit in 227 KB (else
// it is read through L2 with __ldg; no node cap).  Bit offsets are int64
// (streams pass 2^31 bits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSweepThreads = 256;  // K5: 4 blocks of <= 64 registers an SM
constexpr int kMaxSmem = 232448;
constexpr int kSlots = 8;           // K5: walks a thread advances together

__device__ __forceinline__ uint32_t be_word(const uint32_t* __restrict__ w,
                                            long long i) {
  return __byte_perm(__ldg(w + i), 0, 0x0123);
}

// Loads the table into shared memory (kSmem) and returns the table to
// read.  Every thread of the block calls it before any returns.
template <bool kSmem>
__device__ __forceinline__ const int* table(const int* __restrict__ g,
                                            int ntrans, int* sh) {
  if constexpr (kSmem) {
    for (int i = threadIdx.x; i < ntrans; i += blockDim.x) sh[i] = g[i];
    __syncthreads();
    return sh;
  } else {
    return g;
  }
}

// The bits of one chunk, from its first word w0, read word by word.
struct Bits {
  const uint32_t* __restrict__ words;
  long long w0;
  int wi = -1;
  uint32_t word = 0;
  __device__ __forceinline__ int at(int q) {
    if ((q >> 5) != wi) {
      wi = q >> 5;
      word = be_word(words, w0 + wi);
    }
    return (word >> (31 - (q & 31))) & 1u;
  }
};

template <bool kSmem>
__device__ __forceinline__ int step(const int* t, int s, int bit) {
  return kSmem ? t[2 * s + bit] : __ldg(t + 2 * s + bit);
}

// Where a chunk's walks stop: the stream's end, or F + D (never reached
// by a walk of a tree whose codes are at most D bits).
__device__ __forceinline__ int walk_limit(long long c, int F, int D,
                                          long long total_bits) {
  long long left = total_bits - c * F;
  return left <= 0 ? 0 : (left < F + D ? (int)left : F + D);
}

// K5 advances a chunk's walks together, position by position, in
// kSlots register slots: walk j starts at position j (it joins a walk
// that is at the root there, or takes a free slot), and walks at the
// root at the same position are one walk from there on, so the
// later-started ones join the earliest.  (Walks in one state at one
// position were at the root together where that codeword began, so
// checking the root finds every meeting.)  A joined walk's outputs are
// stored as its target (g = -1 - target) and its count less the
// target's at the join; a last pass in walk order (targets start first)
// resolves them.  Slot 0 holds the pass's first walk, which never joins
// another, so once the others have joined a thread advances slot 0
// alone, and all threads of a warp read the same position: F + D steps
// a chunk plus the joining walks' steps.  A walk that finds every slot
// busy waits for another pass over the chunk (a code with more than
// kSlots phases that never meet, e.g. a fixed-length code of 9 or more
// bits, takes ceil(phases / kSlots) passes).
template <bool kSmem>
__global__ void __launch_bounds__(kSweepThreads, 4)
    fsm_sweep_kernel(const uint32_t* __restrict__ words,
                     const int* __restrict__ trans, int ntrans,
                     long long total_bits, long long nchunks, int F, int D,
                     int* __restrict__ g_out, long long* __restrict__ n_out) {
  extern __shared__ int sh[];
  const int* t = table<kSmem>(trans, ntrans, sh);
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  int lim = walk_limit(c, F, D, total_bits);
  int qend = F < lim ? F : lim;          // no walk ends before this
  Bits in{words, c * (F >> 5)};
  int* go = g_out + c * D;
  long long* no = n_out + c * D;
  for (int base = 0; base < D; base += 64) {
    int nb = D - base < 64 ? D - base : 64;
    uint64_t pending = nb == 64 ? ~0ull : (1ull << nb) - 1;
    for (int j = base; j < base + nb; ++j) {
      if (j >= lim) {                    // starts at the stream's end
        go[j] = 0;
        no[j] = 0;
        pending &= ~(1ull << (j - base));
      }
    }
    while (pending) {
      int gs[kSlots], gid[kSlots], gn[kSlots];
      bool live[kSlots];
#pragma unroll
      for (int m = 0; m < kSlots; ++m) live[m] = false;
      int nlive = 0;
      uint64_t todo = pending;
      int q = base + __ffsll((long long)todo) - 1;
      while (true) {
        int jr = q - base;
        if (jr < 64 && ((todo >> jr) & 1)) {   // walk q starts
          int join = -1, free = -1;
#pragma unroll
          for (int m = kSlots - 1; m >= 0; --m) {
            if (live[m] && gs[m] == 0) join = m;
            if (!live[m]) free = m;
          }
          todo &= ~(1ull << jr);
          if (join >= 0 || free >= 0) pending &= ~(1ull << jr);
#pragma unroll
          for (int m = 0; m < kSlots; ++m) {
            if (m == join) {
              go[q] = -1 - gid[m];
              no[q] = -gn[m];
            } else if (join < 0 && m == free) {
              live[m] = true;
              gs[m] = gn[m] = 0;
              gid[m] = q;
              ++nlive;
            }
          }
        }
        if (q >= qend) {                 // walks that end here
#pragma unroll
          for (int m = 0; m < kSlots; ++m) {
            if (live[m] && ((gs[m] == 0 && q >= F) || q >= lim)) {
              go[gid[m]] = q >= F ? q - F : 0;
              no[gid[m]] = gn[m];
              live[m] = false;
              --nlive;
            }
          }
        }
        if (nlive == 0) {
          if (!todo) break;
          q = base + __ffsll((long long)todo) - 1;
          continue;
        }
        int bit = in.at(q);
        ++q;
        if (nlive == 1 && live[0]) {     // the usual case: slot 0 alone
          int v = step<kSmem>(t, gs[0], bit);
          gn[0] += v < 0;
          gs[0] = v < 0 ? 0 : v;
          continue;
        }
#pragma unroll
        for (int m = 0; m < kSlots; ++m) {
          if (live[m]) {
            int v = step<kSmem>(t, gs[m], bit);
            gn[m] += v < 0;
            gs[m] = v < 0 ? 0 : v;
          }
        }
        // walks at the root together: the later-started join the earliest
        int r = -1, rgid = 0, rgn = 0;
#pragma unroll
        for (int m = 0; m < kSlots; ++m) {
          if (live[m] && gs[m] == 0) {
            if (r < 0) {
              r = m;
              rgid = gid[m];
              rgn = gn[m];
            } else {
              if (gid[m] < rgid) {
                go[rgid] = -1 - gid[m];
                no[rgid] = (long long)rgn - gn[m];
                rgid = gid[m];
                rgn = gn[m];
              } else {
                go[gid[m]] = -1 - rgid;
                no[gid[m]] = (long long)gn[m] - rgn;
              }
              live[m] = false;
              --nlive;
            }
          }
        }
#pragma unroll
        for (int m = 0; m < kSlots; ++m) {
          if (m == r) {
            gid[m] = rgid;
            gn[m] = rgn;
          }
        }
      }
    }
  }
  for (int j = 0; j < D; ++j) {          // targets start before joiners
    int gj = go[j];
    if (gj < 0) {
      go[j] = go[-1 - gj];
      no[j] += no[-1 - gj];
    }
  }
}

__global__ void fsm_sync_kernel(const int* __restrict__ g,
                                const long long* __restrict__ n,
                                long long nchunks, int D, long long stride,
                                int* __restrict__ g_out,
                                long long* __restrict__ n_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nchunks * D) return;
  if (i < stride * D) {
    g_out[i] = g[i];
    n_out[i] = n[i];
    return;
  }
  long long prev = i - stride * D;
  long long k = (i / D) * D + g[prev];
  g_out[i] = g[k];
  n_out[i] = n[prev] + n[k];
}

template <bool kSmem>
__global__ void fsm_emit_kernel(const uint32_t* __restrict__ words,
                                const int* __restrict__ trans, int ntrans,
                                long long total_bits, long long nchunks,
                                int F, int D, const int* __restrict__ entry,
                                const long long* __restrict__ offsets,
                                long long n_sym, int* __restrict__ out) {
  extern __shared__ int sh[];
  const int* t = table<kSmem>(trans, ntrans, sh);
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  int lim = walk_limit(c, F, D, total_bits);
  Bits in{words, c * (F >> 5)};
  long long o = offsets[c];
  int s = 0;
  for (int q = entry[c]; q < lim && (s != 0 || q < F); ++q) {
    int v = step<kSmem>(t, s, in.at(q));
    if (v < 0) {
      if (o < n_sym) out[o] = v & 0x7fffffff;
      ++o;
      s = 0;
    } else {
      s = v;
    }
  }
}

// Launches kernel<true> with the table in shared memory when it fits,
// else kernel<false>, one thread a chunk.
template <class K, class... Args>
int launch(K smem_kernel, K global_kernel, int ntrans, int threads,
           long long nchunks, void* stream, Args... args) {
  cudaStream_t st = (cudaStream_t)stream;
  size_t bytes = (size_t)ntrans * sizeof(int);
  unsigned blocks = (unsigned)((nchunks + threads - 1) / threads);
  if (bytes <= (size_t)kMaxSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    smem_kernel<<<blocks, threads, bytes, st>>>(args...);
  } else {
    global_kernel<<<blocks, threads, 0, st>>>(args...);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sz_fsm_sweep(const void* bits, const int* trans, int ntrans,
                            long long total_bits, long long nchunks, int F,
                            int D, int* g, long long* n, void* stream) {
  return launch(fsm_sweep_kernel<true>, fsm_sweep_kernel<false>, ntrans,
                kSweepThreads, nchunks, stream, (const uint32_t*)bits, trans,
                ntrans, total_bits, nchunks, F, D, g, n);
}

extern "C" int sz_fsm_sync(const int* g, const long long* n,
                           long long nchunks, int D, long long stride,
                           int* g_out, long long* n_out, void* stream) {
  long long total = nchunks * D;
  unsigned blocks = (unsigned)((total + 255) / 256);
  fsm_sync_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      g, n, nchunks, D, stride, g_out, n_out);
  return (int)cudaGetLastError();
}

extern "C" int sz_fsm_emit(const void* bits, const int* trans, int ntrans,
                           long long total_bits, long long nchunks, int F,
                           int D, const int* entry, const long long* offsets,
                           long long n_sym, int* out, void* stream) {
  return launch(fsm_emit_kernel<true>, fsm_emit_kernel<false>, ntrans,
                kThreads, nchunks, stream, (const uint32_t*)bits, trans,
                ntrans, total_bits, nchunks, F, D, entry, offsets, n_sym,
                out);
}
