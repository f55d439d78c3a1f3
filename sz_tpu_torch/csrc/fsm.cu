// K5 fsm_sweep, K6 fsm_sync, K7 fsm_emit: Huffman decode of the type
// stream on Hopper (sm_90a).
//
// Replaces sz_tpu/tpu/fsm_kernel.py's three Pallas kernels (kernel A
// _fsm_call, :137; kernel B _fsm_call_b, :172; kernel C _compact_call,
// :298).  The coded stream is cut into chunks of F bits (F = 1024, one
// 128-byte line, or the next multiple of 1024 at or above the longest
// code D), one thread per chunk.  Bits at or past total_bits emit
// nothing.
//
// Walks step a codeword at a time (codeword() below): the next k bits
// from the root index the codeword table lut (fsm_kernel.build_lut; k =
// min(12, D), in shared memory): bit 31 set, a code of len = bits 26..30
// and its symbol in bits 0..25; else the internal node (bits 0..25) reached after
// len bits, from which the walk goes on bit by bit through the transition
// table trans[2*s + b] (bit 31 set: a leaf, symbol in the low 31 bits;
// else the child node), read through L1/L2 with __ldg, so that shared
// memory, and with it occupancy, does not follow the tree's size.  Bits
// come from a 64-bit window of two big-endian words, cut with a funnel
// shift.
//
// A walk that starts at a codeword boundary (at the root) ends its chunk
// at the first boundary at or past F; that boundary lies in [F, F + D),
// so the next chunk's true first boundary is one of D offsets.  Hence:
//
//   K5: for each offset j < D, walk from the root at j to the end of the
//       chunk: g[c][j] = the next chunk's first boundary offset, n[c][j]
//       = the symbols emitted.  Walks from different offsets meet at a
//       common boundary and coincide from there (self-synchronization):
//       each distinct boundary of the chunk is decoded once (below).
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
// Bound on this card: the latency of the dependent chain of a walk (a
// table lookup in shared memory a codeword, the window's word loads, and
// for codes past k bits one load of trans a bit through L1/L2) and the
// instructions a step, not bytes: the stream is read about once and the
// maps and symbols written once.  The design answers with fewer links
// (a codeword a lookup, not a bit; K5 decodes each distinct boundary of
// a chunk once, however many walks reach it), loads issued a word ahead,
// and parallelism (one chunk a thread, ~10^6 at 512^3, the block size
// chosen for the most threads an SM).  K5 stages its maps and K7 its
// symbols in shared memory and stores them in whole lines.  Bit offsets
// are int64 (streams pass 2^31 bits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWideThreads = 256;   // K5 for D > 63
constexpr int kEmitThreads = 256;
constexpr int kWindowDepth = 63;  // K5's windowed sweep: D <= 63
constexpr int kStage = 32;        // K7: symbols a lane stages a round
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory
constexpr int kSmemPerSm = 233472;
constexpr int kPayload = (1 << 26) - 1;

// The bits of one chunk from its first word: at(q) is the 32 bits from
// chunk bit q on, the first in bit 31.  Words at or past the stream's
// padded end read as 0.  Three words are kept: the two the cut reads and
// the next, loaded when the walk enters a word and first read when it
// leaves it, so that a walk moving forward waits on no load after its
// first.
struct Window {
  const uint32_t* __restrict__ words;
  long long left;  // words from the chunk's first to the stream's end
  int wi = -2;
  uint32_t a = 0, b = 0, n = 0;  // words wi, wi + 1, wi + 2
  __device__ __forceinline__ uint32_t word(int i) const {
    return i < left ? __byte_perm(__ldg(words + i), 0, 0x0123) : 0u;
  }
  __device__ __forceinline__ uint32_t at(int q) {
    int i = q >> 5;
    if (i != wi) {
      if (i == wi + 1) {
        a = b;
        b = n;
      } else {
        a = word(i);
        b = word(i + 1);
      }
      n = word(i + 2);
      wi = i;
    }
    return __funnelshift_l(b, a, q & 31);
  }
};

// One codeword from the root at chunk bit q < lim: the bit after it, or
// -1 when it does not end at or before lim (the walk stops at lim);
// *sym = its symbol.
__device__ __forceinline__ int codeword(Window& in, const int* lut, int k,
                                        const int* __restrict__ trans,
                                        int q, int lim, int* sym) {
  int e = lut[in.at(q) >> (32 - k)];
  int len = (e >> 26) & 31;
  if (e < 0) {
    *sym = e & kPayload;
    return q + len <= lim ? q + len : -1;
  }
  int s = e & kPayload;
  for (q += len; q < lim; ) {
    int v = __ldg(trans + 2 * s + (in.at(q) >> 31));
    ++q;
    if (v < 0) {
      *sym = v & 0x7fffffff;
      return q;
    }
    s = v;
  }
  return -1;
}

// Where a chunk's walks stop: the stream's end, or F + D (never reached
// by a walk of a tree whose codes are at most D bits).
__device__ __forceinline__ int walk_limit(long long c, int F, int D,
                                          long long total_bits) {
  long long left = total_bits - c * F;
  return left <= 0 ? 0 : (left < F + D ? (int)left : F + D);
}

// Copies the codeword table into shared memory; every thread of the
// block calls it before any leaves.
__device__ __forceinline__ void load_lut(const int* __restrict__ lut, int k,
                                         int* sh) {
  for (int i = threadIdx.x; i < 1 << k; i += blockDim.x) sh[i] = __ldg(lut + i);
  __syncthreads();
}

// K5's ring of kW slots: a slot holds id | count << kId, and a mask bit
// a position; for D < 32 (F = 1024) 16 bits and 32 bits hold them.
template <int kW> struct Ring {
  using Slot = int;
  using Mask = uint64_t;
  static constexpr int kId = 6;
};
template <> struct Ring<32> {
  using Slot = uint16_t;
  using Mask = uint32_t;
  static constexpr int kId = 5;
};
__device__ __forceinline__ int lowest(uint32_t m) { return __ffs((int)m) - 1; }
__device__ __forceinline__ int lowest(uint64_t m) {
  return __ffsll((long long)m) - 1;
}

// K5, D <= 63 (every tree of the main path).  A chunk's walks advance in
// bit order: the walk at the lowest position steps one codeword, and a
// walk that lands where another one stands merges with it, the later
// started into the earlier.  Each distinct boundary reachable from the D
// offsets is thus decoded once.  The walks stand within D + 1 bits of
// the lowest (the one that stepped was lowest and a codeword is at most
// D bits), so a mask `live` of kW bits holds their positions relative
// to `cur`, and a ring of kW slots in shared memory, indexed by
// position, holds each one's first offset (its id) and count (Ring).
// The offsets j < D start as walks at position j.  A merged walk's
// result is kept as (the walk it joined, its count less that walk's
// there); a last pass in offset order (targets start first) resolves
// them.  Results (n << 7 | g, or rel << 7 | 64 | target while
// unresolved) sit in shared memory, [j][thread], and the block stores
// its maps as whole lines.  The block size is the one of 128, 256 and
// 512 threads that keeps the most threads on an SM within its shared
// memory.  A code that never self-synchronizes keeps its D phases apart:
// D full walks, no more.
template <int kW>
__global__ void __launch_bounds__(512)
    fsm_sweep_kernel(const uint32_t* __restrict__ words, long long nwords,
                     const int* __restrict__ trans,
                     const int* __restrict__ lut_g, int k,
                     long long total_bits, long long nchunks, int F, int D,
                     int* __restrict__ g_out, long long* __restrict__ n_out) {
  using Slot = typename Ring<kW>::Slot;
  using Mask = typename Ring<kW>::Mask;
  constexpr int kId = Ring<kW>::kId;
  constexpr Mask kOne = 1;
  extern __shared__ int sh[];
  load_lut(lut_g, k, sh);
  const int T = blockDim.x, t = threadIdx.x;
  Slot* slots = (Slot*)(sh + (1 << k));
  int* rs = (int*)(slots + kW * T);   // rs[j * T + thread]
  Slot* slot = slots + t;
  int* res = rs + t;
  long long c0 = (long long)blockIdx.x * T;
  long long c = c0 + t;
  if (c < nchunks) {
    int lim = walk_limit(c, F, D, total_bits);
    int qend = F < lim ? F : lim;  // no walk ends before this
    Window in{words + c * (F >> 5), nwords - c * (F >> 5)};
    Mask live = 0;
    for (int j = 0; j < D; ++j) {
      if (j < lim) {
        slot[j * T] = (Slot)j;
        live |= kOne << j;
      } else {
        res[j * T] = 0;              // starts at the stream's end
      }
    }
    int cur = 0, sym;
    while (live && cur < qend) {     // bit 0 of live: the walk at cur
      int sv = slot[(cur & (kW - 1)) * T];
      int id = sv & (kW - 1), cnt = sv >> kId;
      int q = codeword(in, sh, k, trans, cur, lim, &sym);
      live &= ~kOne;
      if (q < 0) {                   // its code passes the stream's end
        res[id * T] = (lim > F ? lim - F : 0) | cnt << 7;
      } else {
        ++cnt;
        int d = q - cur;
        Slot* qs = slot + (q & (kW - 1)) * T;
        if ((live >> d) & 1) {       // a walk stands there: merge
          int ov = *qs, oid = ov & (kW - 1), ocnt = ov >> kId;
          if (oid < id) {
            res[id * T] = (int)((unsigned)(cnt - ocnt) << 7) | 64 | oid;
          } else {
            res[oid * T] = (int)((unsigned)(ocnt - cnt) << 7) | 64 | id;
            *qs = (Slot)(id | cnt << kId);
          }
        } else {
          live |= kOne << d;
          *qs = (Slot)(id | cnt << kId);
        }
      }
      if (live) {
        int s = lowest(live);
        live >>= s;
        cur += s;
      }
    }
    for (; live; live &= live - 1) {   // walks that end where they stand
      int p = cur + lowest(live);
      int sv = slot[(p & (kW - 1)) * T];
      res[(sv & (kW - 1)) * T] = (p > F ? p - F : 0) | (sv >> kId) << 7;
    }
    for (int j = 0; j < D; ++j) {      // targets start before joiners
      int r = res[j * T];
      if (r & 64) {
        int rt = res[(r & 63) * T];
        res[j * T] = (int)((unsigned)((r >> 7) + (rt >> 7)) << 7) | (rt & 63);
      }
    }
  }
  __syncthreads();
  // the block's rows [c0, c0 + T) are contiguous in both maps
  long long rows = nchunks - c0 < T ? nchunks - c0 : T;
  for (int i = t; i < rows * D; i += T) {
    int cc = i / D, j = i - cc * D;
    int r = rs[j * T + cc];
    g_out[c0 * D + i] = r & 63;
    n_out[c0 * D + i] = r >> 7;
  }
}

// K5, D > 63 (deep trees only).  Walk W0 from offset 0 marks its
// boundaries in a bitmap (bit p: W0 at the root at p) with prefix counts
// by word, in global scratch (2 * nw words a chunk).  Each later offset
// walks until it reaches one of W0's boundaries and takes W0's end and
// the rest of W0's count from there (a rank in the bitmap); a code that
// never self-synchronizes walks D full times, no more.
__global__ void __launch_bounds__(kWideThreads, 4)
    fsm_sweep_wide_kernel(const uint32_t* __restrict__ words,
                          long long nwords, const int* __restrict__ trans,
                          const int* __restrict__ lut_g, int k,
                          long long total_bits, long long nchunks, int F,
                          int D, int* __restrict__ g_out,
                          long long* __restrict__ n_out,
                          uint32_t* __restrict__ scratch) {
  extern __shared__ int sh[];
  load_lut(lut_g, k, sh);
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  int lim = walk_limit(c, F, D, total_bits);
  int qend = F < lim ? F : lim;
  int nw = (F + D) / 32 + 1;
  uint32_t* bm = scratch + c * 2 * nw;
  uint32_t* pre = bm + nw;
  int* go = g_out + c * D;
  long long* no = n_out + c * D;
  Window in{words + c * (F >> 5), nwords - c * (F >> 5)};
  int p = 0, n0 = 0, sym;
  bool cut = false;                    // W0's last code passes lim
  for (int w = 0; w < nw; ++w) bm[w] = 0;
  while (p < qend) {
    int q = codeword(in, sh, k, trans, p, lim, &sym);
    if (q < 0) {
      cut = true;
      break;
    }
    ++n0;
    p = q;
    bm[p >> 5] |= 1u << (p & 31);
  }
  int g0 = cut ? (lim > F ? lim - F : 0) : (p > F ? p - F : 0);
  uint32_t run = 0;
  for (int w = 0; w < nw; ++w) {
    pre[w] = run;
    run += __popc(bm[w]);
  }
  for (int j = 0; j < D; ++j) {
    if (j >= lim) {
      go[j] = 0;
      no[j] = 0;
      continue;
    }
    int own = 0;
    p = j;
    while (true) {
      uint32_t wd = bm[p >> 5];
      if ((wd >> (p & 31)) & 1 || p == 0) {   // on W0's chain
        int rank = p == 0 ? 0
                          : (int)pre[p >> 5] +
                                __popc(wd & (0xffffffffu >> (31 - (p & 31))));
        go[j] = g0;
        no[j] = own + n0 - rank;
        break;
      }
      if (p >= qend) {
        go[j] = p > F ? p - F : 0;
        no[j] = own;
        break;
      }
      int q = codeword(in, sh, k, trans, p, lim, &sym);
      if (q < 0) {
        go[j] = lim > F ? lim - F : 0;
        no[j] = own;
        break;
      }
      ++own;
      p = q;
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

// K7.  Each lane walks its chunk from its true first boundary, a
// codeword a step, and stages up to kStage symbols a round in its row of
// the warp's buffer ([lane][kStage + 1]: lanes at one slot hit distinct
// banks); then the warp stores each lane's row in turn, 32 lanes on
// consecutive int32s, so a store touches one or two 128-byte lines
// rather than 32.
__global__ void __launch_bounds__(kEmitThreads)
    fsm_emit_kernel(const uint32_t* __restrict__ words, long long nwords,
                    const int* __restrict__ trans,
                    const int* __restrict__ lut_g, int k,
                    long long total_bits, long long nchunks, int F, int D,
                    const int* __restrict__ entry,
                    const long long* __restrict__ offsets, long long n_sym,
                    int* __restrict__ out) {
  extern __shared__ int sh[];
  load_lut(lut_g, k, sh);
  const int lane = threadIdx.x & 31;
  int* buf = sh + (1 << k) + (threadIdx.x >> 5) * 32 * (kStage + 1);
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int q = 0, qend = 0, lim = 0;
  long long o = 0;
  if (c < nchunks) {
    lim = walk_limit(c, F, D, total_bits);
    qend = F < lim ? F : lim;
    q = entry[c];
    o = offsets[c];
  }
  Window in{words + (c < nchunks ? c : 0) * (F >> 5),
            nwords - (c < nchunks ? c : 0) * (F >> 5)};
  while (__any_sync(0xffffffffu, q < qend)) {
    int m = 0, sym;
    while (m < kStage && q < qend) {
      int q2 = codeword(in, sh, k, trans, q, lim, &sym);
      if (q2 < 0) {                  // passes the stream's end: no symbol
        q = qend;
        break;
      }
      buf[lane * (kStage + 1) + m++] = sym;
      q = q2;
    }
    __syncwarp();
    for (unsigned has = __ballot_sync(0xffffffffu, m > 0); has;
         has &= has - 1) {
      int l = __ffs(has) - 1;
      int ml = __shfl_sync(0xffffffffu, m, l);
      long long ol = __shfl_sync(0xffffffffu, o, l) + lane;
      if (lane < ml && ol < n_sym) out[ol] = buf[l * (kStage + 1) + lane];
    }
    o += m;
    __syncwarp();
  }
}

// Launches a kernel with `smem` bytes of dynamic shared memory, one
// thread a chunk.
template <class K, class... Args>
int launch(K kernel, size_t smem, int threads, long long nchunks,
           void* stream, Args... args) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  unsigned blocks = (unsigned)((nchunks + threads - 1) / threads);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sz_fsm_sweep(const void* bits, const int* trans,
                            const int* lut, int k, long long total_bits,
                            long long nchunks, int F, int D, int* g,
                            long long* n, void* scratch, void* stream) {
  const uint32_t* w = (const uint32_t*)bits;
  long long nwords = nchunks * (F >> 5);
  size_t lut_bytes = sizeof(int) << k;
  if (D > kWindowDepth) {
    return launch(fsm_sweep_wide_kernel, lut_bytes, kWideThreads, nchunks,
                  stream, w, nwords, trans, lut, k, total_bits, nchunks, F,
                  D, g, n, (uint32_t*)scratch);
  }
  size_t per_thread = D < 32 ? 2 * 32 + 4 * D : 4 * (64 + D);
  int threads = 0;
  long long resident = 0;
  for (int T = 128; T <= 512; T *= 2) {   // most threads an SM
    size_t smem = lut_bytes + per_thread * T;
    long long blocks = (long long)(kSmemPerSm / (smem + 1024));
    if (2048 / T < blocks) blocks = 2048 / T;
    if (smem <= (size_t)kMaxSmem && blocks * T > resident) {
      resident = blocks * T;
      threads = T;
    }
  }
  if (!threads) return (int)cudaErrorInvalidValue;
  size_t smem = lut_bytes + per_thread * threads;
  if (D < 32) {
    return launch(fsm_sweep_kernel<32>, smem, threads, nchunks, stream, w,
                  nwords, trans, lut, k, total_bits, nchunks, F, D, g, n);
  }
  return launch(fsm_sweep_kernel<64>, smem, threads, nchunks, stream, w,
                nwords, trans, lut, k, total_bits, nchunks, F, D, g, n);
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

extern "C" int sz_fsm_emit(const void* bits, const int* trans,
                           const int* lut, int k, long long total_bits,
                           long long nchunks, int F, int D, const int* entry,
                           const long long* offsets, long long n_sym,
                           int* out, void* stream) {
  size_t smem = (sizeof(int) << k) +
                sizeof(int) * 32 * (kStage + 1) * (kEmitThreads / 32);
  return launch(fsm_emit_kernel, smem, kEmitThreads, nchunks, stream,
                (const uint32_t*)bits, nchunks * (F >> 5), trans, lut, k,
                total_bits, nchunks, F, D, entry, offsets, n_sym, out);
}
