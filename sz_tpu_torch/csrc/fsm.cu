// K5 fsm_sweep, K6 fsm_scan, K7 fsm_emit: Huffman decode of the type
// stream on Hopper (sm_90a).
//
// Replaces sz_tpu/tpu/fsm_kernel.py's three Pallas kernels (kernel A
// _fsm_call, :137; kernel B _fsm_call_b, :172, the chunk entry-state
// sync; kernel C _compact_call, :298).  The coded stream is cut into
// chunks of F bits (F = 1024, one 128-byte line, or the next multiple of
// 1024 at or above the longest code D), one thread per chunk.  Bits at
// or past total_bits emit nothing.
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
//   K6: one scan of the maps from chunk 0, entered at 0: entry[c + 1] =
//       g[c][entry[c]], offsets[c + 1] = offsets[c] + n[c][entry[c]], and
//       the stream's symbol count, in one launch (a single-pass scan
//       with decoupled look-back over tiles of chunks, below).  It relies
//       on no self-synchronization: a stream whose walks never meet
//       decodes in the same one launch.
//   K7: walk each chunk from its true first boundary and write each
//       symbol as int32 at the chunk's int64 offset; symbols at or past
//       n_sym (the byte padding's junk) are dropped.
//
// Bound on this card, K5 and K7: the latency of the dependent chain of a
// walk (a table lookup in shared memory a codeword, the window's word
// loads, and for codes past k bits one load of trans a bit through
// L1/L2) and the instructions a step, not bytes: the stream is read
// about once and the maps and symbols written once.  The design answers
// with fewer links (a codeword a lookup, not a bit; K5 decodes each
// distinct boundary of a chunk once, however many walks reach it), loads
// issued a word ahead, and parallelism (one chunk a thread, ~10^6 at
// 512^3, the block size chosen for the most threads an SM).  K5 stages
// its maps and K7 its symbols in shared memory and stores them in whole
// lines.  Bit offsets are int64 (streams pass 2^31 bits).
//
// Bound on this card, K6: bytes, one read of the maps (12 B an entry,
// 298 MB at 512^3) and one write of entry and offsets.  The composition
// of two chunks' maps is associative, so a tile's D-wide aggregate can
// be built before anything is known about its entry; the scan's carry,
// once chunk 0's entry is fixed, is a scalar pair (entry, count).  The
// design stages each tile's rows once (16-byte cp.async) and composes
// them in shared memory.  What stands in its way is the look-back: its
// folds are D-wide and each window of it costs two round trips to L2,
// and the tiles that stage together all look back past one another.  So
// it runs in a warp of its own from the moment the tile is claimed,
// beside the staging, and tiles are as large as two blocks an SM allow
// (fsm_kernel.scan_tile): the fewer tiles for the same bytes, the fewer
// aggregates each look-back folds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "lookback.cuh"

namespace {

using lookback::bar_arrive;
using lookback::bar_sync;
using lookback::kAggregate;
using lookback::kInclusive;

constexpr int kWideThreads = 256;   // K5 for D > 63
constexpr int kEmitThreads = 256;
constexpr int kWindowDepth = 63;  // K5's windowed sweep: D <= 63
constexpr int kStage = 32;        // K7: symbols a lane stages a round
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory
constexpr int kSmemPerSm = 233472;
constexpr int kPayload = (1 << 26) - 1;
constexpr int kScanWarps = 8;     // K6: warps that compose a tile
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kScanBlock = kScanThreads + 32;  // and one that looks back
constexpr int kWindow = 32;       // K6: predecessors a look-back step reads
// K6's named barriers: the composing warps alone, and their hand-over of
// the runs' composites to the look-back warp
constexpr int kComposers = 1, kComposed = 2;

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

// K6: a tile's entries.  A g value outside [0, D) (no map K5 writes)
// reads as D - 1, so every gather stays inside its row.
__device__ __forceinline__ int entry_in(int x, int D) {
  return (int)min((unsigned)x, (unsigned)(D - 1));
}

// Copies `bytes` (a multiple of 4) from device memory into shared memory
// with `threads` threads (this one is `tid`): 16-byte cp.async where
// the source is 16-byte aligned, word loads for the tail (and for a
// source that is not).  Both read L2 (.cg), never a line that L1 may
// hold from before a look-back's flag.  The caller waits (cp_async_wait)
// before it reads the copy.
__device__ __forceinline__ void stage(void* dst, const void* src,
                                      long long bytes, int tid,
                                      int threads) {
  const long long words = bytes >> 2;
  long long done = 0;
  if (!(reinterpret_cast<size_t>(src) & 15)) {
    done = (bytes >> 4) << 2;
    for (long long i = tid; i < done >> 2; i += threads) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(
          static_cast<char*>(dst) + 16 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                   "l"(static_cast<const char*>(src) + 16 * i)
                   : "memory");
    }
  }
  for (long long i = done + tid; i < words; i += threads)
    static_cast<int*>(dst)[i] = __ldcg(static_cast<const int*>(src) + i);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <class V>
__device__ __forceinline__ V shfl(V v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}

// Entry x of a map spread over a warp, lane l holding entries l and l +
// 32 (v0, v1): every lane of the warp calls it (x < 64).
template <class V>
__device__ __forceinline__ V entry_of(V v0, V v1, int x, bool two) {
  const V a = shfl(v0, x & 31);
  if (!two) return a;
  const V b = shfl(v1, x & 31);
  return x < 32 ? a : b;
}

// Entries a row of K6's aggregates: D rounded up to a multiple of 4, so
// that every row starts on 16 bytes.
__host__ __device__ __forceinline__ int padded(int D) {
  return (D + 3) & ~3;
}

// K6's look-back for tile t > 0, D <= 63, one warp: the tile's first
// boundary (*e) and the symbols before it (*k).  Y, the composite from
// the start of the earliest tile folded so far to the start of tile t,
// starts as the identity; lane l holds Y's entries l and l + 32.  The
// warp reads kWindow predecessors' descriptors at a time (nearest
// first), copies the aggregates of those up to the nearest inclusive
// prefix (one contiguous block of rows) into its buffer wg/wn
// ([kWindow][padded(D)]) in one round of cp.async, and folds them into Y,
//   Y.g[x] <- Y.g[A.g[x]],  Y.n[x] <- A.n[x] + Y.n[A.g[x]],
// until it meets an inclusive prefix (e, k) of tile s: the entry at tile
// s + 1 and the symbols of tiles 0..s.  Then tile t starts at Y.g[e]
// with k + Y.n[e] symbols before it.  A window costs two round trips to
// L2 (descriptors, then aggregates) and a fold two shuffles' latency.
__device__ void look_back(long long t, const longlong2* desc,
                          const int* agg_g, const long long* agg_n, int D,
                          int* wg, long long* wn, int* e, long long* k) {
  const int lane = threadIdx.x & 31, Dp = padded(D);
  const bool two = D > 32;
  int y0 = lane, y1 = lane + 32;
  long long m0 = 0, m1 = 0;
  for (long long j = t - 1;; j -= kWindow) {
    unsigned incl;
    const longlong2 d = lookback::window(j, desc, &incl);
    const int nfold = incl ? __ffs(incl) - 1 : kWindow;
    if (nfold) {
      __threadfence();  // read the aggregates after their flags
      const long long first = (j - nfold + 1) * Dp;
      stage(wn, agg_n + first, 8LL * nfold * Dp, lane, 32);
      stage(wg, agg_g + first, 4LL * nfold * Dp, lane, 32);
      cp_async_wait();
      __syncwarp();
#pragma unroll 4
      for (int i = 0; i < nfold; ++i) {  // tile j - i, in row nfold - 1 - i
        const int r = (nfold - 1 - i) * Dp;
        const int a0 = lane < D ? wg[r + lane] : lane;
        const int a1 = lane + 32 < D ? wg[r + lane + 32] : lane + 32;
        const long long n0 = lane < D ? wn[r + lane] : 0;
        const long long n1 = lane + 32 < D ? wn[r + lane + 32] : 0;
        const int g0 = entry_of(y0, y1, a0, two);
        const int g1 = entry_of(y0, y1, a1, two);
        const long long q0 = entry_of(m0, m1, a0, two);
        const long long q1 = entry_of(m0, m1, a1, two);
        y0 = g0;
        y1 = g1;
        m0 = n0 + q0;
        m1 = n1 + q1;
      }
      __syncwarp();  // the buffer is read before the next window's copy
    }
    if (incl) {  // the inclusive prefix, in lane nfold
      const int x = (int)shfl(d.y, nfold);
      *e = entry_of(y0, y1, x, two);
      *k = shfl(d.x, nfold) + entry_of(m0, m1, x, two);
      return;
    }
  }
}

// K6, D <= 63 (every tree of the main path).  A block claims the next
// tile of T chunks from the counter and stages the tile's rows of g and n
// in shared memory (cp.async, so every map byte is read from device
// memory once).  Its kScanWarps composing warps each compose a run of T /
// kScanWarps chunks: lane l carries the walks entered at offsets l and l
// + 32 through the run (X.n[j] += n[c][X.g[j]], X.g[j] = g[c][X.g[j]]);
// the runs' composites, in warp order, make the tile's aggregate, which
// the tile publishes (D-wide to scratch, then its descriptor, flagged
// AGGREGATE) before anything waits on its prefix.  Meanwhile its own
// warp looks back (look_back above), from the moment the tile is
// claimed.  With both, the look-back warp's lane 0 walks the runs'
// composites from the tile's entry, which gives each run's entry and
// count and the tile's inclusive prefix (the entry at the next tile and
// the symbols so far), published at once.  Then each composing warp's
// lane 0 walks its run from its entry in shared memory, staging entry
// and offsets, which the block stores whole.  Tile 0 starts at (0, 0)
// and publishes only its inclusive prefix.
__global__ void __launch_bounds__(kScanBlock, 2)
    fsm_scan_kernel(const int* __restrict__ g,
                    const long long* __restrict__ n, long long nchunks,
                    int D, int T, longlong2* desc, int* counter,
                    int* agg_g, long long* agg_n, int* __restrict__ entry,
                    long long* __restrict__ offsets,
                    long long* __restrict__ total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = padded(D);
  long long* sn = reinterpret_cast<long long*>(smem);  // [T][D] rows of n
  long long* xn = sn + (long long)T * D;  // [kScanWarps][D] composites
  long long* soff = xn + kScanWarps * D;  // [T] the tile's offsets
  long long* wn = soff + T;               // [kWindow][Dp] look-back buffer
  int* sg = reinterpret_cast<int*>(wn + kWindow * Dp);  // [T][D] of g
  int* xg = sg + T * D;                            // [kScanWarps][D]
  int* sent = xg + kScanWarps * D;  // [T] the tile's entries
  int* wg = sent + T;               // [kWindow][Dp]
  __shared__ long long s_tile;
  __shared__ int s_e[kScanWarps];              // each run's entry
  __shared__ long long s_k[kScanWarps];        // and its count
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const long long t = s_tile, c0 = t * T;
  const int rows = (int)min((long long)T, nchunks - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = T / kScanWarps;

  if (warp == kScanWarps) {
    int e = 0;
    long long k = 0;
    if (t) look_back(t, desc, agg_g, agg_n, D, wg, wn, &e, &k);
    bar_sync(kComposed, kScanBlock);
    if (lane == 0) {
      for (int w = 0; w < kScanWarps; ++w) {
        s_e[w] = e;
        s_k[w] = k;
        k += xn[w * D + e];
        e = xg[w * D + e];
      }
      lookback::store_desc(desc + t, k, (long long)kInclusive << 32 | e);
    }
  } else {
    stage(sn, n + c0 * D, 8LL * rows * D, threadIdx.x, kScanThreads);
    stage(sg, g + c0 * D, 4LL * rows * D, threadIdx.x, kScanThreads);
    cp_async_wait();
    bar_sync(kComposers, kScanThreads);
    const int r0 = warp * R, r1 = min(r0 + R, rows);
    for (int j = lane; j < D; j += 32) {
      int e = j;
      long long k = 0;
      for (int c = r0; c < r1; ++c) {
        k += sn[c * D + e];
        e = entry_in(sg[c * D + e], D);
      }
      xg[warp * D + j] = e;
      xn[warp * D + j] = k;
    }
    bar_sync(kComposers, kScanThreads);
    if (t) {
      for (int j = threadIdx.x; j < D; j += kScanThreads) {
        int e = j;
        long long k = 0;
        for (int w = 0; w < kScanWarps; ++w) {
          k += xn[w * D + e];
          e = xg[w * D + e];
        }
        agg_g[t * Dp + j] = e;
        agg_n[t * Dp + j] = k;
      }
      __threadfence();
      bar_sync(kComposers, kScanThreads);
      if (threadIdx.x == 0)
        lookback::store_desc(desc + t, 0, (long long)kAggregate << 32);
    }
    bar_arrive(kComposed, kScanBlock);
  }
  __syncthreads();
  if (warp < kScanWarps && lane == 0) {
    int e = s_e[warp];
    long long k = s_k[warp];
    const int r0 = warp * R, r1 = min(r0 + R, rows);
    for (int c = r0; c < r1; ++c) {
      sent[c] = e;
      soff[c] = k;
      k += sn[c * D + e];
      e = entry_in(sg[c * D + e], D);
    }
    if (r0 < r1 && c0 + r1 == nchunks) *total = k;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kScanBlock) {
    entry[c0 + i] = sent[i];
    offsets[c0 + i] = soff[i];
  }
}

// K6, D > 63 (deep trees only): no rows staged.  Each thread carries the
// walks entered at its offsets j through the tile's T chunks,
// reading the maps through L1/L2, which gives the aggregate directly.
// The look-back cannot hold a D-wide composite in a warp, so it finds
// the nearest inclusive prefix and walks its entry forward through the
// aggregates in between, one lookup a tile; thread 0 then walks the
// tile's chunks.
__global__ void __launch_bounds__(kScanThreads)
    fsm_scan_wide_kernel(const int* __restrict__ g,
                         const long long* __restrict__ n, long long nchunks,
                         int D, int T, longlong2* desc, int* counter,
                         int* agg_g, long long* agg_n,
                         int* __restrict__ entry,
                         long long* __restrict__ offsets,
                         long long* __restrict__ total) {
  __shared__ long long s_tile, s_k;
  __shared__ int s_e;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const long long t = s_tile, c0 = t * T;
  const int rows = (int)min((long long)T, nchunks - c0);
  const int* gt = g + c0 * D;
  const long long* nt = n + c0 * D;
  const int Dp = padded(D);
  for (int j = threadIdx.x; j < D; j += kScanThreads) {
    int e = j;
    long long k = 0;
    for (int c = 0; c < rows; ++c) {
      k += __ldg(nt + (long long)c * D + e);
      e = entry_in(__ldg(gt + (long long)c * D + e), D);
    }
    agg_g[t * Dp + j] = e;
    agg_n[t * Dp + j] = k;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x < 32) {
    int e = 0;
    long long k = 0;
    if (t) {
      if (threadIdx.x == 0)
        lookback::store_desc(desc + t, 0, (long long)kAggregate << 32);
      long long j = t - 1;
      unsigned incl;
      longlong2 d;
      for (;; j -= 32) {
        d = lookback::window(j, desc, &incl);
        if (incl) break;
      }
      const int stop = __ffs(incl) - 1;
      e = (int)shfl(d.y, stop);
      k = shfl(d.x, stop);
      __threadfence();  // read the aggregates after their flags
      for (long long i = j - stop + 1; i < t; ++i) {
        k += __ldcg(agg_n + i * Dp + e);
        e = __ldcg(agg_g + i * Dp + e);
      }
    }
    if (threadIdx.x == 0) {
      lookback::store_desc(desc + t, k + __ldcg(agg_n + t * Dp + e),
                           (long long)kInclusive << 32 |
                               __ldcg(agg_g + t * Dp + e));
      s_e = e;
      s_k = k;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int e = s_e;
    long long k = s_k;
    for (int c = 0; c < rows; ++c) {
      entry[c0 + c] = e;
      offsets[c0 + c] = k;
      k += __ldg(nt + (long long)c * D + e);
      e = entry_in(__ldg(gt + (long long)c * D + e), D);
    }
    if (c0 + rows == nchunks) *total = k;
  }
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

// A kernel's dynamic shared memory limit is one attribute for the
// process, and the sizes here depend on the call (the table's bits, the
// depth): a thread setting it and launching must not let another thread
// lower it in between (slabs decode in several threads at once).
std::mutex smem_attribute;

// Launches a kernel with `smem` bytes of dynamic shared memory, one
// thread a chunk.
template <class K, class... Args>
int launch(K kernel, size_t smem, int threads, long long nchunks,
           void* stream, Args... args) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(smem_attribute);
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

// K6.  tile: chunks a tile, a multiple of 32 (fsm_kernel.scan_tile).
// scratch: (ntiles + 1) 16-byte words (a descriptor a tile, then the
// tile counter; zeroed here), then the tiles' aggregates, rows of
// padded(D) entries: ntiles rows of int64 counts, ntiles of int32
// entries.
extern "C" int sz_fsm_scan(const int* g, const long long* n,
                           long long nchunks, int D, int tile,
                           void* scratch, int* entry, long long* offsets,
                           long long* total, void* stream) {
  if (nchunks < 1 || D < 1 || tile < 32 || tile % 32)
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (nchunks + tile - 1) / tile;
  if (ntiles >= 1LL << 31) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  longlong2* desc = (longlong2*)scratch;
  int* counter = (int*)(desc + ntiles);
  long long* agg_n = (long long*)(desc + ntiles + 1);
  int* agg_g = (int*)(agg_n + ntiles * padded(D));
  cudaError_t e = cudaMemsetAsync(desc, 0, (ntiles + 1) * 16, st);
  if (e != cudaSuccess) return (int)e;
  if (D > kWindowDepth) {
    fsm_scan_wide_kernel<<<(unsigned)ntiles, kScanThreads, 0, st>>>(
        g, n, nchunks, D, tile, desc, counter, agg_g, agg_n, entry, offsets,
        total);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      12 * ((size_t)tile * D + kScanWarps * D + tile + kWindow * padded(D));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(smem_attribute);
  e = cudaFuncSetAttribute(fsm_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  fsm_scan_kernel<<<(unsigned)ntiles, kScanBlock, smem, st>>>(
      g, n, nchunks, D, tile, desc, counter, agg_g, agg_n, entry, offsets,
      total);
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
