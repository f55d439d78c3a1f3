// K4 pack_bits: MSB-first Huffman bit-pack of the stream-ordered type
// codes on Hopper (sm_90a).  Output: the big-endian byte stream that
// sz_tpu/format/huffman.py::encode produces for the same table.
//
// Replaces sz_tpu/tpu/pack_kernel.py::pack2_bits (windowed table of at
// most 4096 symbols, codes <= 26 bits) and ::pack_bits (per-chunk
// concat tree, codes <= 32 bits).  This kernel takes the full
// HuffmanTables width: 128-bit codes as (code_hi, code_lo), MSB-aligned.
//
// Bound on this card: bytes, at best.  The least traffic is each symbol
// read once (4 B) and each output byte written once (a few bits a symbol
// on the main path's streams); the table (code_len, then code_hi, and
// code_lo for codes past 64 bits) is read through L1/L2, where the few
// hot entries of a type stream stay.  The design moves nothing else
// through device memory: one launch reads each symbol once and writes
// each output word once, with no offset scratch, no second pass over the
// symbols, no memset of the output and no separate byte swap.  What
// bounds it in practice is a tile's latency (its loads, the scan, and the
// look-back's round trips to L2) over the tiles in flight, six blocks an
// SM, which the 32 KB word buffer (128 bits a symbol) caps; so the
// look-back runs in a warp of its own, from the moment the tile is
// claimed, beside the packing.
//
//   1. A block claims the next tile of kTile symbols from a counter, so
//      tiles start in order.  Each thread loads a run of kRun consecutive
//      symbols (16-byte loads), gathers their code lengths and codes, and
//      sums the lengths; one block scan gives each run its tile-relative
//      bit offset and the tile's bit count m.
//   2. The tile's scan state is a segment (bits, tail): its bit count and
//      its last min(bits, 31) bits, which the runs that reach them OR
//      together from their own codes, so the tile publishes its segment
//      (its aggregate) before anything is packed.  Joining segments is
//      associative, so a single-pass chained scan with decoupled
//      look-back gives the tile the exact int64 bit offset s of its first
//      bit and the s mod 32 bits before it, past 2^31 bits included.  A
//      warp of its own looks back from the moment the tile is claimed,
//      while the packers work: it reads 32 predecessors' descriptors at a
//      time (aggregates, or an inclusive prefix, where it stops), folds
//      them in five shuffle steps, and publishes the tile's inclusive
//      prefix once the packers hand it the tile's segment.
//   3. Meanwhile each packing thread shifts its run's codes, 32 bits at a
//      time, through a 64-bit register and emits whole 32-bit words into
//      the tile's word buffer in shared memory (at most 128 bits a symbol
//      fit): a word the run covers alone is stored, the run's first and
//      last word, which a neighbouring run may share, are ORed (shared
//      atomics).
//   4. The block then writes every output word that ends inside the
//      tile, whole: word j is the funnel shift of buffer words j - 1 and
//      j by s mod 32 (for j = 0, the prefix's tail), byte-swapped on the
//      way out, coalesced.  The word that holds the tile's last bits is
//      left to the tile that completes it, which has those bits in its
//      prefix tail; the last tile also writes the stream's final partial
//      word.  So each output word is stored once, by one block.
// Codes occupy disjoint bit ranges and the scan sums integers, so the
// bytes do not depend on the order in which blocks run.  A block waits
// only on tiles claimed before it, by blocks already running, so the
// look-back cannot deadlock.  Symbols < 0 (holes) and symbols past the
// table contribute no bits.  Code lengths must lie in [0, 128], the
// table's width, as every HuffmanTables' do; for any other length the
// output is undefined and differs from the plain version's (the word
// buffer stays in bounds, but words past it are dropped).

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using lookback::bar_arrive;
using lookback::bar_sync;
using lookback::kAggregate;
using lookback::kInclusive;

constexpr int kThreads = 256;              // threads that pack
constexpr int kRun = 8;                    // consecutive symbols a thread
constexpr int kTile = kThreads * kRun;     // 2048 symbols a block
constexpr int kBlock = kThreads + 32;      // and one warp that looks back
constexpr int kMaxCodeBits = 128;
// a tile's words, and one zero word past them for the funnel shifts
constexpr int kWords = kTile * kMaxCodeBits / 32 + 1;
constexpr int kLookback = 32;              // predecessors a look-back step

// A segment of the bit stream: its length, and its last min(bits, 31)
// bits right-aligned.
struct Seg {
  long long bits;
  unsigned tail;
};

// The segment a followed by b.
__device__ __forceinline__ Seg join(Seg a, Seg b) {
  Seg r;
  r.bits = a.bits + b.bits;
  r.tail = b.bits >= 31 ? b.tail
                        : ((a.tail << (int)b.bits) | b.tail) & 0x7fffffffu;
  return r;
}

// A tile's descriptor (lookback.cuh) holds (bits, state << 32 | tail).
__device__ __forceinline__ void publish(longlong2* d, Seg v, int state) {
  lookback::store_desc(d, v.bits,
                       (long long)state << 32 | (long long)v.tail);
}

// Named barriers: the packing threads alone (kPackers), and the packers'
// hand-over of the tile's segment to the look-back warp (kSegmentReady).
constexpr int kPackers = 1, kSegmentReady = 2;

// Exclusive scan of one int per packing thread (threadIdx.x < kThreads).
__device__ __forceinline__ int packers_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  bar_sync(kPackers, kThreads);
  if (warp == 0) {
    int w = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;  // inclusive
  }
  bar_sync(kPackers, kThreads);
  *total = warp_sums[kThreads / 32 - 1];
  return (warp ? warp_sums[warp - 1] : 0) + incl - v;
}

// A 32-bit mask of the top k bits, 0 <= k <= 32.
__device__ __forceinline__ unsigned top_bits(int k) {
  return (unsigned)(0xffffffff00000000ull >> k);
}

__device__ __forceinline__ void put_word(unsigned* sh, int w, unsigned v,
                                         bool shared_word) {
  if (w >= kWords - 1) return;  // only codes past 128 bits reach here
  if (shared_word)
    atomicOr(sh + w, v);
  else
    sh[w] = v;
}

// The last min(L, 31) bits, right-aligned, of a code of L >= 1 bits as
// the stream holds it (bits past the table's 128 are zeros).
__device__ __forceinline__ unsigned code_tail(unsigned long long hi,
                                              unsigned long long lo, int L) {
  unsigned long long v;
  if (L <= 64)
    v = hi >> (64 - L);
  else if (L < 128)
    v = (hi << (L - 64)) | (lo >> (128 - L));
  else
    v = L - 128 >= 64 ? 0ull : lo << (L - 128);
  return (unsigned)v & 0x7fffffffu;
}

// Warp-wide decoupled look-back of tile t > 0: the segment of every bit
// before the tile.  Lane l reads tile j - l; the warp folds the window up
// to the nearest inclusive prefix, or all 32 aggregates and steps back.
__device__ Seg look_back(long long t, const longlong2* desc) {
  const int lane = threadIdx.x & 31;
  Seg suffix = {0, 0u};
  for (long long j = t - 1;; j -= kLookback) {
    unsigned incl;
    const longlong2 d = lookback::window(j, desc, &incl);
    const int stop = incl ? __ffs(incl) - 1 : kLookback - 1;
    // fold lanes stop..0 (earliest tile first) in five shuffle steps
    Seg v = {0, 0u};
    if (lane <= stop) v = Seg{d.x, (unsigned)d.y};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      Seg x;
      x.bits = __shfl_down_sync(0xffffffffu, v.bits, o);
      x.tail = __shfl_down_sync(0xffffffffu, v.tail, o);
      if (lane + o < 32) v = join(x, v);
    }
    v.bits = __shfl_sync(0xffffffffu, v.bits, 0);
    v.tail = __shfl_sync(0xffffffffu, v.tail, 0);
    suffix = join(v, suffix);
    if (incl) return suffix;
  }
}

// The last min(bits, 31) bits of a run of codes, right-aligned.
__device__ __forceinline__ unsigned run_tail(
    const int* s, const int* len, const unsigned long long* __restrict__ hi,
    const unsigned long long* __restrict__ lo) {
  unsigned tail = 0u;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const int L = len[q];
    if (L <= 0) continue;
    const unsigned c =
        code_tail(__ldg(hi + s[q]), L > 64 ? __ldg(lo + s[q]) : 0ull, L);
    tail = L >= 31 ? c : ((tail << L) | c) & 0x7fffffffu;
  }
  return tail;
}

__global__ void __launch_bounds__(kBlock) pack_lookback_kernel(
    const int* __restrict__ sym, long long n,
    const unsigned long long* __restrict__ code_hi,
    const unsigned long long* __restrict__ code_lo,
    const int* __restrict__ code_len, int nstates, longlong2* desc,
    int* counter, long long ntiles, unsigned* __restrict__ words,
    long long nwords) {
  __shared__ unsigned sh[kWords];
  __shared__ long long s_tile;
  __shared__ Seg s_own, s_before;
  if (threadIdx.x == 0) {
    s_tile = atomicAdd(counter, 1);
    s_own.tail = 0u;
  }
  __syncthreads();
  const long long t = s_tile;

  if (threadIdx.x >= kThreads) {
    // the look-back warp: the prefix of the tile from its predecessors,
    // while the packers load, scan and pack; then the inclusive prefix
    const Seg before = t ? look_back(t, desc) : Seg{0, 0u};
    bar_sync(kSegmentReady, kBlock);
    if (threadIdx.x == kThreads) {
      publish(desc + t, join(before, s_own), kInclusive);
      s_before = before;
    }
  } else {
    // 1. the run's symbols and code lengths; the packers' scan
    const long long base = t * kTile + (long long)threadIdx.x * kRun;
    int s[kRun];
    if (base + kRun <= n &&
        ((reinterpret_cast<size_t>(sym + base) & 15) == 0)) {
      const int4* p = reinterpret_cast<const int4*>(sym + base);
#pragma unroll
      for (int v = 0; v < kRun / 4; ++v) {
        const int4 q = __ldcs(p + v);
        s[4 * v] = q.x;
        s[4 * v + 1] = q.y;
        s[4 * v + 2] = q.z;
        s[4 * v + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kRun; ++q) s[q] = base + q < n ? sym[base + q] : -1;
    }
    int len[kRun];
    int bits = 0;
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      len[q] = (s[q] >= 0 && s[q] < nstates) ? __ldg(code_len + s[q]) : 0;
      bits += len[q];
    }
    int m;
    const int o = packers_exclusive_scan(bits, &m);
    // 2. the tile's segment: the runs that reach its last min(m, 31)
    // bits OR in their part, before anything is packed
    const int end = o + bits;
    if (bits > 0 && end > m - 31)
      atomicOr(&s_own.tail,
               (unsigned)((unsigned long long)run_tail(s, len, code_hi,
                                                       code_lo)
                          << (m - end)) &
                   0x7fffffffu);
    const int mw = min((m + 31) >> 5, kWords - 1);
    for (int w = threadIdx.x; w <= mw; w += kThreads) sh[w] = 0u;
    bar_sync(kPackers, kThreads);
    if (threadIdx.x == 0) {
      s_own.bits = m;
      publish(desc + t, s_own, kAggregate);
    }
    bar_arrive(kSegmentReady, kBlock);

    // 3. the run's codes into the tile's word buffer, 32 bits at a time
    if (bits > 0) {
      int w = o >> 5;
      int nacc = o & 31;  // bits before the run in its first word
      bool first_shared = nacc != 0;
      unsigned long long acc = 0ull;
      // append the top k (1..32) bits of c
      auto append = [&](unsigned c, int k) {
        acc |= ((unsigned long long)(c & top_bits(k)) << 32) >> nacc;
        nacc += k;
        if (nacc >= 32) {
          put_word(sh, w++, (unsigned)(acc >> 32), first_shared);
          first_shared = false;
          acc <<= 32;
          nacc -= 32;
        }
      };
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        const int L = len[q];
        if (L <= 0) continue;
        const unsigned long long hi = __ldg(code_hi + s[q]);
        if (L <= 32) {
          append((unsigned)(hi >> 32), L);
          continue;
        }
        append((unsigned)(hi >> 32), 32);
        append((unsigned)hi, min(L - 32, 32));
        if (L <= 64) continue;
        const unsigned long long lo = __ldg(code_lo + s[q]);
        append((unsigned)(lo >> 32), min(L - 64, 32));
        if (L > 96) append((unsigned)lo, min(L - 96, 32));
        // lengths past 128 bits (no HuffmanTables code) advance as zeros
        for (int k = L - 128; k > 0; k -= 32) append(0u, min(k, 32));
      }
      if (nacc > 0) put_word(sh, w, (unsigned)(acc >> 32), true);
    }
  }
  __syncthreads();

  // 4. the words that end inside the tile (and the stream's last word)
  const Seg before = s_before;
  const int m = (int)s_own.bits;
  const long long g0 = before.bits >> 5;
  const int r = (int)(before.bits & 31);
  int nout = (r + m) >> 5;
  if (t == ntiles - 1 && ((r + m) & 31)) ++nout;
  nout = min(nout, kWords - 1);
  for (int j = threadIdx.x; j < nout; j += kBlock) {
    unsigned v = sh[j];
    if (r) v = ((j ? sh[j - 1] : before.tail) << (32 - r)) | (v >> r);
    if (g0 + j < nwords) words[g0 + j] = __byte_perm(v, 0u, 0x0123);
  }
}

}  // namespace

// desc: (ntiles + 1) x 16 B scratch, zeroed here: a descriptor a tile,
// then the tile counter; words: uint32[nwords] output, nwords =
// ceil(total_bits / 32).
extern "C" int sz_pack_bits(const int* sym, long long n,
                            const unsigned long long* code_hi,
                            const unsigned long long* code_lo,
                            const int* code_len, int nstates, void* desc,
                            unsigned* words, long long nwords, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || nwords <= 0) return (int)cudaSuccess;
  const long long ntiles = (n + kTile - 1) / kTile;
  cudaError_t e = cudaMemsetAsync(desc, 0, (ntiles + 1) * 16, st);
  if (e != cudaSuccess) return (int)e;
  longlong2* d = (longlong2*)desc;
  pack_lookback_kernel<<<(unsigned)ntiles, kBlock, 0, st>>>(
      sym, n, code_hi, code_lo, code_len, nstates, d, (int*)(d + ntiles),
      ntiles, words, nwords);
  return (int)cudaGetLastError();
}
