// K14 ts_quantize and K15 ts_decode: the temporal codec's step against
// the previous step's reconstruction, on Hopper (sm_90a), in float32 and
// float64.
//
// K14 replaces sz_tpu/temporal.py::_ts_device_step_fn (and the float32
// ::_ts_step_jax), K15 ::_ts_decode_fn: XLA device steps of the JAX
// package, which have no Pallas form.  Their arithmetic is the host
// contract of compress_1d_ts / decompress_1d_ts
// (SZ_compress_float_1D_MDQ_ts sz_float_ts.c:69,
// decompressDataSeries_float_1D_ts szd_float_ts.c:19), in this order:
//
//   K14  pae   = |cur - prev|                       (in T)
//        cand  = (double)pae <= check_radius         (double)
//        state = (int)(((double)pae / rp + 1) / 2)   (truncation)
//        rec   = T((double)prev + (double)(+-state) * interval2)
//        esc   = !cand || (double)|cur - rec| > rp || i < 2
//        type  = esc ? 0 : radius +- state  (+ where cur >= prev)
//        an escape's reconstruction is the median-offset truncation of
//        the exact-value stream: T(bits(T(cur - median)) & mask) + median
//   K15  out   = T((double)prev + (double)(type - radius) * interval2),
//        an escape (type 0) the next value of the compact escape stream.
//
// Every rounding is an explicit _rn intrinsic and the build has
// --fmad=false: nothing is fused.  NaN compares false, so a NaN or an
// infinite point escapes, as in numpy.  Where rp = 0 (a PW_REL bound, or
// ABS 0) a candidate's quotient is 0/0: __double2int_rz gives state 0
// and the type radius, numpy's type too (its int64 of NaN has zero low
// 32 bits); the reconstruction prev + 0 may then differ from numpy's
// prev - 0 in the sign of a zero, on which no stream or decode depends.
//
// The division by 2 is a multiplication by 0.5 (__dmul_rn): both round
// the same exact real, so they give the same bits for every double,
// subnormals included.
//
// Bound on this card: bytes.  Both are elementwise: K14 reads cur and
// prev and writes the type and the reconstruction (16 bytes a float32
// point, 28 a float64 one) and each escape's value once; K15 reads the
// type and prev and writes the point (12 and 20 bytes) and reads each
// escape once.  The work a point is one double division and a few other
// double operations and conversions, below the card's 64-bit rates at
// these byte counts; in the float32 K14 it still holds about an eighth
// of the time (a copy with the arithmetic stubbed out runs 13 % faster
// on the H100, tools/temporal_variants.py), which stays: the bits may
// not change.
//
// Design: two launches a call, no look-back.  Escapes are rare (0.2 % of
// a chain's points), so the pass that moves every byte waits on nothing
// outside its block, and a second small launch places the escapes.
// - Slots and tiles.  A slot is kVec = 4 consecutive points, read and
//   written as 16-byte accesses (float4, two double2, int4).  The slots
//   start at point -lead, so that every full slot of the arrays that
//   matter most is 16-byte aligned: the wrapper picks the head (the
//   first aligned point, 0-3) that aligns the most bytes a point, and an
//   array that is not aligned at it (a view at an odd storage offset)
//   is read or written a point at a time, as is a slot that the field's
//   ends cut (a scalar head and tail).  A tile is kThreads x kSlots
//   slots, one block: thread x takes slots x, x + 256, ..., so a warp's
//   access is 512 contiguous bytes, and all of a thread's slots are
//   loaded before any is computed.  K14 takes 2 slots a thread (2048
//   points a tile, 64 registers: four blocks an SM), K15 4 (4096
//   points); on the H100 (tools/temporal_variants.py) K14 with 4 slots
//   ran 5-12 % slower, K15 with 2 up to 12 % slower and with 8 no
//   faster.
// - Pass A (ts_quantize_kernel, ts_decode_kernel and their _f64 forms),
//   blocks independent of each other.  K14 writes every type and
//   reconstruction; K15 writes every point (an escape gets a placeholder
//   that pass B overwrites).  The tile's escapes are ranked in index
//   order: a warp's count of each slot step (__reduce_add_sync), one
//   warp's scan of the kSlots x kWarps counts, and for each step in
//   which a warp has escapes, a shuffle scan of its lanes' counts.  K14
//   stages each escape's value, K15 each escape's position in the tile,
//   at its rank from the tile's first point (so the staging has room for
//   every point), and the tile's count is written unconditionally:
//   nothing needs zeroing.
// - Pass B (ts_quantize_escapes_kernel, ts_decode_escapes_kernel and
//   their _f64 forms) reads only the tile counts and the staged escapes.
//   A block takes groups of kGroup tiles (at most kPlaceBlocks blocks);
//   it sums the counts before its first tile, warp 0 scans a group's
//   counts, and a warp a tile moves the staged escapes: K14 to the
//   compact front of vals, in index order; K15 writes out[pos] = r <
//   nvals ? vals[r] : NaN.  The block that ends the field writes the
//   count.  The staging is a buffer of its own: in an all-escape step
//   the destination of tile t overlaps the staged escapes of earlier
//   tiles, which another block may not have moved yet.  Pass B costs
//   6-10 us a call on the H100 (its launch and a few dependent round
//   trips to L2); launching it as pass A's programmatic dependent did
//   not shorten it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;             // points a slot
constexpr int kQuantizeSlots = 2;   // K14's slots a thread: 2048 points a tile
constexpr int kDecodeSlots = 4;     // K15's: 4096 points a tile
constexpr int kGroup = 32;          // tiles pass B scans at once
constexpr int kPlaceBlocks = 256;   // pass B's most blocks
static_assert(kVec == 4, "a slot is one 16-byte access of float or int");

// Pass A's tile: kSlots slots a thread, all loaded before any is computed.
template <int kSlots_>
struct Tiling {
  static constexpr int kSlots = kSlots_;
  static constexpr int kTile = kThreads * kSlots * kVec;   // points
  static constexpr int kCounts = kSlots * kWarps;   // (slot step, warp)
  static constexpr int kScan = (kCounts + 31) / 32; // of them a lane scans
  // a thread's escapes, kVec bits a slot
  using Mask = std::conditional_t<(kSlots * kVec > 32), unsigned long long,
                                  unsigned>;
};
using QuantizeTiling = Tiling<kQuantizeSlots>;
using DecodeTiling = Tiling<kDecodeSlots>;

template <typename T>
struct Num;

template <>
struct Num<float> {
  using Bits = unsigned int;
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float narrow(double v) {
    return __double2float_rn(v);
  }
  static __device__ __forceinline__ Bits bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ float of_bits(Bits b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ float nan() {
    return __uint_as_float(0x7fc00000u);
  }
};

template <>
struct Num<double> {
  using Bits = unsigned long long;
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double narrow(double v) { return v; }
  static __device__ __forceinline__ Bits bits(double v) {
    return (Bits)__double_as_longlong(v);
  }
  static __device__ __forceinline__ double of_bits(Bits b) {
    return __longlong_as_double((long long)b);
  }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
};

// A slot as 16-byte accesses, from an address aligned for them.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[kVec]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<double> {
  static __device__ __forceinline__ void load(const double* p,
                                              double (&v)[kVec]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
  static __device__ __forceinline__ void store(double* p,
                                               const double (&v)[kVec]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
};

template <>
struct Pack<int> {
  static __device__ __forceinline__ void load(const int* p, int (&v)[kVec]) {
    const int4 a = *reinterpret_cast<const int4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(int* p, const int (&v)[kVec]) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ bool inside(long long j, long long n) {
  return j >= 0 && j < n;
}

// Points i .. i + kVec - 1: one vector access where the array is aligned
// for it (vec) and the slot lies in the field, else a point at a time,
// inside the field only.
template <typename T>
__device__ __forceinline__ void load_slot(const T* __restrict__ p,
                                          long long i, long long n, bool vec,
                                          T (&v)[kVec]) {
  if (vec && i >= 0 && i + kVec <= n) {
    Pack<T>::load(p + i, v);
    return;
  }
#pragma unroll
  for (int q = 0; q < kVec; ++q) v[q] = inside(i + q, n) ? p[i + q] : T(0);
}

template <typename T>
__device__ __forceinline__ void store_slot(T* __restrict__ p, long long i,
                                           long long n, bool vec,
                                           const T (&v)[kVec]) {
  if (vec && i >= 0 && i + kVec <= n) {
    Pack<T>::store(p + i, v);
    return;
  }
#pragma unroll
  for (int q = 0; q < kVec; ++q)
    if (inside(i + q, n)) p[i + q] = v[q];
}

// The escapes of slot step k among the thread's (bits).
template <typename Mask>
__device__ __forceinline__ unsigned step_bits(Mask bits, int k) {
  return (unsigned)(bits >> (k * kVec)) & ((1u << kVec) - 1u);
}

// Pass A's ranking, part 1: on return s_off[k * kWarps + warp] holds the
// tile's escapes before (step k, warp) in index order, and the tile's
// count is in *tile_count.
template <typename Tl>
__device__ __forceinline__ void rank_tile(typename Tl::Mask bits, int* s_off,
                                          int* tile_count) {
  constexpr int kScan = Tl::kScan, kCounts = Tl::kCounts;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < Tl::kSlots; ++k) {
    const unsigned w =
        __reduce_add_sync(0xffffffffu, (unsigned)__popc(step_bits(bits, k)));
    if (lane == 0) s_off[k * kWarps + warp] = (int)w;
  }
  __syncthreads();
  if (warp == 0) {
    int v[kScan], own = 0;
#pragma unroll
    for (int j = 0; j < kScan; ++j) {
      v[j] = lane * kScan + j < kCounts ? s_off[lane * kScan + j] : 0;
      own += v[j];
    }
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    int run = incl - own;
#pragma unroll
    for (int j = 0; j < kScan; ++j) {
      if (lane * kScan + j < kCounts) s_off[lane * kScan + j] = run;
      run += v[j];
    }
    if (lane == 31) *tile_count = incl;
  }
  __syncthreads();
}

// Pass A's ranking, part 2: put(k, q, r) for each of the thread's
// escapes (point q of its slot step k), r its rank in the tile.
template <typename Tl, typename Put>
__device__ __forceinline__ void each_escape(typename Tl::Mask bits,
                                            const int* s_off, Put put) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < Tl::kSlots; ++k) {
    const unsigned m = step_bits(bits, k);
    if (!__any_sync(0xffffffffu, m)) continue;
    const int c = __popc(m);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    int r = s_off[k * kWarps + warp] + incl - c;
#pragma unroll
    for (int q = 0; q < kVec; ++q)
      if ((m >> q) & 1u) put(k, q, r++);
  }
}

// The first point of slot step k of this thread in tile t.
template <typename Tl>
__device__ __forceinline__ long long slot_point(long long t, int lead,
                                                int k) {
  return t * Tl::kTile - lead +
         (long long)(k * kThreads + threadIdx.x) * kVec;
}

// The first point in the field of tile t of kTile points: its escapes
// are staged from there.
template <int kTile>
__device__ __forceinline__ long long tile_first(long long t, int lead) {
  const long long p = t * kTile - lead;
  return p < 0 ? 0 : p;
}

template <typename T>
struct StepArgs {   // K14's scalars
  double rp, check_radius, interval2;
  typename Num<T>::Bits mask;
  T median;
  int radius;
};

// One point of K14: whether it escapes, its type and reconstruction.
template <typename T>
__device__ __forceinline__ bool quantize_point(T x, T p, bool first_two,
                                               const StepArgs<T>& a,
                                               int& type, T& rec) {
  using N = Num<T>;
  const T pae = N::abs(N::sub(x, p));
  const bool cand = (double)pae <= a.check_radius;
  // the state only matters where it is a candidate, where it is small
  const int state =
      cand ? __double2int_rz(__dmul_rn(
                 __dadd_rn(__ddiv_rn((double)pae, a.rp), 1.0), 0.5))
           : 0;
  const int s = x >= p ? state : -state;
  const T r = N::narrow(__dadd_rn((double)p, __dmul_rn((double)s,
                                                       a.interval2)));
  const bool bad = (double)N::abs(N::sub(x, r)) > a.rp;
  const bool e = !cand || bad || first_two;
  type = e ? 0 : a.radius + s;
  rec = e ? N::add(N::of_bits(N::bits(N::sub(x, a.median)) & a.mask),
                   a.median)
          : r;
  return e;
}

// vec: bit 0 the first input, bit 1 the second, bit 2 the first output,
// bit 3 the second output aligned for vector accesses.
template <typename T, typename Tl>
__device__ __forceinline__ void quantize_tile(
    const T* __restrict__ cur, const T* __restrict__ prev, long long n,
    int lead, int vec, const StepArgs<T>& a, int* __restrict__ types,
    T* __restrict__ recon, T* __restrict__ stage,
    int* __restrict__ tile_count) {
  __shared__ int s_off[Tl::kCounts];
  const long long t = blockIdx.x;
  T x[Tl::kSlots][kVec], p[Tl::kSlots][kVec];
#pragma unroll
  for (int k = 0; k < Tl::kSlots; ++k) {
    const long long i = slot_point<Tl>(t, lead, k);
    if (i < n) {
      load_slot(cur, i, n, vec & 1, x[k]);
      load_slot(prev, i, n, vec & 2, p[k]);
    }
  }
  typename Tl::Mask bits = 0;
#pragma unroll
  for (int k = 0; k < Tl::kSlots; ++k) {
    const long long i = slot_point<Tl>(t, lead, k);
    if (i >= n) continue;
    int ty[kVec];
    T rc[kVec];
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      ty[q] = 0;
      rc[q] = T(0);
      if (inside(i + q, n) &&
          quantize_point(x[k][q], p[k][q], i + q < 2, a, ty[q], rc[q]))
        m |= 1u << q;
    }
    store_slot(types, i, n, vec & 4, ty);
    store_slot(recon, i, n, vec & 8, rc);
    bits |= (typename Tl::Mask)m << (k * kVec);
  }
  rank_tile<Tl>(bits, s_off, tile_count + t);
  T* st = stage + tile_first<Tl::kTile>(t, lead);
  each_escape<Tl>(bits, s_off, [&](int k, int q, int r) {
    st[r] = cur[slot_point<Tl>(t, lead, k) + q];
  });
}

template <typename T, typename Tl>
__device__ __forceinline__ void decode_tile(
    const int* __restrict__ types, const T* __restrict__ prev, long long n,
    int lead, int vec, int radius, double interval2, T* __restrict__ out,
    int* __restrict__ stage, int* __restrict__ tile_count) {
  using N = Num<T>;
  __shared__ int s_off[Tl::kCounts];
  const long long t = blockIdx.x;
  int ty[Tl::kSlots][kVec];
  T p[Tl::kSlots][kVec];
#pragma unroll
  for (int k = 0; k < Tl::kSlots; ++k) {
    const long long i = slot_point<Tl>(t, lead, k);
    if (i < n) {
      load_slot(types, i, n, vec & 1, ty[k]);
      load_slot(prev, i, n, vec & 2, p[k]);
    }
  }
  typename Tl::Mask bits = 0;
#pragma unroll
  for (int k = 0; k < Tl::kSlots; ++k) {
    const long long i = slot_point<Tl>(t, lead, k);
    if (i >= n) continue;
    T o[kVec];
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      // an escape's placeholder is overwritten by pass B
      o[q] = N::narrow(__dadd_rn(
          (double)p[k][q], __dmul_rn((double)(ty[k][q] - radius), interval2)));
      if (inside(i + q, n) && ty[k][q] == 0) m |= 1u << q;
    }
    store_slot(out, i, n, vec & 4, o);
    bits |= (typename Tl::Mask)m << (k * kVec);
  }
  rank_tile<Tl>(bits, s_off, tile_count + t);
  const long long first = tile_first<Tl::kTile>(t, lead);
  int* st = stage + first;
  each_escape<Tl>(bits, s_off, [&](int k, int q, int r) {
    st[r] = (int)(slot_point<Tl>(t, lead, k) + q - first);
  });
}

// Pass B: the tiles of this block, kGroup at a time; move(first, r, dst)
// for the r-th escape of the tile whose first point is first, dst its
// rank in the field.  The block that ends the field writes the count.
template <int kTile, typename Move>
__device__ __forceinline__ void place_escapes(const int* __restrict__ counts,
                                              long long ntiles, int lead,
                                              long long per_block,
                                              long long* count, Move move) {
  __shared__ long long s_part[kWarps];
  __shared__ int s_pre[kGroup + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g0 = (long long)blockIdx.x * per_block * kGroup;
  const long long g1 =
      g0 + per_block * kGroup < ntiles ? g0 + per_block * kGroup : ntiles;
  // the escapes before tile g0 (a multiple of 4: whole int4 loads)
  long long s = 0;
#pragma unroll 4
  for (long long j = 4LL * threadIdx.x; j < g0; j += 4 * kThreads) {
    const int4 c = *reinterpret_cast<const int4*>(counts + j);
    s += (long long)c.x + c.y + c.z + c.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) s_part[warp] = s;
  __syncthreads();
  long long base = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) base += s_part[w];
  for (long long t0 = g0; t0 < g1; t0 += kGroup) {
    if (warp == 0) {
      const int c = t0 + lane < g1 ? counts[t0 + lane] : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      s_pre[lane] = incl - c;
      if (lane == 31) s_pre[kGroup] = incl;
    }
    __syncthreads();
    for (int l = warp; l < kGroup && t0 + l < g1; l += kWarps) {
      const long long first = tile_first<kTile>(t0 + l, lead);
      const int c = s_pre[l + 1] - s_pre[l];
      const long long dst = base + s_pre[l];
      for (int r = lane; r < c; r += 32) move(first, r, dst + r);
    }
    base += s_pre[kGroup];
    __syncthreads();
  }
  if (g1 == ntiles && threadIdx.x == 0) *count = base;
}

__global__ void __launch_bounds__(kThreads) ts_quantize_kernel(
    const float* __restrict__ cur, const float* __restrict__ prev,
    long long n, int lead, int vec, StepArgs<float> a,
    int* __restrict__ types, float* __restrict__ recon,
    float* __restrict__ stage, int* __restrict__ tile_count) {
  quantize_tile<float, QuantizeTiling>(cur, prev, n, lead, vec, a, types,
                                       recon, stage, tile_count);
}

__global__ void __launch_bounds__(kThreads) ts_quantize_f64_kernel(
    const double* __restrict__ cur, const double* __restrict__ prev,
    long long n, int lead, int vec, StepArgs<double> a,
    int* __restrict__ types, double* __restrict__ recon,
    double* __restrict__ stage, int* __restrict__ tile_count) {
  quantize_tile<double, QuantizeTiling>(cur, prev, n, lead, vec, a, types,
                                        recon, stage, tile_count);
}

template <typename T>
__device__ __forceinline__ void compact_escapes(
    const T* __restrict__ stage, const int* __restrict__ tile_count,
    long long ntiles, int lead, long long per_block, T* __restrict__ vals,
    long long* count) {
  place_escapes<QuantizeTiling::kTile>(
      tile_count, ntiles, lead, per_block, count,
      [&](long long first, int r, long long dst) {
        vals[dst] = stage[first + r];
      });
}

__global__ void __launch_bounds__(kThreads) ts_quantize_escapes_kernel(
    const float* __restrict__ stage, const int* __restrict__ tile_count,
    long long ntiles, int lead, long long per_block,
    float* __restrict__ vals, long long* count) {
  compact_escapes<float>(stage, tile_count, ntiles, lead, per_block, vals,
                         count);
}

__global__ void __launch_bounds__(kThreads) ts_quantize_escapes_f64_kernel(
    const double* __restrict__ stage, const int* __restrict__ tile_count,
    long long ntiles, int lead, long long per_block,
    double* __restrict__ vals, long long* count) {
  compact_escapes<double>(stage, tile_count, ntiles, lead, per_block, vals,
                          count);
}

__global__ void __launch_bounds__(kThreads) ts_decode_kernel(
    const int* __restrict__ types, const float* __restrict__ prev,
    long long n, int lead, int vec, int radius, double interval2,
    float* __restrict__ out, int* __restrict__ stage,
    int* __restrict__ tile_count) {
  decode_tile<float, DecodeTiling>(types, prev, n, lead, vec, radius,
                                   interval2, out, stage, tile_count);
}

__global__ void __launch_bounds__(kThreads) ts_decode_f64_kernel(
    const int* __restrict__ types, const double* __restrict__ prev,
    long long n, int lead, int vec, int radius, double interval2,
    double* __restrict__ out, int* __restrict__ stage,
    int* __restrict__ tile_count) {
  decode_tile<double, DecodeTiling>(types, prev, n, lead, vec, radius,
                                    interval2, out, stage, tile_count);
}

template <typename T>
__device__ __forceinline__ void restore_escapes(
    const int* __restrict__ stage, const int* __restrict__ tile_count,
    long long ntiles, int lead, long long per_block,
    const T* __restrict__ vals, long long nvals, T* __restrict__ out,
    long long* count) {
  place_escapes<DecodeTiling::kTile>(
      tile_count, ntiles, lead, per_block, count,
      [&](long long first, int r, long long dst) {
        out[first + stage[first + r]] =
            dst < nvals ? vals[dst] : Num<T>::nan();
      });
}

__global__ void __launch_bounds__(kThreads) ts_decode_escapes_kernel(
    const int* __restrict__ stage, const int* __restrict__ tile_count,
    long long ntiles, int lead, long long per_block,
    const float* __restrict__ vals, long long nvals, float* __restrict__ out,
    long long* count) {
  restore_escapes<float>(stage, tile_count, ntiles, lead, per_block, vals,
                         nvals, out, count);
}

__global__ void __launch_bounds__(kThreads) ts_decode_escapes_f64_kernel(
    const int* __restrict__ stage, const int* __restrict__ tile_count,
    long long ntiles, int lead, long long per_block,
    const double* __restrict__ vals, long long nvals,
    double* __restrict__ out, long long* count) {
  restore_escapes<double>(stage, tile_count, ntiles, lead, per_block, vals,
                          nvals, out, count);
}

// Both passes' launch geometry: tiles from point -lead, pass B's blocks
// each taking per_block groups of kGroup tiles.
struct Geometry {
  int lead;
  long long ntiles, per_block, blocks;
};

Geometry geometry(long long n, int head, int kTile) {
  Geometry g;
  g.lead = (kVec - head % kVec) % kVec;
  g.ntiles = (n + g.lead + kTile - 1) / kTile;
  const long long groups = (g.ntiles + kGroup - 1) / kGroup;
  g.per_block = (groups + kPlaceBlocks - 1) / kPlaceBlocks;
  g.blocks = (groups + g.per_block - 1) / g.per_block;
  return g;
}

// Bit b of the result: pointer b, of its element size, is 16-byte
// aligned at point head.
int aligned(int head, const void* const* ptrs, const int* sizes, int k) {
  int vec = 0;
  for (int b = 0; b < k; ++b)
    if (((uintptr_t)ptrs[b] + (uintptr_t)sizes[b] * head) % 16 == 0)
      vec |= 1 << b;
  return vec;
}

template <typename T, typename KernelA, typename KernelB>
int quantize(KernelA pass_a, KernelB pass_b, const T* cur, const T* prev,
             long long n, const StepArgs<T>& a, int head, int* types,
             T* recon, T* vals, long long* count, T* stage, int* tile_count,
             cudaStream_t st) {
  if (n <= 0) return (int)cudaMemsetAsync(count, 0, sizeof(long long), st);
  const Geometry g = geometry(n, head, QuantizeTiling::kTile);
  const void* ptrs[4] = {cur, prev, types, recon};
  const int sizes[4] = {(int)sizeof(T), (int)sizeof(T), 4, (int)sizeof(T)};
  pass_a<<<(unsigned)g.ntiles, kThreads, 0, st>>>(
      cur, prev, n, g.lead, aligned(head, ptrs, sizes, 4), a, types, recon,
      stage, tile_count);
  pass_b<<<(unsigned)g.blocks, kThreads, 0, st>>>(
      stage, tile_count, g.ntiles, g.lead, g.per_block, vals, count);
  return (int)cudaGetLastError();
}

template <typename T, typename KernelA, typename KernelB>
int decode(KernelA pass_a, KernelB pass_b, const int* types, const T* prev,
           long long n, const T* vals, long long nvals, int radius,
           double interval2, int head, T* out, long long* count, int* stage,
           int* tile_count, cudaStream_t st) {
  if (n <= 0) return (int)cudaMemsetAsync(count, 0, sizeof(long long), st);
  const Geometry g = geometry(n, head, DecodeTiling::kTile);
  const void* ptrs[3] = {types, prev, out};
  const int sizes[3] = {4, (int)sizeof(T), (int)sizeof(T)};
  pass_a<<<(unsigned)g.ntiles, kThreads, 0, st>>>(
      types, prev, n, g.lead, aligned(head, ptrs, sizes, 3), radius,
      interval2, out, stage, tile_count);
  pass_b<<<(unsigned)g.blocks, kThreads, 0, st>>>(
      stage, tile_count, g.ntiles, g.lead, g.per_block, vals, nvals, out,
      count);
  return (int)cudaGetLastError();
}

}  // namespace

// head: the first point at which the slots are aligned (0-3, the
// wrapper's choice).  vals: room for every point (the compact escape
// values, in index order); count: int64, the escapes.  stage: room for
// every point (the staged escape values); tile_count: an int a tile
// (QuantizeTiling::kTile points, the first from point head - 4 where
// head > 0, else 0).
extern "C" int sz_ts_quantize(const float* cur, const float* prev,
                              long long n, double rp, double check_radius,
                              double interval2, int radius,
                              unsigned long long mask, float median,
                              int head, int* types, float* recon,
                              float* vals, long long* count, float* stage,
                              int* tile_count, void* stream) {
  const StepArgs<float> a{rp, check_radius, interval2, (unsigned)mask,
                          median, radius};
  return quantize(ts_quantize_kernel, ts_quantize_escapes_kernel, cur, prev,
                  n, a, head, types, recon, vals, count, stage, tile_count,
                  (cudaStream_t)stream);
}

extern "C" int sz_ts_quantize_f64(const double* cur, const double* prev,
                                  long long n, double rp,
                                  double check_radius, double interval2,
                                  int radius, unsigned long long mask,
                                  double median, int head, int* types,
                                  double* recon, double* vals,
                                  long long* count, double* stage,
                                  int* tile_count, void* stream) {
  const StepArgs<double> a{rp, check_radius, interval2, mask, median,
                           radius};
  return quantize(ts_quantize_f64_kernel, ts_quantize_escapes_f64_kernel,
                  cur, prev, n, a, head, types, recon, vals, count, stage,
                  tile_count, (cudaStream_t)stream);
}

// vals: the nvals escape values in stream order; count: int64, the
// escapes the types call for (more than nvals: a corrupt stream).
// stage: an int a point (the escapes' positions); tile_count: an int a
// tile of DecodeTiling::kTile points, placed as K14's.
extern "C" int sz_ts_decode(const int* types, const float* prev, long long n,
                            const float* vals, long long nvals, int radius,
                            double interval2, int head, float* out,
                            long long* count, int* stage, int* tile_count,
                            void* stream) {
  return decode(ts_decode_kernel, ts_decode_escapes_kernel, types, prev, n,
                vals, nvals, radius, interval2, head, out, count, stage,
                tile_count, (cudaStream_t)stream);
}

extern "C" int sz_ts_decode_f64(const int* types, const double* prev,
                                long long n, const double* vals,
                                long long nvals, int radius,
                                double interval2, int head, double* out,
                                long long* count, int* stage,
                                int* tile_count, void* stream) {
  return decode(ts_decode_f64_kernel, ts_decode_escapes_f64_kernel, types,
                prev, n, vals, nvals, radius, interval2, head, out, count,
                stage, tile_count, (cudaStream_t)stream);
}
