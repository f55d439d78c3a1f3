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
// Bound on this card: bytes.  Both passes are elementwise: K14 reads cur
// and prev and writes the type and the reconstruction (16 bytes a
// float32 point, 28 a float64 one) and each escape's value once; K15
// reads the type and prev and writes the point (12 and 20 bytes) and
// reads each escape once.  The work a point is a few double operations,
// far below the card's 64-bit rate at these byte counts.
//
// Design.  A block claims the next tile of kTile points from a counter,
// so tiles start in order; thread x takes points x, x + 256, ... (kPer
// of them), so each load and store of a warp is one contiguous run.  The
// escapes are ranked in index order: a ballot per warp and step ranks a
// lane among its warp's escapes of that step; warp 0 scans the kPer x 8
// counts of the tile in index order, and the tile's total takes its
// exclusive prefix over the tiles before it from a single-pass chained
// scan with decoupled look-back (lookback.cuh, as K4 and K6): warp 0
// publishes the tile's count as its aggregate, reads 32 predecessors'
// descriptors at a time back to the nearest inclusive prefix, and
// publishes the tile's inclusive prefix.  A block waits only on tiles
// claimed before it, by blocks already running, so the look-back cannot
// deadlock.  K14 writes the types and the reconstruction before the
// look-back and each escape's value at its rank after it; K15 writes the
// predicted points before and each escape from the compact stream after
// (NaN for an escape past its end, which the count exposes).  The tile
// that ends the field writes the escape count.

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using lookback::kAggregate;
using lookback::kInclusive;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                   // points a thread
constexpr int kTile = kThreads * kPer;    // 2048 points a block
static_assert(kPer * kWarps == 64, "warp 0 scans two counts a lane");

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

// Warp-wide decoupled look-back of tile t > 0: the escapes before it.
__device__ long long look_back(long long t, const longlong2* desc) {
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  for (long long j = t - 1;; j -= 32) {
    unsigned incl;
    const longlong2 d = lookback::window(j, desc, &incl);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    long long v = lane <= stop ? d.x : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    sum += v;
    if (incl) return sum;
  }
}

// The tile's escapes in index order.  ballot[k]: the warp's escapes of
// step k.  On return s_off[k * kWarps + warp] holds the escapes of the
// tile before that (step, warp) and *s_base those before the tile; the
// tile that ends the field has written the total to *count.
__device__ __forceinline__ void rank_tile(const unsigned* ballot,
                                          long long t, long long ntiles,
                                          longlong2* desc, long long* count,
                                          int* s_off, long long* s_base) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) s_off[k * kWarps + warp] = __popc(ballot[k]);
  }
  __syncthreads();
  if (warp == 0) {
    const int a = s_off[2 * lane], b = s_off[2 * lane + 1];
    int incl = a + b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    s_off[2 * lane] = incl - a - b;
    s_off[2 * lane + 1] = incl - b;
    const long long own = __shfl_sync(0xffffffffu, incl, 31);
    long long before = 0;
    if (t > 0) {
      if (lane == 0)
        lookback::store_desc(desc + t, own, (long long)kAggregate << 32);
      before = look_back(t, desc);
    }
    if (lane == 0) {
      lookback::store_desc(desc + t, before + own,
                           (long long)kInclusive << 32);
      *s_base = before;
      if (t == ntiles - 1) *count = before + own;
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void ts_quantize_tile(
    const T* __restrict__ cur, const T* __restrict__ prev, long long n,
    double rp, double check_radius, double interval2, int radius,
    typename Num<T>::Bits mask, T median, int* __restrict__ types,
    T* __restrict__ recon, T* __restrict__ esc, long long* count,
    longlong2* desc, int* counter, long long ntiles) {
  using N = Num<T>;
  __shared__ int s_off[kPer * kWarps];
  __shared__ long long s_tile, s_base;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const long long t = s_tile;
  const long long first = t * kTile + threadIdx.x;
  unsigned ballot[kPer];
  T c[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = first + (long long)k * kThreads;
    bool e = false;
    c[k] = T(0);
    if (i < n) {
      const T x = cur[i];
      const T p = prev[i];
      c[k] = x;
      const T pae = N::abs(N::sub(x, p));
      const bool cand = (double)pae <= check_radius;
      // the state only matters where it is a candidate, where it is small
      const int state =
          cand ? __double2int_rz(__ddiv_rn(
                     __dadd_rn(__ddiv_rn((double)pae, rp), 1.0), 2.0))
               : 0;
      const int s = x >= p ? state : -state;
      const T rec =
          N::narrow(__dadd_rn((double)p, __dmul_rn((double)s, interval2)));
      const bool bad = (double)N::abs(N::sub(x, rec)) > rp;
      e = !cand || bad || i < 2;
      types[i] = e ? 0 : radius + s;
      recon[i] = e ? N::add(N::of_bits(N::bits(N::sub(x, median)) & mask),
                            median)
                   : rec;
    }
    ballot[k] = __ballot_sync(0xffffffffu, e);
  }
  rank_tile(ballot, t, ntiles, desc, count, s_off, &s_base);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if ((ballot[k] >> lane) & 1u)
      esc[s_base + s_off[k * kWarps + warp] + __popc(ballot[k] & below)] =
          c[k];
  }
}

template <typename T>
__device__ __forceinline__ void ts_decode_tile(
    const int* __restrict__ types, const T* __restrict__ prev, long long n,
    const T* __restrict__ vals, long long nvals, int radius,
    double interval2, T* __restrict__ out, long long* count,
    longlong2* desc, int* counter, long long ntiles) {
  using N = Num<T>;
  __shared__ int s_off[kPer * kWarps];
  __shared__ long long s_tile, s_base;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const long long t = s_tile;
  const long long first = t * kTile + threadIdx.x;
  unsigned ballot[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = first + (long long)k * kThreads;
    bool e = false;
    if (i < n) {
      const int q = types[i];
      e = q == 0;
      if (!e)
        out[i] = N::narrow(__dadd_rn(
            (double)prev[i], __dmul_rn((double)(q - radius), interval2)));
    }
    ballot[k] = __ballot_sync(0xffffffffu, e);
  }
  rank_tile(ballot, t, ntiles, desc, count, s_off, &s_base);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if ((ballot[k] >> lane) & 1u) {
      const long long r =
          s_base + s_off[k * kWarps + warp] + __popc(ballot[k] & below);
      out[first + (long long)k * kThreads] = r < nvals ? vals[r] : N::nan();
    }
  }
}

__global__ void __launch_bounds__(kThreads) ts_quantize_kernel(
    const float* __restrict__ cur, const float* __restrict__ prev,
    long long n, double rp, double check_radius, double interval2,
    int radius, unsigned mask, float median, int* __restrict__ types,
    float* __restrict__ recon, float* __restrict__ esc, long long* count,
    longlong2* desc, int* counter, long long ntiles) {
  ts_quantize_tile<float>(cur, prev, n, rp, check_radius, interval2, radius,
                          mask, median, types, recon, esc, count, desc,
                          counter, ntiles);
}

__global__ void __launch_bounds__(kThreads) ts_quantize_f64_kernel(
    const double* __restrict__ cur, const double* __restrict__ prev,
    long long n, double rp, double check_radius, double interval2,
    int radius, unsigned long long mask, double median,
    int* __restrict__ types, double* __restrict__ recon,
    double* __restrict__ esc, long long* count, longlong2* desc,
    int* counter, long long ntiles) {
  ts_quantize_tile<double>(cur, prev, n, rp, check_radius, interval2, radius,
                           mask, median, types, recon, esc, count, desc,
                           counter, ntiles);
}

__global__ void __launch_bounds__(kThreads) ts_decode_kernel(
    const int* __restrict__ types, const float* __restrict__ prev,
    long long n, const float* __restrict__ vals, long long nvals,
    int radius, double interval2, float* __restrict__ out, long long* count,
    longlong2* desc, int* counter, long long ntiles) {
  ts_decode_tile<float>(types, prev, n, vals, nvals, radius, interval2, out,
                        count, desc, counter, ntiles);
}

__global__ void __launch_bounds__(kThreads) ts_decode_f64_kernel(
    const int* __restrict__ types, const double* __restrict__ prev,
    long long n, const double* __restrict__ vals, long long nvals,
    int radius, double interval2, double* __restrict__ out,
    long long* count, longlong2* desc, int* counter, long long ntiles) {
  ts_decode_tile<double>(types, prev, n, vals, nvals, radius, interval2, out,
                         count, desc, counter, ntiles);
}

// Zero the count, and the descriptors and the tile counter after them.
int prepare(long long ntiles, void* desc, long long* count,
            cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(long long), st);
  if (e == cudaSuccess && ntiles > 0)
    e = cudaMemsetAsync(desc, 0, (ntiles + 1) * 16, st);
  return (int)e;
}

}  // namespace

// desc: (ceil(n / 2048) + 1) x 16 B scratch, zeroed here: a descriptor a
// tile, then the tile counter.  esc: room for every point (the compact
// escape values, in index order); count: int64, the escapes.
extern "C" int sz_ts_quantize(const float* cur, const float* prev,
                              long long n, double rp, double check_radius,
                              double interval2, int radius,
                              unsigned long long mask, float median,
                              int* types, float* recon, float* esc,
                              long long* count, void* desc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long ntiles = (n + kTile - 1) / kTile;
  int rc = prepare(ntiles, desc, count, st);
  if (rc || n <= 0) return rc;
  longlong2* d = (longlong2*)desc;
  ts_quantize_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(
      cur, prev, n, rp, check_radius, interval2, radius, (unsigned)mask,
      median, types, recon, esc, count, d, (int*)(d + ntiles), ntiles);
  return (int)cudaGetLastError();
}

extern "C" int sz_ts_quantize_f64(const double* cur, const double* prev,
                                  long long n, double rp,
                                  double check_radius, double interval2,
                                  int radius, unsigned long long mask,
                                  double median, int* types, double* recon,
                                  double* esc, long long* count, void* desc,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long ntiles = (n + kTile - 1) / kTile;
  int rc = prepare(ntiles, desc, count, st);
  if (rc || n <= 0) return rc;
  longlong2* d = (longlong2*)desc;
  ts_quantize_f64_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(
      cur, prev, n, rp, check_radius, interval2, radius, mask, median, types,
      recon, esc, count, d, (int*)(d + ntiles), ntiles);
  return (int)cudaGetLastError();
}

// vals: the nvals escape values in stream order; count: int64, the
// escapes the types call for (more than nvals: a corrupt stream).
extern "C" int sz_ts_decode(const int* types, const float* prev, long long n,
                            const float* vals, long long nvals, int radius,
                            double interval2, float* out, long long* count,
                            void* desc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long ntiles = (n + kTile - 1) / kTile;
  int rc = prepare(ntiles, desc, count, st);
  if (rc || n <= 0) return rc;
  longlong2* d = (longlong2*)desc;
  ts_decode_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(
      types, prev, n, vals, nvals, radius, interval2, out, count, d,
      (int*)(d + ntiles), ntiles);
  return (int)cudaGetLastError();
}

extern "C" int sz_ts_decode_f64(const int* types, const double* prev,
                                long long n, const double* vals,
                                long long nvals, int radius,
                                double interval2, double* out,
                                long long* count, void* desc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long ntiles = (n + kTile - 1) / kTile;
  int rc = prepare(ntiles, desc, count, st);
  if (rc || n <= 0) return rc;
  longlong2* d = (longlong2*)desc;
  ts_decode_f64_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(
      types, prev, n, vals, nvals, radius, interval2, out, count, d,
      (int*)(d + ntiles), ntiles);
  return (int)cudaGetLastError();
}
