// K10 classic_quantize / K11 classic_decode: the classic SZ1.4 codec's
// positional Lorenzo recurrence on Hopper (sm_90a), encode and decode,
// on 2-D, 3-D and 4-D fields of float32 and float64.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as XLA,
// a plane scan with a per-plane fixpoint (sz_tpu/tpu/classic_engine.py
// ::_encode_fn and ::_decode_fn), whose rules are those of the reference
// kernels SZ_compress_float_{2,3,4}D_MDQ (sz_float.c:610/946/1479), the
// double twins and their decoders (szd_float.c:284/600).
//
// The predictor of point (i, j, k) depends on its position (the names
// A (k-1), B (j-1), C (i-1), D (j-1,k-1), E (i-1,j-1), F (i-1,k-1),
// G (i-1,j-1,k-1), A2 (k-2)):
//   layer i = 0 (a 2-D field is this layer alone): (0,0) escapes, (0,1)
//     takes A, the rest of row 0 2A - A2, column 0 B, the rest
//     (A + B) - D;
//   layers i >= 1: (0,0) takes C, row 0 (A + C) - F, column 0
//     (B + C) - E, the rest A + B, + C, - D, - E, - F, + G, one rounding
//     each (classic_engine.py:174-181).
// A 4-D field is q1 independent 3-D volumes (sz_float.c:1479), each
// restarting with an escape and the layer-0 scheme.
//
// Three numeric forms (core/classic_nd.Form): float32 data on ranks 2-3
// quantizes in float (rp, recip float; itvNum = (float)(fabs(diff) *
// (double)recip + 1.0)); float32 data on rank 4 declares double itvNum
// and keeps rp double, and reconstructs (float)((double)pred + q *
// (double)rp); float64 data is double throughout.  In every form t =
// (int)(itv / 2) + radius, the reconstruction takes two roundings, and
// the epsilon recheck |cur - rec| > rp is done in double.  An escape's
// reconstruction is its value less the median with the low
// width - req_length bits cleared, plus the median.
//
// A fourth form, K10's alone: the subblock kernels of SZ_compress_args3
// (SZ_compress_{float,double}_{2,3,4}D_MDQ_subblock, sz_float.c:3566/
// 3777/4118; sz_tpu/core/classic_nd.py:470-484), for a region of a
// field: itv = |(double)diff| / rp64 + 1 (a division, not the
// reciprocal), t = (int)(itv / 2) + radius, rec = (V)((double)pred +
// (double)(2 (t - radius)) * rp64), and no epsilon recheck, on float32
// and float64 data of every rank (a 4-D region runs the 3-D scheme per
// outer slice, as the double form does).  A template flag (kSub) of the
// double form, so the other forms compile as before.
//
// Design: warp strips on the machinery of strips.cuh (shared with
// K1d/K2d), whose note has the walk, the rings, the hand-offs and the
// claim order; here the point rules.  K10 stages the data, writes each
// type over its consumed value and the escape's reconstruction is taken
// off the chain at the group's load; K11 stages the types and reads the
// escapes compact, in raster order: a lane takes its row's first escape
// rank from row_base (the exclusive scan of the rows' escape counts) and
// counts on along the row, the next value loaded ahead.
//
// Bound on this card: the chain of steps, r1 + r2 + r3 - 2 of them plus
// what the hand-offs add (a group a plane, a slot chunk a plane group,
// 32 steps and a group a strip), each step the latency of one point's
// chain (the shuffle, the predictor's adds, the quantizer's double
// multiply-add and conversions); bytes are far below it (K10 8 bytes a
// float point with no R, K11 8 and the escapes).
//
// Bit-exactness: every float op that reaches the stream is an explicit
// round-to-nearest intrinsic in the JAX engine's op order; the build
// passes --fmad=false as well.  x * 0.5 replaces x / 2: both round the
// same real x / 2 (with -ftz=false, subnormal results included).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "strips.cuh"

namespace {

using namespace strips;

// Warps a block: W planes (rank 3) or strips (rank 2).  The rings
// take (33 + 32) x 65 entries a warp.
template <class V>
struct Warps {
  static constexpr int n = sizeof(V) == 8 ? 4 : 6;
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float narrow(double x, float*) {
  return __double2float_rn(x);
}
__device__ __forceinline__ double narrow(double x, double*) { return x; }

// An escape's reconstruction: (cur - median) with its low bits cleared,
// plus the median (compressSingleFloatValue / _esc_recon_dev).
__device__ __forceinline__ float esc_recon(float cur, float median,
                                          unsigned long long mask) {
  const float norm = __fsub_rn(cur, median);
  return __fadd_rn(__uint_as_float(__float_as_uint(norm) & (unsigned)mask),
                   median);
}
__device__ __forceinline__ double esc_recon(double cur, double median,
                                           unsigned long long mask) {
  const double norm = __dsub_rn(cur, median);
  return __dadd_rn(
      __longlong_as_double((long long)((unsigned long long)
                                           __double_as_longlong(norm) &
                                       mask)),
      median);
}

// The positional predictor of (i, j, k) from its neighbours (names in
// the note above), each case in the JAX engine's op order, chosen by
// selects (i is the warp's own).
template <class V>
__device__ __forceinline__ V predict(int i, int j, int k, V A, V A2, V B,
                                     V D, V C, V E, V F, V G) {
  const bool j0 = j == 0, k0 = k == 0;
  if (i == 0) {
    const V row = k == 1 ? A : sub_rn(mul_rn(V(2), A), A2);
    const V rest = k0 ? B : sub_rn(add_rn(A, B), D);
    return j0 ? (k0 ? V(0) : row) : rest;
  }
  V p = add_rn(A, B);
  p = add_rn(p, C);
  p = sub_rn(p, D);
  p = sub_rn(p, E);
  p = sub_rn(p, F);
  p = add_rn(p, G);
  const V row = k0 ? C : sub_rn(add_rn(A, C), F);
  const V col = k0 ? sub_rn(add_rn(B, C), E) : p;
  return j0 ? row : col;
}

// The scalars of a call: rp in RT (rp_t: its V rounding, used by the
// float form's reconstruction), rp64 = (double)rp, recip64 =
// (double)recip.
template <class V>
struct Quantizer {
  V rp_t;
  double rp64, recip64;
  int intervals, radius;
  V rp_dn;  // rp64 rounded down to V: |x| > rp64 iff |x| > rp_dn
};

// The reconstruction's increment 2(t - radius) * rp, which depends on t
// alone: in V with kDbl false, else in double.
template <bool kDbl, class V>
__device__ __forceinline__ auto step_of(int t, const Quantizer<V>& q) {
  const int m = 2 * (t - q.radius);
  if constexpr (kDbl)
    return __dmul_rn(__int2double_rn(m), q.rp64);
  else
    return mul_rn((V)m, q.rp_t);
}

// pred + the increment: in V, or in double and rounded once to V (the
// decode's `(pred + q).astype(T)`).
template <bool kDbl, class V, class Q>
__device__ __forceinline__ V recon(V pred, Q inc) {
  if constexpr (kDbl)
    return narrow(__dadd_rn((double)pred, inc), (V*)nullptr);
  else
    return add_rn(pred, inc);
}

// One predict-quantize step (compress_nd's quant): the type, 0 for an
// escape, and the reconstruction (valid where the type is not 0).
// itvNum is float in the float form (kDbl false), double otherwise.
// Shortened, not changed: h = trunc(+-itv / 2) stays a float (double),
// so (V)(2 (t - radius)) is h + h, exact for any t within the
// intervals; the recheck |(double)(cur - rec)| > rp64 on a float
// difference is |cur - rec| > rp_dn; t = (int)h + radius is off the
// chain.
// The subblock form (kSub, double only) divides by rp64 and keeps every
// point within the intervals: no recheck.
template <bool kDbl, bool kSub, class V>
__device__ __forceinline__ int quantize(V cur, V pred, const Quantizer<V>& q,
                                        V* rec) {
  static_assert(kDbl || !kSub, "the subblock form is a double form");
  const V diff = sub_rn(cur, pred);
  double m;
  if constexpr (kSub)
    m = __dadd_rn(__ddiv_rn(fabs((double)diff), q.rp64), 1.0);
  else
    m = __dadd_rn(__dmul_rn(fabs((double)diff), q.recip64), 1.0);
  bool within;
  int half;
  if constexpr (kDbl) {
    within = m < (double)q.intervals;
    const double h = trunc(__dmul_rn(diff < V(0) ? -m : m, 0.5));
    half = __double2int_rz(h);
    *rec = recon<kDbl>(pred, __dmul_rn(__dadd_rn(h, h), q.rp64));
  } else {
    const float itv = __double2float_rn(m);
    within = itv < (float)q.intervals;
    const float h = truncf(__fmul_rn(diff < 0.0f ? -itv : itv, 0.5f));
    half = __float2int_rz(h);
    *rec = recon<kDbl>(pred, mul_rn(__fadd_rn(h, h), q.rp_t));
  }
  if constexpr (kSub) return within ? half + q.radius : 0;
  const bool ok = within & !(fabs(sub_rn(cur, *rec)) > q.rp_dn);
  return ok ? half + q.radius : 0;
}

// The arguments of K10 (kDec false) and K11.
template <class V>
struct QuantArgs {
  const V* data;
  int* types;
  V* R;  // null: no reconstruction written
  Quantizer<V> q;
  V median;
  unsigned long long mask;
};

template <class V>
struct DecodeArgs {
  const int* types;
  const V* esc;               // the escapes' values in raster order
  long long n_esc;
  const long long* row_base;  // escapes before each row (raster)
  V* R;
  Quantizer<V> q;
};

// A staged slot as the type K10 writes over its consumed value.
template <class S>
__device__ __forceinline__ int* type_at(S* slot) {
  return reinterpret_cast<int*>(slot);
}

// The point rule of a form (strips.cuh): rank, value type, double
// arithmetic, decode.  S is the staged input (K10's data, K11's types),
// one array of the warp's staging region; K10 writes each type over its
// consumed value.  Column chunks, rings of 64 slots: a float block holds
// two an SM.  kSub: K10's subblock form.
template <int kRank_, class V_, bool kDbl, bool kDec, bool kSub = false>
struct Classic {
  using V = V_;
  using S = typename std::conditional<kDec, int, V>::type;
  using Args = typename std::conditional<kDec, DecodeArgs<V>,
                                         QuantArgs<V>>::type;
  static constexpr int kRank = kRank_;
  static constexpr int W = Warps<V>::n;
  static constexpr int kRing = 64;
  static constexpr bool kSlotChunks = false;
  static constexpr int kStageBytes = Ring<kRing>::kRingS * sizeof(S);
  static constexpr int kG = Group<kRank>::n;

  // the staged value or type, and (K10) the escape's reconstruction of
  // the value, taken off the chain
  struct In {
    S x;
    V er;
  };

  struct Lane {
    // K11: this lane's next escape (the rows' ranks from row_base)
    long long eidx = 0;
    V enext = V(0);
    V ev[kG];

    // A rank past the stream reads its last value, as _decode_fn clips;
    // an empty stream reads none.
    __device__ __forceinline__ V escape(const Args& a, long long rank) const {
      if constexpr (kDec)
        return a.n_esc > 0 ? __ldg(a.esc + min(rank, a.n_esc - 1)) : V(0);
      else
        return V(0);
    }

    __device__ __forceinline__ Lane(const Args& a, unsigned char*,
                                    long long row0, int lane, int rows,
                                    int) {
      if constexpr (kDec) {
        if (lane < rows) eidx = a.row_base[row0 + lane];
        enext = escape(a, eidx);
      }
    }

    __device__ __forceinline__ void stage_chunk(const Args& a,
                                                unsigned char* st,
                                                long long base, int c,
                                                int lane, int rows, int r3) {
      const S* src;
      if constexpr (kDec)
        src = a.types;
      else
        src = a.data;
      stage_copy<kRing, kSlotChunks>(src, reinterpret_cast<S*>(st), base, c,
                                     lane, rows, r3);
    }

    __device__ __forceinline__ In load(const Args& a, const unsigned char* st,
                                       int e, int) const {
      In x;
      x.x = reinterpret_cast<const S*>(st)[e];
      if constexpr (!kDec) x.er = esc_recon(x.x, a.median, a.mask);
      return x;
    }

    // K11's escapes in the group, a lane's consecutive in the compact
    // stream: the first is enext (loaded ahead), the rest are loaded
    // here; a group with none takes the path without
    template <class Run>
    __device__ __forceinline__ void group(const Args& a, const In* xin,
                                          int s, int lane, int rows, int r3,
                                          Run&& run) {
      if constexpr (kDec) {
        unsigned em = 0;
#pragma unroll
        for (int q = 0; q < kG; ++q) {
          const int k = s + q - lane;
          if (lane < rows && k >= 0 && k < r3 && xin[q].x == 0)
            em |= 1u << q;
        }
        if (__any_sync(kFull, em != 0)) {
#pragma unroll
          for (int q = 0; q < kG; ++q) {
            const int before = __popc(em & ((1u << q) - 1));
            ev[q] = V(0);
            if ((em >> q) & 1)
              ev[q] = before == 0 ? enext : escape(a, eidx + before);
          }
          run(std::true_type{});
          if (em) {
            eidx += __popc(em);
            enext = escape(a, eidx);
          }
        } else {
          run(std::false_type{});
        }
      } else {
        run(std::false_type{});
      }
    }

    // with the escape path, a type 0 takes its escape value from ev
    template <class Path>
    __device__ __forceinline__ V point(Path, const Args& a, int q,
                                       const In& x, int i, int j, int k, V A,
                                       V A2, V B, V D, V C, V E, V F, V G,
                                       int* t) const {
      const V pred = predict(i, j, k, A, A2, B, D, C, E, F, G);
      if constexpr (kDec) {
        V R = recon<kDbl>(pred, step_of<kDbl>(x.x, a.q));
        if constexpr (Path::value)
          if (x.x == 0) R = ev[q];
        return R;
      } else {
        V rec;
        int tq = quantize<kDbl, kSub>(x.x, pred, a.q, &rec);
        if ((i | j | k) == 0) tq = 0;
        *t = tq;
        return tq ? rec : x.er;
      }
    }

    __device__ __forceinline__ void keep(unsigned char* st, int e,
                                         const In&, int t) const {
      if constexpr (!kDec) *type_at(reinterpret_cast<S*>(st) + e) = t;
    }

    __device__ __forceinline__ void out(const Args& a,
                                        const unsigned char* st, int e,
                                        long long gi) const {
      if constexpr (!kDec)
        a.types[gi] = *type_at(
            const_cast<S*>(reinterpret_cast<const S*>(st)) + e);
    }
  };
};

// Each form and rank its own __global__ name (the profile tells them
// apart; chip_smoke.DEVICE_NAMES lists them).
__global__ void __launch_bounds__(Warps<float>::n * 32) classic_quantize2d_kernel(
    Geo<float> g, QuantArgs<float> a) {
  run_strips<Classic<2, float, false, false>>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_quantize3d_kernel(
    Geo<float> g, QuantArgs<float> a) {
  run_strips<Classic<3, float, false, false>>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_quantize4d_kernel(
    Geo<float> g, QuantArgs<float> a) {
  run_strips<Classic<3, float, true, false>>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_quantize2d_f64_kernel(
    Geo<double> g, QuantArgs<double> a) {
  run_strips<Classic<2, double, true, false>>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_quantize3d_f64_kernel(
    Geo<double> g, QuantArgs<double> a) {
  run_strips<Classic<3, double, true, false>>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_decode2d_kernel(
    Geo<float> g, DecodeArgs<float> a) {
  run_strips<Classic<2, float, false, true>>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_decode3d_kernel(
    Geo<float> g, DecodeArgs<float> a) {
  run_strips<Classic<3, float, false, true>>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_decode4d_kernel(
    Geo<float> g, DecodeArgs<float> a) {
  run_strips<Classic<3, float, true, true>>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_decode2d_f64_kernel(
    Geo<double> g, DecodeArgs<double> a) {
  run_strips<Classic<2, double, true, true>>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_decode3d_f64_kernel(
    Geo<double> g, DecodeArgs<double> a) {
  run_strips<Classic<3, double, true, true>>(g, a);
}

// K10's subblock form: float32 data of rank 2, or rank 3 (a 3-D field,
// or the volumes of a 4-D one), and float64 data.
__global__ void __launch_bounds__(Warps<float>::n * 32) classic_quantize2d_sub_kernel(
    Geo<float> g, QuantArgs<float> a) {
  run_strips<Classic<2, float, true, false, true>>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_quantize3d_sub_kernel(
    Geo<float> g, QuantArgs<float> a) {
  run_strips<Classic<3, float, true, false, true>>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_quantize2d_sub_f64_kernel(
    Geo<double> g, QuantArgs<double> a) {
  run_strips<Classic<2, double, true, false, true>>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_quantize3d_sub_f64_kernel(
    Geo<double> g, QuantArgs<double> a) {
  run_strips<Classic<3, double, true, false, true>>(g, a);
}

// rp64 rounded down to float: for a float x, |x| > rp64 iff |x| > it.
float down_to_float(double rp64) {
  float r = (float)rp64;
  if ((double)r > rp64) r = nextafterf(r, -INFINITY);
  return r;
}

unsigned long long mask_of(int ign, int width) {
  if (ign >= width) return 0ull;
  const unsigned long long full = width == 32 ? 0xFFFFFFFFull : ~0ull;
  return (~((1ull << ign) - 1ull)) & full;
}

template <class V, bool kDbl, bool kDec, bool kSub = false>
int launch_rank(void (*k2)(Geo<V>,
                           typename Classic<2, V, kDbl, kDec, kSub>::Args),
                void (*k3)(Geo<V>,
                           typename Classic<3, V, kDbl, kDec, kSub>::Args),
                const typename Classic<3, V, kDbl, kDec, kSub>::Args& a,
                int rank,
                int nvol, int r1, int r2, int r3, const int* order,
                int* flags, V* rows, V* planes, int nunits, void* stream) {
  Geo<V> g;
  const int rc = make_geo<Warps<V>::n>(&g, rank, nvol, r1, r2, r3, order,
                                       flags, rows, planes, nunits);
  if (rc) return rc;
  if (rank == 2)
    return launch<Classic<2, V, kDbl, kDec, kSub>>(k2, g, a,
                                                   (cudaStream_t)stream);
  return launch<Classic<3, V, kDbl, kDec, kSub>>(k3, g, a,
                                                 (cudaStream_t)stream);
}

}  // namespace

// Arguments common to the entry points: the lattice of one launch, nvol
// volumes of r1 x r2 x r3 (a 2-D field: rank 2, nvol = r1 = 1; a 3-D
// field: rank 3, nvol = 1; a 4-D field: rank 3, its q1 volumes); order:
// int32[nunits], the units in claim order (classic_kernel.strip_order);
// flags: int32[nunits * (W + 1) + 1], zero; rows, planes: scratch
// of the value type (classic_kernel.scratch sizes them).  Quantizer
// scalars: rp_t the precision in the data's type, rp64 and recip64 the
// precision and its reciprocal in RT, widened; ign = max(width -
// req_length, 0).

// K10, float32 data on ranks 2-3 (float form): data -> types i32 and,
// where R is not null, the reconstruction.
extern "C" int sz_classic_quantize(const float* data, int* types, float* R,
                                   int rank, int nvol, int r1, int r2,
                                   int r3, float rp_t, double rp64,
                                   double recip64, int intervals, int radius,
                                   float median, int ign, const int* order,
                                   int* flags, float* rows, float* planes,
                                   int nunits, void* stream) {
  QuantArgs<float> a{data, types, R,
                     Quantizer<float>{rp_t, rp64, recip64, intervals,
                                      radius, down_to_float(rp64)},
                     median, mask_of(ign, 32)};
  return launch_rank<float, false, false>(
      classic_quantize2d_kernel, classic_quantize3d_kernel, a, rank, nvol,
      r1, r2, r3, order, flags, rows, planes, nunits, stream);
}

// K10, the volumes of a float32 4-D field (double form).
extern "C" int sz_classic_quantize_4d(const float* data, int* types,
                                      float* R, int nvol, int r1, int r2,
                                      int r3, double rp64, double recip64,
                                      int intervals, int radius,
                                      float median, int ign,
                                      const int* order, int* flags,
                                      float* rows, float* planes,
                                      int nunits, void* stream) {
  QuantArgs<float> a{data, types, R,
                     Quantizer<float>{0.0f, rp64, recip64, intervals,
                                      radius, down_to_float(rp64)},
                     median, mask_of(ign, 32)};
  Geo<float> g;
  const int rc = make_geo<Warps<float>::n>(&g, 3, nvol, r1, r2, r3, order,
                                           flags, rows, planes, nunits);
  if (rc) return rc;
  return launch<Classic<3, float, true, false>>(classic_quantize4d_kernel, g,
                                                a, (cudaStream_t)stream);
}

// K10, float64 data (rank 2, rank 3, or the volumes of rank 4).
extern "C" int sz_classic_quantize_f64(const double* data, int* types,
                                       double* R, int rank, int nvol, int r1,
                                       int r2, int r3, double rp64,
                                       double recip64, int intervals,
                                       int radius, double median, int ign,
                                       const int* order, int* flags,
                                       double* rows, double* planes,
                                       int nunits, void* stream) {
  QuantArgs<double> a{data, types, R,
                      Quantizer<double>{rp64, rp64, recip64, intervals,
                                        radius, rp64},
                      median, mask_of(ign, 64)};
  return launch_rank<double, true, false>(
      classic_quantize2d_f64_kernel, classic_quantize3d_f64_kernel, a, rank,
      nvol, r1, r2, r3, order, flags, rows, planes, nunits, stream);
}

// K10's subblock form, float32 data (rank 2, rank 3, or the volumes of
// rank 4): the double form on rp64, dividing, with no recheck.
extern "C" int sz_classic_quantize_sub(const float* data, int* types,
                                       float* R, int rank, int nvol, int r1,
                                       int r2, int r3, double rp64,
                                       int intervals, int radius,
                                       float median, int ign,
                                       const int* order, int* flags,
                                       float* rows, float* planes,
                                       int nunits, void* stream) {
  QuantArgs<float> a{data, types, R,
                     Quantizer<float>{0.0f, rp64, 0.0, intervals, radius,
                                      0.0f},
                     median, mask_of(ign, 32)};
  return launch_rank<float, true, false, true>(
      classic_quantize2d_sub_kernel, classic_quantize3d_sub_kernel, a, rank,
      nvol, r1, r2, r3, order, flags, rows, planes, nunits, stream);
}

// K10's subblock form, float64 data.
extern "C" int sz_classic_quantize_sub_f64(const double* data, int* types,
                                           double* R, int rank, int nvol,
                                           int r1, int r2, int r3,
                                           double rp64, int intervals,
                                           int radius, double median,
                                           int ign, const int* order,
                                           int* flags, double* rows,
                                           double* planes, int nunits,
                                           void* stream) {
  QuantArgs<double> a{data, types, R,
                      Quantizer<double>{rp64, rp64, 0.0, intervals, radius,
                                        rp64},
                      median, mask_of(ign, 64)};
  return launch_rank<double, true, false, true>(
      classic_quantize2d_sub_f64_kernel, classic_quantize3d_sub_f64_kernel,
      a, rank, nvol, r1, r2, r3, order, flags, rows, planes, nunits, stream);
}

// K11, float32 data on ranks 2-3: types i32, the escapes' values in
// raster order (n_esc of them) and row_base (int64, one a row of r3: the
// escapes before it) -> out.
extern "C" int sz_classic_decode(const int* types, const float* esc,
                                 long long n_esc, const long long* row_base,
                                 float* out, int rank, int nvol, int r1,
                                 int r2, int r3, float rp_t, int radius,
                                 const int* order, int* flags, float* rows,
                                 float* planes, int nunits, void* stream) {
  DecodeArgs<float> a{types, esc, n_esc, row_base, out,
                      Quantizer<float>{rp_t, 0.0, 0.0, 0, radius, 0.0f}};
  return launch_rank<float, false, true>(
      classic_decode2d_kernel, classic_decode3d_kernel, a, rank, nvol, r1,
      r2, r3, order, flags, rows, planes, nunits, stream);
}

// K11, the volumes of a float32 4-D field.
extern "C" int sz_classic_decode_4d(const int* types, const float* esc,
                                    long long n_esc,
                                    const long long* row_base, float* out,
                                    int nvol, int r1, int r2, int r3,
                                    double rp64, int radius,
                                    const int* order, int* flags,
                                    float* rows, float* planes, int nunits,
                                    void* stream) {
  DecodeArgs<float> a{types, esc, n_esc, row_base, out,
                      Quantizer<float>{0.0f, rp64, 0.0, 0, radius, 0.0f}};
  Geo<float> g;
  const int rc = make_geo<Warps<float>::n>(&g, 3, nvol, r1, r2, r3, order,
                                           flags, rows, planes, nunits);
  if (rc) return rc;
  return launch<Classic<3, float, true, true>>(classic_decode4d_kernel, g, a,
                                               (cudaStream_t)stream);
}

// K11, float64 data.
extern "C" int sz_classic_decode_f64(const int* types, const double* esc,
                                     long long n_esc,
                                     const long long* row_base, double* out,
                                     int rank, int nvol, int r1, int r2,
                                     int r3, double rp64, int radius,
                                     const int* order, int* flags,
                                     double* rows, double* planes,
                                     int nunits, void* stream) {
  DecodeArgs<double> a{types, esc, n_esc, row_base, out,
                       Quantizer<double>{rp64, rp64, 0.0, 0, radius, rp64}};
  return launch_rank<double, true, true>(
      classic_decode2d_f64_kernel, classic_decode3d_f64_kernel, a, rank,
      nvol, r1, r2, r3, order, flags, rows, planes, nunits, stream);
}
