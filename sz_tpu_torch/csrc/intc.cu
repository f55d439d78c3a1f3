// K16 int_quantize / K17 int_decode: the integer codecs' positional
// Lorenzo recurrence on Hopper (sm_90a), encode and decode, on 2-D, 3-D
// and 4-D fields of int8, uint8, int16, uint16, int32, uint32, int64 and
// uint64.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence in host
// C over OpenMP blocks (sz_tpu/native/core.c intnd_encode2 :2247,
// intnd_decode :2354, intnd_encode_wf :4270, intnd_decode_wf :4404), the
// reference's SZ_compress_intXX_{2,3,4}D_MDQ (sz_int32.c and its twins)
// and their decoders.
//
// The predictor of point (i, j, k) depends on its position, as in the
// classic float codec (classic.cu, whose note names the neighbours A to
// G and A2): layer i = 0 (a 2-D field is this layer alone): (0,0)
// escapes, (0,1) takes A, the rest of row 0 2A - A2, column 0 B, the
// rest A + B - D; layers i >= 1: (0,0) takes C, row 0 A + C - F, column 0
// B + C - E, the rest the seven-term stencil.  A 4-D field is q1
// independent 3-D volumes, each restarting with an escape; its encoder
// codes cell (l, 0, 0, 1) with the volume's element 0 as the current
// value (the reference's stale curValue, which equals A there) and, where
// that escapes, reconstructs the field's first element (what the escape
// stores; the wrapper puts that value in the escape stream).
//
// Arithmetic (bit-exact with core.c, the reference): the encoder's ring
// holds its reconstructions wrapped to AN bits; the prediction is the
// stencil in int64 (wrapping), wrapped to AN; diff = cur - pred wrapped
// to DN; itv = (double)|diff| / rp + 1 (|INT64_MIN| stays negative, so
// it is "in range"); in range, t = (int)(+-itv / 2) + radius and the
// value (int64_t)trunc((double)pred + 2.0 * (t - radius) * rp) wrapped to
// AN; out of range, type 0 and the value itself.  The decoder's ring
// holds the output values; its prediction is the stencil in int64 and
// each value (int64_t)trunc((double)pred + (t - radius) * interval2)
// wrapped to the output type.  C's double-to-integer conversions are
// x86's: INT64_MIN (INT32_MIN for (int)) out of range and for NaN, which
// x86_d2ll / x86_d2i give where CUDA's intrinsics would saturate.  Every
// double operation is a round-to-nearest intrinsic and the build passes
// --fmad=false.
//
// Forms.  The encoder's ring and chain are 32 bits wide where that is
// exact, else 64:
// - r32 (a 32-bit ring, AN = DN = 32): int32 data, whose AN and DN are
//   32 (the stencil's adds commute with the wrap, so it runs in uint32);
//   and 8- and 16-bit data whose type's largest |value| M0 keeps
//   0 < rp and 8 M0 + 7 rp + 28 < 2^31 (the wrapper checks it from the
//   dtype and rp: rp up to about 2^28).
//   There every reconstruction lies within rp + 2 of a value of the data
//   (|diff| < 2^31: it does not wrap in DN bits), so |value| <= M0 + rp +
//   2 = M, |pred| <= 7 M and |cur - pred| <= M0 + 7 M < 2^31: AN = 64 and
//   DN = 64 give the same bits as 32.
// - small (AN 64, DN 32), u32 (AN 64, DN 64), i64 (AN 64, DN 64, 8-byte
//   staged slots): int64 rings, for the rest.
// The decoder's ring holds the output type: 32 bits for 8-, 16- and
// 32-bit outputs (its stencil still sums them in int64 where the double
// form needs the unwrapped prediction, uint32's zero-extended), int64
// for 64-bit ones.
//
// Arithmetic forms, picked per launch by the wrapper (an exact case
// split on rp, interval2 and the dtype; int_kernel.quantize_
// form / decode_form), each a path of the same kernel:
// - K16 integer (r32 only): rp an integer P with 1 <= P < 2^31 and
//   P * intervals < 2^51.  Then, with ad = |diff| <= 2^31 and X = ad / P:
//   fl(X) and fl(fl(X) + 1) stay within 2^-51 intervals < 1 / P of X and
//   X + 1 (both below intervals where it matters), and X + 1 lies on an
//   even integer or at least 1 / P from it, so in range <=> ad <
//   (intervals - 1) P and q = trunc(itv / 2) = (ad + P) div 2P; 2qP <
//   2^51 and |pred| < 2^31, so the double reconstruction is exact:
//   rec = wrap32(pred +- 2qP), in uint32.  The divide is a multiply-high
//   by magic = floor(2^64 / 2P) + 1, exact for every n = ad + P < 2^32
//   (n * 2P < 2^64).  thr = min((intervals - 1) P, 2^32 - 1).
// - K16 reciprocal (rp not an integer, 2^-1000 < rp < 2^1000, intervals
//   >= 2): z = fl(fl(ad * (fl(1/rp) / 2)) + 1/2) is itv / 2 within
//   2^-51.5 intervals (three roundings of relative 2^-53 in the quotient,
//   two in the sums); where z lies more than tol = 2^-49 intervals from
//   the range's end (intervals / 2) and, in range, from every integer,
//   the range test and trunc(z) are itv's.  A lane within it (or with a
//   negative |diff|, or NaN) takes the exact chain (__ddiv_rn): rare,
//   since for a non-integer rp = a / 2^k (a odd, k >= 1) X + 1 is never
//   an even integer.  The reconstruction is fl(pred + fl(+-trunc(z) *
//   2rp)), the reference's fl(fl(2 (t - radius)) rp) (2rp exact).
// - K16 exact: today's chain, for an integer rp that the integer form
//   does not take (every 2P-th |diff| sits on a boundary: the reciprocal
//   would send a lane in 2P of each step to the divide) and rp outside
//   the reciprocal's range.
// - K17 integer (32-bit rings): interval2 an integer I2 with |I2| <=
//   2^20: |t - radius| < 2^32 and |pred| < 2^35, so every double step is
//   exact and the value is wrap(pred + (t - radius) I2), in uint32 (the
//   wrap is modular).  Else K17's double form, today's chain.
//
// Design: warp strips on the machinery of strips.cuh (shared with
// K10/K11 and K1d/K2d), whose note has the walk, the rings, the
// hand-offs and the claim order; slot chunks, rings of 32 slots in 3-D
// (64 in 2-D, as K1d/K2d: a 2-D warp runs a strip behind the one above),
// 4 warps a block; a 3-D block of the 32-bit forms takes 38,696 shared
// bytes, of the int64 forms 60,476 (77,372 with 8-byte staged slots),
// and __launch_bounds__ asks the blocks an SM each kernel runs (kMin*,
// below).  K16 stages the data and writes each type over its consumed
// slot; K17 stages the types and reads the escapes compact, in raster
// order, from its row's first rank in row_base, as K11 does.  K16's
// integer form is a kernel of its own (r32i); its double forms, and
// K17's two forms, are a per-group branch on a launch constant
// (warp-uniform).
//
// Bound on this card: the chain of steps, r1 + r2 + r3 - 2 of them plus
// what the hand-offs add, each step the latency of one point's chain
// (the shuffle, the stencil's adds, the wraps, the quantizer) times the
// warps an SM cannot hide it with; bytes are far below it (K16 8 bytes
// an int32 point, K17 8 and the escapes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "strips.cuh"

namespace {

using namespace strips;

using i64 = long long;
using u64 = unsigned long long;

// Warps a block.
constexpr int kWarps = 4;

// The arithmetic forms (int_kernel.ARITH).
enum Arith { kExact = 0, kRecip = 1, kInteger = 2 };

// A group's path: escapes among its points (K17) and the arithmetic form.
template <bool kEsc, int kArith>
struct Path {
  static constexpr bool value = kEsc;
  static constexpr int arith = kArith;
};

// wrap_bits (core.c:2189), signed, to kBits = 32 or 64.
template <int kBits>
__device__ __forceinline__ i64 wrap_s(i64 v) {
  if constexpr (kBits >= 64)
    return v;
  else
    return (i64)(int)(unsigned)(u64)v;
}

template <int kBytes>
struct IntOf;
template <>
struct IntOf<1> {
  using S = signed char;
  using U = unsigned char;
};
template <>
struct IntOf<2> {
  using S = short;
  using U = unsigned short;
};
template <>
struct IntOf<4> {
  using S = int;
  using U = unsigned;
};

// An int64 as a ring value: its low 32 bits for an int ring.
template <class V>
__device__ __forceinline__ V narrow(i64 v) {
  if constexpr (sizeof(V) == 4)
    return (V)(int)(unsigned)(u64)v;
  else
    return v;
}

// A value wrapped to a kBytes-wide type, signed or not.
template <int kBytes>
__device__ __forceinline__ i64 wrap_to(i64 v, int sgn) {
  if constexpr (kBytes >= 8) {
    return v;
  } else {
    using T = IntOf<kBytes>;
    return sgn ? (i64)(typename T::S)v : (i64)(typename T::U)v;
  }
}

// (int64_t)trunc(v) and (int)v as x86 converts: the "integer indefinite"
// (the type's minimum) out of range and for NaN.
__device__ __forceinline__ i64 x86_d2ll(double v) {
  return (v >= -9223372036854775808.0 && v < 9223372036854775808.0)
             ? __double2ll_rz(v)
             : (i64)0x8000000000000000ull;
}

__device__ __forceinline__ int x86_d2i(double v) {
  return (v > -2147483649.0 && v < 2147483648.0) ? __double2int_rz(v)
                                                 : (int)0x80000000u;
}

// The positional predictor of (i, j, k), wrapping in V's width, by the
// classic codec's cases (classic.cu predict); i is the warp's own.  The
// terms off the chain (all but A and B) are summed apart.
template <class V>
__device__ __forceinline__ V ipredict(int i, int j, int k, V A, V A2, V B,
                                      V D, V C, V E, V F, V G) {
  using U = typename std::make_unsigned<V>::type;
  const U a = A, a2 = A2, b = B, d = D, c = C, e = E, f = F, g = G;
  const bool j0 = j == 0, k0 = k == 0;
  if (i == 0) {
    const U row = k == 1 ? a : a + a - a2;
    const U rest = k0 ? b : a + b - d;
    return (V)(j0 ? (k0 ? U(0) : row) : rest);
  }
  const U p = (a + b) + (c - d - e - f + g);
  const U row = k0 ? c : a + c - f;
  const U col = k0 ? b + c - e : p;
  return (V)(j0 ? row : col);
}

// Element i of an integer array of width esize, as the type reads it.
__device__ __forceinline__ i64 load_elem(const void* p, long long i,
                                         int esize, int sgn) {
  switch (esize) {
    case 1:
      return sgn ? (i64)((const signed char*)p)[i]
                 : (i64)((const unsigned char*)p)[i];
    case 2:
      return sgn ? (i64)((const short*)p)[i]
                 : (i64)((const unsigned short*)p)[i];
    case 4:
      return sgn ? (i64)((const int*)p)[i] : (i64)((const unsigned*)p)[i];
    default:
      return ((const i64*)p)[i];
  }
}

// The arguments of K16 and K17.
struct IntQuantArgs {
  const void* data;
  int* types;
  i64* R;  // never asked for (the header writes it where not null)
  double rp, intervals_d;
  // the reciprocal form: fl(1/rp) / 2, 2 rp, and z's bounds: in range
  // below lo_z, out above hi_z, tol_z from an integer (the note)
  double rcp_h, rp2, lo_z, hi_z, tol_z;
  u64 magic;          // the integer form: floor(2^64 / 2P) + 1
  unsigned P, P2, thr;  // P, 2P, min((intervals - 1) P, 2^32 - 1)
  int arith, intervals, radius, esize, sgn, quirk;
};

struct IntDecodeArgs {
  const int* types;
  const i64* esc;             // the escapes' values in raster order
  long long n_esc;
  const long long* row_base;  // escapes before each row (raster)
  i64* R;                     // an 8-byte output, else null
  void* out;                  // a narrower output, else null
  double interval2;
  int arith, i2, radius, sgn;  // i2: interval2 (the integer form)
};

// A staged slot as the int the rule writes over it.
template <class S>
__device__ __forceinline__ int* int_at(S* slot) {
  return reinterpret_cast<int*>(slot);
}

// One quantizer step (ienc_quant, core.c:2224) in the integer form (the
// r32 form only): false where it escapes, else the type in t and the
// wrapped value in rec.
__device__ __forceinline__ bool iquant_int(int cur, int pred,
                                           const IntQuantArgs& a, int* t,
                                           int* rec) {
  const unsigned diff = (unsigned)cur - (unsigned)pred;
  const bool neg = (int)diff < 0;
  const unsigned ad = neg ? 0u - diff : diff;
  const unsigned q = (unsigned)__umul64hi((u64)(ad + a.P), a.magic);
  const unsigned m = q * a.P2;
  *rec = (int)(neg ? (unsigned)pred - m : (unsigned)pred + m);
  *t = (int)(neg ? (unsigned)a.radius - q : (unsigned)a.radius + q);
  return ad < a.thr;
}

// One quantizer step in double, in the exact form or (kRecip) by the
// reciprocal with the exact chain on the lanes near a boundary.
template <int kArith, int kDN, class V>
__device__ __forceinline__ bool iquant_dbl(V cur, V pred,
                                           const IntQuantArgs& a, int* t,
                                           V* rec) {
  constexpr bool k32 = sizeof(V) == 4;
  const i64 diff =
      k32 ? (i64)(int)((unsigned)cur - (unsigned)pred)
          : wrap_s<kDN>((i64)((u64)(i64)cur - (u64)(i64)pred));
  const i64 ad = diff < 0 ? (i64)(0ull - (u64)diff) : diff;
  const double add =
      k32 ? __uint2double_rn((unsigned)ad) : __ll2double_rn(ad);
  const double pd =
      k32 ? __int2double_rn((int)pred) : __ll2double_rn((i64)pred);
  bool inr, exact = true;
  int tt = 0;
  double v = 0.0;
  if constexpr (kArith == kRecip) {
    const double z = __dadd_rn(__dmul_rn(add, a.rcp_h), 0.5);
    const double qd = trunc(z);
    const double sq = diff < 0 ? -qd : qd;
    inr = z < a.lo_z;
    tt = (int)((unsigned)__double2int_rz(sq) + (unsigned)a.radius);
    v = __dadd_rn(pd, __dmul_rn(sq, a.rp2));
    exact = !(z > a.hi_z ||
              (inr && __dsub_rn(z, qd) > a.tol_z &&
               __dsub_rn(__dadd_rn(qd, 1.0), z) > a.tol_z));
  }
  if (exact) {
    double itv = __dadd_rn(__ddiv_rn(add, a.rp), 1.0);
    inr = itv < a.intervals_d;
    if (diff < 0) itv = -itv;
    tt = x86_d2i(__dmul_rn(itv, 0.5)) + a.radius;
    v = __dadd_rn(
        pd, __dmul_rn(__dmul_rn(2.0, __int2double_rn(tt - a.radius)), a.rp));
  }
  *t = tt;
  *rec = narrow<V>(x86_d2ll(v));
  return inr;
}

// K16's point rule (strips.cuh): rank, ring value (int: the r32 form),
// staged slot, DN bits (AN is V's width) and the arithmetic: the integer
// form alone (kInt; a kernel of its own, whose 2-D walk ran 14 % faster
// without the double forms' code beside it) or the double forms.
template <int kRank_, class V_, class S_, int kDN, bool kInt = false>
struct IntQuant {
  using V = V_;
  using S = S_;
  using Args = IntQuantArgs;
  static constexpr bool k32 = sizeof(V) == 4;
  static_assert(!k32 || kDN == 32, "the r32 form is AN = DN = 32");
  static_assert(k32 || !kInt, "the integer form needs the r32 form");
  static constexpr int kRank = kRank_;
  static constexpr int W = kWarps;
  static constexpr int kRing = kRank == 3 ? 32 : 64;
  static constexpr bool kSlotChunks = true;
  static constexpr int kStageBytes = Ring<kRing>::kRingS * sizeof(S);

  struct In {
    V cur;
  };

  struct Lane {
    u64 rowaddr;  // the byte address of the lane's row
    V first;      // the field's first element (the 4-D quirk's escape)

    __device__ __forceinline__ Lane(const Args& a, unsigned char*,
                                    long long row0, int lane, int, int r3) {
      rowaddr = (u64)a.data + (u64)((row0 + lane) * r3) * (u64)a.esize;
      first = a.quirk ? (V)load_elem(a.data, 0, a.esize, a.sgn) : V(0);
    }

    // slot chunk c: each value's aligned slot-sized word by cp.async
    __device__ __forceinline__ void stage_chunk(const Args& a,
                                                unsigned char* st,
                                                long long base, int c,
                                                int lane, int rows, int r3) {
      using G = Ring<kRing>;
      S* X = reinterpret_cast<S*>(st);
      const int x = c * kChunk + (lane & 15);
      const char* src = static_cast<const char*>(a.data);
#pragma unroll 4
      for (int rr = 0; rr < (rows + 1) / 2; ++rr) {
        const int r = 2 * rr + (lane >> 4);
        const int col = x - r;
        if (r < rows && col >= 0 && col < r3) {
          const u64 at =
              (u64)(src + (base + (long long)r * r3 + col) * a.esize) &
              ~(u64)(sizeof(S) - 1);
          cp_async(X + r * G::kPitch + (x & G::kMask),
                   reinterpret_cast<const S*>(at));
        }
      }
    }

    // the value at column k, off the chain: its bytes in the staged word
    __device__ __forceinline__ In load(const Args& a, const unsigned char* st,
                                       int e, int k) const {
      In x;
      const S w = reinterpret_cast<const S*>(st)[e];
      if constexpr (sizeof(S) == 8) {
        x.cur = (V)w;
      } else {
        const unsigned off = (unsigned)((rowaddr + (u64)k * a.esize) & 3u);
        const unsigned u = (unsigned)w >> (8u * off);
        x.cur = (V)(a.esize == 4   ? (a.sgn ? (i64)(int)u : (i64)u)
                    : a.esize == 2 ? (a.sgn ? (i64)(short)u
                                            : (i64)(unsigned short)u)
                                   : (a.sgn ? (i64)(signed char)u
                                            : (i64)(unsigned char)u));
      }
      return x;
    }

    // the launch's arithmetic form, the same for every group
    template <class Run>
    __device__ __forceinline__ void group(const Args& a, const In*, int, int,
                                          int, int, Run&& run) {
      if constexpr (kInt)
        run(Path<false, kInteger>{});
      else if (a.arith == kRecip)
        run(Path<false, kRecip>{});
      else
        run(Path<false, kExact>{});
    }

    template <class P>
    __device__ __forceinline__ V point(P, const Args& a, int, const In& x,
                                       int i, int j, int k, V A, V A2, V B,
                                       V D, V C, V E, V F, V G,
                                       int* t) const {
      const V pred = ipredict<V>(i, j, k, A, A2, B, D, C, E, F, G);
      const bool quirk = a.quirk && (i | j) == 0 && k == 1;
      const V cur = quirk ? A : x.cur;
      V rec;
      int tq;
      bool inr;
      if constexpr (P::arith == kInteger)
        inr = iquant_int(cur, pred, a, &tq, &rec);
      else
        inr = iquant_dbl<P::arith, kDN>(cur, pred, a, &tq, &rec);
      if ((i | j | k) == 0 || !inr) {
        *t = 0;
        return quirk ? first : cur;
      }
      *t = tq;
      return rec;
    }

    __device__ __forceinline__ void keep(unsigned char* st, int e, const In&,
                                         int t) const {
      *int_at(reinterpret_cast<S*>(st) + e) = t;
    }

    __device__ __forceinline__ void out(const Args& a,
                                        const unsigned char* st, int e,
                                        long long gi) const {
      a.types[gi] =
          *int_at(const_cast<S*>(reinterpret_cast<const S*>(st)) + e);
    }
  };
};

// K17's point rule: rank and output width (the ring holds the output
// type: int for 8-, 16- and 32-bit outputs).
template <int kRank_, int kBytes>
struct IntDecode {
  using V = typename std::conditional<(kBytes < 8), int, i64>::type;
  using S = int;
  using Args = IntDecodeArgs;
  static constexpr bool k32 = kBytes < 8;
  static constexpr int kRank = kRank_;
  static constexpr int W = kWarps;
  static constexpr int kRing = kRank == 3 ? 32 : 64;
  static constexpr bool kSlotChunks = true;
  static constexpr int kStageBytes = Ring<kRing>::kRingS * sizeof(S);
  static constexpr int kG = Group<kRank>::n;

  struct In {
    int t;
  };

  struct Lane {
    // this lane's next escape (the rows' ranks from row_base)
    long long eidx = 0;
    V enext = 0;
    V ev[kG];

    // A rank past the stream reads its last value; an empty stream none.
    __device__ __forceinline__ V escape(const Args& a, long long rank) const {
      return a.n_esc > 0 ? (V)__ldg(a.esc + min(rank, a.n_esc - 1)) : V(0);
    }

    __device__ __forceinline__ Lane(const Args& a, unsigned char*,
                                    long long row0, int lane, int rows,
                                    int) {
      if (lane < rows) eidx = a.row_base[row0 + lane];
      enext = escape(a, eidx);
    }

    __device__ __forceinline__ void stage_chunk(const Args& a,
                                                unsigned char* st,
                                                long long base, int c,
                                                int lane, int rows, int r3) {
      stage_copy<kRing, kSlotChunks>(a.types, reinterpret_cast<int*>(st),
                                     base, c, lane, rows, r3);
    }

    __device__ __forceinline__ In load(const Args&, const unsigned char* st,
                                       int e, int) const {
      return In{reinterpret_cast<const int*>(st)[e]};
    }

    template <bool kEsc, class Run>
    __device__ __forceinline__ void run_arith(const Args& a, Run&& run) {
      if constexpr (k32) {
        if (a.arith == kInteger) {
          run(Path<kEsc, kInteger>{});
          return;
        }
      }
      run(Path<kEsc, kExact>{});
    }

    // the group's escapes, a lane's consecutive in the compact stream
    // (classic.cu's K11); a group with none takes the path without
    template <class Run>
    __device__ __forceinline__ void group(const Args& a, const In* xin,
                                          int s, int lane, int rows, int r3,
                                          Run&& run) {
      unsigned em = 0;
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const int k = s + q - lane;
        if (lane < rows && k >= 0 && k < r3 && xin[q].t == 0) em |= 1u << q;
      }
      if (__any_sync(kFull, em != 0)) {
#pragma unroll
        for (int q = 0; q < kG; ++q) {
          const int before = __popc(em & ((1u << q) - 1));
          ev[q] = 0;
          if ((em >> q) & 1)
            ev[q] = before == 0 ? enext : escape(a, eidx + before);
        }
        run_arith<true>(a, run);
        if (em) {
          eidx += __popc(em);
          enext = escape(a, eidx);
        }
      } else {
        run_arith<false>(a, run);
      }
    }

    // a ring value as the int64 the double form sums (uint32 unsigned)
    __device__ __forceinline__ static i64 ext(V x, int sgn) {
      if constexpr (kBytes == 4)
        return sgn ? (i64)x : (i64)(unsigned)x;
      else
        return (i64)x;
    }

    // the value, its low 32 bits in t (a narrow output's)
    template <class P>
    __device__ __forceinline__ V point(P, const Args& a, int q, const In& x,
                                       int i, int j, int k, V A, V A2, V B,
                                       V D, V C, V E, V F, V G,
                                       int* t) const {
      V R;
      if constexpr (P::arith == kInteger) {
        const unsigned pred =
            (unsigned)ipredict<V>(i, j, k, A, A2, B, D, C, E, F, G);
        const unsigned off =
            ((unsigned)x.t - (unsigned)a.radius) * (unsigned)a.i2;
        R = narrow<V>(wrap_to<kBytes>((i64)(int)(pred + off), a.sgn));
      } else {
        const int sg = a.sgn;
        const i64 pred =
            ipredict<i64>(i, j, k, ext(A, sg), ext(A2, sg), ext(B, sg),
                          ext(D, sg), ext(C, sg), ext(E, sg), ext(F, sg),
                          ext(G, sg));
        R = narrow<V>(wrap_to<kBytes>(
            x86_d2ll(__dadd_rn(__ll2double_rn(pred),
                               __dmul_rn(__int2double_rn(x.t - a.radius),
                                         a.interval2))),
            a.sgn));
      }
      if constexpr (P::value)
        if (x.t == 0) R = ev[q];
      *t = (int)R;
      return R;
    }

    __device__ __forceinline__ void keep(unsigned char* st, int e, const In&,
                                         int t) const {
      if constexpr (kBytes < 8) reinterpret_cast<int*>(st)[e] = t;
    }

    __device__ __forceinline__ void out(const Args& a,
                                        const unsigned char* st, int e,
                                        long long gi) const {
      if constexpr (kBytes < 8) {
        using T = typename IntOf<kBytes>::S;
        static_cast<T*>(a.out)[gi] =
            (T) reinterpret_cast<const int*>(st)[e];
      }
    }
  };
};

// The forms' rules and the blocks an SM each asks of the register
// allocator.  Shared memory allows at most: 32-bit rings 3-D 5, 2-D 3;
// int64 rings 3-D 3 (2 with 8-byte slots), 2-D 1.  The 3-D 32-bit forms
// ask 4 (128 registers): they spill 100 to 152 bytes a thread there, and
// still ran 8 % (K16) and 17 % (K17) faster than at 3 blocks and 168
// registers with no spill (PERF.md, PR 19); the int64 3-D forms ask 2
// (at 3, 168 registers, they spilled 108 to 132 bytes; not timed).
using Q2r32i = IntQuant<2, int, unsigned, 32, true>;
using Q3r32i = IntQuant<3, int, unsigned, 32, true>;
using Q2r32 = IntQuant<2, int, unsigned, 32>;
using Q3r32 = IntQuant<3, int, unsigned, 32>;
using Q2small = IntQuant<2, i64, unsigned, 32>;
using Q3small = IntQuant<3, i64, unsigned, 32>;
using Q2u32 = IntQuant<2, i64, unsigned, 64>;
using Q3u32 = IntQuant<3, i64, unsigned, 64>;
using Q2i64 = IntQuant<2, i64, i64, 64>;
using Q3i64 = IntQuant<3, i64, i64, 64>;

constexpr int kMin32_3 = 4, kMin32_2 = 3, kMin64_3 = 2, kMin64_3w = 2,
              kMin64_2 = 1;

// Each form and rank its own __global__ name (the profile tells them
// apart; chip_smoke.DEVICE_NAMES lists them).
__global__ void __launch_bounds__(kWarps * 32, kMin32_2)
    int_quantize2d_r32i_kernel(Geo<int> g, IntQuantArgs a) {
  run_strips<Q2r32i>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_3)
    int_quantize3d_r32i_kernel(Geo<int> g, IntQuantArgs a) {
  run_strips<Q3r32i>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_2)
    int_quantize2d_r32_kernel(Geo<int> g, IntQuantArgs a) {
  run_strips<Q2r32>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_3)
    int_quantize3d_r32_kernel(Geo<int> g, IntQuantArgs a) {
  run_strips<Q3r32>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin64_2)
    int_quantize2d_small_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<Q2small>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin64_3)
    int_quantize3d_small_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<Q3small>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin64_2)
    int_quantize2d_u32_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<Q2u32>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin64_3)
    int_quantize3d_u32_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<Q3u32>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin64_2)
    int_quantize2d_i64_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<Q2i64>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin64_3w)
    int_quantize3d_i64_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<Q3i64>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_2)
    int_decode2d_8_kernel(Geo<int> g, IntDecodeArgs a) {
  run_strips<IntDecode<2, 1>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_3)
    int_decode3d_8_kernel(Geo<int> g, IntDecodeArgs a) {
  run_strips<IntDecode<3, 1>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_2)
    int_decode2d_16_kernel(Geo<int> g, IntDecodeArgs a) {
  run_strips<IntDecode<2, 2>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_3)
    int_decode3d_16_kernel(Geo<int> g, IntDecodeArgs a) {
  run_strips<IntDecode<3, 2>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_2)
    int_decode2d_32_kernel(Geo<int> g, IntDecodeArgs a) {
  run_strips<IntDecode<2, 4>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin32_3)
    int_decode3d_32_kernel(Geo<int> g, IntDecodeArgs a) {
  run_strips<IntDecode<3, 4>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin64_2)
    int_decode2d_64_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<2, 8>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32, kMin64_3)
    int_decode3d_64_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<3, 8>>(g, a);
}

template <class R2, class R3>
int launch_rank(void (*k2)(Geo<typename R2::V>, typename R2::Args),
                void (*k3)(Geo<typename R3::V>, typename R3::Args),
                const typename R3::Args& a, int rank, int nvol, int r1,
                int r2, int r3, const int* order, int* flags, void* rows,
                void* planes, int nunits, void* stream) {
  using V = typename R3::V;
  static_assert(std::is_same<V, typename R2::V>::value, "one ring type");
  Geo<V> g;
  const int rc = make_geo<kWarps>(&g, rank, nvol, r1, r2, r3, order, flags,
                                  static_cast<V*>(rows),
                                  static_cast<V*>(planes), nunits);
  if (rc) return rc;
  if (rank == 2) return launch<R2>(k2, g, a, (cudaStream_t)stream);
  return launch<R3>(k3, g, a, (cudaStream_t)stream);
}

}  // namespace

// Arguments common to the entry points: the lattice of one launch, nvol
// volumes of r1 x r2 x r3 (a 2-D field: rank 2, nvol = r1 = 1; a 3-D
// field: rank 3, nvol = 1; a 4-D field: rank 3, its q1 volumes); order:
// int32[nunits], the units in claim order (strips.strip_order); flags:
// int32[nunits * (W + 1) + 1], zero; rows, planes: scratch of the ring's
// type, int32 for the 32-bit forms, else int64 (strips.scratch_sizes
// sizes them).  esize and sgn: the data's width in bytes and signedness.

// K16: data (esize-byte integers) -> types i32.  form: 0 r32, 1 small,
// 2 u32, 3 i64 (int_kernel.QUANT_FORMS); arith: 0 exact, 1 reciprocal,
// 2 integer, with their constants (the note; int_kernel.quantize_form
// makes them); quirk: the 4-D encoder's cell (l, 0, 0, 1).
extern "C" int sz_int_quantize(
    const void* data, int* types, int rank, int nvol, int r1, int r2, int r3,
    int esize, int sgn, int form, int arith, double rp, double rcp_h,
    double rp2, double lo_z, double hi_z, double tol_z,
    unsigned long long magic, unsigned P, unsigned thr, int intervals,
    int radius, int quirk, const int* order, int* flags, void* rows,
    void* planes, int nunits, void* stream) {
  const IntQuantArgs a{data,  types, nullptr, rp,     (double)intervals,
                       rcp_h, rp2,   lo_z,    hi_z,   tol_z,
                       magic, P,     2u * P,  thr,    arith,
                       intervals,    radius,  esize,  sgn,
                       quirk};
  const auto tail = [&](auto k2, auto k3, auto r2t, auto r3t) {
    using R2 = decltype(r2t);
    using R3 = decltype(r3t);
    return launch_rank<R2, R3>(k2, k3, a, rank, nvol, r1, r2, r3, order,
                               flags, rows, planes, nunits, stream);
  };
  if (arith < kExact || arith > kInteger || (arith == kInteger && form != 0))
    return (int)cudaErrorInvalidValue;
  if (form == 0 && esize <= 4 && arith == kInteger)
    return tail(int_quantize2d_r32i_kernel, int_quantize3d_r32i_kernel,
                Q2r32i{}, Q3r32i{});
  if (form == 0 && esize <= 4)
    return tail(int_quantize2d_r32_kernel, int_quantize3d_r32_kernel,
                Q2r32{}, Q3r32{});
  if (form == 1 && esize <= 2)
    return tail(int_quantize2d_small_kernel, int_quantize3d_small_kernel,
                Q2small{}, Q3small{});
  if (form == 2 && esize == 4)
    return tail(int_quantize2d_u32_kernel, int_quantize3d_u32_kernel,
                Q2u32{}, Q3u32{});
  if (form == 3 && esize == 8)
    return tail(int_quantize2d_i64_kernel, int_quantize3d_i64_kernel,
                Q2i64{}, Q3i64{});
  return (int)cudaErrorInvalidValue;
}

// K17: types i32, the escapes' values in raster order (int64, n_esc of
// them, values of the output type) and row_base (int64, one a row of r3:
// the escapes before it) -> out (esize-byte integers).  arith: 0 double,
// 2 integer (esize <= 4), whose i2 is interval2.
extern "C" int sz_int_decode(const int* types, const i64* esc,
                             long long n_esc, const long long* row_base,
                             void* out, int rank, int nvol, int r1, int r2,
                             int r3, int esize, int sgn, double interval2,
                             int arith, int i2, int radius, const int* order,
                             int* flags, void* rows, void* planes, int nunits,
                             void* stream) {
  const IntDecodeArgs a{types,
                        esc,
                        n_esc,
                        row_base,
                        esize == 8 ? static_cast<i64*>(out) : nullptr,
                        esize == 8 ? nullptr : out,
                        interval2,
                        arith,
                        i2,
                        radius,
                        sgn};
  const auto tail = [&](auto k2, auto k3, auto r2t, auto r3t) {
    using R2 = decltype(r2t);
    using R3 = decltype(r3t);
    return launch_rank<R2, R3>(k2, k3, a, rank, nvol, r1, r2, r3, order,
                               flags, rows, planes, nunits, stream);
  };
  if (!(arith == kExact || (arith == kInteger && esize <= 4)))
    return (int)cudaErrorInvalidValue;
  switch (esize) {
    case 1:
      return tail(int_decode2d_8_kernel, int_decode3d_8_kernel,
                  IntDecode<2, 1>{}, IntDecode<3, 1>{});
    case 2:
      return tail(int_decode2d_16_kernel, int_decode3d_16_kernel,
                  IntDecode<2, 2>{}, IntDecode<3, 2>{});
    case 4:
      return tail(int_decode2d_32_kernel, int_decode3d_32_kernel,
                  IntDecode<2, 4>{}, IntDecode<3, 4>{});
    case 8:
      return tail(int_decode2d_64_kernel, int_decode3d_64_kernel,
                  IntDecode<2, 8>{}, IntDecode<3, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

// The resident blocks an SM (the runtime's occupancy, at the launch's
// shared bytes), registers a thread and local bytes a thread of kernel
// `which`, in int_kernel.kernels()'s order, into out[0..2].
extern "C" int sz_int_kernel_info(int which, int* out) {
  struct Entry {
    const void* k;
    size_t bytes;
  };
  const Entry table[] = {
      {(const void*)(int_quantize2d_r32i_kernel),
       strips::shared_bytes<Q2r32i>()},
      {(const void*)(int_quantize3d_r32i_kernel),
       strips::shared_bytes<Q3r32i>()},
      {(const void*)(int_quantize2d_r32_kernel),
       strips::shared_bytes<Q2r32>()},
      {(const void*)(int_quantize3d_r32_kernel),
       strips::shared_bytes<Q3r32>()},
      {(const void*)(int_quantize2d_small_kernel),
       strips::shared_bytes<Q2small>()},
      {(const void*)(int_quantize3d_small_kernel),
       strips::shared_bytes<Q3small>()},
      {(const void*)(int_quantize2d_u32_kernel),
       strips::shared_bytes<Q2u32>()},
      {(const void*)(int_quantize3d_u32_kernel),
       strips::shared_bytes<Q3u32>()},
      {(const void*)(int_quantize2d_i64_kernel),
       strips::shared_bytes<Q2i64>()},
      {(const void*)(int_quantize3d_i64_kernel),
       strips::shared_bytes<Q3i64>()},
      {(const void*)(int_decode2d_8_kernel),
       strips::shared_bytes<IntDecode<2, 1>>()},
      {(const void*)(int_decode3d_8_kernel),
       strips::shared_bytes<IntDecode<3, 1>>()},
      {(const void*)(int_decode2d_16_kernel),
       strips::shared_bytes<IntDecode<2, 2>>()},
      {(const void*)(int_decode3d_16_kernel),
       strips::shared_bytes<IntDecode<3, 2>>()},
      {(const void*)(int_decode2d_32_kernel),
       strips::shared_bytes<IntDecode<2, 4>>()},
      {(const void*)(int_decode3d_32_kernel),
       strips::shared_bytes<IntDecode<3, 4>>()},
      {(const void*)(int_decode2d_64_kernel),
       strips::shared_bytes<IntDecode<2, 8>>()},
      {(const void*)(int_decode3d_64_kernel),
       strips::shared_bytes<IntDecode<3, 8>>()},
  };
  if (which < 0 || which >= (int)(sizeof(table) / sizeof(table[0])))
    return (int)cudaErrorInvalidValue;
  const Entry& e = table[which];
  cudaError_t rc = cudaFuncSetAttribute(
      e.k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)e.bytes);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, e.k, kWarps * 32,
                                                     e.bytes);
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes fa;
  if ((rc = cudaFuncGetAttributes(&fa, e.k)) != cudaSuccess) return (int)rc;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return 0;
}
