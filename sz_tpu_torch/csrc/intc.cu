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
// Arithmetic (bit-exact with core.c): the encoder's ring holds its
// reconstructions wrapped to AN bits; the prediction is the stencil in
// int64 (wrapping), wrapped to AN; diff = cur - pred wrapped to DN;
// itv = (double)|diff| / rp + 1 (|INT64_MIN| stays negative, so it is
// "in range"); in range, t = (int)(+-itv / 2) + radius and the value
// (int64_t)trunc((double)pred + 2.0 * (t - radius) * rp) wrapped to AN;
// out of range, type 0 and the value itself.  The decoder's ring holds
// the output values; its prediction is the stencil in int64 and each
// value (int64_t)trunc((double)pred + (t - radius) * interval2) wrapped
// to the output type.  C's double-to-integer conversions are x86's:
// INT64_MIN (INT32_MIN for (int)) out of range and for NaN, which
// x86_d2ll / x86_d2i give where CUDA's intrinsics would saturate.
// Every double operation is a round-to-nearest intrinsic and the build
// passes --fmad=false.
//
// Forms: the encoder is templated on its staged slot (4 bytes: the
// aligned word that holds an 8-, 16- or 32-bit value, its byte offset
// taken from the value's address at the load; 8 bytes: an int64 or
// uint64 value) and on AN and DN (32 or 64 bits), which lie on the chain:
// the 8- and 16-bit types (AN 64, DN 32), int32 (32, 32), uint32 (64,
// 64), int64 and uint64 (64, 64).  The input's width and signedness act
// only at the load, off the chain, and are arguments.  The decoder is
// templated on the output width (its wrap lies on the chain), with the
// signedness an argument: an 8-byte output is the ring's value (written
// by the strip header as R), a narrower one goes out through the staging
// slot of its consumed type.
//
// Design: warp strips on the machinery of strips.cuh (shared with
// K10/K11 and K1d/K2d), whose note has the walk, the rings, the
// hand-offs and the claim order; column chunks, rings of 64 int64 slots,
// 4 warps a block.  K16 stages the data and writes each type over its
// consumed slot; K17 stages the types and reads the escapes compact, in
// raster order, from its row's first rank in row_base, as K11 does.
//
// Bound on this card: the chain of steps, r1 + r2 + r3 - 2 of them plus
// what the hand-offs add, each step the latency of one point's chain (the
// shuffle, the stencil's 64-bit adds, the wraps, and the encoder's double
// divide, conversions and multiply-adds); bytes are far below it (K16 8
// bytes an int32 point, K17 8 and the escapes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "strips.cuh"

namespace {

using namespace strips;

using i64 = long long;
using u64 = unsigned long long;

// Warps a block; the int64 rings take (33 + 32) x 65 entries a warp.
constexpr int kWarps = 4;

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

// The positional predictor of (i, j, k) in int64 (wrapping), by the
// classic codec's cases (classic.cu predict); i is the warp's own.
__device__ __forceinline__ i64 ipredict(int i, int j, int k, i64 A, i64 A2,
                                        i64 B, i64 D, i64 C, i64 E, i64 F,
                                        i64 G) {
  const u64 a = A, a2 = A2, b = B, d = D, c = C, e = E, f = F, g = G;
  const bool j0 = j == 0, k0 = k == 0;
  if (i == 0) {
    const u64 row = k == 1 ? a : 2ull * a - a2;
    const u64 rest = k0 ? b : a + b - d;
    return (i64)(j0 ? (k0 ? 0ull : row) : rest);
  }
  const u64 p = a + b + c - d - e - f + g;
  const u64 row = k0 ? c : a + c - f;
  const u64 col = k0 ? b + c - e : p;
  return (i64)(j0 ? row : col);
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
  int intervals, radius, esize, sgn, quirk;
};

struct IntDecodeArgs {
  const int* types;
  const i64* esc;             // the escapes' values in raster order
  long long n_esc;
  const long long* row_base;  // escapes before each row (raster)
  i64* R;                     // an 8-byte output, else null
  void* out;                  // a narrower output, else null
  double interval2;
  int radius, sgn;
};

// A staged slot as the int the rule writes over it.
template <class S>
__device__ __forceinline__ int* int_at(S* slot) {
  return reinterpret_cast<int*>(slot);
}

// One quantizer step (ienc_quant, core.c:2224): false where it escapes,
// else the type in t and the AN-wrapped value in rec.
template <int kAN, int kDN>
__device__ __forceinline__ bool iquant(i64 cur, i64 pred,
                                       const IntQuantArgs& a, int* t,
                                       i64* rec) {
  const i64 diff = wrap_s<kDN>((i64)((u64)cur - (u64)pred));
  const i64 ad = diff < 0 ? (i64)(0ull - (u64)diff) : diff;
  double itv = __dadd_rn(__ddiv_rn(__ll2double_rn(ad), a.rp), 1.0);
  if (!(itv < a.intervals_d)) return false;
  if (diff < 0) itv = -itv;
  const int tt = x86_d2i(__dmul_rn(itv, 0.5)) + a.radius;
  const double v = __dadd_rn(
      __ll2double_rn(pred),
      __dmul_rn(__dmul_rn(2.0, __int2double_rn(tt - a.radius)), a.rp));
  *t = tt;
  *rec = wrap_s<kAN>(x86_d2ll(v));
  return true;
}

// K16's point rule (strips.cuh): rank, staged slot, AN and DN bits.
template <int kRank_, class S_, int kAN, int kDN>
struct IntQuant {
  using V = i64;
  using S = S_;
  using Args = IntQuantArgs;
  static constexpr int kRank = kRank_;
  static constexpr int W = kWarps;
  static constexpr int kRing = 64;
  static constexpr bool kSlotChunks = false;
  static constexpr int kStageBytes = Ring<kRing>::kRingS * sizeof(S);

  struct In {
    i64 cur;
  };

  struct Lane {
    u64 rowaddr;  // the byte address of the lane's row
    i64 first;    // the field's first element (the 4-D quirk's escape)

    __device__ __forceinline__ Lane(const Args& a, unsigned char*,
                                    long long row0, int lane, int, int r3) {
      rowaddr = (u64)a.data + (u64)((row0 + lane) * r3) * (u64)a.esize;
      first = a.quirk ? load_elem(a.data, 0, a.esize, a.sgn) : 0;
    }

    // column chunk c: each value's aligned slot-sized word by cp.async
    __device__ __forceinline__ void stage_chunk(const Args& a,
                                                unsigned char* st,
                                                long long base, int c,
                                                int lane, int rows, int r3) {
      using G = Ring<kRing>;
      S* X = reinterpret_cast<S*>(st);
      const int col = c * kChunk + (lane & 15);
      const char* src = static_cast<const char*>(a.data);
#pragma unroll 4
      for (int rr = 0; rr < (rows + 1) / 2; ++rr) {
        const int r = 2 * rr + (lane >> 4);
        if (r < rows && col < r3) {
          const u64 at =
              (u64)(src + (base + (long long)r * r3 + col) * a.esize) &
              ~(u64)(sizeof(S) - 1);
          cp_async(X + r * G::kPitch + ((col + r) & G::kMask),
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
        x.cur = (i64)w;
      } else {
        const unsigned off = (unsigned)((rowaddr + (u64)k * a.esize) & 3u);
        const unsigned u = (unsigned)w >> (8u * off);
        x.cur = a.esize == 4   ? (a.sgn ? (i64)(int)u : (i64)u)
                : a.esize == 2 ? (a.sgn ? (i64)(short)u
                                        : (i64)(unsigned short)u)
                               : (a.sgn ? (i64)(signed char)u
                                        : (i64)(unsigned char)u);
      }
      return x;
    }

    template <class Run>
    __device__ __forceinline__ void group(const Args&, const In*, int, int,
                                          int, int, Run&& run) {
      run(std::false_type{});
    }

    template <class Path>
    __device__ __forceinline__ V point(Path, const Args& a, int, const In& x,
                                       int i, int j, int k, V A, V A2, V B,
                                       V D, V C, V E, V F, V G,
                                       int* t) const {
      const i64 pred = wrap_s<kAN>(ipredict(i, j, k, A, A2, B, D, C, E, F, G));
      const bool quirk = a.quirk && (i | j) == 0 && k == 1;
      const i64 cur = quirk ? A : x.cur;
      i64 rec;
      int tq;
      if ((i | j | k) == 0 || !iquant<kAN, kDN>(cur, pred, a, &tq, &rec)) {
        *t = 0;
        return wrap_s<kAN>(quirk ? first : cur);
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

// K17's point rule: rank and output width.
template <int kRank_, int kBytes>
struct IntDecode {
  using V = i64;
  using S = int;
  using Args = IntDecodeArgs;
  static constexpr int kRank = kRank_;
  static constexpr int W = kWarps;
  static constexpr int kRing = 64;
  static constexpr bool kSlotChunks = false;
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
      return a.n_esc > 0 ? __ldg(a.esc + min(rank, a.n_esc - 1)) : 0;
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
        run(std::true_type{});
        if (em) {
          eidx += __popc(em);
          enext = escape(a, eidx);
        }
      } else {
        run(std::false_type{});
      }
    }

    // the value, its low 32 bits in t (a narrow output's)
    template <class Path>
    __device__ __forceinline__ V point(Path, const Args& a, int q,
                                       const In& x, int i, int j, int k, V A,
                                       V A2, V B, V D, V C, V E, V F, V G,
                                       int* t) const {
      const i64 pred = ipredict(i, j, k, A, A2, B, D, C, E, F, G);
      V R = wrap_to<kBytes>(
          x86_d2ll(__dadd_rn(__ll2double_rn(pred),
                             __dmul_rn(__int2double_rn(x.t - a.radius),
                                       a.interval2))),
          a.sgn);
      if constexpr (Path::value)
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

// Each form and rank its own __global__ name (the profile tells them
// apart; chip_smoke.DEVICE_NAMES lists them).
__global__ void __launch_bounds__(kWarps * 32)
    int_quantize2d_small_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<IntQuant<2, unsigned, 64, 32>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_quantize3d_small_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<IntQuant<3, unsigned, 64, 32>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_quantize2d_i32_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<IntQuant<2, unsigned, 32, 32>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_quantize3d_i32_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<IntQuant<3, unsigned, 32, 32>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_quantize2d_u32_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<IntQuant<2, unsigned, 64, 64>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_quantize3d_u32_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<IntQuant<3, unsigned, 64, 64>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_quantize2d_i64_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<IntQuant<2, i64, 64, 64>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_quantize3d_i64_kernel(Geo<i64> g, IntQuantArgs a) {
  run_strips<IntQuant<3, i64, 64, 64>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_decode2d_8_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<2, 1>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_decode3d_8_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<3, 1>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_decode2d_16_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<2, 2>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_decode3d_16_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<3, 2>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_decode2d_32_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<2, 4>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_decode3d_32_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<3, 4>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_decode2d_64_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<2, 8>>(g, a);
}

__global__ void __launch_bounds__(kWarps * 32)
    int_decode3d_64_kernel(Geo<i64> g, IntDecodeArgs a) {
  run_strips<IntDecode<3, 8>>(g, a);
}

template <class R2, class R3>
int launch_rank(void (*k2)(Geo<i64>, typename R2::Args),
                void (*k3)(Geo<i64>, typename R3::Args),
                const typename R3::Args& a, int rank, int nvol, int r1,
                int r2, int r3, const int* order, int* flags, i64* rows,
                i64* planes, int nunits, void* stream) {
  Geo<i64> g;
  const int rc = make_geo<kWarps>(&g, rank, nvol, r1, r2, r3, order, flags,
                                  rows, planes, nunits);
  if (rc) return rc;
  if (rank == 2) return launch<R2>(k2, g, a, (cudaStream_t)stream);
  return launch<R3>(k3, g, a, (cudaStream_t)stream);
}

}  // namespace

// Arguments common to the entry points: the lattice of one launch, nvol
// volumes of r1 x r2 x r3 (a 2-D field: rank 2, nvol = r1 = 1; a 3-D
// field: rank 3, nvol = 1; a 4-D field: rank 3, its q1 volumes); order:
// int32[nunits], the units in claim order (strips.strip_order); flags:
// int32[nunits * (W + 1) + 1], zero; rows, planes: int64 scratch
// (strips.scratch_sizes sizes them).  esize and sgn: the data's width in
// bytes and signedness.

// K16: data (esize-byte integers) -> types i32.  an, dn: the prediction's
// and the difference's bits (32 or 64); quirk: the 4-D encoder's cell
// (l, 0, 0, 1).
extern "C" int sz_int_quantize(const void* data, int* types, int rank,
                               int nvol, int r1, int r2, int r3, int esize,
                               int sgn, int an, int dn, double rp,
                               int intervals, int radius, int quirk,
                               const int* order, int* flags, i64* rows,
                               i64* planes, int nunits, void* stream) {
  const IntQuantArgs a{data,   types, nullptr, rp,  (double)intervals,
                       intervals, radius, esize, sgn, quirk};
  const auto tail = [&](auto k2, auto k3, auto r2t, auto r3t) {
    using R2 = decltype(r2t);
    using R3 = decltype(r3t);
    return launch_rank<R2, R3>(k2, k3, a, rank, nvol, r1, r2, r3, order,
                               flags, rows, planes, nunits, stream);
  };
  if (esize == 8 && an == 64 && dn == 64)
    return tail(int_quantize2d_i64_kernel, int_quantize3d_i64_kernel,
                IntQuant<2, i64, 64, 64>{}, IntQuant<3, i64, 64, 64>{});
  if (esize == 4 && an == 32 && dn == 32)
    return tail(int_quantize2d_i32_kernel, int_quantize3d_i32_kernel,
                IntQuant<2, unsigned, 32, 32>{},
                IntQuant<3, unsigned, 32, 32>{});
  if (esize == 4 && an == 64 && dn == 64)
    return tail(int_quantize2d_u32_kernel, int_quantize3d_u32_kernel,
                IntQuant<2, unsigned, 64, 64>{},
                IntQuant<3, unsigned, 64, 64>{});
  if (esize <= 2 && an == 64 && dn == 32)
    return tail(int_quantize2d_small_kernel, int_quantize3d_small_kernel,
                IntQuant<2, unsigned, 64, 32>{},
                IntQuant<3, unsigned, 64, 32>{});
  return (int)cudaErrorInvalidValue;
}

// K17: types i32, the escapes' values in raster order (int64, n_esc of
// them, values of the output type) and row_base (int64, one a row of r3:
// the escapes before it) -> out (esize-byte integers).
extern "C" int sz_int_decode(const int* types, const i64* esc,
                             long long n_esc, const long long* row_base,
                             void* out, int rank, int nvol, int r1, int r2,
                             int r3, int esize, int sgn, double interval2,
                             int radius, const int* order, int* flags,
                             i64* rows, i64* planes, int nunits,
                             void* stream) {
  const IntDecodeArgs a{types,
                        esc,
                        n_esc,
                        row_base,
                        esize == 8 ? static_cast<i64*>(out) : nullptr,
                        esize == 8 ? nullptr : out,
                        interval2,
                        radius,
                        sgn};
  const auto tail = [&](auto k2, auto k3, auto r2t, auto r3t) {
    using R2 = decltype(r2t);
    using R3 = decltype(r3t);
    return launch_rank<R2, R3>(k2, k3, a, rank, nvol, r1, r2, r3, order,
                               flags, rows, planes, nunits, stream);
  };
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
