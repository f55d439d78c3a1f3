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
// restarting with an escape and the layer-0 scheme: one launch a volume
// on offset pointers, so that each volume's first row is its lattice's.
//
// Three numeric forms (core/classic_nd.Form): float32 data on ranks 2-3
// quantizes in float (rp, recip float; itvNum = (float)(fabs(diff) *
// (double)recip + 1.0)); float32 data on rank 4 declares double itvNum
// and keeps rp double, and reconstructs (float)((double)pred + q *
// (double)rp); float64 data is double throughout.  In every form t =
// (int)(itv / 2) + radius, the reconstruction takes two roundings, and
// the epsilon recheck |cur - rec| > rp is done in double.  An escape's
// reconstruction is its value less the median with the low
// width - req_length bits cleared, plus the median, computed in the
// point rule from the staged value.
//
// Design: one persistent launch a call (a volume, in 4-D) on the tile
// machinery of tiles.cuh (shared with K1/K2 and K8/K9), whose note has
// the claim order, the hand-off and the bound.  Row 0's 2A - A2 reads
// the k-2 neighbour on the lattice's first row, so the tiles carry a
// k-halo two deep; the JAX engine pins that row with a serial scan
// because the linear predictor amplifies a fixpoint's perturbations,
// while a wavefront computes each point once, from final neighbours, and
// needs no pin.  The tiles are K1/K2's (ClassicTile; classic_kernel.TILE*
// mirror them).
//
// Bound on this card: the dependency chain (tile-diagonals x point
// steps; at 512^3 the tiles' busy time over the resident blocks), as for
// K1/K2 and K8/K9, not bytes (K10 moves 12 bytes a float point, K11 12)
// or arithmetic (a step is at most seven adds, the quantizer's double
// multiply-add and a division by 2).
//
// Bit-exactness: every float op that reaches the stream is an explicit
// round-to-nearest intrinsic in the JAX engine's op order; the build
// passes --fmad=false as well.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using namespace tiles;

// The tile of a lattice of rank kRank (3: a 3-D field or a 4-D volume;
// 2: r1 = 1) and element type V: K1/K2's LorenzoTile, for the same
// shared-memory reasons (a double 2-D tile is shorter on k).
template <int kRank, class V>
struct ClassicTile {
  static constexpr bool kWide = sizeof(V) == 8;
  static constexpr int bi = kRank == 3 ? 8 : 1;
  static constexpr int bj = kRank == 3 ? 16 : 64;
  static constexpr int bk = kRank == 3 ? 32 : kWide ? 64 : 96;
};

template <int kRank, class V>
using GeoOf = Geo<TileShape<ClassicTile<kRank, V>, 2>>;

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

// The positional predictor of lattice point (i, j, k) at shared index
// c, from its final neighbours (names in the note above).
template <class G, class V>
__device__ __forceinline__ V predict(const V* Rs, int c, int i, int j,
                                     int k) {
  constexpr int P = G::P, Q = G::Q;
  if (i == 0) {
    if (j == 0) {
      if (k == 0) return V(0);
      if (k == 1) return Rs[c - 1];
      return sub_rn(mul_rn(V(2), Rs[c - 1]), Rs[c - 2]);
    }
    if (k == 0) return Rs[c - P];
    return sub_rn(add_rn(Rs[c - 1], Rs[c - P]), Rs[c - P - 1]);
  }
  if (j == 0) {
    if (k == 0) return Rs[c - Q];
    return sub_rn(add_rn(Rs[c - 1], Rs[c - Q]), Rs[c - Q - 1]);
  }
  if (k == 0) return sub_rn(add_rn(Rs[c - P], Rs[c - Q]), Rs[c - Q - P]);
  V p = add_rn(Rs[c - 1], Rs[c - P]);
  p = add_rn(p, Rs[c - Q]);
  p = sub_rn(p, Rs[c - P - 1]);
  p = sub_rn(p, Rs[c - Q - P]);
  p = sub_rn(p, Rs[c - Q - 1]);
  return add_rn(p, Rs[c - Q - P - 1]);
}

// The scalars of a call: rp in RT (rp_t: its V rounding, used by the
// float form's reconstruction), rp64 = (double)rp, recip64 =
// (double)recip.
template <class V>
struct Quantizer {
  V rp_t;
  double rp64, recip64;
  int intervals, radius;
};

// pred + 2(t - radius) * rp: in V with kDbl false, else in double and
// rounded once to V (the decode's `(pred + q).astype(T)`).
template <bool kDbl, class V>
__device__ __forceinline__ V recon(V pred, int t, const Quantizer<V>& q) {
  const int m = 2 * (t - q.radius);
  if constexpr (kDbl)
    return narrow(__dadd_rn((double)pred,
                            __dmul_rn(__int2double_rn(m), q.rp64)),
                  (V*)nullptr);
  else
    return add_rn(pred, mul_rn((V)m, q.rp_t));
}

// One predict-quantize step (compress_nd's quant): the type, 0 for an
// escape, and with a type the reconstruction.  itvNum is float in the
// float form (kDbl false), double otherwise.
template <bool kDbl, class V>
__device__ __forceinline__ int quantize(V cur, V pred, const Quantizer<V>& q,
                                        V* rec) {
  const V diff = sub_rn(cur, pred);
  const double m = __dadd_rn(__dmul_rn(fabs((double)diff), q.recip64), 1.0);
  bool within;
  int half;
  if constexpr (kDbl) {
    within = m < (double)q.intervals;
    half = __double2int_rz(__ddiv_rn(diff < V(0) ? -m : m, 2.0));
  } else {
    const float itv = __double2float_rn(m);
    within = itv < (float)q.intervals;
    half = __float2int_rz(__fdiv_rn(diff < 0.0f ? -itv : itv, 2.0f));
  }
  if (!within) return 0;
  const int t = half + q.radius;
  *rec = recon<kDbl>(pred, t, q);
  return fabs((double)sub_rn(cur, *rec)) > q.rp64 ? 0 : t;
}

// The point rules (tiles.cuh): in shared memory R with its halo, X (the
// encode's data, the decode's stored escapes) and T (the types).
template <class V, bool kDbl>
struct QuantArgs {
  static constexpr int kArrays = 3;
  static constexpr int kFlagBytes = 0;
  static constexpr bool kTypesOut = true;
  const V* data;
  int* t_out;
  V* R;
  Quantizer<V> q;
  V median;
  unsigned long long mask;
};

template <class V, bool kDbl>
struct DecodeArgs {
  static constexpr int kArrays = 3;
  static constexpr int kFlagBytes = 0;
  static constexpr bool kTypesOut = false;
  const int* types;
  const V* known;
  V* R;
  Quantizer<V> q;
};

template <class G, class V, bool kDbl>
__device__ __forceinline__ void stage(const G& g, const Tile& t,
                                      const QuantArgs<V, kDbl>& a, V* X,
                                      int*, unsigned char*) {
  BoxWalk w(t.ni, t.nj, t.nk);
  while (w.ok()) {
    V x[kStageBatch];
    int s[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      s[u] = -1;
      if (w.ok()) {
        long long gi;
        tile_point(g, t, w, &gi, &s[u]);
        x[u] = __ldg(a.data + gi);
        w.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (s[u] >= 0) X[s[u]] = x[u];
  }
}

template <class G, class V, bool kDbl>
__device__ __forceinline__ void stage(const G& g, const Tile& t,
                                      const DecodeArgs<V, kDbl>& a, V* X,
                                      int* T, unsigned char*) {
  BoxWalk w(t.ni, t.nj, t.nk);
  while (w.ok()) {
    V x[kStageBatch];
    int ty[kStageBatch], s[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      s[u] = -1;
      if (w.ok()) {
        long long gi;
        tile_point(g, t, w, &gi, &s[u]);
        x[u] = __ldg(a.known + gi);
        ty[u] = __ldg(a.types + gi);
        w.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (s[u] >= 0) {
        X[s[u]] = x[u];
        T[s[u]] = ty[u];
      }
  }
}

// One encoded point: its type and R, the reconstruction or, for an
// escape, the escape's.  The first point of the lattice escapes.
template <class G, class V, bool kDbl>
__device__ __forceinline__ void point(const G&, const QuantArgs<V, kDbl>& a,
                                      int c, int i, int j, int k, V* Rs,
                                      const V* X, int* T,
                                      const unsigned char*) {
  const V cur = X[c];
  V rec = V(0);
  const int t = (i | j | k) == 0
                    ? 0
                    : quantize<kDbl>(cur, predict<G>(Rs, c, i, j, k), a.q,
                                     &rec);
  T[c] = t;
  Rs[c] = t ? rec : esc_recon(cur, a.median, a.mask);
}

// One decoded point: the reconstruction from its type, or the stored
// escape.
template <class G, class V, bool kDbl>
__device__ __forceinline__ void point(const G&, const DecodeArgs<V, kDbl>& a,
                                      int c, int i, int j, int k, V* Rs,
                                      const V* X, int* T,
                                      const unsigned char*) {
  const int t = T[c];
  Rs[c] = t ? recon<kDbl>(predict<G>(Rs, c, i, j, k), t, a.q) : X[c];
}

// Each form and rank its own __global__ name (the profile tells them
// apart; chip_smoke.DEVICE_NAMES lists them).
__global__ void __launch_bounds__(kMaxThreads) classic_quantize2d_kernel(
    GeoOf<2, float> g, const int* __restrict__ order, int* flags,
    QuantArgs<float, false> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_quantize3d_kernel(
    GeoOf<3, float> g, const int* __restrict__ order, int* flags,
    QuantArgs<float, false> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_quantize4d_kernel(
    GeoOf<3, float> g, const int* __restrict__ order, int* flags,
    QuantArgs<float, true> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_quantize2d_f64_kernel(
    GeoOf<2, double> g, const int* __restrict__ order, int* flags,
    QuantArgs<double, true> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_quantize3d_f64_kernel(
    GeoOf<3, double> g, const int* __restrict__ order, int* flags,
    QuantArgs<double, true> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_decode2d_kernel(
    GeoOf<2, float> g, const int* __restrict__ order, int* flags,
    DecodeArgs<float, false> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_decode3d_kernel(
    GeoOf<3, float> g, const int* __restrict__ order, int* flags,
    DecodeArgs<float, false> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_decode4d_kernel(
    GeoOf<3, float> g, const int* __restrict__ order, int* flags,
    DecodeArgs<float, true> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_decode2d_f64_kernel(
    GeoOf<2, double> g, const int* __restrict__ order, int* flags,
    DecodeArgs<double, true> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) classic_decode3d_f64_kernel(
    GeoOf<3, double> g, const int* __restrict__ order, int* flags,
    DecodeArgs<double, true> a) {
  run_tiles(g, order, flags, a);
}

unsigned long long mask_of(int ign, int width) {
  if (ign >= width) return 0ull;
  const unsigned long long full = width == 32 ? 0xFFFFFFFFull : ~0ull;
  return (~((1ull << ign) - 1ull)) & full;
}

// One launch on the lattice (r1, r2, r3): rank 2 (r1 = 1) takes the 2-D
// tile, any other the 3-D one.
template <class V, bool kDbl, class A>
int launch_form(void (*k2)(GeoOf<2, V>, const int*, int*, A),
                void (*k3)(GeoOf<3, V>, const int*, int*, A), const A& a,
                int rank, int r1, int r2, int r3, const int* order,
                int* flags, int ntiles, void* stream) {
  if (rank == 2)
    return launch(k2, a, 1, r2, r3, order, flags, ntiles,
                  (cudaStream_t)stream);
  return launch(k3, a, r1, r2, r3, order, flags, ntiles,
                (cudaStream_t)stream);
}

}  // namespace

// Arguments common to the entry points: the lattice (r1, r2, r3) of one
// launch (a 2-D field: rank 2 and r1 = 1; a 4-D volume: rank 3); order:
// int32[ntiles], the flat tile index of each claim number by
// tile-diagonal, for ClassicTile of the rank and type
// (gpu/tiles.tile_order); flags: int32[ntiles + 1], zero (the last is
// the claim counter).  Quantizer scalars: rp_t the precision in the
// data's type, rp64 and recip64 the precision and its reciprocal in
// RT, widened; ign = max(width - req_length, 0).

// K10, float32 data on ranks 2-3 (float form): data -> types i32 and
// the reconstruction R (both preallocated, the lattice's shape).
extern "C" int sz_classic_quantize(const float* data, int* types, float* R,
                                   int rank, int r1, int r2, int r3,
                                   float rp_t, double rp64, double recip64,
                                   int intervals, int radius, float median,
                                   int ign, const int* order, int* flags,
                                   int ntiles, void* stream) {
  QuantArgs<float, false> a{data, types, R,
                            Quantizer<float>{rp_t, rp64, recip64, intervals,
                                             radius},
                            median, mask_of(ign, 32)};
  return launch_form<float, false>(classic_quantize2d_kernel,
                                   classic_quantize3d_kernel, a, rank, r1,
                                   r2, r3, order, flags, ntiles, stream);
}

// K10, one volume of a float32 4-D field (double form).
extern "C" int sz_classic_quantize_4d(const float* data, int* types,
                                      float* R, int r1, int r2, int r3,
                                      double rp64, double recip64,
                                      int intervals, int radius,
                                      float median, int ign,
                                      const int* order, int* flags,
                                      int ntiles, void* stream) {
  QuantArgs<float, true> a{data, types, R,
                           Quantizer<float>{0.0f, rp64, recip64, intervals,
                                            radius},
                           median, mask_of(ign, 32)};
  return launch(classic_quantize4d_kernel, a, r1, r2, r3, order, flags,
                ntiles, (cudaStream_t)stream);
}

// K10, float64 data (rank 2, rank 3, or one volume of rank 4).
extern "C" int sz_classic_quantize_f64(const double* data, int* types,
                                       double* R, int rank, int r1, int r2,
                                       int r3, double rp64, double recip64,
                                       int intervals, int radius,
                                       double median, int ign,
                                       const int* order, int* flags,
                                       int ntiles, void* stream) {
  QuantArgs<double, true> a{data, types, R,
                            Quantizer<double>{rp64, rp64, recip64, intervals,
                                              radius},
                            median, mask_of(ign, 64)};
  return launch_form<double, true>(classic_quantize2d_f64_kernel,
                                   classic_quantize3d_f64_kernel, a, rank,
                                   r1, r2, r3, order, flags, ntiles, stream);
}

// K11, float32 data on ranks 2-3: types i32 and known (the escapes'
// values in place, anything elsewhere) -> out.
extern "C" int sz_classic_decode(const int* types, const float* known,
                                 float* out, int rank, int r1, int r2,
                                 int r3, float rp_t, int radius,
                                 const int* order, int* flags, int ntiles,
                                 void* stream) {
  DecodeArgs<float, false> a{types, known, out,
                             Quantizer<float>{rp_t, 0.0, 0.0, 0, radius}};
  return launch_form<float, false>(classic_decode2d_kernel,
                                   classic_decode3d_kernel, a, rank, r1, r2,
                                   r3, order, flags, ntiles, stream);
}

// K11, one volume of a float32 4-D field.
extern "C" int sz_classic_decode_4d(const int* types, const float* known,
                                    float* out, int r1, int r2, int r3,
                                    double rp64, int radius,
                                    const int* order, int* flags,
                                    int ntiles, void* stream) {
  DecodeArgs<float, true> a{types, known, out,
                            Quantizer<float>{0.0f, rp64, 0.0, 0, radius}};
  return launch(classic_decode4d_kernel, a, r1, r2, r3, order, flags,
                ntiles, (cudaStream_t)stream);
}

// K11, float64 data.
extern "C" int sz_classic_decode_f64(const int* types, const double* known,
                                     double* out, int rank, int r1, int r2,
                                     int r3, double rp64, int radius,
                                     const int* order, int* flags,
                                     int ntiles, void* stream) {
  DecodeArgs<double, true> a{types, known, out,
                             Quantizer<double>{rp64, rp64, 0.0, 0, radius}};
  return launch_form<double, true>(classic_decode2d_f64_kernel,
                                   classic_decode3d_f64_kernel, a, rank, r1,
                                   r2, r3, order, flags, ntiles, stream);
}
