// K8 msst19_wavefront3d / K9 msst19_lines2d: the MSST19 point-wise
// relative (PW_REL) codec's multiplicative recurrence on Hopper (sm_90a),
// encode and decode; K8d / K9d, their forms for float64 data.
//
// K8 replaces sz_tpu/tpu/msst19_kernel.py::_make_wf_kernel (T11, the
// 3-D wavefront behind `encode`/`decode`); K9 replaces
// ::_make_wf2_kernel (T12, the 2-D line kernel behind
// `encode2d`/`decode2d`).  What they compute is fixed by the reference's
// host chains (sz_float.c SZ_compress_float_{2,3}D_MDQ_MSST19,
// szd_float.c decompressDataSeries_float_{2,3}D_MSST19; in the JAX
// package sz_tpu/core/pwr.py compress_msst19 / decompress_msst19):
//
//   3-D (K8): pred = f32(((A*B)*C)*G / ((D*E)*F)) in IEEE f64, each
//     product and the quotient rounded once (the C's `double temp`
//     chains), with the first plane, row and column taking the C's
//     shorter forms (A, B, C, A*A/A2, A*B/D, A*C/F, B*C/E);
//   2-D (K9): pred = f32(f32(A*B) / D) in single precision (the
//     reference's 2-D float kernel chains in float), first row
//     f32(f32(A*A) / A2);
//   encode: ratio = f32(|cur| / |pred|); the state is the cache table's
//     entry for the bits of (double)ratio (CacheTable.lookup): sign
//     masked, exponent range-checked against [base, top], mantissa >>
//     (52 - bits); state s != 0 reconstructs f32(f64(|pred|) * pt[s]),
//     an escape (state 0; always at the first point) reconstructs |cur|
//     with its low 32 - req_length bits cleared;
//   decode: the same reconstruction from the types, escapes taking the
//     stored (signed) values.
// The chain carries magnitudes: every predictor is a product or a
// quotient, so |pred| is the same function of the neighbours'
// magnitudes, and the host's signed chain gives the same bits.  Inf and
// NaN predictions, and zero denominators, fall out of plain IEEE
// arithmetic exactly as in the C: a NaN or infinite ratio has exponent
// 2047 (past top) and a zero ratio exponent 0 (below base), so both
// look up state 0.
//
// What the TPU needed and this card does not: T11/T12 computed the f64
// chain in software (softf64 integer arithmetic) and found the state by
// a 3-level stairstep counting search limited to 4096 boundary states,
// so the 1e-4 and 1e-5 bounds went back to the host.  Here the chain is
// native __dmul_rn/__ddiv_rn (the build also passes --fmad=false), and
// the state is one indexed load of the u16 cache table, of any size
// (13 bits a subrange at 1e-3, 20 bits at 1e-5: megabytes).
//
// Design: one persistent launch a call on the tile machinery of
// tiles.cuh (shared with K1/K2), whose note has the claim order, the
// hand-off and the bound.  The MSST19 stencil reads K1's seven
// neighbours and, on the lattice's first row, A2 = (i, j, k-2), so the
// tiles carry a k-halo two deep.  K8 runs on Msst19Tile<3> for any r1,
// K9 on Msst19Tile<2> (r1 = 1).  Shared memory holds R as the output
// takes it (escapes signed in the decode), and every neighbour read takes
// fabsf, as do reads of the halo that came back from device memory.
//
// K8d and K9d (the `_f64` kernels and entry points, their own names so a
// profile and the launch counters tell them apart) replace the XLA scans
// that the JAX package runs for float64 data (sz_tpu/tpu/msst19_engine.py
// _wf3_encode_fn / _wf3_decode_fn and _wf2_encode_fn / _wf2_decode_fn;
// the host chains sz_double.c MSST19 2-D/3-D, szd_double.c): the same
// stencil with the chain in double throughout and nothing rounded to
// float: pred = ((A*B)*C)*G / ((D*E)*F) and its shorter forms, in 2-D
// the 3-D first plane's forms (A*A/A2, A*B/D); ratio = |cur| / |pred| in
// double, keyed on its own bits; a state reconstructs |pred| * pt[s]; an
// escape keeps |cur| with its low 64 - req_length bits cleared.  R, the
// staged values and the halo are doubles: the 3-D tile keeps its shape
// (106,740 B of shared memory, two blocks an SM), the 2-D one takes
// bk = 64 (172,840 B; 1 x 64 x 96 would take 256,040 B, past a block's
// 232,448), as K1d's 2-D tile does.
//
// Bound on this card: the dependency chain (tile-diagonals x point
// steps; at 512^3 the tiles' busy time over the resident blocks), not
// bytes or arithmetic.  A step of the encode is the predictor (K8: up to
// six __dmul_rn and a __ddiv_rn), the ratio's __fdiv_rn, the cache-table
// load, the precision-table load and one __dmul_rn, then a barrier; the
// decode has no ratio and no cache-table load.  The tables are read with
// __ldg (the read-only path through L1; the states a field uses cluster
// around ratio 1), not staged: the main path's cache table (192 KB at
// 1e-3) fits beside no tile block, and the encode - decode time, which
// bounds what staging could win, is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using namespace tiles;

// The tile (bi x bj x bk) of K8 (rank 3) and K9 (rank 2) for data of
// type V; the same values stand in msst19_kernel.TILE3 / TILE2 (float)
// and TILE3_F64 / TILE2_F64 for the claim order
// (tests/test_torch_msst19_tiles.py compares them).
template <int kRank, class V>
struct Msst19Tile {
  static constexpr bool kWide = sizeof(V) == 8;
  static constexpr int bi = kRank == 3 ? 8 : 1;
  static constexpr int bj = kRank == 3 ? 16 : 64;
  static constexpr int bk = kRank == 3 ? 32 : kWide ? 64 : 96;
};

template <int kRank, class V>
using Msst19Geo = Geo<TileShape<Msst19Tile<kRank, V>, 2>>;

template <int kRank>
struct Rank {};

struct Tables {
  const uint16_t* table;  // (top - base + 1) << bits states
  const double* pt;       // npt precision factors
  int npt, base, top, bits;
};

// State of a prediction ratio, keyed on the bits of (double)ratio
// (CacheTable.lookup): 0 outside the table.  A float ratio widens
// exactly.
__device__ __forceinline__ int lookup(double ratio, const Tables& t) {
  unsigned long long b =
      (unsigned long long)__double_as_longlong(ratio) & 0x7FFFFFFFFFFFFFFFull;
  int expo = (int)(b >> 52) - t.base;
  if (expo < 0 || expo > t.top - t.base) return 0;
  unsigned long long manti = (b & 0x000FFFFFFFFFFFFFull) >> (52 - t.bits);
  return __ldg(t.table + ((long long)expo << t.bits) + (long long)manti);
}

// |cur| / |pred| in the data's precision.
__device__ __forceinline__ float ratio_of(float cur, float pred) {
  return __fdiv_rn(cur, pred);
}
__device__ __forceinline__ double ratio_of(double cur, double pred) {
  return __ddiv_rn(cur, pred);
}

// (f64(|pred|) * pt[s]) in the data's type (float: rounded once); a type
// past the table (a corrupt stream, refused by the engine) gives NaN
// rather than a read out of bounds.
__device__ __forceinline__ float recon(float pred, int s, const Tables& t) {
  if ((unsigned)s >= (unsigned)t.npt) return __int_as_float(0x7FFFFFFF);
  return __double2float_rn(__dmul_rn((double)fabsf(pred), __ldg(t.pt + s)));
}
__device__ __forceinline__ double recon(double pred, int s, const Tables& t) {
  if ((unsigned)s >= (unsigned)t.npt)
    return __longlong_as_double(0x7FF8000000000000ll);
  return __dmul_rn(fabs(pred), __ldg(t.pt + s));
}

__device__ __forceinline__ float trunc_bits(float cur,
                                            unsigned long long mask) {
  return __uint_as_float(__float_as_uint(cur) & (unsigned)mask);
}
__device__ __forceinline__ double trunc_bits(double cur,
                                             unsigned long long mask) {
  return __longlong_as_double(
      (long long)((unsigned long long)__double_as_longlong(cur) & mask));
}

// |R| at shared index c, widened.
__device__ __forceinline__ double wide(const float* Rs, int c) {
  return (double)fabsf(Rs[c]);
}
__device__ __forceinline__ double wide(const double* Rs, int c) {
  return fabs(Rs[c]);
}

// The 3-D predictor of lattice point (i, j, k) at shared index c, from
// the magnitudes of its final neighbours, in double: rounded once to
// float for float data (the C's `double temp` chains), not at all for
// double data, whose 2-D rules are the first plane's (i = 0).  Names as
// in the host chain: A (k-1), B (j-1), C (i-1), D (j-1,k-1), E
// (i-1,j-1), F (i-1,k-1), G (i-1,j-1,k-1), A2 (k-2).
template <class G, class V>
__device__ __forceinline__ double predict_wide(const V* Rs, int c, int i,
                                               int j, int k) {
  constexpr int P = G::P, Q = G::Q;
  if (i == 0) {
    if (j == 0) {
      if (k == 0) return 0.0;
      if (k == 1) return wide(Rs, c - 1);
      double a = wide(Rs, c - 1);
      return __ddiv_rn(__dmul_rn(a, a), wide(Rs, c - 2));
    }
    if (k == 0) return wide(Rs, c - P);
    return __ddiv_rn(__dmul_rn(wide(Rs, c - 1), wide(Rs, c - P)),
                     wide(Rs, c - P - 1));
  }
  if (j == 0) {
    if (k == 0) return wide(Rs, c - Q);
    return __ddiv_rn(__dmul_rn(wide(Rs, c - 1), wide(Rs, c - Q)),
                     wide(Rs, c - Q - 1));
  }
  if (k == 0)
    return __ddiv_rn(__dmul_rn(wide(Rs, c - P), wide(Rs, c - Q)),
                     wide(Rs, c - Q - P));
  double num = __dmul_rn(__dmul_rn(__dmul_rn(wide(Rs, c - 1), wide(Rs, c - P)),
                                   wide(Rs, c - Q)),
                         wide(Rs, c - Q - P - 1));
  double den = __dmul_rn(__dmul_rn(wide(Rs, c - P - 1), wide(Rs, c - Q - P)),
                         wide(Rs, c - Q - 1));
  return __ddiv_rn(num, den);
}

template <class G>
__device__ __forceinline__ float predict(Rank<3>, const float* Rs, int c,
                                         int i, int j, int k) {
  return __double2float_rn(predict_wide<G>(Rs, c, i, j, k));
}

// The float 2-D predictor of lattice point (0, j, k), in single
// precision (the reference's 2-D float kernel chains in float): A (k-1),
// B (j-1), D (j-1,k-1), A2 (k-2).
template <class G>
__device__ __forceinline__ float predict(Rank<2>, const float* Rs, int c,
                                         int, int j, int k) {
  constexpr int P = G::P;
  const float A = fabsf(Rs[c - 1]);
  if (j == 0) {
    if (k == 0) return 0.0f;
    if (k == 1) return A;
    return __fdiv_rn(__fmul_rn(A, A), fabsf(Rs[c - 2]));
  }
  if (k == 0) return fabsf(Rs[c - P]);
  return __fdiv_rn(__fmul_rn(A, fabsf(Rs[c - P])), fabsf(Rs[c - P - 1]));
}

template <class G, int kRank>
__device__ __forceinline__ double predict(Rank<kRank>, const double* Rs,
                                          int c, int i, int j, int k) {
  return predict_wide<G>(Rs, c, i, j, k);
}

// The point rules (tiles.cuh): in shared memory R, X (the encode's
// |data|, the decode's stored escapes) and T (the states), R and X of
// the data's type V.
template <int kRank, class V>
struct Encode {
  static constexpr int kArrays = 3;
  static constexpr int kFlagBytes = 0;
  static constexpr bool kTypesOut = true;
  const V* data;
  int* t_out;
  V* R;
  Tables tab;
  unsigned long long mask;
};

template <int kRank, class V>
struct Decode {
  static constexpr int kArrays = 3;
  static constexpr int kFlagBytes = 0;
  static constexpr bool kTypesOut = false;
  const int* types;
  const V* known;
  V* R;
  Tables tab;
};

__device__ __forceinline__ float magnitude(float v) { return fabsf(v); }
__device__ __forceinline__ double magnitude(double v) { return fabs(v); }

template <class G, int kRank, class V>
__device__ __forceinline__ void stage(const G& g, const Tile& t,
                                      const Encode<kRank, V>& a, V* X, int*,
                                      unsigned char*) {
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
      if (s[u] >= 0) X[s[u]] = magnitude(x[u]);
  }
}

template <class G, int kRank, class V>
__device__ __forceinline__ void stage(const G& g, const Tile& t,
                                      const Decode<kRank, V>& a, V* X, int* T,
                                      unsigned char*) {
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

// One encoded point: its state, and R = the reconstruction or, for an
// escape, |cur| truncated.  The first point of the lattice escapes.
template <class G, int kRank, class V>
__device__ __forceinline__ void point(const G&, const Encode<kRank, V>& a,
                                      int c, int i, int j, int k, V* Rs,
                                      const V* X, int* T,
                                      const unsigned char*) {
  const V cur = X[c];
  const V pred = predict<G>(Rank<kRank>(), Rs, c, i, j, k);
  const int s =
      (i | j | k) == 0 ? 0 : lookup((double)ratio_of(cur, pred), a.tab);
  T[c] = s;
  Rs[c] = s ? recon(pred, s, a.tab) : trunc_bits(cur, a.mask);
}

// One decoded point: the reconstruction, or the stored escape (signed).
template <class G, int kRank, class V>
__device__ __forceinline__ void point(const G&, const Decode<kRank, V>& a,
                                      int c, int i, int j, int k, V* Rs,
                                      const V* X, int* T,
                                      const unsigned char*) {
  const int s = T[c];
  const V pred = predict<G>(Rank<kRank>(), Rs, c, i, j, k);
  Rs[c] = s ? recon(pred, s, a.tab) : X[c];
}

__global__ void __launch_bounds__(kMaxThreads) wavefront3d_encode_kernel(
    Msst19Geo<3, float> g, const int* __restrict__ order, int* flags,
    Encode<3, float> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) wavefront3d_decode_kernel(
    Msst19Geo<3, float> g, const int* __restrict__ order, int* flags,
    Decode<3, float> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) lines2d_encode_kernel(
    Msst19Geo<2, float> g, const int* __restrict__ order, int* flags,
    Encode<2, float> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) lines2d_decode_kernel(
    Msst19Geo<2, float> g, const int* __restrict__ order, int* flags,
    Decode<2, float> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) wavefront3d_encode_f64_kernel(
    Msst19Geo<3, double> g, const int* __restrict__ order, int* flags,
    Encode<3, double> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) wavefront3d_decode_f64_kernel(
    Msst19Geo<3, double> g, const int* __restrict__ order, int* flags,
    Decode<3, double> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) lines2d_encode_f64_kernel(
    Msst19Geo<2, double> g, const int* __restrict__ order, int* flags,
    Encode<2, double> a) {
  run_tiles(g, order, flags, a);
}

__global__ void __launch_bounds__(kMaxThreads) lines2d_decode_f64_kernel(
    Msst19Geo<2, double> g, const int* __restrict__ order, int* flags,
    Decode<2, double> a) {
  run_tiles(g, order, flags, a);
}

// The escapes' mask: the low ign bits of a width-bit pattern cleared.
inline unsigned long long mask_of(int ign, int width) {
  unsigned long long full = width == 64 ? ~0ull : 0xFFFFFFFFull;
  return ign >= width ? 0ull : full & ~((1ull << ign) - 1ull);
}

}  // namespace

// order: int32[ntiles], the flat tile index of each claim number, by
// tile-diagonal, for Msst19Tile<3, V> (K8, K8d) or Msst19Tile<2, V> (K9,
// K9d) (gpu/tiles.tile_order); flags: int32[ntiles + 1], zero (the last
// is the claim counter).  ign: the low bits an escape clears,
// max(32 - req_length, 0) for float data, max(64 - req_length, 0) for
// double data.

// K8 encode: data f32 (r1, r2, r3) -> types i32 and the magnitude
// reconstruction R (both preallocated, same shape).
extern "C" int sz_msst19_wavefront3d_encode(
    const float* data, const uint16_t* table, const double* pt, int npt,
    int base, int top, int bits, int ign, int* types, float* R, int r1,
    int r2, int r3, const int* order, int* flags, int ntiles,
    void* stream) {
  Encode<3, float> a{data, types, R, Tables{table, pt, npt, base, top, bits},
                     mask_of(ign, 32)};
  return launch(wavefront3d_encode_kernel, a, r1, r2, r3, order, flags,
                ntiles, (cudaStream_t)stream);
}

// K8 decode: types i32 and the escapes' values (known, f32, signed; any
// value elsewhere) -> out f32 (escapes signed, the rest magnitudes).
extern "C" int sz_msst19_wavefront3d_decode(
    const int* types, const float* known, const double* pt, int npt,
    float* out, int r1, int r2, int r3, const int* order, int* flags,
    int ntiles, void* stream) {
  Decode<3, float> a{types, known, out, Tables{nullptr, pt, npt, 0, 0, 0}};
  return launch(wavefront3d_decode_kernel, a, r1, r2, r3, order, flags,
                ntiles, (cudaStream_t)stream);
}

// K9 encode: data f32 (r2, r3) -> types i32 and R.
extern "C" int sz_msst19_lines2d_encode(
    const float* data, const uint16_t* table, const double* pt, int npt,
    int base, int top, int bits, int ign, int* types, float* R, int r2,
    int r3, const int* order, int* flags, int ntiles, void* stream) {
  Encode<2, float> a{data, types, R, Tables{table, pt, npt, base, top, bits},
                     mask_of(ign, 32)};
  return launch(lines2d_encode_kernel, a, 1, r2, r3, order, flags, ntiles,
                (cudaStream_t)stream);
}

// K9 decode: types i32, known f32 (r2, r3) -> out f32.
extern "C" int sz_msst19_lines2d_decode(
    const int* types, const float* known, const double* pt, int npt,
    float* out, int r2, int r3, const int* order, int* flags, int ntiles,
    void* stream) {
  Decode<2, float> a{types, known, out, Tables{nullptr, pt, npt, 0, 0, 0}};
  return launch(lines2d_decode_kernel, a, 1, r2, r3, order, flags, ntiles,
                (cudaStream_t)stream);
}

// K8d encode: data f64 (r1, r2, r3) -> types i32 and R f64.
extern "C" int sz_msst19_wavefront3d_encode_f64(
    const double* data, const uint16_t* table, const double* pt, int npt,
    int base, int top, int bits, int ign, int* types, double* R, int r1,
    int r2, int r3, const int* order, int* flags, int ntiles,
    void* stream) {
  Encode<3, double> a{data, types, R, Tables{table, pt, npt, base, top, bits},
                      mask_of(ign, 64)};
  return launch(wavefront3d_encode_f64_kernel, a, r1, r2, r3, order, flags,
                ntiles, (cudaStream_t)stream);
}

// K8d decode: types i32, known f64 -> out f64.
extern "C" int sz_msst19_wavefront3d_decode_f64(
    const int* types, const double* known, const double* pt, int npt,
    double* out, int r1, int r2, int r3, const int* order, int* flags,
    int ntiles, void* stream) {
  Decode<3, double> a{types, known, out, Tables{nullptr, pt, npt, 0, 0, 0}};
  return launch(wavefront3d_decode_f64_kernel, a, r1, r2, r3, order, flags,
                ntiles, (cudaStream_t)stream);
}

// K9d encode: data f64 (r2, r3) -> types i32 and R f64.
extern "C" int sz_msst19_lines2d_encode_f64(
    const double* data, const uint16_t* table, const double* pt, int npt,
    int base, int top, int bits, int ign, int* types, double* R, int r2,
    int r3, const int* order, int* flags, int ntiles, void* stream) {
  Encode<2, double> a{data, types, R, Tables{table, pt, npt, base, top, bits},
                      mask_of(ign, 64)};
  return launch(lines2d_encode_f64_kernel, a, 1, r2, r3, order, flags, ntiles,
                (cudaStream_t)stream);
}

// K9d decode: types i32, known f64 (r2, r3) -> out f64.
extern "C" int sz_msst19_lines2d_decode_f64(
    const int* types, const double* known, const double* pt, int npt,
    double* out, int r2, int r3, const int* order, int* flags, int ntiles,
    void* stream) {
  Decode<2, double> a{types, known, out, Tables{nullptr, pt, npt, 0, 0, 0}};
  return launch(lines2d_decode_f64_kernel, a, 1, r2, r3, order, flags, ntiles,
                (cudaStream_t)stream);
}
