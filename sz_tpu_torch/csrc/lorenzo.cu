// K1 wavefront_quantize / K2 wavefront_decode: the SZ2.1 Lorenzo
// recurrence in dependency order on Hopper (sm_90a), on float32 fields;
// K1d / K2d: the same on float64 fields.
//
// Replaces sz_tpu/tpu/pallas_kernels.py::plane_quantize and
// ::strip_quantize (per-plane fixpoint iteration), and
// sz_tpu/tpu/wf_quantize.py::wavefront_quantize / ::wavefront_decode
// (sheared anti-diagonal pass), plus the XLA plane scan of
// sz_tpu/tpu/engine.py::_decode_fn.
//
// Every point (i, j, k) depends on its seven Lorenzo neighbours, the
// points one lower on any set of axes.  Out-of-lattice neighbours read
// 0.0f, which is the reference's boundary rule.  Rank 2 is r1 = 1.
//
// Design: one persistent launch per call on the tile machinery of
// tiles.cuh (shared with K8/K9), with a one-deep k-halo: tiles of
// LorenzoTile's shape, claimed in tile-diagonal order, each run as a
// point wavefront in shared memory.  tiles.cuh's note has the order, the
// memory order of the hand-off and what bounds it.  Here: the tile
// shapes, picked by a sweep on the H100 (PERF.md), and the point rules.
// For K1 a step's chain is the shared-memory reads, the 7-term sum, the
// quantizer and a barrier; at 512^3 (32,768 tiles) the bound is each
// tile's busy time, most of it staging the inputs, over the resident
// blocks.
//
// K1d / K2d replace no Pallas kernel (the JAX package keeps float64 off
// its Pallas kernels): they port the XLA stages that run float64 there,
// the fixpoints of sz_tpu/tpu/engine.py::_quantize_fn and ::_decode_fn,
// whose rule is sz_tpu/core/regnd.py::_np_quant in double.  Same tiles
// machinery; a double tile takes twice the shared memory of R and X, so
// the 2-D tile is shorter on k (LorenzoTile: the shapes, from the
// kernel's shared-memory bytes and the ptxas report, PERF.md).  They move
// ~34 (K1d) and ~25 (K2d) bytes a point and are bound, as K1/K2, by the
// dependency chain and the tiles' busy time, not by f64 operations.
//
// Bit-exactness: every float op that reaches the stream is an explicit
// round-to-nearest intrinsic in the op order of the JAX kernels
// (pallas_kernels.py pred2d / wf_quantize._pred_add, engine._quant), in
// float for K1/K2 and in double for K1d/K2d; the build passes
// --fmad=false as well.  Each point is computed once, from final
// neighbours, so any dependency order gives the same bits.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using namespace tiles;

// The tile (bi x bj x bk) of a lattice of rank kRank (3: r1 > 1; 2:
// r1 = 1) and element type V; lorenzo_kernel.TILE3 / TILE2 (float) and
// TILE3_F64 / TILE2_F64 hold the same values for the claim order
// (tests/test_torch_kernels.py compares them).  A double 2-D tile of
// 1 x 64 x 96 would take 268,842 B of shared memory, past a block's
// 232,448; at bk = 64 it takes 181,482 B (one block an SM, as the float
// 2-D tile), and the 3-D tile keeps its shape at 112,077 B (two blocks
// an SM, the float one three).
template <int kRank, class V>
struct LorenzoTile {
  static constexpr bool kWide = sizeof(V) == 8;
  static constexpr int bi = kRank == 3 ? 8 : 1;
  static constexpr int bj = kRank == 3 ? 16 : 64;
  static constexpr int bk = kRank == 3 ? 32 : kWide ? 64 : 96;
};

// Round-to-nearest float and double arithmetic, one name for both.
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

// (x,y,z-1)+(x,y-1,z), +(x-1,y,z), -(x,y-1,z-1), -(x-1,y,z-1),
// -(x-1,y-1,z), +(x-1,y-1,z-1), all read from the tile's shared copy
template <class V>
__device__ __forceinline__ V pred7(const V* Rs, int c, int P, int Q) {
  V p = add_rn(Rs[c - 1], Rs[c - P]);
  p = add_rn(p, Rs[c - Q]);
  p = sub_rn(p, Rs[c - P - 1]);
  p = sub_rn(p, Rs[c - Q - 1]);
  p = sub_rn(p, Rs[c - Q - P]);
  p = add_rn(p, Rs[c - Q - P - 1]);
  return p;
}

// engine._quant: predict -> quantize with escape and epsilon recheck.
__device__ __forceinline__ void quant(float cur, float pred, float rp,
                                      float recip, float capf, int radius,
                                      int* t_out, float* rec_out) {
  float diff = __fsub_rn(cur, pred);
  float itv = __fadd_rn(__fmul_rn(fabsf(diff), recip), 1.0f);
  bool within = itv < capf;
  if (diff < 0.0f) itv = -itv;
  // unsigned arithmetic: out-of-range codes (within == false) are
  // discarded below, but must not be signed-overflow UB on the way
  unsigned tu = (unsigned)__float2int_rz(__fdiv_rn(itv, 2.0f)) +
                (unsigned)radius;
  int q = (int)(2u * (tu - (unsigned)radius));
  float rec = __fadd_rn(pred, __fmul_rn(__int2float_rn(q), rp));
  bool ok = within && (fabsf(__fsub_rn(cur, rec)) <= rp);
  *t_out = ok ? (int)tu : 0;
  *rec_out = ok ? rec : cur;
}

// The same rule in double (regnd._np_quant with T = float64): K1d.
__device__ __forceinline__ void quant(double cur, double pred, double rp,
                                      double recip, double capf, int radius,
                                      int* t_out, double* rec_out) {
  double diff = __dsub_rn(cur, pred);
  double itv = __dadd_rn(__dmul_rn(fabs(diff), recip), 1.0);
  bool within = itv < capf;
  if (diff < 0.0) itv = -itv;
  unsigned tu = (unsigned)__double2int_rz(__ddiv_rn(itv, 2.0)) +
                (unsigned)radius;
  int q = (int)(2u * (tu - (unsigned)radius));
  double rec = __dadd_rn(pred, __dmul_rn(__int2double_rn(q), rp));
  bool ok = within && (fabs(__dsub_rn(cur, rec)) <= rp);
  *t_out = ok ? (int)tu : 0;
  *rec_out = ok ? rec : cur;
}

// The point rules (tiles.cuh): in shared memory R with its halo, the
// staged value X, for K1 the type codes T, and the flags F.
template <class V>
struct QuantArgs {
  static constexpr int kArrays = 3;
  static constexpr int kFlagBytes = 1;
  static constexpr bool kTypesOut = true;
  const V* data;
  const int* t_reg;
  const V* rec_reg;
  const unsigned char* reg;
  const unsigned char* mean_mask;  // null unless use_mean
  int* t_out;
  V* R;
  V rp, recip, cap_szf, mean;
  int radius;
};

template <class V>
struct DecodeArgs {
  static constexpr int kArrays = 2;
  static constexpr int kFlagBytes = 1;
  static constexpr bool kTypesOut = false;
  const unsigned char* known_mask;
  const V* known;
  const V* q_lor;
  V* R;
};

// Stages one tile's inputs: X = the regression value or the data (K1),
// the known value or q (K2); F = the point's flags; T = t_reg (K1).
template <class G, class V>
__device__ __forceinline__ void stage(const G& g, const Tile& t,
                                      const QuantArgs<V>& a, V* X, int* T,
                                      unsigned char* F) {
  BoxWalk w(t.ni, t.nj, t.nk);
  while (w.ok()) {
    V x[kStageBatch];
    int tr[kStageBatch], s[kStageBatch];
    unsigned char f[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      s[u] = -1;
      if (w.ok()) {
        long long gi;
        tile_point(g, t, w, &gi, &s[u]);
        unsigned char r = a.reg[gi];
        unsigned char m = a.mean_mask ? a.mean_mask[gi] : 0;
        V d = a.data[gi], rr = a.rec_reg[gi];
        tr[u] = a.t_reg[gi];
        f[u] = (unsigned char)(r | (m << 1));
        x[u] = r ? rr : d;
        w.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (s[u] >= 0) {
        X[s[u]] = x[u];
        T[s[u]] = tr[u];
        F[s[u]] = f[u];
      }
  }
}

template <class G, class V>
__device__ __forceinline__ void stage(const G& g, const Tile& t,
                                      const DecodeArgs<V>& a, V* X, int*,
                                      unsigned char* F) {
  BoxWalk w(t.ni, t.nj, t.nk);
  while (w.ok()) {
    V x[kStageBatch];
    int s[kStageBatch];
    unsigned char f[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      s[u] = -1;
      if (w.ok()) {
        long long gi;
        tile_point(g, t, w, &gi, &s[u]);
        unsigned char km = a.known_mask[gi];
        V kv = a.known[gi], q = a.q_lor[gi];
        f[u] = km;
        x[u] = km ? kv : q;
        w.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (s[u] >= 0) {
        X[s[u]] = x[u];
        F[s[u]] = f[u];
      }
  }
}

// One point of K1 at shared index c (its neighbours are final).  Every
// thread runs the quantizer (a regression point discards its result),
// so the warp does not split.
template <class G, class V>
__device__ __forceinline__ void point(const G&, const QuantArgs<V>& a, int c,
                                      int, int, int, V* Rs, const V* X,
                                      int* T, const unsigned char* F) {
  const unsigned char f = F[c];
  const V x = X[c];
  const int t_reg = T[c];
  int t;
  V rec;
  quant(x, pred7(Rs, c, G::P, G::Q), a.rp, a.recip, a.cap_szf, a.radius, &t,
        &rec);
  if (a.mean_mask) {
    // index shift of the mean-flush bin (engine.py:976-980)
    if (t != 0 && t <= a.radius) t -= 1;
    if (f & 2) {
      t = a.radius;
      rec = a.mean;
    }
  }
  T[c] = (f & 1) ? t_reg : t;
  Rs[c] = (f & 1) ? x : rec;
}

// One point of K2: R = known_mask ? known : pred7(R) + q_lor.
template <class G, class V>
__device__ __forceinline__ void point(const G&, const DecodeArgs<V>&, int c,
                                      int, int, int, V* Rs, const V* X, int*,
                                      const unsigned char* F) {
  const unsigned char f = F[c];
  const V x = X[c];
  const V r = add_rn(pred7(Rs, c, G::P, G::Q), x);
  Rs[c] = f ? x : r;
}

// K1 and K2 on float fields, K1d and K2d on double ones: one name each,
// so that a profile tells them apart.
template <class G>
__global__ void __launch_bounds__(kMaxThreads) wavefront_quantize_kernel(
    G g, const int* __restrict__ order, int* flags, QuantArgs<float> a) {
  run_tiles(g, order, flags, a);
}

template <class G>
__global__ void __launch_bounds__(kMaxThreads) wavefront_decode_kernel(
    G g, const int* __restrict__ order, int* flags, DecodeArgs<float> a) {
  run_tiles(g, order, flags, a);
}

template <class G>
__global__ void __launch_bounds__(kMaxThreads) wavefront_quantize_f64_kernel(
    G g, const int* __restrict__ order, int* flags, QuantArgs<double> a) {
  run_tiles(g, order, flags, a);
}

template <class G>
__global__ void __launch_bounds__(kMaxThreads) wavefront_decode_f64_kernel(
    G g, const int* __restrict__ order, int* flags, DecodeArgs<double> a) {
  run_tiles(g, order, flags, a);
}

template <int kRank, class V>
using LorenzoGeo = Geo<TileShape<LorenzoTile<kRank, V>, 1>>;

}  // namespace

// order: int32[ntiles], the flat tile index of each claim number, by
// tile-diagonal, for LorenzoTile<3, V> when r1 > 1 and LorenzoTile<2, V>
// when r1 = 1 (gpu/tiles.tile_order); flags: int32[ntiles + 1], zero
// (the last is the claim counter).
extern "C" int sz_wavefront_quantize(
    const float* data, const int* t_reg, const float* rec_reg,
    const unsigned char* reg, const unsigned char* mean_mask, int* t_out,
    float* R, int r1, int r2, int r3, float rp, float recip, float cap_szf,
    float mean, int radius, int use_mean, const int* order, int* flags,
    int ntiles, void* stream) {
  QuantArgs<float> a{data, t_reg, rec_reg, reg,
                     use_mean ? mean_mask : nullptr,
                     t_out, R, rp, recip, cap_szf, mean, radius};
  cudaStream_t st = (cudaStream_t)stream;
  return r1 > 1 ? launch(wavefront_quantize_kernel<LorenzoGeo<3, float>>, a,
                         r1, r2, r3, order, flags, ntiles, st)
                : launch(wavefront_quantize_kernel<LorenzoGeo<2, float>>, a,
                         r1, r2, r3, order, flags, ntiles, st);
}

extern "C" int sz_wavefront_decode(const unsigned char* known_mask,
                                   const float* known, const float* q_lor,
                                   float* R, int r1, int r2, int r3,
                                   const int* order, int* flags, int ntiles,
                                   void* stream) {
  DecodeArgs<float> a{known_mask, known, q_lor, R};
  cudaStream_t st = (cudaStream_t)stream;
  return r1 > 1 ? launch(wavefront_decode_kernel<LorenzoGeo<3, float>>, a,
                         r1, r2, r3, order, flags, ntiles, st)
                : launch(wavefront_decode_kernel<LorenzoGeo<2, float>>, a,
                         r1, r2, r3, order, flags, ntiles, st);
}

extern "C" int sz_wavefront_quantize_f64(
    const double* data, const int* t_reg, const double* rec_reg,
    const unsigned char* reg, const unsigned char* mean_mask, int* t_out,
    double* R, int r1, int r2, int r3, double rp, double recip,
    double cap_szf, double mean, int radius, int use_mean, const int* order,
    int* flags, int ntiles, void* stream) {
  QuantArgs<double> a{data, t_reg, rec_reg, reg,
                      use_mean ? mean_mask : nullptr,
                      t_out, R, rp, recip, cap_szf, mean, radius};
  cudaStream_t st = (cudaStream_t)stream;
  return r1 > 1
             ? launch(wavefront_quantize_f64_kernel<LorenzoGeo<3, double>>,
                      a, r1, r2, r3, order, flags, ntiles, st)
             : launch(wavefront_quantize_f64_kernel<LorenzoGeo<2, double>>,
                      a, r1, r2, r3, order, flags, ntiles, st);
}

extern "C" int sz_wavefront_decode_f64(const unsigned char* known_mask,
                                       const double* known,
                                       const double* q_lor, double* R,
                                       int r1, int r2, int r3,
                                       const int* order, int* flags,
                                       int ntiles, void* stream) {
  DecodeArgs<double> a{known_mask, known, q_lor, R};
  cudaStream_t st = (cudaStream_t)stream;
  return r1 > 1
             ? launch(wavefront_decode_f64_kernel<LorenzoGeo<3, double>>, a,
                      r1, r2, r3, order, flags, ntiles, st)
             : launch(wavefront_decode_f64_kernel<LorenzoGeo<2, double>>, a,
                      r1, r2, r3, order, flags, ntiles, st);
}
