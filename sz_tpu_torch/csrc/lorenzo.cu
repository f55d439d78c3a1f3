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
// 0.0, which is the reference's boundary rule.
//
// K1/K2 design: one persistent launch per call on the tile machinery of
// tiles.cuh (shared with K8/K9), with a one-deep k-halo: tiles of
// LorenzoTile's shape, claimed in tile-diagonal order, each run as a
// point wavefront in shared memory.  tiles.cuh's note has the order, the
// memory order of the hand-off and what bounds it.  Here: the tile
// shapes, picked by a sweep on the H100 (PERF.md), and the point rules.
// For K1 a step's chain is the shared-memory reads, the 7-term sum, the
// quantizer and a barrier; at 512^3 (32,768 tiles) the bound is each
// tile's busy time, most of it staging the inputs, over the resident
// blocks.  Rank 2 is r1 = 1.
//
// K1d / K2d replace no Pallas kernel (the JAX package keeps float64 off
// its Pallas kernels): they port the XLA stages that run float64 there,
// the fixpoints of sz_tpu/tpu/engine.py::_quantize_fn and ::_decode_fn,
// whose rule is sz_tpu/core/regnd.py::_np_quant in double.  Design: warp
// strips on the machinery of strips.cuh (shared with K10/K11), whose
// note has the walk, the rings, the hand-offs and the claim order; one
// launch a call, the rank-3 form for a rank-3 lattice and the rank-2
// form for a rank-2 one.  What a double tile could not avoid -- a block
// barrier every point step, every neighbour read from shared memory, a
// double footprint that left a 2-D block two warps -- the strips avoid:
// neighbours in registers and shuffles, no barrier in the step loop.
// The footprint sets how many warps a block holds, so K1d/K2d go by slot
// chunks: a double ring then needs 32 slots in 3-D, not 64, and a block
// holds 8 (K1d) or 10 (K2d) planes' warps.  A staged slot takes 12 bytes
// (K1d: X = reg ? rec_reg : data, and t_reg, the type written over it)
// or 8 (K2d: X = known_mask ? known : q_lor).  The flags (K1d: reg and
// mean; K2d: known_mask) reach no ring: each lane copies its own row's
// flag bytes of a chunk, two chunks ahead, as three aligned 8-byte blocks
// by cp.async (a plain load would stall the next progress mark, a
// release); at the staging of a chunk each lane packs its row's 16 into
// bits by column mod 32, and a staging lane takes its point's flag from
// its row's lane by shuffle to pick the point's X source (per-point
// shared-memory reads there cost the 2-D walk a quarter of its time).
// They move 26 (K1d without R) and 25 (K2d) bytes a point and are bound,
// as K10/K11, by the chain of steps and its hand-offs, and at 512^3 by
// the warps a block's rings leave an SM.
//
// Bit-exactness: every float op that reaches the stream is an explicit
// round-to-nearest intrinsic in the op order of the JAX kernels
// (pallas_kernels.py pred2d / wf_quantize._pred_add, engine._quant), in
// float for K1/K2 and in double for K1d/K2d; the build passes
// --fmad=false as well.  Each point is computed once, from final
// neighbours, so any dependency order gives the same bits.  K1d takes
// itv * 0.5 for itv / 2 (|itv| >= 1, +-inf or NaN: both round the same
// real) and 2 (t - radius) as h + h, h = trunc(itv * 0.5), exact for any
// t within the intervals.

#include <cuda_runtime.h>

#include <type_traits>

#include "strips.cuh"
#include "tiles.cuh"

namespace {

using namespace tiles;

// The tile (bi x bj x bk) of a float lattice of rank kRank (3: r1 > 1;
// 2: r1 = 1); lorenzo_kernel.TILE3 / TILE2 hold the same values for the
// claim order (tests/test_torch_kernels.py compares them).
template <int kRank>
struct LorenzoTile {
  static constexpr int bi = kRank == 3 ? 8 : 1;
  static constexpr int bj = kRank == 3 ? 16 : 64;
  static constexpr int bk = kRank == 3 ? 32 : 96;
};

// Round-to-nearest float arithmetic.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
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

// K1 and K2 on float fields (K1d and K2d below, on the strips): one name
// each, so that a profile tells them apart.
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

template <int kRank>
using LorenzoGeo = Geo<TileShape<LorenzoTile<kRank>, 1>>;

// The arguments of K1d and K2d; n: the lattice's points (the flag
// arrays' bytes).
struct StripQuantArgs {
  const double* data;
  const int* t_reg;
  const double* rec_reg;
  const unsigned char* reg;
  const unsigned char* mean_mask;  // null unless use_mean
  int* t_out;
  double* R;  // null: no reconstruction written
  long long n;
  double rp, recip, cap_szf, mean;
  int radius;
};

struct StripDecodeArgs {
  const unsigned char* known_mask;
  const double* known;
  const double* q_lor;
  double* R;
  long long n;
};

// K1d (kDec false) and K2d as point rules of strips.cuh, by slot chunks.
// A warp's staging region holds X (double), for K1d T (int32), then the
// flag bytes: for each flag array (K1d reg and mean, K2d known), 3 slot
// chunks x 32 rows x the three aligned 8-byte blocks (24 bytes) that
// cover a row's 16 columns of a chunk, each lane copying its own row's.
// Slot chunk c's are copied (cp.async) two chunks ahead, at the staging
// of chunk c - 2; at the staging of chunk c each lane packs its row's 16
// flags into bits (kept by column mod 32), and each point's X source is
// picked by its row's bits.
template <int kRank_, bool kDec>
struct LorenzoStrip {
  using V = double;
  using Args = typename std::conditional<kDec, StripDecodeArgs,
                                         StripQuantArgs>::type;
  static constexpr int kRank = kRank_;
  // rank 3: rings of 32 slots, so that a block holds many planes' warps;
  // rank 2 (one warp a strip, each a strip behind the one above): 64, so
  // that a warp need not keep within 23 steps of the next
  static constexpr int kRing = kRank == 3 ? 32 : 64;
  static constexpr bool kSlotChunks = true;
  using G = strips::Ring<kRing>;
  // warps a block
  static constexpr int W = kRank == 2 ? 4 : kDec ? 10 : 8;
  static constexpr int kFlags = kDec ? 1 : 2;    // flag arrays
  static constexpr int kSeg = 24;                // a row's flag bytes a chunk
  static constexpr int kFlagSlots = 3;           // slot chunks in flight
  static constexpr int kOffT = G::kRingS * 8;    // T after X
  static constexpr int kOffF = kOffT + (kDec ? 0 : G::kRingS * 4);
  static constexpr int kStageBytes =
      kOffF + kFlags * kFlagSlots * strips::kLanes * kSeg;
  static constexpr int kHalf = strips::kLanes / 2;  // points a lane stages

  // x: the staged X; t: K1d's t_reg; f0: reg (K1d) or known (K2d); f1:
  // the mean flush (K1d)
  struct In {
    double x;
    int t;
    bool f0, f1;
  };

  struct Lane {
    unsigned m0 = 0, m1 = 0;  // the lane's row's flags by column mod 32
    int nsc;                  // slot chunks of the walk

    static __device__ __forceinline__ const unsigned char* flags(
        const Args& a, int f) {
      if constexpr (kDec)
        return a.known_mask;
      else
        return f == 0 ? a.reg : a.mean_mask;
    }

    static __device__ __forceinline__ unsigned char* fbuf(unsigned char* st,
                                                          int f, int slot) {
      return st + kOffF + (f * kFlagSlots + slot) * strips::kLanes * kSeg;
    }

    // the byte index of row r's column 16c - r (may lie before the row)
    static __device__ __forceinline__ long long first(long long base, int c,
                                                      int r, int r3) {
      return base + (long long)r * r3 + c * strips::kChunk - r;
    }

    // slot chunk c's flag bytes of the lane's row into their buffer slot:
    // the three aligned 8-byte blocks from first() rounded down; bytes
    // outside the arrays are zero-filled, never read
    __device__ __forceinline__ void copy_flags(const Args& a,
                                               unsigned char* st,
                                               long long base, int c,
                                               int lane, int rows, int r3) {
      const int col0 = c * strips::kChunk - lane;
      if (lane >= rows || col0 + strips::kChunk <= 0 || col0 >= r3) return;
      const long long b0 = first(base, c, lane, r3) & ~7ll;
#pragma unroll
      for (int m = 0; m < kSeg / 8; ++m) {
        const long long wb = b0 + 8 * m;
        const long long left = a.n - wb;
        const int nb = wb < 0 ? 0 : left >= 8 ? 8 : left > 0 ? (int)left : 0;
#pragma unroll
        for (int f = 0; f < kFlags; ++f) {
          const unsigned char* src = flags(a, f);
          if (src)
            strips::cp_async_zfill8(
                fbuf(st, f, c % kFlagSlots) + lane * kSeg + 8 * m,
                nb ? src + wb : src, nb);
        }
      }
    }

    // 16 flag bytes (each 0 or 1) from byte off of a row's 24 as bits
    static __device__ __forceinline__ unsigned pack16(const unsigned char* p,
                                                      int off) {
      const unsigned long long* q =
          reinterpret_cast<const unsigned long long*>(p);
      const unsigned long long q0 = q[0], q1 = q[1], q2 = q[2];
      const int sh = 8 * off;
      const unsigned long long lo = sh ? (q0 >> sh) | (q1 << (64 - sh)) : q0;
      const unsigned long long hi = sh ? (q1 >> sh) | (q2 << (64 - sh)) : q1;
      unsigned out = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned long long y = h ? hi : lo;  // byte i at bit 8i -> bit i
        y |= y >> 7;
        y |= y >> 14;
        y |= y >> 28;
        out |= (unsigned)(y & 0xFF) << (8 * h);
      }
      return out;
    }

    // slot chunks 0 and 1's flags, landed before the walk stages chunk 0
    __device__ __forceinline__ Lane(const Args& a, unsigned char* st,
                                    long long row0, int lane, int rows,
                                    int r3) {
      nsc = (r3 + rows - 2 + strips::kChunk) / strips::kChunk;
      copy_flags(a, st, row0 * r3, 0, lane, rows, r3);
      if (nsc > 1) copy_flags(a, st, row0 * r3, 1, lane, rows, r3);
      strips::cp_async_commit();
      strips::cp_async_wait_all();
      __syncwarp();
    }

    // slot chunk c: the lane's row's 16 flags packed into bits (and into
    // its masks), each point's X from the source its flag picks (a staging
    // lane takes its point's flag from the row's lane by shuffle) and,
    // K1d, its t_reg, then slot chunk c + 2's flag bytes
    __device__ __forceinline__ void stage_chunk(const Args& a,
                                                unsigned char* st,
                                                long long base, int c,
                                                int lane, int rows, int r3) {
      double* X = reinterpret_cast<double*>(st);
      int* T = reinterpret_cast<int*>(st + kOffT);
      const int slot = c % kFlagSlots;
      // the lane's row's columns 16c - lane + t at bits (16c - lane + t)
      // mod 32: a rotation of the 16 bits (bytes past the lattice are 0)
      const int off = (int)(first(base, c, lane, r3) & 7);
      const int sh = (c * strips::kChunk - lane) & 31;
      const unsigned keep = ~__funnelshift_l(0xFFFFu, 0xFFFFu, sh);
      const unsigned b0 = pack16(fbuf(st, 0, slot) + lane * kSeg, off);
      m0 = (m0 & keep) | __funnelshift_l(b0, b0, sh);
      if (!kDec && flags(a, 1)) {
        const unsigned b1 = pack16(fbuf(st, 1, slot) + lane * kSeg, off);
        m1 = (m1 & keep) | __funnelshift_l(b1, b1, sh);
      }
      const int t = lane & 15, h = lane >> 4;
      const int x = c * strips::kChunk + t;
      long long gi = base + (long long)h * r3 + x - h;  // row h, column x - h
#pragma unroll
      for (int rr = 0; rr < kHalf; ++rr, gi += 2ll * r3 - 2) {
        const int r = 2 * rr + h;
        const int col = x - r;
        const bool f0 = (__shfl_sync(strips::kFull, b0, 2 * rr + h) >> t) & 1;
        if (r < rows && col >= 0 && col < r3) {
          const int e = r * G::kPitch + (x & G::kMask);
          if constexpr (kDec) {
            strips::cp_async(X + e, (f0 ? a.known : a.q_lor) + gi);
          } else {
            strips::cp_async(X + e, (f0 ? a.rec_reg : a.data) + gi);
            strips::cp_async(T + e, a.t_reg + gi);  // no branch: faster
          }
        }
      }
      if (c + 2 < nsc) copy_flags(a, st, base, c + 2, lane, rows, r3);
    }

    __device__ __forceinline__ In load(const Args&, const unsigned char* st,
                                       int e, int k) const {
      In x;
      x.x = reinterpret_cast<const double*>(st)[e];
      x.t = 0;
      if constexpr (!kDec) x.t = reinterpret_cast<const int*>(st + kOffT)[e];
      x.f0 = (m0 >> (k & 31)) & 1;
      x.f1 = (m1 >> (k & 31)) & 1;
      return x;
    }

    template <class Run>
    __device__ __forceinline__ void group(const Args&, const In*, int, int,
                                          int, int, Run&& run) {
      run(std::false_type{});
    }

    // pred7 in lorenzo.cu's op order, the out-of-lattice neighbours 0.0
    // (selected: the rings hold other points there), then K2d's R =
    // known ? X : pred + q or K1d's quantizer (regnd._np_quant in double,
    // shortened as the note says), the mean flush's index shift and the
    // regression merge (engine.py:976-980)
    template <class Path>
    __device__ __forceinline__ double point(Path, const Args& a, int,
                                            const In& x, int i, int j, int k,
                                            double A, double, double B,
                                            double D, double C, double E,
                                            double F, double G_,
                                            int* t) const {
      const double z = 0.0;
      const bool iz = i == 0, jz = j == 0, kz = k == 0;
      A = kz ? z : A;
      B = jz ? z : B;
      C = iz ? z : C;
      D = (jz | kz) ? z : D;
      E = (iz | jz) ? z : E;
      F = (iz | kz) ? z : F;
      G_ = (iz | jz | kz) ? z : G_;
      double p = __dadd_rn(A, B);
      p = __dadd_rn(p, C);
      p = __dsub_rn(p, D);
      p = __dsub_rn(p, F);
      p = __dsub_rn(p, E);
      p = __dadd_rn(p, G_);
      if constexpr (kDec) {
        return x.f0 ? x.x : __dadd_rn(p, x.x);
      } else {
        const double cur = x.x;
        const double diff = __dsub_rn(cur, p);
        const double itv = __dadd_rn(__dmul_rn(fabs(diff), a.recip), 1.0);
        const bool within = itv < a.cap_szf;
        const double h = trunc(__dmul_rn(diff < 0.0 ? -itv : itv, 0.5));
        double rec = __dadd_rn(p, __dmul_rn(__dadd_rn(h, h), a.rp));
        const bool ok = within && (fabs(__dsub_rn(cur, rec)) <= a.rp);
        int tq = ok ? __double2int_rz(h) + a.radius : 0;
        rec = ok ? rec : cur;
        if (a.mean_mask) {
          if (tq != 0 && tq <= a.radius) tq -= 1;
          if (x.f1) {
            tq = a.radius;
            rec = a.mean;
          }
        }
        *t = x.f0 ? x.t : tq;
        return x.f0 ? cur : rec;
      }
    }

    // K1d: the type over the consumed t_reg (an unconditional store: a
    // regression point's t_reg read back and stored measured faster than
    // a store at the other points alone)
    __device__ __forceinline__ void keep(unsigned char* st, int e, const In&,
                                         int t) const {
      if constexpr (!kDec) reinterpret_cast<int*>(st + kOffT)[e] = t;
    }

    __device__ __forceinline__ void out(const Args& a,
                                        const unsigned char* st, int e,
                                        long long gi) const {
      if constexpr (!kDec)
        a.t_out[gi] = reinterpret_cast<const int*>(st + kOffT)[e];
    }
  };
};

// K1d and K2d, each rank its own name (chip_smoke.DEVICE_NAMES lists
// them).
__global__ void __launch_bounds__(LorenzoStrip<2, false>::W * 32)
    wavefront_quantize2d_f64_kernel(strips::Geo<double> g,
                                    StripQuantArgs a) {
  strips::run_strips<LorenzoStrip<2, false>>(g, a);
}

__global__ void __launch_bounds__(LorenzoStrip<3, false>::W * 32)
    wavefront_quantize3d_f64_kernel(strips::Geo<double> g,
                                    StripQuantArgs a) {
  strips::run_strips<LorenzoStrip<3, false>>(g, a);
}

__global__ void __launch_bounds__(LorenzoStrip<2, true>::W * 32)
    wavefront_decode2d_f64_kernel(strips::Geo<double> g,
                                  StripDecodeArgs a) {
  strips::run_strips<LorenzoStrip<2, true>>(g, a);
}

__global__ void __launch_bounds__(LorenzoStrip<3, true>::W * 32)
    wavefront_decode3d_f64_kernel(strips::Geo<double> g,
                                  StripDecodeArgs a) {
  strips::run_strips<LorenzoStrip<3, true>>(g, a);
}

// One K1d or K2d launch on a lattice of `rank` (3: r1 x r2 x r3; 2: one
// plane of r2 x r3).
template <bool kDec>
int launch_strips(const typename LorenzoStrip<3, kDec>::Args& a, int rank,
                  int r1, int r2, int r3, const int* order, int* flags,
                  double* rows, double* planes, int nunits, void* stream) {
  strips::Geo<double> g;
  const int rc =
      rank == 2
          ? strips::make_geo<LorenzoStrip<2, kDec>::W>(
                &g, rank, 1, r1, r2, r3, order, flags, rows, planes, nunits)
          : strips::make_geo<LorenzoStrip<3, kDec>::W>(
                &g, rank, 1, r1, r2, r3, order, flags, rows, planes, nunits);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (kDec) {
    return rank == 2 ? strips::launch<LorenzoStrip<2, true>>(
                           wavefront_decode2d_f64_kernel, g, a, st)
                     : strips::launch<LorenzoStrip<3, true>>(
                           wavefront_decode3d_f64_kernel, g, a, st);
  } else {
    return rank == 2 ? strips::launch<LorenzoStrip<2, false>>(
                           wavefront_quantize2d_f64_kernel, g, a, st)
                     : strips::launch<LorenzoStrip<3, false>>(
                           wavefront_quantize3d_f64_kernel, g, a, st);
  }
}

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
  return r1 > 1 ? launch(wavefront_quantize_kernel<LorenzoGeo<3>>, a,
                         r1, r2, r3, order, flags, ntiles, st)
                : launch(wavefront_quantize_kernel<LorenzoGeo<2>>, a,
                         r1, r2, r3, order, flags, ntiles, st);
}

extern "C" int sz_wavefront_decode(const unsigned char* known_mask,
                                   const float* known, const float* q_lor,
                                   float* R, int r1, int r2, int r3,
                                   const int* order, int* flags, int ntiles,
                                   void* stream) {
  DecodeArgs<float> a{known_mask, known, q_lor, R};
  cudaStream_t st = (cudaStream_t)stream;
  return r1 > 1 ? launch(wavefront_decode_kernel<LorenzoGeo<3>>, a,
                         r1, r2, r3, order, flags, ntiles, st)
                : launch(wavefront_decode_kernel<LorenzoGeo<2>>, a,
                         r1, r2, r3, order, flags, ntiles, st);
}

// K1d / K2d: rank 3 (r1 x r2 x r3) or 2 (r1 = 1); order: int32[nunits],
// the strip units in claim order (gpu/strips.strip_order with
// LorenzoStrip::W); flags: int32[nunits * (W + 1) + 1], zero; rows,
// planes: double scratch (gpu/strips.scratch_sizes); R null: K1d writes
// the types alone.
extern "C" int sz_wavefront_quantize_f64(
    const double* data, const int* t_reg, const double* rec_reg,
    const unsigned char* reg, const unsigned char* mean_mask, int* t_out,
    double* R, int rank, int r1, int r2, int r3, double rp, double recip,
    double cap_szf, double mean, int radius, int use_mean, const int* order,
    int* flags, double* rows, double* planes, int nunits, void* stream) {
  StripQuantArgs a{data, t_reg, rec_reg, reg,
                   use_mean ? mean_mask : nullptr,
                   t_out, R, (long long)r1 * r2 * r3, rp, recip, cap_szf,
                   mean, radius};
  return launch_strips<false>(a, rank, r1, r2, r3, order, flags, rows,
                              planes, nunits, stream);
}

extern "C" int sz_wavefront_decode_f64(const unsigned char* known_mask,
                                       const double* known,
                                       const double* q_lor, double* R,
                                       int rank, int r1, int r2, int r3,
                                       const int* order, int* flags,
                                       double* rows, double* planes,
                                       int nunits, void* stream) {
  StripDecodeArgs a{known_mask, known, q_lor, R, (long long)r1 * r2 * r3};
  return launch_strips<true>(a, rank, r1, r2, r3, order, flags, rows,
                             planes, nunits, stream);
}
