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
// Design: warp strips, neighbours in registers, hand-offs by chunk.
// - A warp walks a strip: lane l owns row j0 + l of one plane i and
//   walks k skewed by its lane, k = s - l at step s.  A and A2 are the
//   lane's own last two results; B comes from lane l - 1 by
//   __shfl_up_sync (its result of the previous step) and D is the B of
//   the previous step; C and E are read from plane i - 1's ring (rows l
//   and l - 1 of the same strip), F and G are the C and E of the
//   previous step.  Every lane runs every shuffle; only the arithmetic
//   is predicated at the ragged ramps.  Lane 0 takes B (and E) from the
//   row above the strip, the ring's row -1.  A group of steps first
//   loads all its inputs from the rings into registers, so no shared
//   load sits on the chain, and stores its results after.
// - Rings.  Each warp keeps its results in a ring of 33 rows (row -1:
//   the row above the strip) x kRing slots, row r's column k at slot
//   (k + r) mod kRing, so that every lane of a step reads and writes one
//   slot index (pitch kRing + 1: 32 banks).  Its inputs (K10's data,
//   K11's types) are staged the same way, a chunk of kChunk columns x 32
//   rows at a time by cp.async, the next chunk loading while the lanes
//   walk this one; K10 writes each type over its consumed value, and the
//   types (and R, when asked for) go back to device memory from the
//   rings, a whole chunk at a time, coalesced.
// - Blocks.  Rank 3: a block's W warps (Warps) walk W consecutive
//   planes of one strip; warp w reads plane i - 1 from warp w - 1's ring
//   once that warp's progress mark (a shared-memory counter raised,
//   release, every Group steps) has passed the group, and warp w - 1
//   runs at most a ring's length ahead of warp w.  Rank 2: the warps
//   walk W consecutive strips, lane 31 of warp w writing the row above
//   warp w + 1's strip into that warp's ring.  No __syncthreads runs
//   inside the step loop.
// - Between blocks: each block publishes the last row of each of its
//   planes (rank 2: of its last strip) by column chunks once complete
//   (lane 31 ends a chunk 31 steps after lane 0), and, rank 3, its last
//   plane by slot chunks (slot = column + row: what the next group's
//   warp 0 reads in one phase, complete 16 steps after its first), into
//   device scratch, each chunk followed by a release flag (the count of
//   chunks published); a consumer waits on the flag (acquire, with
//   __nanosleep backoff) and reads the chunk with __ldcg.
// - One launch a call: work units (volume, plane group, strip group)
//   are claimed from a global counter in the order classic_kernel.
//   strip_order makes (by diagonal g + s, then volume, so a 4-D field's
//   volumes run side by side), every unit's predecessors earlier, so a
//   block waits only on units that running blocks claimed.
// - K11 reads the escapes compact, in raster order: a lane takes its
//   row's first escape rank from row_base (the exclusive scan of the
//   rows' escape counts) and counts on along the row, the next value
//   loaded ahead.
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

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLanes = 32;      // rows of a strip, one a lane
constexpr int kChunk = 16;      // columns a chunk: staging, output, hand-off
constexpr int kRing = 64;       // slots of a ring row (a power of 2)
constexpr int kPitch = kRing + 1;
constexpr int kDone = 1 << 30;  // the progress mark of a finished warp

// Steps between two progress marks of a warp: a rank-3 warp's plane is
// read by the next warp a group behind, a rank-2 warp's last row 32
// steps behind.
template <int kRank>
struct Group {
  static constexpr int n = kRank == 3 ? 4 : 8;
};

// Warps a block: W planes (rank 3) or strips (rank 2).  The rings
// take (33 + 32) x 65 entries a warp; float blocks fit two an SM.
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
template <bool kDbl, class V>
__device__ __forceinline__ int quantize(V cur, V pred, const Quantizer<V>& q,
                                        V* rec) {
  const V diff = sub_rn(cur, pred);
  const double m = __dadd_rn(__dmul_rn(fabs((double)diff), q.recip64), 1.0);
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

// The lattice of a launch and its units: nvol volumes of r1 x r2 x r3
// (rank 2: r1 = 1, nvol = 1); per volume ng plane groups x ns strip
// groups (rank 3: groups of W planes and single strips; rank 2: one
// plane, groups of W strips); nchunks = ceil(r3 / kChunk).
// rows: the published last rows, [nvol][ns][r1][r3]; planes: the
// published last planes by slot (column + row), [nvol][ng][r2][r3 + 32];
// flags: [nunits][W + 1] (column chunks of warp w's last row, then
// slot chunks of the plane) and the claim counter.
template <class V>
struct Geo {
  int nvol, r1, r2, r3, ng, ns, nunits, nchunks;
  const int* order;
  int* flags;
  V* rows;
  V* planes;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Waits until a unit's flag counts `need` chunks.
__device__ __forceinline__ void wait_flag(const int* f, int need) {
  int ns = 32;
  while (ld_acquire(f) < need) {
    __nanosleep(ns);
    if (ns < 512) ns *= 2;
  }
}

// In-block progress marks: a warp's lanes store into its rings, then
// __syncwarp and lane 0 raises the mark (release); a reader spins on it
// (acquire).
__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}

// Waits until an in-block warp's progress mark reaches `need`.
__device__ __forceinline__ void wait_mark(const int* m, int need) {
  while (ld_acquire_cta(m) < need) {
  }
}

template <class S>
__device__ __forceinline__ void cp_async(S* dst, const S* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(S) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// All but the latest committed group have landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A staged slot as the type K10 writes over its consumed value.
template <class S>
__device__ __forceinline__ int* type_at(S* slot) {
  return reinterpret_cast<int*>(slot);
}

// A form: rank, value type, double arithmetic, decode.  S is the staged
// input (K10's data, K11's types); the rings of a block are W + 1
// value rings (ring 0 the plane above warp 0, read from device memory;
// ring w + 1 warp w's) and W staging rings.
template <int kRank, class V, bool kDbl, bool kDec>
struct Form {
  using S = typename std::conditional<kDec, int, V>::type;
  using Args = typename std::conditional<kDec, DecodeArgs<V>,
                                         QuantArgs<V>>::type;
  static constexpr int W = Warps<V>::n;
  static constexpr int kRingV = (kLanes + 1) * kPitch;
  static constexpr int kRingS = kLanes * kPitch;
  static constexpr size_t bytes = (size_t)(W + 1) * kRingV * sizeof(V) +
                                  (size_t)W * kRingS * sizeof(S) +
                                  (size_t)(W + 1) * sizeof(int);
};

// Warp w's walk of unit u = (v, gi, si).
template <int kRank, class V, bool kDbl, bool kDec>
__device__ __forceinline__ void walk(
    const Geo<V>& g, const typename Form<kRank, V, kDbl, kDec>::Args& a,
    int u, int v, int gi, int si, V* rings,
    typename Form<kRank, V, kDbl, kDec>::S* stage, int* mark) {
  using F = Form<kRank, V, kDbl, kDec>;
  using S = typename F::S;
  constexpr int W = F::W;
  constexpr int kG = Group<kRank>::n;
  constexpr int kMask = kRing - 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = kRank == 3 ? gi * W + w : 0;
  const int j0 = kLanes * (kRank == 3 ? si : si * W + w);
  if (i >= g.r1 || j0 >= g.r2) {
    if (lane == 0) st_release_cta(mark + w, kDone);
    return;
  }
  const int rows = min(kLanes, g.r2 - j0);
  const int r3 = g.r3;
  V* up = rings + w * F::kRingV;  // plane i - 1: ring 0 or warp w - 1's
  V* own = up + F::kRingV;        // this warp's; row -1 the row above
  V* next = own + F::kRingV;      // (rank 2) warp w + 1's
  S* st = stage + w * F::kRingS;
  const bool has_next = w + 1 < W;
  const bool feed_next =
      kRank == 2 && has_next && rows == kLanes && j0 + kLanes < g.r2;
  const long long row0 = (long long)(v * g.r1 + i) * g.r2 + j0;
  const long long base = row0 * r3;
  const int nc = g.nchunks;
  const int last_step = r3 + rows - 2;
  const int xs = r3 + kLanes;                          // slots a plane row
  const int nsc = (last_step + kChunk) / kChunk;       // slot chunks
  const int* src_flag = nullptr;  // the row above the strip: its flag
  const V* src_row = nullptr;     // and its values
  if (si > 0 && (kRank == 3 || w == 0)) {
    src_flag = g.flags + (u - 1) * (W + 1) + (kRank == 3 ? w : W - 1);
    src_row = g.rows + ((long long)(v * g.ns + si - 1) * g.r1 + i) * r3;
  }
  const bool pub_rows = (kRank == 3 || w == W - 1) && si + 1 < g.ns;
  const bool pub_plane = kRank == 3 && w == W - 1 && gi + 1 < g.ng;
  const S* src = nullptr;
  if constexpr (kDec)
    src = a.types;
  else
    src = a.data;

  // chunk c of the inputs into the staging ring: half a warp a row
  auto stage_chunk = [&](int c) {
    const int col = c * kChunk + (lane & 15);
    const long long gx = base + col;
#pragma unroll 4
    for (int rr = 0; rr < (rows + 1) / 2; ++rr) {
      const int r = 2 * rr + (lane >> 4);
      if (r < rows && col < r3)
        cp_async(st + r * kPitch + ((col + r) & kMask),
                 src + gx + (long long)r * r3);
    }
  };

  // chunk c, complete: the types, R where asked for, the published last
  // row and its flag
  auto output = [&](int c) {
    const int col = c * kChunk + (lane & 15);
    const long long gx = base + col;
    V* prow = g.rows + ((long long)(v * g.ns + si) * g.r1 + i) * r3 + col;
#pragma unroll 4
    for (int rr = 0; rr < (rows + 1) / 2; ++rr) {
      const int r = 2 * rr + (lane >> 4);
      if (r < rows && col < r3) {
        const int x = (col + r) & kMask;
        if constexpr (!kDec)
          a.types[gx + (long long)r * r3] = *type_at(st + r * kPitch + x);
        const V val = own[(r + 1) * kPitch + x];
        if (a.R) a.R[gx + (long long)r * r3] = val;
        if (pub_rows && r == kLanes - 1) *prow = val;
      }
    }
    if (pub_rows) {
      __syncwarp();
      if (lane == 0) st_release(g.flags + u * (W + 1) + w, c + 1);
    }
  };

  // (rank 3, the block's last plane) slot chunk c of the ring, rows as
  // they lie there (slot = column + row): what the next group's warp 0
  // reads in phase c, complete after step kChunk * c + kChunk - 1
  auto publish_plane = [&](int c) {
    const int x = c * kChunk + (lane & 15);
    V* pl = g.planes + ((long long)(v * g.ng + gi) * g.r2 + j0) * xs;
#pragma unroll 4
    for (int rr = 0; rr < (rows + 1) / 2; ++rr) {
      const int r = 2 * rr + (lane >> 4);
      if (r < rows && x - r >= 0 && x - r < r3)
        pl[(long long)r * xs + x] = own[(r + 1) * kPitch + (x & kMask)];
    }
    __syncwarp();
    if (lane == 0) st_release(g.flags + u * (W + 1) + W, c + 1);
  };

  // column chunk c of the row above the strip (own ring row -1) and,
  // for warp 0 of a rank-3 block past the first group, of plane i - 1's
  // row above (ring 0's row -1)
  auto halo = [&](int c) {
    const int col = c * kChunk + lane;
    if (src_row) {
      wait_flag(src_flag, c + 1);
      if (lane < kChunk && col < r3)
        own[(col - 1) & kMask] = __ldcg(src_row + col);
    }
    if (kRank == 3 && w == 0 && gi > 0 && si > 0) {
      wait_flag(g.flags + (u - g.ns - 1) * (W + 1) + W - 1, c + 1);
      if (lane < kChunk && col < r3)
        up[(col - 1) & kMask] = __ldcg(
            g.rows + ((long long)(v * g.ns + si - 1) * g.r1 + i - 1) * r3 +
            col);
    }
  };

  // (warp 0 of a rank-3 block past the first group) slot chunk c of
  // plane i - 1, as the previous group's last warp published it, into
  // ring 0
  auto plane_above = [&](int c) {
    wait_flag(g.flags + (u - g.ns) * (W + 1) + W, c + 1);
    const V* pl = g.planes + ((long long)(v * g.ng + gi - 1) * g.r2 + j0) * xs;
    const int x = c * kChunk + (lane & 15);
    V val[kLanes / 2];
#pragma unroll
    for (int rr = 0; rr < kLanes / 2; ++rr) {
      const int r = 2 * rr + (lane >> 4);
      if (r < rows && x < xs) val[rr] = __ldcg(pl + (long long)r * xs + x);
    }
#pragma unroll
    for (int rr = 0; rr < kLanes / 2; ++rr) {
      const int r = 2 * rr + (lane >> 4);
      if (r < rows && x < xs) up[(r + 1) * kPitch + (x & kMask)] = val[rr];
    }
  };

  // K11: this lane's next escape (the rows' ranks from row_base).  A
  // rank past the stream reads its last value, as _decode_fn clips; an
  // empty stream reads none.
  long long eidx = 0;
  V enext = V(0);
  auto escape = [&](long long rank) {
    if constexpr (kDec)
      return a.n_esc > 0 ? __ldg(a.esc + min(rank, a.n_esc - 1)) : V(0);
    else
      return V(0);
  };
  if constexpr (kDec) {
    if (lane < rows) eidx = a.row_base[row0 + lane];
    enext = escape(eidx);
  }

  V A = V(0), A2 = V(0), Bp = V(0), Cp = V(0), Ep = V(0);

  // One group of kG steps from step s.
  auto group = [&](int s) {
    if (w > 0) wait_mark(mark + w - 1, s + kG + (kRank == 3 ? 0 : 31));
    if (has_next) wait_mark(mark + w + 1, s + kG - (kRank == 3 ? 63 : 95));
    // the group's inputs, all ready now, loaded before any of its
    // stores: the staged values or types, the row above (row -1) and,
    // rank 3, plane i - 1 (C at slot s, E one row up at slot s - 1)
    S xin[kG];
    V hbv[kG], Cv[kG], Ev[kG], erv[kG];
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int x = (s + q) & kMask, xm = (s + q - 1) & kMask;
      xin[q] = st[lane * kPitch + x];
      if constexpr (!kDec) erv[q] = esc_recon(xin[q], a.median, a.mask);
      hbv[q] = own[xm];
      if constexpr (kRank == 3) {
        Cv[q] = up[(lane + 1) * kPitch + x];
        Ev[q] = up[lane * kPitch + xm];
      } else {
        Cv[q] = Ev[q] = V(0);
      }
    }
    V Rv[kG], ev[kG];
    int tv[kG];
    // the point steps: registers and shuffles only; with esc_path, a
    // type 0 takes its escape value from ev
    auto run = [&](auto esc_path) {
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const int k = s + q - lane;
        V B = __shfl_up_sync(kFull, A, 1);
        if (lane == 0) B = hbv[q];
        const int j = j0 + lane;
        const V pred = predict(i, j, k, A, A2, B, Bp, Cv[q], Ev[q], Cp, Ep);
        V R;
        if constexpr (kDec) {
          R = recon<kDbl>(pred, step_of<kDbl>(xin[q], a.q));
          if constexpr (decltype(esc_path)::value)
            if (xin[q] == 0) R = ev[q];
        } else {
          const V cur = xin[q];
          V rec;
          int t = quantize<kDbl>(cur, pred, a.q, &rec);
          if ((i | j | k) == 0) t = 0;
          R = t ? rec : erv[q];
          tv[q] = t;
        }
        Rv[q] = R;
        A2 = A;
        A = R;
        Bp = B;
        Cp = Cv[q];
        Ep = Ev[q];
      }
    };
    if constexpr (kDec) {
      // K11's escapes in the group, a lane's consecutive in the compact
      // stream: the first is enext (loaded ahead), the rest are loaded
      // here; a group with none takes the path without
      unsigned em = 0;
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const int k = s + q - lane;
        if (lane < rows && k >= 0 && k < r3 && xin[q] == 0) em |= 1u << q;
      }
      if (__any_sync(kFull, em != 0)) {
#pragma unroll
        for (int q = 0; q < kG; ++q) {
          const int before = __popc(em & ((1u << q) - 1));
          ev[q] = V(0);
          if ((em >> q) & 1)
            ev[q] = before == 0 ? enext : escape(eidx + before);
        }
        run(std::true_type{});
        if (em) {
          eidx += __popc(em);
          enext = escape(eidx);
        }
      } else {
        run(std::false_type{});
      }
    } else {
      run(std::false_type{});
    }
    // the group's results into the rings
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int x = (s + q) & kMask;
      const int k = s + q - lane;
      const bool act = lane < rows && k >= 0 && k < r3;
      if (act) {
        own[(lane + 1) * kPitch + x] = Rv[q];
        if constexpr (!kDec) *type_at(st + lane * kPitch + x) = tv[q];
      }
      if (feed_next && lane == kLanes - 1 && act)
        next[(s + q - kLanes) & kMask] = Rv[q];
    }
    __syncwarp();
    if (lane == 0) st_release_cta(mark + w, s + kG);
  };

  // Phase p: steps kChunk p to kChunk p + kChunk - 1; its start writes
  // out chunk p - 3 (complete) and publishes slot chunk p - 1 of the
  // last plane, stages chunk p + 1, and loads chunk p of the rows above
  // (while the producing warp runs ahead: this warp waits for it next).
  stage_chunk(0);
  cp_async_commit();
  for (int p = 0; p < nc + 3; ++p) {
    const int s0 = p * kChunk;
    if (p >= 3) output(p - 3);
    if (pub_plane && p >= 1 && p - 1 < nsc) publish_plane(p - 1);
    __syncwarp();
    if (p + 1 < nc) stage_chunk(p + 1);
    cp_async_commit();
    cp_async_wait_prior();  // chunk p has landed
    __syncwarp();
    if (p < nc) {
      // the ring's row -1 overwrites slots warp w + 1 read as E
      if (kRank == 3 && has_next) wait_mark(mark + w + 1, s0 - 48);
      halo(p);
    }
    if (kRank == 3 && w == 0 && gi > 0 && p < nsc) plane_above(p);
    __syncwarp();
    for (int s = s0; s < s0 + kChunk && s <= last_step; s += kG) group(s);
  }
  cp_async_wait_all();
  __syncwarp();
  if (lane == 0) st_release_cta(mark + w, kDone);
}

// The persistent loop: claim a unit, walk it, until none is left.
template <int kRank, class V, bool kDbl, bool kDec>
__device__ __forceinline__ void run_strips(
    const Geo<V>& g, const typename Form<kRank, V, kDbl, kDec>::Args& a) {
  using F = Form<kRank, V, kDbl, kDec>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* rings = reinterpret_cast<V*>(smem);
  typename F::S* stage =
      reinterpret_cast<typename F::S*>(rings + (F::W + 1) * F::kRingV);
  int* mark = reinterpret_cast<int*>(stage + F::W * F::kRingS);
  int* claimed = mark + F::W;
  int* counter = g.flags + g.nunits * (F::W + 1);
  while (true) {
    if (threadIdx.x == 0) *claimed = atomicAdd(counter, 1);
    if ((threadIdx.x & 31) == 0) mark[threadIdx.x >> 5] = 0;
    __syncthreads();
    const int n = *claimed;
    if (n >= g.nunits) break;
    const int u = g.order[n];
    const int si = u % g.ns, gi = (u / g.ns) % g.ng, v = u / (g.ns * g.ng);
    walk<kRank, V, kDbl, kDec>(g, a, u, v, gi, si, rings, stage, mark);
    __syncthreads();
  }
}

// Each form and rank its own __global__ name (the profile tells them
// apart; chip_smoke.DEVICE_NAMES lists them).
__global__ void __launch_bounds__(Warps<float>::n * 32) classic_quantize2d_kernel(
    Geo<float> g, QuantArgs<float> a) {
  run_strips<2, float, false, false>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_quantize3d_kernel(
    Geo<float> g, QuantArgs<float> a) {
  run_strips<3, float, false, false>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_quantize4d_kernel(
    Geo<float> g, QuantArgs<float> a) {
  run_strips<3, float, true, false>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_quantize2d_f64_kernel(
    Geo<double> g, QuantArgs<double> a) {
  run_strips<2, double, true, false>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_quantize3d_f64_kernel(
    Geo<double> g, QuantArgs<double> a) {
  run_strips<3, double, true, false>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_decode2d_kernel(
    Geo<float> g, DecodeArgs<float> a) {
  run_strips<2, float, false, true>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_decode3d_kernel(
    Geo<float> g, DecodeArgs<float> a) {
  run_strips<3, float, false, true>(g, a);
}

__global__ void __launch_bounds__(Warps<float>::n * 32) classic_decode4d_kernel(
    Geo<float> g, DecodeArgs<float> a) {
  run_strips<3, float, true, true>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_decode2d_f64_kernel(
    Geo<double> g, DecodeArgs<double> a) {
  run_strips<2, double, true, true>(g, a);
}

__global__ void __launch_bounds__(Warps<double>::n * 32) classic_decode3d_f64_kernel(
    Geo<double> g, DecodeArgs<double> a) {
  run_strips<3, double, true, true>(g, a);
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

// The unit grid of a lattice: per volume (ng, ns) as Geo's note says.
template <class V>
int make_geo(Geo<V>* g, int rank, int nvol, int r1, int r2, int r3,
             const int* order, int* flags, V* rows, V* planes, int nunits) {
  constexpr int W = Warps<V>::n;
  const int strips = (r2 + kLanes - 1) / kLanes;
  g->nvol = nvol, g->r1 = rank == 2 ? 1 : r1, g->r2 = r2, g->r3 = r3;
  g->ng = rank == 2 ? 1 : (r1 + W - 1) / W;
  g->ns = rank == 2 ? (strips + W - 1) / W : strips;
  g->nchunks = (r3 + kChunk - 1) / kChunk;
  g->order = order, g->flags = flags, g->rows = rows, g->planes = planes;
  g->nunits = nunits;
  if ((rank == 2 && nvol != 1) ||
      (long long)nvol * g->ng * g->ns != nunits)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One launch of `kernel`: W warps a block, as many blocks as can be
// resident (never more than there are units).
template <int kRank, class V, bool kDbl, bool kDec>
int launch(void (*kernel)(Geo<V>,
                          typename Form<kRank, V, kDbl, kDec>::Args),
           const Geo<V>& g,
           const typename Form<kRank, V, kDbl, kDec>::Args& a,
           cudaStream_t st) {
  using F = Form<kRank, V, kDbl, kDec>;
  if (g.nunits == 0) return 0;
  const size_t bytes = F::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    F::W * 32, bytes);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > g.nunits) blocks = g.nunits;
  kernel<<<(unsigned)blocks, F::W * 32, bytes, st>>>(g, a);
  return (int)cudaGetLastError();
}

template <class V, bool kDbl, bool kDec>
int launch_rank(void (*k2)(Geo<V>, typename Form<2, V, kDbl, kDec>::Args),
                void (*k3)(Geo<V>, typename Form<3, V, kDbl, kDec>::Args),
                const typename Form<3, V, kDbl, kDec>::Args& a, int rank,
                int nvol, int r1, int r2, int r3, const int* order,
                int* flags, V* rows, V* planes, int nunits, void* stream) {
  Geo<V> g;
  const int rc = make_geo(&g, rank, nvol, r1, r2, r3, order, flags, rows,
                          planes, nunits);
  if (rc) return rc;
  if (rank == 2)
    return launch<2, V, kDbl, kDec>(k2, g, a, (cudaStream_t)stream);
  return launch<3, V, kDbl, kDec>(k3, g, a, (cudaStream_t)stream);
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
  const int rc = make_geo(&g, 3, nvol, r1, r2, r3, order, flags, rows,
                          planes, nunits);
  if (rc) return rc;
  return launch<3, float, true, false>(classic_quantize4d_kernel, g, a,
                                       (cudaStream_t)stream);
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
  const int rc = make_geo(&g, 3, nvol, r1, r2, r3, order, flags, rows,
                          planes, nunits);
  if (rc) return rc;
  return launch<3, float, true, true>(classic_decode4d_kernel, g, a,
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
