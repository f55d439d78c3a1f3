// K12 ra_encode / K13 ra_decode: the random-access block codec's
// per-block quantization and reconstruction on Hopper (sm_90a).
//
// They replace the JAX package's XLA scans sz_tpu/tpu/ra_engine.py
// _encode_fn (:86) and _decode_fn (:218), whose arithmetic is the RA
// kernels' (sz_float.c:9751-9766 SZ_compress_float_3D_MDQ_decompression_
// random_access_with_blocked_regression and its 1-D/2-D twins,
// szd_float.c:6567/6872/7213; host form sz_tpu/core/rablock.py
// _quant_cell):
//   predictor: regression blocks qc0*ii + qc1*jj + qc2*kk + qc3, a float
//     chain left to right, no FMA; Lorenzo blocks the float Lorenzo
//     stencil over the block's own reconstruction, zero outside the
//     block (blocks are independent), in the C's operand order;
//   quantizer, in double: diff = f64(cur - pred) (a float subtraction),
//     itv = |diff| / rp + 1, within = itv < cap (cap - 2 on Lorenzo
//     blocks), t = trunc(+-itv / 2) + radius, rec = f32(f64(pred) +
//     f64(2 (t - radius)) * rp), kept when within and
//     |f64(cur - rec)| <= rp, else an escape (t = 0, rec = cur); with
//     use_mean a Lorenzo point within rp of the mean takes type 1 and
//     the mean;
//   decode: val = f32(f64(pred) + f64(2 (t - radius)) * rp), the mean
//     for a Lorenzo type 1 under use_mean, the escape's value for t = 0.
//
// Design.  Every block is independent, so the work is the cells' own
// arithmetic and the bytes: each block's values (K12) or types (K13)
// read once, its types (K12) or the region's values (K13) written once.
// - Ranks 3 and 2 (6^3 and 16^2 cells): a warp takes a block (at rank 2
//   half a warp a block, two blocks a warp, measured slower).  It loads
//   the block's contiguous values or types with 16-byte loads, all
//   issued before any is used (the block starts 16-byte aligned: 864 B
//   or 1 KB), and stages them in shared memory.
//   Regression blocks have no recurrence: lane l takes cells l, l + 32,
//   ...  Lorenzo blocks walk the block's anti-diagonals i + j (+ k) = d,
//   lane l on the d-th diagonal's l-th cell, reading its neighbours from
//   a bordered (bs+1)^rank reconstruction in shared memory that is zero
//   on the border; every stencil neighbour lies on an earlier diagonal,
//   so the cells of one diagonal are independent and the result is the
//   raster walk's, bit for bit.  The (diagonal, lane) -> cell table
//   comes from ra_kernel.diag_table (a device tensor), so the CPU tests
//   check the very table read here.  K12 writes its types back from
//   shared memory with 16-byte stores.
// - Rank 1 (256 cells): the Lorenzo chain is serial within a block and
//   rounds f32(f64(prev) + ...) at every step, so no scan keeps its
//   bits: a lane keeps a block.  A warp takes 32 consecutive blocks and
//   stages them through a 32 x 33 tile in chunks of 32 cells a block,
//   one 128-byte load a block, the next chunk's loads in flight while
//   the lanes walk this one; the types (K12) or values (K13) go back
//   through the same tile, coalesced.
// - K13 reads the compact escape stream: unpred (the escapes in stream
//   order) and esc_base (each selected block's first escape).  A cell's
//   escape rank in its block is its raster rank among the block's
//   type-0 cells: a ballot and popc over each 32-cell raster chunk plus a
//   running count (a lane's own count at rank 1); a block with no type 0
//   skips the ballots.  Escapes go straight into the block's
//   reconstruction buffer before the walk.  An escape past the end of
//   unpred (a corrupt stream) decodes to NaN and adds one to *bad, as
//   the plain version counts it; the engine raises on a count.
// - K13 writes the region in the field's row-major layout, cropped to
//   [start, end): a CTA takes kSpan consecutive blocks along the last
//   axis of the selection and, after __syncthreads, writes whole rows
//   of its span (kSpan * bs cells; a thread keeps its column) from the
//   blocks' buffers, coalesced.
//
// Bound on this card: bytes (K12 8 bytes a padded cell; K13 4 a padded
// cell read and 4 a region cell written, plus the escapes).  Measured
// (PERF.md) at 1.6-1.8 times that at 512^3: what is left is the issue of
// the quantizer's double division and conversions a cell, and at rank 1
// the 256-step chain of each of only nb / 32 warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;                // rank 1: cells a block a stage
constexpr unsigned kNaN = 0x7fc00000u;    // torch's NaN, the plain version's

struct Quant {
  double rp;
  int cap, radius, use_mean;
  float mean;
};

// The selection's block grid, the crop's offset in the block-aligned
// lattice and the region's extents; axes past the rank are 1 / 0 / 1.
struct Region {
  int grid[3], lo[3], ext[3];
};

// The regression predictor of cell (ii, jj, kk) from the block's four
// (rank 3), three (rank 2) or two (rank 1) coefficients.
template <int kRank>
__device__ __forceinline__ float reg_pred(const float* q, int ii, int jj,
                                          int kk) {
  if (kRank == 3)
    return __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(q[0], (float)ii),
                            __fmul_rn(q[1], (float)jj)),
                  __fmul_rn(q[2], (float)kk)),
        q[3]);
  if (kRank == 2)
    return __fadd_rn(__fadd_rn(__fmul_rn(q[0], (float)ii),
                               __fmul_rn(q[1], (float)jj)),
                     q[2]);
  return __fadd_rn(__fmul_rn(q[0], (float)ii), q[1]);
}

// f32(f64(pred) + f64(2 (t - radius)) * rp)
__device__ __forceinline__ float rebuild(float pred, int t, const Quant& c) {
  return __double2float_rn(__dadd_rn(
      (double)pred, __dmul_rn((double)(2 * (t - c.radius)), c.rp)));
}

// One quantized point: its type, and its reconstruction in *rec.  Written
// with selects, not branches: at rank 1 the lanes of a warp walk
// different blocks, and branches would split them.
__device__ __forceinline__ int quant(float cur, float pred, bool lor,
                                     const Quant& c, float* rec) {
  const float fd = __fsub_rn(cur, pred);
  const double itv = __dadd_rn(__ddiv_rn(fabs((double)fd), c.rp), 1.0);
  // the truncation only of an in-range interval (0 elsewhere)
  const bool within = itv < (double)(lor ? c.cap - 2 : c.cap);  // not NaN
  const double half = within ? __dmul_rn(fd < 0.0f ? -itv : itv, 0.5) : 0.0;
  const int tq = __double2int_rz(half) + c.radius;
  const float rq = rebuild(pred, tq, c);
  const bool ok = within && fabs((double)__fsub_rn(cur, rq)) <= c.rp;
  const bool flush =
      c.use_mean && lor && fabs((double)__fsub_rn(cur, c.mean)) <= c.rp;
  *rec = flush ? c.mean : ok ? rq : cur;
  return flush ? 1 : ok ? tq : 0;
}

// A block of bs^rank cells (ranks 2 and 3) in shared memory: the staged
// values or types (kCell words), then the bordered reconstruction
// (kRing words, rounded up so that every slot stays 16-byte aligned).
template <int kRank, int kBs>
struct Blk {
  static constexpr int kB1 = kBs + 1;
  static constexpr int kCell = kRank == 3 ? kBs * kBs * kBs : kBs * kBs;
  static constexpr int kRing = kRank == 3 ? kB1 * kB1 * kB1 : kB1 * kB1;
  static constexpr int kSlot = kCell + (kRing + 3) / 4 * 4;
  static constexpr int kDiag = kRank * (kBs - 1) + 1;
  static constexpr int kRows = kCell / kBs;  // rows along the last axis

  // raster cell ci -> its coordinates (kk = 0 at rank 2)
  __device__ static void coords(int ci, int& ii, int& jj, int& kk) {
    if (kRank == 3) {
      ii = ci / (kBs * kBs), jj = ci / kBs % kBs, kk = ci % kBs;
    } else {
      ii = ci / kBs, jj = ci % kBs, kk = 0;
    }
  }
  // the index of (ii, jj, kk) in the bordered reconstruction
  __device__ static int at(int ii, int jj, int kk) {
    if (kRank == 3) return ((ii + 1) * kB1 + jj + 1) * kB1 + kk + 1;
    return (ii + 1) * kB1 + jj + 1;
  }
  __device__ static int self(int ci) {
    int ii, jj, kk;
    coords(ci, ii, jj, kk);
    return at(ii, jj, kk);
  }
  // the regression predictor of cell ci
  __device__ static float reg(const float* q, int ci) {
    int ii, jj, kk;
    coords(ci, ii, jj, kk);
    return reg_pred<kRank>(q, ii, jj, kk);
  }
  // the Lorenzo predictor of the cell at bordered index s, the C's order
  __device__ static float lorenzo(const float* R, int s) {
    if (kRank == 3) {
      constexpr int P = kB1 * kB1;
      float p = __fadd_rn(R[s - 1], R[s - kB1]);
      p = __fadd_rn(p, R[s - P]);
      p = __fsub_rn(p, R[s - kB1 - 1]);
      p = __fsub_rn(p, R[s - P - 1]);
      p = __fsub_rn(p, R[s - P - kB1]);
      return __fadd_rn(p, R[s - P - kB1 - 1]);
    }
    return __fsub_rn(__fadd_rn(R[s - 1], R[s - kB1]), R[s - kB1 - 1]);
  }
};

// An escape's value: unpred[k], or past its end NaN, counted in *bad.
__device__ __forceinline__ float escape(const float* __restrict__ unpred,
                                        long long n_unpred, long long k,
                                        unsigned long long* bad) {
  if (k < n_unpred) return __ldg(unpred + k);
  atomicAdd(bad, 1ull);
  return __uint_as_float(kNaN);
}

// --- ranks 2 and 3: a warp a block ---------------------------------------

// The kVec float4 words a lane stages of a block of kCell words (all
// loads issued before any is used).
template <int kCell>
struct Stage {
  static constexpr int kVec = (kCell / 4 + 31) / 32;
  float4 v[kVec];
  __device__ void load(const void* block, int lane) {
    const float4* p = reinterpret_cast<const float4*>(block);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (lane + 32 * k < kCell / 4) v[k] = __ldg(p + lane + 32 * k);
  }
  __device__ void store(float* st, int lane) const {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (lane + 32 * k < kCell / 4)
        reinterpret_cast<float4*>(st)[lane + 32 * k] = v[k];
  }
  __device__ bool any_zero(int lane) const {  // a type-0 word loaded
    bool z = false;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (lane + 32 * k < kCell / 4)
        z |= !__float_as_int(v[k].x) | !__float_as_int(v[k].y) |
             !__float_as_int(v[k].z) | !__float_as_int(v[k].w);
    return z;
  }
};

// K12: a CTA takes kWarps consecutive blocks.
template <int kRank, int kBs>
__device__ __forceinline__ void encode_group(
    const float* __restrict__ blocks, const uint8_t* __restrict__ lor,
    const float* __restrict__ qc, long long nb,
    const int* __restrict__ diag, const Quant& c, int* __restrict__ types) {
  using B = Blk<kRank, kBs>;
  __shared__ __align__(16) float smem[kWarps][B::kSlot];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarps + w;
  if (b >= nb) return;  // no CTA barrier below
  float* st = smem[w];
  float* R = st + B::kCell;
  Stage<B::kCell> in;
  in.load(blocks + b * B::kCell, lane);
  float q[kRank + 1];
  for (int e = 0; e <= kRank; ++e) q[e] = __ldg(qc + b * (kRank + 1) + e);
  const bool l = __ldg(lor + b) != 0;
  in.store(st, lane);
  if (l)
    for (int e = lane; e < B::kRing; e += 32) R[e] = 0.0f;
  __syncwarp();
  if (!l) {
    for (int ci = lane; ci < B::kCell; ci += 32) {
      float rec;
      st[ci] = __int_as_float(quant(st[ci], B::reg(q, ci), false, c, &rec));
    }
  } else {
    for (int d = 0; d < B::kDiag; ++d) {
      const int ent = __ldg(diag + d * 32 + lane);
      if (ent >= 0) {
        const int ci = ent & 0xffff, s = ent >> 16;
        float rec;
        st[ci] = __int_as_float(quant(st[ci], B::lorenzo(R, s), true, c,
                                      &rec));
        R[s] = rec;
      }
      __syncwarp();
    }
  }
  __syncwarp();
  float4* t4 = reinterpret_cast<float4*>(types + b * B::kCell);
  for (int e = lane; e < B::kCell / 4; e += 32)
    t4[e] = reinterpret_cast<const float4*>(st)[e];
}

// K13: a CTA takes kSpan consecutive blocks along the selection's last
// axis (grid.x = the other axes' blocks times the segments of the last).
template <int kRank, int kBs>
__device__ __forceinline__ void decode_group(
    const int* __restrict__ types, const float* __restrict__ unpred,
    long long n_unpred, const long long* __restrict__ esc_base,
    const uint8_t* __restrict__ lor, const float* __restrict__ qc,
    const int* __restrict__ diag, const Region& g, const Quant& c,
    float* __restrict__ out, unsigned long long* bad) {
  using B = Blk<kRank, kBs>;
  constexpr int kSpan = kWarps, kLast = kRank - 1;
  __shared__ __align__(16) float smem[kSpan][B::kSlot];
  const int lane = threadIdx.x & 31, slot = threadIdx.x >> 5;
  const int glast = g.grid[kLast];
  const int segs = (glast + kSpan - 1) / kSpan;
  const int row = blockIdx.x / segs, seg = blockIdx.x % segs;
  const int bl = seg * kSpan + slot;
  if (bl < glast) {
    const long long b = (long long)row * glast + bl;
    float* st = smem[slot];
    float* R = st + B::kCell;
    Stage<B::kCell> in;
    in.load(types + b * B::kCell, lane);
    float q[kRank + 1];
    for (int e = 0; e <= kRank; ++e) q[e] = __ldg(qc + b * (kRank + 1) + e);
    const bool l = __ldg(lor + b) != 0;
    in.store(st, lane);
    if (l)
      for (int e = lane; e < B::kRing; e += 32) R[e] = 0.0f;
    __syncwarp();
    // the escapes, in raster order, straight into the reconstruction
    long long run =
        __any_sync(0xffffffffu, in.any_zero(lane)) ? __ldg(esc_base + b)
                                                   : -1;
    for (int c0 = 0; run >= 0 && c0 < B::kCell; c0 += 32) {
      const int ci = c0 + lane;
      const bool esc = ci < B::kCell && __float_as_int(st[ci]) == 0;
      const unsigned m = __ballot_sync(0xffffffffu, esc);
      if (esc) {
        const long long k = run + __popc(m & ((1u << lane) - 1));
        R[B::self(ci)] = escape(unpred, n_unpred, k, bad);
      }
      run += __popc(m);
    }
    __syncwarp();
    if (!l) {
      for (int ci = lane; ci < B::kCell; ci += 32) {
        const int t = __float_as_int(st[ci]);
        if (t != 0) R[B::self(ci)] = rebuild(B::reg(q, ci), t, c);
      }
    } else {
      for (int d = 0; d < B::kDiag; ++d) {
        const int ent = __ldg(diag + d * 32 + lane);
        if (ent >= 0) {
          const int ci = ent & 0xffff, s = ent >> 16;
          const int t = __float_as_int(st[ci]);
          if (t != 0) {
            float v = rebuild(B::lorenzo(R, s), t, c);
            if (c.use_mean && t == 1) v = c.mean;
            R[s] = v;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // the span's rows, each kSpan * bs cells along the last axis, kStep rows
  // a pass; a thread keeps its column.  Cells of blocks past the grid lie
  // past the crop (lo + ext <= grid * bs).
  constexpr int kWidth = kSpan * kBs, kStep = kThreads / kWidth;
  const int col = threadIdx.x % kWidth, r0 = threadIdx.x / kWidth;
  const int ol = seg * kWidth + col - g.lo[kLast];
  if (r0 >= kStep || (unsigned)ol >= (unsigned)g.ext[kLast]) return;
  const int w = col / kBs, kk = col - w * kBs;
  const float* src = smem[w] + B::kCell;
  if (kRank == 3) {
    const int i0 = row / g.grid[1] * kBs - g.lo[0];
    const int j0 = row % g.grid[1] * kBs - g.lo[1];
    for (int r = r0; r < B::kRows; r += kStep) {
      const int ii = r / kBs, jj = r - ii * kBs;
      const int o0 = i0 + ii, o1 = j0 + jj;
      if ((unsigned)o0 < (unsigned)g.ext[0] &&
          (unsigned)o1 < (unsigned)g.ext[1])
        out[((long long)o0 * g.ext[1] + o1) * g.ext[2] + ol] =
            src[B::at(ii, jj, kk)];
    }
  } else {
    const int i0 = row * kBs - g.lo[0];
    for (int r = r0; r < B::kRows; r += kStep) {
      const int o0 = i0 + r;
      if ((unsigned)o0 < (unsigned)g.ext[0])
        out[(long long)o0 * g.ext[1] + ol] = src[B::at(r, kk, 0)];
    }
  }
}

// --- rank 1: a lane a block -----------------------------------------------

// The tile rows r < rows of a warp's 32 blocks, cells c0.. of each, kept
// in registers (all loads issued before any is used).
struct Rows {
  float v[32];
  template <class T>
  __device__ void load(const T* base, long long b0, int rows, int kBs,
                       int c0, int lane) {
#pragma unroll
    for (int r = 0; r < 32; ++r)
      if (r < rows)
        v[r] = __int_as_float(__ldg(reinterpret_cast<const int*>(
            base + (b0 + r) * kBs + c0 + lane)));
  }
  __device__ void store(float (*T)[kChunk + 1], int rows, int lane) const {
#pragma unroll
    for (int r = 0; r < 32; ++r)
      if (r < rows) T[r][lane] = v[r];
  }
};

// K12: a warp takes 32 consecutive blocks of kBs cells.
template <int kBs>
__device__ __forceinline__ void encode_lanes(
    const float* __restrict__ blocks, const uint8_t* __restrict__ lor,
    const float* __restrict__ qc, long long nb, const Quant& c,
    int* __restrict__ types) {
  __shared__ float tile[kWarps][32][kChunk + 1];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b0 = ((long long)blockIdx.x * kWarps + w) * 32;
  if (b0 >= nb) return;  // whole warps only: the syncs below are warp-wide
  const int rows = (int)min(32LL, nb - b0);
  const long long b = b0 + lane;
  const bool live = lane < rows;
  float q[2] = {0.0f, 0.0f};
  bool l = false;
  if (live) {
    q[0] = __ldg(qc + 2 * b), q[1] = __ldg(qc + 2 * b + 1);
    l = __ldg(lor + b) != 0;
  }
  float(*T)[kChunk + 1] = tile[w];
  Rows next;
  next.load(blocks, b0, rows, kBs, 0, lane);
  float prev = 0.0f;
  for (int c0 = 0; c0 < kBs; c0 += kChunk) {
    next.store(T, rows, lane);
    __syncwarp();
    if (c0 + kChunk < kBs)
      next.load(blocks, b0, rows, kBs, c0 + kChunk, lane);
    if (live) {
      for (int s = 0; s < kChunk; ++s) {
        const float cur = T[lane][s];
        const float pred =
            l ? prev : reg_pred<1>(q, c0 + s, 0, 0);
        float rec;
        T[lane][s] = __int_as_float(quant(cur, pred, l, c, &rec));
        prev = l ? rec : cur;
      }
    }
    __syncwarp();
    for (int r = 0; r < rows; ++r)
      types[(b0 + r) * kBs + c0 + lane] = __float_as_int(T[r][lane]);
    __syncwarp();
  }
}

// K13: the selection is g.grid[0] consecutive blocks; out the crop.
template <int kBs>
__device__ __forceinline__ void decode_lanes(
    const int* __restrict__ types, const float* __restrict__ unpred,
    long long n_unpred, const long long* __restrict__ esc_base,
    const uint8_t* __restrict__ lor, const float* __restrict__ qc,
    const Region& g, const Quant& c, float* __restrict__ out,
    unsigned long long* bad) {
  __shared__ float tile[kWarps][32][kChunk + 1];
  const long long nb = g.grid[0];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b0 = ((long long)blockIdx.x * kWarps + w) * 32;
  if (b0 >= nb) return;
  const int rows = (int)min(32LL, nb - b0);
  const long long b = b0 + lane;
  const bool live = lane < rows;
  float q[2] = {0.0f, 0.0f};
  bool l = false;
  long long k = 0;  // this block's next escape
  if (live) {
    q[0] = __ldg(qc + 2 * b), q[1] = __ldg(qc + 2 * b + 1);
    l = __ldg(lor + b) != 0;
    k = __ldg(esc_base + b);
  }
  float(*T)[kChunk + 1] = tile[w];
  Rows next;
  next.load(types, b0, rows, kBs, 0, lane);
  float prev = 0.0f;
  for (int c0 = 0; c0 < kBs; c0 += kChunk) {
    next.store(T, rows, lane);
    __syncwarp();
    if (c0 + kChunk < kBs)
      next.load(types, b0, rows, kBs, c0 + kChunk, lane);
    if (live) {
      for (int s = 0; s < kChunk; ++s) {
        const int t = __float_as_int(T[lane][s]);
        const float pred =
            l ? prev : reg_pred<1>(q, c0 + s, 0, 0);
        float v = rebuild(pred, t, c);
        if (c.use_mean && l && t == 1) v = c.mean;
        if (t == 0) {
          v = escape(unpred, n_unpred, k++, bad);
        }
        prev = v;
        T[lane][s] = v;
      }
    }
    __syncwarp();
    for (int r = 0; r < rows; ++r) {
      const long long o = (b0 + r) * kBs + c0 + lane - g.lo[0];
      if (o >= 0 && o < g.ext[0]) out[o] = T[r][lane];
    }
    __syncwarp();
  }
}

// --- the kernels ----------------------------------------------------------

// rank 1 holds a prefetched chunk in registers; the encode is held to two
// CTAs an SM (2^24 points are 256 CTAs, one wave), as the decode fits
__global__ void __launch_bounds__(kThreads, 2) ra_encode1d_kernel(
    const float* blocks, const uint8_t* lor, const float* qc, long long nb,
    Quant c, int* types) {
  encode_lanes<256>(blocks, lor, qc, nb, c, types);
}
__global__ void __launch_bounds__(kThreads) ra_encode2d_kernel(
    const float* blocks, const uint8_t* lor, const float* qc, long long nb,
    const int* diag, Quant c, int* types) {
  encode_group<2, 16>(blocks, lor, qc, nb, diag, c, types);
}
__global__ void __launch_bounds__(kThreads) ra_encode3d_kernel(
    const float* blocks, const uint8_t* lor, const float* qc, long long nb,
    const int* diag, Quant c, int* types) {
  encode_group<3, 6>(blocks, lor, qc, nb, diag, c, types);
}
__global__ void __launch_bounds__(kThreads) ra_decode1d_kernel(
    const int* types, const float* unpred, long long n_unpred,
    const long long* esc_base, const uint8_t* lor, const float* qc,
    Region g, Quant c, float* out, unsigned long long* bad) {
  decode_lanes<256>(types, unpred, n_unpred, esc_base, lor, qc, g, c, out,
                    bad);
}
__global__ void __launch_bounds__(kThreads) ra_decode2d_kernel(
    const int* types, const float* unpred, long long n_unpred,
    const long long* esc_base, const uint8_t* lor, const float* qc,
    const int* diag, Region g, Quant c, float* out, unsigned long long* bad) {
  decode_group<2, 16>(types, unpred, n_unpred, esc_base, lor, qc, diag, g,
                      c, out, bad);
}
__global__ void __launch_bounds__(kThreads) ra_decode3d_kernel(
    const int* types, const float* unpred, long long n_unpred,
    const long long* esc_base, const uint8_t* lor, const float* qc,
    const int* diag, Region g, Quant c, float* out, unsigned long long* bad) {
  decode_group<3, 6>(types, unpred, n_unpred, esc_base, lor, qc, diag, g, c,
                     out, bad);
}

template <class K, class... A>
int launch(K kernel, long long ctas, cudaStream_t st, A... args) {
  if (ctas == 0) return 0;
  kernel<<<(unsigned)ctas, kThreads, 0, st>>>(args...);
  return (int)cudaGetLastError();
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// K12: blocks f32 (nb, bs^rank), lor u8 (nb; 1 = Lorenzo), qc f32
// (nb, rank + 1), diag i32 (rank (bs - 1) + 1, 32) the diagonal table
// (ranks 2-3) -> types i32 (nb, bs^rank).  The rank picks the block size:
// 256 / 16 / 6 at ranks 1 / 2 / 3 (rablock.BLOCK_SIZE).
extern "C" int sz_ra_encode(const float* blocks, const uint8_t* lor,
                            const float* qc, long long nb, int rank,
                            const int* diag, double rp, int cap, int radius,
                            int use_mean, float mean, int* types,
                            void* stream) {
  const Quant c{rp, cap, radius, use_mean, mean};
  const cudaStream_t st = (cudaStream_t)stream;
  if (rank == 3)
    return launch(ra_encode3d_kernel, cdiv(nb, kWarps), st, blocks, lor, qc,
                  nb, diag, c, types);
  if (rank == 2)
    return launch(ra_encode2d_kernel, cdiv(nb, kWarps), st, blocks, lor, qc,
                  nb, diag, c, types);
  if (rank == 1)
    return launch(ra_encode1d_kernel, cdiv(nb, 32 * kWarps), st, blocks,
                  lor, qc, nb, c, types);
  return (int)cudaErrorInvalidValue;
}

// K13: types i32 (nsel, bs^rank) of the selected blocks in raster order
// over their grid (g0, g1, g2: axes past the rank 1), unpred f32
// (n_unpred; the escapes in stream order), esc_base i64 (nsel; each
// block's first escape in unpred), lor, qc, diag as K12's -> out f32,
// the region of extents (e0, e1, e2) that starts lo0, lo1, lo2 cells
// into the selection's first block, in row-major order; *bad (zero on
// entry) gains one for each escape past the end of unpred.
extern "C" int sz_ra_decode(const int* types, const float* unpred,
                            long long n_unpred, const long long* esc_base,
                            const uint8_t* lor, const float* qc,
                            const int* diag, int rank, int g0, int g1,
                            int g2, int lo0, int lo1, int lo2, int e0,
                            int e1, int e2, double rp, int radius,
                            int use_mean, float mean, float* out,
                            unsigned long long* bad, void* stream) {
  const Quant c{rp, 0, radius, use_mean, mean};
  const Region g{{g0, g1, g2}, {lo0, lo1, lo2}, {e0, e1, e2}};
  const cudaStream_t st = (cudaStream_t)stream;
  if (rank == 3)
    return launch(ra_decode3d_kernel, (long long)g0 * g1 * cdiv(g2, kWarps),
                  st, types, unpred, n_unpred, esc_base, lor, qc, diag, g, c,
                  out, bad);
  if (rank == 2)
    return launch(ra_decode2d_kernel, (long long)g0 * cdiv(g1, kWarps), st,
                  types, unpred, n_unpred, esc_base, lor, qc, diag, g, c,
                  out, bad);
  if (rank == 1)
    return launch(ra_decode1d_kernel, cdiv(g0, 32 * kWarps), st, types,
                  unpred, n_unpred, esc_base, lor, qc, g, c, out, bad);
  return (int)cudaErrorInvalidValue;
}
