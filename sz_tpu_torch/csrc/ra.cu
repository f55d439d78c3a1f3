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
// Design: one thread a block, walking its bs^rank cells in raster order
// (a topological order of the stencil), every block independent: no
// hand-off between threads or CTAs.  A Lorenzo point reads only the
// current and the previous plane (rank 3) or row (rank 2), so a thread
// keeps two bordered planes of (bs+1)^2 floats (rank 2: two rows of
// bs+1; rank 1: one register), zero on the border, in shared memory,
// element e of every thread of the CTA side by side (no bank conflicts);
// 98 floats a thread at bs = 6, 128 threads a CTA (50 KB).  The block's
// values and types go to and from device memory one cell a step.
//
// Bound on this card: the bytes (each block's values read once and its
// types written once: 8 bytes a cell) would take 0.32 ms at 512^3; the
// simple design is instead bound by each thread's serial walk (216
// dependent steps of double arithmetic a block, the loads strided by a
// block) over the threads the card holds at once.  PERF.md has its
// time.  The escapes' values come in placed per cell (a torch cumsum in
// the wrapper), so the decode reads no escape cursor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Quant {
  double rp;
  int cap, radius, use_mean;
  float mean;
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

// One quantized point: its type, and its reconstruction in *rec.
__device__ __forceinline__ int quant(float cur, float pred, bool lor,
                                     const Quant& c, float* rec) {
  const double diff = (double)__fsub_rn(cur, pred);
  double itv = __dadd_rn(__ddiv_rn(fabs(diff), c.rp), 1.0);
  int t = 0;
  float r = cur;
  if (itv < (double)(lor ? c.cap - 2 : c.cap)) {  // false for NaN
    if (diff < 0) itv = -itv;
    const int tq = __double2int_rz(__dmul_rn(itv, 0.5)) + c.radius;
    const float rq = rebuild(pred, tq, c);
    if (fabs((double)__fsub_rn(cur, rq)) <= c.rp) t = tq, r = rq;
  }
  if (c.use_mean && lor && fabs((double)__fsub_rn(cur, c.mean)) <= c.rp) {
    t = 1;
    r = c.mean;
  }
  *rec = r;
  return t;
}

// The walk of one block (this thread's): the Lorenzo predictor from the
// two-plane ring Rs (this thread's element e at Rs[e * kThreads]), then
// step(ci, pred, lor) -> the point's reconstruction.
template <int kRank, class Step>
__device__ __forceinline__ void walk(const float* q, bool lor, int bs,
                                     float* Rs, Step step) {
  const int b1 = bs + 1;
  auto S = [&](int p, int j1, int k1) {
    return Rs + (((p * b1 + j1) * b1 + k1) * kThreads);
  };
  if (kRank == 1) {
    float prev = 0.0f;
    for (int ii = 0; ii < bs; ++ii) {
      const float pred = lor ? prev : reg_pred<1>(q, ii, 0, 0);
      prev = step(ii, pred);
    }
    return;
  }
  const int planes = kRank == 3 ? 2 * b1 * b1 : 2 * b1;
  for (int e = 0; e < planes; ++e) Rs[e * kThreads] = 0.0f;
  int ci = 0;
  if (kRank == 2) {
    for (int ii = 0; ii < bs; ++ii) {
      const int p = ii & 1, o = p ^ 1;
      for (int jj = 0; jj < bs; ++jj, ++ci) {
        const int j1 = jj + 1;
        float pred;
        if (lor)
          pred = __fsub_rn(__fadd_rn(*S(0, p, j1 - 1), *S(0, o, j1)),
                           *S(0, o, j1 - 1));
        else
          pred = reg_pred<2>(q, ii, jj, 0);
        *S(0, p, j1) = step(ci, pred);
      }
    }
    return;
  }
  for (int ii = 0; ii < bs; ++ii) {
    const int p = ii & 1, o = p ^ 1;
    for (int jj = 0; jj < bs; ++jj) {
      const int j1 = jj + 1;
      for (int kk = 0; kk < bs; ++kk, ++ci) {
        const int k1 = kk + 1;
        float pred;
        if (lor) {
          pred = __fadd_rn(*S(p, j1, k1 - 1), *S(p, j1 - 1, k1));
          pred = __fadd_rn(pred, *S(o, j1, k1));
          pred = __fsub_rn(pred, *S(p, j1 - 1, k1 - 1));
          pred = __fsub_rn(pred, *S(o, j1, k1 - 1));
          pred = __fsub_rn(pred, *S(o, j1 - 1, k1));
          pred = __fadd_rn(pred, *S(o, j1 - 1, k1 - 1));
        } else {
          pred = reg_pred<3>(q, ii, jj, kk);
        }
        *S(p, j1, k1) = step(ci, pred);
      }
    }
  }
}

template <int kRank>
__device__ __forceinline__ void encode_block(
    const float* __restrict__ blocks, const uint8_t* __restrict__ lor,
    const float* __restrict__ qc, long long nb, int bs, Quant c,
    int* __restrict__ types) {
  extern __shared__ float smem[];
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= nb) return;
  int ncell = bs;
  for (int r = 1; r < kRank; ++r) ncell *= bs;
  const float* x = blocks + b * ncell;
  int* ty = types + b * ncell;
  float q[kRank + 1];
  for (int e = 0; e <= kRank; ++e) q[e] = __ldg(qc + b * (kRank + 1) + e);
  const bool l = __ldg(lor + b) != 0;
  walk<kRank>(q, l, bs, smem + threadIdx.x, [&](int ci, float pred) {
    const float cur = __ldg(x + ci);
    float rec;
    ty[ci] = quant(cur, pred, l, c, &rec);
    return l ? rec : cur;
  });
}

template <int kRank>
__device__ __forceinline__ void decode_block(
    const int* __restrict__ types, const float* __restrict__ escv,
    const uint8_t* __restrict__ lor, const float* __restrict__ qc,
    long long nb, int bs, Quant c, float* __restrict__ out) {
  extern __shared__ float smem[];
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= nb) return;
  int ncell = bs;
  for (int r = 1; r < kRank; ++r) ncell *= bs;
  float q[kRank + 1];
  for (int e = 0; e <= kRank; ++e) q[e] = __ldg(qc + b * (kRank + 1) + e);
  const bool l = __ldg(lor + b) != 0;
  walk<kRank>(q, l, bs, smem + threadIdx.x, [&](int ci, float pred) {
    const int t = __ldg(types + b * ncell + ci);
    float v = rebuild(pred, t, c);
    if (c.use_mean && l && t == 1) v = c.mean;
    if (t == 0) v = __ldg(escv + b * ncell + ci);
    out[b * ncell + ci] = v;
    return v;
  });
}

__global__ void __launch_bounds__(kThreads) ra_encode1d_kernel(
    const float* blocks, const uint8_t* lor, const float* qc, long long nb,
    int bs, Quant c, int* types) {
  encode_block<1>(blocks, lor, qc, nb, bs, c, types);
}
__global__ void __launch_bounds__(kThreads) ra_encode2d_kernel(
    const float* blocks, const uint8_t* lor, const float* qc, long long nb,
    int bs, Quant c, int* types) {
  encode_block<2>(blocks, lor, qc, nb, bs, c, types);
}
__global__ void __launch_bounds__(kThreads) ra_encode3d_kernel(
    const float* blocks, const uint8_t* lor, const float* qc, long long nb,
    int bs, Quant c, int* types) {
  encode_block<3>(blocks, lor, qc, nb, bs, c, types);
}
__global__ void __launch_bounds__(kThreads) ra_decode1d_kernel(
    const int* types, const float* escv, const uint8_t* lor, const float* qc,
    long long nb, int bs, Quant c, float* out) {
  decode_block<1>(types, escv, lor, qc, nb, bs, c, out);
}
__global__ void __launch_bounds__(kThreads) ra_decode2d_kernel(
    const int* types, const float* escv, const uint8_t* lor, const float* qc,
    long long nb, int bs, Quant c, float* out) {
  decode_block<2>(types, escv, lor, qc, nb, bs, c, out);
}
__global__ void __launch_bounds__(kThreads) ra_decode3d_kernel(
    const int* types, const float* escv, const uint8_t* lor, const float* qc,
    long long nb, int bs, Quant c, float* out) {
  decode_block<3>(types, escv, lor, qc, nb, bs, c, out);
}

// Shared-memory bytes of a CTA: the two-plane ring of every thread.
size_t ring_bytes(int rank, int bs) {
  const size_t b1 = bs + 1;
  const size_t e = rank == 3 ? 2 * b1 * b1 : rank == 2 ? 2 * b1 : 0;
  return e * kThreads * sizeof(float);
}

template <class K, class... A>
int launch(K kernel, int rank, int bs, long long nb, cudaStream_t st,
           A... args) {
  if (nb == 0) return 0;
  const size_t bytes = ring_bytes(rank, bs);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (nb + kThreads - 1) / kThreads;
  kernel<<<(unsigned)grid, kThreads, bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// K12: blocks f32 (nb, bs^rank), lor u8 (nb; 1 = Lorenzo), qc f32
// (nb, rank + 1) -> types i32 (nb, bs^rank).
extern "C" int sz_ra_encode(const float* blocks, const uint8_t* lor,
                            const float* qc, long long nb, int rank, int bs,
                            double rp, int cap, int radius, int use_mean,
                            float mean, int* types, void* stream) {
  const Quant c{rp, cap, radius, use_mean, mean};
  const cudaStream_t st = (cudaStream_t)stream;
  if (rank == 3)
    return launch(ra_encode3d_kernel, 3, bs, nb, st, blocks, lor, qc, nb, bs,
                  c, types);
  if (rank == 2)
    return launch(ra_encode2d_kernel, 2, bs, nb, st, blocks, lor, qc, nb, bs,
                  c, types);
  if (rank == 1)
    return launch(ra_encode1d_kernel, 1, bs, nb, st, blocks, lor, qc, nb, bs,
                  c, types);
  return (int)cudaErrorInvalidValue;
}

// K13: types i32 and escv f32 (the escapes' values placed per cell;
// anything elsewhere) (nb, bs^rank), lor, qc -> out f32 (nb, bs^rank).
extern "C" int sz_ra_decode(const int* types, const float* escv,
                            const uint8_t* lor, const float* qc, long long nb,
                            int rank, int bs, double rp, int radius,
                            int use_mean, float mean, float* out,
                            void* stream) {
  const Quant c{rp, 0, radius, use_mean, mean};
  const cudaStream_t st = (cudaStream_t)stream;
  if (rank == 3)
    return launch(ra_decode3d_kernel, 3, bs, nb, st, types, escv, lor, qc,
                  nb, bs, c, out);
  if (rank == 2)
    return launch(ra_decode2d_kernel, 2, bs, nb, st, types, escv, lor, qc,
                  nb, bs, c, out);
  if (rank == 1)
    return launch(ra_decode1d_kernel, 1, bs, nb, st, types, escv, lor, qc,
                  nb, bs, c, out);
  return (int)cudaErrorInvalidValue;
}
