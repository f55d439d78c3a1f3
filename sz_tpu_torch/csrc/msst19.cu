// K8 msst19_wavefront3d / K9 msst19_lines2d: the MSST19 point-wise
// relative (PW_REL) codec's multiplicative recurrence on Hopper (sm_90a),
// encode and decode.
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
// Bound on this card: the dependency order, not bytes or arithmetic.
// K8 is one launch per anti-diagonal s = i + j + k (r1 + r2 + r3 - 2
// launches; a cell's neighbours lie on diagonals s-1..s-3, final once
// the earlier launches on the stream have run), like K1/K2.  A block
// lives for one diagonal, so the tables are read through L1 (the
// states a field uses cluster around ratio 1) instead of being staged
// per block.  K9 is one block of 1024 threads that walks the
// r2 + r3 - 1 anti-diagonal lines d = j + k with a __syncthreads()
// between lines: the two previous lines are kept in shared memory, and
// so are the cache table and the precision table when they fit in the
// 227 KB a block may use (else they are read through L2): one launch
// instead of r2 + r3 - 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads3d = 256;
constexpr int kThreads2d = 1024;
constexpr int kSmemMax = 232448;  // 227 KB: a block's dynamic shared memory

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

struct Tables {
  const uint16_t* table;  // (top - base + 1) << bits states
  const double* pt;       // npt precision factors
  int npt, base, top, bits;
};

// State of a prediction ratio (CacheTable.lookup): 0 outside the table.
__device__ __forceinline__ int lookup(float ratio, const Tables& t) {
  unsigned long long b =
      (unsigned long long)__double_as_longlong((double)ratio) &
      0x7FFFFFFFFFFFFFFFull;
  int expo = (int)(b >> 52) - t.base;
  if (expo < 0 || expo > t.top - t.base) return 0;
  unsigned long long manti = (b & 0x000FFFFFFFFFFFFFull) >> (52 - t.bits);
  return t.table[((long long)expo << t.bits) + (long long)manti];
}

// f32(f64(|pred|) * pt[s]); a type past the table (a corrupt stream,
// refused by the engine) gives NaN rather than a read out of bounds.
__device__ __forceinline__ float recon(float pred, int s, const Tables& t) {
  if ((unsigned)s >= (unsigned)t.npt) return __int_as_float(0x7FFFFFFF);
  return __double2float_rn(__dmul_rn((double)fabsf(pred), t.pt[s]));
}

__device__ __forceinline__ float trunc_bits(float cur, unsigned mask) {
  return __uint_as_float(__float_as_uint(cur) & mask);
}

__device__ __forceinline__ double wide(const float* R, long long idx) {
  return (double)fabsf(R[idx]);
}

// The 3-D predictor of point (i, j, k) from the magnitudes of its
// already-final neighbours (R may hold signed values: it is read as
// magnitudes).  Names as in the host chain: A (k-1), B (j-1), C (i-1),
// D (j-1,k-1), E (i-1,j-1), F (i-1,k-1), G (i-1,j-1,k-1), A2 (k-2).
__device__ __forceinline__ float pred3(const float* R, int i, int j, int k,
                                       int r2, int r3) {
  const long long r23 = (long long)r2 * r3;
  const long long x = ((long long)i * r2 + j) * r3 + k;
  if (i == 0) {
    if (j == 0) {
      if (k == 0) return 0.0f;
      if (k == 1) return fabsf(R[x - 1]);
      double a = wide(R, x - 1);
      return __double2float_rn(__ddiv_rn(__dmul_rn(a, a), wide(R, x - 2)));
    }
    if (k == 0) return fabsf(R[x - r3]);
    return __double2float_rn(__ddiv_rn(
        __dmul_rn(wide(R, x - 1), wide(R, x - r3)), wide(R, x - r3 - 1)));
  }
  if (j == 0) {
    if (k == 0) return fabsf(R[x - r23]);
    return __double2float_rn(__ddiv_rn(
        __dmul_rn(wide(R, x - 1), wide(R, x - r23)), wide(R, x - r23 - 1)));
  }
  if (k == 0)
    return __double2float_rn(__ddiv_rn(
        __dmul_rn(wide(R, x - r3), wide(R, x - r23)),
        wide(R, x - r23 - r3)));
  double num = __dmul_rn(__dmul_rn(__dmul_rn(wide(R, x - 1), wide(R, x - r3)),
                                   wide(R, x - r23)),
                         wide(R, x - r23 - r3 - 1));
  double den = __dmul_rn(__dmul_rn(wide(R, x - r3 - 1), wide(R, x - r23 - r3)),
                         wide(R, x - r23 - 1));
  return __double2float_rn(__ddiv_rn(num, den));
}

// The points of diagonal s inside the box i in [i_lo, i_lo + ni),
// j in [j_lo, j_lo + nj); k = s - i - j must fall inside [0, r3).
struct Diag {
  int s, i_lo, j_lo, ni, nj;
};

__device__ __forceinline__ bool diag_point(const Diag& d, int r2, int r3,
                                           int* i, int* j, int* k) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)d.ni * d.nj) return false;
  *i = d.i_lo + (int)(t / d.nj);
  *j = d.j_lo + (int)(t % d.nj);
  *k = d.s - *i - *j;
  return *j < r2 && *k >= 0 && *k < r3;
}

__global__ void __launch_bounds__(kThreads3d) wavefront3d_encode_kernel(
    Diag d, const float* __restrict__ data, Tables t, unsigned mask,
    int* __restrict__ types, float* R, int r2, int r3) {
  int i, j, k;
  if (!diag_point(d, r2, r3, &i, &j, &k)) return;
  long long x = ((long long)i * r2 + j) * r3 + k;
  float cur = fabsf(__ldg(data + x));
  float pred = pred3(R, i, j, k, r2, r3);
  int s = x == 0 ? 0 : lookup(__fdiv_rn(cur, pred), t);
  types[x] = s;
  R[x] = s ? recon(pred, s, t) : trunc_bits(cur, mask);
}

__global__ void __launch_bounds__(kThreads3d) wavefront3d_decode_kernel(
    Diag d, const int* __restrict__ types, const float* __restrict__ known,
    Tables t, float* out, int r2, int r3) {
  int i, j, k;
  if (!diag_point(d, r2, r3, &i, &j, &k)) return;
  long long x = ((long long)i * r2 + j) * r3 + k;
  int s = __ldg(types + x);
  out[x] = s ? recon(pred3(out, i, j, k, r2, r3), s, t) : __ldg(known + x);
}

inline Diag diag_box(int s, int r1, int r2, int r3) {
  Diag d;
  d.s = s;
  d.i_lo = imax(0, s - (r2 - 1) - (r3 - 1));
  int i_hi = imin(r1 - 1, s);
  d.j_lo = imax(0, s - i_hi - (r3 - 1));
  int j_hi = imin(r2 - 1, s - d.i_lo);
  d.ni = i_hi - d.i_lo + 1;
  d.nj = j_hi - d.j_lo + 1;
  return d;
}

inline unsigned blocks_for(const Diag& d) {
  long long n = (long long)d.ni * d.nj;
  return (unsigned)((n + kThreads3d - 1) / kThreads3d);
}

inline unsigned mask_of(int ign) {
  return ign >= 32 ? 0u : ~((1u << ign) - 1u);
}

// --- K9: the 2-D line walk -----------------------------------------------

// Shared-memory layout of K9, decided on the host: each part's byte
// offset, or -1 when that part stays in device memory.
struct Smem2d {
  int pt_off, lines_off, table_off, bytes;
};

// Point (j, k) of line d: A = (j, k-1) and B = (j-1, k) on line d-1,
// D = (j-1, k-1) and A2 = (j, k-2) on line d-2.  Lines are indexed by k,
// three of r3 entries, line d in slot d % 3, holding magnitudes.
__device__ __forceinline__ float pred2(const float* l1, const float* l2,
                                       int j, int k) {
  if (j == 0) {
    if (k == 0) return 0.0f;
    if (k == 1) return l1[k - 1];
    return __fdiv_rn(__fmul_rn(l1[k - 1], l1[k - 1]), l2[k - 2]);
  }
  if (k == 0) return l1[k];
  return __fdiv_rn(__fmul_rn(l1[k - 1], l1[k]), l2[k - 1]);
}

// Copy the tables that fit into shared memory and point *t at the
// copies; returns the line buffers to use.  Shared or device memory, the
// kernel reads both through the same generic pointers.
__device__ float* stage2d(unsigned char* smem, Smem2d sm, Tables* t,
                          long long table_n, float* gl_lines) {
  if (sm.pt_off >= 0) {
    double* p = (double*)(smem + sm.pt_off);
    for (int q = threadIdx.x; q < t->npt; q += blockDim.x) p[q] = t->pt[q];
    t->pt = p;
  }
  if (sm.table_off >= 0) {
    uint16_t* p = (uint16_t*)(smem + sm.table_off);
    for (long long q = threadIdx.x; q < table_n; q += blockDim.x)
      p[q] = t->table[q];
    t->table = p;
  }
  __syncthreads();
  return sm.lines_off >= 0 ? (float*)(smem + sm.lines_off) : gl_lines;
}

template <bool kDecode>
__global__ void __launch_bounds__(kThreads2d) lines2d_kernel(
    const float* __restrict__ in, const int* __restrict__ types_in,
    Tables t, long long table_n, unsigned mask, int* __restrict__ types_out,
    float* __restrict__ out, float* gl_lines, Smem2d sm, int r2, int r3) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lines = stage2d(smem, sm, &t, table_n, gl_lines);
  for (int d = 0; d < r2 + r3 - 1; ++d) {
    float* l0 = lines + (long long)(d % 3) * r3;
    const float* l1 = lines + (long long)((d + 2) % 3) * r3;
    const float* l2 = lines + (long long)((d + 1) % 3) * r3;
    int k_lo = imax(0, d - (r2 - 1)), k_hi = imin(d, r3 - 1);
    for (int k = k_lo + threadIdx.x; k <= k_hi; k += blockDim.x) {
      int j = d - k;
      long long x = (long long)j * r3 + k;
      float v;
      if constexpr (kDecode) {
        int s = types_in[x];
        v = s ? recon(pred2(l1, l2, j, k), s, t) : in[x];
        out[x] = v;
        v = fabsf(v);
      } else {
        float cur = fabsf(in[x]);
        float pred = pred2(l1, l2, j, k);
        int s = x == 0 ? 0 : lookup(__fdiv_rn(cur, pred), t);
        v = s ? recon(pred, s, t) : trunc_bits(cur, mask);
        types_out[x] = s;
        out[x] = v;
      }
      l0[k] = v;
    }
    __syncthreads();
  }
}

inline Smem2d plan2d(int npt, long long table_n, int r3) {
  Smem2d sm{-1, -1, -1, 0};
  long long used = 0;
  long long pt_b = 8LL * npt, lines_b = 12LL * r3;
  long long tab_b = (2 * table_n + 15) / 16 * 16;
  if (lines_b <= kSmemMax) {
    sm.lines_off = (int)used;
    used += (lines_b + 15) / 16 * 16;
  }
  if (used + tab_b <= kSmemMax) {
    sm.table_off = (int)used;
    used += tab_b;
  }
  if (used + pt_b <= kSmemMax) {
    sm.pt_off = (int)used;
    used += pt_b;
  }
  sm.bytes = (int)used;
  return sm;
}

template <bool kDecode>
int launch2d(const float* in, const int* types_in, Tables t, long long table_n,
             unsigned mask, int* types_out, float* out, float* gl_lines,
             int r2, int r3, cudaStream_t st) {
  Smem2d sm = plan2d(t.npt, kDecode ? 0 : table_n, r3);
  auto kern = lines2d_kernel<kDecode>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, kThreads2d, sm.bytes, st>>>(in, types_in, t, table_n, mask,
                                        types_out, out, gl_lines, sm, r2, r3);
  return (int)cudaGetLastError();
}

}  // namespace

// K8 encode: data f32 (r1, r2, r3) -> types i32 and the magnitude
// reconstruction R (both preallocated, same shape).
extern "C" int sz_msst19_wavefront3d_encode(
    const float* data, const uint16_t* table, const double* pt, int npt,
    int base, int top, int bits, int ign, int* types, float* R, int r1,
    int r2, int r3, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Tables t{table, pt, npt, base, top, bits};
  unsigned mask = mask_of(ign);
  for (int s = 0; s < r1 + r2 + r3 - 2; ++s) {
    Diag d = diag_box(s, r1, r2, r3);
    if (d.ni <= 0 || d.nj <= 0) continue;
    wavefront3d_encode_kernel<<<blocks_for(d), kThreads3d, 0, st>>>(
        d, data, t, mask, types, R, r2, r3);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// K8 decode: types i32 and the escapes' values (known, f32, signed; any
// value elsewhere) -> out f32 (escapes signed, the rest magnitudes).
extern "C" int sz_msst19_wavefront3d_decode(
    const int* types, const float* known, const double* pt, int npt,
    float* out, int r1, int r2, int r3, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Tables t{nullptr, pt, npt, 0, 0, 0};
  for (int s = 0; s < r1 + r2 + r3 - 2; ++s) {
    Diag d = diag_box(s, r1, r2, r3);
    if (d.ni <= 0 || d.nj <= 0) continue;
    wavefront3d_decode_kernel<<<blocks_for(d), kThreads3d, 0, st>>>(
        d, types, known, t, out, r2, r3);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// K9 encode: data f32 (r2, r3) -> types i32 and R; lines: 3 * r3 f32 of
// device scratch, used when the line buffers do not fit in shared memory.
extern "C" int sz_msst19_lines2d_encode(
    const float* data, const uint16_t* table, long long table_n,
    const double* pt, int npt, int base, int top, int bits, int ign,
    int* types, float* R, float* lines, int r2, int r3, void* stream) {
  Tables t{table, pt, npt, base, top, bits};
  return launch2d<false>(data, nullptr, t, table_n, mask_of(ign), types, R,
                         lines, r2, r3, (cudaStream_t)stream);
}

// K9 decode: types i32, known f32 (r2, r3) -> out f32.
extern "C" int sz_msst19_lines2d_decode(
    const int* types, const float* known, const double* pt, int npt,
    float* out, float* lines, int r2, int r3, void* stream) {
  Tables t{nullptr, pt, npt, 0, 0, 0};
  return launch2d<true>(known, types, t, 0, 0u, nullptr, out, lines, r2, r3,
                        (cudaStream_t)stream);
}
