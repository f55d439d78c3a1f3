// K3 histogram: exact 65536-bin int32 counts of the quantization type
// codes (the Huffman frequency table) on Hopper (sm_90a).
//
// Replaces sz_tpu/tpu/hist_kernel.py::histogram (bf16 one-hot matmuls on
// the TPU's MXU).  Here the counts are integer atomics, exact and
// independent of order.
//
// Bound on this card: bytes (each symbol read once, 4 B, and the 256 KB
// of counts written), so the design reads the symbols once, in 16-byte
// loads, two a thread in flight, and keeps the counting off device
// memory.  65536 bins x 4 B exceed a block's shared memory, but SZ's type
// codes cluster around the quantizer radius, which the caller knows, so
// a block privatises a window of kWindow bins around it (16 KB: several
// blocks an SM) and splits each symbol three ways:
//   - the radius bin itself, where a smooth field puts most codes, and
//     symbol 0 (the escapes) are counted in two registers a thread and
//     reduced once a block: no atomic at all;
//   - other symbols inside the window take one shared-memory atomic;
//   - symbols outside it take a global atomic, aggregated over the warp
//     (__match_any_sync, paid only when a lane of the warp has such a
//     symbol, which a good window makes rare).
// The window's placement is a hint only: a wrong one moves work to the
// global path and never changes a count.  At the end each block adds its
// nonzero window bins and its two register bins to the output with one
// global atomic each.  Negative symbols (holes) and symbols >= 65536 are
// skipped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 65536;
constexpr int kWindow = 4096;  // bins privatised in shared memory
constexpr int kThreads = 512;
constexpr int kVecs = 2;       // 16-byte loads a thread in flight

__global__ void __launch_bounds__(kThreads) histogram_window_kernel(
    const int* __restrict__ sym, long long n, int center, int lo,
    int* __restrict__ hist) {
  __shared__ int bins[kWindow];
  __shared__ int s_center, s_zero;
  for (int b = threadIdx.x; b < kWindow; b += kThreads) bins[b] = 0;
  if (threadIdx.x == 0) s_center = s_zero = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int n_center = 0, n_zero = 0;
  // every lane of a warp calls count() together (__any_sync and
  // __match_any_sync take the full mask)
  auto count = [&](int s) {
    n_center += s == center;
    n_zero += s == 0;
    const unsigned d = (unsigned)s - (unsigned)lo;
    if (d < (unsigned)kWindow && s != center) atomicAdd(&bins[d], 1);
    const bool out = (unsigned)s < (unsigned)kBins && s != 0 &&
                     d >= (unsigned)kWindow;
    if (__any_sync(0xffffffffu, out)) {
      const unsigned peers = __match_any_sync(0xffffffffu, out ? s : -1);
      if (out && lane == __ffs(peers) - 1) atomicAdd(&hist[s], __popc(peers));
    }
  };

  // the 16-byte-aligned body; i0 is uniform across a warp, so its lanes
  // take the same trip count
  const int head = (int)min((long long)((16 - ((uintptr_t)sym & 15)) & 15) / 4,
                            n);
  const long long nv = (n - head) / 4;
  const int4* v4 = reinterpret_cast<const int4*>(sym + head);
  const long long stride = (long long)gridDim.x * kThreads * kVecs;
  for (long long i0 = ((long long)blockIdx.x * kThreads + (threadIdx.x & ~31))
                      * kVecs;
       i0 < nv; i0 += stride) {
    int4 q[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long i = i0 + 32 * v + lane;
      q[v] = i < nv ? __ldcs(v4 + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      count(q[v].x);
      count(q[v].y);
      count(q[v].z);
      count(q[v].w);
    }
  }
  // the (at most 3 + 3) symbols before and after the body: one warp
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long tail = head + 4 * nv;
    int s = -1;
    if (lane < head)
      s = sym[lane];
    else if (lane >= 4 && tail + lane - 4 < n)
      s = sym[tail + lane - 4];
    count(s);
  }

  n_center = __reduce_add_sync(0xffffffffu, (unsigned)n_center);
  n_zero = __reduce_add_sync(0xffffffffu, (unsigned)n_zero);
  if (lane == 0) {
    if (n_center) atomicAdd(&s_center, n_center);
    if (n_zero) atomicAdd(&s_zero, n_zero);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kWindow; b += kThreads) {
    const int c = bins[b];
    if (c) atomicAdd(&hist[lo + b], c);
  }
  if (threadIdx.x == 0) {
    if (s_center) atomicAdd(&hist[center], s_center);
    if (s_zero) atomicAdd(&hist[0], s_zero);
  }
}

}  // namespace

// center: the register bin, in [1, 65536); lo: the window's first bin,
// 1 <= lo <= center < lo + kWindow <= 65536 (the wrapper places both from
// the quantizer radius).  hist: int32[65536] output.
extern "C" int sz_histogram(const int* sym, long long n, int center, int lo,
                            int* hist, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (center < 1 || center >= kBins || lo < 1 || lo > center ||
      center >= lo + kWindow || lo + kWindow > kBins)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(hist, 0, kBins * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaSuccess;
  // resident blocks, found once (a static's initialization is
  // thread-safe: slabs launch from several threads at once)
  struct Resident {
    cudaError_t e;
    long long blocks;
  };
  static const Resident resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, histogram_window_kernel, kThreads, 0);
    return Resident{err, (long long)sms * (per_sm < 1 ? 1 : per_sm)};
  }();
  if (resident.e != cudaSuccess) return (int)resident.e;
  const long long per_block = (long long)kThreads * kVecs * 4;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > resident.blocks) blocks = resident.blocks;
  histogram_window_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      sym, n, center, lo, hist);
  return (int)cudaGetLastError();
}
