// The tile machinery of the wavefront kernels on Hopper (sm_90a): K1/K2
// (lorenzo.cu, the SZ2.1 Lorenzo recurrence) and K8/K9 (msst19.cu, the
// MSST19 PW_REL recurrence).  It does not depend on the point rule.
//
// A recurrence fits it when point (i, j, k) reads only points one lower
// on some set of axes (the seven Lorenzo neighbours) and, with a k-halo
// two deep, also (i, j, k-2) on the lattice's first row (i = 0, j = 0).
//
// Design: one persistent launch per call.  The lattice is cut into tiles
// of bi x bj x bk points (TileShape: fixed at compile time by the kernel
// family), k (the contiguous axis) the long side.  Tile (I, J, K) needs
// only (I-1, J, K), (I, J-1, K) and (I, J, K-1); their own predecessors
// cover the edge and corner neighbours, and (I, J, K-1) also holds the
// k-2 neighbour of the tile's first point (bk >= 2).  The wrapper numbers
// the tiles by tile-diagonal I + J + K (`order`, made in Python by
// gpu/tiles.tile_order), so every tile's predecessors have lower
// numbers.  A block has bi * bj threads, one a k-row of the tile; it
// claims the next number from a global counter and
//   1. stages the tile's inputs in shared memory (they depend on no
//      other tile, so this overlaps the wait);
//   2. waits for each predecessor's done flag (acquire) and, as soon as
//      one is set, reads the low face of R it completed through L2
//      (__ldcg: a 128-byte line may hold points of a finished and of an
//      unfinished tile), and with a two-deep halo the k-2 point of the
//      lattice's first row;
//   3. runs the point wavefront inside the tile: thread (li, lj) walks its
//      k-row skewed by li + lj, one point a step, __syncthreads between
//      steps, every neighbour read from shared memory;
//   4. stores R on those of its three high faces that a later tile reads
//      (none beyond the lattice's last tile on an axis: in 2-D, never
//      the i-face, which is the whole tile), and with a two-deep halo
//      the point a later tile reads as its k-2 neighbour, fences, and
//      publishes its flag (release store);
//   5. writes the rest of R, and the types where the rule has them, with
//      coalesced stores.
// A block waits only on tiles claimed earlier by blocks already running,
// so the scheme cannot deadlock at any grid size.  The wrapper allocates
// the flags and the counter (torch.zeros) on every call.
//
// What bounds it on this card: the dependency chain, not bytes.  A tile
// starts when its predecessors are done, so the critical path is (tile-
// diagonals) x (bi + bj + bk - 2 point steps + the flag hand-off, the
// halo load and the publishing fence); a step is one point's dependent
// chain (shared-memory reads, the rule's arithmetic, a barrier), and the
// steps are most of the path.  On a lattice with many more tiles than
// resident blocks (512^3) the bound is instead each tile's busy time over
// the resident blocks.  The shared-memory pitches put the 32 threads of a
// warp's step on 32 banks.
//
// A point rule is a type Args with
//   kArrays     arrays a point in shared memory, 2 or 3: R with its halo
//               and the staged value X, of R's element type, and, with
//               3, the int array T;
//   kFlagBytes  1 for a byte array F a point after them, else 0;
//   kTypesOut   true when write_back also stores T to a.t_out;
//   R           the output (float* or double*: its element type V is the
//               type of R, X and the halo), which later tiles read back
//               as halo;
// and, found by argument-dependent lookup in the kernel's source,
//   stage(g, t, a, X, T, F)  fill the tile's inputs;
//   point(g, a, c, i, j, k, Rs, X, T, F)  compute lattice point (i, j, k)
//               at shared index c from its final neighbours in Rs.

#pragma once

#include <cuda_runtime.h>

namespace tiles {

// Threads a block at most: one a (i, j) column of the tile.
constexpr int kMaxThreads = 256;

// The element type V of a point rule's output R (float or double).
template <class P>
struct Pointee;
template <class V>
struct Pointee<V*> {
  using type = V;
};
template <class Args>
using ValueOf = typename Pointee<decltype(Args::R)>::type;

// Shared-memory bytes a block of rule Args takes on tile shape G.
template <class G, class Args>
constexpr size_t shared_bytes() {
  return (size_t)G::entries * (2 * sizeof(ValueOf<Args>) +
                               (Args::kArrays == 3 ? 4 : 0) +
                               Args::kFlagBytes);
}

// The smallest v >= lo with v = want (mod 32).
constexpr int pitch(int lo, int want) {
  return lo + ((want - lo) % 32 + 32) % 32;
}

// The tile of a kernel family: Dims::bi x bj x bk points, with a k-halo
// kHalo deep (1, or 2 for a rule that reads (i, j, k-2)).  P and Q are
// the shared-memory pitches of a k-row and of an i-plane of a tile with
// its halo; P = 2 and Q = bj + 1 (mod 32) put thread li * bj + lj of each
// step on bank (li * bj + lj) mod 32.
template <class Dims, int kHalo>
struct TileShape {
  static constexpr int bi = Dims::bi, bj = Dims::bj, bk = Dims::bk;
  static constexpr int khalo = kHalo;
  static constexpr int threads = bi * bj;
  static constexpr int P = pitch(bk + kHalo, 2);
  static constexpr int Q = pitch((bj + 1) * P, bj + 1);
  // entries of one shared-memory array: the tile with its halo
  static constexpr int entries = (bi + 1) * Q;
  static_assert(threads % 32 == 0 && threads <= kMaxThreads,
                "a block is whole warps, at most kMaxThreads");
  static_assert(kHalo == 1 || (kHalo == 2 && bk >= 2),
                "the k-2 neighbour lies in the previous k-tile");
};

// Lattice geometry over the tile shape S.
template <class S>
struct Geo : S {
  int r1, r2, r3;
  int nti, ntj, ntk;  // tiles per axis
  int ntiles;
};

struct Tile {
  int id;               // flat tile index (I * ntj + J) * ntk + K
  int ti, tj, tk;       // tile coordinates
  int i0, j0, k0;       // first point
  int ni, nj, nk;       // extent (ragged at the high faces)
  bool si, sj, sk;      // a tile follows on axis i, j, k
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

// Claims the next tile; false when none is left.
template <class G>
__device__ __forceinline__ bool claim(const G& g, const int* order,
                                      int* counter, Tile* t) {
  __shared__ int claimed;
  if (threadIdx.x == 0) claimed = atomicAdd(counter, 1);
  __syncthreads();
  const int n = claimed;
  if (n >= g.ntiles) return false;
  int id = order[n];
  t->id = id;
  t->tk = id % g.ntk;
  t->tj = (id / g.ntk) % g.ntj;
  t->ti = id / (g.ntk * g.ntj);
  t->i0 = t->ti * G::bi;
  t->j0 = t->tj * G::bj;
  t->k0 = t->tk * G::bk;
  t->ni = min(G::bi, g.r1 - t->i0);
  t->nj = min(G::bj, g.r2 - t->j0);
  t->nk = min(G::bk, g.r3 - t->k0);
  t->si = t->ti + 1 < g.nti;
  t->sj = t->tj + 1 < g.ntj;
  t->sk = t->tk + 1 < g.ntk;
  return true;
}

// True once every thread has seen the flag set; each thread's load is
// an acquire, so each may then read what the flag's tile wrote.  A null
// flag (no such predecessor) is done.
__device__ __forceinline__ bool done(const int* flag) {
  return __syncthreads_and(flag == nullptr || ld_acquire(flag) != 0);
}

// Shared-memory index of tile point (li, lj, lk); the halo is at -1 (and
// at lk = -2 with a two-deep k-halo).
template <class G>
__device__ __forceinline__ int sidx(const G&, int li, int lj, int lk) {
  return (li + 1) * G::Q + (lj + 1) * G::P + lk + G::khalo;
}

template <class G>
__device__ __forceinline__ long long gidx(const G& g, int i, int j, int k) {
  return ((long long)i * g.r2 + j) * g.r3 + k;
}

template <class G, class V>
__device__ __forceinline__ V halo_at(const G& g, const V* R, int i, int j,
                                     int k) {
  return (i < 0 || j < 0 || k < 0) ? V(0) : __ldcg(R + gidx(g, i, j, k));
}

// With a two-deep k-halo: true for the tile that holds the k-2 neighbour
// of the next k-tile's first point, (0, 0, nk - 2), on the lattice's first
// row.
template <class G>
__device__ __forceinline__ bool holds_k2(const Tile& t) {
  return G::khalo == 2 && t.sk && t.ti == 0 && t.tj == 0;
}

// This thread's points of an n0 x n1 x n2 box, blockDim.x at a time in
// row-major order, as (a, b, c); next() advances without a division.
struct BoxWalk {
  int n0, n1, n2, a, b, c;
  __device__ __forceinline__ BoxWalk(int m0, int m1, int m2)
      : n0(m0), n1(m1), n2(m2) {
    int e = threadIdx.x;
    c = e % n2;
    e /= n2;
    b = e % n1;
    a = e / n1;
  }
  __device__ __forceinline__ bool ok() const { return a < n0; }
  __device__ __forceinline__ void next() {
    c += blockDim.x;
    while (c >= n2) {
      c -= n2;
      if (++b == n1) b = 0, ++a;
    }
  }
};

// Loads in flight per thread in the gathers: each round issues all its
// loads before the first store.
constexpr int kBatch = 8;
constexpr int kStageBatch = 16;

// Copies one face of the tile between R and its shared copy Rs (kLoad:
// R -> Rs, 0 outside the lattice; else Rs -> R).  The face's points
// are an n1 x n2 grid; map(b, c, &li, &lj, &lk) places grid point (b, c)
// in the tile.
template <bool kLoad, class G, class V, class Map>
__device__ __forceinline__ void copy_face(const G& g, const Tile& t, V* R,
                                          V* Rs, int n1, int n2, Map map) {
  BoxWalk w(1, n1, n2);
  while (w.ok()) {
    V v[kBatch];
    int s[kBatch];
    long long x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      s[u] = -1;
      if (w.ok()) {
        int li, lj, lk;
        map(w.b, w.c, &li, &lj, &lk);
        s[u] = sidx(g, li, lj, lk);
        if (kLoad) {
          v[u] = halo_at(g, R, t.i0 + li, t.j0 + lj, t.k0 + lk);
        } else {
          x[u] = gidx(g, t.i0 + li, t.j0 + lj, t.k0 + lk);
          v[u] = Rs[s[u]];
        }
        w.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s[u] >= 0) {
        if (kLoad)
          Rs[s[u]] = v[u];
        else
          R[x[u]] = v[u];
      }
  }
}

// Waits for the tile's <= 3 predecessors and loads the low face of R
// that each one completes as soon as it is done, so that only the last
// one's face is loaded on the critical path.  Face li = -1 (lj, lk in
// [-1, n)) is complete with tile (I-1, J, K), whose own predecessors hold
// its edges; face lj = -1 (li >= 0, lk in [-1, nk)) with (I, J-1, K);
// face lk = -1 (li, lj >= 0) with (I, J, K-1), and so is the point
// (0, 0, -2) of a two-deep halo on the lattice's first row.  A face
// outside the lattice reads 0 at once.
template <class G, class V>
__device__ __forceinline__ void wait_and_load_halo(const G& g,
                                                   const Tile& t,
                                                   const int* flags,
                                                   const V* R, V* Rs) {
  V* r = const_cast<V*>(R);
  const int* pred[3] = {t.ti > 0 ? flags + t.id - g.ntj * g.ntk : nullptr,
                        t.tj > 0 ? flags + t.id - g.ntk : nullptr,
                        t.tk > 0 ? flags + t.id - 1 : nullptr};
  bool todo[3] = {true, true, true};
  for (int left = 3; left > 0;) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (!todo[q] || !done(pred[q])) continue;
      if (q == 0) {
        copy_face<true>(g, t, r, Rs, t.nj + 1, t.nk + 1,
                        [](int b, int c, int* li, int* lj, int* lk) {
                          *li = -1, *lj = b - 1, *lk = c - 1;
                        });
      } else if (q == 1) {
        copy_face<true>(g, t, r, Rs, t.ni, t.nk + 1,
                        [](int b, int c, int* li, int* lj, int* lk) {
                          *li = b, *lj = -1, *lk = c - 1;
                        });
      } else {
        copy_face<true>(g, t, r, Rs, t.ni, t.nj,
                        [](int b, int c, int* li, int* lj, int* lk) {
                          *li = b, *lj = c, *lk = -1;
                        });
        if (G::khalo == 2 && t.ti == 0 && t.tj == 0 && t.tk > 0 &&
            threadIdx.x == 0)
          Rs[sidx(g, 0, 0, -2)] = __ldcg(R + gidx(g, 0, 0, t.k0 - 2));
      }
      todo[q] = false;
      --left;
    }
  }
}

// R on the tile's high faces that a later tile reads (the only points
// other tiles read), and the k-2 neighbour of the next k-tile.
template <class G, class V>
__device__ __forceinline__ void store_faces(const G& g, const Tile& t, V* R,
                                            V* Rs) {
  const int hi = t.ni - 1, hj = t.nj - 1, hk = t.nk - 1;
  if (t.si)
    copy_face<false>(g, t, R, Rs, t.nj, t.nk,
                     [=](int b, int c, int* li, int* lj, int* lk) {
                       *li = hi, *lj = b, *lk = c;
                     });
  if (t.sj)
    copy_face<false>(g, t, R, Rs, t.ni, t.nk,
                     [=](int b, int c, int* li, int* lj, int* lk) {
                       *li = b, *lj = hj, *lk = c;
                     });
  if (t.sk)
    copy_face<false>(g, t, R, Rs, t.ni, t.nj,
                     [=](int b, int c, int* li, int* lj, int* lk) {
                       *li = b, *lj = c, *lk = hk;
                     });
  if (holds_k2<G>(t) && threadIdx.x == 0)
    R[gidx(g, 0, 0, t.k0 + hk - 1)] = Rs[sidx(g, 0, 0, hk - 1)];
}

// The tile's point w: its lattice and shared indices.
template <class G>
__device__ __forceinline__ void tile_point(const G& g, const Tile& t,
                                           const BoxWalk& w, long long* x,
                                           int* s) {
  *x = gidx(g, t.i0 + w.a, t.j0 + w.b, t.k0 + w.c);
  *s = sidx(g, w.a, w.b, w.c);
}

// Coalesced write-back of the tile's R off the points store_faces wrote,
// and of T where the rule has types, kBatch points a thread per round.
template <class G, class Args, class V>
__device__ __forceinline__ void write_back(const G& g, const Tile& t,
                                           const Args& a, const V* Rs,
                                           const int* T) {
  const bool k2 = holds_k2<G>(t);
  BoxWalk w(t.ni, t.nj, t.nk);
  while (w.ok()) {
    long long x[kBatch];
    V r[kBatch];
    int tv[kBatch];
    bool rest[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      x[u] = -1;
      if (w.ok()) {
        int s;
        tile_point(g, t, w, &x[u], &s);
        rest[u] = !((t.si && w.a == t.ni - 1) || (t.sj && w.b == t.nj - 1) ||
                    (t.sk && w.c == t.nk - 1) ||
                    (k2 && w.a == 0 && w.b == 0 && w.c == t.nk - 2));
        r[u] = Rs[s];
        if constexpr (Args::kTypesOut) tv[u] = T[s];
        w.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (x[u] >= 0) {
        if (rest[u]) a.R[x[u]] = r[u];
        if constexpr (Args::kTypesOut) a.t_out[x[u]] = tv[u];
      }
  }
}

// The persistent loop of every kernel on these tiles.
template <class G, class Args>
__device__ __forceinline__ void run_tiles(const G& g, const int* order,
                                          int* flags, const Args& a) {
  using V = ValueOf<Args>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int m = G::entries;
  V* Rs = (V*)smem;
  V* X = Rs + m;
  int* T = (int*)(X + m);
  unsigned char* F = (unsigned char*)(Args::kArrays == 3 ? T + m : T);
  int* counter = flags + g.ntiles;
  const int lane = threadIdx.x;
  const int li = lane / G::bj, lj = lane % G::bj;
  Tile t;
  while (claim(g, order, counter, &t)) {
    stage(g, t, a, X, T, F);
    wait_and_load_halo(g, t, flags, a.R, Rs);
    __syncthreads();
    // step s: thread (li, lj) computes lk = s - li - lj, at c0 + s
    const bool active = li < t.ni && lj < t.nj;
    const int steps = t.ni + t.nj + t.nk - 2;
    const int c0 = sidx(g, li, lj, -li - lj);
    const int i = t.i0 + li, j = t.j0 + lj;
    for (int s = 0; s < steps; ++s) {
      int lk = s - li - lj;
      if (active && lk >= 0 && lk < t.nk)
        point(g, a, c0 + s, i, j, t.k0 + lk, Rs, X, T, F);
      __syncthreads();
    }
    // publish the points later tiles read, then write the rest
    store_faces(g, t, a.R, Rs);
    __threadfence();
    __syncthreads();
    if (lane == 0) st_release(flags + t.id, 1);
    write_back(g, t, a, Rs, T);
    __syncthreads();
  }
}

// One launch of `kernel` over the r1 x r2 x r3 lattice: G::threads-thread
// blocks, as many as can be resident (never more than there are tiles).
// ntiles must be the tile count of G's tile shape.
template <class G, class Args>
int launch(void (*kernel)(G, const int*, int*, Args), const Args& a, int r1,
           int r2, int r3, const int* order, int* flags, int ntiles,
           cudaStream_t st) {
  G g;
  g.r1 = r1, g.r2 = r2, g.r3 = r3;
  g.nti = (r1 + G::bi - 1) / G::bi;
  g.ntj = (r2 + G::bj - 1) / G::bj;
  g.ntk = (r3 + G::bk - 1) / G::bk;
  g.ntiles = ntiles;
  if ((long long)g.nti * g.ntj * g.ntk != ntiles)
    return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return 0;
  const size_t bytes = shared_bytes<G, Args>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    G::threads, bytes);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > ntiles) blocks = ntiles;
  kernel<<<(unsigned)blocks, G::threads, bytes, st>>>(g, order, flags, a);
  return (int)cudaGetLastError();
}

}  // namespace tiles
