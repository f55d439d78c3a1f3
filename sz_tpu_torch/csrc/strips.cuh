// The strip machinery of the Lorenzo-type recurrences on Hopper (sm_90a):
// K10/K11 (classic.cu, the classic SZ1.4 codec) and K1d/K2d (lorenzo.cu,
// the SZ2.1 regression codec's Lorenzo recurrence on float64 fields).  It
// does not depend on the point rule.
//
// A recurrence fits it when point (i, j, k) reads only its own row's last
// two points (k-1, k-2), the row above (j-1) and the plane above (i-1) at
// k and k-1: the seven Lorenzo neighbours A (k-1), B (j-1), C (i-1),
// D (j-1,k-1), E (i-1,j-1), F (i-1,k-1), G (i-1,j-1,k-1), and A2 (k-2).
//
// Design: warp strips, neighbours in registers, hand-offs by chunk.
// - A warp walks a strip: lane l owns row j0 + l of one plane i and walks
//   k skewed by its lane, k = s - l at step s.  A and A2 are the lane's
//   own last two results; B comes from lane l - 1 by __shfl_up_sync (its
//   result of the previous step) and D is the B of the previous step; C
//   and E are read from plane i - 1's ring (rows l and l - 1 of the same
//   strip), F and G are the C and E of the previous step.  Every lane
//   runs every shuffle; only the stores are predicated at the ragged
//   ramps, so a lane computes garbage off the lattice and the rule
//   selects what it reads there.  Lane 0 takes B (and E) from the row
//   above the strip, the ring's row -1.  A group of steps first loads all
//   its inputs from the rings into registers, so no shared load sits on
//   the chain, and stores its results after.
// - Rings.  Each warp keeps its results in a ring of 33 rows (row -1: the
//   row above the strip) x kRing slots (the rule's: 64 or 32), row r's
//   column k at slot (k + r) mod kRing, so that every lane of a step
//   reads and writes one slot index (pitch kRing + 1: 32 banks).  Its
//   staged inputs lie the same way, 32 rows of the rule's arrays, staged
//   by cp.async a chunk ahead of the walk; a rule may write a point's
//   type over its consumed inputs; the types (and R, when asked for) go
//   back to device memory from the rings, coalesced by row.  The traffic
//   goes by chunks of one of two kinds (the rule's kSlotChunks):
//   - column chunks (K10/K11): columns 16c to 16c + 15 of every row,
//     written out three phases after it is walked (lane 31 ends it 31
//     steps after lane 0), so a ring holds 64 slots;
//   - slot chunks (K1d/K2d): what steps 16c to 16c + 15 touch, row r's
//     columns 16c - r to 16c + 15 - r, written out one phase after it,
//     so a ring of 32 slots holds two chunks and the lag between two
//     warps, and a double block holds twice the warps.
// - Blocks.  Rank 3: a block's W warps walk W consecutive planes of one
//   strip; warp w reads plane i - 1 from warp w - 1's ring once that
//   warp's progress mark (a shared-memory counter raised, release, every
//   Group steps) has passed the group, and warp w - 1 runs at most a
//   ring's length ahead of warp w.  Rank 2: the warps walk W consecutive
//   strips, lane 31 of warp w writing the row above warp w + 1's strip
//   into that warp's ring.  No __syncthreads runs inside the step loop.
// - Between blocks: each block publishes the last row of each of its
//   planes (rank 2: of its last strip) by chunks as it writes them out
//   and, rank 3, its last plane by slot chunks (slot = column + row: what
//   the next group's warp 0 reads in one phase, complete 16 steps after
//   its first), into device scratch, each chunk followed by a release
//   flag (the count of chunks published; with slot chunks, a row's column
//   col is out with chunk (col + 31) / 16); a consumer waits on the flag
//   (acquire, with __nanosleep backoff) and reads with __ldcg.
// - One launch a call: work units (volume, plane group, strip group) are
//   claimed from a global counter in the order gpu/strips.strip_order
//   makes (by diagonal g + s, then volume, so a 4-D field's volumes run
//   side by side), every unit's predecessors earlier, so a block waits
//   only on units that running blocks claimed.
//
// What bounds it on this card: the chain of steps, r1 + r2 + r3 - 2 of
// them plus what the hand-offs add (a group a plane, a slot chunk a plane
// group, 32 steps and a group a strip), each step the latency of one
// point's chain (the shuffle, the predictor's adds, the rule's
// arithmetic); and, where a block's rings leave few warps an SM, the
// warps' throughput.  Plain loads of device memory inside the walk would
// stall at the next release (a progress mark every group): a rule stages
// everything by cp.async.
//
// A point rule is a class Rule with
//   V            the value type of the rings and of R (float or double);
//   kRank        2 or 3 (the strip form);
//   W            warps a block;
//   kRing        slots of a ring row (a power of 2: 64 with column
//                chunks, 32 or more with slot chunks);
//   kSlotChunks  staging and output by slot chunks (else column chunks);
//   kStageBytes  shared bytes of a warp's staging region (the rule lays
//                its arrays out there: Ring<kRing>::kRingS slots each);
//   Args         the kernel's arguments, with a.R (V*) the reconstruction,
//                null where it is not asked for;
//   In           a point's staged inputs in registers;
//   Lane         a lane's state over one walk, made by
//                Lane(a, st, row0, lane, rows, r3) (st: the warp's
//                staging region; row0: the strip's first row, base =
//                row0 * r3 its first point), with
//     stage_chunk(a, st, base, c, lane, rows, r3)  stage chunk c of the
//                strip (chunks come in order 0, 1, ...; entry
//                e = r * kPitch + slot) by cp.async, committed by the
//                walk with the chunk;
//     load(a, st, e, k)  the staged inputs of the lane's point at entry e,
//                column k, into registers (off the chain);
//     group(a, xin, s, lane, rows, r3, run)  run the group's steps:
//                run(std::false_type{}) or, for a rule with a second path,
//                run(std::true_type{});
//     point(path, a, q, x, i, j, k, A, A2, B, D, C, E, F, G, &t)  the
//                point's reconstruction from its neighbours as the ring
//                holds them (the rule selects its boundary values), its
//                type in t where it has one;
//     keep(st, e, x, t)  after the step: what stays in the staging slot
//                (a type written over the consumed inputs);
//     out(a, st, e, gi)  output of the rule's own arrays at lattice index
//                gi (R and the hand-offs are the header's).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace strips {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLanes = 32;      // rows of a strip, one a lane
constexpr int kChunk = 16;      // steps a slot chunk: staging, output, hand-off
constexpr int kDone = 1 << 30;  // the progress mark of a finished warp

// The rings of kRing slots a row.
template <int kRing>
struct Ring {
  static_assert(kRing >= 2 * kChunk && (kRing & (kRing - 1)) == 0,
                "two slot chunks, a power of 2");
  static constexpr int kPitch = kRing + 1;
  static constexpr int kMask = kRing - 1;
  static constexpr int kRingV = (kLanes + 1) * kPitch;  // a value ring
  static constexpr int kRingS = kLanes * kPitch;        // a staging array
};

// Steps between two progress marks of a warp: a rank-3 warp's plane is
// read by the next warp a group behind, a rank-2 warp's last row 32
// steps behind.
template <int kRank>
struct Group {
  static constexpr int n = kRank == 3 ? 4 : 8;
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

// Dynamic shared memory of a block of rule Rule: W + 1 value rings (ring 0
// the plane above warp 0, read from device memory; ring w + 1 warp w's),
// W staging regions, the progress marks and the claimed unit.
template <class Rule>
constexpr size_t shared_bytes() {
  return (size_t)(Rule::W + 1) * Ring<Rule::kRing>::kRingV *
             sizeof(typename Rule::V) +
         (size_t)Rule::W * Rule::kStageBytes +
         (size_t)(Rule::W + 1) * sizeof(int);
}

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

// Eight bytes at an 8-byte aligned src, of which the first n (0 to 8)
// are read and the rest zero-filled.
__device__ __forceinline__ void cp_async_zfill8(void* dst, const void* src,
                                                int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
               "l"(src), "r"(n)
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

// Chunk c of one input array into a staging array X of the warp's
// region, by cp.async: half a warp a row, row r's columns 16c to 16c + 15
// (a column chunk) or 16c - r to 16c + 15 - r (a slot chunk).
template <int kRing, bool kSlots, class S>
__device__ __forceinline__ void stage_copy(const S* src, S* X,
                                           long long base, int c, int lane,
                                           int rows, int r3) {
  using G = Ring<kRing>;
  const int x = c * kChunk + (lane & 15);  // the slot chunk's slot, or
                                           // the column chunk's column
#pragma unroll 4
  for (int rr = 0; rr < (rows + 1) / 2; ++rr) {
    const int r = 2 * rr + (lane >> 4);
    const int col = kSlots ? x - r : x;
    if (r < rows && col >= 0 && col < r3)
      cp_async(X + r * G::kPitch + ((col + r) & G::kMask),
               src + base + (long long)r * r3 + col);
  }
}

// A slot chunk c of a full strip whose rows all lie on the lattice:
// columns 16c - 31 to 16c + 15 (its output skips the per-point bounds,
// instructions that in 2-D lie on the chain).
__device__ __forceinline__ bool interior_chunk(int c, int rows, int r3) {
  return rows == kLanes && c * kChunk - (kLanes - 1) >= 0 &&
         c * kChunk + kChunk <= r3;
}

// The chunks a published last row must count before its columns up to
// col are out (col < r3).
template <bool kSlots>
__device__ __forceinline__ int row_chunks(int col) {
  return (kSlots ? col + kLanes - 1 : col) / kChunk + 1;
}

// Warp w's walk of unit u = (v, gi, si).
template <class Rule>
__device__ __forceinline__ void walk(const Geo<typename Rule::V>& g,
                                     const typename Rule::Args& a, int u,
                                     int v, int gi, int si,
                                     typename Rule::V* rings,
                                     unsigned char* stage, int* mark) {
  using V = typename Rule::V;
  using In = typename Rule::In;
  using G = Ring<Rule::kRing>;
  constexpr int kRank = Rule::kRank;
  constexpr int W = Rule::W;
  constexpr int kG = Group<kRank>::n;
  constexpr int kRing = Rule::kRing, kPitch = G::kPitch, kMask = G::kMask;
  constexpr bool kSlots = Rule::kSlotChunks;
  // chunks are output (and the last rows published) kLag phases after
  // they are walked
  constexpr int kLag = kSlots ? 1 : 3;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = kRank == 3 ? gi * W + w : 0;
  const int j0 = kLanes * (kRank == 3 ? si : si * W + w);
  if (i >= g.r1 || j0 >= g.r2) {
    if (lane == 0) st_release_cta(mark + w, kDone);
    return;
  }
  const int rows = min(kLanes, g.r2 - j0);
  const int r3 = g.r3;
  V* up = rings + w * G::kRingV;  // plane i - 1: ring 0 or warp w - 1's
  V* own = up + G::kRingV;        // this warp's; row -1 the row above
  V* next = own + G::kRingV;      // (rank 2) warp w + 1's
  unsigned char* st = stage + (size_t)w * Rule::kStageBytes;
  const bool has_next = w + 1 < W;
  const bool feed_next =
      kRank == 2 && has_next && rows == kLanes && j0 + kLanes < g.r2;
  const long long row0 = (long long)(v * g.r1 + i) * g.r2 + j0;
  const long long base = row0 * r3;
  const int nc = g.nchunks;
  const int last_step = r3 + rows - 2;
  const int xs = r3 + kLanes;                          // slots a plane row
  const int nsc = (last_step + kChunk) / kChunk;       // slot chunks
  // the row above the strip (a strip of 32 rows above): its flag, values
  // and the slot chunks it counts once complete
  const int* src_flag = nullptr;
  const V* src_row = nullptr;
  const int src_done = row_chunks<kSlots>(r3 - 1);
  if (si > 0 && (kRank == 3 || w == 0)) {
    src_flag = g.flags + (u - 1) * (W + 1) + (kRank == 3 ? w : W - 1);
    src_row = g.rows + ((long long)(v * g.ns + si - 1) * g.r1 + i) * r3;
  }
  const bool pub_rows = (kRank == 3 || w == W - 1) && si + 1 < g.ns;
  const bool pub_plane = kRank == 3 && w == W - 1 && gi + 1 < g.ng;
  typename Rule::Lane L(a, st, row0, lane, rows, r3);

  // chunk c, complete: the rule's own outputs, R where asked for, the
  // published last row and its flag.  With slot chunks the last row and
  // its flag go first, so that the release waits on no bulk store of the
  // chunk (with column chunks that order measured slower)
  auto publish_row = [&](int c, int col, const V& val) {
    if (col >= 0 && col < r3)
      g.rows[((long long)(v * g.ns + si) * g.r1 + i) * r3 + col] = val;
  };
  auto release_row = [&](int c) {
    __syncwarp();
    if (lane == 0) st_release(g.flags + u * (W + 1) + w, c + 1);
  };
  auto output = [&](int c) {
    const int x = c * kChunk + (lane & 15);  // slot (slot chunk) or column
    if constexpr (kSlots) {
      // every lane's points lie on one slot; row r's point at lattice
      // index gx, one row pair a step (gx += 2 r3 - 2)
      if (pub_rows) {
        const int col = x - (kLanes - 1);
        if (lane < 16)
          publish_row(c, col, own[kLanes * kPitch + (x & kMask)]);
        release_row(c);
      }
      const int h = lane >> 4, e = x & kMask;
      long long gx = base + (long long)h * r3 + x - h;
      if (interior_chunk(c, rows, r3)) {
#pragma unroll 4
        for (int rr = 0; rr < kLanes / 2; ++rr, gx += 2ll * r3 - 2) {
          const int r = 2 * rr + h;
          L.out(a, st, r * kPitch + e, gx);
          if (a.R) a.R[gx] = own[(r + 1) * kPitch + e];
        }
      } else {
#pragma unroll 4
        for (int rr = 0; rr < (rows + 1) / 2; ++rr, gx += 2ll * r3 - 2) {
          const int r = 2 * rr + h;
          const int col = x - r;
          if (r < rows && col >= 0 && col < r3) {
            L.out(a, st, r * kPitch + e, gx);
            if (a.R) a.R[gx] = own[(r + 1) * kPitch + e];
          }
        }
      }
    } else {
#pragma unroll 4
      for (int rr = 0; rr < (rows + 1) / 2; ++rr) {
        const int r = 2 * rr + (lane >> 4);
        const int col = x;
        if (r < rows && col >= 0 && col < r3) {
          const int e = (col + r) & kMask;
          const long long gx = base + (long long)r * r3 + col;
          L.out(a, st, r * kPitch + e, gx);
          const V val = own[(r + 1) * kPitch + e];
          if (a.R) a.R[gx] = val;
          if (pub_rows && r == kLanes - 1) publish_row(c, col, val);
        }
      }
      if (pub_rows) release_row(c);
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
    // (c + 1 written out for column chunks: the same value through
    // row_chunks compiled to a markedly slower K10 on the H100)
    const int need =
        kSlots ? min(row_chunks<kSlots>(c * kChunk + kChunk - 1), src_done)
               : c + 1;
    if (src_row) {
      wait_flag(src_flag, need);
      if (lane < kChunk && col < r3)
        own[(col - 1) & kMask] = __ldcg(src_row + col);
    }
    if (kRank == 3 && w == 0 && gi > 0 && si > 0) {
      wait_flag(g.flags + (u - g.ns - 1) * (W + 1) + W - 1, need);
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

  V A = V(0), A2 = V(0), Bp = V(0), Cp = V(0), Ep = V(0);

  // One group of kG steps from step s.
  auto group = [&](int s) {
    // the plane (rank 3) or the last row (rank 2) this group reads is
    // done; the next warp has read what this group overwrites
    if (w > 0) wait_mark(mark + w - 1, s + kG + (kRank == 3 ? 0 : 31));
    if (has_next)
      wait_mark(mark + w + 1,
                s + kG - (kRank == 3 ? kRing - 1 : kRing + kLanes - 1));
    // the group's inputs, all ready now, loaded before any of its
    // stores: the staged inputs, the row above (row -1) and, rank 3,
    // plane i - 1 (C at slot s, E one row up at slot s - 1)
    In xin[kG];
    V hbv[kG], Cv[kG], Ev[kG];
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int x = (s + q) & kMask, xm = (s + q - 1) & kMask;
      xin[q] = L.load(a, st, lane * kPitch + x, s + q - lane);
      hbv[q] = own[xm];
      if constexpr (kRank == 3) {
        Cv[q] = up[(lane + 1) * kPitch + x];
        Ev[q] = up[lane * kPitch + xm];
      } else {
        Cv[q] = Ev[q] = V(0);
      }
    }
    V Rv[kG];
    int tv[kG];
    // the point steps: registers and shuffles only
    auto run = [&](auto path) {
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const int k = s + q - lane;
        V B = __shfl_up_sync(kFull, A, 1);
        if (lane == 0) B = hbv[q];
        const int j = j0 + lane;
        const V R = L.point(path, a, q, xin[q], i, j, k, A, A2, B, Bp, Cv[q],
                            Ev[q], Cp, Ep, &tv[q]);
        Rv[q] = R;
        A2 = A;
        A = R;
        Bp = B;
        Cp = Cv[q];
        Ep = Ev[q];
      }
    };
    L.group(a, xin, s, lane, rows, r3, run);
    // the group's results into the rings
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int x = (s + q) & kMask;
      const int k = s + q - lane;
      const bool act = lane < rows && k >= 0 && k < r3;
      if (act) {
        own[(lane + 1) * kPitch + x] = Rv[q];
        L.keep(st, lane * kPitch + x, xin[q], tv[q]);
      }
      if (feed_next && lane == kLanes - 1 && act)
        next[(s + q - kLanes) & kMask] = Rv[q];
    }
    __syncwarp();
    if (lane == 0) st_release_cta(mark + w, s + kG);
  };

  // Phase p: steps kChunk p to kChunk p + kChunk - 1; its start writes out
  // chunk p - kLag (complete) and publishes slot chunk p - 1 of the last
  // plane, stages chunk p + 1, and loads column chunk p of the rows above
  // (while the producing warp runs ahead: this warp waits for it next).
  const int nstage = kSlots ? nsc : nc;  // chunks staged and output
  L.stage_chunk(a, st, base, 0, lane, rows, r3);
  cp_async_commit();
  for (int p = 0; p < nstage + kLag; ++p) {
    const int s0 = p * kChunk;
    if (p >= kLag) output(p - kLag);
    if (pub_plane && p >= 1 && p - 1 < nsc) publish_plane(p - 1);
    __syncwarp();
    if (p + 1 < nstage) L.stage_chunk(a, st, base, p + 1, lane, rows, r3);
    cp_async_commit();
    cp_async_wait_prior();  // chunk p has landed
    __syncwarp();
    if (p < nc) {
      // the ring's row -1 overwrites columns warp w + 1 read as E
      if (kRank == 3 && has_next)
        wait_mark(mark + w + 1, s0 + kChunk - kRing);
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
template <class Rule>
__device__ __forceinline__ void run_strips(const Geo<typename Rule::V>& g,
                                           const typename Rule::Args& a) {
  using V = typename Rule::V;
  extern __shared__ __align__(16) unsigned char smem[];
  V* rings = reinterpret_cast<V*>(smem);
  unsigned char* stage = reinterpret_cast<unsigned char*>(
      rings + (Rule::W + 1) * Ring<Rule::kRing>::kRingV);
  int* mark = reinterpret_cast<int*>(stage + (size_t)Rule::W * Rule::kStageBytes);
  int* claimed = mark + Rule::W;
  int* counter = g.flags + g.nunits * (Rule::W + 1);
  while (true) {
    if (threadIdx.x == 0) *claimed = atomicAdd(counter, 1);
    if ((threadIdx.x & 31) == 0) mark[threadIdx.x >> 5] = 0;
    __syncthreads();
    const int n = *claimed;
    if (n >= g.nunits) break;
    const int u = g.order[n];
    const int si = u % g.ns, gi = (u / g.ns) % g.ng, v = u / (g.ns * g.ng);
    walk<Rule>(g, a, u, v, gi, si, rings, stage, mark);
    __syncthreads();
  }
}

// The unit grid of a lattice for blocks of W warps: per volume (ng, ns)
// as Geo's note says.
template <int W, class V>
int make_geo(Geo<V>* g, int rank, int nvol, int r1, int r2, int r3,
             const int* order, int* flags, V* rows, V* planes, int nunits) {
  const int nstrips = (r2 + kLanes - 1) / kLanes;
  g->nvol = nvol, g->r1 = rank == 2 ? 1 : r1, g->r2 = r2, g->r3 = r3;
  g->ng = rank == 2 ? 1 : (r1 + W - 1) / W;
  g->ns = rank == 2 ? (nstrips + W - 1) / W : nstrips;
  g->nchunks = (r3 + kChunk - 1) / kChunk;
  g->order = order, g->flags = flags, g->rows = rows, g->planes = planes;
  g->nunits = nunits;
  if ((rank == 2 && nvol != 1) ||
      (long long)nvol * g->ng * g->ns != nunits)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One launch of `kernel` (rule Rule): W warps a block, as many blocks as can
// be resident (never more than there are units).
template <class Rule>
int launch(void (*kernel)(Geo<typename Rule::V>, typename Rule::Args),
           const Geo<typename Rule::V>& g, const typename Rule::Args& a,
           cudaStream_t st) {
  if (g.nunits == 0) return 0;
  const size_t bytes = shared_bytes<Rule>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    Rule::W * 32, bytes);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > g.nunits) blocks = g.nunits;
  kernel<<<(unsigned)blocks, Rule::W * 32, bytes, st>>>(g, a);
  return (int)cudaGetLastError();
}

}  // namespace strips
