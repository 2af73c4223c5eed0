// Shared by every kernel source of this directory: the grid geometry, the
// pair math, the neighbour loops and the fixed-order global sum.
//
//   * rows are particles sorted by cell, with per-cell start offsets
//     (Geom.start); cell c holds rows start[c] .. start[c + 1];
//   * each RECEIVING particle gets one thread, which loops over its 27
//     neighbour cells (the 3 z-neighbours of a cell are consecutive cell
//     ids, so the loop is 9 contiguous row ranges) and accumulates in
//     registers; r = x_i - x_j; pairs are cut to d^2 <= h^2, self excluded;
//   * the density sweep of DFSPH and PCISPH's predicted-density sweep run
//     that loop in two phases (for_each_neighbor_cut): each first cuts the
//     candidates, keeping the rows within h in a per-thread buffer of
//     shared memory, and then sums the pair terms over its own hits only,
//     in the same order; PCISPH's cut takes the positions of its 16-byte
//     records at the moved positions x*, the candidates staying those of
//     the cells; K5's sweeps of the steps without a list cut in registers
//     instead (for_each_neighbor_masked: a bit mask per 32 candidates);
//   * or, where the step has built its neighbour list (Geom.nl_idx, see
//     for_each_listed), walks that list: the same pairs in the same order,
//     with no candidate to cut, each neighbour's position and liquid flag
//     read as one 16-byte record (Geom.nl_rec);
//   * so no atomics and no capacity: no particle is ever dropped, and
//     every sum has a fixed order (the results repeat bit for bit);
//   * W and gradW use the sqrt form of kernels.py, the same arithmetic as
//     the plain PyTorch twins in dense_ops.py; the libraries are built with
//     -fmad=false so that each pair term rounds as the plain twin's does
//     (only the summation order differs).
//
// Global sums are a per-block fixed-order tree of partials plus a one-block
// reduction kernel in fixed order; no atomics, so the bits repeat from run
// to run.

#pragma once

#include <cuda_runtime.h>

constexpr int kBlock = 256;        // threads per block of every row kernel
constexpr int kReduceBlock = 1024; // threads of the partials reduction
constexpr float kEps = 1.0e-5f;    // gradW cut-off distance (kernels._EPS)
// Hits a receiver of for_each_neighbor_cut keeps before it sums them
// (engine.CUT_SLOTS): 40 x 256 x 4 bytes = 40 KB of shared memory a block.
constexpr int kCutSlots = 40;

// Mirror: engine._Geom (same field order).
struct Geom {
  const float* pos;  // (3, M) planar positions, rows sorted by cell
  const float* liq;  // (M,) 1.0 at liquid rows, 0.0 at boundary rows
  const int* cell;   // (M,) cell id of each row
  const int* start;  // (num_cells + 1,) first row of each cell
  int M, gx, gy, gz;
  float h, h2, vl, vs;  // support radius, h^2, liquid / boundary volume
  float w_sigma, gs_ml; // 8 / (pi h^3), 48 / (pi h^3)
  // The step's neighbour list (sliced ELL), or null where none was built:
  // slice s holds rows 32 s .. 32 s + 31; the k-th neighbour of row i is
  // nl_idx[nl_off[s] + 32 k + i % 32], k < (nl_off[s + 1] - nl_off[s]) / 32,
  // and -1 marks a padding slot.
  const int* nl_idx;
  const int* nl_off;
  // The list's record of every row, (x, y, z, liquid flag), written by the
  // fill: one 16-byte load per listed neighbour where the planar arrays
  // take four scattered 4-byte ones.
  const float4* nl_rec;
};

// ---------------------------------------------------------------------------
// Pair math (kernels.cubic_w_scalar / cubic_grad_scale)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float kernel_w(const Geom& g, float d2) {
  const float dist = sqrtf(fmaxf(d2, 0.0f));
  const float q = dist / g.h;
  const float inner = 6.0f * q * q * q - 6.0f * q * q + 1.0f;
  const float f = 1.0f - q;
  const float outer = 2.0f * f * f * f;
  const float w = q <= 0.5f ? inner : outer;
  return q <= 1.0f ? g.w_sigma * w : 0.0f;
}

__device__ __forceinline__ float kernel_gs(const Geom& g, float d2) {
  const float dist = sqrtf(fmaxf(d2, 0.0f));
  const float q = dist / g.h;
  const float inner = g.gs_ml * (3.0f * q - 2.0f) / g.h2;
  const float outer =
      -g.gs_ml * (1.0f - q) * (1.0f - q) / (fmaxf(dist, kEps) * g.h);
  const float s = q <= 0.5f ? inner : outer;
  return (dist > kEps && q <= 1.0f) ? s : 0.0f;
}

// Rest volume of a row from its liquid flag lj (a list record's .w) ...
__device__ __forceinline__ float volume_of(const Geom& g, float lj) {
  return lj != 0.0f ? g.vl : g.vs;
}

// ... or of row j.
__device__ __forceinline__ float volume(const Geom& g, int j) {
  return volume_of(g, g.liq[j]);
}

// Calls f(j, rx, ry, rz, d2) for every neighbour j of row i with
// d2 <= h^2, j != i, in a fixed order (dx, dy, then rows ascending).
template <class F>
__device__ __forceinline__ void for_each_neighbor(const Geom& g, int i,
                                                  F& f) {
  const int M = g.M;
  const float xi = g.pos[i], yi = g.pos[M + i], zi = g.pos[2 * M + i];
  const int c = g.cell[i];
  const int cz = c % g.gz;
  const int cy = (c / g.gz) % g.gy;
  const int cx = c / (g.gz * g.gy);
  const int z0 = max(cz - 1, 0);
  const int z1 = min(cz + 1, g.gz - 1);
  for (int dx = -1; dx <= 1; ++dx) {
    const int nx = cx + dx;
    if (nx < 0 || nx >= g.gx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int ny = cy + dy;
      if (ny < 0 || ny >= g.gy) continue;
      const int base = (nx * g.gy + ny) * g.gz;
      const int jb = g.start[base + z0];
      const int je = g.start[base + z1 + 1];
      for (int j = jb; j < je; ++j) {
        if (j == i) continue;
        const float rx = xi - g.pos[j];
        const float ry = yi - g.pos[M + j];
        const float rz = zi - g.pos[2 * M + j];
        const float d2 = rx * rx + ry * ry + rz * rz;
        if (d2 <= g.h2) f(j, rx, ry, rz, d2);
      }
    }
  }
}

// The same calls as for_each_neighbor, in the same order and with the same
// pair arithmetic, with the cut and the body apart but no shared memory:
// each (dx, dy) column's candidates are cut 32 at a time into a bit mask
// in a register, and f then runs over that chunk's set bits, lowest first,
// recomputing the geometry from the same loads (same bits).  The warp runs
// the body as often as its busiest lane has hits in the chunk, not at every
// candidate where any lane has one, and the L1 cache keeps its full size
// for the candidates' positions.
template <class F>
__device__ __forceinline__ void for_each_neighbor_masked(const Geom& g, int i,
                                                         F& f) {
  const int M = g.M;
  const float xi = g.pos[i], yi = g.pos[M + i], zi = g.pos[2 * M + i];
  const int c = g.cell[i];
  const int cz = c % g.gz;
  const int cy = (c / g.gz) % g.gy;
  const int cx = c / (g.gz * g.gy);
  const int z0 = max(cz - 1, 0);
  const int z1 = min(cz + 1, g.gz - 1);
  for (int dx = -1; dx <= 1; ++dx) {
    const int nx = cx + dx;
    if (nx < 0 || nx >= g.gx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int ny = cy + dy;
      if (ny < 0 || ny >= g.gy) continue;
      const int base = (nx * g.gy + ny) * g.gz;
      const int je = g.start[base + z1 + 1];
      for (int j0 = g.start[base + z0]; j0 < je; j0 += 32) {
        const int n = min(32, je - j0);
        unsigned hit = 0u;
        for (int k = 0; k < n; ++k) {
          const int j = j0 + k;
          const float rx = xi - g.pos[j];
          const float ry = yi - g.pos[M + j];
          const float rz = zi - g.pos[2 * M + j];
          if (j != i && rx * rx + ry * ry + rz * rz <= g.h2) hit |= 1u << k;
        }
        while (hit != 0u) {
          const int j = j0 + __ffs(hit) - 1;
          hit &= hit - 1u;
          const float rx = xi - g.pos[j];
          const float ry = yi - g.pos[M + j];
          const float rz = zi - g.pos[2 * M + j];
          f(j, rx, ry, rz, rx * rx + ry * ry + rz * rz);
        }
      }
    }
  }
}

// Where the cut loop reads a row's position: the planar Geom.pos ...
struct PlanarPos {
  const float* pos;
  int M;
  __device__ float3 operator()(int j) const {
    return make_float3(__ldg(pos + j), __ldg(pos + M + j),
                       __ldg(pos + 2 * M + j));
  }
};

// ... or a 16-byte record per row, (x, y, z, liquid flag): one load.
struct RecordPos {
  const float4* rec;
  __device__ float3 operator()(int j) const {
    const float4 r = __ldg(rec + j);
    return make_float3(r.x, r.y, r.z);
  }
};

// The same calls as for_each_neighbor, in the same order and with the same
// pair arithmetic, but the cut and the pair body run apart.  In the single
// loop a warp's 32 receivers (about 4 cells) scan different windows of ~216
// candidates each, and the body runs whenever ANY lane has a hit there, so
// every lane pays the body on most candidates though it keeps ~12% of
// them.  Here the thread first cuts (d2 <= h^2, j != i) and appends each
// row it keeps to its own slots of a shared buffer, `slot` (slot k at
// slot[k * kBlock]: each lane in its own bank); then it runs f over its own
// hits, recomputing the geometry from the same loads (same bits).  Lanes
// then diverge only on their hit counts (~27), not on the union of the
// warp's hits.  A receiver with more than kCutSlots hits sums the full
// buffer when the next hit comes and carries on cutting: no hit is
// dropped, none added twice, the order is kept.  The candidates are those
// of the cells (Geom.cell, Geom.start); the positions, of the cut and of
// the pair geometry, are x(j) (PlanarPos: Geom.pos itself; RecordPos:
// moved positions).
template <class X, class F>
__device__ __forceinline__ void for_each_neighbor_cut(const Geom& g, int i,
                                                      const X& x, int* slot,
                                                      F& f) {
  const float3 pi = x(i);
  int n = 0;
  auto sum = [&]() {
    for (int k = 0; k < n; ++k) {
      const int j = slot[k * kBlock];
      const float3 pj = x(j);
      const float rx = pi.x - pj.x;
      const float ry = pi.y - pj.y;
      const float rz = pi.z - pj.z;
      f(j, rx, ry, rz, rx * rx + ry * ry + rz * rz);
    }
    n = 0;
  };
  const int c = g.cell[i];
  const int cz = c % g.gz;
  const int cy = (c / g.gz) % g.gy;
  const int cx = c / (g.gz * g.gy);
  const int z0 = max(cz - 1, 0);
  const int z1 = min(cz + 1, g.gz - 1);
  for (int dx = -1; dx <= 1; ++dx) {
    const int nx = cx + dx;
    if (nx < 0 || nx >= g.gx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int ny = cy + dy;
      if (ny < 0 || ny >= g.gy) continue;
      const int base = (nx * g.gy + ny) * g.gz;
      const int jb = g.start[base + z0];
      const int je = g.start[base + z1 + 1];
      for (int j = jb; j < je; ++j) {
        if (j == i) continue;
        const float3 pj = x(j);
        const float rx = pi.x - pj.x;
        const float ry = pi.y - pj.y;
        const float rz = pi.z - pj.z;
        if (rx * rx + ry * ry + rz * rz <= g.h2) {
          if (n == kCutSlots) sum();
          slot[n++ * kBlock] = j;
        }
      }
    }
  }
  sum();
}

// Calls f(j, rx, ry, rz, d2, rj) for every listed neighbour j of row i,
// rj its record (x, y, z, liquid flag) as loaded, in the list's order,
// which is the order of for_each_neighbor (the fill, nbr_list_fill in
// sweeps.cu, writes what that loop finds): the pair geometry is the same
// arithmetic on the same pairs, so a sum over the list has the bits of the
// same sum over the cells.  Thread t of a warp reads slot 32 k + t of its
// slice, so each k is one coalesced line; the neighbour's position and
// flag come in one 16-byte record; padding slots are skipped, never summed
// as zero terms (+0.0 is not neutral at -0.0).
template <class F>
__device__ __forceinline__ void for_each_listed_record(const Geom& g, int i,
                                                       F& f) {
  const float4 ri = __ldg(g.nl_rec + i);
  const int b = g.nl_off[i >> 5];
  const int n = (g.nl_off[(i >> 5) + 1] - b) >> 5;
  const int* slot = g.nl_idx + b + (i & 31);
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const int j = __ldg(slot + 32 * k);
    if (j < 0) continue;
    const float4 rj = __ldg(g.nl_rec + j);
    const float rx = ri.x - rj.x;
    const float ry = ri.y - rj.y;
    const float rz = ri.z - rj.z;
    const float d2 = rx * rx + ry * ry + rz * rz;
    f(j, rx, ry, rz, d2, rj);
  }
}

// The same walk, calling f(j, rx, ry, rz, d2, lj) with lj the neighbour's
// liquid flag (its record's .w).
template <class F>
__device__ __forceinline__ void for_each_listed(const Geom& g, int i, F& f) {
  auto flag = [&](int j, float rx, float ry, float rz, float d2,
                  const float4& rj) { f(j, rx, ry, rz, d2, rj.w); };
  for_each_listed_record(g, i, flag);
}

// Fixed-order tree over one block; thread 0 stores the block's partial.
__device__ __forceinline__ void block_partial(float v, float* partials) {
  __shared__ float sh[kBlock];
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0];
}

// out[0] = add + sum(partials[0..n)), one block, fixed order.
static __global__ void reduce_partials_kernel(
    const float* __restrict__ partials, int n, float add, float* out) {
  __shared__ float sh[kReduceBlock];
  float s = 0.0f;
  for (int k = threadIdx.x; k < n; k += kReduceBlock) s += partials[k];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceBlock / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = add + sh[0];
}

static inline int blocks_of(int m) {
  return m > 0 ? (m + kBlock - 1) / kBlock : 1;
}
