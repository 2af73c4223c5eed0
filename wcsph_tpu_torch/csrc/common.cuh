// Shared by every kernel source of this directory: the grid geometry, the
// pair math, the neighbour loop and the fixed-order global sum.
//
//   * rows are particles sorted by cell, with per-cell start offsets
//     (Geom.start); cell c holds rows start[c] .. start[c + 1];
//   * each RECEIVING particle gets one thread, which loops over its 27
//     neighbour cells (the 3 z-neighbours of a cell are consecutive cell
//     ids, so the loop is 9 contiguous row ranges) and accumulates in
//     registers; r = x_i - x_j; pairs are cut to d^2 <= h^2, self excluded;
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

// Calls f(j, rx, ry, rz, d2, lj) for every listed neighbour j of row i,
// lj its liquid flag, in the list's order, which is the order of
// for_each_neighbor (the fill, nbr_list_fill in sweeps.cu, writes what that
// loop finds): the pair geometry is the same arithmetic on the same pairs,
// so a sum over the list has the bits of the same sum over the cells.
// Thread t of a warp reads slot 32 k + t of its slice, so each k is one
// coalesced line; the neighbour's position and flag come in one 16-byte
// record; padding slots are skipped, never summed as zero terms (+0.0 is
// not neutral at -0.0).
template <class F>
__device__ __forceinline__ void for_each_listed(const Geom& g, int i, F& f) {
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
    f(j, rx, ry, rz, d2, rj.w);
  }
}

// The same loop over the same candidates (the cells of Geom.pos), with the
// pair geometry taken at moved positions: x(j, p) fills p[3] for row j.
// A pair is cut by its distance at the moved positions.
template <class X, class F>
__device__ __forceinline__ void for_each_neighbor_at(const Geom& g, int i,
                                                     const X& x, F& f) {
  float pi[3];
  x(i, pi);
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
        float pj[3];
        x(j, pj);
        const float rx = pi[0] - pj[0];
        const float ry = pi[1] - pj[1];
        const float rz = pi[2] - pj[2];
        const float d2 = rx * rx + ry * ry + rz * rz;
        if (d2 <= g.h2) f(j, rx, ry, rz, d2);
      }
    }
  }
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
