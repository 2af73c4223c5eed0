// Hand-written Hopper (sm_90a) kernels of the surface reconstruction: the
// scalar field at the reconstruction points (mc_field, plain and
// anisotropic), the weighted moments of the anisotropy estimator
// (aniso_moments) and its matrices G (aniso_g).
//
// No Pallas kernel corresponds to these.  The JAX package computes them in
// XLA: mc_field_packed (wcsph_tpu/surface/field.py:57) as a packed window
// sweep of the grid points against the 27 shifted particle cells, and
// aniso.compute (wcsph_tpu/surface/aniso.py:45) as two window sweeps (the
// weighted mean, then the weighted covariance about it and the neighbour
// count) and a batched 3x3 jnp.linalg.eigh.  The port's plain twin of G
// runs torch.linalg.eigh; on the card its batched cuSOLVER call refuses
// the flagship's 1.1M matrices at once (CUSOLVER_STATUS_INVALID_VALUE),
// hence aniso_g.
//
//   * mc_field: one thread per reconstruction point (MC_SUB^3 = 64 points
//     a cell: 4 per axis, h / 4 apart), one block per kFieldZ cells along
//     z, two warps a cell.  All points of a cell share the cell's 27-cell
//     window (binned at the particles' own positions), and the block's
//     cells share the union of their windows (9 columns of kFieldZ + 2
//     cells), which the block walks once, kFieldThreads candidates at a
//     time: each thread loads one, and the candidates whose coefficient is
//     not 0 (liquid, above the density gate: the wrapper's coeff) are
//     compacted in window order into shared memory as 16-byte rows
//     (position, coefficient; anisotropic also G and the candidate's reach).
//     Each warp owns a box of its cell's points (2 x 4 x 4) and keeps, by a
//     ballot, the staged candidates of its cell's window whose distance from
//     the box is within their reach: h, or anisotropic the radius past which
//     |2 G r| > h (aniso_g's radius), both with a margin for rounding.  A
//     candidate it drops is past the support at every point of the box, so
//     W of it is exactly 0 there.  Each lane then sums coeff W over the kept
//     ones at its own point, W only where d^2 is within h^2 (with the same
//     margin): every nonzero term of the whole window, in window order, so
//     the old one-cell kernel's bits.  (A lane cutting the kept ones into a
//     bit mask first, and summing its own hits, ran no faster plain and
//     8-21% slower anisotropic; a block over 1 or 4 cells was no faster
//     than over 2.)  A window with no such candidate loads no pair (the
//     ~60% of the flagship's cells away from the liquid).  Each thread writes its own element of the dense field
//     (gx 4, gy 4, gz 4).  Bound: the pair evaluations, ~34 terms a point
//     within the support of the ~216 candidates of its window.
//   * aniso_moments: one thread per liquid receiver, one launch.  The
//     receiver cuts each (dx, dy) column of its window, 32 candidates at a
//     time, into a bit mask of its pairs within h (the register-mask cut of
//     common.cuh's for_each_neighbor_masked: reconstruction builds its own
//     grid and no neighbour list) and keeps the mask of each column's first
//     chunk in shared memory (9 words a thread: in registers they cost the
//     kernel half its resident blocks).  A first walk of the hits sums w
//     and w x_j over liquid neighbours, w = 1 - (d / 2h)^3; the receiver
//     forms its weighted mean in registers; a second walk sums the six
//     products w d_a d_b of d = x_j - mean, and the count of all pairs.
//     The second walk takes each column's first chunk from its kept mask
//     and cuts a column's later chunks again (rare: more than 32
//     candidates in three cells of a column), the same hits in the same
//     order, so the bits of the former two launches.  The 11 rows are
//     written once.  (Walking a neighbour list of the grid, at depth 8,
//     took a third of this kernel's device time, but building the list,
//     its offsets, fill and sizing read, cost more: the whole anisotropic
//     surface_field ran 0-4% slower with it.)  Bound: the candidate scan,
//     as K5's list-less sweeps.
//   * aniso_g: one thread per row, a 3x3 Jacobi eigendecomposition of the
//     covariance in registers, the spectral clamp, G and mc_field's reach
//     of the row.  Bound: bytes.
//
// A launch returns cudaGetLastError().

#include "common.cuh"

constexpr int kSub = 4;                        // dense_ops.MC_SUB
constexpr int kPoints = kSub * kSub * kSub;    // points of a cell
constexpr int kFieldZ = 2;                     // cells of a field block, in z
constexpr int kFieldThreads = kPoints * kFieldZ;
constexpr int kFieldWarps = kFieldThreads / 32;
constexpr int kZSpan = kFieldZ + 2;            // z cells of a block's window
// Relative margin of the field's cuts: a candidate is dropped only where
// |r| exceeds its reach, or d^2 exceeds h^2, by this much, far above the
// rounding of the pair's float arithmetic, so a dropped term is one that
// kernel_w returns as exactly 0.
constexpr float kReachMargin = 1.0e-3f;
// aniso_g's reach is capped at this many h: no candidate of a window lies
// farther from a point of the cell (2 sqrt(3) h between binned positions,
// plus the smoothed centre's move of at most 0.95 h).
constexpr float kReachCap = 5.0f;

// The reconstruction points of a cell: the grid's origin, its cell size and
// the offsets k h / 4 along an axis (dense_ops.field_offsets), the
// candidates' reach (anisotropic) and the dense field written.
struct FieldArgs {
  const float* x;      // (3, M) positions the field is evaluated at
  const float* coeff;  // (M,) m / max(rho, 1) where gated in, else 0
  const float* G;      // (9, M) row-major G, or null (plain kernel)
  const float* reach;  // (M,) aniso_g's radius, or null (plain kernel)
  float ox, oy, oz, cell;
  float off[kSub];
  float* out;          // (gx 4, gy 4, gz 4)
};

// d^2 of the pair of point p and staged candidate q: |r|^2, or |2 G r|^2
// (the old kernel's arithmetic, term for term).
template <bool kAniso>
__device__ __forceinline__ float field_d2(float px, float py, float pz,
                                          const float4& c, const float4& ga,
                                          const float4& gb, float g8) {
  const float rx = px - c.x;
  const float ry = py - c.y;
  const float rz = pz - c.z;
  if (!kAniso) return rx * rx + ry * ry + rz * rz;
  const float gx = 2.0f * (ga.x * rx + ga.y * ry + ga.z * rz);
  const float gy = 2.0f * (ga.w * rx + gb.x * ry + gb.y * rz);
  const float gz = 2.0f * (gb.z * rx + gb.w * ry + g8 * rz);
  return gx * gx + gy * gy + gz * gz;
}

template <bool kAniso>
__global__ void __launch_bounds__(kFieldThreads)
    mc_field_kernel(Geom g, FieldArgs a) {
  __shared__ float4 s_p[kFieldThreads];                // x, y, z, coeff
  __shared__ float4 s_ga[kAniso ? kFieldThreads : 1];  // G 0-3
  __shared__ float4 s_gb[kAniso ? kFieldThreads : 1];  // G 4-7
  __shared__ float2 s_gc[kAniso ? kFieldThreads : 1];  // G 8, reach^2
  __shared__ int s_z[kFieldThreads];                   // the row's z cell
  __shared__ int s_zs[9][kZSpan + 1];  // a column's first row of each z cell
  __shared__ int s_upto[9];            // running candidate counts
  __shared__ int s_kept[kFieldWarps];
  const int M = g.M;
  const int nzb = (g.gz + kFieldZ - 1) / kFieldZ;
  const int zb = blockIdx.x % nzb;
  const int cy = (blockIdx.x / nzb) % g.gy;
  const int cx = blockIdx.x / (nzb * g.gy);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int cz = zb * kFieldZ + t / kPoints;   // this thread's cell in z
  const bool mine = cz < g.gz;
  // the point: cell origin, then its offset (field.py: origin + pts)
  const int p = t % kPoints;
  const int pa = p / (kSub * kSub), pb = (p / kSub) % kSub, pc = p % kSub;
  const float bx = a.ox + (float)cx * a.cell;
  const float by = a.oy + (float)cy * a.cell;
  const float bz = a.oz + (float)cz * a.cell;
  const float px = bx + a.off[pa], py = by + a.off[pb], pz = bz + a.off[pc];
  // the warp's box: pa in {wa, wa + 1}, pb and pc in 0..3, its corners
  // computed as the points' own coordinates
  const int wa = (p / 32) * 2;
  const float x0 = bx + a.off[wa], x1 = bx + a.off[wa + 1];
  const float y0 = by + a.off[0], y1 = by + a.off[kSub - 1];
  const float z0 = bz + a.off[0], z1 = bz + a.off[kSub - 1];
  const float cut2 = g.h2 * (1.0f + kReachMargin);

  // the union window's 9 columns, (dx, dy) order: each column's rows from
  // z cell zlo through zhi, and where each z cell starts
  const int zlo = max(zb * kFieldZ - 1, 0);
  const int zhi = min(zb * kFieldZ + kFieldZ, g.gz - 1);
  if (t < 9 * (kZSpan + 1)) {
    const int col = t / (kZSpan + 1), k = t % (kZSpan + 1);
    const int nx = cx + col / 3 - 1, ny = cy + col % 3 - 1;
    int row = 0;
    if (nx >= 0 && nx < g.gx && ny >= 0 && ny < g.gy) {
      row = g.start[(nx * g.gy + ny) * g.gz + min(zlo + k, zhi + 1)];
    }
    s_zs[col][k] = row;
  }
  __syncthreads();
  if (t == 0) {
    int total = 0;
    for (int col = 0; col < 9; ++col) {
      total += s_zs[col][kZSpan] - s_zs[col][0];
      s_upto[col] = total;
    }
  }
  __syncthreads();
  const int total = s_upto[8];

  float acc = 0.0f;
  for (int k0 = 0; k0 < total; k0 += kFieldThreads) {
    // load candidate k0 + t, keep it where its coefficient is not 0
    const int k = k0 + t;
    int j = -1, col = 0;
    float cj = 0.0f;
    if (k < total) {
      while (s_upto[col] <= k) ++col;
      j = s_zs[col][0] + k - (col ? s_upto[col - 1] : 0);
      cj = __ldg(a.coeff + j);
    }
    const bool keep = cj != 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_kept[warp] = __popc(ballot);
    __syncthreads();
    int n = 0, slot = 0;
    for (int w = 0; w < kFieldWarps; ++w) {
      if (w < warp) slot += s_kept[w];
      n += s_kept[w];
    }
    if (keep) {
      slot += __popc(ballot & ((1u << lane) - 1u));
      s_p[slot] = make_float4(__ldg(a.x + j), __ldg(a.x + M + j),
                              __ldg(a.x + 2 * M + j), cj);
      if (kAniso) {
        const float* G = a.G + j;
        s_ga[slot] = make_float4(__ldg(G), __ldg(G + M), __ldg(G + 2 * M),
                                 __ldg(G + 3 * M));
        s_gb[slot] = make_float4(__ldg(G + 4 * M), __ldg(G + 5 * M),
                                 __ldg(G + 6 * M), __ldg(G + 7 * M));
        const float r = __ldg(a.reach + j) * (1.0f + kReachMargin);
        s_gc[slot] = make_float2(__ldg(G + 8 * M), r * r);
      }
      int zc = 0;
      while (zc + 1 < kZSpan && s_zs[col][zc + 1] <= j) ++zc;
      s_z[slot] = zlo + zc;
    }
    __syncthreads();
    if (mine) {
      for (int b0 = 0; b0 < n; b0 += 32) {
        // the warp keeps the staged candidates of its cell's window within
        // reach of its box
        const int q = b0 + lane;
        bool near = false;
        if (q < n) {
          const float4 c = s_p[q];
          const float dx = fmaxf(fmaxf(x0 - c.x, c.x - x1), 0.0f);
          const float dy = fmaxf(fmaxf(y0 - c.y, c.y - y1), 0.0f);
          const float dz = fmaxf(fmaxf(z0 - c.z, c.z - z1), 0.0f);
          const float reach2 = kAniso ? s_gc[q].y : cut2;
          near = dx * dx + dy * dy + dz * dz <= reach2
                 && abs(s_z[q] - cz) <= 1;
        }
        const unsigned kept = __ballot_sync(0xffffffffu, near);
        // each lane sums coeff W over them at its point, W only where d^2
        // is within h^2 (with the margin)
        for (unsigned m = kept; m != 0u; m &= m - 1u) {
          const int e = b0 + __ffs(m) - 1;
          const float4 c = s_p[e];
          const float d2 = field_d2<kAniso>(
              px, py, pz, c, kAniso ? s_ga[e] : float4{},
              kAniso ? s_gb[e] : float4{}, kAniso ? s_gc[e].x : 0.0f);
          if (d2 <= cut2) acc += c.w * kernel_w(g, d2);
        }
      }
    }
    __syncthreads();
  }
  if (mine) {
    const int sy = g.gy * kSub, sz = g.gz * kSub;
    a.out[((cx * kSub + pa) * sy + cy * kSub + pb) * sz + cz * kSub + pc] =
        acc;
  }
}

extern "C" int mc_field(const Geom* g, const float* x, const float* coeff,
                        const float* G, const float* reach, float ox,
                        float oy, float oz, float cell, float off1,
                        float off2, float off3, float* out, void* stream) {
  const FieldArgs a{x,  coeff, G,    reach, ox,
                    oy, oz,    cell, {0.0f, off1, off2, off3},
                    out};
  const int blocks = g->gx * g->gy * ((g->gz + kFieldZ - 1) / kFieldZ);
  if (blocks == 0) return 0;
  if (G != nullptr) {
    mc_field_kernel<true><<<blocks, kFieldThreads, 0, (cudaStream_t)stream>>>(
        *g, a);
  } else {
    mc_field_kernel<false>
        <<<blocks, kFieldThreads, 0, (cudaStream_t)stream>>>(*g, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The hits of row i (position xi, yi, zi) among candidates j0 .. j0 + n - 1
// (n <= 32): bit k where j0 + k is within h and not i (the cut of
// for_each_neighbor_masked, common.cuh).
__device__ __forceinline__ unsigned column_hits(const Geom& g, int i,
                                                float xi, float yi, float zi,
                                                int j0, int n) {
  const int M = g.M;
  unsigned hit = 0u;
  for (int k = 0; k < n; ++k) {
    const int j = j0 + k;
    const float rx = xi - g.pos[j];
    const float ry = yi - g.pos[M + j];
    const float rz = zi - g.pos[2 * M + j];
    if (j != i && rx * rx + ry * ry + rz * rz <= g.h2) hit |= 1u << k;
  }
  return hit;
}

// Calls f(j, d2) for every pair of row i within h, in the order of
// for_each_neighbor_masked, and keeps in kept[kBlock col] the hit mask of
// column col's first 32 candidates (kWalk 1), or takes those masks from
// kept and cuts only a column's later chunks again (kWalk 2).
template <int kWalk, class F>
__device__ __forceinline__ void moments_walk(const Geom& g, int i, float xi,
                                             float yi, float zi, int cx,
                                             int cy, int z0, int z1,
                                             unsigned* kept, F& f) {
  const int M = g.M;
  for (int col = 0; col < 9; ++col) {
    const int nx = cx + col / 3 - 1, ny = cy + col % 3 - 1;
    if (nx < 0 || nx >= g.gx || ny < 0 || ny >= g.gy) continue;
    const int base = (nx * g.gy + ny) * g.gz;
    const int jb = g.start[base + z0];
    const int je = g.start[base + z1 + 1];
    for (int j0 = jb; j0 < je; j0 += 32) {
      unsigned hit;
      if (kWalk == 2 && j0 == jb) {
        hit = kept[kBlock * col];
      } else {
        hit = column_hits(g, i, xi, yi, zi, j0, min(32, je - j0));
        if (kWalk == 1 && j0 == jb) kept[kBlock * col] = hit;
      }
      while (hit != 0u) {
        const int j = j0 + __ffs(hit) - 1;
        hit &= hit - 1u;
        const float rx = xi - g.pos[j];
        const float ry = yi - g.pos[M + j];
        const float rz = zi - g.pos[2 * M + j];
        f(j, rx * rx + ry * ry + rz * rz);
      }
    }
  }
}

// mom: (11, M) rows [sum w, sum w x_j (3), sum w d_a d_b (xx, xy, xz, yy,
// yz, zz), count] (dense_ops.aniso_moments).  kMomentBlocks resident blocks
// an SM hold the kernel to 48 registers: left alone it takes 52, for 4.
constexpr int kMomentBlocks = 5;
__global__ void __launch_bounds__(kBlock, kMomentBlocks)
    aniso_moments_kernel(Geom g, float* __restrict__ mom) {
  // each thread's kept masks, column-major: a warp's 32 in 32 banks
  __shared__ unsigned s_kept[9 * kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int M = g.M;
  if (i >= M) return;
  const float wr = 2.0f * g.h;    // the weight's radius, 2h
  float sw = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
  float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float count = 0.0f;
  if (g.liq[i] != 0.0f) {
    const float xi = g.pos[i], yi = g.pos[M + i], zi = g.pos[2 * M + i];
    const int cell = g.cell[i];
    const int cz = cell % g.gz;
    const int cy = (cell / g.gz) % g.gy;
    const int cx = cell / (g.gz * g.gy);
    const int z0 = max(cz - 1, 0);
    const int z1 = min(cz + 1, g.gz - 1);
    unsigned* kept = s_kept + threadIdx.x;
    auto first = [&](int j, float d2) {
      if (g.liq[j] == 0.0f) return;
      const float q = sqrtf(fmaxf(d2, 0.0f)) / wr;
      const float w = 1.0f - q * q * q;
      sw += w;
      sx += w * g.pos[j];
      sy += w * g.pos[M + j];
      sz += w * g.pos[2 * M + j];
    };
    moments_walk<1>(g, i, xi, yi, zi, cx, cy, z0, z1, kept, first);
    const float den = fmaxf(sw, 1e-12f);
    const float mx = sw > 0.0f ? sx / den : xi;
    const float my = sw > 0.0f ? sy / den : yi;
    const float mz = sw > 0.0f ? sz / den : zi;
    auto second = [&](int j, float d2) {
      count += 1.0f;
      if (g.liq[j] == 0.0f) return;
      const float q = sqrtf(fmaxf(d2, 0.0f)) / wr;
      const float w = 1.0f - q * q * q;
      const float d[3] = {g.pos[j] - mx, g.pos[M + j] - my,
                          g.pos[2 * M + j] - mz};
      c[0] += w * d[0] * d[0];
      c[1] += w * d[0] * d[1];
      c[2] += w * d[0] * d[2];
      c[3] += w * d[1] * d[1];
      c[4] += w * d[1] * d[2];
      c[5] += w * d[2] * d[2];
    };
    moments_walk<2>(g, i, xi, yi, zi, cx, cy, z0, z1, kept, second);
  }
  mom[i] = sw;
  mom[M + i] = sx;
  mom[2 * M + i] = sy;
  mom[3 * M + i] = sz;
#pragma unroll
  for (int k = 0; k < 6; ++k) mom[(4 + k) * M + i] = c[k];
  mom[10 * M + i] = count;
}

extern "C" int aniso_moments(const Geom* g, float* mom, void* stream) {
  aniso_moments_kernel<<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
      *g, mom);
  return static_cast<int>(cudaGetLastError());
}

// G from the moments (aniso.compute's spectral clamp, ParticleData.py:
// 246-278), one thread per row: the covariance c = sums / max(sum w,
// 1e-12), its eigendecomposition by cyclic Jacobi rotations (at most
// kSweeps sweeps of the three off-diagonal pairs; a 3x3 symmetric matrix
// converges in a few), eigenvalues ascending, s0 the largest, the two
// others clamped from below to s0 / kr, and G = R diag(1 / (ks s~)) R^T,
// written row-major into 9 rows; kn I where the row is not liquid, has
// at most min_neighbors neighbours, or s0 <= 0.  Beside G, the row's reach
// for mc_field: G's least eigenvalue is 1 / (ks s0) (kn for kn I), so
// |2 G r| <= h needs |r| <= h ks s0 / 2 (h / (2 kn)), capped at kReachCap
// h.  The JAX package runs jnp.linalg.eigh here; the port's plain twin
// runs torch.linalg.eigh, which on the card refuses a batch of the
// flagship's size.
// Bound: the 19 words a row it reads and writes.
struct AnisoConsts {
  float kr, ks, kn;
  int min_neighbors;
  float h;
};

constexpr int kSweeps = 8;

__device__ __forceinline__ void jacobi_rotate(float a[3][3], float v[3][3],
                                              int p, int q) {
  const float apq = a[p][q];
  if (apq == 0.0f) return;
  const float theta = (a[q][q] - a[p][p]) / (2.0f * apq);
  const float t = copysignf(1.0f, theta)
                  / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
  const float c = 1.0f / sqrtf(t * t + 1.0f);
  const float s = t * c;
  a[p][p] -= t * apq;
  a[q][q] += t * apq;
  a[p][q] = a[q][p] = 0.0f;
  const int r = 3 - p - q;
  const float arp = a[r][p], arq = a[r][q];
  a[r][p] = a[p][r] = c * arp - s * arq;
  a[r][q] = a[q][r] = s * arp + c * arq;
  for (int k = 0; k < 3; ++k) {
    const float vkp = v[k][p], vkq = v[k][q];
    v[k][p] = c * vkp - s * vkq;
    v[k][q] = s * vkp + c * vkq;
  }
}

__global__ void aniso_g_kernel(int M, const float* __restrict__ mom,
                               const float* __restrict__ liq,
                               AnisoConsts k, float* __restrict__ G,
                               float* __restrict__ reach) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= M) return;
  const float den = fmaxf(mom[i], 1e-12f);
  const float xx = mom[4 * M + i] / den, xy = mom[5 * M + i] / den;
  const float xz = mom[6 * M + i] / den, yy = mom[7 * M + i] / den;
  const float yz = mom[8 * M + i] / den, zz = mom[9 * M + i] / den;
  float a[3][3] = {{xx, xy, xz}, {xy, yy, yz}, {xz, yz, zz}};
  float v[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f},
                   {0.0f, 0.0f, 1.0f}};
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    if (a[0][1] == 0.0f && a[0][2] == 0.0f && a[1][2] == 0.0f) break;
    jacobi_rotate(a, v, 0, 1);
    jacobi_rotate(a, v, 0, 2);
    jacobi_rotate(a, v, 1, 2);
  }
  // eigenvalues ascending, with their columns of v
  int o[3] = {0, 1, 2};
  auto order = [&](int x, int y) {
    if (a[o[x]][o[x]] > a[o[y]][o[y]]) {
      const int t = o[x];
      o[x] = o[y];
      o[y] = t;
    }
  };
  order(0, 1);
  order(1, 2);
  order(0, 1);
  const float s0 = a[o[2]][o[2]];
  const float s1 = fmaxf(a[o[1]][o[1]], s0 / k.kr);
  const float s2 = fmaxf(a[o[0]][o[0]], s0 / k.kr);
  const float inv[3] = {1.0f / (k.ks * fmaxf(s2, 1e-20f)),
                        1.0f / (k.ks * fmaxf(s1, 1e-20f)),
                        1.0f / (k.ks * fmaxf(s0, 1e-20f))};
  const bool ok = liq[i] != 0.0f && mom[10 * M + i] > (float)k.min_neighbors
                  && s0 > 0.0f;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      float gij = 0.0f;
      for (int e = 0; e < 3; ++e) gij += v[r][o[e]] * inv[e] * v[c][o[e]];
      G[(3 * r + c) * M + i] = ok ? gij : (r == c ? k.kn : 0.0f);
    }
  }
  const float to = ok ? 0.5f * k.h * k.ks * fmaxf(s0, 1e-20f)
                      : 0.5f * k.h / k.kn;
  reach[i] = fminf(to, kReachCap * k.h);
}

extern "C" int aniso_g(int m, const float* mom, const float* liq, float kr,
                       float ks, float kn, int min_neighbors, float h,
                       float* G, float* reach, void* stream) {
  aniso_g_kernel<<<blocks_of(m), kBlock, 0, (cudaStream_t)stream>>>(
      m, mom, liq, AnisoConsts{kr, ks, kn, min_neighbors, h}, G, reach);
  return static_cast<int>(cudaGetLastError());
}
