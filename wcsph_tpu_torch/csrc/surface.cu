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
//   * mc_field: one block per grid cell, one thread per reconstruction
//     point (MC_SUB^3 = 64 points a cell: 4 per axis, h / 4 apart).  All
//     64 points of a cell share the cell's 27-cell window (binned at the
//     particles' own positions; 9 row ranges), so the block walks that
//     window once, 64 candidates at a time: each thread loads one, the
//     candidates whose coefficient is not 0 (liquid, above the density
//     gate: the wrapper's coeff) are compacted in window order into
//     shared memory (position, coefficient and, anisotropic, the 9 entries
//     of G), and every thread then sums coeff W over them at its point.
//     A window with no such candidate loads no pair (the ~60% of the
//     flagship's cells away from the liquid): the block writes zeros.  Each
//     thread writes its own element of the dense field (gx 4, gy 4, gz 4).
//     Bound: the pair evaluations, ~216 candidates for each of 64 points
//     where the data's ~34 terms a point lie within the support; the
//     shared window keeps the candidates' loads off device memory.
//   * aniso_moments: one thread per liquid receiver, over its pairs within
//     h in the order of for_each_neighbor_masked (the register-mask cut of
//     common.cuh, fastest for list-less sweeps: reconstruction builds its
//     own grid and no neighbour list), in two launches: pass 1 sums w and
//     w x_j over liquid neighbours, w = 1 - (d / 2h)^3; pass 2 forms the
//     receiver's weighted mean from pass 1's sums and sums the six
//     products w d_a d_b of d = x_j - mean, and the count of all pairs.
//     Bound: the candidate scan, as K5's list-less sweeps.
//   * aniso_g: one thread per row, a 3x3 Jacobi eigendecomposition of the
//     covariance in registers, the spectral clamp and G.  Bound: bytes.
//
// A launch returns cudaGetLastError().

#include "common.cuh"

constexpr int kSub = 4;                        // dense_ops.MC_SUB
constexpr int kPoints = kSub * kSub * kSub;    // threads of a field block

// The reconstruction points of a cell: the grid's origin, its cell size and
// the offsets k h / 4 along an axis (dense_ops.field_offsets), and the
// dense field written.
struct FieldArgs {
  const float* x;      // (3, M) positions the field is evaluated at
  const float* coeff;  // (M,) m / max(rho, 1) where gated in, else 0
  const float* G;      // (9, M) row-major G, or null (plain kernel)
  float ox, oy, oz, cell;
  float off[kSub];
  float* out;          // (gx 4, gy 4, gz 4)
};

template <bool kAniso>
__global__ void __launch_bounds__(kPoints)
    mc_field_kernel(Geom g, FieldArgs a) {
  __shared__ float s_x[3][kPoints];
  __shared__ float s_c[kPoints];
  __shared__ float s_g[kAniso ? 9 : 1][kPoints];
  __shared__ int s_kept[kPoints / 32];
  const int M = g.M;
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int cz = c % g.gz;
  const int cy = (c / g.gz) % g.gy;
  const int cx = c / (g.gz * g.gy);
  // the point: cell origin, then its offset (field.py: origin + pts)
  const int pa = t / (kSub * kSub), pb = (t / kSub) % kSub, pc = t % kSub;
  const float px = (a.ox + (float)cx * a.cell) + a.off[pa];
  const float py = (a.oy + (float)cy * a.cell) + a.off[pb];
  const float pz = (a.oz + (float)cz * a.cell) + a.off[pc];

  // the window's 9 row ranges, (dx, dy) order, and their running lengths
  const int z0 = max(cz - 1, 0);
  const int z1 = min(cz + 1, g.gz - 1);
  int first[9], upto[9];
  int total = 0;
  for (int k = 0; k < 9; ++k) {
    const int nx = cx + k / 3 - 1, ny = cy + k % 3 - 1;
    int jb = 0, je = 0;
    if (nx >= 0 && nx < g.gx && ny >= 0 && ny < g.gy) {
      const int base = (nx * g.gy + ny) * g.gz;
      jb = g.start[base + z0];
      je = g.start[base + z1 + 1];
    }
    total += je - jb;
    first[k] = jb;
    upto[k] = total;
  }

  const int lane = t & 31, warp = t >> 5;
  float acc = 0.0f;
  for (int k0 = 0; k0 < total; k0 += kPoints) {
    // load candidate k0 + t, keep it where its coefficient is not 0
    const int k = k0 + t;
    int j = -1;
    float cj = 0.0f;
    if (k < total) {
      int col = 0;
      while (upto[col] <= k) ++col;
      j = first[col] + k - (col ? upto[col - 1] : 0);
      cj = __ldg(a.coeff + j);
    }
    const bool keep = cj != 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_kept[warp] = __popc(ballot);
    __syncthreads();
    int n = 0, slot = 0;
    for (int w = 0; w < kPoints / 32; ++w) {
      if (w < warp) slot += s_kept[w];
      n += s_kept[w];
    }
    if (keep) {
      slot += __popc(ballot & ((1u << lane) - 1u));
      s_x[0][slot] = __ldg(a.x + j);
      s_x[1][slot] = __ldg(a.x + M + j);
      s_x[2][slot] = __ldg(a.x + 2 * M + j);
      s_c[slot] = cj;
      if (kAniso) {
#pragma unroll
        for (int e = 0; e < 9; ++e) s_g[e][slot] = __ldg(a.G + e * M + j);
      }
    }
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      const float rx = px - s_x[0][q];
      const float ry = py - s_x[1][q];
      const float rz = pz - s_x[2][q];
      float d2;
      if (kAniso) {
        const float gx = 2.0f * (s_g[0][q] * rx + s_g[1][q] * ry
                                 + s_g[2][q] * rz);
        const float gy = 2.0f * (s_g[3][q] * rx + s_g[4][q] * ry
                                 + s_g[5][q] * rz);
        const float gz = 2.0f * (s_g[6][q] * rx + s_g[7][q] * ry
                                 + s_g[8][q] * rz);
        d2 = gx * gx + gy * gy + gz * gz;
      } else {
        d2 = rx * rx + ry * ry + rz * rz;
      }
      acc += s_c[q] * kernel_w(g, d2);
    }
    __syncthreads();
  }
  const int sy = g.gy * kSub, sz = g.gz * kSub;
  a.out[((cx * kSub + pa) * sy + cy * kSub + pb) * sz + cz * kSub + pc] = acc;
}

extern "C" int mc_field(const Geom* g, const float* x, const float* coeff,
                        const float* G, float ox, float oy, float oz,
                        float cell, float off1, float off2, float off3,
                        float* out, void* stream) {
  const FieldArgs a{x, coeff, G, ox, oy, oz, cell, {0.0f, off1, off2, off3},
                    out};
  const int cells = g->gx * g->gy * g->gz;
  if (cells == 0) return 0;
  if (G != nullptr) {
    mc_field_kernel<true><<<cells, kPoints, 0, (cudaStream_t)stream>>>(*g,
                                                                       a);
  } else {
    mc_field_kernel<false><<<cells, kPoints, 0, (cudaStream_t)stream>>>(*g,
                                                                        a);
  }
  return static_cast<int>(cudaGetLastError());
}

// mom: (11, M) rows [sum w, sum w x_j (3), sum w d_a d_b (xx, xy, xz, yy,
// yz, zz), count]; pass 1 writes rows 0-3, pass 2 reads them and writes
// rows 4-10 (dense_ops.aniso_moments).
template <int kPass>
__global__ void aniso_moments_kernel(Geom g, float* __restrict__ mom) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int M = g.M;
  if (i >= M) return;
  const float wr = 2.0f * g.h;    // the weight's radius, 2h
  const bool liquid = g.liq[i] != 0.0f;
  if (kPass == 1) {
    float sw = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
    auto f = [&](int j, float, float, float, float d2) {
      if (g.liq[j] == 0.0f) return;
      const float q = sqrtf(fmaxf(d2, 0.0f)) / wr;
      const float w = 1.0f - q * q * q;
      sw += w;
      sx += w * g.pos[j];
      sy += w * g.pos[M + j];
      sz += w * g.pos[2 * M + j];
    };
    if (liquid) for_each_neighbor_masked(g, i, f);
    mom[i] = sw;
    mom[M + i] = sx;
    mom[2 * M + i] = sy;
    mom[3 * M + i] = sz;
  } else {
    float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float count = 0.0f;
    if (liquid) {
      const float sw = mom[i];
      const float den = fmaxf(sw, 1e-12f);
      const float mx = sw > 0.0f ? mom[M + i] / den : g.pos[i];
      const float my = sw > 0.0f ? mom[2 * M + i] / den : g.pos[M + i];
      const float mz = sw > 0.0f ? mom[3 * M + i] / den : g.pos[2 * M + i];
      auto f = [&](int j, float, float, float, float d2) {
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
      for_each_neighbor_masked(g, i, f);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) mom[(4 + k) * M + i] = c[k];
    mom[10 * M + i] = count;
  }
}

extern "C" int aniso_moments(const Geom* g, float* mom, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  aniso_moments_kernel<1><<<blocks_of(g->M), kBlock, 0, s>>>(*g, mom);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aniso_moments_kernel<2><<<blocks_of(g->M), kBlock, 0, s>>>(*g, mom);
  return static_cast<int>(cudaGetLastError());
}

// G from the moments (aniso.compute's spectral clamp, ParticleData.py:
// 246-278), one thread per row: the covariance c = sums / max(sum w,
// 1e-12), its eigendecomposition by cyclic Jacobi rotations (at most
// kSweeps sweeps of the three off-diagonal pairs; a 3x3 symmetric matrix
// converges in a few), eigenvalues ascending, s0 the largest, the two
// others clamped from below to s0 / kr, and G = R diag(1 / (ks s~)) R^T,
// written row-major into 9 rows; kn I where the row is not liquid, has
// at most min_neighbors neighbours, or s0 <= 0.  The JAX package runs
// jnp.linalg.eigh here; the port's plain twin runs torch.linalg.eigh,
// which on the card refuses a batch of the flagship's size.
// Bound: the 18 words a row it reads and writes.
struct AnisoConsts {
  float kr, ks, kn;
  int min_neighbors;
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
                               AnisoConsts k, float* __restrict__ G) {
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
}

extern "C" int aniso_g(int m, const float* mom, const float* liq, float kr,
                       float ks, float kn, int min_neighbors, float* G,
                       void* stream) {
  aniso_g_kernel<<<blocks_of(m), kBlock, 0, (cudaStream_t)stream>>>(
      m, mom, liq, AnisoConsts{kr, ks, kn, min_neighbors}, G);
  return static_cast<int>(cudaGetLastError());
}
