// Hand-written Hopper (sm_90a) kernels of the SESPH, PCISPH and IISPH steps
// and of the surface tension of the DFSPH step (K5-K8 below).
//
// They replace the remaining four Pallas kernels of
// wcsph_tpu/pallas/engine.py: the one-sided sweep _build_sweep (279)
// and the fused programs _build_fused_tension (904),
// _build_fused_iisph_iter (1238) and _build_fused_pcisph_iter (1466).  As
// in sweeps.cu they compute what those kernels compute, not their TPU
// layout: one thread per receiving particle gathers its own sum over the
// cell-sorted rows (common.cuh), so there is no capacity, no plane, no
// occupancy mask, no overlap-add fold and no zero phase, and where a TPU
// program relies on its grid running in order (a phase reads what all
// programs of the phase before wrote), each phase is its own launch on one
// stream.
//
// What bounds them on the H100 is what bounds the sweeps of sweeps.cu: the
// candidate loop (~200 candidates per receiver, ~15% within h) with the
// neighbour rows coming from L1/L2, not the tens of MB of operands in
// device memory.  Neighbouring threads hold neighbouring rows of one cell
// and walk nearly the same candidate ranges.  Nothing here is tuned beyond
// that.
//
// A launch returns cudaGetLastError().

#include "common.cuh"

// ---------------------------------------------------------------------------
// K5: the one-sided sweep.  Replaces _build_sweep (engine.py:279), the
// function that runs an emit's one-sided __call__ over the full 27-cell
// window: each receiver sums the emit over its own neighbours and nothing is
// written to the other end of a pair.  One generic kernel, templated on an
// emit functor:
//   E::kOut      number of accumulated channels
//   E::kAllRows  true: every row receives; false: liquid rows (0 elsewhere)
//   E::Row       what the receiver holds in registers; e.row(g, i) loads it
//   e.pair(g, row, j, rx, ry, rz, d2, acc)   the per-pair body
//   e.finish(g, i, acc)                      the per-row epilogue
// ---------------------------------------------------------------------------

template <class E>
__global__ void k5_sweep_kernel(Geom g, E e) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  float acc[E::kOut];
#pragma unroll
  for (int k = 0; k < E::kOut; ++k) acc[k] = 0.0f;
  if (E::kAllRows || g.liq[i] != 0.0f) {
    const typename E::Row row = e.row(g, i);
    auto f = [&](int j, float rx, float ry, float rz, float d2) {
      e.pair(g, row, j, rx, ry, rz, d2, acc);
    };
    for_each_neighbor(g, i, f);
  }
  e.finish(g, i, acc);
}

template <class E>
static int launch_sweep(const Geom* g, const E& e, void* stream) {
  k5_sweep_kernel<E><<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
      *g, e);
  return static_cast<int>(cudaGetLastError());
}

// The usual epilogue: channel k of row i goes to out[k * M + i].
template <int K>
__device__ __forceinline__ void store_channels(float* __restrict__ out, int M,
                                               int i, const float* acc) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k * M + i] = acc[k];
}

struct NoRow {};

// _DensityAlpha (1920) without the alpha sums: [sum V_j W, count].
struct DensityAlpha {
  static constexpr int kOut = 2;
  static constexpr bool kAllRows = true;
  using Row = NoRow;
  float* out;
  __device__ Row row(const Geom&, int) const { return Row{}; }
  __device__ void pair(const Geom& g, const Row&, int j, float, float, float,
                       float d2, float* acc) const {
    acc[0] += volume(g, j) * kernel_w(g, d2);
    acc[1] += 1.0f;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

// _SesphForce (2214): explicit viscosity + symmetric Tait-pressure
// acceleration.  rinv = 1 / max(rho, 1), rr = rho / rho0, pi = p rinv^2 are
// prepared by the caller; d0 = 0.01 h^2.
struct SesphForce {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  struct Row {
    float vx, vy, vz, rr, pi, p;
  };
  const float* vel;
  const float* rinv;
  const float* rr;
  const float* pi;
  const float* p;
  float a_liq, b_sol, d0, rho0;
  float* out;
  __device__ Row row(const Geom& g, int i) const {
    return Row{vel[i], vel[g.M + i], vel[2 * g.M + i], rr[i], pi[i], p[i]};
  }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, float* acc) const {
    const int M = g.M;
    const float lj = g.liq[j];
    const float sj = 1.0f - lj;
    const float rd = 1.0f / (d2 + d0);
    const float dv_dot = (r.vx - vel[j]) * rx + (r.vy - vel[M + j]) * ry +
                         (r.vz - vel[2 * M + j]) * rz;
    const float vh_dot = r.vx * rx + r.vy * ry + r.vz * rz;
    const float rj = rinv[j];
    const float visc =
        (lj * a_liq * rj * dv_dot + sj * b_sol * r.rr * vh_dot) * rd;
    const float pres = -rho0 * (g.vl * lj * (r.pi + p[j] * rj * rj) +
                                g.vs * sj * (r.pi + r.p / (rho0 * rho0)));
    const float c = (visc + pres) * kernel_gs(g, d2);
    acc[0] += c * rx;
    acc[1] += c * ry;
    acc[2] += c * rz;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

// _IisphAdv (2337): [-sum V_j gs r (3), sum V_j gs (v_i - v_j).r,
// sum V_j gs^2 d2].
struct IisphAdv {
  static constexpr int kOut = 5;
  static constexpr bool kAllRows = false;
  struct Row {
    float vx, vy, vz;
  };
  const float* vel;
  float* out;
  __device__ Row row(const Geom& g, int i) const {
    return Row{vel[i], vel[g.M + i], vel[2 * g.M + i]};
  }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, float* acc) const {
    const int M = g.M;
    const float gs = kernel_gs(g, d2);
    const float vgs = volume(g, j) * gs;
    acc[0] -= vgs * rx;
    acc[1] -= vgs * ry;
    acc[2] -= vgs * rz;
    const float dv_dot = (r.vx - vel[j]) * rx + (r.vy - vel[M + j]) * ry +
                         (r.vz - vel[2 * M + j]) * rz;
    acc[3] += vgs * dv_dot;
    acc[4] += vgs * gs * d2;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

// _IisphAii (2374): sum V_j gs (d_ii_i . r), the receiver's own d_ii.
struct IisphAii {
  static constexpr int kOut = 1;
  static constexpr bool kAllRows = false;
  struct Row {
    float dx, dy, dz;
  };
  const float* dii;
  float* out;
  __device__ Row row(const Geom& g, int i) const {
    return Row{dii[i], dii[g.M + i], dii[2 * g.M + i]};
  }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, float* acc) const {
    const float f = kernel_gs(g, d2) * (r.dx * rx + r.dy * ry + r.dz * rz);
    acc[0] += volume(g, j) * f;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

// _IisphForce (2466): -sum c gs r with c = V0 (dpi_i + dpi_j) for a liquid
// neighbour and Vs dpi_i for a boundary one; dpi = p / den^2.
struct IisphForce {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  struct Row {
    float dpi;
  };
  const float* dpi;
  float* out;
  __device__ Row row(const Geom&, int i) const { return Row{dpi[i]}; }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, float* acc) const {
    const float lj = g.liq[j];
    const float c =
        lj * (g.vl * (r.dpi + dpi[j])) + (1.0f - lj) * g.vs * r.dpi;
    const float fg = c * kernel_gs(g, d2);
    acc[0] -= fg * rx;
    acc[1] -= fg * ry;
    acc[2] -= fg * rz;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

// ---------------------------------------------------------------------------
// K6: surface normals + tension.  Replaces _build_fused_tension
// (engine.py:904), whose phase 1 reads the finished normals of phase 0 from
// neighbouring rows: two launches.
//   1. _SurfaceNormals (2498): n_i = h sum_j m ril_j gs r, with
//      ril = liq / max(rho, 1); the h scale of the finished sum is the
//      sweep's epilogue;
//   2. _TensionAccel (2519) on those normals: Akinci cohesion, curvature and
//      boundary adhesion.
// ---------------------------------------------------------------------------

struct SurfaceNormals {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  using Row = NoRow;
  const float* ril;
  float mass;
  float* out;
  __device__ Row row(const Geom&, int) const { return Row{}; }
  __device__ void pair(const Geom& g, const Row&, int j, float rx, float ry,
                       float rz, float d2, float* acc) const {
    const float c = mass * ril[j] * kernel_gs(g, d2);
    acc[0] += c * rx;
    acc[1] += c * ry;
    acc[2] += c * rz;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    out[i] = g.h * acc[0];
    out[g.M + i] = g.h * acc[1];
    out[2 * g.M + i] = g.h * acc[2];
  }
};

// Mirror: engine._TensionParams (same field order).
struct TensionParams {
  float coh;     // -tension_coff m
  float adh;     // -tension_coff_b rho0 V_b
  float curv;    // -tension_coff
  float rho0x2;  // 2 rho0
  float eps;
  float coh_k;   // 32 / (pi h^9)
  float coh_c;   // h^6 / 64: the inner branch's offset, outside the k factor
  float adh_k;   // 0.007 / h^3.25
  float cx, cy, cz, radius2;  // adhesion region around the SOURCE particle
};

struct TensionAccel {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  struct Row {
    float rho, nx, ny, nz;
  };
  const float* rho;
  const float* n;
  TensionParams t;
  float* out;
  __device__ Row row(const Geom& g, int i) const {
    return Row{rho[i], n[i], n[g.M + i], n[2 * g.M + i]};
  }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, float* acc) const {
    const int M = g.M;
    const float h = g.h;
    const float dist = sqrtf(fmaxf(d2, 1.0e-12f));
    const float inv_dist = 1.0f / fmaxf(dist, t.eps);
    const bool pair_ok = d2 > t.eps;
    const float lj = g.liq[j];
    const float k_ij = t.rho0x2 / fmaxf(r.rho + rho[j], 1.0f);
    const float gate = pair_ok ? lj * k_ij : 0.0f;
    // kernels.cohesion_w_scalar
    const float hd = h - dist;
    const float base = hd * hd * hd * (dist * dist * dist);
    const float w_coh = dist > 0.5f * h ? t.coh_k * base
                                        : 2.0f * t.coh_k * base - t.coh_c;
    // kernels.adhesion_w_scalar
    const float arg =
        fmaxf(-4.0f * dist * dist / h + 6.0f * dist - 2.0f * h, 0.0f);
    const float w_adh = dist > 0.5f * h ? t.adh_k * sqrtf(sqrtf(arg)) : 0.0f;
    const float ex = g.pos[j] - t.cx;
    const float ey = g.pos[M + j] - t.cy;
    const float ez = g.pos[2 * M + j] - t.cz;
    const bool in_region = ex * ex + ey * ey + ez * ez < t.radius2;
    const float adh_gate = (pair_ok && in_region) ? 1.0f - lj : 0.0f;
    const float c_rad = t.coh * w_coh * inv_dist * gate +
                        t.adh * w_adh * inv_dist * adh_gate;
    const float cg = gate * t.curv;
    acc[0] += c_rad * rx + cg * (r.nx - n[j]);
    acc[1] += c_rad * ry + cg * (r.ny - n[M + j]);
    acc[2] += c_rad * rz + cg * (r.nz - n[2 * M + j]);
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

// ---------------------------------------------------------------------------
// K7: a whole relaxed-Jacobi iteration of IISPH.  Replaces
// _build_fused_iisph_iter (engine.py:1238): its zero phase is not needed
// (every sweep writes its own rows), and its three in-order phases and SMEM
// residual become three launches plus the fixed-order sum:
//   1. dij_i = sum_j fac_j gs r with fac = -liq deninv p formed on the fly
//      (_IisphDij 2397);
//   2. s_i (_IisphS 2417) reading the finished dij of neighbours, with
//      p_liq = liq p and g = deninv p formed on the fly;
//   3. p' = ok ? max((1 - w) p + w / (a_ii dt^2) (b - dt^2 s), 0) : 0 with
//      ok = |a_ii dt^2| > eps, in place (launch 2 was the last reader of p),
//      and a block partial of liq ((a_ii p' + s) dt^2 - b) gated on p' != 0;
//   4. one block sums the partials in a fixed order.
// ---------------------------------------------------------------------------

struct IisphDij {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  using Row = NoRow;
  const float* deninv;
  const float* p;
  float* out;
  __device__ Row row(const Geom&, int) const { return Row{}; }
  __device__ void pair(const Geom& g, const Row&, int j, float rx, float ry,
                       float rz, float d2, float* acc) const {
    const float fac = -g.liq[j] * deninv[j] * p[j];
    const float fg = fac * kernel_gs(g, d2);
    acc[0] += fg * rx;
    acc[1] += fg * ry;
    acc[2] += fg * rz;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

struct IisphS {
  static constexpr int kOut = 1;
  static constexpr bool kAllRows = false;
  struct Row {
    float dx, dy, dz, g;  // the receiver's dij and g = deninv p
  };
  const float* dii;
  const float* dij;
  const float* deninv;
  const float* p;
  float* out;
  __device__ Row row(const Geom& g, int i) const {
    return Row{dij[i], dij[g.M + i], dij[2 * g.M + i], deninv[i] * p[i]};
  }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, float* acc) const {
    const int M = g.M;
    const float gs = kernel_gs(g, d2);
    const float lj = g.liq[j];
    const float dij_dot_i = gs * (r.dx * rx + r.dy * ry + r.dz * rz);
    const float dii_j_dot =
        gs * (lj * p[j]) *
        (dii[j] * rx + dii[M + j] * ry + dii[2 * M + j] * rz);
    const float dij_j_dot =
        gs * (dij[j] * rx + dij[M + j] * ry + dij[2 * M + j] * rz);
    const float dji_pi_dot = r.g * gs * gs * d2;
    const float term_liq =
        g.vl * (dij_dot_i - dii_j_dot - dij_j_dot + dji_pi_dot);
    const float term_sol = g.vs * dij_dot_i;
    acc[0] += lj * term_liq + (1.0f - lj) * term_sol;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

__global__ void k7_update_kernel(int M, const float* __restrict__ liq,
                                 const float* __restrict__ aii,
                                 const float* __restrict__ b,
                                 const float* __restrict__ s,
                                 float* __restrict__ p, float dt, float omega,
                                 float eps, float* __restrict__ partials) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float part = 0.0f;
  if (i < M) {
    const float h2 = dt * dt;
    const float a = aii[i], bi = b[i], si = s[i];
    const float denom = a * h2;
    const bool ok = fabsf(denom) > eps;
    float pn = fmaxf(
        (1.0f - omega) * p[i] + omega / (ok ? denom : 1.0f) * (bi - h2 * si),
        0.0f);
    pn = ok ? pn : 0.0f;
    p[i] = pn;
    const float resid = pn != 0.0f ? (a * pn + si) * h2 - bi : 0.0f;
    part = liq[i] * resid;
  }
  block_partial(part, partials);
}

// ---------------------------------------------------------------------------
// K8: a whole PCISPH prediction iteration.  Replaces
// _build_fused_pcisph_iter (engine.py:1466); three launches plus the sum:
//   1. predicted density adv_i = sum_j V_j W(|x*_i - x*_j|)
//      (_PcisphAdvPart 2310) at x* = x + liq v* dt, formed on the fly: no x*
//      array in device memory.  The candidates are those of the ORIGINAL
//      cells (Geom.pos, Geom.start); a pair is cut by its distance at x*;
//   2. p' = p + factor (max(w0 + adv, 1) - 1) in place, and a block partial
//      of liq (max(w0 + adv, 1) - 1); then the fixed-order sum;
//   3. pressure acceleration -sum c gs r at x* with p' at both ends
//      (_PcisphAccPart 2323): c = V0 (p'_i + p'_j) for a liquid neighbour,
//      Vs p'_i for a boundary one.
// ---------------------------------------------------------------------------

struct Starred {
  const float* pos;
  const float* liq;
  const float* vel_star;
  int M;
  float dt;
  __device__ void operator()(int j, float* x) const {
    const bool l = liq[j] != 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x0 = pos[c * M + j];
      x[c] = l ? x0 + vel_star[c * M + j] * dt : x0;
    }
  }
};

__global__ void k8_adv_kernel(Geom g, Starred xs, float* __restrict__ adv) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  float acc = 0.0f;
  if (g.liq[i] != 0.0f) {
    auto f = [&](int j, float, float, float, float d2) {
      acc += volume(g, j) * kernel_w(g, d2);
    };
    for_each_neighbor_at(g, i, xs, f);
  }
  adv[i] = acc;
}

__global__ void k8_pressure_kernel(int M, const float* __restrict__ liq,
                                   const float* __restrict__ adv,
                                   float* __restrict__ p, float factor,
                                   float w0, float* __restrict__ partials) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float part = 0.0f;
  if (i < M) {
    const float over = fmaxf(w0 + adv[i], 1.0f) - 1.0f;
    p[i] += factor * over;
    part = liq[i] * over;
  }
  block_partial(part, partials);
}

__global__ void k8_acc_kernel(Geom g, Starred xs, const float* __restrict__ p,
                              float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (g.liq[i] != 0.0f) {
    const float pi = p[i];
    auto f = [&](int j, float rx, float ry, float rz, float d2) {
      const float lj = g.liq[j];
      const float c = lj * g.vl * (pi + p[j]) + (1.0f - lj) * g.vs * pi;
      const float fg = c * kernel_gs(g, d2);
      ax -= fg * rx;
      ay -= fg * ry;
      az -= fg * rz;
    };
    for_each_neighbor_at(g, i, xs, f);
  }
  const int M = g.M;
  out[i] = ax;
  out[M + i] = ay;
  out[2 * M + i] = az;
}

// ---------------------------------------------------------------------------
// Plain C entry points (bound with ctypes by engine.py).  Each returns the
// first cudaError_t of its launches (0 = all launched).
// ---------------------------------------------------------------------------

extern "C" int k5_density_alpha(const Geom* g, float* out, void* stream) {
  return launch_sweep(g, DensityAlpha{out}, stream);
}

extern "C" int k5_sesph_force(const Geom* g, const float* vel,
                              const float* rinv, const float* rr,
                              const float* pi, const float* p, float a_liq,
                              float b_sol, float d0, float rho0, float* out,
                              void* stream) {
  return launch_sweep(
      g, SesphForce{vel, rinv, rr, pi, p, a_liq, b_sol, d0, rho0, out},
      stream);
}

extern "C" int k5_iisph_adv(const Geom* g, const float* vel, float* out,
                            void* stream) {
  return launch_sweep(g, IisphAdv{vel, out}, stream);
}

extern "C" int k5_iisph_aii(const Geom* g, const float* dii, float* out,
                            void* stream) {
  return launch_sweep(g, IisphAii{dii, out}, stream);
}

extern "C" int k5_iisph_force(const Geom* g, const float* dpi, float* out,
                              void* stream) {
  return launch_sweep(g, IisphForce{dpi, out}, stream);
}

extern "C" int k6_fused_tension(const Geom* g, const float* ril,
                                const float* rho, const TensionParams* t,
                                float mass, float* normals, float* acc,
                                void* stream) {
  int e = launch_sweep(g, SurfaceNormals{ril, mass, normals}, stream);
  if (e != 0) return e;
  return launch_sweep(g, TensionAccel{rho, normals, *t, acc}, stream);
}

extern "C" int k7_fused_jacobi_iter(const Geom* g, const float* dii,
                                    const float* deninv, const float* aii,
                                    const float* b, float* p, float dt,
                                    float omega, float eps, float* dij,
                                    float* s, float* partials, float* resid,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = blocks_of(g->M);
  int e = launch_sweep(g, IisphDij{deninv, p, dij}, stream);
  if (e != 0) return e;
  e = launch_sweep(g, IisphS{dii, dij, deninv, p, s}, stream);
  if (e != 0) return e;
  k7_update_kernel<<<nb, kBlock, 0, st>>>(g->M, g->liq, aii, b, s, p, dt,
                                          omega, eps, partials);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return static_cast<int>(ce);
  reduce_partials_kernel<<<1, kReduceBlock, 0, st>>>(partials, nb, 0.0f,
                                                     resid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k8_fused_pcisph_iter(const Geom* g, const float* vel_star,
                                    float* p, float dt, float factor,
                                    float w0, float* adv, float* acc,
                                    float* partials, float* err,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = blocks_of(g->M);
  const Starred xs{g->pos, g->liq, vel_star, g->M, dt};
  k8_adv_kernel<<<nb, kBlock, 0, st>>>(*g, xs, adv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k8_pressure_kernel<<<nb, kBlock, 0, st>>>(g->M, g->liq, adv, p, factor, w0,
                                            partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<<<1, kReduceBlock, 0, st>>>(partials, nb, 0.0f, err);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k8_acc_kernel<<<nb, kBlock, 0, st>>>(*g, xs, p, acc);
  return static_cast<int>(cudaGetLastError());
}
