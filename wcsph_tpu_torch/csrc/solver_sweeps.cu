// Hand-written Hopper (sm_90a) kernels of the SESPH, PCISPH and IISPH steps
// and of the surface tension of the DFSPH step (K5-K8 below).
//
// They replace the remaining four Pallas kernels of
// wcsph_tpu/pallas/engine.py: the one-sided sweep _build_sweep (279)
// and the fused programs _build_fused_tension (904),
// _build_fused_iisph_iter (1238) and _build_fused_pcisph_iter (1466), and
// five emits of _build_sweep_sym (441) that only the unfused solver loops
// run alone (their formulas are K6's, K7's and K8's).  As
// in sweeps.cu they compute what those kernels compute, not their TPU
// layout: one thread per receiving particle gathers its own sum over the
// cell-sorted rows (common.cuh), so there is no cell capacity, no plane, no
// occupancy mask, no overlap-add fold and no zero phase, and where a TPU
// program relies on its grid running in order (a phase reads what all
// programs of the phase before wrote), each phase is its own launch on one
// stream.
//
// What bounds a cell-loop sweep on the H100 is what bounds those of
// sweeps.cu: the candidate loop (~216 candidates per receiver, ~13% within
// h) with the neighbour rows coming from L1/L2, not the tens of MB of
// operands in device memory.  So the sweeps that can avoid it do:
//   * the sweeps that run after the step has built its neighbour list walk
//     it (k5_list_kernel, for_each_listed_record): ~30 listed pairs per
//     receiver, bound by the gathers of the neighbours' fields.  These are
//     IISPH's three K5 emits and K7's two sweeps (the IISPH step builds the
//     list after its density sweep), and both launches of K6 (the DFSPH
//     step builds it before its tension), and the unfused entries of those
//     four sweeps;
//   * K8's pairs are those within h at the moved positions x*, which change
//     from iteration to iteration, so it cannot walk the step's list; but
//     its two sweeps of one iteration share the same x*, so the first cuts
//     the candidates once (for_each_neighbor_cut on 16-byte records of x*)
//     and writes its hits to a buffer, which the second walks; so do the
//     unfused loop's two prediction calls of one iteration, the cut
//     (k1_pcisph_predict) into register masks, the walk (k1_pcisph_walk)
//     over its kept hits;
//   * K5's density and SESPH-force emits run on steps that build no list
//     (SESPH, PCISPH; IISPH's density sweep builds it), so they scan the
//     cells, but cut each column's candidates, 32 at a time, into a bit
//     mask in a register before they sum over the hits (k5_cut_kernel,
//     for_each_neighbor_masked).  The shared-memory cut of the DFSPH
//     density sweep (for_each_neighbor_cut) was slower than the single
//     loop for these light bodies on particles at rest: its 40 KB a block
//     take the L1 cache the candidate loop reads from (PERF.md).
//
// A launch returns cudaGetLastError().

#include <type_traits>

#include "common.cuh"

// ---------------------------------------------------------------------------
// K5: the one-sided sweep.  Replaces _build_sweep (engine.py:279), the
// function that runs an emit's one-sided __call__ over the full 27-cell
// window: each receiver sums the emit over its own neighbours and nothing is
// written to the other end of a pair.  Two generic kernels, templated on an
// emit functor:
//   E::kOut      number of accumulated channels
//   E::kAllRows  true: every row receives; false: liquid rows (0 elsewhere)
//   E::Row       what the receiver holds in registers; e.row(g, i) loads it
//   e.pair(g, row, j, rx, ry, rz, d2, n, acc)    the per-pair body
//   e.finish(g, i, acc)                          the per-row epilogue
// where n is what the kernel knows of the neighbour:
//   * k5_cut_kernel scans the cells, for the emits that run where no list
//     exists: each column's candidates are cut into a register bit mask,
//     then the emit runs over the hits (for_each_neighbor_masked: the
//     single loop's calls in its order, so its bits); n is the neighbour's
//     liquid flag;
//   * k5_list_kernel walks the step's list (the same pairs in the same
//     order as the cell loop, so the same bits), for the emits that run
//     after the list is built and receive on liquid rows only (the list
//     holds the pairs of the liquid rows); n is the neighbour's record,
//     the float4 (x, y, z, liquid flag) the walk has already loaded, so an
//     emit that needs the neighbour's position (TensionAccel) reads no
//     other array for it.  It walks at the emit's depth, E::kDepth where
//     the emit sets one, else 1 (WalkDepth; for_each_listed_record).
// ---------------------------------------------------------------------------

// The list walk's depth of a listed emit: its kDepth, or 1 where it sets
// none.
template <class E, class = void>
struct WalkDepth {
  static constexpr int value = 1;
};
template <class E>
struct WalkDepth<E, std::void_t<decltype(E::kDepth)>> {
  static constexpr int value = E::kDepth;
};

template <class E>
__global__ void k5_cut_kernel(Geom g, E e) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  float acc[E::kOut];
#pragma unroll
  for (int k = 0; k < E::kOut; ++k) acc[k] = 0.0f;
  if (E::kAllRows || g.liq[i] != 0.0f) {
    const typename E::Row row = e.row(g, i);
    auto f = [&](int j, float rx, float ry, float rz, float d2) {
      e.pair(g, row, j, rx, ry, rz, d2, g.liq[j], acc);
    };
    for_each_neighbor_masked(g, i, g.pos, f);
  }
  e.finish(g, i, acc);
}

template <class E>
__global__ void k5_list_kernel(Geom g, E e) {
  static_assert(!E::kAllRows, "the list holds the liquid rows' pairs only");
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  float acc[E::kOut];
#pragma unroll
  for (int k = 0; k < E::kOut; ++k) acc[k] = 0.0f;
  if (g.liq[i] != 0.0f) {
    const typename E::Row row = e.row(g, i);
    auto f = [&](int j, float rx, float ry, float rz, float d2,
                 const float4& rj) {
      e.pair(g, row, j, rx, ry, rz, d2, rj, acc);
    };
    constexpr int D = WalkDepth<E>::value;
    for_each_listed_record<D>(g, i, f);
  }
  e.finish(g, i, acc);
}

template <class E>
static int launch_cut_sweep(const Geom* g, const E& e, void* stream) {
  k5_cut_kernel<E><<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
      *g, e);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
static int launch_list_sweep(const Geom* g, const E& e, void* stream) {
  k5_list_kernel<E><<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
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
  __device__ void pair(const Geom& g, const Row&, int, float, float, float,
                       float d2, float lj, float* acc) const {
    acc[0] += volume_of(g, lj) * kernel_w(g, d2);
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
                       float rz, float d2, float lj, float* acc) const {
    const int M = g.M;
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
                       float rz, float d2, const float4& rj,
                       float* acc) const {
    const float lj = rj.w;
    const int M = g.M;
    const float gs = kernel_gs(g, d2);
    const float vgs = volume_of(g, lj) * gs;
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
  __device__ void pair(const Geom& g, const Row& r, int, float rx, float ry,
                       float rz, float d2, const float4& rj,
                       float* acc) const {
    const float lj = rj.w;
    const float f = kernel_gs(g, d2) * (r.dx * rx + r.dy * ry + r.dz * rz);
    acc[0] += volume_of(g, lj) * f;
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
                       float rz, float d2, const float4& rj,
                       float* acc) const {
    const float lj = rj.w;
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
// Both walk the step's neighbour list (k5_list_kernel), which the DFSPH
// step builds after its density sweep, before its tension; both receive on
// liquid rows only (SurfaceNormals' epilogue writes h 0 at the others).
// TensionAccel's adhesion-region test reads the neighbour's position from
// the record the walk has loaded, not from three planar gathers.  What
// bounds them is the gathers per listed neighbour: the record and ril for
// the normals; the record, rho and the three normals for the tension.
// ---------------------------------------------------------------------------

// The normals' sums times `scale`: h in K6, 1 in the unfused entry
// k1_surface_normals (SurfaceNormalsK1), whose caller scales by h
// (engine.surface_normals).
struct SurfaceNormals {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  using Row = NoRow;
  const float* ril;
  float mass;
  float scale;
  float* out;
  __device__ Row row(const Geom&, int) const { return Row{}; }
  __device__ void pair(const Geom& g, const Row&, int j, float rx, float ry,
                       float rz, float d2, const float4&,
                       float* acc) const {
    const float c = mass * ril[j] * kernel_gs(g, d2);
    acc[0] += c * rx;
    acc[1] += c * ry;
    acc[2] += c * rz;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    out[i] = scale * acc[0];
    out[g.M + i] = scale * acc[1];
    out[2 * g.M + i] = scale * acc[2];
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

// The receiver's fields of the tension's pair: its density and h-scaled
// normal.
struct TensionRow {
  float rho, nx, ny, nz;
};

// The neighbour's density and normal as TensionAccel reads them: from the
// planes rho (M,) and n (3, M).
struct TensionPlanes {
  const float* rho;
  const float* n;
  int M, j;
  __device__ float rho_j() const { return rho[j]; }
  __device__ float nx() const { return n[j]; }
  __device__ float ny() const { return n[M + j]; }
  __device__ float nz() const { return n[2 * M + j]; }
};

// _TensionAccel's pair: Akinci cohesion, curvature and boundary adhesion,
// with the neighbour's density and normal from nb (each read where the
// sum needs it).
template <class Nb>
__device__ __forceinline__ void tension_pair(const Geom& g,
                                             const TensionParams& t,
                                             const TensionRow& r, float rx,
                                             float ry, float rz, float d2,
                                             const float4& rj, const Nb& nb,
                                             float* acc) {
  const float lj = rj.w;
  const float h = g.h;
  const float dist = sqrtf(fmaxf(d2, 1.0e-12f));
  const float inv_dist = 1.0f / fmaxf(dist, t.eps);
  const bool pair_ok = d2 > t.eps;
  const float k_ij = t.rho0x2 / fmaxf(r.rho + nb.rho_j(), 1.0f);
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
  // the neighbour's own position, from its record (the floats of g.pos)
  const float ex = rj.x - t.cx;
  const float ey = rj.y - t.cy;
  const float ez = rj.z - t.cz;
  const bool in_region = ex * ex + ey * ey + ez * ez < t.radius2;
  const float adh_gate = (pair_ok && in_region) ? 1.0f - lj : 0.0f;
  const float c_rad = t.coh * w_coh * inv_dist * gate +
                      t.adh * w_adh * inv_dist * adh_gate;
  const float cg = gate * t.curv;
  acc[0] += c_rad * rx + cg * (r.nx - nb.nx());
  acc[1] += c_rad * ry + cg * (r.ny - nb.ny());
  acc[2] += c_rad * rz + cg * (r.nz - nb.nz());
}

struct TensionAccel {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  using Row = TensionRow;
  const float* rho;
  const float* n;
  TensionParams t;
  float* out;
  __device__ Row row(const Geom& g, int i) const {
    return Row{rho[i], n[i], n[g.M + i], n[2 * g.M + i]};
  }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, const float4& rj,
                       float* acc) const {
    tension_pair(g, t, r, rx, ry, rz, d2, rj, TensionPlanes{rho, n, g.M, j},
                 acc);
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
// Launches 1 and 2 walk the step's neighbour list (k5_list_kernel), which
// the IISPH step builds before its Jacobi loop; the positions do not move
// in between.  Both receive on liquid rows only.  What bounds them is the
// gathers per listed neighbour: its record and, for s, its dii, dij and p
// (7 words); for dij, its deninv and p.
// ---------------------------------------------------------------------------

// dij's source factor of row j: fac_j = -liq_j deninv_j p_j formed on the
// fly (K7; k1_iisph_dij walks the caller's fac, IisphDijFac below).
struct FacFromP {
  const float* deninv;
  const float* p;
  __device__ float operator()(int j, float lj) const {
    return -lj * deninv[j] * p[j];
  }
};

template <class Fac>
struct IisphDijOf {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  using Row = NoRow;
  Fac fac;
  float* out;
  __device__ Row row(const Geom&, int) const { return Row{}; }
  __device__ void pair(const Geom& g, const Row&, int j, float rx, float ry,
                       float rz, float d2, const float4& rj,
                       float* acc) const {
    const float fg = fac(j, rj.w) * kernel_gs(g, d2);
    acc[0] += fg * rx;
    acc[1] += fg * ry;
    acc[2] += fg * rz;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};
using IisphDij = IisphDijOf<FacFromP>;

// s's pressure terms: p_liq_j = liq_j p_j and the receiver's g_i =
// deninv_i p_i formed on the fly (K7) ...
struct PressFromP {
  const float* deninv;
  const float* p;
  __device__ float p_liq(int j, float lj) const { return lj * p[j]; }
  __device__ float g_of(int i) const { return deninv[i] * p[i]; }
};

// ... or the caller's p_liq and g, the JAX method's operands (k1_iisph_s).
struct PressFields {
  const float* p_liq_f;
  const float* g_f;
  __device__ float p_liq(int j, float) const { return p_liq_f[j]; }
  __device__ float g_of(int i) const { return g_f[i]; }
};

template <class P>
struct IisphSOf {
  static constexpr int kOut = 1;
  static constexpr bool kAllRows = false;
  struct Row {
    float dx, dy, dz, g;  // the receiver's dij and g = deninv p
  };
  const float* dii;
  const float* dij;
  P press;
  float* out;
  __device__ Row row(const Geom& g, int i) const {
    return Row{dij[i], dij[g.M + i], dij[2 * g.M + i], press.g_of(i)};
  }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, const float4& rj,
                       float* acc) const {
    const float lj = rj.w;
    const int M = g.M;
    const float gs = kernel_gs(g, d2);
    const float dij_dot_i = gs * (r.dx * rx + r.dy * ry + r.dz * rz);
    const float dii_j_dot =
        gs * press.p_liq(j, lj) *
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
using IisphS = IisphSOf<PressFromP>;

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
// K1's IISPH emits of the unfused loop: K7's two list sweeps alone, on the
// JAX method's operands (_IisphDij 2397 on fac; _IisphS 2417 on p_liq and
// g), which only that loop runs.  Each walks the list at a depth of its
// own; the pairs, their order and their arithmetic are K7's, term for term
// (the same bits).  What bounds them is the gathers per listed neighbour:
//   * dij's pair reads j's record and fac_j.  Its entry first packs
//     (x_j, y_j, z_j, fac_j) into records of its own, which the walk reads
//     in place of the list's: one 16-byte load a pair where there were
//     two, for a pass of ~35 MB (0.98x the walk at depth 8 alone at rest,
//     0.96x jittered, the pass counted in; PERF.md §6);
//   * s's pair reads seven words of j from seven planes (dii and dij three
//     each, p_liq).  Packed into one 32-byte row a neighbour they cost a
//     pass of ~66 MB and gained nothing at rest, where the cell-sorted
//     neighbours of a warp's rows share the planes' sectors in L1 (1.16x
//     the walk alone at depth 8; 0.91x jittered): the walk reads the planes.
// ---------------------------------------------------------------------------

// The list walk's depth (for_each_listed_record) of the two: of depths 2,
// 4, 8 and 16 on the 1M dam break, the fastest by device time at rest and
// jittered (PERF.md §6).  Every other emit of k5_list_kernel walks at 1.
constexpr int kIisphDijDepth = 8;
constexpr int kIisphSDepth = 8;

// dij's walk records: (x_j, y_j, z_j, fac_j), walked in place of the
// list's (x, y, z, liquid flag).  fac carries the liquid mask (0 at a
// boundary row), so the pair needs no flag.
__global__ void k1_fac_records_kernel(int M, const float* __restrict__ pos,
                                      const float* __restrict__ fac,
                                      float4* __restrict__ rec) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < M) rec[i] = make_float4(pos[i], pos[M + i], pos[2 * M + i], fac[i]);
}

// IisphDijOf's pair, with fac_j the record's .w.
struct IisphDijFac {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  static constexpr int kDepth = kIisphDijDepth;
  using Row = NoRow;
  float* out;
  __device__ Row row(const Geom&, int) const { return Row{}; }
  __device__ void pair(const Geom& g, const Row&, int, float rx, float ry,
                       float rz, float d2, const float4& rj,
                       float* acc) const {
    const float fg = rj.w * kernel_gs(g, d2);
    acc[0] += fg * rx;
    acc[1] += fg * ry;
    acc[2] += fg * rz;
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

struct IisphSFields : IisphSOf<PressFields> {
  static constexpr int kDepth = kIisphSDepth;
};

// ---------------------------------------------------------------------------
// K1's tension emits of the unfused DFSPH step: K6's two list sweeps alone,
// on the JAX methods' operands (_SurfaceNormals 2498 on ril, unscaled;
// _TensionAccel 2519 on rho and the h-scaled normals), which only that
// step runs.  Each walks the list at a depth of its own; the pairs, their
// order and their arithmetic are K6's, term for term (the same bits), and
// K6's two instances walk at 1 with their machine code.  What bounds them
// is the gathers per listed neighbour:
//   * the normals' pair reads j's record and ril_j.  Packing
//     (x_j, y_j, z_j, m ril_j) into records of their own, walked in place
//     of the list's as dij's are, lost in both scenes (1.03x the walk at
//     depth 8 alone, the pass counted in; PERF.md §6): the walk reads ril;
//   * the tension's pair reads j's record, rho_j and the three planes of
//     its normal.  Its entry first packs (nx_j, ny_j, nz_j, rho_j) into one
//     16-byte row a neighbour, one aligned load a pair beside the record
//     where there were four gathers, for a pass of ~35 MB (0.95x the walk
//     at depth 4 alone at rest, 0.97x jittered, the pass counted in).
// ---------------------------------------------------------------------------

// The list walk's depth (for_each_listed_record) of the two: of depths 2,
// 4, 8 and 16 on the 1M dam break, the fastest by device time at rest and
// jittered (PERF.md §6).
constexpr int kSurfaceNormalsDepth = 8;
constexpr int kTensionAccelDepth = 4;

struct SurfaceNormalsK1 : SurfaceNormals {
  static constexpr int kDepth = kSurfaceNormalsDepth;
};

// The tension's rows: (nx_j, ny_j, nz_j, rho_j).
__global__ void k1_tension_rows_kernel(int M, const float* __restrict__ rho,
                                       const float* __restrict__ n,
                                       float4* __restrict__ rows) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < M) rows[i] = make_float4(n[i], n[M + i], n[2 * M + i], rho[i]);
}

// The neighbour's density and normal from its packed row.
struct TensionPacked {
  float4 q;
  __device__ float rho_j() const { return q.w; }
  __device__ float nx() const { return q.x; }
  __device__ float ny() const { return q.y; }
  __device__ float nz() const { return q.z; }
};

// TensionAccel's pair on the packed rows.
struct TensionAccelK1 {
  static constexpr int kOut = 3;
  static constexpr bool kAllRows = false;
  static constexpr int kDepth = kTensionAccelDepth;
  using Row = TensionRow;
  const float4* rows;
  TensionParams t;
  float* out;
  __device__ Row row(const Geom&, int i) const {
    const float4 q = __ldg(rows + i);
    return Row{q.w, q.x, q.y, q.z};
  }
  __device__ void pair(const Geom& g, const Row& r, int j, float rx, float ry,
                       float rz, float d2, const float4& rj,
                       float* acc) const {
    tension_pair(g, t, r, rx, ry, rz, d2, rj, TensionPacked{__ldg(rows + j)},
                 acc);
  }
  __device__ void finish(const Geom& g, int i, const float* acc) const {
    store_channels<kOut>(out, g.M, i, acc);
  }
};

// ---------------------------------------------------------------------------
// K8: a whole PCISPH prediction iteration.  Replaces
// _build_fused_pcisph_iter (engine.py:1466), whose two sweeps both run at
// the moved positions x* = x + liq v* dt, with the candidates of the
// ORIGINAL cells (Geom.cell, Geom.start) and a pair cut by its distance at
// x*.  Both sweeps of one iteration see the same pairs, so only the first
// cuts the candidates; five launches:
//   1. each row's 16-byte record (x*, liquid flag), and the overflow flag
//      cleared;
//   2. predicted density adv_i = sum_j V_j W(|x*_i - x*_j|) (_PcisphAdvPart
//      2310) over the candidates cut at the records (for_each_neighbor_cut:
//      cut into shared memory, then sum).  The sum writes each hit, in the
//      loop's order, to the hit buffer: hit k of row i at hits[k M + i] (the
//      warp's 32 rows side by side, so each k is one coalesced store), for
//      k < width, and the row's count of kept hits; a liquid row with more
//      hits than width raises *over to its hit count (atomicMax: the
//      largest, whatever the order).  adv sums every hit;
//   3. p' = p + factor (max(w0 + adv, 1) - 1) in place, and a block partial
//      of liq (max(w0 + adv, 1) - 1); then the fixed-order sum;
//   4. pressure acceleration -sum c gs r at x* with p' at both ends
//      (_PcisphAccPart 2323): c = V0 (p'_i + p'_j) for a liquid neighbour,
//      Vs p'_i for a boundary one, over the kept hits: no candidate is
//      scanned.  Where *over is set the hits were cut short: the caller
//      runs the step again with a wider buffer.
// The same pairs in the same order as the cell loop at x*, so the same
// bits.  Bound: the cut (~216 candidates per receiver, one 16-byte record
// each) in launch 2; launch 4 walks ~30 hits of 2 words and a record each.
// ---------------------------------------------------------------------------

__global__ void k8_star_kernel(int M, const float* __restrict__ pos,
                               const float* __restrict__ liq,
                               const float* __restrict__ vel_star, float dt,
                               float4* __restrict__ xs,
                               int* __restrict__ over) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i == 0) *over = 0;
  if (i >= M) return;
  const float l = liq[i];
  float x[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x0 = pos[c * M + i];
    x[c] = l != 0.0f ? x0 + vel_star[c * M + i] * dt : x0;
  }
  xs[i] = make_float4(x[0], x[1], x[2], l);
}

__global__ void k8_adv_kernel(Geom g, const float4* __restrict__ xs,
                              int width, int* __restrict__ hits,
                              int* __restrict__ nhit, int* __restrict__ over,
                              float* __restrict__ adv) {
  __shared__ int slot[kCutSlots * kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const int M = g.M;
  float acc = 0.0f;
  int k = 0;
  if (g.liq[i] != 0.0f) {
    auto f = [&](int j, float, float, float, float d2) {
      acc += volume(g, j) * kernel_w(g, d2);
      if (k < width) hits[k * M + i] = j;
      ++k;
    };
    for_each_neighbor_cut(g, i, RecordPos{xs}, slot + threadIdx.x, f);
  }
  adv[i] = acc;
  nhit[i] = min(k, width);
  if (k > width) atomicMax(over, k);
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

__global__ void k8_acc_kernel(Geom g, const float4* __restrict__ xs,
                              const int* __restrict__ hits,
                              const int* __restrict__ nhit,
                              const float* __restrict__ p,
                              float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const int M = g.M;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  const int n = nhit[i];
  if (n > 0) {
    const float4 ri = __ldg(xs + i);
    const float pi = p[i];
    const int* slot = hits + i;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const int j = __ldg(slot + k * M);
      const float4 rj = __ldg(xs + j);
      const float rx = ri.x - rj.x;
      const float ry = ri.y - rj.y;
      const float rz = ri.z - rj.z;
      const float d2 = rx * rx + ry * ry + rz * rz;
      const float lj = rj.w;
      const float c = lj * g.vl * (pi + p[j]) + (1.0f - lj) * g.vs * pi;
      const float fg = c * kernel_gs(g, d2);
      ax -= fg * rx;
      ay -= fg * ry;
      az -= fg * rz;
    }
  }
  out[i] = ax;
  out[M + i] = ay;
  out[2 * M + i] = az;
}

// ---------------------------------------------------------------------------
// K1's emits that only the unfused solver loops (fused_solver_iters=False)
// run alone, each an entry of its own.  Replaces _build_sweep_sym
// (engine.py:441) with these emits:
//   * _IisphDij (2397), _IisphS (2417): K7's two list sweeps on the JAX
//     method's operands (fac; p_liq and g) instead of forming them from p;
//     the s sweep reads its neighbours' finished dij, so they are two calls
//     in order, as in K7;
//   * _SurfaceNormals (2498), _TensionAccel (2519): K6's two list sweeps,
//     the normals unscaled (the caller scales by h), with emits of their
//     own (SurfaceNormalsK1, TensionAccelK1);
//   * _PcisphPredict (2270): predicted density and pressure acceleration
//     at the moved positions x* (3, M), two entries.  No list holds the
//     pairs at x*, and the unfused loop calls it twice an iteration at the
//     same x* with another pressure (first the old, then the updated one),
//     so the first call, the cut (k1_pcisph_predict_kernel), scans the
//     cells of the grid binned at x and cuts at x* (for_each_neighbor_masked
//     on the planar x*: K8's pair set, in the cell loop's order, at liquid
//     receivers), sums both outputs, and keeps what the second needs: each
//     row's record rec[i] = (x*, liquid flag), its hits in scan order at
//     hits[k M + i] for k < width (K8's layout, grid.StarHits) and its full
//     hit count; the second, the walk (k1_pcisph_walk_kernel), sums the
//     same outputs over the kept hits, one 16-byte record and one pressure
//     load a hit, as k8_acc_kernel.  A row with more hits than width scans
//     its cells again at x* inside the walk, in the same order: the same
//     bits, and no flag, overflow or replay.  Both run predict_pair on the
//     same pair geometry, so the walk's bits are those of a cut at the same
//     x* and pressure.  The out-of-domain rows lie in no cell's range and
//     no cell lies in their window, so they take no pair.  Bound: the cut,
//     the candidate loop, as K5's cut sweeps; the walk, its gathers.
// ---------------------------------------------------------------------------

// One pair's terms of _PcisphPredict into (adv, acc): V_j W and -c gs r,
// c = V0 (p_i + p_j) for a liquid neighbour (lj 1), Vs p_i for a boundary
// one (lj 0).
__device__ __forceinline__ void predict_pair(const Geom& g, float pi,
                                             float lj, float pj, float rx,
                                             float ry, float rz, float d2,
                                             float& adv, float* acc) {
  adv += volume_of(g, lj) * kernel_w(g, d2);
  const float c = lj * g.vl * (pi + pj) + (1.0f - lj) * g.vs * pi;
  const float fg = c * kernel_gs(g, d2);
  acc[0] -= fg * rx;
  acc[1] -= fg * ry;
  acc[2] -= fg * rz;
}

__device__ __forceinline__ void store_predict(int M, int i, float adv,
                                              const float* acc, float* out) {
  out[i] = adv;
  out[M + i] = acc[0];
  out[2 * M + i] = acc[1];
  out[3 * M + i] = acc[2];
}

__global__ void k1_pcisph_predict_kernel(Geom g, const float* __restrict__ xs,
                                         const float* __restrict__ p,
                                         int width, int* __restrict__ hits,
                                         int* __restrict__ nhit,
                                         float4* __restrict__ rec,
                                         float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const int M = g.M;
  const float li = g.liq[i];
  rec[i] = make_float4(xs[i], xs[M + i], xs[2 * M + i], li);
  float adv = 0.0f, acc[3] = {0.0f, 0.0f, 0.0f};
  int k = 0;
  if (li != 0.0f) {
    const float pi = p[i];
    auto f = [&](int j, float rx, float ry, float rz, float d2) {
      predict_pair(g, pi, g.liq[j], p[j], rx, ry, rz, d2, adv, acc);
      if (k < width) hits[k * M + i] = j;
      ++k;
    };
    for_each_neighbor_masked(g, i, xs, f);
  }
  nhit[i] = k;
  store_predict(M, i, adv, acc, out);
}

__global__ void k1_pcisph_walk_kernel(Geom g, const float* __restrict__ xs,
                                      const float* __restrict__ p, int width,
                                      const int* __restrict__ hits,
                                      const int* __restrict__ nhit,
                                      const float4* __restrict__ rec,
                                      float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const int M = g.M;
  float adv = 0.0f, acc[3] = {0.0f, 0.0f, 0.0f};
  const int n = nhit[i];     // 0 at boundary rows
  if (n > 0) {
    const float pi = p[i];
    if (n <= width) {
      const float4 ri = __ldg(rec + i);
      const int* slot = hits + i;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const int j = __ldg(slot + k * M);
        const float4 rj = __ldg(rec + j);
        const float rx = ri.x - rj.x;
        const float ry = ri.y - rj.y;
        const float rz = ri.z - rj.z;
        predict_pair(g, pi, rj.w, p[j], rx, ry, rz,
                     rx * rx + ry * ry + rz * rz, adv, acc);
      }
    } else {     // the cut kept only width of its hits: scan again
      auto f = [&](int j, float rx, float ry, float rz, float d2) {
        predict_pair(g, pi, g.liq[j], p[j], rx, ry, rz, d2, adv, acc);
      };
      for_each_neighbor_masked(g, i, xs, f);
    }
  }
  store_predict(M, i, adv, acc, out);
}

// ---------------------------------------------------------------------------
// Plain C entry points (bound with ctypes by engine.py).  Each returns the
// first cudaError_t of its launches (0 = all launched).
// ---------------------------------------------------------------------------

extern "C" int k5_density_alpha(const Geom* g, float* out, void* stream) {
  return launch_cut_sweep(g, DensityAlpha{out}, stream);
}

extern "C" int k5_sesph_force(const Geom* g, const float* vel,
                              const float* rinv, const float* rr,
                              const float* pi, const float* p, float a_liq,
                              float b_sol, float d0, float rho0, float* out,
                              void* stream) {
  return launch_cut_sweep(
      g, SesphForce{vel, rinv, rr, pi, p, a_liq, b_sol, d0, rho0, out},
      stream);
}

extern "C" int k5_iisph_adv(const Geom* g, const float* vel, float* out,
                            void* stream) {
  return launch_list_sweep(g, IisphAdv{vel, out}, stream);
}

extern "C" int k5_iisph_aii(const Geom* g, const float* dii, float* out,
                            void* stream) {
  return launch_list_sweep(g, IisphAii{dii, out}, stream);
}

extern "C" int k5_iisph_force(const Geom* g, const float* dpi, float* out,
                              void* stream) {
  return launch_list_sweep(g, IisphForce{dpi, out}, stream);
}

extern "C" int k6_fused_tension(const Geom* g, const float* ril,
                                const float* rho, const TensionParams* t,
                                float mass, float* normals, float* acc,
                                void* stream) {
  int e = launch_list_sweep(g, SurfaceNormals{ril, mass, g->h, normals},
                            stream);
  if (e != 0) return e;
  return launch_list_sweep(g, TensionAccel{rho, normals, *t, acc}, stream);
}

extern "C" int k7_fused_jacobi_iter(const Geom* g, const float* dii,
                                    const float* deninv, const float* aii,
                                    const float* b, float* p, float dt,
                                    float omega, float eps, float* dij,
                                    float* s, float* partials, float* resid,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = blocks_of(g->M);
  int e = launch_list_sweep(g, IisphDij{{deninv, p}, dij}, stream);
  if (e != 0) return e;
  e = launch_list_sweep(g, IisphS{dii, dij, {deninv, p}, s}, stream);
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
                                    float w0, int width, int* hits, int* nhit,
                                    float* xs, int* over, float* adv,
                                    float* acc, float* partials, float* err,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = blocks_of(g->M);
  float4* rec = reinterpret_cast<float4*>(xs);
  k8_star_kernel<<<nb, kBlock, 0, st>>>(g->M, g->pos, g->liq, vel_star, dt,
                                        rec, over);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k8_adv_kernel<<<nb, kBlock, 0, st>>>(*g, rec, width, hits, nhit, over, adv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k8_pressure_kernel<<<nb, kBlock, 0, st>>>(g->M, g->liq, adv, p, factor, w0,
                                            partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<<<1, kReduceBlock, 0, st>>>(partials, nb, 0.0f, err);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k8_acc_kernel<<<nb, kBlock, 0, st>>>(*g, rec, hits, nhit, p, acc);
  return static_cast<int>(cudaGetLastError());
}

// rec: (M, 4) floats, 16-byte aligned, the walk's records (scratch).
extern "C" int k1_iisph_dij(const Geom* g, const float* fac, float* rec,
                            float* out, void* stream) {
  k1_fac_records_kernel<<<blocks_of(g->M), kBlock, 0,
                          (cudaStream_t)stream>>>(
      g->M, g->pos, fac, reinterpret_cast<float4*>(rec));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  Geom walk = *g;
  walk.nl_rec = reinterpret_cast<const float4*>(rec);
  return launch_list_sweep(&walk, IisphDijFac{out}, stream);
}

extern "C" int k1_iisph_s(const Geom* g, const float* dii, const float* dij,
                          const float* p_liq, const float* gi, float* out,
                          void* stream) {
  return launch_list_sweep(g, IisphSFields{{dii, dij, {p_liq, gi}, out}},
                           stream);
}

extern "C" int k1_surface_normals(const Geom* g, const float* ril,
                                  float mass, float* out, void* stream) {
  return launch_list_sweep(g, SurfaceNormalsK1{{ril, mass, 1.0f, out}},
                           stream);
}

// rows: (M, 4) floats, 16-byte aligned, the neighbours' rows (scratch).
extern "C" int k1_tension_accel(const Geom* g, const float* rho,
                                const float* n, const TensionParams* t,
                                float* rows, float* out, void* stream) {
  float4* packed = reinterpret_cast<float4*>(rows);
  k1_tension_rows_kernel<<<blocks_of(g->M), kBlock, 0,
                           (cudaStream_t)stream>>>(g->M, rho, n, packed);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_list_sweep(g, TensionAccelK1{packed, *t, out}, stream);
}

extern "C" int k1_pcisph_predict(const Geom* g, const float* xs,
                                 const float* p, int width, int* hits,
                                 int* nhit, float* rec, float* out,
                                 void* stream) {
  k1_pcisph_predict_kernel<<<blocks_of(g->M), kBlock, 0,
                             (cudaStream_t)stream>>>(
      *g, xs, p, width, hits, nhit, reinterpret_cast<float4*>(rec), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k1_pcisph_walk(const Geom* g, const float* xs, const float* p,
                              int width, const int* hits, const int* nhit,
                              const float* rec, float* out, void* stream) {
  k1_pcisph_walk_kernel<<<blocks_of(g->M), kBlock, 0,
                          (cudaStream_t)stream>>>(
      *g, xs, p, width, hits, nhit, reinterpret_cast<const float4*>(rec),
      out);
  return static_cast<int>(cudaGetLastError());
}
