// Hand-written Hopper (sm_90a) kernels of the DFSPH main path.
//
// They replace the four Pallas kernels of wcsph_tpu/pallas/engine.py that
// the flagship step runs (K1-K4 below).  They compute what those kernels
// compute, not their TPU layout: the capacity-padded cells, 8-row rank
// blocks, 128-lane margins, plane DMA, occupancy bitmasks and the
// overlap-add fold of the TPU engine exist because that chip has 128-wide
// lanes, no atomics and no cheap gathers.  Here each receiving particle gets
// one thread that gathers its own sum over the cell-sorted rows (common.cuh:
// geometry, pair math, neighbour loop, fixed-order global sums).
//
// The per-receiver formulas are the one-sided __call__ bodies of the TPU
// emits (_DensityAlphaDrho 1981, _KappaAcc 2005, _DivAcc 2029, _ViscAcc
// 2053, _ViscInit 2099, _Vorticity 2145); one templated neighbour loop
// with a per-formula functor serves all of them.
//
// What bounds a cell-loop sweep on the H100: not DRAM (each row's fields
// are read from device memory about once per sweep, tens of MB at 1M rows)
// but the candidate loop itself (for_each_neighbor), ~216 candidates per
// receiver of which ~12% lie within h, each costing its loads and its cut,
// and a pair body that the whole warp runs wherever any of its lanes has a
// hit.  K1's density sweep, which runs before the step's list exists,
// splits the two: for_each_neighbor_cut cuts first into a per-thread
// buffer of shared memory, then sums over its own hits.
//
// Positions do not move between the sort and the position update.  So the
// DFSPH and IISPH steps build a neighbour list once, right after their
// density sweep (nbr_list_fill: one cell-loop pass that writes what the
// loop finds, in its order, and each row's 16-byte record of position and
// liquid flag), and every sweep that runs after it walks the list
// (for_each_listed): K2, K3, the _DivAcc entry (which shares K2's
// divergence launch), the _ViscInit and _Vorticity entries and K4's
// matvec.  ~30 listed pairs per receiver, no cut, each slot a coalesced
// read and each neighbour's geometry one 16-byte load.  What bounds a walk
// then is its gathers: per listed neighbour the record and the sweep's own
// fields of that row (vorticity: vel, om and rinv, 7 words; visc-init: x
// and rinv, 4; K4: d and rinv, 4), each a scattered load served from L1/L2
// since a warp's neighbours lie in 9 row ranges.  These sweeps need the
// list: there is no cell-loop form of them.
//
// A launch returns cudaGetLastError().

#include "common.cuh"

// sum_j V_j gs (v_i - v_j).r  (_DivAcc), over the list
__device__ __forceinline__ float div_sum(const Geom& g, int i,
                                         const float* __restrict__ vel) {
  const int M = g.M;
  const float vx = vel[i], vy = vel[M + i], vz = vel[2 * M + i];
  float acc = 0.0f;
  auto f = [&](int j, float rx, float ry, float rz, float d2, float lj) {
    const float dv = (vx - vel[j]) * rx + (vy - vel[M + j]) * ry +
                     (vz - vel[2 * M + j]) * rz;
    acc += volume_of(g, lj) * kernel_gs(g, d2) * dv;
  };
  for_each_listed(g, i, f);
  return acc;
}

// Kappa source of the kappa sweep: a field k' (K2) ...
struct KField {
  const float* k;
  __device__ float operator()(int j) const { return k[j]; }
};

// ... or k' = dt (S + bias) A formed on the fly (K3).
struct KFromS {
  const float* s;
  const float* a;
  float dt, bias;
  __device__ float operator()(int j) const {
    return dt * (s[j] + bias) * a[j];
  }
};

// sum_j V_j (k'_i + k'_j) gs r  (_KappaAcc), over the list
template <class K>
__device__ __forceinline__ void kappa_sum(const Geom& g, int i, const K& k,
                                          float& ax, float& ay, float& az) {
  const float ki = k(i);
  auto f = [&](int j, float rx, float ry, float rz, float d2, float lj) {
    const float c = volume_of(g, lj) * (ki + k(j)) * kernel_gs(g, d2);
    ax += c * rx;
    ay += c * ry;
    az += c * rz;
  };
  for_each_listed(g, i, f);
}

// Weiler viscosity pair coefficient seen from receiver i (_ViscAcc), lj
// the neighbour's liquid flag.
__device__ __forceinline__ float visc_coeff(float lj, int j, float d2,
                                            const float* __restrict__ rinv,
                                            float ri, float a_liq,
                                            float b_sol, float d0) {
  return (lj * a_liq * rinv[j] + (1.0f - lj) * b_sol * ri) / (d2 + d0);
}

// ---------------------------------------------------------------------------
// K1: the pair sweep.  Replaces _build_sweep_sym (engine.py:441) with its
// overlap-add fold _fold_sym_tot (601), for the four emits of the main path.
// One launch per call; one thread per receiver.  The Newton half window of
// the TPU kernel (each pair once, both sides written) would need atomic
// mirror writes here; the gather form evaluates each pair from both ends
// instead and needs none.
// ---------------------------------------------------------------------------

// _DensityAlphaDrho: every in-domain receiver.  out (7, M):
// [sum V_j W, count, sum V_j gs r (3), sum_liq (V0 gs)^2 d2,
//  sum V_j gs (v_i - v_j).r]
// It runs before the step's list exists (its counts size the list), so it
// scans the cells.  Bound: the candidate loop, not bytes.  In a single
// loop a warp's lanes, spread over ~4 cells, ran the two-sqrt,
// two-division pair body on the union of their hits; for_each_neighbor_cut
// cuts into kCutSlots hit slots per thread (40 KB of shared memory per
// block) and then sums each receiver's own hits in the loop's order, so
// the outputs keep the single loop's bits.  Replaces _build_sweep_sym
// (engine.py:441) with the emit _DensityAlphaDrho.
__global__ void k1_density_kernel(Geom g, const float* __restrict__ vel,
                                  float* __restrict__ out) {
  __shared__ int hits[kCutSlots * kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const int M = g.M;
  const float vx = vel[i], vy = vel[M + i], vz = vel[2 * M + i];
  float rho = 0.0f, cnt = 0.0f, sgx = 0.0f, sgy = 0.0f, sgz = 0.0f;
  float sq = 0.0f, div = 0.0f;
  auto f = [&](int j, float rx, float ry, float rz, float d2) {
    const bool lj = g.liq[j] != 0.0f;
    const float vj = lj ? g.vl : g.vs;
    const float gs = kernel_gs(g, d2);
    rho += vj * kernel_w(g, d2);
    cnt += 1.0f;
    const float vgs = vj * gs;
    sgx += vgs * rx;
    sgy += vgs * ry;
    sgz += vgs * rz;
    if (lj) {
      const float lgs = g.vl * gs;
      sq += lgs * lgs * d2;
    }
    const float dv = (vx - vel[j]) * rx + (vy - vel[M + j]) * ry +
                     (vz - vel[2 * M + j]) * rz;
    div += vgs * dv;
  };
  for_each_neighbor_cut(g, i, PlanarPos{g.pos, M}, hits + threadIdx.x, f);
  out[i] = rho;
  out[M + i] = cnt;
  out[2 * M + i] = sgx;
  out[3 * M + i] = sgy;
  out[4 * M + i] = sgz;
  out[5 * M + i] = sq;
  out[6 * M + i] = div;
}

// _DivAcc at liquid receivers (0 elsewhere), over the list.  Also K2's
// second launch.
__global__ void k1_div_kernel(Geom g, const float* __restrict__ vel,
                              float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  out[i] = g.liq[i] != 0.0f ? div_sum(g, i, vel) : 0.0f;
}

// _ViscInit at liquid receivers, over the list.  out (9, M): [sum c gs
// r_a r_b for (xx, xy, xz, yy, yz, zz), sum c gs (x_i - x_j).r r (3)]
__global__ void k1_visc_init_kernel(Geom g, const float* __restrict__ x,
                                    const float* __restrict__ rinv,
                                    float a_liq, float b_sol, float d0,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const int M = g.M;
  float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (g.liq[i] != 0.0f) {
    const float xx = x[i], xy = x[M + i], xz = x[2 * M + i];
    const float ri = rinv[i];
    auto f = [&](int j, float rx, float ry, float rz, float d2, float lj) {
      const float c = visc_coeff(lj, j, d2, rinv, ri, a_liq, b_sol, d0);
      const float gs = kernel_gs(g, d2);
      const float cg = c * gs;
      acc[0] += cg * rx * rx;
      acc[1] += cg * rx * ry;
      acc[2] += cg * rx * rz;
      acc[3] += cg * ry * ry;
      acc[4] += cg * ry * rz;
      acc[5] += cg * rz * rz;
      const float dxr = (xx - x[j]) * rx + (xy - x[M + j]) * ry +
                        (xz - x[2 * M + j]) * rz;
      const float cf = c * dxr * gs;
      acc[6] += cf * rx;
      acc[7] += cf * ry;
      acc[8] += cf * rz;
    };
    for_each_listed(g, i, f);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k * M + i] = acc[k];
}

// _Vorticity at liquid receivers, over the list.  out (9, M):
// [sum mass_j (d_om x r) gs (3), sum liq_j W / rho_j d_om (3),
//  sum stretch_j (d_vel x r) gs (3)], d_q = q_i - liq_j q_j
__global__ void k1_vorticity_kernel(Geom g, const float* __restrict__ vel,
                                    const float* __restrict__ om,
                                    const float* __restrict__ rinv,
                                    float m, float rho0vs, float rho0vl,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const int M = g.M;
  float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (g.liq[i] != 0.0f) {
    const float oi[3] = {om[i], om[M + i], om[2 * M + i]};
    const float vi[3] = {vel[i], vel[M + i], vel[2 * M + i]};
    auto f = [&](int j, float rx, float ry, float rz, float d2, float lj) {
      const float sj = 1.0f - lj;
      const float r[3] = {rx, ry, rz};
      float dom[3], dve[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dom[c] = oi[c] - lj * om[c * M + j];
        dve[c] = vi[c] - lj * vel[c * M + j];
      }
      const float mass_j = m * lj + rho0vs * sj;
      const float str_j = m * lj + rho0vl * sj;
      const float gs = kernel_gs(g, d2);
      const float tw = lj * kernel_w(g, d2) * rinv[j];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int c0 = (c + 1) % 3, c1 = (c + 2) % 3;
        acc[c] += mass_j * ((dom[c0] * r[c1] - dom[c1] * r[c0]) * gs);
        acc[3 + c] += tw * dom[c];
        acc[6 + c] += str_j * ((dve[c0] * r[c1] - dve[c1] * r[c0]) * gs);
      }
    };
    for_each_listed(g, i, f);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k * M + i] = acc[k];
}

// ---------------------------------------------------------------------------
// K2: fused kappa velocity update + divergence.  Replaces _build_fused_iter
// (engine.py:736).  The TPU kernel runs both sweeps in one program because
// its grid runs in order (phase 0 finishes before phase 1 reads).  Blocks
// of a CUDA grid run in no order, so it is two launches on one stream:
//   1. gated kappa sweep, vel += gate * sum V_j (k'_i + k'_j) gs r, in place
//      (safe: this sweep reads neighbours' k', never their velocity);
//   2. the divergence sweep of the updated velocity (k1_div_kernel), which
//      reads neighbours' velocities and so must follow launch 1.
// Both walk the step's neighbour list.
// ---------------------------------------------------------------------------

__global__ void k2_kappa_kernel(Geom g, float* __restrict__ vel,
                                const float* __restrict__ kf,
                                const float* __restrict__ gate) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const float gi = gate[i];
  if (gi == 0.0f) return;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  kappa_sum(g, i, KField{kf}, ax, ay, az);
  const int M = g.M;
  vel[i] += gi * ax;
  vel[M + i] += gi * ay;
  vel[2 * M + i] += gi * az;
}

// ---------------------------------------------------------------------------
// K3: a whole DFSPH divergence (mode 0) or pressure (mode 1) iteration.
// Replaces _build_fused_iter_full (engine.py:1041), whose three in-order
// grid phases and SMEM error accumulator become three launches:
//   1. kappa sweep with k'_j = dt (S_j + bias) A_j formed on the fly, the
//      receiver also doing kv += (S_i + bias) A_i (bias = -mode);
//   2. divergence sweep of the new velocity whose epilogue writes the next
//      S (mode 0: max(paux acc, 0); mode 1: max(paux + dt acc, 1)) in
//      place (launch 1 was the only reader of S) and a per-block partial of
//      sum liq (S' - mode);
//   3. one block sums the partials in a fixed order.  No atomics: a fixed
//      order keeps the error, and so the iteration count, identical from
//      run to run.
// Launches 1 and 2 walk the step's neighbour list; a call runs 2 walks of
// ~30 slots per receiver where the cell loop scanned ~216 candidates twice.
// ---------------------------------------------------------------------------

__global__ void k3_kappa_kernel(Geom g, float* __restrict__ vel,
                                float* __restrict__ kv,
                                const float* __restrict__ s,
                                const float* __restrict__ a, float dt,
                                float bias) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  kv[i] += (s[i] + bias) * a[i];
  if (g.liq[i] == 0.0f) return;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  kappa_sum(g, i, KFromS{s, a, dt, bias}, ax, ay, az);
  const int M = g.M;
  vel[i] += ax;
  vel[M + i] += ay;
  vel[2 * M + i] += az;
}

__global__ void k3_div_kernel(Geom g, const float* __restrict__ vel,
                              float* __restrict__ s,
                              const float* __restrict__ paux, float dt,
                              int mode, float* __restrict__ partials) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float part = 0.0f;
  if (i < g.M) {
    const float lq = g.liq[i];
    const float acc = lq != 0.0f ? div_sum(g, i, vel) : 0.0f;
    const float sn = mode ? fmaxf(paux[i] + dt * acc, 1.0f)
                          : fmaxf(paux[i] * acc, 0.0f);
    s[i] = sn;
    part = lq * (sn - static_cast<float>(mode));
  }
  block_partial(part, partials);
}

// ---------------------------------------------------------------------------
// The step's neighbour list (no TPU counterpart: the TPU engine cuts the
// candidates again in every sweep, since it has no cheap gather).  One
// thread per row writes its record rec[i] = (x, y, z, liquid flag)
// (Geom.nl_rec), runs the cell loop once and writes each neighbour it
// finds, in the loop's order (ascending j), into its slots of the sliced
// ELL layout (common.cuh, Geom.nl_idx); the rest of its slots, and every
// slot of a boundary row, take the padding sentinel -1.  The slice widths
// come from the density sweep's count of the same pairs under the same
// cut, so a liquid row's neighbours fill exactly its first count slots.  A
// row that finds more neighbours than its slice has slots (a count below
// the pairs within h) sets *overflow, which the wrapper reads and raises on:
// a list that drops a pair is never walked.
// Bound: the slots it writes (~4 bytes x 32 per row) and the records
// (16 bytes per row).
// ---------------------------------------------------------------------------

__global__ void nbr_list_fill_kernel(Geom g, const int* __restrict__ off,
                                     int* __restrict__ idx,
                                     float4* __restrict__ rec,
                                     int* __restrict__ overflow) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= g.M) return;
  const int M = g.M;
  const float li = g.liq[i];
  rec[i] = make_float4(g.pos[i], g.pos[M + i], g.pos[2 * M + i], li);
  const int b = off[i >> 5];
  const int n = (off[(i >> 5) + 1] - b) >> 5;
  int* slot = idx + b + (i & 31);
  int k = 0;
  if (li != 0.0f) {
    auto f = [&](int j, float, float, float, float) {
      if (k < n) slot[32 * k] = j;
      ++k;
    };
    for_each_neighbor(g, i, f);
  }
  if (k > n) *overflow = 1;
  for (; k < n; ++k) slot[32 * k] = -1;
}

// ---------------------------------------------------------------------------
// K4: one block-Jacobi PCG iteration of the implicit viscosity.  Replaces
// _build_fused_visc_iter (engine.py:1677), which keeps two global dots in
// SMEM across in-order grid phases.  Here five launches:
//   1. _ViscAcc sweep on d; epilogue ad = d - acc dt rinv_i and a block
//      partial of liq (d . ad);
//   2. d_ad = eps + sum of the partials (one block, fixed order);
//   3. alpha = delta / d_ad on the device; x += alpha d;
//      r = liq (r - alpha ad); s = Minv r; partial of liq (r . s);
//   4. delta' = sum of the partials;
//   5. beta = delta' / delta; d = liq (s + beta d).
// Launch 1 walks the step's neighbour list.  The host reads only delta'
// (the loop condition).
// ---------------------------------------------------------------------------

__global__ void k4_matvec_kernel(Geom g, const float* __restrict__ d,
                                 const float* __restrict__ rinv, float a_liq,
                                 float b_sol, float d0, float dt,
                                 float* __restrict__ ad,
                                 float* __restrict__ partials) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float part = 0.0f;
  if (i < g.M) {
    const int M = g.M;
    const float lq = g.liq[i];
    const float dx = d[i], dy = d[M + i], dz = d[2 * M + i];
    const float ri = rinv[i];
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    if (lq != 0.0f) {
      auto f = [&](int j, float rx, float ry, float rz, float d2,
                   float lj) {
        const float c = visc_coeff(lj, j, d2, rinv, ri, a_liq, b_sol, d0);
        const float dxr = (dx - d[j]) * rx + (dy - d[M + j]) * ry +
                          (dz - d[2 * M + j]) * rz;
        const float cf = c * dxr * kernel_gs(g, d2);
        ax += cf * rx;
        ay += cf * ry;
        az += cf * rz;
      };
      for_each_listed(g, i, f);
    }
    const float sc = dt * ri;
    const float adx = dx - ax * sc, ady = dy - ay * sc, adz = dz - az * sc;
    ad[i] = adx;
    ad[M + i] = ady;
    ad[2 * M + i] = adz;
    part = lq * (dx * adx + dy * ady + dz * adz);
  }
  block_partial(part, partials);
}

__global__ void k4_update_kernel(int M, const float* __restrict__ liq,
                                 float* __restrict__ x, float* __restrict__ r,
                                 const float* __restrict__ d,
                                 const float* __restrict__ ad,
                                 const float* __restrict__ minv,
                                 const float* __restrict__ delta,
                                 const float* __restrict__ scal,
                                 float* __restrict__ s_out,
                                 float* __restrict__ partials) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float part = 0.0f;
  if (i < M) {
    const float alpha = delta[0] / scal[0];
    const float lq = liq[i];
    float rn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c * M + i] += alpha * d[c * M + i];
      rn[c] = lq * (r[c * M + i] - alpha * ad[c * M + i]);
      r[c * M + i] = rn[c];
    }
    const float m0 = minv[i], m1 = minv[M + i], m2 = minv[2 * M + i];
    const float m3 = minv[3 * M + i], m4 = minv[4 * M + i];
    const float m5 = minv[5 * M + i];
    const float s0 = m0 * rn[0] + m1 * rn[1] + m2 * rn[2];
    const float s1 = m1 * rn[0] + m3 * rn[1] + m4 * rn[2];
    const float s2 = m2 * rn[0] + m4 * rn[1] + m5 * rn[2];
    s_out[i] = s0;
    s_out[M + i] = s1;
    s_out[2 * M + i] = s2;
    part = lq * (rn[0] * s0 + rn[1] * s1 + rn[2] * s2);
  }
  block_partial(part, partials);
}

__global__ void k4_direction_kernel(int M, const float* __restrict__ liq,
                                    float* __restrict__ d,
                                    const float* __restrict__ s,
                                    const float* __restrict__ delta,
                                    const float* __restrict__ scal) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= M) return;
  const float beta = scal[1] / delta[0];
  const float lq = liq[i];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    d[c * M + i] = lq * (s[c * M + i] + beta * d[c * M + i]);
}

// ---------------------------------------------------------------------------
// Plain C entry points (bound with ctypes by engine.py).  Each returns the
// first cudaError_t of its launches (0 = all launched).
// ---------------------------------------------------------------------------

extern "C" int k1_density_alpha_drho(const Geom* g, const float* vel,
                                     float* out, void* stream) {
  k1_density_kernel<<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
      *g, vel, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k1_div_acc(const Geom* g, const float* vel, float* out,
                          void* stream) {
  k1_div_kernel<<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
      *g, vel, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k1_visc_init(const Geom* g, const float* x, const float* rinv,
                            float a_liq, float b_sol, float d0, float* out,
                            void* stream) {
  k1_visc_init_kernel<<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
      *g, x, rinv, a_liq, b_sol, d0, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k1_vorticity(const Geom* g, const float* vel, const float* om,
                            const float* rinv, float m, float rho0vs,
                            float rho0vl, float* out, void* stream) {
  k1_vorticity_kernel<<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
      *g, vel, om, rinv, m, rho0vs, rho0vl, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k2_fused_kappa_drho(const Geom* g, float* vel, const float* kf,
                                   const float* gate, float* acc,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = blocks_of(g->M);
  k2_kappa_kernel<<<nb, kBlock, 0, st>>>(*g, vel, kf, gate);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k1_div_kernel<<<nb, kBlock, 0, st>>>(*g, vel, acc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k3_fused_iter_full(const Geom* g, float* vel, float* kv,
                                  float* s, const float* a, const float* paux,
                                  float dt, int mode, float* partials,
                                  float* err, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = blocks_of(g->M);
  const float bias = -static_cast<float>(mode);
  k3_kappa_kernel<<<nb, kBlock, 0, st>>>(*g, vel, kv, s, a, dt, bias);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k3_div_kernel<<<nb, kBlock, 0, st>>>(*g, vel, s, paux, dt, mode, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<<<1, kReduceBlock, 0, st>>>(partials, nb, 0.0f, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbr_list_fill(const Geom* g, const int* off, int* idx,
                             float* rec, int* overflow, void* stream) {
  nbr_list_fill_kernel<<<blocks_of(g->M), kBlock, 0, (cudaStream_t)stream>>>(
      *g, off, idx, reinterpret_cast<float4*>(rec), overflow);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k4_fused_visc_iter(const Geom* g, float* x, float* r, float* d,
                                  const float* rinv, const float* minv6,
                                  const float* delta, float dt, float eps,
                                  float a_liq, float b_sol, float d0,
                                  float* ad, float* s, float* partials,
                                  float* scal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = blocks_of(g->M);
  k4_matvec_kernel<<<nb, kBlock, 0, st>>>(*g, d, rinv, a_liq, b_sol, d0, dt,
                                          ad, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<<<1, kReduceBlock, 0, st>>>(partials, nb, eps, scal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k4_update_kernel<<<nb, kBlock, 0, st>>>(g->M, g->liq, x, r, d, ad, minv6,
                                          delta, scal, s, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<<<1, kReduceBlock, 0, st>>>(partials, nb, 0.0f,
                                                     scal + 1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k4_direction_kernel<<<nb, kBlock, 0, st>>>(g->M, g->liq, d, s, delta, scal);
  return static_cast<int>(cudaGetLastError());
}
