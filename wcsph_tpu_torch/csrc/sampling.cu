// Hand-written Hopper (sm_90a) kernel of the Poisson-disk boundary
// sampler: one phase step (poisson_phase).
//
// No Pallas kernel corresponds to it.  The JAX package runs the step in
// XLA (_phase_step, wcsph_tpu/sampling.py:117): dense (3, sample_cap, NC)
// candidate tables and, for each of the 125 offsets of the 5^3 window, a
// flat-index shifted copy of the (3, accept_cap, NC) accepted arrays, with
// the test evaluated for every cell of the chunk.  Here:
//
//   * the chunk's own candidates are sorted by cell (stable: rank in a cell
//     is by candidate index) with per-cell start offsets, built by the
//     wrapper's caller (sampling.py) with torch ops; the candidate a phase
//     step tries in cell c is order[start[c] + trial];
//   * one thread per cell of the phase's colour, (cx % 3) + 3 (cy % 3) +
//     9 ((cz + z0) % 3) == phase: the sub-lattice of every third cell on
//     each axis, ~NC / 27 threads; a cell with no trial-th candidate or
//     no free slot returns at once;
//   * the thread reads the points accepted in its in-box 5^3 window by
//     3-D cell coordinates, the slots below each cell's count, and stops
//     at the first one within r (the test is an OR: the order of the
//     window does not change the result); else it accepts its candidate
//     into slot acc_cnt of its own cell.  Cells of one colour are at least
//     3 cells apart on some axis and the window reaches 2, so no thread
//     reads a cell another thread of the launch writes;
//   * the distance test is the reference's, one float32 operation at a
//     time (the library is built with -fmad=false): d^2 summed x, y, z and
//     floored at 1e-18, the direction, the two normals' cosines clipped to
//     [-1, 1], the arcsin quotient where |c1 - c2| > 1e-5, else
//     1 / sqrt(max(1 - c1^2, 1e-6)), the same-face bypass, the strict
//     < r.  arcsin is asin_f32: XLA's decomposition with fdlibm's atan2f,
//     the sequence of dense_ops.asin_f32, so that kernel, twin and the
//     JAX package on the CPU give the same bits.
//
// Bound: one launch moves little (the phase's start offsets, the tried
// candidates, the window's accepted points); the launches are many (27 a
// trial, 270 a chunk at the defaults) and each waits for the one before
// it, so launch latency and the longest window walk bound a step.
//
// A launch returns cudaGetLastError().

#include <cuda_runtime.h>

constexpr int kSampleThreads = 256;

// Mirror: engine._PhaseChunk (same field order).
struct PhaseChunk {
  const float* pts;   // (3, N) candidate positions
  const float* nrm;   // (3, N) their face normals
  const int* fid;     // (N,) their face ids
  int n;              // N, the stride of a component of pts and nrm
  const int* order;   // (N,) candidates by cell
  const int* start;   // (NC + 1,) first sorted candidate of each cell
  int gx, gy, gz, z0;
  float r;
  int cap;            // accept_cap: slots a cell
  float* acc_p;       // (3, cap, NC)
  float* acc_n;       // (3, cap, NC)
  int* acc_f;         // (cap, NC), -1 in a free slot
  int* acc_cnt;       // (NC,)
};

// fdlibm's float atanf constants: atan(0.5) and atan(1) split hi + lo, and
// the odd and even polynomial coefficients.
__constant__ float kAtanHi[2] = {4.6364760399e-01f, 7.8539812565e-01f};
__constant__ float kAtanLo[2] = {5.0121582440e-09f, 3.7748947079e-08f};
__constant__ float kAtanT[11] = {
    3.3333334327e-01f, -2.0000000298e-01f, 1.4285714924e-01f,
    -1.1111110449e-01f, 9.0908870101e-02f, -7.6918758452e-02f,
    6.6610731184e-02f, -5.8335702866e-02f, 4.9768779427e-02f,
    -3.6531571299e-02f, 1.6285819933e-02f};

// arcsin of x in [-1, 1] as XLA forms it on the CPU, 2 atan2(x, 1 +
// sqrt((1 - x)(1 + x))), with fdlibm's atan2f of a quotient in [0, 1]
// (dense_ops.asin_f32 is the same sequence).
__device__ float asin_f32(float x) {
  const float den = sqrtf((1.0f - x) * (1.0f + x)) + 1.0f;
  const float a = fabsf(x) / den;
  float t;
  int id;
  if (a < 0.4375f) {
    t = a;
    id = -1;
  } else if (a < 0.6875f) {
    t = (2.0f * a - 1.0f) / (2.0f + a);
    id = 0;
  } else {
    t = (a - 1.0f) / (a + 1.0f);
    id = 1;
  }
  const float z = t * t;
  const float w = z * z;
  const float s1 = z * (kAtanT[0] + w * (kAtanT[2] + w * (kAtanT[4] + w * (
      kAtanT[6] + w * (kAtanT[8] + w * kAtanT[10])))));
  const float s2 = w * (kAtanT[1] + w * (kAtanT[3] + w * (kAtanT[5] + w * (
      kAtanT[7] + w * kAtanT[9]))));
  float r = id < 0 ? t - t * (s1 + s2)
                   : kAtanHi[id] - ((t * (s1 + s2) - kAtanLo[id]) - t);
  if (x < 0.0f) r = -r;
  if (x == 0.0f) r = x;
  return r + r;
}

__global__ void __launch_bounds__(kSampleThreads)
    poisson_phase_kernel(PhaseChunk c, int px, int py, int pz, int ny3,
                         int nz3, int count, int trial) {
  const int t = blockIdx.x * kSampleThreads + threadIdx.x;
  if (t >= count) return;
  const int cx = px + 3 * (t / (ny3 * nz3));
  const int cy = py + 3 * ((t / nz3) % ny3);
  const int cz = pz + 3 * (t % nz3);
  const int nc = c.gx * c.gy * c.gz;
  const int cell = (cx * c.gy + cy) * c.gz + cz;
  const int s = c.start[cell] + trial;
  if (s >= c.start[cell + 1]) return;
  const int cnt = c.acc_cnt[cell];
  if (cnt >= c.cap) return;
  const int q = c.order[s];
  const int n = c.n;
  const float qx = c.pts[q], qy = c.pts[n + q], qz = c.pts[2 * n + q];
  const float mx = c.nrm[q], my = c.nrm[n + q], mz = c.nrm[2 * n + q];
  const int qf = c.fid[q];
  const int plane = c.cap * nc;   // one component of acc_p / acc_n
  for (int dx = -2; dx <= 2; ++dx) {
    const int nx = cx + dx;
    if (nx < 0 || nx >= c.gx) continue;
    for (int dy = -2; dy <= 2; ++dy) {
      const int ny = cy + dy;
      if (ny < 0 || ny >= c.gy) continue;
      for (int dz = -2; dz <= 2; ++dz) {
        const int nz = cz + dz;
        if (nz < 0 || nz >= c.gz) continue;
        const int nb = (nx * c.gy + ny) * c.gz + nz;
        const int m = c.acc_cnt[nb];
        for (int a = 0; a < m; ++a) {
          const int k = a * nc + nb;
          const float ddx = qx - c.acc_p[k];
          const float ddy = qy - c.acc_p[plane + k];
          const float ddz = qz - c.acc_p[2 * plane + k];
          const float dist =
              sqrtf(fmaxf(ddx * ddx + ddy * ddy + ddz * ddz, 1e-18f));
          float gdist = dist;
          if (c.acc_f[k] != qf) {
            const float vx = ddx / dist, vy = ddy / dist, vz = ddz / dist;
            float c1 = mx * vx + my * vy + mz * vz;
            float c2 = c.acc_n[k] * vx + c.acc_n[plane + k] * vy
                       + c.acc_n[2 * plane + k] * vz;
            c1 = fminf(fmaxf(c1, -1.0f), 1.0f);
            c2 = fminf(fmaxf(c2, -1.0f), 1.0f);
            const float corr =
                fabsf(c1 - c2) > 1e-5f
                    ? (asin_f32(c1) - asin_f32(c2)) / (c1 - c2)
                    : 1.0f / sqrtf(fmaxf(1.0f - c1 * c1, 1e-6f));
            gdist = dist * corr;
          }
          if (gdist < c.r) return;   // a conflict: the candidate is refused
        }
      }
    }
  }
  const int k = cnt * nc + cell;
  c.acc_p[k] = qx;
  c.acc_p[plane + k] = qy;
  c.acc_p[2 * plane + k] = qz;
  c.acc_n[k] = mx;
  c.acc_n[plane + k] = my;
  c.acc_n[2 * plane + k] = mz;
  c.acc_f[k] = qf;
  c.acc_cnt[cell] = cnt + 1;
}

// One phase step: the cells of colour `phase` try their `trial`-th
// candidate.  The colour's cells are cx = px + 3 i, cy = py + 3 j, cz =
// pz + 3 k with pz = (phase / 9 - z0) mod 3, non-negative (z0 may be).
extern "C" int poisson_phase(const PhaseChunk* c, int phase, int trial,
                             void* stream) {
  const int px = phase % 3, py = (phase / 3) % 3;
  const int pz = (((phase / 9 - c->z0) % 3) + 3) % 3;
  const int nx3 = (c->gx - px + 2) / 3;
  const int ny3 = (c->gy - py + 2) / 3;
  const int nz3 = (c->gz - pz + 2) / 3;
  const int count = nx3 * ny3 * nz3;
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (count + kSampleThreads - 1) / kSampleThreads;
  poisson_phase_kernel<<<blocks, kSampleThreads, 0, (cudaStream_t)stream>>>(
      *c, px, py, pz, ny3, nz3, count, trial);
  return static_cast<int>(cudaGetLastError());
}
