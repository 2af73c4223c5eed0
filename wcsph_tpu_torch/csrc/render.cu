// Hand-written Hopper (sm_90a) kernels of the point rasterizer: the
// z-buffered splat of particles as disks (splat_points).
//
// No Pallas kernel corresponds to it.  The JAX package rasterizes in XLA
// (_rasterize, wcsph_tpu/render.py:111): the (S, N) stencil pixels of
// every point, then one scatter-min per colour channel of a packed
// (depth, colour) key into a (H W, 3) uint32 image.  Here, three launches
// on one stream:
//
//   * fill: the key image (H W 3 uint32, the wrapper's scratch) to
//     0xFFFFFFFF;
//   * splat: one thread per point: clip = pv (x, y, z, 1), each row
//     fma(p2, z, fma(p1, y, p0 x)) + p3, the order of XLA's dot on the CPU
//     (the plain twin emulates the fused multiply-adds), NDC, the screen
//     position rounded half to even (rintf, jnp.round's rule), clamped to
//     +-2^20 before the int conversion; a point with NDC z outside [0, 1]
//     draws nothing; else it loops over its disk stencil (i^2 + j^2 <=
//     radius^2 and <= its own radius^2) and, per in-frame pixel and channel,
//     atomicMin of the key (uint32(z 4.19e6) << 8) | (255 - c): the nearest
//     point wins each channel, at equal depth the brightest, as the
//     reference's per-channel scatter-min (so one pixel's channels may come
//     from different points at equal depth, as there);
//   * resolve: one thread per pixel channel: (255 - (key & 0xFF)) times
//     float32(1 / 255), as XLA forms the division by 255, or
//     the background where the key is still 0xFFFFFFFF, into the (H, W, 3)
//     float image.
//
// Bound: the bytes of the points, colours and radii read once and the
// image written once; the atomics on pixels that many points cover (a
// dense block seen edge-on) serialise, which the bound does not count.
//
// A launch returns cudaGetLastError().

#include <cuda_runtime.h>

constexpr int kSplatThreads = 256;
constexpr int kPv = 16;                     // proj @ view, 4x4
constexpr float kPixelClamp = 1048576.0f;   // dense_ops.PIXEL_CLAMP
// float32(1 / 255) (dense_ops.INV_255): XLA turns the reference's division
// by 255 into a product with it
constexpr float kInv255 = 3.921568859e-03f;

// Mirror: engine._Splat (same field order).
struct Splat {
  const float* pts;    // (3, N) positions
  const float* col;    // (3, N) colours in [0, 1]
  const int* radii;    // (N,) disk radius of each point, in pixels
  int n;
  float pv[kPv];       // proj @ view, row-major
  int width, height, radius;   // radius: the stencil's, radius_px
  float background;
  unsigned* keys;      // (H W 3,) scratch
  float* out;          // (H, W, 3)
};

__global__ void splat_fill_kernel(unsigned* keys, int count) {
  const int i = blockIdx.x * kSplatThreads + threadIdx.x;
  if (i < count) keys[i] = 0xFFFFFFFFu;
}

__global__ void __launch_bounds__(kSplatThreads)
    splat_kernel(const Splat s) {
  const int i = blockIdx.x * kSplatThreads + threadIdx.x;
  if (i >= s.n) return;
  const float x = s.pts[i], y = s.pts[s.n + i], z = s.pts[2 * s.n + i];
  float clip[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    clip[r] = fmaf(s.pv[4 * r + 2], z,
                   fmaf(s.pv[4 * r + 1], y, s.pv[4 * r] * x))
              + s.pv[4 * r + 3];
  }
  const float zn = clip[2] / clip[3];
  if (!(zn >= 0.0f && zn <= 1.0f)) return;
  const float sx = (clip[0] / clip[3] + 1.0f) * 0.5f * (float)s.width;
  const float sy = (clip[1] / clip[3] + 1.0f) * 0.5f * (float)s.height;
  const int cx = (int)fminf(fmaxf(rintf(sx), -kPixelClamp), kPixelClamp);
  const int cy = (int)fminf(fmaxf(rintf(sy), -kPixelClamp), kPixelClamp);
  const unsigned zbits = ((unsigned)(zn * 4.19e6f)) << 8;
  unsigned key[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = fminf(fmaxf(s.col[c * s.n + i] * 255.0f, 0.0f), 255.0f);
    key[c] = zbits | (255u - (unsigned)v);
  }
  const int own = s.radii[i];
  const long long own2 = (long long)own * own;
  const int rad = s.radius;
  for (int a = -rad; a <= rad; ++a) {
    const int px = cx + a;
    if (px < 0 || px >= s.width) continue;
    for (int b = -rad; b <= rad; ++b) {
      const int py = cy + b;
      const int r2 = a * a + b * b;
      if (py < 0 || py >= s.height || r2 > rad * rad || r2 > own2) continue;
      unsigned* dst = s.keys + 3 * (py * s.width + px);
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicMin(dst + c, key[c]);
    }
  }
}

__global__ void splat_resolve_kernel(const unsigned* keys, int count,
                                     float background, float* out) {
  const int i = blockIdx.x * kSplatThreads + threadIdx.x;
  if (i >= count) return;
  const unsigned k = keys[i];
  out[i] = k == 0xFFFFFFFFu ? background
                            : (float)(255u - (k & 0xFFu)) * kInv255;
}

extern "C" int splat_points(const Splat* s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int count = 3 * s->width * s->height;
  const int blocks = (count + kSplatThreads - 1) / kSplatThreads;
  splat_fill_kernel<<<blocks, kSplatThreads, 0, st>>>(s->keys, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s->n > 0) {
    splat_kernel<<<(s->n + kSplatThreads - 1) / kSplatThreads, kSplatThreads,
                   0, st>>>(*s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  splat_resolve_kernel<<<blocks, kSplatThreads, 0, st>>>(s->keys, count,
                                                         s->background,
                                                         s->out);
  return static_cast<int>(cudaGetLastError());
}
