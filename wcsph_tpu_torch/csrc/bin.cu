// Hand-written Hopper (sm_90a) kernels of the step's grid stage: the bin
// (rows sorted by cell, with per-cell start offsets), the pack and unpack of
// the per-particle fields, and the slice offsets of the step's neighbour
// list.  Nothing in this file reads the device's results back to the host:
// from the positions to a filled list the stage only enqueues launches.
//
// No Pallas kernel corresponds to these.  The JAX package runs its bin,
// pack and unpack in XLA: argsort of the cell ids and rank within each run
// (wcsph_tpu/grid.py:75-122, wcsph_tpu/resident.py:121-186 build_prep and
// grid_from_prep), one stacked gather to pack (pack_many_padded, 194) and
// one to unpack (unpack_many_direct, 274).  Here:
//
//   * bin_cells is a counting sort by cell.  One pass computes each
//     particle's cell exactly as cell_of_positions does, floor((x - dmin) *
//     float32(1 / cell size)), and takes a slot in its cell from an atomic
//     histogram; a scan of the histogram gives the cell offsets; a scatter
//     places each particle at its cell's offset plus its slot; then each
//     cell's few rows are put in particle order by an insertion sort, so the
//     permutation is the stable sort's whatever order the atomics took.
//     Particles outside the domain take the rows after the last cell, in
//     particle order (a scan of their flags ranks them), and are inert: in
//     no cell's range, liquid flag 0, and a cell id whose 27-cell window
//     lies wholly outside the grid (the cell loops of common.cuh find no
//     candidate for them).
//   * pack_rows and unpack_rows move every field of a step in one launch
//     each: pack reads each row's particle (order), unpack each particle's
//     row (row_of, -1 outside the domain, where the default is kept).
//   * nbr_list_offsets turns the density sweep's counts into the sliced-ELL
//     offsets of grid.NeighborList (one warp max per slice, then the scan),
//     clamped to the capacity of the slot buffer that the step keeps from
//     step to step, and writes the slots needed (unclamped) to a device
//     scalar that the step reads with its first existing host read.
//
// One scan serves the cell offsets, the outside ranks and the slice
// offsets: three launches, a per-block sum over contiguous chunks, one block
// that scans those sums (in 64-bit), and a per-block scan of each chunk from
// its block's prefix.
//
// What bounds them on the H100: bytes, and at 1M rows the launches.  The
// bin moves ~45 bytes per particle once, but its scatter, sort and gathers
// are scattered accesses and it runs ten launches; pack and unpack move 4
// bytes per field and row plus the indices.
//
// A launch returns cudaGetLastError().

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

constexpr int kThreads = 256;      // threads of the row kernels
constexpr int kScanThreads = 1024; // threads of the scan kernels (32 warps)
constexpr int kScanBlocks = 1024;  // most blocks of a scan's chunked passes
                                   // (engine.SCAN_PARTIALS - 1)
constexpr int kMaxFields = 16;     // field rows a pack or unpack moves

static inline int blocks(long long n) {
  return n > 0 ? static_cast<int>((n + kThreads - 1) / kThreads) : 1;
}

// ---------------------------------------------------------------------------
// The scan: out[k] = min(sum of in[0 .. k), clamp) for k = 0 .. n, and
// *total = the unclamped sum of all n inputs.
// ---------------------------------------------------------------------------

// Inclusive scan of v over the kScanThreads threads of a block, in 64 bits;
// *total gets the block's sum.  Every thread of the block must call it.
__device__ long long block_inclusive_scan(long long v, long long* total) {
  __shared__ long long warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[kScanThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

// partials[b] = the sum of block b's chunk.
__global__ void scan_reduce_kernel(const int* __restrict__ in, int n,
                                   int chunk,
                                   long long* __restrict__ partials) {
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, n);
  long long s = 0;
  for (int k = lo + threadIdx.x; k < hi; k += kScanThreads) s += in[k];
  long long sum;
  block_inclusive_scan(s, &sum);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// partials[0 .. nb) -> their exclusive prefix sums; *total = their sum.
__global__ void scan_partials_kernel(long long* __restrict__ partials, int nb,
                                     long long* __restrict__ total) {
  const long long v = threadIdx.x < nb ? partials[threadIdx.x] : 0;
  long long sum;
  const long long incl = block_inclusive_scan(v, &sum);
  if (threadIdx.x < nb) partials[threadIdx.x] = incl - v;
  if (threadIdx.x == 0) *total = sum;
}

// Each block scans its chunk tile by tile, from its prefix.
__global__ void scan_apply_kernel(const int* __restrict__ in, int n,
                                  int chunk,
                                  const long long* __restrict__ partials,
                                  const long long* __restrict__ total,
                                  int clamp, int* __restrict__ out) {
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, n);
  long long carry = partials[blockIdx.x];
  for (int t = lo; t < hi; t += kScanThreads) {
    const int k = t + threadIdx.x;
    const long long v = k < hi ? in[k] : 0;
    long long sum;
    const long long incl = block_inclusive_scan(v, &sum);
    if (k < hi) {
      out[k] = static_cast<int>(min(carry + incl - v,
                                    static_cast<long long>(clamp)));
    }
    carry += sum;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[n] = static_cast<int>(min(*total, static_cast<long long>(clamp)));
  }
}

// partials: kScanBlocks int64 of scratch.
static void scan(const int* in, int n, int clamp, int* out,
                 long long* partials, long long* total, cudaStream_t st) {
  const int nb = n > 0 ? std::min(kScanBlocks, (n + kScanThreads - 1) /
                                                   kScanThreads)
                       : 1;
  const int chunk = n > 0 ? (n + nb - 1) / nb : 0;
  scan_reduce_kernel<<<nb, kScanThreads, 0, st>>>(in, n, chunk, partials);
  scan_partials_kernel<<<1, kScanThreads, 0, st>>>(partials, nb, total);
  scan_apply_kernel<<<nb, kScanThreads, 0, st>>>(in, n, chunk, partials,
                                                 total, clamp, out);
}

// ---------------------------------------------------------------------------
// The bin
// ---------------------------------------------------------------------------

// Cell key of each particle (nc outside the domain), its slot in its cell,
// its outside flag, and the count of liquid particles inside the domain.
__global__ void bin_count_kernel(const float* __restrict__ pos, int n,
                                 int n_liquid, float dx, float dy, float dz,
                                 float inv, int gx, int gy, int gz,
                                 int* __restrict__ key, int* __restrict__ slot,
                                 int* __restrict__ hist,
                                 int* __restrict__ outside,
                                 int* __restrict__ n_liq) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  bool counted = false;
  if (p < n) {
    // float compares: a NaN or infinite position falls outside
    const float fx = floorf((pos[p] - dx) * inv);
    const float fy = floorf((pos[n + p] - dy) * inv);
    const float fz = floorf((pos[2 * n + p] - dz) * inv);
    const bool in = fx >= 0.0f && fx < static_cast<float>(gx) &&
                    fy >= 0.0f && fy < static_cast<float>(gy) &&
                    fz >= 0.0f && fz < static_cast<float>(gz);
    const int k = in ? (static_cast<int>(fx) * gy + static_cast<int>(fy)) *
                               gz +
                           static_cast<int>(fz)
                     : gx * gy * gz;
    key[p] = k;
    slot[p] = in ? atomicAdd(hist + k, 1) : 0;
    outside[p] = in ? 0 : 1;
    counted = in && p < n_liquid;
  }
  const unsigned votes = __ballot_sync(0xffffffffu, counted);
  if ((threadIdx.x & 31) == 0 && votes != 0u) atomicAdd(n_liq, __popc(votes));
}

// tmp[row] = particle: a cell's particles from its offset in slot order,
// the outside ones after the last cell in particle order.
__global__ void bin_scatter_kernel(int n, int nc, const int* __restrict__ key,
                                   const int* __restrict__ slot,
                                   const int* __restrict__ start,
                                   const int* __restrict__ orank,
                                   int* __restrict__ tmp) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int k = key[p];
  tmp[k < nc ? start[k] + slot[p] : start[nc] + orank[p]] = p;
}

// Each cell's rows in particle order (insertion sort: ~8 rows a cell of
// liquid at rest).
__global__ void bin_sort_kernel(int nc, const int* __restrict__ start,
                                int* __restrict__ tmp) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= nc) return;
  const int b = start[c];
  const int e = start[c + 1];
  for (int a = b + 1; a < e; ++a) {
    const int v = tmp[a];
    int k = a - 1;
    while (k >= b && tmp[k] > v) {
      tmp[k + 1] = tmp[k];
      --k;
    }
    tmp[k + 1] = v;
  }
}

// The grid's row arrays from the permutation.
__global__ void bin_rows_kernel(const float* __restrict__ pos, int n,
                                int n_liquid, int nc, int outside_cell,
                                const int* __restrict__ key,
                                const int* __restrict__ tmp,
                                long long* __restrict__ order,
                                int* __restrict__ row_of,
                                int* __restrict__ cell,
                                float* __restrict__ pos_out,
                                unsigned char* __restrict__ liquid,
                                float* __restrict__ liq) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const int p = tmp[r];
  const int k = key[p];
  const bool in = k < nc;
  const bool l = in && p < n_liquid;
  order[r] = p;
  row_of[p] = in ? r : -1;
  cell[r] = in ? k : outside_cell;
  pos_out[r] = pos[p];
  pos_out[n + r] = pos[n + p];
  pos_out[2 * n + r] = pos[2 * n + p];
  liquid[r] = l ? 1 : 0;
  liq[r] = l ? 1.0f : 0.0f;
}

// scratch: 5 n + 1 + nc int32; partials: kScanBlocks + 1 int64.
extern "C" int bin_cells(const float* pos, int n, int n_liquid, float dx,
                         float dy, float dz, float inv, int gx, int gy,
                         int gz, int outside_cell, int* scratch,
                         long long* partials, long long* order, int* row_of,
                         int* cell, int* start, float* pos_out,
                         unsigned char* liquid, float* liq, int* n_liq,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = gx * gy * gz;
  int* key = scratch;
  int* slot = key + n;
  int* outside = slot + n;
  int* orank = outside + n;  // n + 1
  int* tmp = orank + n + 1;
  int* hist = tmp + n;       // nc
  long long* total = partials + kScanBlocks;
  cudaMemsetAsync(hist, 0, sizeof(int) * static_cast<size_t>(nc), st);
  cudaMemsetAsync(n_liq, 0, sizeof(int), st);
  bin_count_kernel<<<blocks(n), kThreads, 0, st>>>(
      pos, n, n_liquid, dx, dy, dz, inv, gx, gy, gz, key, slot, hist,
      outside, n_liq);
  scan(hist, nc, INT_MAX, start, partials, total, st);
  scan(outside, n, INT_MAX, orank, partials, total, st);
  bin_scatter_kernel<<<blocks(n), kThreads, 0, st>>>(n, nc, key, slot, start,
                                                     orank, tmp);
  bin_sort_kernel<<<blocks(nc), kThreads, 0, st>>>(nc, start, tmp);
  bin_rows_kernel<<<blocks(n), kThreads, 0, st>>>(
      pos, n, n_liquid, nc, outside_cell, key, tmp, order, row_of, cell,
      pos_out, liquid, liq);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Pack and unpack: every field row of a step in one launch
// ---------------------------------------------------------------------------

// Mirror: engine._Fields.  Field row k: src[k] -> dst[k]; unpack keeps
// dflt[k] for particles outside the domain.
struct Fields {
  const float* src[kMaxFields];
  float* dst[kMaxFields];
  const float* dflt[kMaxFields];
  int k;
};

// Per-liquid (nl,) rows -> sorted (n,) rows; rows holding no liquid take 0.
__global__ void pack_rows_kernel(Fields f, int n,
                                 const long long* __restrict__ order,
                                 const float* __restrict__ liq) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const bool l = liq[r] != 0.0f;
  const long long p = l ? order[r] : 0;
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {
    if (k < f.k) f.dst[k][r] = l ? __ldg(f.src[k] + p) : 0.0f;
  }
}

// Sorted (n,) rows -> per-liquid (nl,) rows; a liquid particle outside the
// domain (row -1) keeps its default.
__global__ void unpack_rows_kernel(Fields f, int nl,
                                   const int* __restrict__ row_of) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= nl) return;
  const int r = row_of[p];
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {
    if (k < f.k) {
      f.dst[k][p] = r >= 0 ? __ldg(f.src[k] + r) : __ldg(f.dflt[k] + p);
    }
  }
}

extern "C" int pack_rows(const Fields* f, int n, const long long* order,
                         const float* liq, void* stream) {
  pack_rows_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      *f, n, order, liq);
  return cudaGetLastError();
}

extern "C" int unpack_rows(const Fields* f, int nl, const int* row_of,
                           void* stream) {
  unpack_rows_kernel<<<blocks(nl), kThreads, 0, (cudaStream_t)stream>>>(
      *f, nl, row_of);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The neighbour list's slice offsets
// ---------------------------------------------------------------------------

// width[s] = 32 x the largest count among slice s's liquid rows.
__global__ void slice_width_kernel(const int* __restrict__ count,
                                   const float* __restrict__ liq, int m,
                                   int s, int* __restrict__ width) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int c = (i < m && liq[i] != 0.0f) ? count[i] : 0;
  const int w = __reduce_max_sync(0xffffffffu, c);
  if ((i & 31) == 0 && (i >> 5) < s) width[i >> 5] = 32 * w;
}

// off (s + 1,) = the exclusive scan of the widths, clamped to the slot
// buffer's capacity; *need = the slots the list needs.  width: s int32 of
// scratch; partials: kScanBlocks int64.
extern "C" int nbr_list_offsets(const int* count, const float* liq, int m,
                                int capacity, int* width, int* off,
                                long long* need, long long* partials,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int s = (m + 31) / 32;
  slice_width_kernel<<<blocks(32LL * s), kThreads, 0, st>>>(count, liq, m, s,
                                                           width);
  scan(width, s, capacity, off, partials, need, st);
  return cudaGetLastError();
}
