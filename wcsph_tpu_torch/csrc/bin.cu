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
//     each: pack reads each row's particle (order) where the row's one-byte
//     liquid flag is set and writes row k of its fields at dst + k n, one
//     block the wrapper allocates; unpack reads each particle's row
//     (row_of, -1 outside the domain, where the default is kept).
//   * nbr_list_offsets turns the density sweep's counts into the sliced-ELL
//     offsets of grid.NeighborList, clamped to the capacity of the slot
//     buffer that the step keeps from step to step, and writes the slots
//     needed (unclamped) to a device scalar that the step reads with its
//     first existing host read.  One cooperative launch: each block takes a
//     contiguous tile of slices (one warp max per slice) and writes its
//     tile's sum; after one grid-wide sync every block scans the few hundred
//     tile sums itself and then its own tile from its prefix.  No status
//     word, so nothing to reset between calls.
//
// One three-launch scan serves the cell offsets and the outside ranks of
// the bin: a per-block sum over contiguous chunks, one block that scans
// those sums (in 64-bit), and a per-block scan of each chunk from its
// block's prefix.
//
// What bounds them on the H100: bytes, and at 1M rows the launches.  The
// bin moves ~45 bytes per particle once, but its scatter, sort and gathers
// are scattered accesses and it runs ten launches; pack and unpack move 4
// bytes per field and row plus the indices; the offsets read 5 bytes a row
// and are bound by their one launch and grid sync (a few microseconds).
//
// A launch returns cudaGetLastError().

#include <algorithm>
#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

constexpr int kThreads = 256;      // threads of the row kernels
constexpr int kScanThreads = 1024; // threads of the scan kernels (32 warps)
constexpr int kScanBlocks = 1024;  // most blocks of a scan's chunked passes
                                   // (engine.SCAN_PARTIALS - 1)
constexpr int kMaxFields = 16;     // field rows a pack or unpack moves
constexpr int kPackSources = 5;    // fields one pack takes, DFSPH's five
                                   // (engine.PACK_SOURCES)
constexpr int kMaxTiles = kScanThreads;  // most blocks of the offsets' one
                                         // grid (grid.OFFSET_TILES)

static inline int blocks(long long n) {
  return n > 0 ? static_cast<int>((n + kThreads - 1) / kThreads) : 1;
}

// ---------------------------------------------------------------------------
// The bin's scan: out[k] = min(sum of in[0 .. k), clamp) for k = 0 .. n,
// and *total = the unclamped sum of all n inputs.
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

// Mirror: engine._Fields (the unpack's).  Field row k: src[k] -> dst[k];
// unpack keeps dflt[k] for particles outside the domain.
struct Fields {
  const float* src[kMaxFields];
  float* dst[kMaxFields];
  const float* dflt[kMaxFields];
  int k;
};

// The pack's source rows, from the field bases the entry is given.
struct PackRows {
  const float* src[kMaxFields];
};

// Per-liquid (nl,) rows -> sorted rows k n .. k n + n - 1 of dst; rows
// holding no liquid take 0.  The flag and the particle are loaded side by
// side, then every field's gather before any store: a store may alias a
// source for the compiler, which would otherwise wait out each gather's
// latency before the next one issues.
__global__ void pack_rows_kernel(PackRows f, int k, int n,
                                 const long long* __restrict__ order,
                                 const unsigned char* __restrict__ liquid,
                                 float* __restrict__ dst) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const bool l = liquid[r] != 0;
  const long long o = order[r];
  const long long p = l ? o : 0;   // a boundary particle has no field row
  float v[kMaxFields];
#pragma unroll
  for (int j = 0; j < kMaxFields; ++j) {
    v[j] = (j < k && l) ? __ldg(f.src[j] + p) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kMaxFields; ++j) {
    if (j < k) dst[static_cast<size_t>(j) * n + r] = v[j];
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

// Field a (a < kPackSources) is rows[a] contiguous (nl,) rows from src[a]
// (null and 0 past the last field); dst: (total rows, n), row k at k n.
extern "C" int pack_rows(int n, int nl, const long long* order,
                         const unsigned char* liquid, float* dst,
                         const float* s0, int k0, const float* s1, int k1,
                         const float* s2, int k2, const float* s3, int k3,
                         const float* s4, int k4, void* stream) {
  const float* const src[kPackSources] = {s0, s1, s2, s3, s4};
  const int rows[kPackSources] = {k0, k1, k2, k3, k4};
  PackRows f{};
  int k = 0;
  for (int a = 0; a < kPackSources; ++a) {
    for (int c = 0; c < rows[a]; ++c) {
      if (k == kMaxFields) return cudaErrorInvalidValue;
      f.src[k++] = src[a] + static_cast<size_t>(c) * nl;
    }
  }
  pack_rows_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, k, n, order, liquid, dst);
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

// One launch of at most one resident grid (cooperative): block b takes
// slices [b tile, b tile + tile).  Phase 1: each warp takes a slice at a
// time, its width (32 x the largest count among its liquid rows) goes to
// off[slice] and into the block's tile sum, tiles[b].  One grid-wide sync.
// Phase 2: every block scans the tile sums (gridDim.x <= kMaxTiles, one a
// thread) for its prefix and the total, then scans its own tile's widths in
// place from that prefix, clamped to capacity; block 0 writes off[s] and
// need.
__global__ void __launch_bounds__(kScanThreads)
    nbr_list_offsets_kernel(const int* __restrict__ count,
                            const unsigned char* __restrict__ liquid, int m,
                            int s, int tile, int capacity,
                            int* __restrict__ off,
                            long long* __restrict__ need,
                            long long* __restrict__ tiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lo = min(static_cast<int>(blockIdx.x) * tile, s);
  const int hi = min(lo + tile, s);
  long long part = 0;
  for (int k = lo + warp; k < hi; k += kScanThreads / 32) {
    const int i = 32 * k + lane;
    int c = 0;
    if (i < m) {   // both loads issue before either is used
      const int n = count[i];
      c = liquid[i] != 0 ? n : 0;
    }
    const int w = __reduce_max_sync(0xffffffffu, c);
    if (lane == 0) {
      off[k] = 32 * w;
      part += 32LL * w;
    }
  }
  long long sum;
  block_inclusive_scan(part, &sum);
  if (threadIdx.x == 0) tiles[blockIdx.x] = sum;
  cooperative_groups::this_grid().sync();

  __shared__ long long prefix;
  const long long t = threadIdx.x < gridDim.x ? __ldcg(tiles + threadIdx.x)
                                              : 0;
  long long total;
  const long long incl = block_inclusive_scan(t, &total);
  if (threadIdx.x == blockIdx.x) prefix = incl - t;
  __syncthreads();
  long long carry = prefix;
  for (int b = lo; b < hi; b += kScanThreads) {
    const int k = b + threadIdx.x;
    const long long v = k < hi ? off[k] : 0;
    long long chunk;
    const long long in = block_inclusive_scan(v, &chunk);
    if (k < hi) {
      off[k] = static_cast<int>(
          min(carry + in - v, static_cast<long long>(capacity)));
    }
    carry += chunk;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    off[s] = static_cast<int>(min(total, static_cast<long long>(capacity)));
    *need = total;
  }
}

// off (s + 1,) = the exclusive scan of the slice widths, clamped to the
// slot buffer's capacity; *need = the slots the list needs.  liquid: the
// rows' one-byte liquid flags; tiles: kMaxTiles int64 of scratch.  The
// grid is the blocks that fit on the card at once (occupancy, read again
// when the current device changes), at most kMaxTiles and one per 32
// slices; a launch the card refuses returns its error.
extern "C" int nbr_list_offsets(const int* count, const unsigned char* liquid,
                                int m, int capacity, int* off,
                                long long* need, long long* tiles,
                                void* stream) {
  static int resident_dev = -1;  // the device whose residency is cached
  static int resident = 0;
  int dev = 0;
  int rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev != resident_dev) {
    int per_sm = 0;
    int sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nbr_list_offsets_kernel, kScanThreads, 0);
    if (rc != cudaSuccess) return rc;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    if (per_sm * sms == 0) return cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * sms;
    resident_dev = dev;
  }
  int s = (m + 31) / 32;
  const int grid =
      std::max(1, std::min({resident, kMaxTiles, (s + 31) / 32}));
  int tile = (s + grid - 1) / grid;
  void* args[] = {&count, &liquid, &m,   &s,    &tile,
                  &capacity, &off,   &need, &tiles};
  rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(nbr_list_offsets_kernel), grid, kScanThreads,
      args, 0, (cudaStream_t)stream);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}
