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
//   * bin_cells is a counting sort by cell in four launches and no memset.
//     (1) Each particle's cell, exactly as cell_of_positions computes it,
//     floor((x - dmin) * float32(1 / cell size)), and a slot in its cell
//     from an atomic histogram.  (2) One cooperative launch scans both the
//     histogram (the cell offsets) and the particles' outside flags: tile
//     sums, one grid sync, then each block scans the tile sums and its own
//     tiles.  It zeroes each histogram bin once it has read it, puts the
//     particles outside the domain on the rows after the last cell in
//     particle order, and writes the count of liquid particles inside the
//     domain, n_liquid - (outside particles below n_liquid): no atomic
//     counter.  (3) A scatter places each particle at its cell's offset
//     plus its slot.  (4) One thread per row takes its particle's rank in
//     the cell's run (how many of the run's particles have a lower index),
//     which puts the run in particle order whatever order the atomics
//     took, so the permutation is the stable sort's, and writes the row's
//     order, cell, position and flags and the particle's row.  The rows
//     outside the domain are inert: in no cell's range, liquid flag 0, and
//     a cell id whose 27-cell window lies wholly outside the grid (the cell
//     loops of common.cuh find no candidate for them).
//     The scratch (cell keys, slots, the scatter's rows, the histogram and
//     the scan's tile sums) is kept by the caller from call to call; its
//     histogram is all zero when a call starts (zeroed when allocated, and
//     by every scan after it reads a bin), so no call clears it.
//   * pack_rows and unpack_rows move every field of a step in one launch
//     each, between the per-liquid rows of at most kPackSources fields and
//     one block of rows the wrapper allocates (row k at k x the row
//     length): pack reads each row's particle (order) where the row's
//     one-byte liquid flag is set; unpack reads each particle's row
//     (row_of, -1 outside the domain, where the default is read).  Only
//     the fields' bases and row counts cross the call; the entry builds
//     the row table.  Each thread issues all its gathers before its
//     stores.
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
// What bounds them on the H100: bytes, and at 1M rows the launches.  The
// bin moves ~45 bytes per particle once, but its scatter and gathers are
// scattered accesses; pack and unpack move 4 bytes per field and row plus
// the indices; the offsets read 5 bytes a row and are bound by their one
// launch and grid sync (a few microseconds).
//
// A launch returns cudaGetLastError() or the cooperative launch's error.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

constexpr int kThreads = 256;      // threads of the row kernels
constexpr int kScanThreads = 1024; // threads of the cooperative scans
                                   // (32 warps)
constexpr int kMaxFields = 16;     // field rows a pack or unpack moves
constexpr int kPackSources = 5;    // fields one pack or unpack takes,
                                   // DFSPH's five (engine.PACK_SOURCES)
constexpr int kMaxTiles = kScanThreads;  // most blocks of a cooperative
                                         // scan's one grid
                                         // (grid.OFFSET_TILES; the bin
                                         // keeps two sets of tile sums,
                                         // engine.BIN_TILES)

static inline int blocks(long long n) {
  return n > 0 ? static_cast<int>((n + kThreads - 1) / kThreads) : 1;
}

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

// The blocks of kScanThreads threads of a cooperative kernel that fit on
// the current device at once (occupancy), kept in *cache for the device
// last asked about.
struct Residency {
  int dev;
  int blocks;
};

static int resident_blocks(const void* kernel, Residency* cache,
                           int* blocks_out) {
  int dev = 0;
  int rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev != cache->dev) {
    int per_sm = 0;
    int sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kScanThreads, 0);
    if (rc != cudaSuccess) return rc;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    if (per_sm * sms == 0) return cudaErrorCooperativeLaunchTooLarge;
    cache->blocks = per_sm * sms;
    cache->dev = dev;
  }
  *blocks_out = cache->blocks;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The bin
// ---------------------------------------------------------------------------

// Cell key of each particle (nc outside the domain) and, inside, its slot
// in its cell.
__global__ void bin_count_kernel(const float* __restrict__ pos, int n,
                                 float dx, float dy, float dz, float inv,
                                 int gx, int gy, int gz,
                                 int* __restrict__ key, int* __restrict__ slot,
                                 int* __restrict__ hist) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  // float compares: a NaN or infinite position falls outside
  const float fx = floorf((pos[p] - dx) * inv);
  const float fy = floorf((pos[n + p] - dy) * inv);
  const float fz = floorf((pos[2 * n + p] - dz) * inv);
  const bool in = fx >= 0.0f && fx < static_cast<float>(gx) &&
                  fy >= 0.0f && fy < static_cast<float>(gy) &&
                  fz >= 0.0f && fz < static_cast<float>(gz);
  const int k = (static_cast<int>(fx) * gy + static_cast<int>(fy)) * gz +
                static_cast<int>(fz);
  key[p] = in ? k : gx * gy * gz;
  if (in) slot[p] = atomicAdd(hist + k, 1);
}

// One launch of at most one resident grid (cooperative): block b takes the
// cells [b ctile, b ctile + ctile) and the particles [b ptile, b ptile +
// ptile).  Phase 1: the block's sums of its cells' counts and of its
// particles' outside flags go to tiles[b] and tiles[kMaxTiles + b].  One
// grid-wide sync.  Phase 2: every block scans both sets of tile sums
// (gridDim.x <= kMaxTiles, one a thread) for its prefixes and the totals,
// then its cells from its prefix: start[c], and hist[c] = 0 once read; then,
// where its tile holds any, the ranks of its outside particles: particle p
// of rank k goes to row start[nc] + k (tmp).  The block whose tile holds
// particle n_liquid writes n_liq = n_liquid - (outside particles below
// it); block 0 writes start[nc], and n_liq where n_liquid = n.
__global__ void __launch_bounds__(kScanThreads)
    bin_scan_kernel(int* __restrict__ hist, int nc,
                    const int* __restrict__ key, int n, int n_liquid,
                    int ctile, int ptile, int* __restrict__ start,
                    int* __restrict__ tmp, int* __restrict__ n_liq,
                    long long* __restrict__ tiles) {
  const int clo = min(static_cast<int>(blockIdx.x) * ctile, nc);
  const int chi = min(clo + ctile, nc);
  const int plo = min(static_cast<int>(blockIdx.x) * ptile, n);
  const int phi = min(plo + ptile, n);
  long long cs = 0;
  long long ps = 0;
  for (int c = clo + threadIdx.x; c < chi; c += kScanThreads) cs += hist[c];
  for (int p = plo + threadIdx.x; p < phi; p += kScanThreads) {
    ps += key[p] >= nc ? 1 : 0;
  }
  long long csum;
  long long psum;
  block_inclusive_scan(cs, &csum);
  block_inclusive_scan(ps, &psum);
  if (threadIdx.x == 0) {
    tiles[blockIdx.x] = csum;
    tiles[kMaxTiles + blockIdx.x] = psum;
  }
  cooperative_groups::this_grid().sync();

  __shared__ long long prefix[2];
  const bool mine = threadIdx.x < gridDim.x;
  const long long ct = mine ? __ldcg(tiles + threadIdx.x) : 0;
  const long long pt = mine ? __ldcg(tiles + kMaxTiles + threadIdx.x) : 0;
  long long ctotal;
  long long ptotal;
  const long long cin = block_inclusive_scan(ct, &ctotal);
  const long long pin = block_inclusive_scan(pt, &ptotal);
  if (threadIdx.x == blockIdx.x) {
    prefix[0] = cin - ct;
    prefix[1] = pin - pt;
  }
  __syncthreads();
  long long carry = prefix[0];
  for (int b = clo; b < chi; b += kScanThreads) {
    const int c = b + threadIdx.x;
    const long long v = c < chi ? hist[c] : 0;
    long long chunk;
    const long long in = block_inclusive_scan(v, &chunk);
    if (c < chi) {
      start[c] = static_cast<int>(carry + in - v);
      hist[c] = 0;
    }
    carry += chunk;
  }
  carry = prefix[1];
  if (psum != 0) {
    for (int b = plo; b < phi; b += kScanThreads) {
      const int p = b + threadIdx.x;
      const long long v = p < phi && key[p] >= nc ? 1 : 0;
      long long chunk;
      const long long rank = block_inclusive_scan(v, &chunk) - v;
      if (v != 0) tmp[ctotal + carry + rank] = p;
      if (p < phi && p == n_liquid) {
        *n_liq = static_cast<int>(n_liquid - (carry + rank));
      }
      carry += chunk;
    }
  } else if (threadIdx.x == 0 && plo <= n_liquid && n_liquid < phi) {
    *n_liq = static_cast<int>(n_liquid - carry);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    start[nc] = static_cast<int>(ctotal);
    if (n_liquid >= n) *n_liq = static_cast<int>(n - ptotal);
  }
}

// tmp[start[k] + slot] = p for every particle inside the domain.
__global__ void bin_scatter_kernel(int n, int nc, const int* __restrict__ key,
                                   const int* __restrict__ slot,
                                   const int* __restrict__ start,
                                   int* __restrict__ tmp) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int k = key[p];
  if (k < nc) tmp[start[k] + slot[p]] = p;
}

// Row r's particle p = tmp[r] goes to row start[k] + (the particles of its
// cell's run below p): the run in particle order.  A thread reads its
// cell's run once, so a cell of L particles costs L reads on each of L
// threads; the solvers keep the density near rest (~8 particles a cell of
// liquid, a few times that where a splash compresses it).  The rows after
// the last cell keep their place (particle order from the scan).
__global__ void bin_rows_kernel(const float* __restrict__ pos, int n,
                                int n_liquid, int nc, int outside_cell,
                                const int* __restrict__ key,
                                const int* __restrict__ start,
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
  const float x = __ldg(pos + p);
  const float y = __ldg(pos + n + p);
  const float z = __ldg(pos + 2 * n + p);
  const bool in = k < nc;
  int row = r;
  if (in) {
    const int b = start[k];
    const int e = start[k + 1];
    int rank = 0;
    for (int a = b; a < e; ++a) rank += tmp[a] < p ? 1 : 0;
    row = b + rank;
  }
  const bool l = in && p < n_liquid;
  order[row] = p;
  row_of[p] = in ? row : -1;
  cell[row] = in ? k : outside_cell;
  pos_out[row] = x;
  pos_out[n + row] = y;
  pos_out[2 * n + row] = z;
  liquid[row] = l ? 1 : 0;
  liq[row] = l ? 1.0f : 0.0f;
}

// scratch: kept by the caller; 2 kMaxTiles int64 of tile sums, then int32
// key, slot and tmp (cap each, cap >= n) and the histogram (nc), all zero
// when the call starts and when it ends.  Four launches: count, the
// cooperative scan (grid: the blocks that fit on the card at once, at most
// kMaxTiles and one per kScanThreads cells or particles), scatter, rows.
extern "C" int bin_cells(const float* pos, int n, int n_liquid, float dx,
                         float dy, float dz, float inv, int gx, int gy,
                         int gz, int outside_cell, void* scratch, int cap,
                         long long* order, int* row_of, int* cell,
                         int* start, float* pos_out, unsigned char* liquid,
                         float* liq, int* n_liq, void* stream) {
  static Residency resident{-1, 0};
  cudaStream_t st = (cudaStream_t)stream;
  int nc = gx * gy * gz;
  long long* tiles = static_cast<long long*>(scratch);
  int* key = reinterpret_cast<int*>(tiles + 2 * kMaxTiles);
  int* slot = key + cap;
  int* tmp = slot + cap;
  int* hist = tmp + cap;
  int most = 0;
  int rc = resident_blocks(reinterpret_cast<const void*>(bin_scan_kernel),
                           &resident, &most);
  if (rc != cudaSuccess) return rc;
  const int grid = std::max(
      1, std::min({most, kMaxTiles,
                   (std::max(nc, n) + kScanThreads - 1) / kScanThreads}));
  int ctile = (nc + grid - 1) / grid;
  int ptile = (n + grid - 1) / grid;
  bin_count_kernel<<<blocks(n), kThreads, 0, st>>>(
      pos, n, dx, dy, dz, inv, gx, gy, gz, key, slot, hist);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  void* args[] = {&hist,  &nc,    &key,  &n,     &n_liquid, &ctile,
                  &ptile, &start, &tmp,  &n_liq, &tiles};
  rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bin_scan_kernel), grid, kScanThreads, args, 0,
      st);
  if (rc != cudaSuccess) return rc;
  bin_scatter_kernel<<<blocks(n), kThreads, 0, st>>>(n, nc, key, slot, start,
                                                     tmp);
  bin_rows_kernel<<<blocks(n), kThreads, 0, st>>>(
      pos, n, n_liquid, nc, outside_cell, key, start, tmp, order, row_of,
      cell, pos_out, liquid, liq);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Pack and unpack: every field row of a step in one launch
// ---------------------------------------------------------------------------

// The field rows of a pack or unpack, from the field bases the entry is
// given: src[j] the packed or per-liquid row read, dflt[j] (unpack) the
// default read outside the domain.
struct FieldRows {
  const float* src[kMaxFields];
  const float* dflt[kMaxFields];
};

// Field a (a < kPackSources) is rows[a] contiguous rows of length len from
// base[a] (null and 0 past the last field): row k of the table.  Returns
// the rows, or -1 past kMaxFields.
static int field_rows(const float* const* base, const int* rows, long long len,
                      const float** table) {
  int k = 0;
  for (int a = 0; a < kPackSources; ++a) {
    for (int c = 0; c < rows[a]; ++c) {
      if (k == kMaxFields) return -1;
      table[k++] = base[a] + c * len;
    }
  }
  return k;
}

// Per-liquid (nl,) rows -> sorted rows k n .. k n + n - 1 of dst; rows
// holding no liquid take 0.  The flag and the particle are loaded side by
// side, then every field's gather before any store: a store may alias a
// source for the compiler, which would otherwise wait out each gather's
// latency before the next one issues.
__global__ void pack_rows_kernel(FieldRows f, int k, int n,
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

// Sorted (m,) rows -> per-liquid rows k nl .. k nl + nl - 1 of dst; a
// liquid particle outside the domain (row -1) reads its default.  The row
// is loaded, then every field's gather before any store, as in the pack.
__global__ void unpack_rows_kernel(FieldRows f, int k, int nl,
                                   const int* __restrict__ row_of,
                                   float* __restrict__ dst) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= nl) return;
  const int r = row_of[p];
  float v[kMaxFields];
#pragma unroll
  for (int j = 0; j < kMaxFields; ++j) {
    if (j < k) v[j] = __ldg(r >= 0 ? f.src[j] + r : f.dflt[j] + p);
  }
#pragma unroll
  for (int j = 0; j < kMaxFields; ++j) {
    if (j < k) dst[static_cast<size_t>(j) * nl + p] = v[j];
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
  FieldRows f{};
  const int k = field_rows(src, rows, nl, f.src);
  if (k < 0) return cudaErrorInvalidValue;
  pack_rows_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, k, n, order, liquid, dst);
  return cudaGetLastError();
}

// Packed field a (a < kPackSources) is rows[a] contiguous (m,) rows from
// p_a, its default as many (nl,) rows from d_a (null and 0 past the last
// field); dst: (total rows, nl), row k at k nl.
extern "C" int unpack_rows(int m, int nl, const int* row_of, float* dst,
                           const float* p0, int k0, const float* p1, int k1,
                           const float* p2, int k2, const float* p3, int k3,
                           const float* p4, int k4, const float* d0,
                           const float* d1, const float* d2, const float* d3,
                           const float* d4, void* stream) {
  const float* const src[kPackSources] = {p0, p1, p2, p3, p4};
  const float* const dflt[kPackSources] = {d0, d1, d2, d3, d4};
  const int rows[kPackSources] = {k0, k1, k2, k3, k4};
  FieldRows f{};
  const int k = field_rows(src, rows, m, f.src);
  if (k < 0) return cudaErrorInvalidValue;
  field_rows(dflt, rows, nl, f.dflt);
  unpack_rows_kernel<<<blocks(nl), kThreads, 0, (cudaStream_t)stream>>>(
      f, k, nl, row_of, dst);
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
  static Residency resident{-1, 0};
  int most = 0;
  int rc = resident_blocks(
      reinterpret_cast<const void*>(nbr_list_offsets_kernel), &resident,
      &most);
  if (rc != cudaSuccess) return rc;
  int s = (m + 31) / 32;
  const int grid =
      std::max(1, std::min({most, kMaxTiles, (s + 31) / 32}));
  int tile = (s + grid - 1) / grid;
  void* args[] = {&count, &liquid, &m,   &s,    &tile,
                  &capacity, &off,   &need, &tiles};
  rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(nbr_list_offsets_kernel), grid, kScanThreads,
      args, 0, (cudaStream_t)stream);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}
