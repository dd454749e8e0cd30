// mapkit: the offline map compiler's grid passes for Hopper (sm_90a).
//
// Replaces the host C++ of the JAX package's compiler (csrc/mapkit.cpp):
//   stamp_kernel               <- mapkit_stamp_segments (mapkit.cpp:91)
//   edt_columns + edt_rows     <- mapkit_edt            (mapkit.cpp:146)
// mapkit_sdf and mapkit_propagate_dir are compositions (two EDTs and a
// select, one EDT and a gather) and stay plain torch in maps/mapkit.py.
//
// stamp_kernel (replaces mapkit.cpp:91): one block per 16 x 16 tile of
//   pixels, one thread per pixel.
//   Bound: by bytes, the three grids read and written once (18 bytes a
//   pixel) and the segment table read once (chip_smoke.py:stamp_bounds_ms).
//   What holds it above that is the float64 work of the 1-2 (pixel,
//   segment) pairs a pixel inside the windows (a division and a square
//   root are each a sequence of float64 instructions) and the scan of the
//   segment windows.
//   Design: the segments come in chunks of 256. Each thread tests one
//   segment's clamped pixel window against the tile (integer compares); a
//   chunk without hits costs one __syncthreads_count. Otherwise
//   __ballot_sync / __popc prefix sums over the block's eight warps compact
//   the hits into a shared list in input order, and only the hits' rows are
//   read from the table. The pixels then walk that list alone, so a
//   pixel's work is its tile's hits, not every segment. Input order keeps
//   "first closest wins" and drivable |= inside exact with no atomics. The
//   window is semantic (the direction update applies inside it only), so
//   each pixel still tests it; the tile predicate is
//   maps/mapkit.py:stamp_tile_hits_torch, changed together with this one.
//   The geometry is double and d = float(sqrt(d2)) is compared with the
//   float best, as in mapkit.cpp; two exact shortcuts skip work: a clamped
//   projection needs no division (IEEE division is monotone), and the
//   square root is taken only where d2 < best^2 (exact in double). The
//   table is one packed buffer (layout at tde_stamp_segments).
//
// edt (replaces mapkit.cpp:146): the exact Euclidean distance transform
//   with the flat index of the nearest source, separable, in integers.
//   Bound: by bytes, the uint8 source read once and the float distance and
//   int index written once, 9 bytes a pixel (chip_smoke.py:edt_bounds_ms).
//   Design: two passes, linear in the pixels apart from the row pass's
//   searches, through one int scratch grid (src_row: each pixel's nearest
//   source row in its column, or -1).
//   edt_columns: a block owns a band of 16 columns (adjacent columns on
//   adjacent threads, so every row's read is coalesced) cut into 64 chunks
//   of rows. Each thread finds its chunk's first and last source; a scan of
//   the other chunks' in shared memory gives the nearest source above and
//   below the chunk; then one sweep up writes the nearest source at or
//   below each row and one sweep down takes the nearer of it and the
//   nearest at or above, the one above on a tie.
//   edt_rows: a block of eight warps a row. The exact lower envelope of the
//   parabolas g1[c] + (j - c)^2 (Felzenszwalb's dt1d, mapkit.cpp:39) is a
//   serial walk, and one lane walking a whole row is bound by instruction
//   issue (a million steps a transform, each a warp instruction), so the
//   32 lanes of warp 0 each build the envelope of a 32nd of the row's
//   columns side by side, in integers only: an intersection is the
//   rational (F[q] - F[p]) / (2 (q - p)), F[c] = g1[c] + c^2, compared by
//   int64 cross-multiplication (products below 2^42 at 8192). Pop while
//   the new intersection is <= the top's. All threads then turn each
//   entry's breakpoint into its first j, floor(z) + 1 (the strict z < j),
//   off the serial walk. Each pixel then takes the least value
//   over the parts by a binary search in each part it visits: from the
//   previous pixel's winning part on (the winner never moves left as j
//   grows), outwards while a part's nearest column, plus its least g1, can
//   still match the best. The smallest column wins a tie inside a part (the
//   envelope) and between parts (compared by column), as the twin's
//   torch.min. The envelopes live in shared memory (10 bytes a column: 10
//   KB at 1024, 80 KB at MAX_EDT_GRID = 8192, above 48 KB by the
//   attribute). Squared distances stay below 2^31, so the result is exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (ops/_build.py).
// The entry points launch on the caller's stream and return
// cudaGetLastError() after the launch: 0 when it was accepted.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 16;              // pixels per side of a stamp block
constexpr int kChunk = kTile * kTile;  // segments tested per round
constexpr int kWarps = kChunk / 32;
constexpr int kBand = 16;              // columns of an edt_columns block
constexpr int kParts = 64;             // row chunks of an edt_columns block
constexpr int kRowWarps = 8;           // an edt_rows block
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kFar = INT_MAX;          // "no source below"
constexpr int kNoSource = 1 << 30;     // squared distance of a line with no source
constexpr size_t kMaxStaticSmem = 48 * 1024;  // a block's, without the attribute

// A segment of the compacted list (the packed table's fields of one row).
struct StampSeg {
  double ax, ay, sx, sy, len2, hw2;
  int i0, j0, i1, j1, has_dir;
  float ang;
};

__global__ void __launch_bounds__(kChunk)
stamp_kernel(int grid, double ox, double oy, double sc,
             const int4* __restrict__ win, const double* __restrict__ geom,
             const float* __restrict__ ang, const int* __restrict__ has_dir,
             int n, uint8_t* drivable, float* best_d, float* angle) {
  __shared__ StampSeg s_list[kChunk];
  __shared__ int s_count[kWarps];
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ti0 = blockIdx.y * kTile, tj0 = blockIdx.x * kTile;
  const int i = ti0 + threadIdx.y, j = tj0 + threadIdx.x;
  const bool in_grid = i < grid && j < grid;
  const size_t k = (size_t)i * grid + j;
  uint8_t drv = in_grid ? drivable[k] : 0;
  float bd = in_grid ? best_d[k] : 0.0f;
  float an = in_grid ? angle[k] : 0.0f;
  // mapkit.cpp: px = origin_x + (i + 0.5) * scale - ax
  const double cx = ox + (i + 0.5) * sc;
  const double cy = oy + (j + 0.5) * sc;

  for (int base = 0; base < n; base += kChunk) {
    // 1. the tile predicate (maps/mapkit.py:stamp_tile_hits_torch): a
    //    non-empty window [i0, i1) x [j0, j1) that meets the tile
    const int s = base + tid;
    bool hit = false;
    int4 w = make_int4(0, 0, 0, 0);
    if (s < n) {
      w = __ldg(win + s);
      hit = w.x < w.z && w.y < w.w && w.x < ti0 + kTile && w.z > ti0 &&
            w.y < tj0 + kTile && w.w > tj0;
    }
    // 2. compact the hits in input order: warp offsets, then lanes below.
    //    The count is also the barrier after the previous chunk's walk; a
    //    chunk without hits costs this one barrier.
    const int m = __syncthreads_count(hit);
    if (m == 0) continue;
    const unsigned mask = __ballot_sync(kFull, hit);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    int pos = __popc(mask & ((1u << lane) - 1u));
#pragma unroll
    for (int q = 0; q < kWarps; ++q) pos += q < warp ? s_count[q] : 0;
    if (hit) {
      StampSeg& e = s_list[pos];
      const double* g = geom + (size_t)s * 6;
      e.ax = g[0];
      e.ay = g[1];
      e.sx = g[2];
      e.sy = g[3];
      e.len2 = g[4];
      e.hw2 = g[5];
      e.i0 = w.x;
      e.j0 = w.y;
      e.i1 = w.z;
      e.j1 = w.w;
      e.has_dir = has_dir[s];
      e.ang = ang[s];
    }
    __syncthreads();
    // 3. the pixels walk the tile's hits in input order
    for (int h = 0; h < m; ++h) {
      const StampSeg& e = s_list[h];
      if (i < e.i0 || i >= e.i1 || j < e.j0 || j >= e.j1) continue;
      const double px = cx - e.ax, py = cy - e.ay;
      const double sx = e.sx, sy = e.sy;
      const bool dir = e.has_dir != 0;
      // t = clamp(num / len2, 0, 1); IEEE division is monotone, so a
      // clamped t needs no division
      const double num = px * sx + py * sy;
      const double t = !dir || num <= 0.0 ? 0.0
                       : num >= e.len2   ? 1.0
                                         : num / e.len2;
      const double dx = px - t * sx, dy = py - t * sy;
      const double d2 = dx * dx + dy * dy;
      if (d2 <= e.hw2) drv = 1;
      // float(sqrt(d2)) < bd needs d2 < bd^2 (exact in double)
      if (dir && d2 < (double)bd * (double)bd) {
        const float d = (float)sqrt(d2);
        if (d < bd) {
          bd = d;
          an = e.ang;
        }
      }
    }
  }
  if (in_grid) {
    drivable[k] = drv;
    best_d[k] = bd;
    angle[k] = an;
  }
}

// Per column j: each pixel's nearest source row (the one above on a tie),
// or -1. Block: kBand columns (threadIdx.x) x kParts row chunks (.y).
__global__ void __launch_bounds__(kBand * kParts)
edt_columns(int grid, const uint8_t* __restrict__ source, int* src_row) {
  __shared__ int s_first[kParts][kBand + 1], s_last[kParts][kBand + 1];
  const int x = threadIdx.x, y = threadIdx.y;
  const int j = blockIdx.x * kBand + x;
  const int rows = (grid + kParts - 1) / kParts;
  const int r0 = min(y * rows, grid), r1 = min(r0 + rows, grid);
  const bool col = j < grid;
  int first = kFar, last = -1;
  if (col) {
    for (int r = r0; r < r1; ++r) {
      if (source[(size_t)r * grid + j]) {
        first = min(first, r);
        last = r;
      }
    }
  }
  s_first[y][x] = first;
  s_last[y][x] = last;
  __syncthreads();
  int above = -1, below = kFar;     // nearest outside the chunk
  for (int c = 0; c < y; ++c) above = max(above, s_last[c][x]);
  for (int c = y + 1; c < kParts; ++c) below = min(below, s_first[c][x]);
  if (!col) return;
  // up: the nearest source at or below each row, kept in src_row
  for (int r = r1 - 1; r >= r0; --r) {
    const size_t o = (size_t)r * grid + j;
    if (source[o]) below = r;
    src_row[o] = below;
  }
  // down: the nearer of the nearest at or above and at or below
  for (int r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * grid + j;
    const int b = src_row[o];
    if (b == r) above = r;
    const int d_above = above >= 0 ? (r - above) * (r - above) : kNoSource;
    const int d_below = b != kFar ? (b - r) * (b - r) : kNoSource;
    const int d = min(d_above, d_below);
    src_row[o] = d >= kNoSource ? -1 : (d_above <= d_below ? above : b);
  }
}

// Per row i: min over columns c of g1[i, c] + (j - c)^2 (the smallest c on
// a tie), with g1[i, c] = (i - src_row[i, c])^2; the distance and the flat
// index of the source it reaches. One block of kRowWarps warps a row: lane
// p of warp 0 builds the envelope of the row's p-th part of columns; then
// each thread takes pixels j = tid, tid + kRowThreads, ... and searches the
// parts that can hold its best.
__global__ void __launch_bounds__(kRowThreads)
edt_rows(int grid, const int* __restrict__ src_row, float* dist, int* idx) {
  extern __shared__ int smem_i[];
  const int span = (grid + 31) / 32;  // columns a part
  const int cap = span * 32;
  int* s_f = smem_i;                  // F of part p's envelope at p span
  int16_t* s_src = (int16_t*)(smem_i + cap);  // the row's src_row
  int16_t* s_v = s_src + grid;        // the envelope's columns
  int16_t* s_t = s_v + cap;           // their first j, floor(z) + 1
  __shared__ int s_n[32], s_mg[32];   // entries and least g1 of a part
  const int tid = threadIdx.x, lane = tid & 31;
  const int i = blockIdx.x;
  const size_t row = (size_t)i * grid;
  for (int c = tid; c < grid; c += kRowThreads)
    s_src[c] = (int16_t)src_row[row + c];
  __syncthreads();

  // 1. each part's lower envelope: the top and the entry below it in
  //    registers, with the top's breakpoint zn / zd (valid from two
  //    entries on); pop while the new breakpoint is <= the top's
  if (tid < 32) {
    const int c0 = min(lane * span, grid), c1 = min(c0 + span, grid);
    int16_t* v = s_v + lane * span;
    int* f = s_f + lane * span;
    int n = 0, vt = 0, ft = 0, vp = 0, fp = 0, zn = 0, zd = 1, mg = INT_MAX;
    int sq_next = c0 < c1 ? s_src[c0] : -1;
    for (int q = c0; q < c1; ++q) {
      const int sq = sq_next;
      sq_next = q + 1 < c1 ? s_src[q + 1] : -1;
      if (sq < 0) continue;
      const int g1 = (i - sq) * (i - sq);
      const int fq = g1 + q * q;                      // F[q] = g1[q] + q^2
      mg = min(mg, g1);
      while (n >= 2 && (long long)(fq - ft) * zd <=
                           (long long)zn * (2 * (q - vt))) {
        --n;
        vt = vp;
        ft = fp;
        if (n >= 2) {
          vp = v[n - 2];
          fp = f[n - 2];
          zn = ft - fp;
          zd = 2 * (vt - vp);
        }
      }
      if (n >= 1) {
        vp = vt;
        fp = ft;
        zn = fq - ft;
        zd = 2 * (q - vt);
      }
      v[n] = (int16_t)q;
      f[n++] = fq;
      vt = q;
      ft = fq;
    }
    s_n[lane] = n;
    s_mg[lane] = mg;
  }
  __syncthreads();
  int total = 0;
#pragma unroll 8
  for (int p = 0; p < 32; ++p) total += s_n[p];
  if (total == 0) {
    // no source in the grid: mapkit.cpp's sqrt(kInf), kInf = 1e20f
    const float far = (float)sqrt((double)1e20f);
    for (int c = tid; c < grid; c += kRowThreads) {
      dist[row + c] = far;
      idx[row + c] = -1;
    }
    return;
  }

  // 2. breakpoints as integers: entry k of a part holds the j with
  //    z[k] < j, so its first j is floor(z[k]) + 1, clamped to [0, grid]
  for (int e = tid; e < cap; e += kRowThreads) {
    const int p = e / span, k = e - p * span;
    if (k >= s_n[p]) continue;
    int first = 0;
    if (k > 0) {
      const int num = s_f[e] - s_f[e - 1];
      const int den = 2 * (s_v[e] - s_v[e - 1]);
      int fl = num / den;
      if (num % den != 0 && num < 0) --fl;
      first = min(max(fl + 1, 0), grid);
    }
    s_t[e] = (int16_t)first;
  }
  __syncthreads();

  // 3. each pixel: a search of the parts from the previous pixel's winner
  //    on (the winning part never moves left as j grows: for parts a < b,
  //    E_a(x) - E_b(x) increases). From its own part (or that winner) to
  //    the right while a part's first column is nearer than the best, then
  //    to the left while its last column is no farther (a tie there is a
  //    smaller column). A part whose distance plus least g1 exceeds the
  //    best is skipped. A part's value at j is its entry with the last
  //    first-j <= j (a binary search); the smaller column wins a tie
  //    between parts.
  int lowest = 0;
  for (int j = tid; j < grid; j += kRowThreads) {
    int best = INT_MAX, bv = INT_MAX;
    const int start = max(j / span, lowest);
    for (int p = start, step = 1; p >= lowest; p += step) {
      if (p == 32) {                  // the right side done: the left side
        p = start;
        step = -1;
        continue;
      }
      const int edge = step > 0 ? max(p * span - j, 0)
                                : j - ((p + 1) * span - 1);
      if (p != start && (step > 0 ? edge * edge >= best : edge * edge > best)) {
        if (step < 0) break;
        p = start;
        step = -1;
        continue;
      }
      const int n = s_n[p];
      if (n == 0 || edge * edge + s_mg[p] > best) continue;
      const int16_t* t = s_t + p * span;
      int x = 0, y = n;
      while (y - x > 1) {
        const int mid = (x + y) >> 1;
        if (t[mid] <= j) x = mid; else y = mid;
      }
      const int c = s_v[p * span + x];
      const int d = (j - c) * (j - c) + s_f[p * span + x] - c * c;
      if (d < best || (d == best && c < bv)) {
        best = d;
        bv = c;
      }
    }
    lowest = bv / span;
    const int sr = s_src[bv];
    dist[row + j] = (float)sqrt((double)(float)best);
    idx[row + j] = sr * grid + bv;
  }
}

}  // namespace

extern "C" {

// table: one packed buffer of the n segments of
// maps/mapkit.py:segment_table, 72 bytes a segment in four arrays:
// win (n, 4) int [i0, j0, i1, j1] at 0, geom (n, 6) double [ax, ay, sx, sy,
// len2, hw2] at 16 n, ang (n,) float at 64 n, has_dir (n,) int at 68 n.
// drivable (uint8), best_d and angle (float) are (grid, grid), read and
// written in place.
int tde_stamp_segments(int grid, double ox, double oy, double sc,
                       const void* table, int n, uint8_t* drivable,
                       float* best_d, float* angle, void* stream) {
  const char* base = (const char*)table;
  const int4* win = (const int4*)base;
  const double* geom = (const double*)(base + (size_t)16 * n);
  const float* ang = (const float*)(base + (size_t)64 * n);
  const int* has_dir = (const int*)(base + (size_t)68 * n);
  const int tiles = (grid + kTile - 1) / kTile;
  stamp_kernel<<<dim3(tiles, tiles), dim3(kTile, kTile), 0,
                 (cudaStream_t)stream>>>(grid, ox, oy, sc, win, geom, ang,
                                         has_dir, n, drivable, best_d, angle);
  return (int)cudaGetLastError();
}

// source (grid, grid) uint8 -> dist (float) and idx (int), with src_row
// (int, grid x grid) as scratch between the two passes.
int tde_edt(int grid, const uint8_t* source, int* src_row, float* dist,
            int* idx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  edt_columns<<<(grid + kBand - 1) / kBand, dim3(kBand, kParts), 0, s>>>(
      grid, source, src_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cap = (grid + 31) / 32 * 32;
  const size_t smem = (size_t)cap * sizeof(int) +
                      (size_t)(grid + 2 * cap) * sizeof(int16_t);
  if (smem + 64 * sizeof(int) > kMaxStaticSmem) {  // and s_n, s_mg
    err = cudaFuncSetAttribute(edt_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  edt_rows<<<grid, kRowThreads, smem, s>>>(grid, src_row, dist, idx);
  return (int)cudaGetLastError();
}

const char* tde_mapkit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
