// mapkit: the offline map compiler's grid passes for Hopper (sm_90a).
//
// Replaces the host C++ of the JAX package's compiler (csrc/mapkit.cpp):
//   stamp_kernel               <- mapkit_stamp_segments (mapkit.cpp:91)
//   edt_columns + edt_rows     <- mapkit_edt            (mapkit.cpp:146)
// mapkit_sdf and mapkit_propagate_dir are compositions (two EDTs and a
// select, one EDT and a gather) and stay plain torch in maps/mapkit.py.
//
// stamp_kernel: one block per 16 x 16 tile of pixels, one thread per pixel.
//   The segments are staged through shared memory 256 at a time and walked
//   in input order, so "first closest wins" and drivable |= inside need no
//   atomics. A segment touches a pixel only inside its window (computed on
//   the host as mapkit.cpp:105-115 does, and clamped): the window decides
//   which pixels the direction update applies to, so it is semantic, not an
//   optimisation. A block skips a segment whose window misses its tile
//   (a uniform branch). The geometry is double, d = float(sqrt(d2)) is
//   compared with the float best, as in mapkit.cpp.
//   Bound: by bytes (the three grids read and written once, 18 bytes a
//   pixel); the double operations of the (pixel, segment) pairs inside the
//   windows are far fewer than the card can do in that time.
//
// edt: the exact Euclidean distance transform, separable. edt_columns: per
//   column, each pixel's nearest source row by a brute-force min-plus over
//   the column; edt_rows: per row, a min-plus of those squared distances
//   plus (j - c)^2 over every column c. Squared distances are integers
//   (< 2^31), so the result is exact, and the tie rule is pinned: the
//   smallest source row, then the smallest column (a strict < while the
//   scan ascends). The twin (maps/mapkit.py:edt_torch) keeps the same rule.
//   Bound: by bytes (one byte read, eight written a pixel); the brute force
//   does 2 G^3 min-plus steps where a lower-envelope algorithm does O(G^2),
//   so this kernel is far above its bound. A simple kernel that is right
//   first; the lower envelope is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (ops/_build.py).
// The entry points launch on the caller's stream and return
// cudaGetLastError() after the launch: 0 when it was accepted.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;          // pixels per side of a stamp block
constexpr int kChunk = kTile * kTile;  // segments staged per round
constexpr int kGeom = 6;           // ax, ay, sx, sy, len2, hw2 (double)
constexpr int kWin = 5;            // i0, j0, i1, j1, has_dir (int)
constexpr int kEdtThreads = 256;
constexpr int kNoSource = 1 << 30; // squared distance of a line with no source

__global__ void __launch_bounds__(kChunk)
stamp_kernel(int grid, double ox, double oy, double sc,
             const double* __restrict__ geom, const int* __restrict__ win,
             const float* __restrict__ ang, int n, uint8_t* drivable,
             float* best_d, float* angle) {
  __shared__ double s_geom[kChunk * kGeom];
  __shared__ int s_win[kChunk * kWin];
  __shared__ float s_ang[kChunk];
  const int tid = threadIdx.y * kTile + threadIdx.x;
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
    const int m = min(kChunk, n - base);
    __syncthreads();
    if (tid < m) {
      for (int f = 0; f < kGeom; ++f)
        s_geom[tid * kGeom + f] = geom[(size_t)(base + tid) * kGeom + f];
      for (int f = 0; f < kWin; ++f)
        s_win[tid * kWin + f] = win[(size_t)(base + tid) * kWin + f];
      s_ang[tid] = ang[base + tid];
    }
    __syncthreads();
    for (int s = 0; s < m; ++s) {
      const int* w = s_win + s * kWin;
      if (w[0] >= ti0 + kTile || w[2] <= ti0 || w[1] >= tj0 + kTile ||
          w[3] <= tj0)
        continue;  // the window misses this tile
      if (i < w[0] || i >= w[2] || j < w[1] || j >= w[3]) continue;
      const double* g = s_geom + s * kGeom;
      const double px = cx - g[0], py = cy - g[1];
      const double sx = g[2], sy = g[3];
      const bool has_dir = w[4] != 0;
      double t = has_dir ? (px * sx + py * sy) / g[4] : 0.0;
      if (t < 0.0) t = 0.0;
      if (t > 1.0) t = 1.0;
      const double dx = px - t * sx, dy = py - t * sy;
      const double d2 = dx * dx + dy * dy;
      if (d2 <= g[5]) drv = 1;
      if (has_dir) {
        const float d = (float)sqrt(d2);
        if (d < bd) {
          bd = d;
          an = s_ang[s];
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

// Per column j: the nearest source row of every pixel (smallest on a tie).
__global__ void __launch_bounds__(kEdtThreads)
edt_columns(int grid, const uint8_t* __restrict__ source, int* g1,
            int* src_row) {
  extern __shared__ int f[];
  const int j = blockIdx.x;
  for (int r = threadIdx.x; r < grid; r += blockDim.x)
    f[r] = source[(size_t)r * grid + j] ? 0 : kNoSource;
  __syncthreads();
  for (int q = threadIdx.x; q < grid; q += blockDim.x) {
    int best = INT_MAX, arg = -1;
    for (int r = 0; r < grid; ++r) {
      const int d = f[r] + (q - r) * (q - r);
      if (d < best) {
        best = d;
        arg = r;
      }
    }
    const bool found = best < kNoSource;
    g1[(size_t)q * grid + j] = found ? best : kNoSource;
    src_row[(size_t)q * grid + j] = found ? arg : -1;
  }
}

// Per row i: min over columns c of g1[i, c] + (j - c)^2 (smallest c on a
// tie); the distance and the flat index of the source it reaches.
__global__ void __launch_bounds__(kEdtThreads)
edt_rows(int grid, const int* __restrict__ g1, const int* __restrict__ src_row,
         float* dist, int* idx) {
  extern __shared__ int f[];
  const int i = blockIdx.x;
  const size_t row = (size_t)i * grid;
  for (int c = threadIdx.x; c < grid; c += blockDim.x) f[c] = g1[row + c];
  __syncthreads();
  for (int j = threadIdx.x; j < grid; j += blockDim.x) {
    int best = INT_MAX, arg = 0;
    for (int c = 0; c < grid; ++c) {
      const int d = f[c] + (j - c) * (j - c);
      if (d < best) {
        best = d;
        arg = c;
      }
    }
    // no source in the grid: mapkit.cpp's sqrt(kInf), kInf = 1e20f
    const bool found = best < kNoSource;
    const float d2 = found ? (float)best : 1e20f;
    dist[row + j] = (float)sqrt((double)d2);
    idx[row + j] = found ? src_row[row + arg] * grid + arg : -1;
  }
}

}  // namespace

extern "C" {

// geom (n, 6) double, win (n, 5) int, ang (n,) float: the per-segment
// table of maps/mapkit.py:segment_table. drivable (uint8), best_d and angle
// (float) are (grid, grid), read and written in place.
int tde_stamp_segments(int grid, double ox, double oy, double sc,
                       const double* geom, const int* win, const float* ang,
                       int n, uint8_t* drivable, float* best_d, float* angle,
                       void* stream) {
  const int tiles = (grid + kTile - 1) / kTile;
  stamp_kernel<<<dim3(tiles, tiles), dim3(kTile, kTile), 0,
                 (cudaStream_t)stream>>>(grid, ox, oy, sc, geom, win, ang, n,
                                         drivable, best_d, angle);
  return (int)cudaGetLastError();
}

// source (grid, grid) uint8 -> dist (float) and idx (int), with g1 and
// src_row (int, grid x grid) as scratch between the two passes.
int tde_edt(int grid, const uint8_t* source, int* g1, int* src_row,
            float* dist, int* idx, void* stream) {
  const size_t smem = (size_t)grid * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  edt_columns<<<grid, kEdtThreads, smem, s>>>(grid, source, g1, src_row);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edt_rows<<<grid, kEdtThreads, smem, s>>>(grid, g1, src_row, dist, idx);
  return (int)cudaGetLastError();
}

const char* tde_mapkit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
