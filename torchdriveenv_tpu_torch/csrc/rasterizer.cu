// Fused birdview rasterizer for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of torchdriveenv_tpu/ops/rasterizer_pallas.py
// (_make_kernel.kernel, launched by _render_pallas through pl.pallas_call).
// It computes what that kernel computes, one (3, 64, 64) uint8 egocentric
// frame per env, from the blocks that prepare_obs_inputs packs:
//   background -> analytic road (the pixel lies within sign(hw)*hw^2 of a
//   corridor segment of the ego cell's nearest-first list) -> waypoint
//   discs -> stoplines tinted by light state (nearest wins) -> NPC boxes ->
//   the ego box.
//
// What bounds the work on the card: arithmetic. The exact road test costs
// 17 f32 operations per pixel per segment, and a cell's list is long: it
// holds every segment that can reach a frame centred anywhere in a 32 m
// cell (an 80 m reach), and the envs sit where traffic is, at a mean of
// about 126 listed segments per env (4096 train envs, measured on the
// card). Scanning all of them for all 4096 pixels is about 8.8 M
// operations per env, against about 13 KB of bytes moved per env. Without
// FMA each multiply and each add issues on its own, so the full scan cannot
// be tuned under about twice its operation bound: only doing less work helps.
//
// Design of render_obs_kernel (one block of kThreads per env, grid = B):
//   1. Frame cull while staging. Of its nseg listed rows the block stages
//      in shared memory only those that can reach the frame: distance from
//      the ego (the frame's centre) to the segment at most
//      hw + frame half-diagonal + margin. Rows with sign(hw)*hw^2 < 0 are
//      dropped. Survivors are compacted with a ballot and a shared counter;
//      their order is irrelevant because the road mask is an OR.
//   2. Tile cull per warp. The frame is 16 tiles of 16 x 16 pixels; warps
//      draw tiles from a shared counter. A lane owns 8 pixels (2 rows x 4
//      adjacent columns), whose world coordinates stay in registers. In
//      rounds of 32 staged segments, lane j tests segment j against the
//      tile's bounding circle, a ballot gathers the candidates, and the
//      warp runs the exact road test only on those, reading each from
//      shared memory once for its 8 pixels. The scan of a tile ends early
//      once every one of its pixels is road.
//   3. The same cull for the overlays: one ballot per tile gives a bit per
//      agent box, waypoint disc and stopline, and one for the ego box; the
//      exact per-pixel tests run over the set bits only. Stoplines keep the
//      descending order, so the lowest index still wins.
//   4. Packed stores: a lane writes one 32-bit word (4 pixels) per row and
//      plane.
//
// Bit-equality with the plain twin (render_obs_torch). A cull only skips a
// primitive that cannot hit any pixel of the tile: every cull test uses the
// half-diagonal between pixel centres, scaled by the length of the ego's
// (cos, sin) row, plus kCullMargin (0.25 m; coordinates reach about 1000 m,
// where an f32 ulp is 6e-5 m, so the margin covers all rounding of both the
// cull and the exact test). The cull's own arithmetic matches nothing bit
// for bit and need not. Every surviving primitive goes through exactly the
// twin's expression: same operand order, IEEE division (no fast math), and
// the file is built with --fmad=false so no multiply-add is contracted.
// cull_masks_torch (ops/rasterizer_cuda.py) is the plain version of these
// predicates; the CPU tests prove them conservative on the compiled maps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 5;                    // blocks per SM it is built for
constexpr int kRes = 64;
constexpr int kPix = kRes * kRes;
constexpr int kAgents = 16;
constexpr int kWaypoints = 8;
constexpr int kLights = 4;
constexpr int kTile = 16;                        // tile side in pixels
constexpr int kTilesPerSide = kRes / kTile;      // 4
constexpr int kTiles = kTilesPerSide * kTilesPerSide;
constexpr int kLanePix = 8;                      // 2 rows x 4 columns
constexpr float kCullMargin = 0.25f;             // metres
constexpr float kSqrt2 = 1.41421356f;
constexpr unsigned kFull = 0xffffffffu;
// bits of a tile's overlay mask
constexpr int kWpShift = kAgents;                // 16..23
constexpr int kSlShift = kAgents + kWaypoints;   // 24..27
constexpr int kEgoBit = kSlShift + kLights;      // 28

static_assert(kThreads >= kAgents * 8,
              "the block loads its 128 agent floats with one thread each");
static_assert(kTile * kTile == 32 * kLanePix, "a warp covers one tile");

struct Params {
  float m_per_px;    // fov / res
  float half_res;    // (res - 1) / 2
  float thick2;      // stopline half thickness squared
  float wp_r2;       // waypoint radius squared
  float len2_eps;    // floor of a segment's squared length
  float bg[3], road[3], wp[3], npc[3], ego[3];
};

// World coordinates of the point at image (row, col), heading up, row 0
// ahead. Integer arguments give pixel centres.
__device__ __forceinline__ void image_world(float row, float col, float ex,
                                            float ey, float ec, float es,
                                            int left_handed, const Params& p,
                                            float& x, float& y) {
  const float fwd = -(row - p.half_res) * p.m_per_px;
  float rgt = (col - p.half_res) * p.m_per_px;
  if (left_handed) rgt = -rgt;
  x = ex + fwd * ec + rgt * es;
  y = ey + fwd * es - rgt * ec;
}

// Squared distance from (x, y) to the segment a + t*s, t in [0, 1], with
// inv = 1 / max(|s|^2, eps): the twin's expression, operand for operand.
__device__ __forceinline__ float seg_dist2(float x, float y, float ax,
                                           float ay, float sx, float sy,
                                           float inv) {
  const float relx = x - ax, rely = y - ay;
  const float tt = fminf(fmaxf((relx * sx + rely * sy) * inv, 0.0f), 1.0f);
  const float dx = relx - tt * sx, dy = rely - tt * sy;
  return dx * dx + dy * dy;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
render_obs_kernel(const float* __restrict__ seg_data,
                  const int* __restrict__ town, const int* __restrict__ ci,
                  const int* __restrict__ cj, const int* __restrict__ nseg_in,
                  const float* __restrict__ env_block,
                  const float* __restrict__ agent_block,
                  const float* __restrict__ wp_block,
                  uint8_t* __restrict__ out,
                  int n_town, int n_cell, int k_rows, int left_handed,
                  Params p) {
  // staged survivors: s_a[j] = (ax, ay, sx, sy),
  // s_c[j] = (1/len^2, sign(hw)*hw^2, tile reach^2, 0)
  extern __shared__ __align__(16) float4 s_dyn[];
  float4* s_a = s_dyn;
  float4* s_c = s_dyn + k_rows;
  __shared__ float s_env[64];
  __shared__ float s_agent[kAgents * 8];
  __shared__ float s_wp[kWaypoints * 8];
  __shared__ float s_sl[kLights * 4];            // sx, sy, 1/len^2, active
  __shared__ int s_nsurv;
  __shared__ int s_next;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = min(max(town[b], 0), n_town - 1);
  const int c0 = min(max(ci[b], 0), n_cell - 1);
  const int c1 = min(max(cj[b], 0), n_cell - 1);
  const int nseg = min(max(nseg_in[b], 0), k_rows);
  const float* rows =
      seg_data + ((((size_t)t * n_cell + c0) * n_cell + c1) * k_rows) * 8;

  if (tid < 64) {
    s_env[tid] = env_block[(size_t)b * 64 + tid];
    s_wp[tid] = wp_block[(size_t)b * kWaypoints * 8 + tid];
  }
  if (tid < kAgents * 8) s_agent[tid] = agent_block[(size_t)b * kAgents * 8 + tid];
  if (tid == 0) {
    s_nsurv = 0;
    s_next = 0;
  }
  __syncthreads();

  const float ex = s_env[0], ey = s_env[1], ec = s_env[2], es = s_env[3];
  // pixel centres lie |ego (cos, sin)| apart per metre of image offset
  const float ego_n2 = ec * ec + es * es;
  const float ego_n = sqrtf(ego_n2);
  const float r_frame = p.half_res * p.m_per_px * kSqrt2 * ego_n + kCullMargin;
  const float r_tile =
      0.5f * (float)(kTile - 1) * p.m_per_px * kSqrt2 * ego_n + kCullMargin;

  if (tid < kLights) {
    const float* sl = s_env + (2 + tid) * 8;
    const float sx = sl[2] - sl[0], sy = sl[3] - sl[1];
    s_sl[tid * 4 + 0] = sx;
    s_sl[tid * 4 + 1] = sy;
    s_sl[tid * 4 + 2] = 1.0f / fmaxf(sx * sx + sy * sy, p.len2_eps);
    s_sl[tid * 4 + 3] = sl[7];
  }

  // 1. stage the segments that can reach the frame
  for (int s0 = tid - lane; s0 < nseg; s0 += kThreads) {
    const int s = s0 + lane;
    bool keep = false;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c = a;
    if (s < nseg) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(rows) + 2 * s);
      const float shw2 = __ldg(rows + (size_t)s * 8 + 4);
      a.x = r.x;
      a.y = r.y;
      a.z = r.z - r.x;
      a.w = r.w - r.y;
      c.x = 1.0f / fmaxf(a.z * a.z + a.w * a.w, p.len2_eps);
      c.y = shw2;
      if (shw2 >= 0.0f) {
        const float hw = sqrtf(shw2);
        const float rf = hw + r_frame, rt = hw + r_tile;
        c.z = rt * rt;
        keep = seg_dist2(ex, ey, a.x, a.y, a.z, a.w, c.x) <= rf * rf;
      }
    }
    const unsigned m = __ballot_sync(kFull, keep);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&s_nsurv, __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (keep) {
      const int j = base + __popc(m & ((1u << lane) - 1u));
      s_a[j] = a;
      s_c[j] = c;
    }
  }
  __syncthreads();
  const int nsurv = s_nsurv;

  const float wp_r = sqrtf(p.wp_r2) + r_tile;
  const float sl_r = sqrtf(p.thick2) + r_tile;
  uint8_t* out_b = out + (size_t)b * 3 * kPix;

  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(&s_next, 1);
    tile = __shfl_sync(kFull, tile, 0);
    if (tile >= kTiles) break;

    const int row0 = (tile / kTilesPerSide) * kTile + (lane >> 2) * 2;
    const int col0 = (tile % kTilesPerSide) * kTile + (lane & 3) * 4;
    float px[kLanePix], py[kLanePix];
#pragma unroll
    for (int k = 0; k < kLanePix; ++k)
      image_world((float)(row0 + k / 4), (float)(col0 + k % 4), ex, ey, ec,
                  es, left_handed, p, px[k], py[k]);
    float tcx, tcy;                              // the tile's centre
    image_world((float)((tile / kTilesPerSide) * kTile) + 0.5f * (kTile - 1),
                (float)((tile % kTilesPerSide) * kTile) + 0.5f * (kTile - 1),
                ex, ey, ec, es, left_handed, p, tcx, tcy);

    // 2. road: cull 32 staged segments at a time, test the candidates
    unsigned road = 0u;
    for (int j0 = 0; j0 < nsurv; j0 += 32) {
      const int j = j0 + lane;
      bool reach = false;
      if (j < nsurv) {
        const float4 a = s_a[j], c = s_c[j];
        reach = seg_dist2(tcx, tcy, a.x, a.y, a.z, a.w, c.x) <= c.z;
      }
      unsigned m = __ballot_sync(kFull, reach);
      while (m) {
        const int jj = j0 + __ffs(m) - 1;
        m &= m - 1u;
        const float4 a = s_a[jj], c = s_c[jj];
#pragma unroll
        for (int k = 0; k < kLanePix; ++k)
          road |= (unsigned)(seg_dist2(px[k], py[k], a.x, a.y, a.z, a.w,
                                       c.x) <= c.y) << k;
      }
      if (__all_sync(kFull, road == (1u << kLanePix) - 1u)) break;
    }

    // 3. overlays: one bit per primitive that can reach the tile
    bool reach = false;
    if (lane < kAgents) {
      const float* r = s_agent + lane * 8;
      const float dx = tcx - r[0], dy = tcy - r[1];
      const float n2 = r[2] * r[2] + r[3] * r[3];
      const float lim = sqrtf(r[4] * r[4] + r[5] * r[5]) + r_tile * sqrtf(n2);
      reach = (r[6] > 0.0f) && ((dx * dx + dy * dy) * n2 <= lim * lim);
    } else if (lane < kSlShift) {
      const float* r = s_wp + (lane - kWpShift) * 8;
      const float dx = tcx - r[0], dy = tcy - r[1];
      reach = (r[2] > 0.0f) && (dx * dx + dy * dy <= wp_r * wp_r);
    } else if (lane < kEgoBit) {
      const int l = lane - kSlShift;
      const float* sl = s_env + (2 + l) * 8;
      reach = (s_sl[l * 4 + 3] > 0.0f) &&
              (seg_dist2(tcx, tcy, sl[0], sl[1], s_sl[l * 4 + 0],
                         s_sl[l * 4 + 1], s_sl[l * 4 + 2]) <= sl_r * sl_r);
    } else if (lane == kEgoBit) {
      const float dx = tcx - ex, dy = tcy - ey;
      const float lim =
          sqrtf(s_env[4] * s_env[4] + s_env[5] * s_env[5]) + r_tile * ego_n;
      reach = (dx * dx + dy * dy) * ego_n2 <= lim * lim;
    }
    const unsigned cm = __ballot_sync(kFull, reach);

    unsigned wp_hit = 0u, npc_hit = 0u, ego_hit = 0u;
    unsigned sl_sel = 0u;            // 4 bits per pixel: winning stopline + 1
    for (unsigned m = (cm >> kWpShift) & ((1u << kWaypoints) - 1u); m;
         m &= m - 1u) {
      const float* r = s_wp + (__ffs(m) - 1) * 8;
      const float wx = r[0], wy = r[1];
#pragma unroll
      for (int k = 0; k < kLanePix; ++k) {
        const float dx = px[k] - wx, dy = py[k] - wy;
        wp_hit |= (unsigned)(dx * dx + dy * dy < p.wp_r2) << k;
      }
    }
    for (unsigned m = cm & ((1u << kAgents) - 1u); m; m &= m - 1u) {
      const float* r = s_agent + (__ffs(m) - 1) * 8;
      const float cx = r[0], cy = r[1], cc = r[2], cs = r[3], hl = r[4],
                  hw = r[5];
#pragma unroll
      for (int k = 0; k < kLanePix; ++k) {
        const float relx = px[k] - cx, rely = py[k] - cy;
        const float lx = relx * cc + rely * cs;
        const float ly = -relx * cs + rely * cc;
        npc_hit |= (unsigned)((fabsf(lx) <= hl) && (fabsf(ly) <= hw)) << k;
      }
    }
    if ((cm >> kEgoBit) & 1u) {
      const float hl = s_env[4], hw = s_env[5];
#pragma unroll
      for (int k = 0; k < kLanePix; ++k) {
        const float erx = px[k] - ex, ery = py[k] - ey;
        const float elx = erx * ec + ery * es;
        const float ely = -erx * es + ery * ec;
        ego_hit |= (unsigned)((fabsf(elx) <= hl) && (fabsf(ely) <= hw)) << k;
      }
    }
    // descending, so the nearest stopline (lowest index) wins on overlap
    for (unsigned m = (cm >> kSlShift) & ((1u << kLights) - 1u); m;) {
      const int l = 31 - __clz(m);
      m &= ~(1u << l);
      const float* sl = s_env + (2 + l) * 8;
      const float ax = sl[0], ay = sl[1], sx = s_sl[l * 4 + 0],
                  sy = s_sl[l * 4 + 1], inv = s_sl[l * 4 + 2];
#pragma unroll
      for (int k = 0; k < kLanePix; ++k)
        if (seg_dist2(px[k], py[k], ax, ay, sx, sy, inv) < p.thick2)
          sl_sel = (sl_sel & ~(0xFu << (4 * k))) | ((unsigned)(l + 1) << (4 * k));
    }

    // 4. composite in the twin's order; one 32-bit store per row and plane
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t word = 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = r * 4 + c;
          float v = p.bg[ch];
          if ((road >> k) & 1u) v = p.road[ch];
          if ((wp_hit >> k) & 1u) v = p.wp[ch];
          const unsigned sl = (sl_sel >> (4 * k)) & 0xFu;
          if (sl) v = s_env[(1 + sl) * 8 + 4 + ch];
          if ((npc_hit >> k) & 1u) v = p.npc[ch];
          if ((ego_hit >> k) & 1u) v = p.ego[ch];
          word |= (uint32_t)(uint8_t)(int)v << (8 * c);
        }
        *reinterpret_cast<uint32_t*>(out_b + ch * kPix + (row0 + r) * kRes +
                                     col0) = word;
      }
    }
  }
}

Params unpack_params(const float* q) {
  Params p;
  p.m_per_px = *q++;
  p.half_res = *q++;
  p.thick2 = *q++;
  p.wp_r2 = *q++;
  p.len2_eps = *q++;
  for (int c = 0; c < 3; ++c) p.bg[c] = *q++;
  for (int c = 0; c < 3; ++c) p.road[c] = *q++;
  for (int c = 0; c < 3; ++c) p.wp[c] = *q++;
  for (int c = 0; c < 3; ++c) p.npc[c] = *q++;
  for (int c = 0; c < 3; ++c) p.ego[c] = *q++;
  return p;
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() after
// the launch: 0 when it was accepted. `seg_data` and `out` must be 16-byte
// aligned (the kernel loads and stores whole words).

int tde_render_obs(const float* seg_data, const int* town, const int* ci,
                   const int* cj, const int* nseg, const float* env_block,
                   const float* agent_block, const float* wp_block,
                   uint8_t* out, int batch, int n_town, int n_cell,
                   int k_rows, int left_handed, const float* params,
                   void* stream) {
  const size_t smem = (size_t)k_rows * 2 * sizeof(float4);
  render_obs_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      seg_data, town, ci, cj, nseg, env_block, agent_block, wp_block, out,
      n_town, n_cell, k_rows, left_handed, unpack_params(params));
  return (int)cudaGetLastError();
}

const char* tde_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
