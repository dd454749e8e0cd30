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
// Design (first version, simple and exact):
//   * one block of 256 threads per env (grid = B); the block reads its own
//     (town, ci, cj, nseg), which the TPU kernel got by scalar prefetch;
//   * the block stages that env's nseg segment rows in shared memory as
//     (ax, ay, sx, sy, 1/len^2, sign(hw)*hw^2), with the env, agent and
//     waypoint blocks and the per-stopline terms;
//   * thread t owns pixels p = t + 256*k, k = 0..15, keeps their world
//     coordinates in registers and scans all nseg segments for each, so one
//     shared-memory read of a segment serves 16 pixels;
//   * the three uint8 planes are written with coalesced byte stores.
// Rows past nseg are never read: in the compiled maps their
// sign(hw)*hw^2 is negative, so they cannot hit and the frame equals the
// full scan of the plain twin.
//
// Bit-equality with the plain twin (render_obs_torch): every float
// expression keeps the twin's operand order; division is IEEE (no fast
// math); the file is built with --fmad=false so no multiply-add is
// contracted into an FMA.
//
// What bounds it on the card: arithmetic. The road test costs 17 f32
// operations per pixel per segment, 4096 pixels x nseg per env: about
// 16.6 G operations for 4096 envs at the mean nseg of 58, against ~50 MB
// of output (about 15 us of HBM time). Without FMA each operation is one
// instruction. Faster designs (per-tile segment culling, several envs per
// block, packed stores) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRes = 64;
constexpr int kPix = kRes * kRes;
constexpr int kPixPerThread = kPix / kThreads;   // 16
constexpr int kAgents = 16;
constexpr int kWaypoints = 8;
constexpr int kLights = 4;
constexpr int kSegStride = 6;                    // staged floats per segment

struct Params {
  float m_per_px;    // fov / res
  float half_res;    // (res - 1) / 2
  float thick2;      // stopline half thickness squared
  float wp_r2;       // waypoint radius squared
  float len2_eps;    // floor of a segment's squared length
  float bg[3], road[3], wp[3], npc[3], ego[3];
};

// World coordinates of pixel `pix`'s center (heading up, row 0 ahead).
__device__ __forceinline__ void pixel_world(int pix, float ex, float ey,
                                            float ec, float es,
                                            int left_handed, const Params& p,
                                            float& x, float& y) {
  const float row = (float)(pix / kRes), col = (float)(pix % kRes);
  const float fwd = -(row - p.half_res) * p.m_per_px;
  float rgt = (col - p.half_res) * p.m_per_px;
  if (left_handed) rgt = -rgt;
  x = ex + fwd * ec + rgt * es;
  y = ey + fwd * es - rgt * ec;
}

__global__ void __launch_bounds__(kThreads)
render_obs_kernel(const float* __restrict__ seg_data,
                  const int* __restrict__ town, const int* __restrict__ ci,
                  const int* __restrict__ cj, const int* __restrict__ nseg_in,
                  const float* __restrict__ env_block,
                  const float* __restrict__ agent_block,
                  const float* __restrict__ wp_block,
                  uint8_t* __restrict__ out,
                  int n_town, int n_cell, int k_rows, int left_handed,
                  Params p) {
  extern __shared__ float s_seg[];               // (nseg, kSegStride)
  __shared__ float s_env[64];
  __shared__ float s_agent[kAgents * 8];
  __shared__ float s_wp[kWaypoints * 8];
  __shared__ float s_sl[kLights * 4];            // sx, sy, 1/len^2, active

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int t = min(max(town[b], 0), n_town - 1);
  const int c0 = min(max(ci[b], 0), n_cell - 1);
  const int c1 = min(max(cj[b], 0), n_cell - 1);
  const int nseg = min(max(nseg_in[b], 0), k_rows);
  const float* rows =
      seg_data + ((((size_t)t * n_cell + c0) * n_cell + c1) * k_rows) * 8;

  for (int s = tid; s < nseg; s += kThreads) {
    const float* r = rows + (size_t)s * 8;
    const float ax = r[0], ay = r[1];
    const float sx = r[2] - ax, sy = r[3] - ay;
    float* d = s_seg + s * kSegStride;
    d[0] = ax;
    d[1] = ay;
    d[2] = sx;
    d[3] = sy;
    d[4] = 1.0f / fmaxf(sx * sx + sy * sy, p.len2_eps);
    d[5] = r[4];
  }
  if (tid < 64) {
    s_env[tid] = env_block[(size_t)b * 64 + tid];
    s_wp[tid] = wp_block[(size_t)b * kWaypoints * 8 + tid];
  }
  if (tid < kAgents * 8) s_agent[tid] = agent_block[(size_t)b * kAgents * 8 + tid];
  __syncthreads();
  if (tid < kLights) {
    const float* sl = s_env + (2 + tid) * 8;
    const float sx = sl[2] - sl[0], sy = sl[3] - sl[1];
    s_sl[tid * 4 + 0] = sx;
    s_sl[tid * 4 + 1] = sy;
    s_sl[tid * 4 + 2] = 1.0f / fmaxf(sx * sx + sy * sy, p.len2_eps);
    s_sl[tid * 4 + 3] = sl[7];
  }
  __syncthreads();

  // the thread's pixel centers, kept in registers for the segment scan
  const float ex = s_env[0], ey = s_env[1], ec = s_env[2], es = s_env[3];
  float px[kPixPerThread], py[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k)
    pixel_world(tid + k * kThreads, ex, ey, ec, es, left_handed, p, px[k],
                py[k]);

  // road layer: any segment within its sign(hw)*hw^2
  unsigned road = 0u;
  for (int s = 0; s < nseg; ++s) {
    const float* d = s_seg + s * kSegStride;
    const float ax = d[0], ay = d[1], sx = d[2], sy = d[3], inv = d[4],
                shw2 = d[5];
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const float relx = px[k] - ax, rely = py[k] - ay;
      const float tt = fminf(fmaxf((relx * sx + rely * sy) * inv, 0.0f), 1.0f);
      const float dx = relx - tt * sx, dy = rely - tt * sy;
      road |= (unsigned)(dx * dx + dy * dy <= shw2) << k;
    }
  }

  // composite, in the order of the twin's _composite (the coordinates are
  // recomputed, identically, so px/py need no dynamic indexing)
  uint8_t* out_b = out + (size_t)b * 3 * kPix;
#pragma unroll 1
  for (int k = 0; k < kPixPerThread; ++k) {
    const int pix = tid + k * kThreads;
    float x, y;
    pixel_world(pix, ex, ey, ec, es, left_handed, p, x, y);
    bool wp_hit = false;
    for (int w = 0; w < kWaypoints; ++w) {
      const float* r = s_wp + w * 8;
      const float dx = x - r[0], dy = y - r[1];
      wp_hit |= (dx * dx + dy * dy < p.wp_r2) && (r[2] > 0.0f);
    }
    bool npc_hit = false;
    for (int a = 0; a < kAgents; ++a) {
      const float* r = s_agent + a * 8;
      const float relx = x - r[0], rely = y - r[1];
      const float lx = relx * r[2] + rely * r[3];
      const float ly = -relx * r[3] + rely * r[2];
      npc_hit |= (fabsf(lx) <= r[4]) && (fabsf(ly) <= r[5]) && (r[6] > 0.0f);
    }
    const float erx = x - ex, ery = y - ey;
    const float elx = erx * ec + ery * es;
    const float ely = -erx * es + ery * ec;
    const bool ego_hit = (fabsf(elx) <= s_env[4]) && (fabsf(ely) <= s_env[5]);
    // the nearest stopline (lowest index) wins on overlap
    int sl_win = -1;
    for (int l = kLights - 1; l >= 0; --l) {
      const float* sl = s_env + (2 + l) * 8;
      const float sx = s_sl[l * 4 + 0], sy = s_sl[l * 4 + 1];
      const float relx = x - sl[0], rely = y - sl[1];
      const float tt = fminf(
          fmaxf((relx * sx + rely * sy) * s_sl[l * 4 + 2], 0.0f), 1.0f);
      const float dx = relx - tt * sx, dy = rely - tt * sy;
      if ((dx * dx + dy * dy < p.thick2) && (s_sl[l * 4 + 3] > 0.0f)) sl_win = l;
    }
    const bool is_road = (road >> k) & 1u;
    for (int ch = 0; ch < 3; ++ch) {
      float v = p.bg[ch];
      if (is_road) v = p.road[ch];
      if (wp_hit) v = p.wp[ch];
      if (sl_win >= 0) v = s_env[(2 + sl_win) * 8 + 4 + ch];
      if (npc_hit) v = p.npc[ch];
      if (ego_hit) v = p.ego[ch];
      out_b[ch * kPix + pix] = (uint8_t)(int)v;
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t). Returns cudaGetLastError() after the
// launch: 0 when it was accepted.
int tde_render_obs(const float* seg_data, const int* town, const int* ci,
                   const int* cj, const int* nseg, const float* env_block,
                   const float* agent_block, const float* wp_block,
                   uint8_t* out, int batch, int n_town, int n_cell,
                   int k_rows, int left_handed, const float* params,
                   void* stream) {
  Params p;
  const float* q = params;
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
  const size_t smem = (size_t)k_rows * kSegStride * sizeof(float);
  render_obs_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      seg_data, town, ci, cj, nseg, env_block, agent_block, wp_block, out,
      n_town, n_cell, k_rows, left_handed, p);
  return (int)cudaGetLastError();
}

const char* tde_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
