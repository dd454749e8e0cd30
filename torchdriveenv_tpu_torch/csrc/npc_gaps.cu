// The NPCs' nearest obstacle and nearest blocking stopline, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this in plain jnp
// (torchdriveenv_tpu/npc/route_follow.py, leader_gaps and light_gaps), and
// the port's plain twin is npc/route_follow.py:leader_gaps + light_gaps.
// It writes, per agent i of env b, what those two return together:
//   leader_gap (B, A)  the gap to the nearest obstacle ahead, +inf if none;
//   leader_v   (B, A)  that obstacle's speed projected on i's heading, 0 if
//                      there is none (or its gap is not finite);
//   light_gap  (B, A)  the gap to the nearest blocking stopline ahead, +inf
//                      if none applies.
// The twin builds (B, A, A) pair tiles and (B, A, L) stopline tiles in about
// 85 elementwise passes through device memory; the kernel keeps every pair
// in registers and writes 12 bytes an agent.
//
// What bounds it on the card: f32 instruction throughput, not bytes. At
// 4096 envs x 96 agents it reads ~11 MB and writes ~5 MB (about 5 us at
// 3.35 TB/s), against 37.7 M pairs of up to ~60 f32 operations and one cosf
// each.
//
// Design (one block per env, grid = B):
//   - A block of round_up(min(A, kChunk), 32) threads; thread t owns agent
//     i = i0 + t for each row of kChunk agents (one row at the benchmark's
//     A = 96).
//   - The candidates j are staged in shared memory kChunk at a time (x, y,
//     heading, speed, velocity, length, presence), and the stoplines of the
//     env's town likewise (midpoint, approach heading, mask & red).
//   - Thread i walks j = 0 .. A-1 in order and keeps the running minimum of
//     the obstacle gap under a strict <, which is argmin's first-minimum
//     rule (a NaN gap wins once and is kept, as amin and argmin keep the
//     first NaN); then walks the stoplines the same way.
//
// Bit-equality with the twin: every value goes through the twin's
// expression with the same operands in the same order (a commutative swap
// at most), cosf / sinf as torch's cos / sin call them (cos(psi_j - psi_i)
// per pair, not the angle-sum identity), clamps that pass NaN through as
// torch's do, IEEE division, and the file is built with --fmad=false so no
// multiply-add is contracted. Constants arrive as f32, rounded as torch
// rounds a Python scalar against an f32 tensor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;     // agents a block owns at once; candidates and
                                // stoplines staged at once

struct Params {
  float leader_range, leader_lat, same_dir_cos;
  float emerg_base, emerg_headway, emerg_range, emerg_lat, emerg_lat_slope;
  float closing_floor, tc_max, oncoming_cos, oncoming_lat, closing_min;
  float light_range, light_lat, aligned_cos, stop_margin;
};

// torch's clamp(x, min=lo) and clamp(x, lo, hi) on the card: NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// Keeps the first minimum, and the first NaN for good (amin / argmin).
__device__ __forceinline__ bool better(float g, float best) {
  return !isnan(best) && (g < best || isnan(g));
}

__global__ void __launch_bounds__(kChunk)
npc_gaps_kernel(const float* __restrict__ states,
                const float* __restrict__ attrs,
                const uint8_t* __restrict__ present,
                const int* __restrict__ town,
                const uint8_t* __restrict__ red,
                const float* __restrict__ stop_p0,
                const float* __restrict__ stop_p1,
                const float* __restrict__ stop_dir,
                const uint8_t* __restrict__ light_mask,
                float* __restrict__ leader_gap, float* __restrict__ leader_v,
                float* __restrict__ light_gap, int n_agents, int attr_dim,
                int n_lights, Params p) {
  __shared__ float s_px[kChunk], s_py[kChunk], s_psi[kChunk], s_v[kChunk];
  __shared__ float s_velx[kChunk], s_vely[kChunk], s_len[kChunk];
  __shared__ uint8_t s_pres[kChunk];
  __shared__ float s_mx[kChunk], s_my[kChunk], s_dir[kChunk];
  __shared__ uint8_t s_on[kChunk];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* st = states + (size_t)b * n_agents * 4;
  const float* at = attrs + (size_t)b * n_agents * attr_dim;
  const uint8_t* pr = present + (size_t)b * n_agents;
  const int tw = town[b];

  for (int i0 = 0; i0 < n_agents; i0 += blockDim.x) {
    const int i = i0 + tid;
    const bool live = i < n_agents;
    float pxi = 0.0f, pyi = 0.0f, psii = 0.0f, vi = 0.0f, leni = 0.0f;
    bool presi = false;
    if (live) {
      pxi = st[i * 4 + 0];
      pyi = st[i * 4 + 1];
      psii = st[i * 4 + 2];
      vi = st[i * 4 + 3];
      leni = at[i * attr_dim];
      presi = pr[i] != 0;
    }
    // f = (cos, sin), l = (-sin, cos) of the heading
    const float fx = cosf(psii), fy = sinf(psii);
    const float lx = -fy, ly = fx;
    const float velxi = vi * fx, velyi = vi * fy;
    const float emerg_d = clamp_min(p.emerg_base + p.emerg_headway * vi,
                                    p.emerg_range);

    float best = INFINITY, best_v = 0.0f;
    for (int j0 = 0; j0 < n_agents; j0 += kChunk) {
      const int jn = min(kChunk, n_agents - j0);
      __syncthreads();
      for (int k = tid; k < jn; k += blockDim.x) {
        const int j = j0 + k;
        const float psij = st[j * 4 + 2], vj = st[j * 4 + 3];
        s_px[k] = st[j * 4 + 0];
        s_py[k] = st[j * 4 + 1];
        s_psi[k] = psij;
        s_v[k] = vj;
        s_velx[k] = vj * cosf(psij);
        s_vely[k] = vj * sinf(psij);
        s_len[k] = at[j * attr_dim];
        s_pres[k] = pr[j];
      }
      __syncthreads();
      if (!live || !presi) continue;
      for (int k = 0; k < jn; ++k) {
        if (!s_pres[k] || j0 + k == i) continue;
        const float relx = s_px[k] - pxi, rely = s_py[k] - pyi;
        const float lon = relx * fx + rely * fy;
        if (!(lon > 0.0f)) continue;
        const float lat = relx * lx + rely * ly;
        const float cospsi = cosf(s_psi[k] - psii);
        // cruising leader: same-direction traffic ahead in the lane corridor
        const bool is_leader = lon < p.leader_range
            && fabsf(lat) < p.leader_lat && cospsi > p.same_dir_cos;
        bool is_emerg = false;
        if (!is_leader && lon < emerg_d) {
          // emergency obstacle: directly ahead in a cone, or an oncoming
          // agent on a predicted miss inside one lane width
          if (cospsi < p.oncoming_cos) {
            const float vrelx = s_velx[k] - velxi, vrely = s_vely[k] - velyi;
            const float vrel_lon = vrelx * fx + vrely * fy;
            const float vrel_lat = vrelx * lx + vrely * ly;
            const float closing = -vrel_lon;
            const float tc = clamp(lon / clamp_min(closing, p.closing_floor),
                                   0.0f, p.tc_max);
            const float lat_pred = lat + vrel_lat * tc;
            is_emerg = fabsf(lat_pred) < p.oncoming_lat
                && closing > p.closing_min;
          } else {
            is_emerg = fabsf(lat) < p.emerg_lat + p.emerg_lat_slope * lon;
          }
        }
        if (!(is_leader || is_emerg)) continue;
        const float gap = lon - (leni + s_len[k]) / 2.0f;
        if (better(gap, best)) {
          best = gap;
          best_v = s_v[k] * cospsi;
        }
      }
    }

    // stoplines of the env's town, non-green ones only
    const float half_len = leni / 2.0f;
    float lbest = INFINITY;
    for (int l0 = 0; l0 < n_lights; l0 += kChunk) {
      const int ln = min(kChunk, n_lights - l0);
      __syncthreads();
      for (int k = tid; k < ln; k += blockDim.x) {
        const size_t l = (size_t)tw * n_lights + l0 + k;
        s_mx[k] = (stop_p0[l * 2 + 0] + stop_p1[l * 2 + 0]) / 2.0f;
        s_my[k] = (stop_p0[l * 2 + 1] + stop_p1[l * 2 + 1]) / 2.0f;
        s_dir[k] = stop_dir[l];
        s_on[k] = light_mask[l] && red[(size_t)b * n_lights + l0 + k];
      }
      __syncthreads();
      if (!live) continue;
      for (int k = 0; k < ln; ++k) {
        if (!s_on[k]) continue;
        const float relx = s_mx[k] - pxi, rely = s_my[k] - pyi;
        const float sl_lon = relx * fx + rely * fy;
        if (!(sl_lon > 0.0f && sl_lon < p.light_range)) continue;
        const float sl_lat = relx * lx + rely * ly;
        if (!(fabsf(sl_lat) < p.light_lat)) continue;
        if (!(cosf(psii - s_dir[k]) > p.aligned_cos)) continue;
        const float g = (sl_lon - half_len) - p.stop_margin;
        if (better(g, lbest)) lbest = g;
      }
    }

    if (live) {
      const size_t o = (size_t)b * n_agents + i;
      leader_gap[o] = best;
      leader_v[o] = isfinite(best) ? best_v : 0.0f;
      light_gap[o] = lbest;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() after
// the launch: 0 when it was accepted. `params` holds the 17 f32 constants of
// Params in order.

int tde_npc_gaps(const float* states, const float* attrs,
                 const uint8_t* present, const int* town, const uint8_t* red,
                 const float* stop_p0, const float* stop_p1,
                 const float* stop_dir, const uint8_t* light_mask,
                 float* leader_gap, float* leader_v, float* light_gap,
                 int batch, int n_agents, int attr_dim, int n_lights,
                 const float* params, void* stream) {
  Params p;
  float* q = reinterpret_cast<float*>(&p);
  for (size_t k = 0; k < sizeof(Params) / sizeof(float); ++k) q[k] = params[k];
  const int rows = n_agents < kChunk ? n_agents : kChunk;
  const int threads = (rows + 31) / 32 * 32;
  npc_gaps_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(
      states, attrs, present, town, red, stop_p0, stop_p1, stop_dir,
      light_mask, leader_gap, leader_v, light_gap, n_agents, attr_dim,
      n_lights, p);
  return (int)cudaGetLastError();
}

const char* tde_npc_gaps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
