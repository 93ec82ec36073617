// First design of this kernel, kept unchanged as a timing baseline:
// chip_smoke.py builds it beside crowdnav_tpu_torch/kernels/csrc/track_cp_topk.cu
// and reports its device time as first_design_device_ms_*.
//
// Tracker -> collision probability -> top-K chain for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of crowdnav_tpu/ops/risk_pallas.py
// (launched by `track_cp_topk_batch`), with the arithmetic of the XLA chain
// risk.update_tracks -> collision_probabilities -> select_top_k under the
// default quirks policy. The plain version is `track_cp_topk` in
// crowdnav_tpu_torch/ops/risk.py; the wrapper is
// crowdnav_tpu_torch/ops/risk_kernel.py.
//
// Per env:
//   1. the 3-decimal box IOU of each of the T tracks with each of the S
//      confirmed segments, and the first-index argmax (jnp.argmax order);
//   2. the matched tracks' update, velocity (prev - curr) / dt;
//   3. unclaimed obstacle segments inserted into free slots by rank, with
//      the -1 speed sentinel;
//   4. collision-cone TTC -> CP mixed with the distance CP, per track;
//   5. the stable top-K by CP (ties to the lower slot, as lax.top_k),
//      padded with the robot pose; cp_max and ego_cp.
//
// Design: one warp per env, no shared memory. S <= 32, so in phase 1 the
// lane is the segment: each of the T tracks is broadcast to the warp and
// its argmax is a shuffle reduction with an exact lowest-index tie-break.
// Then the lane is the track (T <= 32): claimed segments are an OR
// reduction of bit masks, free-slot and obstacle ranks are __ballot_sync /
// __popc prefix counts, the values of matched and inserted segments come
// over __shfl_sync, and the top-K rank of a track is the number of tracks
// that beat it. Inputs and outputs are the natural (N,S), (N,T), (N,K)
// row-major tensors; bool tensors are one byte per element.
//
// Numerics (crowdnav_tpu_torch/utils/numerics.py): built with -fmad=false;
// fmaf only where the reference's compiler fuses; round(x, 3) is
// rintf(x * 1000) * 0.001f; divisions by the constant dt are products with
// inv_dt = f32(1/f32(dt)); IEEE division and sqrtf elsewhere.
//
// Bound: at 16,384 envs the kernel reads about 26.5 MB (segments, tracks,
// robot poses) and writes about 18.5 MB (tracks, top-K, two scalars), so
// about 13 us of memory time at 3.35 TB/s; its arithmetic (T x S IOUs, T^2
// rank compares per env, ~25 M flops in all) is far below that.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Consts {
  float side;        // f32(2 * ped_radius)
  float two_side2;   // f32(2 * side * side)
  float inv_dt;      // f32(1 / f32(dt))
  float bw2;         // f32(collision_body_width^2)
  float w_ttc;       // f32(cp_ttc_weight)
  float w_dist;      // f32(cp_dist_weight)
  float max_range;   // f32(max_scan_range)
  float inv_range;   // f32(1 / max(f32(max - min), f32(1e-9)))
};

__global__ void track_cp_topk_kernel(
    const uint8_t* __restrict__ seg_conf, const uint8_t* __restrict__ seg_obs,
    const float* __restrict__ seg_pos, const float* __restrict__ seg_dist,
    const uint8_t* __restrict__ t_valid, const float* __restrict__ t_pos,
    const float* __restrict__ t_prev, const float* __restrict__ t_dist,
    const float* __restrict__ t_speed, const float* __restrict__ t_vel,
    const float* __restrict__ r_pos, const float* __restrict__ r_prev,
    const uint8_t* __restrict__ compute_cp, uint8_t* __restrict__ o_valid,
    float* __restrict__ o_pos, float* __restrict__ o_prev,
    uint8_t* __restrict__ o_has_prev, float* __restrict__ o_dist,
    float* __restrict__ o_speed, float* __restrict__ o_vel,
    float* __restrict__ top_cp, float* __restrict__ top_pv,
    float* __restrict__ cp_max, float* __restrict__ ego_cp, int n_envs,
    int S, int T, int K, Consts c) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (env >= n_envs) return;  // whole warps leave together
  const float inf = __int_as_float(0x7f800000);

  // ---- phase 1: lane = segment ----
  const size_t sb = (size_t)env * S;
  const bool has_seg = lane < S;
  const bool conf = has_seg && seg_conf[sb + lane];
  const bool is_obs = has_seg && seg_obs[sb + lane];
  const float cx = has_seg ? seg_pos[2 * (sb + lane)] : 0.f;
  const float cy = has_seg ? seg_pos[2 * (sb + lane) + 1] : 0.f;
  const float cd = has_seg ? seg_dist[sb + lane] : 0.f;

  const size_t tb = (size_t)env * T;
  int my_best = 0;          // argmax segment of track `lane`
  float my_best_iou = -1.f;
  for (int t = 0; t < T; ++t) {
    const float px = t_pos[2 * (tb + t)], py = t_pos[2 * (tb + t) + 1];
    float v;
    if (has_seg) {
      const float ddx = fabsf(px - cx), ddy = fabsf(py - cy);
      const float inter = fmaxf(c.side - ddx, 0.f) * fmaxf(c.side - ddy, 0.f);
      const float uni = c.two_side2 - inter;
      const float iou = rintf((inter / uni) * 1000.f) * 0.001f;
      v = conf ? iou : -1.f;
    } else {
      v = -inf;
    }
    int j = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, off);
      const int oj = __shfl_xor_sync(kFull, j, off);
      if (ov > v || (ov == v && oj < j)) {
        v = ov;
        j = oj;
      }
    }
    if (lane == t) {
      my_best = j;
      my_best_iou = v;
    }
  }

  // ---- phase 2: lane = track ----
  const bool has_trk = lane < T;
  const size_t ti = tb + (has_trk ? lane : 0);
  const bool valid = has_trk && t_valid[ti];
  const float px = has_trk ? t_pos[2 * ti] : 0.f;
  const float py = has_trk ? t_pos[2 * ti + 1] : 0.f;
  const bool matched = valid && my_best_iou > 0.f;
  const float nx = __shfl_sync(kFull, cx, my_best);
  const float ny = __shfl_sync(kFull, cy, my_best);
  const float nd = __shfl_sync(kFull, cd, my_best);
  const float delx = px - nx, dely = py - ny;  // prev - curr
  const float speed = sqrtf(fmaf(dely, dely, delx * delx)) * c.inv_dt;

  float f_px = px, f_py = py, f_prx = 0.f, f_pry = 0.f, f_dist = 0.f;
  float f_speed = 0.f, f_vx = 0.f, f_vy = 0.f;
  if (has_trk) {
    f_prx = t_prev[2 * ti];
    f_pry = t_prev[2 * ti + 1];
    f_dist = t_dist[ti];
    f_speed = t_speed[ti];
    f_vx = t_vel[2 * ti];
    f_vy = t_vel[2 * ti + 1];
  }
  if (matched) {
    f_prx = px;
    f_pry = py;
    f_px = nx;
    f_py = ny;
    f_dist = nd;
    f_speed = speed;
    f_vx = delx * c.inv_dt;
    f_vy = dely * c.inv_dt;
  }

  // insertion: the r-th free slot takes the r-th unclaimed obstacle
  const unsigned claimed =
      __reduce_or_sync(kFull, matched ? (1u << my_best) : 0u);
  const unsigned insert_mask =
      __ballot_sync(kFull, is_obs && !((claimed >> lane) & 1u));
  const bool free_slot = has_trk && !matched;
  const unsigned free_mask = __ballot_sync(kFull, free_slot);
  const int free_rank = __popc(free_mask & ((1u << lane) - 1u));
  const bool inserted = free_slot && free_rank < __popc(insert_mask);
  int src = 0;
  if (inserted) {
    unsigned m = insert_mask;
    for (int r = 0; r < free_rank; ++r) m &= m - 1u;
    src = __ffs(m) - 1;
  }
  const float ix = __shfl_sync(kFull, cx, src);
  const float iy = __shfl_sync(kFull, cy, src);
  const float id = __shfl_sync(kFull, cd, src);
  if (inserted) {
    f_px = ix;
    f_py = iy;
    f_prx = ix;
    f_pry = iy;
    f_dist = id;
    f_speed = -1.f;  // fresh-track sentinel
    f_vx = 0.f;
    f_vy = 0.f;
  }
  const bool f_valid = matched || inserted;
  const bool f_has_prev = matched && !inserted;

  // ---- phase 3: collision probability of track `lane` ----
  const float rx = r_pos[2 * env], ry = r_pos[2 * env + 1];
  const float prx = r_prev[2 * env], pry = r_prev[2 * env + 1];
  const float mdx = rx - prx, mdy = ry - pry;
  const float agent_speed = sqrtf(fmaf(mdy, mdy, mdx * mdx)) * c.inv_dt;
  const float hp = f_has_prev ? 1.f : 0.f;
  const float relx = (rx + (f_prx - f_px) * hp) - prx;
  const float rely = (ry + (f_pry - f_py) * hp) - pry;
  const float nrm = fmaxf(sqrtf(fmaf(rely, rely, relx * relx)), 1e-9f);
  const float ux = relx / nrm, uy = rely / nrm;
  const float ocx = f_px - prx, ocy = f_py - pry;
  const float bb = fmaf(ocy, uy, ocx * ux);
  const float d2 = fmaf(-bb, bb, fmaf(ocy, ocy, ocx * ocx));
  const float disc = c.bw2 - d2;
  const bool hit = disc >= 0.f;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float dist_cp = hit ? fminf(fabsf(bb - sq), fabsf(bb + sq)) : inf;
  const float resultant = agent_speed - f_speed;
  const bool still = resultant == 0.f;
  const float ttc = dist_cp / (still ? 1.f : resultant);
  const float ttc_nz = ttc == 0.f ? inf : ttc;
  const float cp_raw = fminf(0.15f / ttc_nz, 1.f);
  const float cp_ttc = (hit && !still) ? cp_raw : 0.f;
  const float gcp =
      f_dist > c.max_range ? 0.f : (c.max_range - f_dist) * c.inv_range;
  float cp = (hit && still) ? gcp : fmaf(c.w_ttc, cp_ttc, c.w_dist * gcp);
  cp = f_valid ? cp : 0.f;
  const float ego = (f_valid && hit && !still) ? cp_ttc : 0.f;

  if (has_trk) {
    o_valid[ti] = f_valid;
    o_pos[2 * ti] = f_px;
    o_pos[2 * ti + 1] = f_py;
    o_prev[2 * ti] = f_prx;
    o_prev[2 * ti + 1] = f_pry;
    o_has_prev[ti] = f_has_prev;
    o_dist[ti] = f_dist;
    o_speed[ti] = f_speed;
    o_vel[2 * ti] = f_vx;
    o_vel[2 * ti + 1] = f_vy;
  }

  // ---- phase 4: stable top-K ----
  const bool any_track = __ballot_sync(kFull, f_valid) != 0u;
  const bool live = compute_cp[env] && any_track;
  const float score = f_valid ? cp : -inf;
  int rank = 0;
  for (int u = 0; u < T; ++u) {
    const float su = __shfl_sync(kFull, score, u);
    rank += (su > score || (su == score && u < lane)) ? 1 : 0;
  }
  const bool picked = live && f_valid;
  const float my_top = picked ? cp : 0.f;
  if (has_trk && rank < K) {
    const size_t kb = (size_t)env * K + rank;
    top_cp[kb] = my_top;
    top_pv[4 * kb] = picked ? f_px : rx;
    top_pv[4 * kb + 1] = picked ? f_py : ry;
    top_pv[4 * kb + 2] = picked ? f_vx : 0.f;
    top_pv[4 * kb + 3] = picked ? f_vy : 0.f;
  }
  float mx = (has_trk && rank < K) ? my_top : -inf;
  float me = has_trk ? ego : -inf;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    me = fmaxf(me, __shfl_xor_sync(kFull, me, off));
  }
  if (lane == 0) {
    cp_max[env] = live ? mx : 0.f;
    ego_cp[env] = live ? me : 0.f;
  }
}

}  // namespace

extern "C" int crowdnav_track_cp_topk(
    const uint8_t* seg_conf, const uint8_t* seg_obs, const float* seg_pos,
    const float* seg_dist, const uint8_t* t_valid, const float* t_pos,
    const float* t_prev, const float* t_dist, const float* t_speed,
    const float* t_vel, const float* r_pos, const float* r_prev,
    const uint8_t* compute_cp, uint8_t* o_valid, float* o_pos, float* o_prev,
    uint8_t* o_has_prev, float* o_dist, float* o_speed, float* o_vel,
    float* top_cp, float* top_pv, float* cp_max, float* ego_cp, int n_envs,
    int S, int T, int K, float side, float two_side2, float inv_dt,
    float bw2, float w_ttc, float w_dist, float max_range, float inv_range,
    void* stream) {
  if (n_envs == 0) return 0;
  const Consts c{side, two_side2, inv_dt, bw2, w_ttc, w_dist, max_range,
                 inv_range};
  const int warps_per_block = 4;
  const int blocks = (n_envs + warps_per_block - 1) / warps_per_block;
  track_cp_topk_kernel<<<blocks, 32 * warps_per_block, 0,
                         (cudaStream_t)stream>>>(
      seg_conf, seg_obs, seg_pos, seg_dist, t_valid, t_pos, t_prev, t_dist,
      t_speed, t_vel, r_pos, r_prev, compute_cp, o_valid, o_pos, o_prev,
      o_has_prev, o_dist, o_speed, o_vel, top_cp, top_pv, cp_max, ego_cp,
      n_envs, S, T, K, c);
  return (int)cudaGetLastError();
}
