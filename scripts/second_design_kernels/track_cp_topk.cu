// Tracker -> collision probability -> top-K chain for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of crowdnav_tpu/ops/risk_pallas.py
// (launched by `track_cp_topk_batch`), in three forms (kForm):
//   - kXla: the arithmetic of the XLA chain risk.update_tracks ->
//     collision_probabilities -> select_top_k under the default quirks
//     policy, which the JAX package's default risk backend runs;
//   - kStrict: the same chain under strict_quirks: every track's closing
//     speed is the first valid track's, and the top-K is the reference's
//     sorted(desc)[-K:] (the K lowest-CP tracks when more than K are
//     valid), reported in descending CP order;
//   - kPallas: the arithmetic of `_kernel` itself (risk_backend="pallas")
//     as the JAX package's CPU reference computes it, which sums the
//     squares of the track's motion, of the resultant line and of the
//     centre offset in the other order, multiplies the line by
//     1 / max(norm, 1e-9) instead of dividing, and fuses the robot's speed
//     into the resultant speed.
// The plain version of each form is `track_cp_topk(..., form)` in
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
// Bound: bytes. At 16,384 envs (S=32, T=24, K=8) the kernel reads 20.6 MB
// and writes 16.1 MB, 11 us at 3.35 TB/s; its arithmetic (T x S IOUs and
// T^2 rank compares per env, ~0.2 GFLOP) is a quarter of that. What the
// card actually spends, though, is instruction slots: one env's work is a
// few hundred warp instructions, and a quarter of the lanes (T = 24 of 32)
// idle in every one. So the design cuts instructions.
//
// Design: one warp per env, lane = segment for the segment rows and lane =
// track for everything else, E envs (warps) to a block (E from the
// wrapper, kernels/launch.py). Each lane loads its own elements of every
// field straight into registers: a warp's loads of one field are one
// contiguous run of 24 to 256 bytes, and the 13 loads are independent, so
// they are all in flight at once; the outputs go back the same way. (A
// version that staged each field's block range in shared memory, with
// 16-byte cp.async copies and then with one TMA bulk copy per field,
// measured slower: staging alone took longer than this whole kernel.)
// Segment positions and distances go to a per-warp row of shared memory,
// where every lane reads them by broadcast. Phase 1 walks the confirmed
// segments (a warp-uniform bit mask) and only marks which boxes overlap
// track `lane`'s: a box that misses scores exactly 0 (0 / uni), so the
// first confirmed segment holds the argmax at 0 until an overlapping one
// scores more, and the IOU division runs for the overlapping pairs alone,
// in a second, per-lane walk in index order. Claims, free-slot and
// obstacle ranks are __ballot_sync / __popc prefix counts; the r-th
// unclaimed obstacle reaches the r-th free slot through a per-warp table
// indexed by rank. The top-K rank of a track is the number of tracks with
// a higher score, read from a score row in shared memory, plus the
// lower-slot tracks with an equal score, from one __match_any_sync. The
// kernel is compiled for the repo's (S, T, K) = (32, 24, 8) and
// (32, 24, 1), so that loop bounds and row sizes fold, and for sizes
// taken at run time.
//
// Numerics (crowdnav_tpu_torch/utils/numerics.py): built with -fmad=false;
// fmaf only where the reference's compiler fuses; round(x, 3) is
// rintf(x * 1000) * 0.001f; divisions by the constant dt are products with
// inv_dt = f32(1/f32(dt)); IEEE division and sqrtf elsewhere.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kXla = 0, kStrict = 1, kPallas = 2;  // ops.risk.FORMS
constexpr int kIn = 13;
constexpr int kOut = 11;
constexpr int kMaxWarps = 16;  // blocks of at most 512 threads

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

// Global tensors in the order of track_cp_topk_fields (kernels/roofline.py):
// confirmed, is_obstacle, center_pos, center_dist, then the track fields
// valid, pos, prev_pos, dist, speed, vel, then robot_pos, robot_prev_pos,
// compute_cp; out: the new track fields valid, pos, prev_pos, has_prev,
// dist, speed, vel, then top_cp, top_pose_vel, cp_max, ego_cp.
struct Ptrs {
  const uint8_t* in[kIn];
  uint8_t* out[kOut];
};

template <typename V>
__device__ __forceinline__ V load(const uint8_t* base, size_t i) {
  return reinterpret_cast<const V*>(base)[i];
}

template <typename V>
__device__ __forceinline__ void store(uint8_t* base, size_t i, V v) {
  reinterpret_cast<V*>(base)[i] = v;
}

// kS, kT, kK: the sizes fixed at compile time, or 0 to take them at run
// time; kForm: kXla, kStrict or kPallas.
template <int kS, int kT, int kK, int kForm>
__global__ void __launch_bounds__(32 * kMaxWarps)
    track_cp_topk_kernel(Ptrs g, int n_envs, int S_rt, int T_rt, int K_rt,
                         Consts c) {
  const int S = kS ? kS : S_rt;
  const int T = kT ? kT : T_rt;
  const int K = kK ? kK : K_rt;
  __shared__ float2 pos_s[kMaxWarps][32];
  __shared__ float dist_s[kMaxWarps][32];
  __shared__ float score_s[kMaxWarps][32];
  __shared__ int seg_of_rank_s[kMaxWarps][32];
  // strict top-K: each track's rank and reorder key
  __shared__ int rank_s[kForm == kStrict ? kMaxWarps : 1][32];
  __shared__ float key_s[kForm == kStrict ? kMaxWarps : 1][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * (blockDim.x >> 5) + w;
  if (env >= n_envs) return;  // whole warps leave; no block barrier follows
  const float inf = __int_as_float(0x7f800000);

  // ---- loads: lane = segment, then lane = track ----
  const bool has_seg = lane < S, has_trk = lane < T;
  const size_t si = (size_t)env * S + lane, ti = (size_t)env * T + lane;
  bool conf = false, obs = false, valid = false;
  float2 cs = make_float2(0.f, 0.f), tp = cs, t_prev = cs, t_vel = cs;
  float cd = 0.f, t_dist = 0.f, t_speed = 0.f;
  if (has_seg) {
    conf = g.in[0][si];
    obs = g.in[1][si];
    cs = load<float2>(g.in[2], si);
    cd = load<float>(g.in[3], si);
  }
  if (has_trk) {
    valid = g.in[4][ti];
    tp = load<float2>(g.in[5], ti);
    t_prev = load<float2>(g.in[6], ti);
    t_dist = load<float>(g.in[7], ti);
    t_speed = load<float>(g.in[8], ti);
    t_vel = load<float2>(g.in[9], ti);
  }
  const float2 rp = load<float2>(g.in[10], env);
  const float2 rq = load<float2>(g.in[11], env);
  const bool compute_cp = g.in[12][env];
  float2* s_pos = pos_s[w];
  float* s_dist = dist_s[w];
  s_pos[lane] = cs;
  s_dist[lane] = cd;
  __syncwarp();

  // ---- phase 1: first-index argmax IOU of track `lane` ----
  const unsigned conf_mask = __ballot_sync(kFull, conf);
  unsigned overlap = 0u;  // confirmed segments whose box overlaps
  if (has_trk) {
    for (unsigned m = conf_mask; m != 0u; m &= m - 1u) {
      const int s = __ffs(m) - 1;
      const float2 q = s_pos[s];
      const float ddx = fabsf(tp.x - q.x), ddy = fabsf(tp.y - q.y);
      const float inter =
          fmaxf(c.side - ddx, 0.f) * fmaxf(c.side - ddy, 0.f);
      if (inter > 0.f) overlap |= 1u << s;
    }
  }
  // every IOU -1 (no confirmed segment): segment 0; else the first
  // confirmed segment at 0 until an overlapping one scores more
  int my_best = conf_mask != 0u ? __ffs(conf_mask) - 1 : 0;
  float my_best_iou = conf_mask != 0u ? 0.f : -1.f;
  for (unsigned m = overlap; m != 0u; m &= m - 1u) {
    const int s = __ffs(m) - 1;
    const float2 q = s_pos[s];
    const float ddx = fabsf(tp.x - q.x), ddy = fabsf(tp.y - q.y);
    const float inter = fmaxf(c.side - ddx, 0.f) * fmaxf(c.side - ddy, 0.f);
    const float uni = c.two_side2 - inter;
    const float iou = rintf((inter / uni) * 1000.f) * 0.001f;
    if (iou > my_best_iou) {
      my_best_iou = iou;
      my_best = s;
    }
  }

  // ---- phase 2: update of track `lane` ----
  const float px = tp.x, py = tp.y;
  const bool matched = valid && my_best_iou > 0.f;
  const float2 nb = s_pos[my_best];
  const float delx = px - nb.x, dely = py - nb.y;  // prev - curr
  const float speed =
      sqrtf(kForm == kPallas ? fmaf(delx, delx, dely * dely)
                             : fmaf(dely, dely, delx * delx)) *
      c.inv_dt;
  float f_px = px, f_py = py, f_prx = t_prev.x, f_pry = t_prev.y;
  float f_dist = t_dist, f_speed = t_speed, f_vx = t_vel.x, f_vy = t_vel.y;
  if (matched) {
    f_prx = px;
    f_pry = py;
    f_px = nb.x;
    f_py = nb.y;
    f_dist = s_dist[my_best];
    f_speed = speed;
    f_vx = delx * c.inv_dt;
    f_vy = dely * c.inv_dt;
  }

  // insertion: the r-th free slot takes the r-th unclaimed obstacle
  const unsigned claimed =
      __reduce_or_sync(kFull, matched ? (1u << my_best) : 0u);
  const bool to_insert = obs && !((claimed >> lane) & 1u);
  const unsigned insert_mask = __ballot_sync(kFull, to_insert);
  const unsigned below = (1u << lane) - 1u;
  if (to_insert) seg_of_rank_s[w][__popc(insert_mask & below)] = lane;
  const bool free_slot = has_trk && !matched;
  const unsigned free_mask = __ballot_sync(kFull, free_slot);
  const int free_rank = __popc(free_mask & below);
  const bool inserted = free_slot && free_rank < __popc(insert_mask);
  __syncwarp();
  if (inserted) {
    const int src = seg_of_rank_s[w][free_rank];
    const float2 is = s_pos[src];
    f_px = is.x;
    f_py = is.y;
    f_prx = is.x;
    f_pry = is.y;
    f_dist = s_dist[src];
    f_speed = -1.f;  // fresh-track sentinel
    f_vx = 0.f;
    f_vy = 0.f;
  }
  const bool f_valid = matched || inserted;
  const bool f_has_prev = matched && !inserted;

  // ---- phase 3: collision probability of track `lane` ----
  const float rx = rp.x, ry = rp.y, prx = rq.x, pry = rq.y;
  const float mdx = rx - prx, mdy = ry - pry;
  const float hp = f_has_prev ? 1.f : 0.f;
  const float relx = (rx + (f_prx - f_px) * hp) - prx;
  const float rely = (ry + (f_pry - f_py) * hp) - pry;
  const float ocx = f_px - prx, ocy = f_py - pry;
  float bb, d2, resultant;
  if (kForm == kPallas) {
    const float inv =
        1.f / fmaxf(sqrtf(fmaf(relx, relx, rely * rely)), 1e-9f);
    const float ux = relx * inv, uy = rely * inv;
    bb = fmaf(ocx, ux, ocy * uy);
    d2 = fmaf(-bb, bb, fmaf(ocx, ocx, ocy * ocy));
    resultant = fmaf(sqrtf(fmaf(mdx, mdx, mdy * mdy)), c.inv_dt, -f_speed);
  } else {
    const float agent_raw = sqrtf(fmaf(mdy, mdy, mdx * mdx));
    const float nrm = fmaxf(sqrtf(fmaf(rely, rely, relx * relx)), 1e-9f);
    const float ux = relx / nrm, uy = rely / nrm;
    bb = fmaf(ocy, uy, ocx * ux);
    d2 = fmaf(-bb, bb, fmaf(ocy, ocy, ocx * ocx));
    if (kForm == kStrict) {
      // the first valid track's closing speed (0 with no valid track),
      // one per env, fused with the robot's speed as the reference's
      // compiler does
      const unsigned vmask = __ballot_sync(kFull, f_valid);
      float obs_speed =
          __shfl_sync(kFull, f_speed, vmask ? __ffs(vmask) - 1 : 0);
      if (vmask == 0u) obs_speed = 0.f;
      resultant = fmaf(agent_raw, c.inv_dt, -obs_speed);
    } else {
      resultant = agent_raw * c.inv_dt - f_speed;
    }
  }
  const float disc = c.bw2 - d2;
  const bool hit = disc >= 0.f;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float dist_cp = hit ? fminf(fabsf(bb - sq), fabsf(bb + sq)) : inf;
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
    g.out[0][ti] = f_valid;
    store(g.out[1], ti, make_float2(f_px, f_py));
    store(g.out[2], ti, make_float2(f_prx, f_pry));
    g.out[3][ti] = f_has_prev;
    store(g.out[4], ti, f_dist);
    store(g.out[5], ti, f_speed);
    store(g.out[6], ti, make_float2(f_vx, f_vy));
  }

  // ---- phase 4: stable top-K ----
  const unsigned valid_mask = __ballot_sync(kFull, f_valid);
  const bool live = compute_cp && valid_mask != 0u;
  float score = f_valid ? cp : -inf;
  if (kForm == kStrict && __popc(valid_mask) > K && f_valid) score = -cp;
  float* s_score = score_s[w];
  s_score[lane] = score;
  __syncwarp();
  // rank = #(u < T: s_u > s) + #(u < lane: s_u == s). The ties come from
  // one match of the scores' bits (-0 made +0, so that bit equality is
  // float equality; a NaN matches no lane).
  const unsigned key = score == score ? __float_as_uint(score + 0.f)
                                      : 0xffffffe0u | (unsigned)lane;
  int rank = __popc(__match_any_sync(kFull, key) & below);
  for (int u = 0; u < T; ++u) rank += s_score[u] > score ? 1 : 0;
  // the output slot of a picked track: its rank, or in the strict form
  // its place among the K picked in descending CP (ties by rank)
  int slot = rank;
  if (kForm == kStrict) {
    const float k_cp = f_valid ? cp : -inf;
    rank_s[w][lane] = has_trk ? rank : K;
    key_s[w][lane] = k_cp;
    __syncwarp();
    slot = 0;
    for (int u = 0; u < T; ++u) {
      const int ru = rank_s[w][u];
      const float ku = key_s[w][u];
      slot += (ru < K && (ku > k_cp || (ku == k_cp && ru < rank))) ? 1 : 0;
    }
  }
  const bool picked = live && f_valid;
  const float my_top = picked ? cp : 0.f;
  if (has_trk && rank < K) {
    const size_t kb = (size_t)env * K + slot;
    store(g.out[7], kb, my_top);
    store(g.out[8], kb,
          make_float4(picked ? f_px : rx, picked ? f_py : ry,
                      picked ? f_vx : 0.f, picked ? f_vy : 0.f));
  }
  float mx = (has_trk && rank < K) ? my_top : -inf;
  float me = has_trk ? ego : -inf;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    me = fmaxf(me, __shfl_xor_sync(kFull, me, off));
  }
  if (lane == 0) {
    store(g.out[9], env, live ? mx : 0.f);
    store(g.out[10], env, live ? me : 0.f);
  }
}

}  // namespace

// ptrs: the 13 input and 11 output tensors' device addresses, in the order
// of track_cp_topk_fields; blocks, envs_per_block: track_cp_topk_launch
// (kernels/launch.py). Returns the launch's cudaError_t.
extern "C" int crowdnav_track_cp_topk(
    void* const* ptrs, int n_envs, int S, int T, int K, int blocks,
    int envs_per_block, float side, float two_side2, float inv_dt, float bw2,
    float w_ttc, float w_dist, float max_range, float inv_range, int form,
    void* stream) {
  if (n_envs == 0) return 0;
  if (envs_per_block < 1 || envs_per_block > kMaxWarps || S < 1 || S > 32 ||
      T < 1 || T > 32 || K < 1 || K > T || form < kXla || form > kPallas) {
    return (int)cudaErrorInvalidValue;
  }
  Ptrs g;
  for (int f = 0; f < kIn; ++f) g.in[f] = static_cast<const uint8_t*>(ptrs[f]);
  for (int f = 0; f < kOut; ++f) {
    g.out[f] = static_cast<uint8_t*>(ptrs[kIn + f]);
  }
  const Consts c{side, two_side2, inv_dt, bw2, w_ttc, w_dist, max_range,
                 inv_range};
  using Kernel = void (*)(Ptrs, int, int, int, int, Consts);
#define CROWDNAV_TRACK_FORMS(S_, T_, K_)                                     \
  (form == kXla      ? track_cp_topk_kernel<S_, T_, K_, kXla>                \
   : form == kStrict ? track_cp_topk_kernel<S_, T_, K_, kStrict>             \
                     : track_cp_topk_kernel<S_, T_, K_, kPallas>)
  const Kernel kernel = S == 32 && T == 24 && K == 8
                            ? CROWDNAV_TRACK_FORMS(32, 24, 8)
                        : S == 32 && T == 24 && K == 1
                            ? CROWDNAV_TRACK_FORMS(32, 24, 1)
                            : CROWDNAV_TRACK_FORMS(0, 0, 0);
#undef CROWDNAV_TRACK_FORMS
  kernel<<<blocks, 32 * envs_per_block, 0, (cudaStream_t)stream>>>(
      g, n_envs, S, T, K, c);
  return (int)cudaGetLastError();
}
