// fastsim: native single-env crowd-navigation simulator (C ABI).
//
// Host-side counterpart of the port's batched env, playing the role the C++
// turtlebot3_fake node plays in the reference (a Gazebo-free kinematic
// robot simulator, turtlebot3_fake.cpp:123-179) plus the lidar: exact
// same diff-drive midpoint-Euler integration, axis-aligned-room + circle
// raycast, pedestrian integration with wall clamping.
//
// Uses: (1) microsecond-latency robot-side control loops in deployment
// (no PyTorch or accelerator on the robot), (2) a second independent
// implementation for cross-checking the port's env (ctypes-driven parity
// tests), (3) fast host-side trajectory rollouts for offline analysis.
//
// Build:  g++ -O3 -fopenmp -shared -fPIC fastsim.cpp -o libfastsim.so
// (crowdnav_tpu_torch/native/__init__.py builds it at first use).
// ABI: plain C structs/functions; see the python wrapper in
// crowdnav_tpu_torch/native/__init__.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Config {
  int32_t n_scans;        // observation beams (359)
  int32_t n_peds;
  float dt;
  float wheel_separation;
  float wheel_radius;
  float robot_radius;
  float ped_radius;
  float room_half_inner;  // inner wall half-size
  float max_scan_range;
  float lidar_min_range;
  float goal_x, goal_y;
  float goal_eps;
  float min_scan_range;   // collision cut; <=0 disables
  int32_t max_steps;
};

struct State {
  float x, y, yaw;
  float prev_x, prev_y;
  int32_t step;
  int32_t done;       // 0 live, 1 success, 2 collision, 3 timeout
  float peds[2 * 64]; // up to 64 pedestrians, xy interleaved
};

inline float wrap_pi(float a) {
  while (a > static_cast<float>(M_PI)) a -= 2.0f * static_cast<float>(M_PI);
  while (a < -static_cast<float>(M_PI)) a += 2.0f * static_cast<float>(M_PI);
  return a;
}

}  // namespace

extern "C" {

// One differential-drive integration step; bit-matches
// crowdnav_tpu_torch.envs.world.integrate_robot (and turtlebot3_fake.cpp).
void fastsim_integrate(const Config* cfg, State* st, float lin, float ang) {
  const float vl = lin - ang * cfg->wheel_separation * 0.5f;
  const float vr = lin + ang * cfg->wheel_separation * 0.5f;
  const float wl = vl / cfg->wheel_radius * cfg->dt;
  const float wr = vr / cfg->wheel_radius * cfg->dt;
  const float ds = cfg->wheel_radius * (wr + wl) * 0.5f;
  const float dth = cfg->wheel_radius * (wr - wl) / cfg->wheel_separation;
  const float mid = st->yaw + dth * 0.5f;
  st->prev_x = st->x;
  st->prev_y = st->y;
  st->x += ds * std::cos(mid);
  st->y += ds * std::sin(mid);
  const float lim = cfg->room_half_inner - cfg->robot_radius;
  st->x = std::min(std::max(st->x, -lim), lim);
  st->y = std::min(std::max(st->y, -lim), lim);
  st->yaw = wrap_pi(st->yaw + dth);
}

// Pedestrian kinematics with wall clamp (vel: n_peds*2 floats).
void fastsim_step_peds(const Config* cfg, State* st, const float* vel) {
  const float lim = cfg->room_half_inner - cfg->ped_radius;
  for (int i = 0; i < cfg->n_peds; ++i) {
    float px = st->peds[2 * i] + vel[2 * i] * cfg->dt;
    float py = st->peds[2 * i + 1] + vel[2 * i + 1] * cfg->dt;
    st->peds[2 * i] = std::min(std::max(px, -lim), lim);
    st->peds[2 * i + 1] = std::min(std::max(py, -lim), lim);
  }
}

// Observation-order lidar scan: beam i points at world angle yaw - i deg.
void fastsim_scan(const Config* cfg, const State* st, float* out) {
  const float deg = static_cast<float>(M_PI) / 180.0f;
  const float half = cfg->room_half_inner;
  const float r2 = cfg->ped_radius * cfg->ped_radius;
  for (int i = 0; i < cfg->n_scans; ++i) {
    const float a = st->yaw - static_cast<float>(i) * deg;
    const float dx = std::cos(a), dy = std::sin(a);
    float t;
    {
      const float tx = (dx != 0.0f)
          ? ((dx > 0 ? half : -half) - st->x) / dx : 1e9f;
      const float ty = (dy != 0.0f)
          ? ((dy > 0 ? half : -half) - st->y) / dy : 1e9f;
      t = std::min(tx, ty);
    }
    for (int p = 0; p < cfg->n_peds; ++p) {
      const float rx = st->peds[2 * p] - st->x;
      const float ry = st->peds[2 * p + 1] - st->y;
      const float b = rx * dx + ry * dy;
      const float disc = r2 - (rx * rx + ry * ry - b * b);
      if (disc >= 0.0f) {
        const float th = b - std::sqrt(disc);
        if (th >= 0.0f && th < t) t = th;
      }
    }
    out[i] = std::min(std::max(t, cfg->lidar_min_range), cfg->max_scan_range);
  }
}

// Full transition: integrate robot + peds, scan, termination flags.
// Returns done code (0 live). scan_out must hold n_scans floats.
int32_t fastsim_step(const Config* cfg, State* st, float lin, float ang,
                     const float* ped_vel, float* scan_out) {
  fastsim_integrate(cfg, st, lin, ang);
  if (ped_vel) fastsim_step_peds(cfg, st, ped_vel);
  st->step += 1;
  fastsim_scan(cfg, st, scan_out);
  float min_scan = 1e9f;
  for (int i = 0; i < cfg->n_scans; ++i) min_scan = std::min(min_scan, scan_out[i]);
  const bool at_goal = std::fabs(st->x - cfg->goal_x) <= cfg->goal_eps &&
                       std::fabs(st->y - cfg->goal_y) <= cfg->goal_eps;
  if (at_goal) st->done = 1;
  else if (cfg->min_scan_range > 0.0f && min_scan < cfg->min_scan_range)
    st->done = 2;
  else if (st->step >= cfg->max_steps) st->done = 3;
  return st->done;
}

// Batched rollout helper: run `n_steps` with per-step (lin, ang) commands,
// writing the (x, y, yaw) trajectory. Returns steps actually run (stops at
// episode end).
int32_t fastsim_rollout(const Config* cfg, State* st, const float* actions,
                        int32_t n_steps, const float* ped_vels,
                        float* traj_out, float* scan_buf) {
  int32_t n = 0;
  for (; n < n_steps; ++n) {
    const float* pv = ped_vels ? ped_vels + 2 * cfg->n_peds * n : nullptr;
    int32_t done = fastsim_step(cfg, st, actions[2 * n], actions[2 * n + 1],
                                pv, scan_buf);
    traj_out[3 * n] = st->x;
    traj_out[3 * n + 1] = st->y;
    traj_out[3 * n + 2] = st->yaw;
    if (done) { ++n; break; }
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched multi-env core (SoA layout, OpenMP over envs).
//
// The host-side counterpart of the port's batched world step
// (crowdnav_tpu_torch/envs/world.py + ops/lidar.py): N independent envs
// step in one call — diff-drive integration, crowd behavior (static /
// random-redraw / fixed direction tables, matching the semantics of
// crowd_behaviors/simulate_*.py), raycast, termination, and jittered
// auto-reset. RANDOM crowd draws use a per-env xorshift64* stream:
// behaviorally equivalent to the port's torch.Generator draws,
// deliberately NOT bit-matching (parity tests drive both engines with
// explicit velocities instead).
// ---------------------------------------------------------------------------

namespace {

inline uint64_t xorshift64s(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

inline float uniform_pm(uint64_t* s, float mag) {  // uniform in [-mag, mag)
  return (static_cast<float>(xorshift64s(s) >> 40) /
              static_cast<float>(1 << 24) * 2.0f - 1.0f) * mag;
}

}  // namespace

extern "C" {

struct BatchConfig {
  Config base;
  int32_t n_envs;
  int32_t behavior;       // 0 static, 1 random, 2 fixed table
  float crowd_speed;
  int32_t redraw_window;  // env-steps between velocity redraws
  float start_x, start_y, start_yaw;
  float start_pos_jitter; // auto-reset randomization (0 = deterministic)
  float start_yaw_jitter;
  float ped_pos_jitter;
  const float* ped_init;  // (P, 2) spawn table
  const float* ped_dirs;  // (P, 2) direction table (behavior 2)
};

// Reset env i of the SoA batch (jittered from its RNG stream).
static void reset_env(const BatchConfig* bc, int i, float* x, float* y,
                      float* yaw, float* px, float* py, int32_t* step,
                      int32_t* done, float* peds, float* ped_vel,
                      uint64_t* rng) {
  const Config* c = &bc->base;
  uint64_t* r = rng + i;
  float sx = bc->start_x, sy = bc->start_y, syaw = bc->start_yaw;
  if (bc->start_pos_jitter > 0) {
    sx += uniform_pm(r, bc->start_pos_jitter);
    sy += uniform_pm(r, bc->start_pos_jitter);
    const float lim = c->room_half_inner - c->robot_radius;
    sx = std::min(std::max(sx, -lim), lim);
    sy = std::min(std::max(sy, -lim), lim);
  }
  if (bc->start_yaw_jitter > 0)
    syaw = wrap_pi(syaw + uniform_pm(r, bc->start_yaw_jitter));
  x[i] = sx; y[i] = sy; yaw[i] = syaw; px[i] = sx; py[i] = sy;
  step[i] = 0; done[i] = 0;
  const float plim = c->room_half_inner - c->ped_radius;
  for (int p = 0; p < c->n_peds; ++p) {
    float ppx = bc->ped_init[2 * p], ppy = bc->ped_init[2 * p + 1];
    if (bc->ped_pos_jitter > 0) {
      ppx += uniform_pm(r, bc->ped_pos_jitter);
      ppy += uniform_pm(r, bc->ped_pos_jitter);
      ppx = std::min(std::max(ppx, -plim), plim);
      ppy = std::min(std::max(ppy, -plim), plim);
    }
    peds[(static_cast<int64_t>(i) * c->n_peds + p) * 2] = ppx;
    peds[(static_cast<int64_t>(i) * c->n_peds + p) * 2 + 1] = ppy;
    ped_vel[(static_cast<int64_t>(i) * c->n_peds + p) * 2] = 0.0f;
    ped_vel[(static_cast<int64_t>(i) * c->n_peds + p) * 2 + 1] = 0.0f;
  }
}

void fastsim_reset_batch(const BatchConfig* bc, float* x, float* y,
                         float* yaw, float* px, float* py, int32_t* step,
                         int32_t* done, float* peds, float* ped_vel,
                         uint64_t* rng) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < bc->n_envs; ++i)
    reset_env(bc, i, x, y, yaw, px, py, step, done, peds, ped_vel, rng);
}

// One batched transition: auto-reset done envs, integrate robot + crowd,
// raycast, set termination codes. actions: (N, 2); scans_out: (N, n_scans).
void fastsim_step_batch(const BatchConfig* bc, float* x, float* y,
                        float* yaw, float* px, float* py, int32_t* step,
                        int32_t* done, float* peds, float* ped_vel,
                        uint64_t* rng, const float* actions,
                        float* scans_out) {
  const Config* c = &bc->base;
  const int S = c->n_scans;
  const int P = c->n_peds;
  const float deg = static_cast<float>(M_PI) / 180.0f;
  const float r2 = c->ped_radius * c->ped_radius;
#pragma omp parallel for schedule(static)
  for (int i = 0; i < bc->n_envs; ++i) {
    if (done[i]) {
      reset_env(bc, i, x, y, yaw, px, py, step, done, peds, ped_vel, rng);
    }
    // robot integration (turtlebot3_fake.cpp:123-179 math)
    const float lin = actions[2 * i], ang = actions[2 * i + 1];
    const float vl = lin - ang * c->wheel_separation * 0.5f;
    const float vr = lin + ang * c->wheel_separation * 0.5f;
    const float wl = vl / c->wheel_radius * c->dt;
    const float wr = vr / c->wheel_radius * c->dt;
    const float ds = c->wheel_radius * (wr + wl) * 0.5f;
    const float dth = c->wheel_radius * (wr - wl) / c->wheel_separation;
    const float mid = yaw[i] + dth * 0.5f;
    px[i] = x[i]; py[i] = y[i];
    x[i] += ds * std::cos(mid);
    y[i] += ds * std::sin(mid);
    const float rlim = c->room_half_inner - c->robot_radius;
    x[i] = std::min(std::max(x[i], -rlim), rlim);
    y[i] = std::min(std::max(y[i], -rlim), rlim);
    yaw[i] = wrap_pi(yaw[i] + dth);

    // crowd behavior (crowd_behaviors/simulate_*.py families)
    float* pp = peds + static_cast<int64_t>(i) * P * 2;
    float* pv = ped_vel + static_cast<int64_t>(i) * P * 2;
    const bool redraw =
        bc->redraw_window > 0 && (step[i] % bc->redraw_window) == 0;
    if (redraw) {
      if (bc->behavior == 1) {           // RANDOM: fresh uniform draw
        for (int p = 0; p < 2 * P; ++p)
          pv[p] = uniform_pm(rng + i, bc->crowd_speed);
      } else if (bc->behavior == 2) {    // fixed direction table
        for (int p = 0; p < 2 * P; ++p)
          pv[p] = bc->ped_dirs[p] * bc->crowd_speed;
      }
    }
    const float plim = c->room_half_inner - c->ped_radius;
    for (int p = 0; p < P; ++p) {
      pp[2 * p] = std::min(std::max(pp[2 * p] + pv[2 * p] * c->dt, -plim),
                           plim);
      pp[2 * p + 1] = std::min(
          std::max(pp[2 * p + 1] + pv[2 * p + 1] * c->dt, -plim), plim);
    }
    step[i] += 1;

    // raycast
    float* out = scans_out + static_cast<int64_t>(i) * S;
    float min_scan = 1e9f;
    for (int s = 0; s < S; ++s) {
      const float a = yaw[i] - static_cast<float>(s) * deg;
      const float dx = std::cos(a), dy = std::sin(a);
      const float tx = (dx != 0.0f)
          ? ((dx > 0 ? c->room_half_inner : -c->room_half_inner) - x[i]) / dx
          : 1e9f;
      const float ty = (dy != 0.0f)
          ? ((dy > 0 ? c->room_half_inner : -c->room_half_inner) - y[i]) / dy
          : 1e9f;
      float t = std::min(tx, ty);
      for (int p = 0; p < P; ++p) {
        const float rx = pp[2 * p] - x[i];
        const float ry = pp[2 * p + 1] - y[i];
        const float b = rx * dx + ry * dy;
        const float disc = r2 - (rx * rx + ry * ry - b * b);
        if (disc >= 0.0f) {
          const float th = b - std::sqrt(disc);
          if (th >= 0.0f && th < t) t = th;
        }
      }
      t = std::min(std::max(t, c->lidar_min_range), c->max_scan_range);
      out[s] = t;
      min_scan = std::min(min_scan, t);
    }

    // termination
    const bool at_goal = std::fabs(x[i] - c->goal_x) <= c->goal_eps &&
                         std::fabs(y[i] - c->goal_y) <= c->goal_eps;
    if (at_goal) done[i] = 1;
    else if (c->min_scan_range > 0.0f && min_scan < c->min_scan_range)
      done[i] = 2;
    else if (step[i] >= c->max_steps) done[i] = 3;
  }
}

}  // extern "C"
