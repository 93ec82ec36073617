"""Sequential NumPy oracle for the perceived-risk environment.

Independent re-implementation of the reference's single-env pipeline
(`environment_stage_1_nobonus.py`) in plain Python/NumPy — loops, dicts and
deques, the way the original is written — used purely as a test oracle for
the port's fixed-shape batched env. Shares NOTHING with the port's tensor
code except the config object; any disagreement between the two
implementations is a bug in one of them. This module is the port's copy of
``crowdnav_tpu/parity/reference_env.py`` and computes what that module
computes, exactly; the one change is the social-region test, which is
written out here (:func:`_contains`) instead of calling matplotlib, which
the port does not need.

Where the reference has documented committed bugs (SURVEY.md §7 quirk
policy), this oracle implements the *intended* semantics, matching the
port's default (`strict_quirks=False`); each site is annotated. With
``cfg.strict_quirks=True`` the oracle instead reproduces the reference's
literal committed behaviors, independently re-implemented (the strict
form of the tracker kernel and the strict reward in `envs/crowd_env.py`
then have a full-trajectory cross-check): the first live track's closing
speed divides every track's
TTC (`environment_stage_1_nobonus.py:793`), top-K overflow keeps the
LOWEST-K slice of the descending CP sort (:882-883), and the waypoint +200
uses the literal ±0.2 arrival box (:1110-1127) instead of the milestone
trail. Out of strict-mode scope (both engines use the intended per-track
form even under strict_quirks): the reference's loop-final collision-cone
shift — :798-815 reuses the LAST track's vo_change when shifting every
track's collision point, an iteration-order artifact of the uuid dict
that has no stable analog in a slot tracker.

The tracker is slot-based (fixed ``max_tracks`` slots, insertion takes the
lowest free slot) so "first live track" is well-defined and matches the
ordering of the port's fixed-slot tracker — a bookkeeping choice, not
borrowed code; the reference's uuid-dict ordering is an accident of
insertion order.
"""
from __future__ import annotations

import math

import numpy as np

from crowdnav_tpu_torch.envs.config import EnvConfig


def _contains(poly, pt):
    """Whether the closed polygon ``poly`` (its vertices in order) holds
    ``pt``: the crossing-number test of matplotlib's
    ``Path.contains_point`` (``point_in_path_impl`` of its ``_path.h``),
    written out with the same comparisons in double precision, so that it
    decides points on an edge as matplotlib does. An edge (a, b) that
    straddles the point's horizontal line toggles the parity when the
    point lies on the side of the edge that ``b``'s flag names."""
    tx, ty = pt
    inside = False
    for (ax, ay), (bx, by) in zip(poly, poly[1:] + poly[:1]):
        a_above, b_above = ay >= ty, by >= ty
        if a_above != b_above and \
                ((by - ty) * (ax - bx) >= (bx - tx) * (ay - by)) == b_above:
            inside = not inside
    return inside


def _wrap(a):
    while a > math.pi:
        a -= 2 * math.pi
    while a < -math.pi:
        a += 2 * math.pi
    return a


class NumpyCrowdEnv:
    """Single env, sequential semantics. Physics matches `envs.world`
    (same dt, same diff-drive math, crowd driven by a supplied velocity
    schedule so both engines see identical worlds)."""

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg
        n = cfg.n_scans
        step_gap = 2 * cfg.max_scan_range * math.sin(math.pi / 360.0)
        ang = math.radians(n - 1)
        wrap_gap = cfg.max_scan_range * math.hypot(math.cos(ang) - 1.0,
                                                   math.sin(ang))
        self.bbox = ((n - 1) * step_gap + wrap_gap) / n
        self.reset()

    # ---------- physics (mirrors envs/world.py, scalar) ----------
    def reset(self, ped_pos=None):
        cfg = self.cfg
        self.x, self.y, self.yaw = cfg.start_pose
        self.prev_x, self.prev_y = self.x, self.y
        self.lin_vel = 0.0
        self.ang_vel = 0.0
        self.ped = (np.array(cfg.ped_init, float).reshape(-1, 2)
                    if ped_pos is None else np.array(ped_pos, float))
        self.goal = np.array(cfg.goal, float)
        self.waypoint = self.goal.copy()
        # fixed-slot tracker: slot -> dict(pos, prev, dist, speed, vel) or
        # None; insertion fills the lowest free slot (see module docstring)
        self.tracks = [None] * self.cfg.max_tracks
        self.step_count = 0
        self.done = False
        self.success = False
        d0 = float(np.linalg.norm(self.goal - [self.x, self.y]))
        self.prev_distance = d0
        self.best_goal_dist = d0
        self.prev_heading = _wrap(math.atan2(self.goal[1] - self.y,
                                             self.goal[0] - self.x)
                                  - self.yaw)
        obs = self._observe(compute_cp=False)
        self.prev_distance = self.last_dtg
        self.prev_heading = self.last_htg
        return obs

    def _integrate(self, v, w):
        cfg = self.cfg
        vl = v - w * cfg.wheel_separation / 2.0
        vr = v + w * cfg.wheel_separation / 2.0
        wl = vl / cfg.wheel_radius * cfg.dt
        wr = vr / cfg.wheel_radius * cfg.dt
        ds = cfg.wheel_radius * (wr + wl) / 2.0
        dth = cfg.wheel_radius * (wr - wl) / cfg.wheel_separation
        mid = self.yaw + dth / 2.0
        self.x += ds * math.cos(mid)
        self.y += ds * math.sin(mid)
        lim = cfg.room_half_inner - cfg.robot_radius
        self.x = min(max(self.x, -lim), lim)
        self.y = min(max(self.y, -lim), lim)
        self.yaw = _wrap(self.yaw + dth)

    def _scan(self):
        """Beam-by-beam raycast in a plain loop."""
        cfg = self.cfg
        out = np.empty(cfg.n_scans)
        half = cfg.room_half_inner
        for i in range(cfg.n_scans):
            ang = self.yaw - math.radians(i)
            dx, dy = math.cos(ang), math.sin(ang)
            # wall exit distance
            tx = ((half if dx > 0 else -half) - self.x) / dx if dx else 1e9
            ty = ((half if dy > 0 else -half) - self.y) / dy if dy else 1e9
            t = min(tx, ty)
            # circles
            for px, py in self.ped:
                rx, ry = px - self.x, py - self.y
                b = rx * dx + ry * dy
                disc = cfg.ped_radius ** 2 - (rx * rx + ry * ry - b * b)
                if disc >= 0:
                    thit = b - math.sqrt(disc)
                    if 0 <= thit < t:
                        t = thit
            out[i] = min(max(t, cfg.lidar_min_range), cfg.max_scan_range)
        return np.round(out, 3)

    # ---------- perception (sequential, reference-style) ----------
    def _points(self, scans):
        pts = []
        for i in range(self.cfg.n_scans):
            ang = math.radians(i)
            px = self.x + scans[i] * math.cos(ang - self.yaw)
            py = self.y - scans[i] * math.sin(ang - self.yaw)
            pts.append((round(px, 3), round(py, 3)))
        return pts

    def _associated(self, p, q, side):
        dx, dy = abs(p[0] - q[0]), abs(p[1] - q[1])
        if self.cfg.strict_quirks:
            inter = max(side - dx, 0.0) * max(side - dy, 0.0)
            return round(inter / (2 * side * side - inter), 3) > 0.0
        return dx < side and dy < side

    def _segment(self, scans, pts):
        """Group occupied beams into segments by box association, classify
        each point wall/obstacle from the change-of-gradient, then confirm
        segment types by the expected-scan-count vote."""
        cfg = self.cfg
        n = cfg.n_scans
        occupied = [scans[i] < cfg.max_scan_range for i in range(n)]

        # gradients (x over y) and change-of-gradient, ring-wrapped
        grads = [None] * n
        for i in range(n):
            if not occupied[i]:
                continue
            j = (i + 1) % n
            dy = pts[i][1] - pts[j][1]
            g = 0.0 if dy == 0 else (pts[i][0] - pts[j][0]) / dy
            grads[i] = round(g, cfg.grad_round_decimals)
        change = [None] * n
        for i in range(n):
            j = (i + 1) % n
            if grads[i] is not None and grads[j] is not None:
                change[i] = round(abs(grads[i] - grads[j]),
                                  cfg.grad_round_decimals)
        kind = [None] * n   # 'w' | 'o'
        for i in range(n):
            if change[i] is None:
                continue
            nxt = change[(i + 1) % n]
            if change[i] == 0.0 or (nxt is not None and nxt == 0.0):
                kind[i] = "w"
            else:
                kind[i] = "o"

        # linear-scan segmentation; wrap merge afterwards
        segs = []           # list of list of beam indices
        cur = []
        for i in range(n):
            if not occupied[i]:
                if cur:
                    segs.append(cur)
                    cur = []
                continue
            if cur:
                p, q = pts[cur[-1]], pts[i]
                side = 2 * self.bbox
                # association: intended raw overlap by default; the
                # reference's literal rounded-IOU form under strict_quirks
                # (utils.is_associated:435-448 rounds before the check;
                # round-5 A/B in geom.boxes_associated docstring)
                if self._associated(p, q, side):
                    cur.append(i)
                else:
                    segs.append(cur)
                    cur = [i]
            else:
                cur = [i]
        if cur:
            segs.append(cur)
        if len(segs) > 1 and occupied[0] and occupied[n - 1] \
                and segs[0][0] == 0 and segs[-1][-1] == n - 1:
            p, q = pts[0], pts[n - 1]
            side = 4 * self.bbox     # doubled box across the blind spot
            if self._associated(p, q, side):
                segs[0] = segs[0] + segs.pop()

        # confirmation
        confirmed = []      # (is_obstacle, pos, dist, region)
        n_segs = len(segs)
        for beams in segs:
            count = len(beams)
            if count < cfg.min_segment_scans:
                continue
            center = beams[count // 2]
            d_c = scans[center]
            frac = (cfg.max_scan_range - d_c) / max(
                cfg.max_scan_range - cfg.min_scan_range, 1e-9)
            est = 3.0 + math.floor(29.0 * frac)
            n_o = sum(1 for b in beams if kind[b] == "o")
            n_w = sum(1 for b in beams if kind[b] == "w")
            if n_o > 0 and n_w > 0:
                score = n_o / max(min(count, est), 1.0)
                if score >= 0.5 or count <= est:
                    is_o = n_o > n_w
                else:
                    is_o = False
                confirmed.append((is_o, pts[center], d_c,
                                  self._region(pts[center], d_c)))
            else:
                if count > min(n_segs, est):
                    confirmed.append((n_o > 0, pts[center], d_c,
                                      self._region(pts[center], d_c)))
        return confirmed

    def _region(self, pt, scan):
        """Social-region code of a segment center, following the reference's
        literal degree-based polygon construction (`utils.get_obstacle_region
        :146-215`, yaw conversion `:356-364`) with matplotlib's crossing-
        number point-in-polygon (:func:`_contains`) as the shapely
        ``contains`` stand-in — an implementation independent of
        `ops/geom.social_region`'s closed-form parallelogram cross
        products. 0/1/2/3/4 = OTHER/FRF/FLF/FRC/FLC."""
        heading = abs(math.degrees(self.yaw) - 180.0)
        fx = self.x - 0.6 * math.cos(math.radians(heading))
        fy = self.y + 0.6 * math.sin(math.radians(heading))
        ox = -0.16 * math.cos(math.radians((90.0 + heading) % 360.0))
        oy = 0.16 * math.sin(math.radians((90.0 + heading) % 360.0))
        lx = -0.16 * math.cos(math.radians((270.0 + heading) % 360.0))
        ly = 0.16 * math.sin(math.radians((270.0 + heading) % 360.0))
        fr = [(self.x + ox, self.y + oy), (fx + ox, fy + oy), (fx, fy),
              (self.x, self.y)]
        fl = [(self.x, self.y), (fx, fy), (fx + lx, fy + ly),
              (self.x + lx, self.y + ly)]
        region = 0
        if 0.3 < scan < 0.6:
            if _contains(fr, pt):
                region = 1
            if _contains(fl, pt):
                region = 2
        if scan < 0.3:
            if _contains(fr, pt):
                region = 3
            if _contains(fl, pt):
                region = 4
        return region

    def _track(self, confirmed):
        cfg = self.cfg
        side = 2 * cfg.ped_radius
        claimed = [False] * len(confirmed)
        for slot, tr in enumerate(self.tracks):
            if tr is None:
                continue
            best, best_iou = None, 0.0
            for j, (_, pos, dist, _r) in enumerate(confirmed):
                dx = abs(tr["pos"][0] - pos[0])
                dy = abs(tr["pos"][1] - pos[1])
                inter = max(side - dx, 0.0) * max(side - dy, 0.0)
                iou = round(inter / (2 * side * side - inter), 3)
                if iou > best_iou:
                    best, best_iou = j, iou
            if best is None:
                self.tracks[slot] = None
                continue
            is_o, pos, dist, _r = confirmed[best]
            delta = (tr["pos"][0] - pos[0], tr["pos"][1] - pos[1])
            tr["prev"], tr["pos"], tr["dist"] = tr["pos"], pos, dist
            tr["speed"] = math.hypot(*delta) / cfg.dt
            tr["vel"] = (delta[0] / cfg.dt, delta[1] / cfg.dt)
            tr["has_prev"] = True
            claimed[best] = True
        for j, (is_o, pos, dist, _r) in enumerate(confirmed):
            if claimed[j] or not is_o:
                continue
            try:
                slot = self.tracks.index(None)   # lowest free slot
            except ValueError:
                break
            self.tracks[slot] = dict(
                pos=pos, prev=pos, dist=dist, speed=-1.0, vel=(0.0, 0.0),
                has_prev=False)

    def _collision_probs(self):
        cfg = self.cfg
        agent_speed = math.hypot(self.x - self.prev_x,
                                 self.y - self.prev_y) / cfg.dt
        live = [tr for tr in self.tracks if tr is not None]
        first_speed = live[0]["speed"] if live else 0.0
        rows = []           # (cp, x, y, vx, vy)
        ego = 0.0
        for tr in live:
            shift = ((tr["prev"][0] - tr["pos"][0],
                      tr["prev"][1] - tr["pos"][1])
                     if tr["has_prev"] else (0.0, 0.0))
            tx = self.x + shift[0] - self.prev_x
            ty = self.y + shift[1] - self.prev_y
            norm = math.hypot(tx, ty)
            ux, uy = (tx / norm, ty / norm) if norm > 1e-9 else (1.0, 0.0)
            rx, ry = tr["pos"][0] - self.prev_x, tr["pos"][1] - self.prev_y
            b = rx * ux + ry * uy
            disc = cfg.collision_body_width ** 2 - (rx * rx + ry * ry
                                                    - b * b)
            hit = disc >= 0
            gcp = ((cfg.max_scan_range - tr["dist"])
                   / max(cfg.max_scan_range - cfg.min_scan_range, 1e-9))
            if tr["dist"] > cfg.max_scan_range:
                gcp = 0.0
            # strict: the reference divides every track's TTC by the FIRST
            # track's closing speed (obstacle_vel = obstacle_vel[0], :793)
            obs_speed = first_speed if cfg.strict_quirks else tr["speed"]
            resultant = agent_speed - obs_speed
            if hit and resultant == 0.0:
                cp = gcp
            elif hit:
                sq = math.sqrt(disc)
                dist_cp = min(abs(b - sq), abs(b + sq))
                ttc = dist_cp / resultant
                cp_ttc = min(1.0, 0.15 / ttc) if ttc != 0 else 0.0
                ego = max(ego, cp_ttc)
                cp = cfg.cp_ttc_weight * cp_ttc + cfg.cp_dist_weight * gcp
            else:
                cp = cfg.cp_dist_weight * gcp
            rows.append((cp, tr["pos"][0], tr["pos"][1],
                         tr["vel"][0], tr["vel"][1]))
        rows.sort(key=lambda r: r[0], reverse=True)
        if cfg.strict_quirks and len(rows) > cfg.k_obstacles:
            # the reference's `sorted(desc)[-K:]` keeps the LOWEST-K CPs
            # (still in descending order) whenever more than K tracks exist
            # (:882-883)
            top = rows[-cfg.k_obstacles:]
        else:
            top = rows[:cfg.k_obstacles]
        while len(top) < cfg.k_obstacles:
            top.append((0.0, self.x, self.y, 0.0, 0.0))
        return top, ego, (top[0][0] if rows else 0.0)

    # ---------- MDP ----------
    def _observe(self, compute_cp=True):
        cfg = self.cfg
        scans = self._scan()
        pts = self._points(scans)

        if self.step_count == 1:
            self.waypoint = self._waypoint()
        dtg = round(float(np.linalg.norm(self.waypoint - [self.x, self.y])),
                    2)
        htg = round(_wrap(math.atan2(self.waypoint[1] - self.y,
                                     self.waypoint[0] - self.x) - self.yaw),
                    2)
        if self.step_count % 5 == 0 or dtg < self.prev_distance:
            self.waypoint = self._waypoint()
        self.last_dtg, self.last_htg = dtg, htg

        confirmed = self._segment(scans, pts)
        # per-confirmed-segment social regions (beam order), for parity
        # against the port's RiskOutput.segment_regions
        self.last_regions = [(is_o, p, r) for is_o, p, _d, r in confirmed]
        self._track(confirmed)
        if compute_cp and any(tr is not None for tr in self.tracks):
            top, self.ego_cp, self.cp_max = self._collision_probs()
        else:
            top = [(0.0, self.x, self.y, 0.0, 0.0)] * cfg.k_obstacles
            self.ego_cp, self.cp_max = 0.0, 0.0

        vx = -self.lin_vel * math.cos(self.ang_vel)
        vy = self.lin_vel * math.sin(self.ang_vel)
        state = list(scans) + [htg, dtg, round(self.x, 3), round(self.y, 3),
                               round(self.yaw, 3), round(vx, 3),
                               round(vy, 3)]
        for row in top:
            state += [row[1], row[2], row[3], row[4]]

        if not self.done:
            if cfg.min_scan_range > 0 and scans.min() < cfg.min_scan_range:
                self.done = True
            if self._in_box(self.goal):
                self.done, self.success = True, True
            if self.step_count >= cfg.max_steps:
                self.done = True
        return np.round(np.array(state), 3)

    def _waypoint(self):
        rel = self.goal - [self.x, self.y]
        d = float(np.linalg.norm(rel))
        if d <= self.cfg.waypoint_radius:
            return self.goal.copy()
        return np.array([self.x, self.y]) + rel / d * self.cfg.waypoint_radius

    def _in_box(self, center, pos=None):
        px, py = (self.x, self.y) if pos is None else pos
        eps = self.cfg.goal_eps
        return abs(px - center[0]) <= eps and abs(py - center[1]) <= eps

    def _reward(self, dtg, htg):
        cfg = self.cfg
        r = cfg.step_penalty
        if dtg - self.prev_distance < 0:
            r += cfg.dtg_reward
        hd = htg - self.prev_heading
        ch, ph = htg, self.prev_heading
        if hd > 0 and not (ch > 0 and ph > 0) and (ch != 0 and ph != 0):
            r += cfg.htg_reward
        elif hd < 0 and not (ch < 0 and ph < 0) and (ch != 0 and ph != 0):
            r += cfg.htg_reward
        if cfg.strict_quirks:
            # literal reference mechanic: +-goal_eps arrival box against the
            # current waypoint (:1110-1127, is_in_desired_position:1285-1301)
            if self._in_box(self.waypoint):
                r += cfg.waypoint_reward
                self.waypoint = self._waypoint()
                if self._in_box(self.goal, pos=self.waypoint):
                    self.waypoint = self.goal.copy()
        else:
            # waypoint milestone (intended semantics, matching the port's
            # default: +200 per waypoint_radius of NET best-goal-distance
            # improvement — see crowd_env._reward docstring for why the
            # literal box test is degenerate under deterministic kinematics)
            goal_dist = float(np.hypot(self.x - self.goal[0],
                                       self.y - self.goal[1]))
            if goal_dist <= self.best_goal_dist - cfg.waypoint_radius:
                r += cfg.waypoint_reward
                self.best_goal_dist = goal_dist
                self.waypoint = self._waypoint()
                if self._in_box(self.goal, pos=self.waypoint):
                    self.waypoint = self.goal.copy()
        if self.done:
            r += cfg.goal_reward if self.success else cfg.collision_reward
        self.prev_distance, self.prev_heading = dtg, htg
        return r

    def step(self, action, ped_vel=None):
        """One transition; ``ped_vel`` (P,2) is the crowd velocity for this
        step (supplied externally so both engines share the draws)."""
        cfg = self.cfg
        self.prev_x, self.prev_y = self.x, self.y
        self.lin_vel, self.ang_vel = float(action[0]), float(action[1])
        self._integrate(self.lin_vel, self.ang_vel)
        if ped_vel is not None and len(self.ped):
            self.ped = self.ped + np.asarray(ped_vel) * cfg.dt
            lim = cfg.room_half_inner - cfg.ped_radius
            self.ped = np.clip(self.ped, -lim, lim)
        self.step_count += 1
        obs = self._observe()
        reward = self._reward(self.last_dtg, self.last_htg)
        return obs, reward, self.done
