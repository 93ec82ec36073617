"""Fixed-seed trajectory parity in the port: its batched ``CrowdEnv`` (one
env, on the CPU, where the kernel wrappers run their plain versions)
against its sequential NumPy oracle (``crowdnav_tpu_torch/parity``), on the
ten scenarios of ``tests/test_parity.py`` with that file's tolerances
(``parity/scenarios.py`` holds them, and ``chip_smoke.py`` runs the same
scenarios on the card). Then the port's oracle against the JAX package's,
on the same scenarios: equal exactly, observation, reward, termination,
tracks and social regions at every step.
``tests/test_reference_parity_direct.py`` holds the JAX package's ``ops``
to the reference's own source; the port's ``ops`` are bit-equal to those
(``tests/test_torch_*.py``)."""
import math

import numpy as np
import pytest
import torch

from crowdnav_tpu.envs.config import make_config as jax_make_config
from crowdnav_tpu.parity import NumpyCrowdEnv as JaxOracle
from crowdnav_tpu_torch.parity import NumpyCrowdEnv, scenarios
from crowdnav_tpu_torch.parity.reference_env import _contains

torch.set_num_threads(1)


def test_parity_empty_room_straight():
    assert scenarios.run("empty_room_straight", "cpu")["steps"] == 40


def test_parity_empty_room_arcs():
    assert scenarios.run("empty_room_arcs", "cpu")["steps"] == 60


def test_parity_static_obstacle_course():
    assert scenarios.run("static_obstacle_course", "cpu")["steps"] > 10


def test_parity_topk_positions_static_scene():
    """With an obstacle in view, both pipelines report it in the top-K
    block at matching positions."""
    scenarios.run("topk_positions_static_scene", "cpu")


def test_parity_moving_crowd_scans():
    """Full-trajectory parity in a MOVING scene: the crossing direction
    table drives the env's crowd; the oracle gets the identical constant
    velocities (`simulate_crossing_4.py:88-92` pattern)."""
    assert scenarios.run("moving_crowd_scans", "cpu")["steps"] > 10


def test_parity_moving_crowd_velocity_estimation():
    """Both engines estimate the moving obstacle's velocity in the top-K
    block (reference velocity estimation `:745-761`)."""
    scenarios.run("moving_crowd_velocity_estimation", "cpu")


def test_parity_moving_crowd_nonzero_cp():
    """An obstacle crossing the robot's motion line produces a nonzero ego
    collision probability in the port's env (and the oracle agrees with
    the env along the way)."""
    r = scenarios.run("moving_crowd_nonzero_cp", "cpu")
    assert r["max_ego_cp"] > 0.0


def test_parity_collision_termination():
    """Driving straight at a wall terminates both at the same step, as a
    failure."""
    scenarios.run("collision_termination", "cpu")


def test_parity_strict_quirks_trajectory():
    """``strict_quirks=True`` (the tracker kernel's strict form and the
    literal waypoint box): scans, pose, rewards with the +200 box fires,
    termination and the top-K block agree step by step."""
    scenarios.run("strict_quirks_trajectory", "cpu")


def test_parity_segment_regions_static_scene():
    """Social-region codes agree env <-> oracle per confirmed segment,
    through the port's ``risk.perceive(..., yaw)``."""
    r = scenarios.run("segment_regions_static_scene", "cpu")
    assert r["segments"] > 10 and r["segments_in_regions"] > 0


def _oracle_state(env):
    return (env.x, env.y, env.yaw, env.prev_x, env.prev_y,
            env.waypoint.tolist(), env.prev_distance, env.prev_heading,
            env.best_goal_dist, env.step_count, env.done, env.success,
            env.ego_cp, env.cp_max, env.tracks, env.last_regions,
            env.ped.tolist())


@pytest.mark.parametrize("name", sorted(scenarios.SPECS))
def test_oracle_equals_the_jax_package_oracle(name):
    """The port's copy of the oracle and the JAX package's, driven with the
    same actions and crowd velocities: equal exactly at every step."""
    cfg_t, actions, vel = scenarios.inputs(name)
    cfg_j, actions_j, vel_j = scenarios.inputs(name, jax_make_config)
    assert actions == actions_j and np.array_equal(vel, vel_j)
    t, j = NumpyCrowdEnv(cfg_t), JaxOracle(cfg_j)
    np.testing.assert_array_equal(t.reset(), j.reset())
    assert t.bbox == j.bbox
    for step, a in enumerate(actions):
        ot, rt, dt = t.step(a, ped_vel=vel)
        oj, rj, dj = j.step(a, ped_vel=vel)
        np.testing.assert_array_equal(ot, oj, err_msg=f"obs step {step}")
        assert (rt, dt) == (rj, dj), step
        assert _oracle_state(t) == _oracle_state(j), step
        if dt:
            break


def test_region_test_is_matplotlibs():
    """The oracle's crossing-number test decides as matplotlib's
    ``Path.contains_point`` on the oracle's parallelograms: random points,
    the vertices, the edges' midpoints, their rounded copies and points on
    the vertices' horizontal and vertical lines."""
    from matplotlib.path import Path
    rng = np.random.default_rng(0)
    n = inside = 0
    for k in range(400):
        x, y = rng.uniform(-1.5, 1.5, 2)
        yaw = rng.uniform(-math.pi, math.pi) if k % 4 else \
            (k // 4 % 4 - 1) * math.pi / 2
        heading = abs(math.degrees(yaw) - 180.0)
        fx = x - 0.6 * math.cos(math.radians(heading))
        fy = y + 0.6 * math.sin(math.radians(heading))
        ox = -0.16 * math.cos(math.radians((90.0 + heading) % 360.0))
        oy = 0.16 * math.sin(math.radians((90.0 + heading) % 360.0))
        poly = [(x + ox, y + oy), (fx + ox, fy + oy), (fx, fy), (x, y)]
        pts = [tuple(p) for p in rng.uniform(-0.7, 0.7, (20, 2)) + (x, y)]
        pts += poly + [((a[0] + b[0]) / 2, (a[1] + b[1]) / 2)
                       for a, b in zip(poly, poly[1:] + poly[:1])]
        pts += [(round(px, 3), round(py, 3)) for px, py in pts]
        pts += [(rng.uniform(-2, 2), vy) for _, vy in poly]
        pts += [(vx, rng.uniform(-2, 2)) for vx, _ in poly]
        path = Path(poly)
        for p in pts:
            want = bool(path.contains_point(p))
            assert _contains(poly, p) == want, (poly, p)
            n += 1
            inside += want
    assert n > 10000 and 0.05 * n < inside < 0.5 * n
