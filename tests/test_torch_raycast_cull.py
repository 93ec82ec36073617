"""The raycast kernel's cull by reach (``kernels/csrc/raycast.cu``) is
exact: a pedestrian whose squared distance ``rel2`` (computed as the kernel
computes it) exceeds the host's threshold ``launch.raycast_reach2`` changes
no beam. On the CPU, each plain version (``raycast_plain``, the XLA form;
``raycast_pallas_plain``, the Pallas form) with every pedestrian equals,
bit for bit, the same plain version with each pedestrian beyond the
threshold moved to the far placeholder of an empty room (1e3), which is
what the kernel's skip amounts to. The populations put pedestrians at the
reach (``max_range + r``) and at the threshold, a few ulp and 1 mm either
side, on and between beam directions, and the robot inside a pedestrian's
circle; P = 0, 6, 14, 20; the 0.6 m lidar in the 3 m room and the
waffle's 3.5 m lidar in the 5 m room. A threshold at the reach itself
(margin 0) changes beams on these populations: the margin is needed."""
import math

import numpy as np
import pytest
import torch

from crowdnav_tpu_torch.envs.config import make_config
from crowdnav_tpu_torch.kernels import launch
from crowdnav_tpu_torch.ops import lidar
from crowdnav_tpu_torch.utils import numerics as nm

torch.set_num_threads(1)
FAR = 1e3          # the placeholder pedestrian of an empty room
N_ENVS = 64
ROOMS = {"range0.6_room3": ("crowd_dense", "crowd", None),
         "range3.5_room5": ("test_12", "random", "waffle")}
PEDS = (0, 6, 14, 20)
FORMS = ("xla", "pallas")


def _cfg(room):
    world, behavior, robot = ROOMS[room]
    return make_config(world, behavior, robot=robot)


def _constants(cfg):
    """``(r2, max_range)`` as the kernel gets them."""
    return nm.f32(cfg.ped_radius ** 2), nm.f32(cfg.max_scan_range)


def _population(cfg, p, seed):
    """``N_ENVS`` poses in the room and ``p`` pedestrians each: four in
    five at a distance from the list below along a beam's direction, half
    a beam off it or in between, the rest uniform in the room."""
    rng = np.random.default_rng(seed)
    h = cfg.room_half_inner - cfg.robot_radius
    pos = rng.uniform(-h, h, (N_ENVS, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, N_ENVS).astype(np.float32)
    peds = rng.uniform(-h, h, (N_ENVS, p, 2)).astype(np.float32)
    r2, max_range = _constants(cfg)
    edge = max_range + math.sqrt(r2)
    reach = math.sqrt(launch.raycast_reach2(r2, max_range))
    ulp = float(np.spacing(np.float32(edge)))
    dists = [edge + k * ulp for k in (-4, -2, -1, 0, 1, 2, 3, 4, 6, 8, 16)]
    dists += [reach + k * ulp for k in (-4, -2, -1, 0, 1, 2, 4)]
    dists += [edge - 1e-3, edge + 1e-3, reach - 1e-3, reach + 1e-3,
              0.5 * cfg.ped_radius]          # the robot inside the circle
    for e in range(N_ENVS):
        for k in range(p):
            if rng.uniform() < 0.2:
                continue
            d = dists[rng.integers(len(dists))]
            off = (0.0, 0.5, rng.uniform(-0.5, 0.5))[rng.integers(3)]
            a = float(yaw[e]) - (int(rng.integers(cfg.n_scans)) + off) \
                * math.pi / 180.0
            peds[e, k] = (pos[e, 0] + d * math.cos(a),
                          pos[e, 1] + d * math.sin(a))
    return torch.from_numpy(pos), torch.from_numpy(yaw), \
        torch.from_numpy(peds)


def _scan(form, cfg, pos, yaw, peds):
    consts = lidar._consts(cfg.ped_radius, cfg.room_half_inner,
                           cfg.max_scan_range, cfg.lidar_min_range)
    if form == "pallas":
        return lidar.raycast_pallas_plain(pos, yaw, peds, cfg.n_scans,
                                          *consts)
    ca, sa = lidar.beam_tables(cfg.n_scans)
    return lidar.raycast_plain(pos, nm.cos(yaw), nm.sin(yaw), ca, sa, peds,
                               *consts)


def _culled(pos, peds, reach2):
    """``peds`` with each pedestrian whose ``rel2`` (the kernel's
    operations) exceeds ``reach2`` moved to the placeholder, and how many
    moved."""
    relx = peds[..., 0] - pos[:, None, 0]
    rely = peds[..., 1] - pos[:, None, 1]
    out = nm.fma(relx, relx, rely * rely) > reach2
    return torch.where(out[..., None], torch.full_like(peds, FAR), peds), \
        int(out.sum())


def _differing(form, room, p, reach2=None):
    """Beams that differ between the plain version with every pedestrian
    and with those beyond ``reach2`` (default the host's threshold) moved
    away, and the number moved."""
    cfg = _cfg(room)
    pos, yaw, peds = _population(cfg, p, seed=100 + p)
    if reach2 is None:
        reach2 = launch.raycast_reach2(*_constants(cfg))
    far, moved = _culled(pos, peds, reach2)
    ref = _scan(form, cfg, pos, yaw, peds)
    got = _scan(form, cfg, pos, yaw, far)
    return int((got.view(torch.int32) != ref.view(torch.int32)).sum()), moved


@pytest.mark.parametrize("p", PEDS)
@pytest.mark.parametrize("room", ROOMS)
@pytest.mark.parametrize("form", FORMS)
def test_cull_by_reach_changes_no_beam(form, room, p):
    bad, moved = _differing(form, room, p)
    assert bad == 0
    assert (moved > 0) == (p > 0)


@pytest.mark.parametrize("form", FORMS)
def test_cull_without_margin_changes_beams(form):
    """The threshold at the reach ``max_range + r`` itself culls
    pedestrians whose float32 hit falls below ``max_range``."""
    bad = 0
    for room in ROOMS:
        r2, max_range = _constants(_cfg(room))
        bare = nm.f32((max_range + math.sqrt(r2)) ** 2)
        bad += sum(_differing(form, room, p, bare)[0] for p in PEDS)
    assert bad > 0


@pytest.mark.parametrize("room,margin", [("range0.6_room3", 9.9e-4),
                                         ("range3.5_room5", 5.4e-3)])
def test_reach_margin_is_the_kernels_note(room, margin):
    """The threshold lies ``margin`` (to two digits, as ``raycast.cu``'s
    note states it) beyond the reach, and is a float32."""
    r2, max_range = _constants(_cfg(room))
    reach2 = launch.raycast_reach2(r2, max_range)
    assert reach2 == nm.f32(reach2)
    got = math.sqrt(reach2) - max_range - math.sqrt(r2)
    assert got == pytest.approx(margin, rel=0.01)
