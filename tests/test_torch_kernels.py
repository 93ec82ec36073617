"""The host side of the port's CUDA kernels, on the CPU: the work counts
of ``kernels/roofline.py`` against the tensors the plain versions really
read and write, the raycast's operation count by hand, the launch geometry
of ``kernels/launch.py`` (grid, envs per block, shared memory) for
the batch sizes the port runs, and the input copies of
``kernels/timing.py``."""
import numpy as np
import pytest
import torch

from crowdnav_tpu_torch.envs.config import make_config
from crowdnav_tpu_torch.kernels import launch, roofline, timing
from crowdnav_tpu_torch.ops import lidar, risk
from crowdnav_tpu_torch.utils import numerics as nm
from torch_parity import population_torch, random_population

torch.set_num_threads(1)
CFG = make_config("crowd_dense", "crowd")
S, T, K, B = CFG.max_segments, CFG.max_tracks, CFG.k_obstacles, CFG.n_scans
R = CFG.ped_radius
R2 = nm.f32(R ** 2)
SIZES = (1, 1000, 1024, 16384)


def _raycast_args(n, p, seed=0):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(-1.3, 1.3, (n, 2)).astype(np.float32))
    yaw = torch.from_numpy(rng.uniform(-np.pi, np.pi, n).astype(np.float32))
    peds = torch.from_numpy(
        rng.uniform(-1.35, 1.35, (n, p, 2)).astype(np.float32))
    ca, sa = lidar.beam_tables(B)
    return (pos, nm.cos(yaw), nm.sin(yaw), ca, sa, peds,
            nm.f32(CFG.room_half_inner), R2, nm.f32(CFG.lidar_min_range),
            nm.f32(CFG.max_scan_range))


@pytest.mark.parametrize("p", [0, 3, 14, 6, 20])
def test_raycast_bytes_are_the_plain_tensors(p):
    args = _raycast_args(7, p)
    out = lidar.raycast_plain(*args)
    tensors = [a for a in args if torch.is_tensor(a)] + [out]
    nbytes, _ = roofline.raycast_work(7, B, p, hits=0)
    assert nbytes == sum(t.nbytes for t in tensors)


def _chain_tensors(n, seed=3):
    segs, tracks, pos, prev, cc = population_torch(
        *random_population(CFG, seed, n))
    inputs = [segs.confirmed, segs.is_obstacle, segs.center_pos,
              segs.center_dist, tracks.valid, tracks.pos, tracks.prev_pos,
              tracks.dist, tracks.speed, tracks.vel, pos, prev, cc]
    new, top_cp, top_pv, cp_max, ego_cp = risk.track_cp_topk(
        CFG, segs, tracks, pos, prev, cc)
    outputs = [new.valid, new.pos, new.prev_pos, new.has_prev, new.dist,
               new.speed, new.vel, top_cp, top_pv, cp_max, ego_cp]
    return inputs, outputs


def test_track_cp_topk_bytes_are_the_plain_tensors():
    inputs, outputs = _chain_tensors(9)
    nbytes, _ = roofline.track_cp_topk_work(9, S, T, K)
    assert nbytes == sum(t.nbytes for t in inputs + outputs)


def test_track_cp_topk_fields_are_the_plain_tensors_rows():
    """The per-env byte rows of the work count are the rows of the
    tensors, in the kernel's argument order."""
    n = 5
    inputs, outputs = _chain_tensors(n, seed=4)
    f_in, f_out = roofline.track_cp_topk_fields(S, T, K)
    assert [row for _, row in f_in] == [t.nbytes // n for t in inputs]
    assert [row for _, row in f_out] == [t.nbytes // n for t in outputs]


@pytest.mark.parametrize("p", [0, 14, 6, 20])
def test_raycast_ops_by_hand(p):
    n, hits = 3, 11
    per_beam = 6 + 5 + 2 + 2            # direction, walls, selects, clip
    by_hand = n * B * (per_beam + 5 * p) + 3 * hits + 5 * n * p
    assert roofline.raycast_work(n, B, p, hits)[1] == by_hand
    if p == 14:
        assert by_hand == 3 * B * 85 + 33 + 210


@pytest.mark.parametrize("world,behavior", [("crowd_sparse", "random"),
                                            ("test_20", "random_20")])
def test_raycast_work_on_the_new_paths(world, behavior):
    """The raycast's shapes on the paths of DDPG, SAC and DQN and of the
    evaluate suites: P = 6 (``crowd_sparse``) and P = 20 in the 5 m room
    with ``min_scan_range`` 0 (``test_20``); the work count's bytes are
    the plain version's tensors there, and its hits those of the plain
    version's circle test."""
    cfg = make_config(world, behavior)
    n, p = 11, cfg.n_peds
    rng = np.random.default_rng(2)
    h = cfg.room_half_inner - cfg.robot_radius
    pos = torch.from_numpy(rng.uniform(-h, h, (n, 2)).astype(np.float32))
    yaw = torch.from_numpy(rng.uniform(-np.pi, np.pi, n).astype(np.float32))
    peds = torch.from_numpy(rng.uniform(-h, h, (n, p, 2)).astype(
        np.float32))
    ca, sa = lidar.beam_tables(cfg.n_scans)
    r2 = nm.f32(cfg.ped_radius ** 2)
    args = (pos, nm.cos(yaw), nm.sin(yaw), ca, sa, peds,
            nm.f32(cfg.room_half_inner), r2, nm.f32(cfg.lidar_min_range),
            nm.f32(cfg.max_scan_range))
    out = lidar.raycast_plain(*args)
    assert out.shape == (n, cfg.n_scans)
    nbytes, ops = roofline.raycast_work(n, cfg.n_scans, p,
                                        roofline.raycast_hits(*args[:6], r2))
    assert nbytes == sum(t.nbytes for t in args[:6] + (out,))
    # every beam of a hit pair counts its root: the hits are the pairs
    # whose discriminant is >= 0, a subset of the n x B x P pairs
    hits = roofline.raycast_hits(*args[:6], r2)
    assert 0 < hits < n * cfg.n_scans * p
    assert ops == (n * cfg.n_scans * (15 + 5 * p) + 3 * hits + 5 * n * p)


def test_raycast_hits_counts_the_rays_that_meet_a_circle():
    """One pedestrian 0.3 ahead of a robot facing +x: the beams within
    asin(r / 0.3) = 9.7 deg of it and of the opposite direction meet the
    circle's line. Beam i points at -i deg, so that is i = 0..9 and
    351..358 ahead (there is no beam 359) and i = 171..189 behind."""
    pos = torch.zeros(1, 2)
    yaw = torch.zeros(1)
    peds = torch.tensor([[[0.3, 0.0]]])
    ca, sa = lidar.beam_tables(B)
    args = (pos, nm.cos(yaw), nm.sin(yaw), ca, sa)
    assert roofline.raycast_hits(*args, peds, R2) == 10 + 8 + 19
    far = torch.full((1, 1, 2), 1e3)
    assert roofline.raycast_hits(*args, far, R2) == 0


@pytest.mark.parametrize("p", [0, 14, 6, 20])
def test_raycast_ops_in_reach_by_hand(p):
    """With the cull by reach the pair tests count only the (env,
    pedestrian) pairs in reach, and every pair pays the reach test."""
    n, hits, in_reach = 3, 11, 5 if p else 0
    by_hand = n * B * 15 + 5 * B * in_reach + 3 * hits + (5 + 1) * n * p
    assert roofline.raycast_work(n, B, p, hits, in_reach)[1] == by_hand
    culled = roofline.raycast_pallas_work(n, B, p, hits, in_reach)[1]
    assert culled == by_hand - n * B * (6 - 2)
    if p:
        assert by_hand < roofline.raycast_work(n, B, p, hits)[1]


@pytest.mark.parametrize("form", ["xla", "pallas"])
def test_raycast_hits_in_reach_are_those_of_the_kept_pedestrians(form):
    """The hits counted under the cull are the hits of the inputs with
    every pedestrian beyond the reach set to NaN (which meets no beam;
    a far placeholder can, by cancellation in its rel2 - b^2), and the
    pedestrians in reach those whose rel2 (the kernel's operations) does
    not exceed ``reach2``."""
    args = _raycast_args(64, 14, seed=5)
    pos, peds = args[0], args[5]
    reach2 = launch.raycast_reach2(R2, nm.f32(CFG.max_scan_range))
    relx = peds[..., 0] - pos[:, 0:1]
    rely = peds[..., 1] - pos[:, 1:2]
    far = nm.fma(relx, relx, rely * rely) > reach2
    kept = torch.where(far[..., None], torch.full_like(peds, np.nan), peds)
    assert roofline.raycast_in_reach(pos, peds, reach2) == int((~far).sum())
    assert 0 < int((~far).sum()) < far.numel()
    if form == "xla":
        def hits(pd, r=None):
            return roofline.raycast_hits(*args[:5], pd, R2, r)
    else:
        yaw = torch.atan2(args[2], args[1])

        def hits(pd, r=None):
            return roofline.raycast_pallas_hits(pos, yaw, pd, B, R2, r)
    assert hits(peds, reach2) == hits(kept) < hits(peds)


def test_raycast_in_reach_by_hand():
    """One robot at the origin; pedestrians on the threshold, an ulp of
    rel2 beyond it, inside the robot's circle and at the placeholder."""
    reach2 = launch.raycast_reach2(R2, nm.f32(CFG.max_scan_range))
    d_in = float(np.sqrt(np.float32(reach2)))
    while nm.f32(d_in) ** 2 > reach2:
        d_in = float(np.nextafter(np.float32(d_in), np.float32(0)))
    d_out = float(np.nextafter(np.float32(d_in), np.float32(1)))
    while float(np.float32(d_out) * np.float32(d_out)) <= reach2:
        d_out = float(np.nextafter(np.float32(d_out), np.float32(1)))
    peds = torch.tensor([[[d_in, 0.0], [0.0, -d_out], [0.01, 0.0],
                          [1e3, 1e3]]])
    assert roofline.raycast_in_reach(torch.zeros(1, 2), peds, reach2) == 2


def test_bounds_name_what_sets_them():
    ms, by = roofline.bound_ms(3.35e9, 0)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = roofline.bound_ms(0, 67e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    _, by = roofline.bound_ms(*roofline.track_cp_topk_work(16384, S, T, K))
    assert by == "bytes"


@pytest.mark.parametrize("e", [None, 1, 3, 16])
@pytest.mark.parametrize("n", SIZES)
def test_track_cp_topk_launch_covers_every_env(n, e):
    geo = launch.track_cp_topk_launch(n, e)
    e = geo.envs_per_block
    assert geo.threads == 32 * e <= 512
    assert geo.grid * e >= n > (geo.grid - 1) * e


def test_track_cp_topk_launch_refuses_bad_blocks():
    for e in (0, 17, 32):
        with pytest.raises(ValueError):
            launch.track_cp_topk_launch(16, e)


@pytest.mark.parametrize("r", [None, 2, 4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_raycast_launch_covers_every_slot(n, r):
    """Every beam of every env has one thread and one of its R slots: the
    slots per env cover B beams with fewer than R to spare."""
    geo = launch.raycast_launch(n, B, 14, beams_per_thread=r)
    r, m = geo.beams_per_thread, geo.slots
    assert m * r >= B > m * r - r
    total = n * m
    assert geo.grid * geo.threads >= total > (geo.grid - 1) * geo.threads
    # per env the pose, 14 relative centres and squared norms, and one
    # reach mask word
    assert geo.smem_bytes == geo.envs_per_block * (16 + 12 * 14 + 4)
    beams = {j + k * m for j in range(m) for k in range(r)} & set(range(B))
    assert beams == set(range(B))


@pytest.mark.parametrize("r", launch.RAYCAST_BEAMS_PER_THREAD)
@pytest.mark.parametrize("threads", [32, 128, 256, 512])
@pytest.mark.parametrize("b", [359, 100, 7])
def test_raycast_envs_per_block_is_the_most_a_block_touches(threads, b, r):
    geo = launch.raycast_launch(3 * threads + 5, b, 1, threads, r)
    m = geo.slots
    total = (3 * threads + 5) * m
    touched = [len({i // m for i in range(first, min(first + threads,
                                                     total))})
               for first in range(0, total, threads)]
    assert max(touched) <= geo.envs_per_block
    assert geo.envs_per_block == -(-(threads - 1) // m) + 1


@pytest.mark.parametrize("p,words", [(0, 0), (1, 1), (20, 1), (32, 1),
                                     (33, 2)])
def test_raycast_smem_holds_a_reach_mask_word_per_32_pedestrians(p, words):
    geo = launch.raycast_launch(1000, B, p)
    assert geo.smem_bytes == geo.envs_per_block * (16 + 12 * p + 4 * words)


def test_raycast_launch_refuses_bad_blocks():
    for threads in (0, 48, 1024):
        with pytest.raises(ValueError):
            launch.raycast_launch(8, B, 14, threads)
    for r in (0, 1, 3, 16):
        with pytest.raises(ValueError):
            launch.raycast_launch(8, B, 14, 256, r)
    with pytest.raises(ValueError):   # the kernel indexes slots in 32 bits
        launch.raycast_launch(2 ** 31 // 180 + 1, B, 14, 128, 2)


def test_timing_copies_and_clones():
    assert timing.copies_for(1) == 64
    assert timing.copies_for(10 ** 12) == 2
    n = timing.copies_for(36_716_544)
    assert n * 36_716_544 >= 5 * timing.L2_BYTES
    args = (torch.ones(3), 2.0, torch.zeros(2, 2))
    sets = timing.clone_args(args, 3)
    assert len(sets) == 3 and all(s[1] == 2.0 for s in sets)
    ptrs = {s[0].data_ptr() for s in sets} | {args[0].data_ptr()}
    assert len(ptrs) == 4
    assert all(torch.equal(s[2], args[2]) for s in sets)



@pytest.mark.parametrize("p", [0, 6, 14, 20])
def test_raycast_pallas_work_is_the_plain_tensors(p):
    """The Pallas form reads the yaw instead of its trig and the beam
    tables: its byte count is the Pallas plain version's tensors; per beam
    it does the angle's multiply-add in float32 and the C library's cos
    and sin (one shared reduction) in float64."""
    args = _raycast_args(7, p)
    pos, peds = args[0], args[5]
    yaw = torch.from_numpy(np.random.default_rng(1).uniform(
        -np.pi, np.pi, 7).astype(np.float32))
    out = lidar.raycast_pallas_plain(pos, yaw, peds, B, *args[6:])
    hits = roofline.raycast_pallas_hits(pos, yaw, peds, B, R2)
    nbytes, ops32, ops64 = roofline.raycast_pallas_work(7, B, p, hits)
    assert nbytes == sum(t.nbytes for t in (pos, yaw, peds, out))
    assert ops32 == 7 * B * (11 + 5 * p) + 3 * hits + 5 * 7 * p
    assert ops64 == 7 * B * roofline.LIBM_SINCOS_PAIR_F64_OPS
    ms, by = roofline.mixed_bound_ms(nbytes, ops32, ops64)
    assert ms >= roofline.bound_ms(nbytes, ops32)[0]
    assert by in ("bytes", "operations")


def test_raycast_pallas_hits_follow_the_pallas_directions():
    """The hit count of the Pallas form is that of its own beam
    directions (here, one pedestrian ahead: the same 37 beams)."""
    pos, yaw = torch.zeros(1, 2), torch.zeros(1)
    peds = torch.tensor([[[0.3, 0.0]]])
    assert roofline.raycast_pallas_hits(pos, yaw, peds, B, R2) == 37


@pytest.mark.parametrize("form", risk.FORMS)
def test_track_cp_topk_forms_move_the_same_bytes(form):
    """Every form reads and writes the same tensors; the strict form adds
    the reorder of the picked tracks to the operations."""
    inputs, outputs = _chain_tensors(9)
    nbytes, ops = roofline.track_cp_topk_work(9, S, T, K, form)
    assert nbytes == sum(t.nbytes for t in inputs + outputs)
    base = roofline.track_cp_topk_work(9, S, T, K)[1]
    assert ops == base + (9 * T * T * 3 if form == "strict" else 0)


@pytest.mark.parametrize("overrides,form", [
    ({}, "xla"), ({"risk_backend": "pallas"}, "pallas"),
    ({"strict_quirks": True}, "strict")])
def test_chain_form_follows_the_config(overrides, form):
    import dataclasses
    from crowdnav_tpu_torch.kernels import build
    cfg = dataclasses.replace(CFG, **overrides)
    assert risk.chain_form(cfg) == form
    assert form in build.TRACK_FORMS
    with pytest.raises(ValueError, match="strict_quirks"):
        risk.chain_form(dataclasses.replace(CFG, risk_backend="pallas",
                                            strict_quirks=True))
