"""Helpers of the PyTorch port's parity tests (``tests/test_torch_*.py``):
moving JAX package state into the port through numpy, and the random
tracker populations of ``tests/test_risk_pallas.py`` rebuilt from numpy
seeds so that both packages get the same inputs."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crowdnav_tpu.envs import world as jworld
from crowdnav_tpu.envs.world import TrackState as JTrackState
from crowdnav_tpu.ops import risk as jrisk
from crowdnav_tpu_torch.envs import world as tworld
from crowdnav_tpu_torch.ops import risk as trisk


def to_torch(a):
    return torch.from_numpy(np.array(a))


def env_state_to_torch(js) -> tworld.EnvState:
    """Batched JAX EnvState -> the port's EnvState (the key is dropped)."""
    kw = {}
    for f in dataclasses.fields(tworld.EnvState):
        v = getattr(js, f.name)
        if f.name == "tracks":
            kw[f.name] = tworld.TrackState(**{
                g.name: to_torch(getattr(v, g.name))
                for g in dataclasses.fields(tworld.TrackState)})
        else:
            kw[f.name] = to_torch(v)
    return tworld.EnvState(**kw)


def jax_state(ts, keys):
    """The port's batched state as a JAX ``EnvState`` carrying ``keys``."""
    kw = {}
    for f in dataclasses.fields(jworld.EnvState):
        if f.name == "key":
            kw["key"] = keys
        elif f.name == "tracks":
            kw["tracks"] = JTrackState(**{
                g.name: jnp.asarray(getattr(ts.tracks, g.name).numpy())
                for g in dataclasses.fields(jworld.TrackState)})
        else:
            kw[f.name] = jnp.asarray(getattr(ts, f.name).numpy())
    return jworld.EnvState(**kw)


# the key ``world.init_state`` leaves in a randomized reset's state
jax_state_keys = jax.jit(jax.vmap(lambda k: jax.random.split(k, 6)[5]))


def assert_env_state_equal(ts: tworld.EnvState, js, msg=""):
    """Every field of the port's state bit-equal to the JAX state's."""
    for f in dataclasses.fields(tworld.EnvState):
        if f.name == "tracks":
            for g in dataclasses.fields(tworld.TrackState):
                np.testing.assert_array_equal(
                    getattr(ts.tracks, g.name).numpy(),
                    np.asarray(getattr(js.tracks, g.name)),
                    err_msg=f"{msg} tracks.{g.name}")
        else:
            np.testing.assert_array_equal(
                getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
                err_msg=f"{msg} {f.name}")


def template_keys(seed: int, n: int):
    """``PRNGKey(0)`` (the key of the JAX env's reset template), then
    ``n`` keys split from ``seed``."""
    return jnp.concatenate([jax.random.PRNGKey(0)[None],
                            jax.random.split(jax.random.PRNGKey(seed), n)])


def check_template(jenv, tenv, draws):
    """The port's reset with the draws of the template's key (row 0 of
    ``draws``) bit-equal to the JAX env's reset template; returns it."""
    ts, tobs = tenv.reset(1, draws={k: v[:1] for k, v in draws.items()})
    st, obs = jenv._template
    np.testing.assert_array_equal(tobs.numpy()[0], obs, err_msg="template")
    assert_env_state_equal(ts, jax.tree.map(lambda a: a[None], st),
                           "template")
    return ts, tobs


def random_population(cfg, seed: int, n: int):
    """Random but plausible segments and tracks (as
    ``tests/test_risk_pallas.py``), positions on a 1/8 grid so that IOU
    ties occur. Returns numpy dicts."""
    rng = np.random.default_rng(seed)
    S, T = cfg.max_segments, cfg.max_tracks
    f32 = np.float32
    seg_valid = rng.uniform(size=(n, S)) < 0.4
    segs = dict(
        valid=seg_valid,
        is_obstacle=seg_valid & (rng.uniform(size=(n, S)) < 0.7),
        confirmed=seg_valid & (rng.uniform(size=(n, S)) < 0.8),
        center_pos=(np.round(rng.uniform(-1.2, 1.2, (n, S, 2)) * 8) / 8
                    ).astype(f32),
        center_dist=rng.uniform(0.08, 0.62, (n, S)).astype(f32),
        count=np.where(seg_valid, 5, 0).astype(np.int32))
    t_valid = rng.uniform(size=(n, T)) < 0.5
    tpos = (np.round(rng.uniform(-1.2, 1.2, (n, T, 2)) * 8) / 8).astype(f32)
    tracks = dict(
        valid=t_valid, pos=tpos,
        prev_pos=(tpos + rng.normal(size=(n, T, 2)) * 0.03).astype(f32),
        has_prev=t_valid & (rng.uniform(size=(n, T)) < 0.8),
        dist=rng.uniform(0.08, 0.62, (n, T)).astype(f32),
        speed=(np.abs(rng.normal(size=(n, T))) * 0.3).astype(f32),
        vel=(rng.normal(size=(n, T, 2)) * 0.1).astype(f32))
    pos = rng.uniform(-1.0, 1.0, (n, 2)).astype(f32)
    prev = (pos - rng.normal(size=(n, 2)) * 0.03).astype(f32)
    cc = np.arange(n) % 7 != 0
    return segs, tracks, pos, prev, cc


def edge_population(cfg):
    """The edge cases of ``tests/test_risk_pallas.py``, plus CP ties and a
    full table: 0 nothing; 1 all tracks valid, no segments; 2 segments only
    (mass insertion); 3 identical segments (IOU tie); 4 twelve tracks on a
    stack of identical segments (CP ties); 5 every slot matched with
    obstacles left over."""
    S, T, n = cfg.max_segments, cfg.max_tracks, 6
    f32 = np.float32
    seg_valid = np.zeros((n, S), bool)
    seg_valid[2, :10] = seg_valid[3, :2] = seg_valid[4, :12] = True
    seg_valid[5] = True
    cpos = np.zeros((n, S, 2), f32)
    cpos[3, :2] = 0.5
    cpos[4, :12] = (0.3, 0.2)
    cpos[5, :, 0] = np.linspace(-1.2, 1.2, S)
    cpos[5, :, 1] = 0.4
    segs = dict(valid=seg_valid, is_obstacle=seg_valid, confirmed=seg_valid,
                center_pos=cpos, center_dist=np.full((n, S), 0.3, f32),
                count=seg_valid.astype(np.int32) * 5)
    t_valid = np.zeros((n, T), bool)
    t_valid[1] = t_valid[5] = True
    t_valid[3, 0] = True
    t_valid[4, :12] = True
    tpos = np.zeros((n, T, 2), f32)
    tpos[3, 0] = 0.5
    tpos[4, :12] = (0.31, 0.2)
    tpos[5] = cpos[5, :T] + np.float32(0.01)
    tracks = dict(valid=t_valid, pos=tpos, prev_pos=np.zeros((n, T, 2), f32),
                  has_prev=t_valid.copy(), dist=np.full((n, T), 0.4, f32),
                  speed=np.full((n, T), 0.2, f32),
                  vel=np.zeros((n, T, 2), f32))
    pos = np.tile(np.array([[0.1, -0.1]], f32), (n, 1))
    prev = np.tile(np.array([[0.08, -0.12]], f32), (n, 1))
    return segs, tracks, pos, prev, np.ones(n, bool)


def population_jax(segs, tracks, pos, prev, cc):
    return (jrisk.Segments(**{k: jnp.asarray(v) for k, v in segs.items()}),
            JTrackState(**{k: jnp.asarray(v) for k, v in tracks.items()}),
            jnp.asarray(pos), jnp.asarray(prev), jnp.asarray(cc))


def population_torch(segs, tracks, pos, prev, cc):
    return (trisk.Segments(**{k: to_torch(v) for k, v in segs.items()}),
            tworld.TrackState(**{k: to_torch(v) for k, v in tracks.items()}),
            to_torch(pos), to_torch(prev), to_torch(cc))


def chain_xla(cfg, segs, tracks, pos, prev, cc):
    """The JAX package's XLA chain update_tracks -> collision_probabilities
    -> select_top_k with the perceive-level reductions, vmapped and jitted."""
    def one(sg, tr, p, pp, c):
        nt = jrisk.update_tracks(cfg, tr, sg)
        cp, ego = jrisk.collision_probabilities(cfg, nt, p, pp)
        live = c & jnp.any(nt.valid)
        top_cp, top_pv = jrisk.select_top_k(cfg, nt, cp, live, p)
        cp_max = jnp.where(live, jnp.max(top_cp), 0.0)
        ego_cp = jnp.where(live, jnp.max(jnp.where(nt.valid, ego, 0.0)), 0.0)
        return nt, top_cp, top_pv, cp_max, ego_cp
    return jax.jit(jax.vmap(one))(segs, tracks, pos, prev, cc)


CHAIN_FIELDS = ("valid", "pos", "prev_pos", "has_prev", "dist", "speed",
                "vel", "top_cp", "top_pose_vel", "cp_max", "ego_cp")


def chain_leaves(out):
    """Flat list of the chain's outputs in CHAIN_FIELDS order, as numpy."""
    trk, top_cp, top_pv, cp_max, ego_cp = out
    vals = [getattr(trk, f) for f in CHAIN_FIELDS[:7]]
    vals += [top_cp, top_pv, cp_max, ego_cp]
    return [v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for v in vals]


def assert_chain_match(got, ref, msg=""):
    """bool outputs exact; float outputs within 1e-6 (abs and rel)."""
    for name, g, r in zip(CHAIN_FIELDS, chain_leaves(got), chain_leaves(ref)):
        if r.dtype == bool:
            np.testing.assert_array_equal(g, r, err_msg=f"{msg} {name}")
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{msg} {name}")


def export_module():
    """``scripts/export_torch_agent.py`` as a module (it is not a
    package's)."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "export_torch_agent",
        os.path.join(root, "scripts", "export_torch_agent.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def state_to_port(agent, jstate):
    """A JAX agent state (any algorithm) as the port's, through the
    exported arrays."""
    from crowdnav_tpu_torch.utils import convert
    arrays = export_module().state_arrays(jax.tree.map(np.asarray, jstate))
    return convert.state_from_arrays(agent, arrays)


def state_to_jax(agent, tstate, jtemplate):
    """The port's state as a JAX agent state of ``jtemplate``'s structure
    and dtypes (the inverse of :func:`state_to_port`)."""
    from crowdnav_tpu_torch.utils import convert
    arrays = convert.state_to_arrays(agent, tstate)

    def tree(t, prefix):
        return {k: tree(v, f"{prefix}/{k}") if isinstance(v, dict)
                else jnp.asarray(arrays[f"{prefix}/{k}"], v.dtype)
                for k, v in t.items()}

    kw = {}
    for f in dataclasses.fields(jtemplate):
        v = getattr(jtemplate, f.name)
        if isinstance(v, dict):
            kw[f.name] = {"params": tree(v["params"], f.name)}
        elif isinstance(v, tuple):
            inner = v[0]
            rep = {"nu": {"params": tree(inner.nu["params"],
                                         f"{f.name}/nu")}}
            if hasattr(inner, "mu"):
                rep["mu"] = {"params": tree(inner.mu["params"],
                                            f"{f.name}/mu")}
                rep["count"] = jnp.asarray(arrays[f"{f.name}/count"],
                                           inner.count.dtype)
            kw[f.name] = (inner._replace(**rep),) + tuple(v[1:])
        else:
            kw[f.name] = jnp.asarray(arrays[f.name], v.dtype)
    return jtemplate.replace(**kw)


def jax_noise_draws(cfg, states):
    """The per-step noise draws of the JAX step from ``states`` (before
    the step), as the port's ``step_batch(noise=...)`` takes them:
    ``"act"`` (the normal times ``actuation_noise``) and ``"dt"`` from
    ``world_step``'s ``k_act``/``k_dt`` keys, ``"lidar"`` from
    ``fold_in(key after the step, 7)``. Jitted, as the step computes
    them (XLA folds the normal's sqrt(2) into the noise scale)."""
    def one(key):
        new_key, _, k_act, k_dt = jax.random.split(key, 4)
        out = {}
        if cfg.actuation_noise > 0.0:
            out["act"] = jax.random.normal(k_act, (2,)) * cfg.actuation_noise
        if cfg.dt_jitter > 0.0:
            out["dt"] = jax.random.uniform(k_dt, (), minval=-cfg.dt_jitter,
                                           maxval=cfg.dt_jitter)
        if cfg.lidar_noise > 0.0:
            out["lidar"] = jax.random.normal(
                jax.random.fold_in(new_key, 7), (cfg.n_scans,)) \
                * cfg.lidar_noise
        return out
    return {k: to_torch(v) for k, v in jax.jit(jax.vmap(one))(
        states.key).items()}
