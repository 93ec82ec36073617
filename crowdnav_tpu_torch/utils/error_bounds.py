"""Float32 forward-error bounds of the learners (TD3, DDPG, SAC, DQN),
carried operation by operation in float64 (numpy), for holding two float32
evaluations of the same update (the port against the JAX package in the
tests; the card against the CPU in ``chip_smoke.py``) to a bound derived
from the arithmetic rather than a tolerance tuned on one host.

:class:`Bnd` is a float64 value and a bound on how far any float32
evaluation of the same formula can lie from it; :func:`critic_grad_bound`
and :func:`actor_grad_bound` evaluate TD3's and DDPG's losses' gradients
so, :func:`sac_grad_bounds` SAC's three and :func:`dqn_grad_bound` DQN's;
:func:`check_update` holds two results of one update of any of the four,
from one state, to what those bounds imply through the optimizers'
arithmetic (Adam's, RMSprop's). The numbers are
float64 on the host: nothing here runs on the card, and nothing of the
training path imports this module. It lives in the package, not beside
the tests, because ``chip_smoke.py`` holds the card's learner to it on a
machine where the script may import nothing of ``tests/``
(``tests/test_torch_rules.py``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from crowdnav_tpu_torch.models.networks import unflatten
from crowdnav_tpu_torch.utils.tree import to_device

U32 = 2.0 ** -24
U64 = 2.0 ** -53
U_BF16 = 2.0 ** -8

# the unit roundoff of the MLPs' compute dtype while :func:`lowp` is on
# (bfloat16), None for float32 networks
_LOWP = [None]


@contextlib.contextmanager
def lowp(u):
    """Bound the MLPs of :func:`bmlp` / :func:`bmlp_back` as computed in a
    storage format of unit roundoff ``u`` (TD3's ``compute_dtype=
    "bfloat16"``: ``u = 2^-8``): every dense layer's input, kernel and
    bias rounded to it, the products summed in float32 and the sum and the
    bias addition each rounded to it; in the backward, each incoming
    gradient and each of the layer's three products rounded to it. The
    rest of the update (losses, targets, Adam) stays float32."""
    prev, _LOWP[0] = _LOWP[0], u
    try:
        yield
    finally:
        _LOWP[0] = prev


def bround(x, u):
    """``x`` rounded to a format of unit roundoff ``u``."""
    x = _b(x)
    return Bnd(x.v, x.e + u * (np.abs(x.v) + x.e))


def _lp(x):
    """``x`` rounded to the MLPs' compute format (unchanged in float32)."""
    return x if _LOWP[0] is None else bround(x, _LOWP[0])


def gamma(m, u=U32):
    """Higham's gamma(m) = m u / (1 - m u): a sum or dot product of m
    terms, in any order and with any fused multiply-adds, has relative
    error at most gamma(m - 1) <= gamma(m) of the sum of |terms|."""
    return m * u / (1.0 - m * u)


class Bnd:
    """A float64 value ``v`` of a float32 computation and a bound ``e``
    with |(any float32 evaluation) - v| <= e, elementwise.

    Every operation adds the float32 rounding it may do (for an
    elementwise operation 3u of the largest possible float32 magnitude
    ``v + e``: three roundings, which covers the other framework's
    equivalent formulas, such as (g + g t)(1 - t) for g (1 - t^2); for a
    k-term dot product or sum gamma(k + 1)), carries its inputs' bounds
    to first and second order, and adds the float64 evaluation's own
    error (the same with 2^-53), so that ``v`` need not be exact. Library sigmoid/tanh are taken to within
    2^-20 of the correctly rounded result (16 float32 ulps). A ReLU whose
    pre-activation lies within its bound of 0 may switch either way in
    float32: its backward then carries the full gradient as the bound."""

    def __init__(self, v, e=None):
        self.v = np.asarray(v, np.float64)
        self.e = np.zeros_like(self.v) if e is None else np.asarray(e)

    @property
    def mag(self):
        return np.abs(self.v) + self.e

    def __getitem__(self, i):
        return Bnd(self.v[i], self.e[i])

    @property
    def T(self):
        return Bnd(self.v.T, self.e.T)


def _b(x):
    return x if isinstance(x, Bnd) else Bnd(x)


def bmatmul(a, b):
    a, b = _b(a), _b(b)
    k = a.v.shape[-1]
    av, bv = np.abs(a.v), np.abs(b.v)
    v = a.v @ b.v
    e = (av @ b.e + a.e @ bv + a.e @ b.e + gamma(k) * (a.mag @ b.mag)
         + gamma(k, U64) * (av @ bv))
    return Bnd(v, e)


def blinear(x, w, b):
    """``x @ w.T + b`` (torch's layout) with the bias summed as one more
    term."""
    x, w = _b(x), _b(w)
    b = _b(b)
    k = x.v.shape[-1] + 1
    v = x.v @ w.v.T + b.v
    e = (np.abs(x.v) @ w.e.T + x.e @ np.abs(w.v).T + x.e @ w.e.T + b.e
         + gamma(k) * (x.mag @ w.mag.T + b.mag)
         + gamma(k, U64) * (np.abs(x.v) @ np.abs(w.v).T + np.abs(b.v)))
    return Bnd(v, e)


def badd(a, b, sign=1.0):
    a, b = _b(a), _b(b)
    v = a.v + sign * b.v
    return Bnd(v, a.e + b.e + 3 * U32 * (a.mag + b.mag) + U64 * np.abs(v))


def bmul(a, b):
    a, b = _b(a), _b(b)
    v = a.v * b.v
    e = (np.abs(a.v) * b.e + a.e * np.abs(b.v) + a.e * b.e
         + 3 * U32 * a.mag * b.mag + U64 * np.abs(v))
    return Bnd(v, e)


def bsum(a, axis):
    a = _b(a)
    k = a.v.shape[axis]
    return Bnd(a.v.sum(axis), a.e.sum(axis) + gamma(k) * a.mag.sum(axis)
               + gamma(k, U64) * np.abs(a.v).sum(axis))


def bmean(a, axis):
    """A sum, then one rounded division (or product with 1/k)."""
    s = bsum(a, axis)
    k = a.v.shape[axis]
    return Bnd(s.v / k, s.e / k + 2 * U32 * s.mag / k)


def bmean_all(a):
    """The mean of every element."""
    a = _b(a)
    return bmean(Bnd(a.v.reshape(-1), a.e.reshape(-1)), 0)


def brelu(z):
    return Bnd(np.maximum(z.v, 0.0), z.e)


def brelu_back(z, g):
    """``g * (z > 0)``; where |z| <= its bound the mask may differ."""
    g = _b(g)
    on = z.v > 0
    sure = np.abs(z.v) > z.e
    e = np.where(sure, g.e * on, np.abs(g.v) + g.e)
    return Bnd(g.v * on, e)


def bminimum(a, b):
    return Bnd(np.minimum(a.v, b.v), np.maximum(a.e, b.e))


def bclip(a, lo, hi):
    return Bnd(np.clip(a.v, lo, hi), a.e)


def _lib(v, e):
    return Bnd(v, e + 2.0 ** -20 * (np.abs(v) + e) + U64 * np.abs(v))


def bsigmoid(z):
    near0 = np.sign(z.v) * np.maximum(np.abs(z.v) - z.e, 0.0)
    s0 = 1.0 / (1.0 + np.exp(-near0))
    return _lib(1.0 / (1.0 + np.exp(-z.v)), s0 * (1.0 - s0) * z.e)


def btanh(z):
    near0 = np.sign(z.v) * np.maximum(np.abs(z.v) - z.e, 0.0)
    return _lib(np.tanh(z.v), (1.0 - np.tanh(near0) ** 2) * z.e)


def bexp(z):
    """Library exp: the slope at the interval's top carries the bound."""
    return _lib(np.exp(z.v), np.exp(z.v + z.e) * z.e)


def blog(x):
    """Library log of a positive value: the slope at the interval's
    bottom carries the bound (unbounded if the interval reaches 0)."""
    lo = x.v - x.e
    with np.errstate(divide="ignore"):
        slope = np.where(lo > 0, 1.0 / np.maximum(lo, 1e-300), np.inf)
    return _lib(np.log(x.v), slope * x.e)


def bdiv(a, b):
    """``a / b``, ``b`` bounded away from 0."""
    a, b = _b(a), _b(b)
    v = a.v / b.v
    lo = np.abs(b.v) - b.e
    with np.errstate(divide="ignore"):
        e = np.where(lo > 0, (a.e + np.abs(v) * b.e) / np.maximum(lo, 1e-300),
                     np.inf)
    mag = np.abs(v) + e
    return Bnd(v, e + 3 * U32 * mag + U64 * np.abs(v))


def bmax(a, axis):
    """The maximum along ``axis``: within the largest bound."""
    return Bnd(a.v.max(axis), a.e.max(axis))


def bconcat(parts, axis=-1):
    parts = [_b(p) for p in parts]
    return Bnd(np.concatenate([p.v for p in parts], axis),
               np.concatenate([p.e for p in parts], axis))


def _dense(p, name, h):
    z = blinear(h, _lp(p[f"{name}.weight"]), _lp(p[f"{name}.bias"]))
    return _lp(_lp(z))     # the sum, then the bias addition


def bmlp(p, prefix, x, n=3):
    """Forward of an ``n``-layer ReLU MLP; returns (out, [x, z1, h1, ...,
    z_{n-1}, h_{n-1}])."""
    x = _lp(x)
    acts, h = [x], x
    for i in range(n - 1):
        z = _dense(p, f"{prefix}dense{i}", h)
        h = brelu(z)
        acts += [z, h]
    out = _dense(p, f"{prefix}dense{n - 1}", h)
    return out, tuple(acts)


def _layer_back(p, name, x, dz, g):
    dz = _lp(dz)
    g[f"{name}.weight"] = _lp(bmatmul(dz.T, x))
    g[f"{name}.bias"] = _lp(bsum(dz, 0))
    return _lp(bmatmul(dz, _lp(p[f"{name}.weight"])))


def bmlp_back(p, prefix, acts, dout, heads=None):
    """Backward of :func:`bmlp` from d(out): ``({param: grad}, d(input))``.
    ``heads``: ``[(layer index, d(that layer's output))]`` for a trunk with
    several output layers on its last hidden state (SAC's actor); the
    trunk is then ``acts`` without an output layer."""
    n_hidden = (len(acts) - 1) // 2
    g = {}
    if heads is None:
        heads = [(n_hidden, dout)]
    h = acts[-1]
    dh = None
    for idx, d in heads:
        part = _layer_back(p, f"{prefix}dense{idx}", h, d, g)
        dh = part if dh is None else badd(dh, part)
    for i in range(n_hidden - 1, -1, -1):
        z, x = acts[2 * i + 1], acts[2 * i]
        dh = _layer_back(p, f"{prefix}dense{i}", x, brelu_back(z, dh), g)
    return g, dh


def flat_bnd(grads: dict, names) -> Bnd:
    """The gradients of ``names`` (a layout's order) as one flat Bnd."""
    return Bnd(np.concatenate([grads[n].v.reshape(-1) for n in names]),
               np.concatenate([grads[n].e.reshape(-1) for n in names]))


def _np_params(d):
    return {k: v.double().numpy() for k, v in d.items()}


def _scaled(cfg, sig, th):
    return bconcat([bmul(sig, float(np.float32(cfg.max_lin_vel))),
                    bmul(th, float(np.float32(cfg.max_ang_vel)))])


def _actor_heads_bnd(p, obs):
    raw, acts = bmlp(p, "", obs)
    return bsigmoid(raw[:, 0:1]), btanh(raw[:, 1:2]), acts


def critic_grad_bound(tagent, state, b, noise):
    """``(loss, y, flat gradient)`` of the critics' TD loss as :class:`Bnd`,
    for the learner state ``state`` (CPU tensors), the batch ``b`` = (obs,
    action, reward, next_obs, done) as float32-valued arrays and the
    standard-normal smoothing noise."""
    f32, cfg = np.float32, tagent.cfg
    obs, act, rew, nxt, done = (np.asarray(x, np.float64) for x in b)
    noise = np.asarray(noise, np.float64)
    at = _np_params(tagent.actor_params(state.actor_target))
    ct = _np_params(tagent.critic_params(state.critic_target))
    cp = _np_params(tagent.critic_params(state.critic_params))
    sig, th, _ = _actor_heads_bnd(at, nxt)
    clip = float(f32(cfg.noise_clip))
    smooth = bclip(bmul(noise, float(f32(cfg.policy_noise))), -clip, clip)
    na = badd(_scaled(cfg, sig, th), smooth)
    xt = bconcat([nxt, na])
    tmin = bminimum(bmlp(ct, "q1.", xt)[0], bmlp(ct, "q2.", xt)[0])
    c = ((1.0 - done) * float(f32(cfg.gamma)))[:, None]
    y = badd(rew[:, None], bmul(c, tmin))
    x = np.concatenate([obs, act], -1)
    grads, loss = {}, None
    for head in ("q1", "q2"):
        q, acts = bmlp(cp, f"{head}.", x)
        r = badd(q, y, -1.0)
        term = bmean(bmul(r, r), 0)
        loss = term if loss is None else badd(loss, term)
        dq = bmul(bmul(r, 2.0), 1.0 / r.v.shape[0])
        g, _ = bmlp_back(cp, f"{head}.", acts, dq)
        grads.update(g)
    names = [n for n, _ in tagent.critic_layout]
    return loss, y, flat_bnd(grads, names)


def ddpg_critic_grad_bound(agent, state, b):
    """``(loss, y, flat gradient)`` of DDPG's critic loss as :class:`Bnd`:
    one critic, the target action unsmoothed."""
    f32, cfg = np.float32, agent.cfg
    obs, act, rew, nxt, done = (np.asarray(x, np.float64) for x in b)
    at = _np_params(agent.actor_params(state.actor_target))
    ct = _np_params(agent.critic_params(state.critic_target))
    cp = _np_params(agent.critic_params(state.critic_params))
    sig, th, _ = _actor_heads_bnd(at, nxt)
    tq, _ = bmlp(ct, "", bconcat([nxt, _scaled(cfg, sig, th)]))
    c = ((1.0 - done) * float(f32(cfg.gamma)))[:, None]
    y = badd(rew[:, None], bmul(c, tq))
    q, acts = bmlp(cp, "", np.concatenate([obs, act], -1))
    r = badd(q, y, -1.0)
    loss = bmean(bmul(r, r), 0)
    g, _ = bmlp_back(cp, "", acts, bmul(bmul(r, 2.0), 1.0 / r.v.shape[0]))
    return loss, y, flat_bnd(g, [n for n, _ in agent.layouts["critic"]])


def actor_grad_bound(tagent, actor_flat, critic_flat, critic_err, obs,
                     head="q1."):
    """``(loss, flat gradient)`` of the actor's loss as :class:`Bnd`, under
    the critic ``critic_flat`` whose float32 values may lie up to
    ``critic_err`` (per parameter) from it; ``head``: the critic's prefix
    (TD3's ``q1.``, DDPG's single critic ``""``)."""
    cfg = tagent.cfg
    ap = _np_params(tagent.actor_params(actor_flat))
    cv = _np_params(tagent.critic_params(critic_flat))
    ce = {k: v.numpy() for k, v in tagent.critic_params(
        torch.from_numpy(critic_err)).items()}
    cp = {k: Bnd(cv[k], ce[k]) for k in cv}
    obs = np.asarray(obs, np.float64)
    n, d = obs.shape
    sig, th, acts_a = _actor_heads_bnd(ap, obs)
    x = bconcat([obs, _scaled(cfg, sig, th)])
    q1, acts_c = bmlp(cp, head, x)
    loss = bmul(bmean(q1, 0), -1.0)
    _, dx = bmlp_back(cp, head, acts_c, Bnd(np.full((n, 1), -1.0 / n)))
    da = dx[:, d:]
    dsig = bmul(bmul(da[:, 0:1], float(np.float32(cfg.max_lin_vel))),
                bmul(sig, badd(1.0, sig, -1.0)))
    dth = bmul(bmul(da[:, 1:2], float(np.float32(cfg.max_ang_vel))),
               badd(1.0, bmul(th, th), -1.0))
    g, _ = bmlp_back(ap, "", acts_a, bconcat([dsig, dth]))
    return loss, flat_bnd(g, [n_ for n_, _ in tagent.layouts["actor"]])


def _bparams(agent, net, flat, err=None):
    """A network's parameters as :class:`Bnd` around the float32 values
    ``flat``, each within ``err`` (per parameter) or exact."""
    v = _np_params(unflatten(flat.detach().cpu(), agent.layouts[net]))
    if err is None:
        return {k: Bnd(x) for k, x in v.items()}
    e = unflatten(torch.from_numpy(err), agent.layouts[net])
    return {k: Bnd(x, e[k].numpy()) for k, x in v.items()}


def actor_action_bound(agent, actor_flat, obs) -> Bnd:
    """The clipped greedy action of a deterministic actor (TD3's, DDPG's)
    with the flat parameters ``actor_flat``, for the observations ``obs``
    (N, obs_dim), as :class:`Bnd`."""
    cfg = agent.cfg
    ap = _bparams(agent, "actor", actor_flat)
    sig, th, _ = _actor_heads_bnd(ap, np.asarray(obs, np.float64))
    return bclip(_scaled(cfg, sig, th), np.array([0.0, -_f(cfg.max_ang_vel)]),
                 np.array([_f(cfg.max_lin_vel), _f(cfg.max_ang_vel)]))


def bclip_back(x, lo, hi, g):
    """``g`` where ``lo <= x <= hi``; where ``x`` lies within its bound of
    an edge the mask may differ."""
    g = _b(g)
    inside = (x.v >= lo) & (x.v <= hi)
    sure = (x.v - x.e > lo) & (x.v + x.e < hi) | (x.v + x.e < lo) \
        | (x.v - x.e > hi)
    e = np.where(sure, g.e * inside, np.abs(g.v) + g.e)
    return Bnd(g.v * inside, e)


def sac_sample_bound(agent, ap, obs, noise):
    """SAC's ``sample`` as :class:`Bnd`: a dict of the forward values
    (``mean``, ``ls``, ``std``, ``z``, ``a``, ``d1`` = z - mean, ``t`` =
    d1 / std, ``w`` = 1 - a^2 + 1e-6, ``lp`` (B, 1), ``action``) and the
    trunk's activations ``acts``."""
    cfg, f = agent.cfg, _f
    x = np.asarray(obs, np.float64)
    trunk, h = [x], x
    for i in range(2):
        z_ = blinear(h, ap[f"dense{i}.weight"], ap[f"dense{i}.bias"])
        h = brelu(z_)
        trunk += [z_, h]
    fw = {"acts": tuple(trunk)}
    fw["mean"] = blinear(h, ap["dense2.weight"], ap["dense2.bias"])
    fw["lsr"] = blinear(h, ap["dense3.weight"], ap["dense3.bias"])
    fw["ls"] = bclip(fw["lsr"], -20.0, 2.0)
    fw["std"] = std = bexp(fw["ls"])
    fw["z"] = z = badd(fw["mean"], bmul(std, np.asarray(noise, np.float64)))
    fw["a"] = a = btanh(z)
    fw["d1"] = d1 = badd(z, fw["mean"], -1.0)
    fw["t"] = t = bdiv(d1, std)
    fw["w"] = w = badd(badd(1.0, bmul(a, a), -1.0), f(1e-6))
    e = badd(badd(badd(bmul(bmul(t, t), -0.5), blog(std), -1.0),
                  f(0.5 * np.log(2 * np.pi)), -1.0), blog(w), -1.0)
    lp = bsum(e, -1)
    fw["lp"] = Bnd(lp.v[:, None], lp.e[:, None])
    fw["action"] = bconcat([bmul(bsigmoid(a[:, 0:1]), f(cfg.max_lin_vel)),
                            bmul(btanh(a[:, 1:2]), f(cfg.max_ang_vel))])
    return fw


def sac_policy_bound(agent, ap, fw, adv, noise):
    """``(loss, flat gradient)`` of SAC's policy loss as :class:`Bnd`, by
    the chain rule of its forward (``fw`` of :func:`sac_sample_bound`, the
    advantage ``adv`` (B, 1) held constant), operation for operation as
    automatic differentiation evaluates it."""
    cfg, f = agent.cfg, _f
    n, k = fw["mean"].v.shape
    lm, lsd, lz = f(cfg.mean_lambda), f(cfg.std_lambda), f(cfg.z_lambda)
    mean, ls, std, z, a = fw["mean"], fw["ls"], fw["std"], fw["z"], fw["a"]
    d1, t, w, lp = fw["d1"], fw["t"], fw["w"], fw["lp"]
    loss = bmean(bmul(lp, adv), 0)
    loss = badd(loss, bmul(bmean_all(bmul(mean, mean)), lm))
    loss = badd(loss, bmul(bmean_all(bmul(ls, ls)), lsd))
    loss = badd(loss, bmul(bmean(bsum(bmul(z, z), 1), 0), lz))
    g_lp = bmul(adv, 1.0 / n)
    g_e = Bnd(np.broadcast_to(g_lp.v, (n, k)), np.broadcast_to(g_lp.e, (n, k)))
    neg = bmul(g_e, -1.0)
    g_t = bmul(bmul(t, 2.0), bmul(g_e, -0.5))
    g_d1 = bdiv(g_t, std)
    g_std = badd(bmul(bdiv(bmul(g_t, d1), bmul(std, std)), -1.0),
                 bdiv(neg, std))
    g_a = bmul(bmul(a, 2.0), bmul(bdiv(neg, w), -1.0))
    g_z = badd(bmul(g_a, badd(1.0, bmul(a, a), -1.0)), g_d1)
    g_z = badd(g_z, bmul(z, 2.0 * lz / n))
    g_mean = badd(badd(g_z, g_d1, -1.0), bmul(mean, 2.0 * lm / (n * k)))
    g_std = badd(g_std, bmul(g_z, np.asarray(noise, np.float64)))
    g_ls = badd(bmul(g_std, std), bmul(ls, 2.0 * lsd / (n * k)))
    g_lsr = bclip_back(fw["lsr"], -20.0, 2.0, g_ls)
    g, _ = bmlp_back(ap, "", fw["acts"], None,
                     heads=[(2, g_mean), (3, g_lsr)])
    return loss, flat_bnd(g, [n_ for n_, _ in agent.layouts["actor"]])


def _sac_value_policy(agent, state, b, noise, q_flat, q_err, v_flat, v_err):
    """SAC's value loss and gradient and its policy loss and gradient as
    :class:`Bnd`, for the updated soft-Q and value networks ``q_flat`` and
    ``v_flat`` whose float32 values may lie within ``q_err`` and ``v_err``
    of them."""
    obs = np.asarray(b[0], np.float64)
    n = obs.shape[0]
    ap = _bparams(agent, "actor", state.actor_params)
    fw = sac_sample_bound(agent, ap, obs, noise)
    qn = _bparams(agent, "soft_q", q_flat, q_err)
    eq, _ = bmlp(qn, "", bconcat([obs, fw["action"]]))
    next_value = badd(eq, fw["lp"], -1.0)
    vp = _bparams(agent, "value", state.value_params)
    v, acts = bmlp(vp, "", obs)
    r = badd(v, next_value, -1.0)
    v_loss = bmean(bmul(r, r), 0)
    gv, _ = bmlp_back(vp, "", acts, bmul(bmul(r, 2.0), 1.0 / n))
    v_grad = flat_bnd(gv, [k for k, _ in agent.layouts["value"]])
    ev, _ = bmlp(_bparams(agent, "value", v_flat, v_err), "", obs)
    adv = badd(fw["lp"], badd(eq, ev, -1.0), -1.0)
    p_loss, p_grad = sac_policy_bound(agent, ap, fw, adv, noise)
    return v_loss, v_grad, p_loss, p_grad


def sac_grad_bounds(agent, state, b):
    """``(q_loss, next_q, flat q gradient)`` of SAC's soft-Q loss as
    :class:`Bnd` (from the value target)."""
    f32, cfg = np.float32, agent.cfg
    obs, act, rew, nxt, done = (np.asarray(x, np.float64) for x in b)
    tv, _ = bmlp(_bparams(agent, "value", state.value_target), "", nxt)
    c = ((1.0 - done) * float(f32(cfg.gamma)))[:, None]
    next_q = badd(rew[:, None], bmul(c, tv))
    qp = _bparams(agent, "soft_q", state.soft_q_params)
    q, acts = bmlp(qp, "", np.concatenate([obs, act], -1))
    r = badd(q, next_q, -1.0)
    loss = bmean(bmul(r, r), 0)
    g, _ = bmlp_back(qp, "", acts, bmul(bmul(r, 2.0), 1.0 / r.v.shape[0]))
    return loss, next_q, flat_bnd(g, [k for k, _ in agent.layouts["soft_q"]])


def dqn_grad_bound(agent, state, b):
    """``(loss, target, flat gradient)`` of DQN's loss as :class:`Bnd`:
    the max over the target network's Q, the gather of the taken action's
    Q, the mean square."""
    f32, cfg = np.float32, agent.cfg
    obs, _, rew, nxt, done = (np.asarray(x, np.float64) for x in b)
    act = np.asarray(b[1]).astype(np.int64)
    nl = agent.n_layers
    pt = _bparams(agent, "q", state.target_params)
    nq, _ = bmlp(pt, "", nxt, nl)
    c = (1.0 - done) * float(f32(cfg.gamma))
    target = badd(rew, bmul(c, bmax(nq, -1)))
    p = _bparams(agent, "q", state.params)
    q, acts = bmlp(p, "", obs, nl)
    rows = np.arange(obs.shape[0])
    r = badd(q[rows, act], target, -1.0)
    loss = bmean(bmul(r, r), 0)
    dr = bmul(bmul(r, 2.0), 1.0 / obs.shape[0])
    dq_v, dq_e = np.zeros_like(q.v), np.zeros_like(q.v)
    dq_v[rows, act], dq_e[rows, act] = dr.v, dr.e
    g, _ = bmlp_back(p, "", acts, Bnd(dq_v, dq_e))
    return loss, target, flat_bnd(g, [k for k, _ in agent.layouts["q"]])


def within(name, got, bnd):
    """Assert every element of ``got`` within its bound; the largest share
    of the bound used."""
    if not np.isfinite(bnd.e).all():
        raise AssertionError(f"{name}: the bound is not finite (an "
                             f"ill-conditioned input)")
    d = np.abs(np.asarray(got, np.float64).reshape(bnd.v.shape) - bnd.v)
    ratio = d / np.maximum(bnd.e, 1e-300)
    if not (d <= bnd.e).all():
        raise AssertionError(f"{name}: {float(ratio.max())} of its bound")
    return float(ratio.max())


def close(name, a, b, bound, expect=0.0):
    """Assert |a - b - expect| <= bound plus the two values' own rounding
    (``expect``: the float64 difference the two should have); the largest
    share of that limit used."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lim = bound + 2 * U32 * (np.abs(a) + np.abs(b))
    if not np.isfinite(lim).all():
        raise AssertionError(f"{name}: the bound is not finite")
    d = np.abs(a - b - expect)
    if not (d <= lim).all():
        raise AssertionError(
            f"{name}: {float((d / np.maximum(lim, 1e-300)).max())} of its "
            f"bound")
    return float((d / np.maximum(lim, 1e-300)).max())


def _np(t):
    return np.asarray(t.detach().cpu().double().numpy())


def _f(x):
    return float(np.float32(x))


def moment_bounds(tx, grad, e, mu0, nu0):
    """Bounds on |mu_a - mu_b| and |nu_a - nu_b| of two float32 Adam steps
    from the same moments ``mu0``, ``nu0`` whose gradients both lie within
    ``e`` of ``grad`` (float64): (1 - b) times the gradient terms'
    difference, plus the products' roundings on each side."""
    c1, c2 = _f(1 - tx.b1), _f(1 - tx.b2)
    mag = np.abs(grad) + e
    mu = c1 * 2 * e + 2 * U32 * (c1 * mag + _f(tx.b1) * np.abs(mu0))
    nu = (c2 * 2 * e * 2 * mag
          + 2 * U32 * (2 * c2 * mag * mag + _f(tx.b2) * np.abs(nu0)))
    return mu, nu


def adam_ratio(tx, mu, nu, count):
    """m_hat / (sqrt(v_hat) + eps) in float64 from float32 moments, with
    the float32 bias corrections ``1 - powf(b, count)`` that both
    frameworks use (``agents/optim.bias_correction``)."""
    from crowdnav_tpu_torch.agents.optim import bias_correction
    t = torch.tensor(count, dtype=torch.int32)
    c1 = float(bias_correction(tx.b1, t))
    c2 = float(bias_correction(tx.b2, t))
    return (mu / c1) / (np.sqrt(nu / c2) + _f(tx.eps))


def param_diff(tx, new_a, new_b, opt):
    """``(expect, bound)`` for p_a - p_b of two float32 Adam steps from the
    same parameters, given each side's own new moments: the difference is
    -lr times the float64 difference of their steps m_hat / (sqrt(v_hat) +
    eps), within 8u of each step (the float32 evaluation of a step from
    its moments rounds six times: two divisions by the bias corrections,
    the square root, the sum with eps, the division, the product with -lr:
    5.5u), and within the sums' own rounding (:func:`close`)."""
    oa, ob = getattr(new_a, opt), getattr(new_b, opt)
    count = int(ob.count)
    ra = adam_ratio(tx, _np(oa.mu), _np(oa.nu), count)
    rb = adam_ratio(tx, _np(ob.mu), _np(ob.nu), count)
    lr = _f(tx.lr)
    return -lr * (ra - rb), 8 * U32 * lr * (np.abs(ra) + np.abs(rb))


def _counts(state, new_a, new_b, fields):
    """Each counter exactly one past the state's on both sides."""
    for name in fields:
        def get(x):
            v = x
            for part in name.split("."):
                v = getattr(v, part)
            return int(v)
        if not get(new_a) == get(new_b) == get(state) + 1:
            raise AssertionError(name)


def _adam(shares, name, tx, grad, state, new_a, new_b, opt, params):
    """The Adam step of ``params`` from two gradients within ``grad``'s
    bound (None: two zero gradients, the moments then equal within their
    own rounding): moments (:func:`moment_bounds`), parameters
    (:func:`param_diff`)."""
    so = getattr(state, opt)
    if grad is None:
        mu = nu = 0.0
    else:
        mu, nu = moment_bounds(tx, grad.v, grad.e, _np(so.mu), _np(so.nu))
    a, b = getattr(new_a, opt), getattr(new_b, opt)
    shares[f"{name}_mu"] = close(f"{name} mu", _np(a.mu), _np(b.mu), mu)
    shares[f"{name}_nu"] = close(f"{name} nu", _np(a.nu), _np(b.nu), nu)
    expect, bound = param_diff(tx, new_a, new_b, opt)
    shares[f"{name}_params"] = close(
        f"{name} params", _np(getattr(new_a, params)),
        _np(getattr(new_b, params)), bound, expect)


def _soft(shares, tau, state, new_a, new_b, target, online):
    """A soft target update: the targets' difference is tau times the
    online parameters' actual difference, within its rounding."""
    a, bb = _np(getattr(new_a, target)), _np(getattr(new_b, target))
    pa, pb = _np(getattr(new_a, online)), _np(getattr(new_b, online))
    t0 = np.abs(_np(getattr(state, target)))
    shares[target] = close(
        target, a, bb, 2 * U32 * (2 * t0 + tau * (np.abs(pa) + np.abs(pb))),
        tau * (pa - pb))


def check_update(agent, state, batch, noise, new_a, new_b, metrics_b=None):
    """Hold two float32 results ``new_a`` and ``new_b`` of one update of
    ``agent`` (TD3, DDPG, SAC or DQN) from the same ``state`` (CPU
    tensors), batch and update draws ``noise`` (TD3's smoothing noise,
    SAC's normal, None for the others) to the derived bounds, and return
    the largest share of each bound used. ``metrics_b``: ``new_b``'s
    metrics, held to their bounds. The shares ending in ``_grad`` are
    those of ``agent``'s own gradients from ``state``, evaluated on its
    device."""
    kind = type(agent).__name__
    if getattr(agent, "dtype", torch.float32) == torch.bfloat16:
        with lowp(U_BF16):
            return _check_td3(agent, state, batch, noise, new_a, new_b,
                              metrics_b)
    if kind == "DDPG":
        return _check_ddpg(agent, state, batch, new_a, new_b, metrics_b)
    if kind == "SAC":
        return _check_sac(agent, state, batch, noise, new_a, new_b,
                          metrics_b)
    if kind == "DQN":
        return _check_dqn(agent, state, batch, new_a, new_b, metrics_b)
    return _check_td3(agent, state, batch, noise, new_a, new_b, metrics_b)


def _check_td3(agent, state, batch, noise, new_a, new_b, metrics_b=None):
    """TD3: the critics' gradients both lie within their bound around a
    float64 evaluation (:func:`critic_grad_bound`), so each Adam moment
    moves by (1 - b) times gradients that close (:func:`moment_bounds`);
    the actor's gradient is bounded the same way under ``new_b``'s critic
    with ``new_a``'s critic at its actual distance from it
    (:func:`actor_grad_bound`), and is zero on a non-policy update. Each
    parameter vector lies within lr times the difference of the two sides'
    own Adam steps, recomputed in float64 from their moments, to within
    the steps' rounding (:func:`param_diff`); the targets' difference
    equals tau times the parameters' actual difference to within the
    rounding of the soft update on a policy update, and is zero otherwise;
    counts are equal."""
    cfg = agent.cfg
    ctx, atx = agent.critic_tx, agent.actor_tx
    b = [_np(x) for x in batch]
    loss_b, y_b, cg_b = critic_grad_bound(agent, state, b, _np(noise))
    _counts(state, new_a, new_b, ("actor_opt.count", "critic_opt.count",
                                  "update_count"))
    shares = {}
    _adam(shares, "critic", ctx, cg_b, state, new_a, new_b, "critic_opt",
          "critic_params")
    crit_a = _np(new_a.critic_params)
    crit_b = new_b.critic_params.detach().cpu()
    # the actor's gradient under new_b's critic: exactly those float32
    # values (for agent's own gradient and new_b's metric), and with the
    # critic anywhere within its actual distance from new_a's (whose
    # critic new_a's actor step used)
    crit_err = np.abs(crit_a - _np(crit_b))
    a_loss_b, ag_b = actor_grad_bound(agent, state.actor_params.cpu(),
                                      crit_b, np.zeros_like(crit_err), b[0])
    _, ag_far = actor_grad_bound(agent, state.actor_params.cpu(), crit_b,
                                 crit_err, b[0])
    policy = int(state.update_count) % cfg.policy_update == 0
    _adam(shares, "actor", atx, ag_far if policy else None, state, new_a,
          new_b, "actor_opt", "actor_params")
    tau = _f(cfg.tau)
    for name, online in (("actor_target", "actor_params"),
                         ("critic_target", "critic_params")):
        a, bb = _np(getattr(new_a, name)), _np(getattr(new_b, name))
        if policy:
            _soft(shares, tau, state, new_a, new_b, name, online)
        elif not np.array_equal(a, bb) or not np.array_equal(
                a, _np(getattr(state, name))):
            raise AssertionError(f"{name} moved on a non-policy update")
        else:
            shares[name] = 0.0
    if metrics_b is not None:
        within("critic_loss", _np(metrics_b["critic_loss"]), loss_b)
        within("q_target_mean", _np(metrics_b["q_target_mean"]),
               bmean(y_b, 0))
        within("actor_loss", _np(metrics_b["actor_loss"]), a_loss_b)
    # the agent's own gradients from ``state``, on its device, within
    # their bounds
    dev = agent.device
    st = to_device(state, dev)
    batch = to_device(batch, dev)
    obs = batch[0].float()
    y = agent.td_target(st, batch, noise.to(dev))
    _, c_grad = agent.critic_grad(st.critic_params, obs, batch[1], y)
    _, a_grad = agent.actor_grad(st.actor_params, crit_b.to(dev), obs)
    shares["critic_grad"] = within("critic grad", _np(c_grad), cg_b)
    shares["actor_grad"] = within("actor grad", _np(a_grad), ag_b)
    return shares


def _check_ddpg(agent, state, batch, new_a, new_b, metrics_b=None):
    """DDPG: TD3's pieces with one critic, no smoothing and no delay (the
    actor steps and the targets move on every update); the OU carry is
    untouched."""
    b = [_np(x) for x in batch]
    loss_b, _, cg_b = ddpg_critic_grad_bound(agent, state, b)
    _counts(state, new_a, new_b, ("actor_opt.count", "critic_opt.count"))
    shares = {}
    _adam(shares, "critic", agent.critic_tx, cg_b, state, new_a, new_b,
          "critic_opt", "critic_params")
    crit_b = new_b.critic_params.detach().cpu()
    crit_err = np.abs(_np(new_a.critic_params) - _np(crit_b))
    a_loss_b, ag_b = actor_grad_bound(agent, state.actor_params.cpu(),
                                      crit_b, np.zeros_like(crit_err), b[0],
                                      head="")
    _, ag_far = actor_grad_bound(agent, state.actor_params.cpu(), crit_b,
                                 crit_err, b[0], head="")
    _adam(shares, "actor", agent.actor_tx, ag_far, state, new_a, new_b,
          "actor_opt", "actor_params")
    tau = _f(agent.cfg.tau)
    _soft(shares, tau, state, new_a, new_b, "actor_target", "actor_params")
    _soft(shares, tau, state, new_a, new_b, "critic_target",
          "critic_params")
    for side in (new_a, new_b):
        if not np.array_equal(_np(side.ou_state), _np(state.ou_state)):
            raise AssertionError("the update moved the OU carry")
    if metrics_b is not None:
        within("critic_loss", _np(metrics_b["critic_loss"]), loss_b)
        within("actor_loss", _np(metrics_b["actor_loss"]), a_loss_b)
    dev = agent.device
    st, batch = to_device(state, dev), to_device(batch, dev)
    obs = batch[0].float()
    y = agent.td_target(st, batch)
    _, c_grad = agent.critic_grad(st.critic_params, obs, batch[1], y)
    _, a_grad = agent.actor_grad(st.actor_params, crit_b.to(dev), obs)
    shares["critic_grad"] = within("critic grad", _np(c_grad), cg_b)
    shares["actor_grad"] = within("actor grad", _np(a_grad), ag_b)
    return shares


def _check_sac(agent, state, batch, noise, new_a, new_b, metrics_b=None):
    """SAC: the soft-Q gradient within its bound (:func:`sac_grad_bounds`);
    the value gradient under the updated soft-Q network, and the policy
    gradient under the updated soft-Q and value networks, with ``new_a``'s
    networks at their actual distance from ``new_b``'s
    (:func:`sac_policy_bound`, through the library ``exp``, ``log``,
    ``tanh`` and ``sigmoid``); three Adam steps as TD3's; the value target
    tau times the value network's actual difference."""
    b = [_np(x) for x in batch]
    noise = _np(noise)
    q_loss, _, qg = sac_grad_bounds(agent, state, b)
    _counts(state, new_a, new_b, ("actor_opt.count", "value_opt.count",
                                  "soft_q_opt.count"))
    shares = {}
    _adam(shares, "soft_q", agent.soft_q_tx, qg, state, new_a, new_b,
          "soft_q_opt", "soft_q_params")
    q_b = new_b.soft_q_params.detach().cpu()
    v_b = new_b.value_params.detach().cpu()
    q_err = np.abs(_np(new_a.soft_q_params) - _np(q_b))
    v_err = np.abs(_np(new_a.value_params) - _np(v_b))
    own = _sac_value_policy(agent, state, b, noise, q_b, None, v_b, None)
    far = _sac_value_policy(agent, state, b, noise, q_b, q_err, v_b, v_err)
    _adam(shares, "value", agent.value_tx, far[1], state, new_a, new_b,
          "value_opt", "value_params")
    _adam(shares, "actor", agent.actor_tx, far[3], state, new_a, new_b,
          "actor_opt", "actor_params")
    _soft(shares, _f(agent.cfg.tau), state, new_a, new_b, "value_target",
          "value_params")
    if metrics_b is not None:
        within("q_loss", _np(metrics_b["q_loss"]), q_loss)
        within("value_loss", _np(metrics_b["value_loss"]), own[0])
        within("policy_loss", _np(metrics_b["policy_loss"]), own[2])
    dev = agent.device
    st, batch = to_device(state, dev), to_device(batch, dev)
    obs, nz = batch[0].float(), torch.from_numpy(noise).float().to(dev)
    gamma = _f(agent.cfg.gamma)
    tv = agent.value_apply(agent.params("value", st.value_target), batch[3])
    next_q = batch[2][:, None] + (1.0 - batch[4][:, None]) * gamma * tv
    _, q_grad = agent.q_grad(st.soft_q_params, obs, batch[1], next_q)
    _, lp = agent.sample(agent.params("actor", st.actor_params), obs,
                         nz)[:2]
    new_action = agent.sample(agent.params("actor", st.actor_params), obs,
                              nz)[0]
    eq = agent.q_apply(agent.params("soft_q", q_b.to(dev)), obs, new_action)
    _, v_grad = agent.value_grad(st.value_params, obs, eq - lp)
    ev = agent.value_apply(agent.params("value", v_b.to(dev)), obs)
    _, p_grad = agent.policy_grad(st.actor_params, obs, nz, eq - ev)
    shares["q_grad"] = within("soft-q grad", _np(q_grad), qg)
    shares["value_grad"] = within("value grad", _np(v_grad), own[1])
    shares["policy_grad"] = within("policy grad", _np(p_grad), own[3])
    return shares


def _rms_grad_interval(g, nu_side, nu0, c, d):
    """Each side's gradient as an interval: within the gradient's bound
    of ``g``, and, where its sign is sure, with the magnitude its own new
    moment implies: ``nu = c g^2 (1+d1)(1+d2) (1+d4) + d nu0 (1+d3)(1+d4)``
    with each |d| <= u (the moment's three roundings)."""
    lo, hi = g.v - g.e, g.v + g.e
    u = U32
    num_lo = nu_side / (1 + u) - d * nu0 * (1 + u)
    num_hi = nu_side / (1 - u) - d * nu0 * (1 - u)
    m_lo = np.sqrt(np.maximum(num_lo, 0.0) / (c * (1 + u) ** 2))
    m_hi = np.sqrt(np.maximum(num_hi, 0.0) / (c * (1 - u) ** 2))
    pos, neg = lo > 0, hi < 0
    lo = np.where(pos, np.maximum(lo, m_lo), np.where(neg, np.maximum(
        lo, -m_hi), lo))
    hi = np.where(pos, np.minimum(hi, m_hi), np.where(neg, np.minimum(
        hi, -m_lo), hi))
    if (lo > hi).any():
        raise AssertionError("a side's moment is not that of a gradient "
                             "within its bound")
    return lo, hi


def _check_dqn(agent, state, batch, new_a, new_b, metrics_b=None):
    """DQN: the gradient within its bound (:func:`dqn_grad_bound`); the
    RMSprop moment moves by (1 - decay) times gradients that close; each
    side's step is ``rsqrt(nu + eps) g`` with its own ``nu`` (the rsqrt
    recomputed exactly, ``utils/numerics.rsqrt``) and ``g`` in the
    interval that the gradient's bound and the side's own moment allow
    (:func:`_rms_grad_interval`), so the parameters' difference is -lr
    times the difference of the two steps' midpoints within lr times
    their half-widths plus 3u of each step; the step count is one more on
    both sides, and each side's target is its parameters where that count
    reaches a multiple of the period, else the state's."""
    from crowdnav_tpu_torch.utils import numerics as nm
    cfg, tx = agent.cfg, agent.tx
    b = [_np(x) for x in batch]
    loss_b, _, g = dqn_grad_bound(agent, state, b)
    _counts(state, new_a, new_b, ("step",))
    shares = {}
    c, d = _f(1 - tx.decay), _f(tx.decay)
    mag = np.abs(g.v) + g.e
    nu0 = _np(state.opt.nu)
    shares["nu"] = close("nu", _np(new_a.opt.nu), _np(new_b.opt.nu),
                         c * 2 * g.e * 2 * mag
                         + 2 * U32 * (2 * c * mag * mag + d * np.abs(nu0)))

    def step(side):
        nu = side.opt.nu.detach().cpu().float()
        r = _np(nm.rsqrt(nu + _f(tx.eps)))
        lo, hi = _rms_grad_interval(g, _np(nu), nu0, c, d)
        return r * (lo + hi) / 2, r * (hi - lo) / 2, r * np.maximum(
            np.abs(lo), np.abs(hi))

    (ma, ha, sa), (mb, hb, sb) = step(new_a), step(new_b)
    lr = _f(tx.lr)
    shares["params"] = close("params", _np(new_a.params), _np(new_b.params),
                             lr * (ha + hb + 3 * U32 * (sa + sb)),
                             -lr * (ma - mb))
    copy = (int(state.step) + 1) % cfg.target_update_period == 0
    for side in (new_a, new_b):
        want = side.params if copy else state.target_params
        if not np.array_equal(_np(side.target_params), _np(want)):
            raise AssertionError(f"target params (copy {copy})")
        if float(side.epsilon) != float(state.epsilon):
            raise AssertionError("the update moved epsilon")
    if metrics_b is not None:
        within("loss", _np(metrics_b["loss"]), loss_b)
    dev = agent.device
    st, batch = to_device(state, dev), to_device(batch, dev)
    target = agent.td_target(st, batch)
    _, grad = agent.q_grad(st.params, batch[0].float(), batch[1], target)
    shares["grad"] = within("grad", _np(grad), g)
    return shares
