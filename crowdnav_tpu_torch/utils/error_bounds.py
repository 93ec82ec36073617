"""Float32 forward-error bounds of the TD3 learner, carried operation by
operation in float64 (numpy), for holding two float32 evaluations of the
same update (the port against the JAX package in the tests; the card
against the CPU in ``chip_smoke.py``) to a bound derived from the
arithmetic rather than a tolerance tuned on one host.

:class:`Bnd` is a float64 value and a bound on how far any float32
evaluation of the same formula can lie from it; :func:`critic_grad_bound`
and :func:`actor_grad_bound` evaluate the TD3 losses' gradients so;
:func:`check_update` holds two results of one update, from one state, to
what those bounds imply through Adam's arithmetic. The numbers are
float64 on the host: nothing here runs on the card, and nothing of the
training path imports this module. It lives in the package, not beside
the tests, because ``chip_smoke.py`` holds the card's learner to it on a
machine where the script may import nothing of ``tests/``
(``tests/test_torch_rules.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from crowdnav_tpu_torch.utils.tree import to_device

U32 = 2.0 ** -24
U64 = 2.0 ** -53


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


def bconcat(parts, axis=-1):
    parts = [_b(p) for p in parts]
    return Bnd(np.concatenate([p.v for p in parts], axis),
               np.concatenate([p.e for p in parts], axis))


def bmlp(p, prefix, x):
    """Forward of a 3-layer ReLU MLP; returns (out, [z1, h1, z2, h2])."""
    z1 = blinear(x, p[f"{prefix}dense0.weight"], p[f"{prefix}dense0.bias"])
    h1 = brelu(z1)
    z2 = blinear(h1, p[f"{prefix}dense1.weight"], p[f"{prefix}dense1.bias"])
    h2 = brelu(z2)
    out = blinear(h2, p[f"{prefix}dense2.weight"], p[f"{prefix}dense2.bias"])
    return out, (x, z1, h1, z2, h2)


def bmlp_back(p, prefix, acts, dout):
    """Backward of :func:`bmlp` from d(out): ``({param: grad}, d(input))``."""
    x, z1, h1, z2, h2 = acts
    g = {}
    g[f"{prefix}dense2.weight"] = bmatmul(dout.T, h2)
    g[f"{prefix}dense2.bias"] = bsum(dout, 0)
    dz2 = brelu_back(z2, bmatmul(dout, p[f"{prefix}dense2.weight"]))
    g[f"{prefix}dense1.weight"] = bmatmul(dz2.T, h1)
    g[f"{prefix}dense1.bias"] = bsum(dz2, 0)
    dz1 = brelu_back(z1, bmatmul(dz2, p[f"{prefix}dense1.weight"]))
    g[f"{prefix}dense0.weight"] = bmatmul(dz1.T, x)
    g[f"{prefix}dense0.bias"] = bsum(dz1, 0)
    return g, bmatmul(dz1, p[f"{prefix}dense0.weight"])


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


def actor_grad_bound(tagent, actor_flat, critic_flat, critic_err, obs):
    """``(loss, flat gradient)`` of the actor's loss as :class:`Bnd`, under
    the critic ``critic_flat`` whose float32 values may lie up to
    ``critic_err`` (per parameter) from it."""
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
    q1, acts_c = bmlp(cp, "q1.", x)
    loss = bmul(bmean(q1, 0), -1.0)
    _, dx = bmlp_back(cp, "q1.", acts_c, Bnd(np.full((n, 1), -1.0 / n)))
    da = dx[:, d:]
    dsig = bmul(bmul(da[:, 0:1], float(np.float32(cfg.max_lin_vel))),
                bmul(sig, badd(1.0, sig, -1.0)))
    dth = bmul(bmul(da[:, 1:2], float(np.float32(cfg.max_ang_vel))),
               badd(1.0, bmul(th, th), -1.0))
    g, _ = bmlp_back(ap, "", acts_a, bconcat([dsig, dth]))
    return loss, flat_bnd(g, [n_ for n_, _ in tagent.actor_layout])


def within(name, got, bnd):
    """Assert every element of ``got`` within its bound; the largest share
    of the bound used."""
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


def check_update(agent, state, batch, noise, new_a, new_b, metrics_b=None):
    """Hold two float32 results ``new_a`` and ``new_b`` of one TD3 update
    from the same ``state`` (CPU tensors), batch and smoothing noise to
    the derived bounds, and return the largest share of each bound used.

    The critics' gradients both lie within their bound around a float64
    evaluation (:func:`critic_grad_bound`), so each Adam moment moves by
    (1 - b) times gradients that close (:func:`moment_bounds`); the
    actor's gradient is bounded the same way under ``new_b``'s critic with
    ``new_a``'s critic at its actual distance from it
    (:func:`actor_grad_bound`), and is zero on a non-policy update. Each
    parameter vector lies within lr times the difference of the two sides'
    own Adam steps, recomputed in float64 from their moments, to within
    the steps' rounding (:func:`param_diff`); the targets' difference
    equals tau times the parameters' actual difference to within the
    rounding of the soft update on a policy update, and is zero otherwise;
    counts are equal. ``metrics_b``: ``new_b``'s metrics, held to their bounds.
    The shares ``critic_grad`` and ``actor_grad`` are those of ``agent``'s
    own gradients from ``state``, evaluated on its device."""
    cfg = agent.cfg
    ctx, atx = agent.critic_tx, agent.actor_tx
    b = [_np(x) for x in batch]
    loss_b, y_b, cg_b = critic_grad_bound(agent, state, b, _np(noise))
    for opt in ("actor_opt", "critic_opt"):
        ca, cb = (int(getattr(s, opt).count) for s in (new_a, new_b))
        if not ca == cb == int(getattr(state, opt).count) + 1:
            raise AssertionError(f"{opt}.count")
    if not (int(new_a.update_count) == int(new_b.update_count)
            == int(state.update_count) + 1):
        raise AssertionError("update_count")
    shares = {}
    mu_c, nu_c = moment_bounds(ctx, cg_b.v, cg_b.e, _np(state.critic_opt.mu),
                               _np(state.critic_opt.nu))
    shares["critic_mu"] = close("critic mu", _np(new_a.critic_opt.mu),
                                _np(new_b.critic_opt.mu), mu_c)
    shares["critic_nu"] = close("critic nu", _np(new_a.critic_opt.nu),
                                _np(new_b.critic_opt.nu), nu_c)
    expect, bound = param_diff(ctx, new_a, new_b, "critic_opt")
    shares["critic_params"] = close(
        "critic params", _np(new_a.critic_params), _np(new_b.critic_params),
        bound, expect)
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
    if policy:
        mu_a, nu_a = moment_bounds(atx, ag_far.v, ag_far.e,
                                   _np(state.actor_opt.mu),
                                   _np(state.actor_opt.nu))
    else:
        mu_a = nu_a = 0.0
    shares["actor_mu"] = close("actor mu", _np(new_a.actor_opt.mu),
                               _np(new_b.actor_opt.mu), mu_a)
    shares["actor_nu"] = close("actor nu", _np(new_a.actor_opt.nu),
                               _np(new_b.actor_opt.nu), nu_a)
    expect, bound = param_diff(atx, new_a, new_b, "actor_opt")
    shares["actor_params"] = close(
        "actor params", _np(new_a.actor_params), _np(new_b.actor_params),
        bound, expect)
    tau = _f(cfg.tau)
    for name, online in (("actor_target", "actor_params"),
                         ("critic_target", "critic_params")):
        a, bb = _np(getattr(new_a, name)), _np(getattr(new_b, name))
        if policy:
            pa, pb = _np(getattr(new_a, online)), _np(getattr(new_b, online))
            t0 = np.abs(_np(getattr(state, name)))
            shares[name] = close(
                name, a, bb,
                2 * U32 * (2 * t0 + tau * (np.abs(pa) + np.abs(pb))),
                tau * (pa - pb))
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
