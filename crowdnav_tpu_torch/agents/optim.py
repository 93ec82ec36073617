"""Adam and RMSprop on one flat float32 parameter vector, each in the
order of its optax counterpart.

Adam follows optax's ``scale_by_adam`` followed by
``scale_by_learning_rate`` (the JAX package's ``optax.adam(lr)``).

Every elementwise step rounds where optax's does:

    mu = f32(1 - b1) * g + f32(b1) * mu
    nu = f32(1 - b2) * (g * g) + f32(b2) * nu
    count = count + 1
    update = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + f32(eps))
    params = params + update * f32(-lr)

``torch.optim.Adam`` rounds differently (``lerp_`` for ``mu``, the bias
corrections folded into the step size and the denominator), so it is not
used. The bias corrections ``1 - b^count`` are float32, with ``b^count``
the C library's ``powf`` as XLA computes it; ``count`` stays on the device,
so they are looked up in a table of ``1 - powf(b, t)`` made once on the
host, up to the first ``t`` where the value rounds to 1 (165 steps for
b1 = 0.9, 17,321 for b2 = 0.999). The square root is correctly rounded on
both devices (``utils/numerics.sqrt``).

RMSprop is ``optax.rmsprop(lr, decay, eps)`` with optax's defaults
(``eps_in_sqrt``, no bias correction, no momentum), the DQN's optimizer:

    nu = f32(1 - decay) * (g * g) + f32(decay) * nu      (nu starts at 0)
    params = params + (rsqrt(nu + f32(eps)) * g) * f32(-lr)

with ``rsqrt`` as XLA's CPU backend computes it (``utils/numerics.rsqrt``).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from crowdnav_tpu_torch.utils import numerics as nm


@dataclasses.dataclass
class AdamState:
    mu: torch.Tensor       # (P,) float32
    nu: torch.Tensor       # (P,) float32
    count: torch.Tensor    # () int32, updates taken


@functools.lru_cache(maxsize=16)
def _bias_table(decay: float, device: torch.device) -> torch.Tensor:
    """``t -> f32(1 - powf(f32(decay), t))`` for ``t`` up to the first
    value that rounds to 1; the table's last entry is that 1.0."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    one = np.float32(1.0)
    vals = [np.float32(0.0)]          # t = 0 is never looked up
    t = 1
    while True:
        v = one - np.float32(lib.powf(decay, float(t)))
        vals.append(v)
        if v == one:
            break
        t += 1
    return torch.from_numpy(np.asarray(vals, np.float32)).to(device)


def bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** count`` as optax computes it, for an int32 tensor."""
    table = _bias_table(decay, count.device)
    idx = torch.clamp(count.long(), max=table.numel() - 1).reshape(1)
    return table.index_select(0, idx).reshape(())


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` on a flat parameter vector."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    @staticmethod
    def init(params: torch.Tensor) -> AdamState:
        return AdamState(mu=torch.zeros_like(params),
                         nu=torch.zeros_like(params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=params.device))

    def update(self, grad: torch.Tensor, state: AdamState,
               params: torch.Tensor):
        """``(new params, new state)``; no argument is modified."""
        b1, b2 = self.b1, self.b2
        mu = grad * nm.f32(1 - b1) + state.mu * nm.f32(b1)
        nu = (grad * grad) * nm.f32(1 - b2) + state.nu * nm.f32(b2)
        count = torch.clamp(state.count.long() + 1,
                            max=2 ** 31 - 1).to(torch.int32)
        mu_hat = mu / bias_correction(b1, count)
        nu_hat = nu / bias_correction(b2, count)
        step = mu_hat / (nm.sqrt(nu_hat) + nm.f32(self.eps))
        new = params + step * nm.f32(-self.lr)
        return new, AdamState(mu=mu, nu=nu, count=count)


@dataclasses.dataclass
class RMSpropState:
    nu: torch.Tensor       # (P,) float32


class RMSprop:
    """``optax.rmsprop(lr, decay, eps)`` on a flat parameter vector."""

    def __init__(self, lr: float, decay: float = 0.9, eps: float = 1e-6):
        self.lr, self.decay, self.eps = lr, decay, eps

    @staticmethod
    def init(params: torch.Tensor) -> RMSpropState:
        return RMSpropState(nu=torch.zeros_like(params))

    def update(self, grad: torch.Tensor, state: RMSpropState,
               params: torch.Tensor):
        """``(new params, new state)``; no argument is modified."""
        nu = (grad * grad) * nm.f32(1 - self.decay) \
            + state.nu * nm.f32(self.decay)
        step = nm.rsqrt(nu + nm.f32(self.eps)) * grad
        return params + step * nm.f32(-self.lr), RMSpropState(nu=nu)
