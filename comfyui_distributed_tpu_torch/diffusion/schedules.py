"""Noise schedules and sigma ladders (k-diffusion parameterization).

Counterpart of ``comfyui_distributed_tpu/diffusion/schedules.py``. Ladders
are built on the host in float32 (as the JAX package builds them) and
moved to the device by the caller.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """VP schedule: sigma_t = sqrt((1 - acp_t) / acp_t) over training steps."""

    alphas_cumprod: torch.Tensor       # [T] float32

    @property
    def sigmas(self) -> torch.Tensor:
        acp = self.alphas_cumprod
        return torch.sqrt((1.0 - acp) / acp)

    def timestep_for_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        """Continuous timestep whose table sigma matches ``sigma``: linear
        interpolation in log-sigma, clipped to the table (``jnp.interp``
        semantics, written with ``searchsorted``)."""
        table = self.sigmas.to(sigma.device)
        log_s = torch.log(torch.clamp(table, min=1e-10))
        x = torch.log(torch.clamp(sigma.float(), min=1e-10))
        n = log_s.shape[0]
        idx = torch.searchsorted(log_s, x.reshape(-1)).clamp(1, n - 1)
        lo, hi = log_s[idx - 1], log_s[idx]
        t = (idx - 1).float() + (x.reshape(-1) - lo) / (hi - lo)
        t = torch.where(x.reshape(-1) <= log_s[0], torch.zeros_like(t), t)
        t = torch.where(x.reshape(-1) >= log_s[-1],
                        torch.full_like(t, float(n - 1)), t)
        return t.reshape(x.shape)


def vp_schedule(num_steps: int = 1000, beta_start: float = 0.00085,
                beta_end: float = 0.012,
                kind: str = "scaled_linear") -> NoiseSchedule:
    """SD-family betas ("scaled_linear": linear in sqrt(beta))."""
    if kind == "scaled_linear":
        betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_steps,
                               dtype=torch.float32) ** 2
    elif kind == "linear":
        betas = torch.linspace(beta_start, beta_end, num_steps,
                               dtype=torch.float32)
    else:
        raise ValueError(f"unknown beta schedule {kind!r}")
    return NoiseSchedule(torch.cumprod(1.0 - betas, dim=0))


def _zero_terminated(sigmas: torch.Tensor) -> torch.Tensor:
    return torch.cat([sigmas.float(), torch.zeros(1)])


def _interp(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(t, arange(T), table)`` for t within [0, T-1]."""
    lo = torch.clamp(torch.floor(t), 0, table.shape[0] - 1).long()
    hi = torch.clamp(lo + 1, max=table.shape[0] - 1)
    w = t - lo.float()
    return table[lo] + w * (table[hi] - table[lo])


def sigmas_karras(n: int, sigma_min: float, sigma_max: float,
                  rho: float = 7.0) -> torch.Tensor:
    """Karras et al. (2022) ladder; [n+1] descending, last = 0."""
    ramp = torch.linspace(0, 1, n, dtype=torch.float32)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    return _zero_terminated((max_inv + ramp * (min_inv - max_inv)) ** rho)


def sigmas_normal(n: int, schedule: NoiseSchedule) -> torch.Tensor:
    """Uniform-in-timestep ladder over the VP table ("normal")."""
    table = schedule.sigmas
    t = torch.linspace(table.shape[0] - 1, 0, n, dtype=torch.float32)
    return _zero_terminated(_interp(t, table))


def sigmas_exponential(n: int, sigma_min: float,
                       sigma_max: float) -> torch.Tensor:
    """Log-uniform ladder (k-diffusion ``get_sigmas_exponential``)."""
    return _zero_terminated(torch.exp(torch.linspace(
        math.log(sigma_max), math.log(sigma_min), n, dtype=torch.float32)))


def sigmas_sgm_uniform(n: int, schedule: NoiseSchedule) -> torch.Tensor:
    """Like "normal" but ending at the table's sigma_min ("sgm_uniform")."""
    table = schedule.sigmas
    t = torch.linspace(table.shape[0] - 1, 0, n + 1, dtype=torch.float32)[:-1]
    return _zero_terminated(_interp(t, table))


def _betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b) by its continued fraction
    (modified Lentz), in float64."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - _betainc(b, a, 1.0 - x)
    front = math.exp(math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
                     + a * math.log(x) + b * math.log1p(-x)) / a
    tiny = 1e-300
    c, d = 1.0, 1.0 - (a + b) * x / (a + 1.0)
    d = 1.0 / (d if abs(d) > tiny else tiny)
    f = d
    for m in range(1, 500):
        for numerator in (m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m)),
                          -(a + m) * (a + b + m) * x
                          / ((a + 2 * m) * (a + 2 * m + 1))):
            d = 1.0 + numerator * d
            d = 1.0 / (d if abs(d) > tiny else tiny)
            c = 1.0 + numerator / c
            c = c if abs(c) > tiny else tiny
            f *= c * d
        if abs(c * d - 1.0) < 1e-15:
            break
    return front * f


def _beta_ppf(q: float, a: float, b: float) -> float:
    """Beta(a, b) quantile by 60 bisection halvings (as the JAX package)."""
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _betainc(a, b, mid) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def sigmas_beta(n: int, schedule: NoiseSchedule, alpha: float = 0.6,
                beta: float = 0.6) -> torch.Tensor:
    """"beta" scheduler: timesteps at Beta(α,β) quantiles of the table."""
    table = schedule.sigmas
    T = table.shape[0]
    ts = 1.0 - torch.linspace(0.0, 1.0, n + 1, dtype=torch.float32)[:-1]
    idx = [int(round(_beta_ppf(float(q), alpha, beta) * (T - 1))) for q in ts]
    return _zero_terminated(table[torch.tensor(idx)])


def sigmas_linear_quadratic(n: int, threshold_noise: float = 0.025,
                            linear_steps: "int | None" = None,
                            sigma_max: float = 1.0) -> torch.Tensor:
    """"linear_quadratic" scheduler: 1−σ rises linearly to
    ``threshold_noise`` over ``linear_steps`` (default n//2), then
    quadratically to 1, C¹ at the joint. [n+1] descending, last = 0."""
    if n == 1:
        return torch.tensor([1.0, 0.0]) * sigma_max
    ls = n // 2 if linear_steps is None else min(int(linear_steps), n)
    i = torch.arange(n + 1, dtype=torch.float32)
    slope = threshold_noise / max(ls, 1)
    linear = i * threshold_noise / max(ls, 1)
    qs = max(n - ls, 1)
    a = (1.0 - threshold_noise - slope * qs) / (qs * qs)
    j = i - ls
    quad = a * j * j + slope * j + threshold_noise
    inv = torch.where(i < ls, linear, quad)
    inv[-1] = 1.0
    return (1.0 - inv) * sigma_max


def sigmas_flow(n: int, shift: float = 1.0) -> torch.Tensor:
    """Rectified-flow ladder: σ from 1 to 0 with the resolution shift
    σ' = shift·σ / (1 + (shift−1)·σ) (FLUX/SD3 convention). [n+1]."""
    sigmas = torch.linspace(1.0, 0.0, n + 1, dtype=torch.float32)
    if shift != 1.0:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return sigmas
