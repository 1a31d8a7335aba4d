"""Samplers in sigma space (counterpart of the JAX ``diffusion/samplers.py``).

A sampler advances ``x`` down a sigma ladder with a denoiser
``denoise(x, sigma) -> x0_hat``. PyTorch runs eagerly, so a sampler is a
Python loop over the ladder. Each is written as the JAX package writes
its programs: ``init(x) -> state``, ``step(state, i) -> state`` for
global ladder index ``i``, ``extract(state) -> x0``. ``make_program``
binds one, and ``run_segment`` advances its state over any range of
ladder indices, so a run cut at step boundaries (preemption, the latent
checkpoints of ``diffusion/checkpoint.py``) is bitwise the uncut run:
``sample`` is one segment over the whole ladder. A state is a tuple of
fp32 tensors and host scalars (a multistep solver's step sizes, flags
and counters); ``diffusion/checkpoint.py`` round-trips both.

The ladder's values are read to the host once per run (``tolist``): the
branches (``sigma_next > 0``, the history a multistep solver has) are
decided on the host, and each step's scalar coefficients are computed
there in float64 and applied to the fp32 latents. The JAX package
computes them in float32 on the device; the two agree to float32
round-off. ``sigma`` reaches the denoiser as a 0-d tensor on the
latents' device: a ladder entry, or one drawn with ``torch.full`` (a fill
kernel, no host-to-device copy) for a solver's intermediate point.

Stochastic samplers draw their noise from a noise source
``noise(j, shape) -> tensor`` keyed by the draw index ``j``: the step
index ``i``, or ``2i`` and ``2i + 1`` for ``dpmpp_sde``'s two draws a
step, as the JAX package folds ``j`` into the sampler key
(``fold_in(key, j)``). ``parallel/rng.step_noise`` is the default
source; tests hand JAX's draws in through the same interface.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Denoiser = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# noise(j, shape): unit normal fp32 noise of draw j on the latents' device
NoiseSource = Callable[[int, tuple], torch.Tensor]
State = tuple
# (init, step, extract) of one run
Program = tuple[Callable[[torch.Tensor], State],
                Callable[[State, int], State],
                Callable[[State], torch.Tensor]]


def _to_d(x: torch.Tensor, sigma: float,
          denoised: torch.Tensor) -> torch.Tensor:
    """x0 prediction → the k-diffusion ODE derivative."""
    return (x - denoised) / max(sigma, 1e-10)


def _ancestral(sigma_from: float, sigma_to: float,
               eta: float) -> tuple[float, float]:
    """Split a σ_from→σ_to transition into a deterministic step and an
    ancestral noise injection (k-diffusion ``get_ancestral_step``):
    (sigma_down, sigma_up)."""
    var_ratio = max(1.0 - (sigma_to / max(sigma_from, 1e-10)) ** 2, 0.0)
    sigma_up = min(sigma_to, eta * sigma_to * math.sqrt(var_ratio))
    sigma_down = math.sqrt(max(sigma_to ** 2 - sigma_up ** 2, 0.0))
    return sigma_down, sigma_up


def _t_of(sigma: float) -> float:
    """log-SNR time t = −log σ, the exponential integrators' clock."""
    return -math.log(max(sigma, 1e-10))


def _i0(h: float) -> float:
    """∫₀ʰ e^{τ−h} dτ = 1 − e^{−h}."""
    return -math.expm1(-h)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 sigma on ``like``'s device, without a host copy."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _first(state: State) -> torch.Tensor:
    return state[0]


def _no_noise(j: int, shape: tuple) -> torch.Tensor:
    """The noise source of a run given none: a sampler that draws raises
    (``ddim`` then runs deterministic, as the JAX one does without a
    key)."""
    raise ValueError("this sampler draws noise: pass a noise source")


# --- programs ----------------------------------------------------------------
# Each takes (denoise, sigmas (the device tensor), s (its host floats),
# noise, **options) and returns (init, step, extract).


def _euler(denoise, sigmas, s, noise) -> Program:
    def step(state, i):
        (x,) = state
        sigma, sigma_next = s[i], s[i + 1]
        d = _to_d(x, sigma, denoise(x, sigmas[i]))
        return (x + d * (sigma_next - sigma),)

    return lambda x: (x,), step, _first


def _euler_ancestral(denoise, sigmas, s, noise, eta: float = 1.0) -> Program:
    def step(state, i):
        (x,) = state
        sigma, sigma_next = s[i], s[i + 1]
        sigma_down, sigma_up = _ancestral(sigma, sigma_next, eta)
        d = _to_d(x, sigma, denoise(x, sigmas[i]))
        x = x + d * (sigma_down - sigma)
        # the last step has sigma_next == 0 → sigma_up == 0: no noise
        if sigma_up > 0:
            x = x + noise(i, x.shape) * sigma_up
        return (x,)

    return lambda x: (x,), step, _first


def _heun(denoise, sigmas, s, noise) -> Program:
    def step(state, i):
        (x,) = state
        sigma, sigma_next = s[i], s[i + 1]
        d = _to_d(x, sigma, denoise(x, sigmas[i]))
        dt = sigma_next - sigma
        x_euler = x + d * dt
        if not sigma_next > 0:     # last step: plain euler, no call at σ = 0
            return (x_euler,)
        d2 = _to_d(x_euler, sigma_next, denoise(x_euler, sigmas[i + 1]))
        return (x + (d + d2) / 2 * dt,)

    return lambda x: (x,), step, _first


def _dpmpp_2m(denoise, sigmas, s, noise) -> Program:
    """DPM-Solver++(2M): second-order multistep on log-sigma."""

    def step(state, i):
        x, old_denoised, have_old = state
        sigma, sigma_next = s[i], s[i + 1]
        denoised = denoise(x, sigmas[i])
        if not sigma_next > 0:     # σ_next == 0: x → denoised exactly
            return (denoised, denoised, True)
        ratio = sigma_next / sigma
        if have_old:
            h = _t_of(sigma_next) - _t_of(sigma)
            h_last = _t_of(sigma) - _t_of(s[i - 1])
            r = h_last / max(h, 1e-10)
            denoised_d = (1 + 1 / (2 * r)) * denoised \
                - (1 / (2 * r)) * old_denoised
        else:
            denoised_d = denoised
        return (x * ratio + denoised_d * (1 - ratio), denoised, True)

    return (lambda x: (x, torch.zeros_like(x), False)), step, _first


def _ddim(denoise, sigmas, s, noise, eta: float = 0.0) -> Program:
    """DDIM in sigma space: ``eta = 0`` is the deterministic solver (the
    x0 form of euler); ``eta > 0`` interpolates toward ancestral
    sampling."""
    stochastic = bool(eta) and noise is not _no_noise

    def step(state, i):
        (x,) = state
        sigma, sigma_next = s[i], s[i + 1]
        denoised = denoise(x, sigmas[i])
        if stochastic:
            sigma_down, sigma_up = _ancestral(sigma, sigma_next, eta)
        else:
            sigma_down, sigma_up = sigma_next, 0.0
        x = denoised + (x - denoised) * (sigma_down / max(sigma, 1e-10))
        if stochastic:
            x = x + noise(i, x.shape) * sigma_up
        return (x,)

    return lambda x: (x,), step, _first


def _lcm(denoise, sigmas, s, noise) -> Program:
    """Latent-consistency sampling: jump to x0, re-noise to the next
    sigma (k-diffusion ``sample_lcm``)."""

    def step(state, i):
        (x,) = state
        denoised = denoise(x, sigmas[i])
        sigma_next = s[i + 1]
        if not sigma_next > 0:
            return (denoised,)
        return (denoised + sigma_next * noise(i, x.shape),)

    return lambda x: (x,), step, _first


def _dpmpp_sde(denoise, sigmas, s, noise, eta: float = 1.0,
               s_noise: float = 1.0, r: float = 0.5) -> Program:
    """DPM-Solver++ (SDE): single-step second order with an ancestral
    noise injection at the midpoint and the endpoint (k-diffusion
    ``sample_dpmpp_sde``). Draws ``2i`` and ``2i + 1``."""

    def sigma_of(t: float) -> float:
        return math.exp(-t)

    def step(state, i):
        (x,) = state
        sigma, sigma_next = s[i], s[i + 1]
        denoised = denoise(x, sigmas[i])
        if not sigma_next > 0:
            return (denoised,)
        t, t_next = _t_of(sigma), _t_of(sigma_next)
        h = t_next - t
        s_mid = t + h * r
        fac = 1.0 / (2.0 * r)
        # midpoint stage with its own ancestral split
        sd1, su1 = _ancestral(sigma_of(t), sigma_of(s_mid), eta)
        s_down = _t_of(sd1)
        x2 = (sigma_of(s_down) / sigma_of(t)) * x \
            - math.expm1(t - s_down) * denoised
        x2 = x2 + noise(2 * i, x.shape) * su1 * s_noise
        denoised2 = denoise(x2, _scalar(sigma_of(s_mid), x))
        # full step
        sd2, su2 = _ancestral(sigma_of(t), sigma_of(t_next), eta)
        t_down = _t_of(sd2)
        denoised_d = (1 - fac) * denoised + fac * denoised2
        x_new = (sigma_of(t_down) / sigma_of(t)) * x \
            - math.expm1(t - t_down) * denoised_d
        return (x_new + noise(2 * i + 1, x.shape) * su2 * s_noise,)

    return lambda x: (x,), step, _first


def _dpmpp_2m_sde(denoise, sigmas, s, noise, eta: float = 1.0,
                  s_noise: float = 1.0) -> Program:
    """DPM-Solver++(2M) SDE, midpoint solver (k-diffusion
    ``sample_dpmpp_2m_sde``)."""

    def step(state, i):
        x, old_denoised, h_last, have_old = state
        sigma, sigma_next = s[i], s[i + 1]
        denoised = denoise(x, sigmas[i])
        if not sigma_next > 0:
            return (denoised, denoised, 0.0, True)
        h = _t_of(sigma_next) - _t_of(sigma)
        eta_h = eta * h
        x_new = (sigma_next / max(sigma, 1e-10)) * math.exp(-eta_h) * x \
            - math.expm1(-h - eta_h) * denoised
        if have_old:
            r = h_last / max(h, 1e-10)
            x_new = x_new + -math.expm1(-h - eta_h) * (0.5 / max(r, 1e-10)) \
                * (denoised - old_denoised)
        x_new = x_new + noise(i, x.shape) * sigma_next * s_noise \
            * math.sqrt(max(-math.expm1(-2.0 * eta_h), 0.0))
        return (x_new, denoised, h, True)

    return (lambda x: (x, torch.zeros_like(x), 0.0, False)), step, _first


def _res_2m(denoise, sigmas, s, noise, eta: float = 0.0) -> Program:
    """RES second-order multistep (``res_2m``): exponential
    Adams–Bashforth on the data prediction, D linear through the last two
    points and the e^{τ−h}-weighted integral taken exactly:
    ``x' = e^{−h} x + I0·D_n + (h − I0)·(D_n − D_{n−1})/h_prev``.
    ``eta > 0`` adds an ancestral split per step (``res_2m_ancestral``)."""

    def step(state, i):
        x, old_denoised, h_prev, have_old = state
        sigma, sigma_next = s[i], s[i + 1]
        denoised = denoise(x, sigmas[i])
        h_real = _t_of(sigma_next) - _t_of(sigma)
        if not sigma_next > 0:
            return (denoised, denoised, h_real, True)
        if eta:
            sigma_down, sigma_up = _ancestral(sigma, sigma_next, eta)
        else:
            sigma_down, sigma_up = sigma_next, 0.0
        h = _t_of(sigma_down) - _t_of(sigma)
        i0 = _i0(h)
        x_new = math.exp(-h) * x + i0 * denoised
        if have_old:
            slope = (denoised - old_denoised) / max(h_prev, 1e-10)
            x_new = x_new + (h - i0) * slope
        if eta:
            x_new = x_new + noise(i, x.shape) * sigma_up
        return (x_new, denoised, h_real, True)

    return (lambda x: (x, torch.zeros_like(x), 0.0, False)), step, _first


def _res_2s(denoise, sigmas, s, noise, eta: float = 0.0,
            c2: float = 0.5) -> Program:
    """RES second-order single step (``res_2s``): two-stage exponential
    Runge–Kutta with midpoint stage c2. Stage ``x_s = e^{−c2·h} x +
    I0(c2·h)·D_n`` at σ·e^{−c2·h}; update ``x' = e^{−h} x + (I0 − Ψ)·D_n +
    Ψ·D_s`` with ``Ψ = (h − I0)/(c2·h)``. Two model calls a step but the
    last. ``eta > 0`` adds an ancestral split (``res_2s_ancestral``)."""

    def step(state, i):
        (x,) = state
        sigma, sigma_next = s[i], s[i + 1]
        denoised = denoise(x, sigmas[i])
        if not sigma_next > 0:
            return (denoised,)
        if eta:
            sigma_down, sigma_up = _ancestral(sigma, sigma_next, eta)
        else:
            sigma_down, sigma_up = sigma_next, 0.0
        h = _t_of(sigma_down) - _t_of(sigma)
        ch = c2 * h
        x_s = math.exp(-ch) * x + _i0(ch) * denoised
        denoised_s = denoise(x_s, _scalar(sigma * math.exp(-ch), x))
        i0 = _i0(h)
        psi = (h - i0) / max(ch, 1e-10)
        x_new = math.exp(-h) * x + (i0 - psi) * denoised + psi * denoised_s
        if eta:
            x_new = x_new + noise(i, x.shape) * sigma_up
        return (x_new,)

    return lambda x: (x,), step, _first


def _dpmpp_3m_sde(denoise, sigmas, s, noise, eta: float = 1.0,
                  s_noise: float = 1.0) -> Program:
    """DPM-Solver++(3M) SDE: third-order multistep with exponential-decay
    noise (k-diffusion ``sample_dpmpp_3m_sde``'s update rule): with
    h_eta = h·(eta+1), ``x' = e^{−h_eta} x + I0(h_eta)·D`` plus the
    divided-difference corrections once two or three history points
    exist, and noise ``σ_next·√(1 − e^{−2·h·eta})``."""

    def step(state, i):
        x, d1, d2, h1, h2, count = state
        sigma, sigma_next = s[i], s[i + 1]
        denoised = denoise(x, sigmas[i])
        if not sigma_next > 0:
            return (denoised, denoised, d1, 0.0, h1, count + 1)
        h = _t_of(sigma_next) - _t_of(sigma)
        h_eta = h * (eta + 1.0)
        x_new = math.exp(-h_eta) * x + _i0(h_eta) * denoised
        phi2 = math.expm1(-h_eta) / h_eta + 1.0
        phi3 = phi2 / h_eta - 0.5
        if count >= 1:
            r0 = h1 / h
            d1_0 = (denoised - d1) / max(r0, 1e-10)
            if count >= 2:
                r1 = h2 / h
                d1_1 = (d1 - d2) / max(r1, 1e-10)
                dd1 = d1_0 + (d1_0 - d1_1) * r0 / max(r0 + r1, 1e-10)
                dd2 = (d1_0 - d1_1) / max(r0 + r1, 1e-10)
                x_new = x_new + phi2 * dd1 - phi3 * dd2
            else:
                x_new = x_new + phi2 * d1_0
        if eta:
            x_new = x_new + noise(i, x.shape) * sigma_next * s_noise * math.sqrt(
                max(-math.expm1(-2.0 * h * eta), 0.0))
        return (x_new, denoised, d1, h, h1, count + 1)

    return ((lambda x: (x, torch.zeros_like(x), torch.zeros_like(x), 0.0,
                        0.0, 0)), step, _first)


def _uni_pc(denoise, sigmas, s, noise) -> Program:
    """UniPC (UniP-2 predictor + UniC-3 corrector), data-prediction form,
    one model call a step: the corrector re-integrates the previous
    transition with D at the predicted point once it is known (quadratic
    through three D points, exponential-trapezoidal on the first
    transition); the predictor is ``res_2m``'s update. Moments I0 =
    1−e^{−h}, I1 = h−I0, I2 = h²−2·I1."""

    def correct(x_prev, d_prev2, d_prev, d_cur, h, h_prev, count):
        i0 = _i0(h)
        i1 = h - i0
        if count < 2:
            # trapezoidal: linear through (0, d_prev), (h, d_cur)
            b_lin = (d_cur - d_prev) / max(h, 1e-10)
            return math.exp(-h) * x_prev + i0 * d_prev + i1 * b_lin
        # quadratic through (−h_prev, d_prev2), (0, d_prev), (h, d_cur)
        i2 = h * h - 2.0 * i1
        hp = max(h_prev, 1e-10)
        hh = max(h, 1e-10)
        det = hh * hp * (hh + hp)
        b = (hp * hp * (d_cur - d_prev) - hh * hh * (d_prev2 - d_prev)) / det
        c = (hp * (d_cur - d_prev) + hh * (d_prev2 - d_prev)) / det
        return math.exp(-h) * x_prev + i0 * d_prev + i1 * b + i2 * c

    def predict(x_cur, d_cur, d_prev, h, h_prev, count):
        i0 = _i0(h)
        x = math.exp(-h) * x_cur + i0 * d_cur
        if count >= 1:
            x = x + (h - i0) * ((d_cur - d_prev) / max(h_prev, 1e-10))
        return x

    def step(state, i):
        # x_pred: predicted state at σ_i; x_prev: corrected state at
        # σ_{i−1}; d_prev/d_prev2: D at σ_{i−1}/σ_{i−2}
        x_prev, x_pred, d_prev, d_prev2, h_prev, h_prev2, count = state
        sigma, sigma_next = s[i], s[i + 1]
        d_cur = denoise(x_pred, sigmas[i])
        x_cur = (correct(x_prev, d_prev2, d_prev, d_cur, h_prev, h_prev2,
                         count) if count >= 1 else x_pred)
        h = _t_of(sigma_next) - _t_of(sigma)
        x_next = (predict(x_cur, d_cur, d_prev, h, h_prev, count)
                  if sigma_next > 0 else d_cur)
        return (x_cur, x_next, d_cur, d_prev, h, h_prev, count + 1)

    return ((lambda x: (x, x, torch.zeros_like(x), torch.zeros_like(x), 0.0,
                        0.0, 0)), step, lambda state: state[1])


def _ancestral_variant(program: Callable) -> Callable:
    def bind(denoise, sigmas, s, noise, eta: float = 1.0, **kwargs):
        return program(denoise, sigmas, s, noise, eta=eta, **kwargs)

    return bind


PROGRAMS: dict[str, Callable[..., Program]] = {
    "euler": _euler,
    "euler_ancestral": _euler_ancestral,
    "heun": _heun,
    "dpmpp_2m": _dpmpp_2m,
    "ddim": _ddim,
    "lcm": _lcm,
    "dpmpp_sde": _dpmpp_sde,
    "dpmpp_2m_sde": _dpmpp_2m_sde,
    "res_2m": _res_2m,
    "res_2s": _res_2s,
    "res_2m_ancestral": _ancestral_variant(_res_2m),
    "res_2s_ancestral": _ancestral_variant(_res_2s),
    "dpmpp_3m_sde": _dpmpp_3m_sde,
    "uni_pc": _uni_pc,
}
SAMPLERS = tuple(PROGRAMS)
# the samplers that draw noise at their default options
STOCHASTIC = frozenset({"euler_ancestral", "lcm", "dpmpp_sde", "dpmpp_2m_sde",
                        "res_2m_ancestral", "res_2s_ancestral",
                        "dpmpp_3m_sde"})


def make_program(name: str, denoise: Denoiser, sigmas: torch.Tensor,
                 noise: Optional[NoiseSource] = None, *,
                 ladder: Optional[list] = None, **kwargs) -> Program:
    """Sampler ``name`` bound to ``denoise`` over ``sigmas`` ([n + 1],
    ending at 0): its ``(init, step, extract)``. ``noise`` is required by
    the samplers that draw noise; unknown names raise ``ValueError``, as
    the JAX ``make_program`` does. ``ladder`` is ``sigmas.tolist()`` when
    the caller still holds the host copy it moved to the card: the
    host-side coefficients then need no read-back (a copy and a
    synchronisation a request)."""
    try:
        builder = PROGRAMS[name]
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; have "
                         f"{sorted(PROGRAMS)}") from None
    values = sigmas.tolist() if ladder is None else list(ladder)
    return builder(denoise, sigmas, values, noise or _no_noise, **kwargs)


def run_segment(program: Program, state: State, start: int,
                length: int) -> State:
    """Advance ``state`` over the ladder indices ``start`` to
    ``start + length - 1``: the steps a run from 0 would take there, with
    the same draws (noise is keyed by the global index)."""
    step = program[1]
    for i in range(int(start), int(start) + int(length)):
        state = step(state, i)
    return state


def sample(name: str, denoise: Denoiser, x: torch.Tensor,
           sigmas: torch.Tensor, noise: Optional[NoiseSource] = None,
           *, ladder: Optional[list] = None, **kwargs) -> torch.Tensor:
    """Run sampler ``name`` from ``x`` down ``sigmas`` ([n + 1], ending at
    0): ``make_program``'s ``init``, one segment over the whole ladder,
    ``extract``."""
    program = make_program(name, denoise, sigmas, noise, ladder=ladder,
                           **kwargs)
    init, _, extract = program
    return extract(run_segment(program, init(x), 0, sigmas.shape[0] - 1))
