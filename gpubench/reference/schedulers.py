"""The samplers of the plain reference, each written from its published
definition, under either parameterisation of the UNet's output.

* DDIM (Song, Meng and Ermon, "Denoising Diffusion Implicit Models",
  eq. 12 with η = 0), as diffusers' ``DDIMScheduler`` spaces its steps
  (``leading``: t_k = k·⌊N/steps⌋ + ``steps_offset``).
* PNDM as diffusers' ``PNDMScheduler`` runs it with ``skip_prk_steps``
  (Liu et al., "Pseudo Numerical Methods for Diffusion Models", eq. 11 for
  the transfer, and the linear multistep of orders 1-4, PLMS): the second
  timestep is evaluated twice, once to average with the first output and
  restart from the first latents, then again to extend the history, so
  ``steps`` + 1 UNet evaluations for ``steps`` > 1.
* ``epsilon``: the output is the noise ε.  ``v_prediction`` (Salimans and
  Ho, "Progressive Distillation", §4): the output is v, and
  x0 = √ᾱ·x − √(1−ᾱ)·v, ε = √ᾱ·v + √(1−ᾱ)·x.

The betas are ``scaled_linear``; tables are built in float64 and cast to
float32.  A sampler gives the UNet's timestep of each evaluation and
``step(i, out, x)``: the guided output of evaluation ``i`` at the latents
``x`` → the latents after it and the part of them that carries the latents
the step starts from, √(ᾱ_prev/ᾱ_t)·x, which depends on no model output, so
that what is left is the step's noise term.  A configuration whose sampler
is not one of these is refused (:func:`unsupported`), never run with other
arithmetic.  Imports nothing of the program.
"""

from typing import List, Tuple

import numpy as np
import torch

PREDICTION_TYPES = ('epsilon', 'v_prediction')


def unsupported(cfg: dict) -> List[str]:
    """What of the configuration's ``scheduler`` the reference does not
    implement; empty where it implements all of it."""
    s = cfg['scheduler']
    bad = []
    if s['name'] not in SAMPLERS:
        bad.append(f"scheduler.name {s['name']!r} (the reference has {sorted(SAMPLERS)})")
    if s['prediction_type'] not in PREDICTION_TYPES:
        bad.append(f"scheduler.prediction_type {s['prediction_type']!r} "
                   f"(the reference has {list(PREDICTION_TYPES)})")
    if s['beta_schedule'] != 'scaled_linear':
        bad.append(f"scheduler.beta_schedule {s['beta_schedule']!r} (the reference has 'scaled_linear')")
    if s.get('eta', 0.0) != 0.0:
        bad.append(f"scheduler.eta {s['eta']!r} (the reference has 0)")
    if s['name'] == 'pndm' and s.get('skip_prk_steps') is not True:
        bad.append('scheduler.skip_prk_steps not true (the reference has PNDM with '
                   'skip_prk_steps alone)')
    return bad


def sampler(cfg: dict, steps: int, device):
    """The configuration's sampler for ``steps`` steps, on ``device``;
    ValueError where the reference does not implement it."""
    bad = unsupported(cfg)
    if bad:
        raise ValueError('the reference does not implement ' + '; '.join(bad))
    return SAMPLERS[cfg['scheduler']['name']](cfg['scheduler'], steps, device)


def evaluations(cfg: dict, steps: int) -> int:
    """UNet evaluations of one request of ``steps`` steps."""
    pndm = cfg['scheduler']['name'] == 'pndm' and steps > 1
    return steps + 1 if pndm else steps


def alphas_cumprod(s: dict) -> np.ndarray:
    betas = np.linspace(s['beta_start'] ** 0.5, s['beta_end'] ** 0.5, s['num_train_timesteps'],
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def timesteps(s: dict, steps: int) -> np.ndarray:
    """The ``leading`` spacing of ``steps`` training timesteps, descending."""
    n = s['num_train_timesteps']
    ratio = n // steps
    return np.clip((np.arange(steps) * ratio).round().astype(np.int64) + s['steps_offset'],
                   0, n - 1)[::-1].copy()


def split(out: torch.Tensor, x: torch.Tensor, a: torch.Tensor, prediction_type: str):
    """(x0, ε) of the model output ``out`` at the latents ``x``, ᾱ = ``a``."""
    if prediction_type == 'v_prediction':
        return (torch.sqrt(a) * x - torch.sqrt(1 - a) * out,
                torch.sqrt(a) * out + torch.sqrt(1 - a) * x)
    return (x - torch.sqrt(1 - a) * out) / torch.sqrt(a), out


class DDIM:
    """x_prev = √ᾱ_prev·x0 + √(1−ᾱ_prev)·ε, one evaluation a step."""

    def __init__(self, s: dict, steps: int, device):
        ac = alphas_cumprod(s)
        ts = timesteps(s, steps)
        prev = ts - s['num_train_timesteps'] // steps
        final = 1.0 if s['set_alpha_to_one'] else ac[0]
        a_prev = np.where(prev >= 0, ac[np.clip(prev, 0, None)], final)
        f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
        self.prediction_type = s['prediction_type']
        self.timesteps = torch.as_tensor(ts, device=device)
        self.a_t, self.a_prev = f32(ac[ts]), f32(a_prev)

    def step(self, i: int, out: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x0, eps = split(out, x, self.a_t[i], self.prediction_type)
        nxt = torch.sqrt(self.a_prev[i]) * x0 + torch.sqrt(1 - self.a_prev[i]) * eps
        return nxt, torch.sqrt(self.a_prev[i] / self.a_t[i]) * x


class PNDM:
    """PLMS as diffusers' ``PNDMScheduler.step_plms`` with ``skip_prk_steps``:
    the history holds the model outputs as given (v under v-prediction),
    the multistep combines them, and the transfer turns the combination
    into ε with the ᾱ and the latents that it integrates from."""

    def __init__(self, s: dict, steps: int, device):
        ac = alphas_cumprod(s)
        ts = timesteps(s, steps)
        self.ratio = s['num_train_timesteps'] // steps
        unet_ts = np.concatenate([ts[:1], ts[1:2], ts[1:]]) if steps > 1 else ts
        self.timesteps = torch.as_tensor(unet_ts, device=device)
        self.ts = [int(t) for t in unet_ts]
        self.ac = torch.as_tensor(ac.astype(np.float32), device=device)
        self.final = torch.tensor(1.0 if s['set_alpha_to_one'] else float(ac[0]),
                                  dtype=torch.float32, device=device)
        self.prediction_type = s['prediction_type']
        self.ets: List[torch.Tensor] = []
        self.cur_sample = None

    def step(self, i: int, out: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.ts[i]
        prev_t = t - self.ratio
        if i != 1:
            self.ets = self.ets[-3:] + [out]
        else:  # the second evaluation integrates t_0 → t_1 again, from the first latents
            prev_t, t = t, t + self.ratio
        e = self.ets
        if len(e) == 1 and i == 0:
            comb, self.cur_sample = out, x
        elif len(e) == 1 and i == 1:
            comb, x, self.cur_sample = (out + e[-1]) / 2, self.cur_sample, None
        elif len(e) == 2:
            comb = (3 * e[-1] - e[-2]) / 2
        elif len(e) == 3:
            comb = (23 * e[-1] - 16 * e[-2] + 5 * e[-3]) / 12
        else:
            comb = (55 * e[-1] - 59 * e[-2] + 37 * e[-3] - 9 * e[-4]) / 24
        return self.transfer(x, t, prev_t, comb)

    def transfer(self, x, t: int, prev_t: int, out):
        """PNDM's eq. 11: x_prev = √(ᾱ_prev/ᾱ_t)·x − (ᾱ_prev − ᾱ_t)·ε /
        (ᾱ_t·√(1−ᾱ_prev) + √(ᾱ_t·(1−ᾱ_t)·ᾱ_prev))."""
        a_t = self.ac[t]
        a_prev = self.ac[prev_t] if prev_t >= 0 else self.final
        _, eps = split(out, x, a_t, self.prediction_type)
        carry = torch.sqrt(a_prev / a_t) * x
        denom = a_t * torch.sqrt(1 - a_prev) + torch.sqrt(a_t * (1 - a_t) * a_prev)
        return carry - (a_prev - a_t) * eps / denom, carry


SAMPLERS = {'ddim': DDIM, 'pndm': PNDM}
