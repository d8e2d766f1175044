"""Diffusion samplers as precomputed tables plus a step function.

PyTorch counterpart of ``daam_tpu/pipeline/schedulers.py``: DDIM, PNDM,
Euler and DPM-Solver++ (2M).  Same contract:

* ``num_scan_steps(n)`` — UNet evaluations for ``n`` user steps,
* ``init_state(n, sample_shape, dtype, device)`` — the per-step tables,
  built in float64 numpy and cast to float32 like ``daam_tpu``'s, and the
  sample-shaped state (PNDM's eps history, DPM++'s previous x0),
* ``step(state, i, model_output, sample)`` → ``(prev_sample, state)``.

PyTorch runs the loop in Python, so what ``daam_tpu`` selects with
``jax.lax.switch`` and ``jnp.where`` on scan-indexed tables (PNDM's order,
``push`` and ``use_cur``; DPM++'s ``first_order`` and ``has_prev``) is
host control flow here: those tables stay numpy and Python ints, and no
step reads the device to decide a branch.  Only the arithmetic tables and
the sample-shaped state live on ``device``.
"""

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

__all__ = ['DDIMScheduler', 'PNDMScheduler', 'EulerDiscreteScheduler',
           'DPMSolverMultistepScheduler', 'get_scheduler', 'SCHEDULERS']


def _make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
                schedule: str) -> np.ndarray:
    if schedule == 'scaled_linear':  # SD default
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if schedule == 'linear':
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    raise ValueError(f'unknown beta schedule {schedule!r}')


def _f32(table, device) -> torch.Tensor:
    """A float64 numpy table cast to float32 on ``device``."""
    return torch.as_tensor(np.asarray(table).astype(np.float32), device=device)


@dataclass
class BaseScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = 'scaled_linear'
    prediction_type: str = 'epsilon'
    steps_offset: int = 1

    def __post_init__(self):
        betas = _make_betas(self.num_train_timesteps, self.beta_start,
                            self.beta_end, self.beta_schedule)
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)

    def _timesteps_desc(self, num_steps: int) -> np.ndarray:
        """Descending training-timestep indices for ``num_steps`` user steps."""
        step_ratio = self.num_train_timesteps // num_steps
        ts = (np.arange(0, num_steps) * step_ratio).round().astype(np.int64)
        ts = ts + self.steps_offset
        return np.clip(ts, 0, self.num_train_timesteps - 1)[::-1].copy()

    def _pred_x0_eps(self, t_alpha, model_output, sample):
        """(pred_x0, pred_eps) under the configured prediction type."""
        a_sqrt = torch.sqrt(t_alpha)
        s_sqrt = torch.sqrt(1.0 - t_alpha)
        if self.prediction_type == 'v_prediction':
            x0 = a_sqrt * sample - s_sqrt * model_output
            eps = a_sqrt * model_output + s_sqrt * sample
        else:  # epsilon
            x0 = (sample - s_sqrt * model_output) / a_sqrt
            eps = model_output
        return x0, eps

    def num_scan_steps(self, num_steps: int) -> int:
        return num_steps

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, state: Dict[str, Any], sample, i):
        return sample


@dataclass
class DDIMScheduler(BaseScheduler):
    """Deterministic DDIM (eta = 0)."""

    set_alpha_to_one: bool = False

    def init_state(self, num_steps: int, sample_shape=None,
                   dtype=torch.float32, device='cpu') -> Dict[str, Any]:
        ts = self._timesteps_desc(num_steps)
        step_ratio = self.num_train_timesteps // num_steps
        prev_ts = ts - step_ratio
        alpha_t = self.alphas_cumprod[ts]
        final_alpha = 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])
        alpha_prev = np.where(prev_ts >= 0,
                              self.alphas_cumprod[np.clip(prev_ts, 0, None)],
                              final_alpha)
        return {
            'timesteps': torch.as_tensor(ts, device=device),
            'alpha_t': _f32(alpha_t, device),
            'alpha_prev': _f32(alpha_prev, device),
        }

    def step(self, state, i, model_output, sample):
        a_t = state['alpha_t'][i]
        a_prev = state['alpha_prev'][i]
        x0, eps = self._pred_x0_eps(a_t, model_output, sample)
        prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return prev, state


@dataclass
class PNDMScheduler(BaseScheduler):
    """PNDM / PLMS with skipped Runge-Kutta warmup — the SD 1.x/2.x default.

    As ``daam_tpu``'s: the second timestep is evaluated twice (the
    half-started linear multistep bootstrap), its eps is *not* pushed to the
    history, and the integration at that step restarts from the saved
    ``cur_sample``.  The history holds the raw model outputs, newest first;
    ``order``, ``push`` and ``use_cur`` are host tables.
    """

    def num_scan_steps(self, num_steps: int) -> int:
        return num_steps + 1 if num_steps > 1 else num_steps

    def init_state(self, num_steps: int, sample_shape=None,
                   dtype=torch.float32, device='cpu') -> Dict[str, Any]:
        assert sample_shape is not None, 'PNDM needs sample_shape for its eps history'
        ts = self._timesteps_desc(num_steps)
        ratio = self.num_train_timesteps // num_steps
        final_alpha = float(self.alphas_cumprod[0])

        if num_steps > 1:
            unet_ts = np.concatenate([ts[:1], ts[1:2], ts[1:]])
            n = len(unet_ts)
            ts_from = unet_ts.copy()
            ts_from[1] = ts[0]           # step 1 integrates t0 -> t1 again
            prev_ts = ts_from - ratio
            prev_ts[1] = ts[1]
            use_cur = np.zeros(n, dtype=np.int32)
            use_cur[1] = 1
            push = np.ones(n, dtype=np.int32)
            push[1] = 0
            # multistep order: 0 = first step, 1 = bootstrap average, 2-4 =
            # linear multistep of that order; min(i, 4), so a short schedule
            # (n = 3 at num_steps = 2) never indexes past the table.
            order = np.clip(np.arange(n), 0, 4)
        else:
            unet_ts = ts
            ts_from = ts
            prev_ts = ts - ratio
            use_cur = np.zeros(1, dtype=np.int32)
            push = np.ones(1, dtype=np.int32)
            order = np.zeros(1, dtype=np.int32)

        alpha_t = self.alphas_cumprod[np.clip(ts_from, 0, None)]
        alpha_prev = np.where(prev_ts >= 0,
                              self.alphas_cumprod[np.clip(prev_ts, 0, None)],
                              final_alpha)
        return {
            'timesteps': torch.as_tensor(unet_ts, device=device),
            'alpha_t': _f32(alpha_t, device),
            'alpha_prev': _f32(alpha_prev, device),
            'use_cur': use_cur,
            'push': push,
            'order': order,
            'ets': torch.zeros((4,) + tuple(sample_shape), dtype=dtype, device=device),
            'cur_sample': torch.zeros(tuple(sample_shape), dtype=dtype, device=device),
        }

    def step(self, state, i, model_output, sample):
        a_t = state['alpha_t'][i]
        a_prev = state['alpha_prev'][i]

        # The history holds RAW model outputs (v-space for v-prediction
        # models); the combination converts to eps once, with the current
        # integration sample and alpha (daam_tpu/pipeline/schedulers.py:179-207).
        out = model_output
        ets = state['ets']
        if state['push'][i]:
            ets = torch.cat([out[None].to(ets.dtype), ets[:-1]])
        cur_sample = state['cur_sample'] if state['use_cur'][i] else sample
        new_cur = sample if i == 0 else state['cur_sample']

        e1, e2, e3, e4 = ets[0], ets[1], ets[2], ets[3]
        order = int(state['order'][i])
        if order == 0:    # first step
            out_prime = out
        elif order == 1:  # bootstrap average
            out_prime = (out + e1) / 2
        elif order == 2:
            out_prime = (3 * e1 - e2) / 2
        elif order == 3:
            out_prime = (23 * e1 - 16 * e2 + 5 * e3) / 12
        else:
            out_prime = (55 * e1 - 59 * e2 + 37 * e3 - 9 * e4) / 24

        if self.prediction_type == 'v_prediction':
            eps_prime = (torch.sqrt(a_t) * out_prime +
                         torch.sqrt(1.0 - a_t) * cur_sample)
        else:
            eps_prime = out_prime

        prev = self._prev_sample(cur_sample, a_t, a_prev, eps_prime)
        state = dict(state)
        state['ets'] = ets
        state['cur_sample'] = new_cur
        return prev, state

    @staticmethod
    def _prev_sample(sample, a_t, a_prev, eps):
        # PNDM transfer formula (eq. 11 of the PNDM paper).
        sigma_prev = torch.sqrt(1 - a_prev)
        denom = a_t * sigma_prev + torch.sqrt(a_t * a_prev * (1 - a_t))
        return torch.sqrt(a_prev / a_t) * sample - (a_prev - a_t) * eps / denom


@dataclass
class EulerDiscreteScheduler(BaseScheduler):
    """Euler discrete (sigma parameterization, deterministic)."""

    def init_state(self, num_steps: int, sample_shape=None,
                   dtype=torch.float32, device='cpu') -> Dict[str, Any]:
        ts = self._timesteps_desc(num_steps).astype(np.float64)
        sigmas_full = np.sqrt((1 - self.alphas_cumprod) / self.alphas_cumprod)
        sigmas = np.interp(ts, np.arange(self.num_train_timesteps), sigmas_full)
        sigmas = np.concatenate([sigmas, [0.0]])
        return {
            'timesteps': torch.as_tensor(ts.round().astype(np.int64), device=device),
            'sigmas': _f32(sigmas, device),
        }

    @property
    def init_noise_sigma(self) -> float:
        sigmas = np.sqrt((1 - self.alphas_cumprod) / self.alphas_cumprod)
        return float(np.sqrt(sigmas.max() ** 2 + 1))

    def scale_model_input(self, state, sample, i):
        sigma = state['sigmas'][i]
        return sample / torch.sqrt(sigma ** 2 + 1)

    def step(self, state, i, model_output, sample):
        sigma = state['sigmas'][i]
        if self.prediction_type == 'v_prediction':
            x0 = (sample / (sigma ** 2 + 1)
                  - model_output * sigma / torch.sqrt(sigma ** 2 + 1))
        else:
            x0 = sample - sigma * model_output
        derivative = (sample - x0) / sigma
        dt = state['sigmas'][i + 1] - sigma
        return sample + derivative * dt, state


@dataclass
class DPMSolverMultistepScheduler(BaseScheduler):
    """DPM-Solver++ (2M), deterministic — the fast high-order sampler
    commonly paired with SDXL."""

    def init_state(self, num_steps: int, sample_shape=None,
                   dtype=torch.float32, device='cpu') -> Dict[str, Any]:
        assert sample_shape is not None, 'DPM-Solver needs sample_shape'
        ts = self._timesteps_desc(num_steps)
        alpha_bar = self.alphas_cumprod[ts]
        a = np.sqrt(alpha_bar)
        s = np.sqrt(1 - alpha_bar)
        lam = np.log(a) - np.log(s)

        # prev = c_sample·x + c_d·D, with the denoise-to-zero terminal as its
        # exact limit: sigma_N -> 0 gives c_sample = 0, c_d = 1 (prev = x0).
        c_sample = np.empty(len(ts))
        c_d = np.empty(len(ts))
        for i in range(len(ts) - 1):
            h = lam[i + 1] - lam[i]
            c_sample[i] = s[i + 1] / s[i]
            c_d[i] = -a[i + 1] * np.expm1(-h)
        c_sample[-1] = 0.0
        c_d[-1] = 1.0

        # lower_order_final: first order on the last step of a short
        # schedule (diffusers: len(timesteps) < 15).
        first_order = np.zeros(len(ts), dtype=np.int32)
        if len(ts) < 15:
            first_order[-1] = 1

        # finite stand-in for the terminal lambda (it enters only the
        # second-order ratio r, which the first-order last step never uses)
        lam_ext = np.concatenate([lam, [lam[-1] + 40.0]])
        return {
            'timesteps': torch.as_tensor(ts, device=device),
            'alpha_sqrt': _f32(a, device),
            'lambda': _f32(lam_ext, device),
            'c_sample': _f32(c_sample, device),
            'c_d': _f32(c_d, device),
            'first_order': first_order,
            'prev_x0': torch.zeros(tuple(sample_shape), dtype=dtype, device=device),
            'has_prev': 0,
        }

    def step(self, state, i, model_output, sample):
        a_bar = state['alpha_sqrt'][i] ** 2
        x0, _ = self._pred_x0_eps(a_bar, model_output, sample)

        if state['has_prev'] > 0 and not state['first_order'][i]:
            lam = state['lambda']
            h = lam[i + 1] - lam[i]
            r = (lam[i] - lam[max(i - 1, 0)]) / h
            d = x0 + (x0 - state['prev_x0']) / (2.0 * torch.where(r == 0, 1.0, r))
        else:
            d = x0
        prev = state['c_sample'][i] * sample + state['c_d'][i] * d

        state = dict(state)
        state['prev_x0'] = x0
        state['has_prev'] = state['has_prev'] + 1
        return prev, state


SCHEDULERS = {
    'ddim': DDIMScheduler,
    'pndm': PNDMScheduler,
    'euler': EulerDiscreteScheduler,
    'dpm++': DPMSolverMultistepScheduler,
    'dpmsolver': DPMSolverMultistepScheduler,
}


def get_scheduler(name: str, prediction_type: str = 'epsilon') -> BaseScheduler:
    if name not in SCHEDULERS:
        raise KeyError(f'unknown scheduler {name!r}; available: {sorted(SCHEDULERS)}')
    return SCHEDULERS[name](prediction_type=prediction_type)
