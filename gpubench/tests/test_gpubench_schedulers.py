"""The reference's samplers (``reference/schedulers.py``) against closed
forms worked out here in float64: v-prediction's x0 and ε, DDIM's step,
PNDM's timesteps, its multistep combinations and its transfer, and the
refusal of a sampler that the reference does not implement."""

import numpy as np
import pytest
import torch

from gpubench.reference import schedulers

SCHED = {'name': 'ddim', 'num_train_timesteps': 1000, 'beta_start': 0.00085,
         'beta_end': 0.012, 'beta_schedule': 'scaled_linear', 'steps_offset': 1,
         'set_alpha_to_one': False, 'eta': 0.0, 'prediction_type': 'epsilon'}


def cfg(**scheduler):
    return {'scheduler': dict(SCHED, **scheduler)}


def alphas():
    """ᾱ of the scaled-linear betas, float64."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    return np.cumprod(1 - betas)


def rand(seed, shape=(2, 4, 8, 8)):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)


def transfer(x, a_t, a_prev, eps):
    """x_prev = √(ᾱ_prev/ᾱ_t)·x − (ᾱ_prev − ᾱ_t)·ε / (ᾱ_t·√(1−ᾱ_prev) + √(ᾱ_t·(1−ᾱ_t)·ᾱ_prev))."""
    denom = a_t * np.sqrt(1 - a_prev) + np.sqrt(a_t * (1 - a_t) * a_prev)
    return np.sqrt(a_prev / a_t) * x - (a_prev - a_t) * eps / denom


def test_v_prediction_split():
    x, v = rand(0), rand(1)
    a = 0.3
    x0, eps = schedulers.split(v, x, torch.tensor(a, dtype=torch.float64), 'v_prediction')
    torch.testing.assert_close(x0, np.sqrt(a) * x - np.sqrt(1 - a) * v, rtol=0, atol=0)
    torch.testing.assert_close(eps, np.sqrt(a) * v + np.sqrt(1 - a) * x, rtol=0, atol=0)
    # x = √ᾱ·x0 + √(1−ᾱ)·ε and v = √ᾱ·ε − √(1−ᾱ)·x0
    torch.testing.assert_close(np.sqrt(a) * x0 + np.sqrt(1 - a) * eps, x)
    torch.testing.assert_close(np.sqrt(a) * eps - np.sqrt(1 - a) * x0, v)


def test_ddim_epsilon_step_is_the_arithmetic_it_was():
    """The epsilon step, operation for operation as the reference ran it
    before it followed other samplers: equal bit for bit."""
    ddim = schedulers.sampler(cfg(), 30, 'cpu')
    x, eps = rand(2).float(), rand(3).float()
    for i in (0, 13, 29):
        a_t, a_prev = ddim.a_t[i], ddim.a_prev[i]
        x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        want = torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps
        nxt, carry = ddim.step(i, eps, x)
        assert torch.equal(nxt, want)
        assert torch.equal(carry, torch.sqrt(a_prev / a_t) * x)


@pytest.mark.parametrize('prediction_type', ['epsilon', 'v_prediction'])
def test_ddim_step_closed_form(prediction_type):
    ac = alphas()
    ddim = schedulers.sampler(cfg(prediction_type=prediction_type), 30, 'cpu')
    assert ddim.timesteps.tolist() == [958 - 33 * k for k in range(30)]
    x, out = rand(4), rand(5)
    for i, t in enumerate(ddim.timesteps.tolist()):
        a_t, a_prev = ac[t], (ac[t - 33] if t >= 33 else ac[0])
        if prediction_type == 'epsilon':
            eps = out
        else:
            eps = np.sqrt(a_t) * out + np.sqrt(1 - a_t) * x
        x0 = (x - np.sqrt(1 - a_t) * eps) / np.sqrt(a_t)
        want = np.sqrt(a_prev) * x0 + np.sqrt(1 - a_prev) * eps
        nxt, carry = ddim.step(i, out.float(), x.float())
        torch.testing.assert_close(nxt.double(), want, rtol=2e-5, atol=2e-5)
        # the carry term leaves the step's noise term: the same as PNDM's transfer
        torch.testing.assert_close(nxt.double(), transfer(x, a_t, a_prev, eps), rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(carry.double(), np.sqrt(a_prev / a_t) * x, rtol=2e-6, atol=2e-6)


def test_evaluations():
    assert schedulers.evaluations(cfg(), 30) == 30
    assert schedulers.evaluations(cfg(name='pndm', skip_prk_steps=True), 30) == 31
    assert schedulers.evaluations(cfg(name='pndm', skip_prk_steps=True), 1) == 1


def test_pndm_timesteps():
    """diffusers' plms_timesteps with skip_prk_steps: 958, 925, 925, 892, …, 1."""
    pndm = schedulers.sampler(cfg(name='pndm', skip_prk_steps=True), 30, 'cpu')
    ts = [958 - 33 * k for k in range(30)]
    assert pndm.timesteps.tolist() == ts[:2] + ts[1:]
    assert len(pndm.timesteps) == 31
    assert schedulers.sampler(cfg(name='pndm', skip_prk_steps=True), 1, 'cpu').timesteps.tolist() == [1]


def test_pndm_constant_noise_is_exact():
    """With the same ε at every evaluation every multistep combination is ε,
    and the transfer is DDIM's step: the latents after evaluation i ≥ 1 are
    √ᾱ_prev·x0 + √(1−ᾱ_prev)·ε of step i − 1, with x0 from the start."""
    ac = alphas()
    pndm = schedulers.sampler(cfg(name='pndm', skip_prk_steps=True), 30, 'cpu')
    x_T, eps = rand(6), rand(7)
    x0 = (x_T - np.sqrt(1 - ac[958]) * eps) / np.sqrt(ac[958])
    x = x_T.float()
    for i in range(31):
        x, _ = pndm.step(i, eps.float(), x)
        if i >= 1:
            t_prev = 958 - 33 * i
            a_prev = ac[t_prev] if t_prev >= 0 else ac[0]
            want = np.sqrt(a_prev) * x0 + np.sqrt(1 - a_prev) * eps
            torch.testing.assert_close(x.double(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('prediction_type', ['epsilon', 'v_prediction'])
def test_pndm_multistep(prediction_type):
    """Each evaluation's output o_i differs; the latents given differ too.
    Eval 0: o_0 from x_0; eval 1: (o_1 + o_0)/2 from x_0 again, t_0 → t_1;
    then the history without o_1: (3o_2 − o_0)/2, (23o_3 − 16o_2 + 5o_0)/12,
    (55o_k − 59o_{k−1} + 37o_{k−2} − 9o_{k−3})/24.  Under v-prediction the
    combination is turned into ε with the ᾱ and latents it integrates from."""
    ac = alphas()
    pndm = schedulers.sampler(cfg(name='pndm', skip_prk_steps=True,
                                  prediction_type=prediction_type), 30, 'cpu')
    outs = [rand(100 + i) for i in range(8)]
    xs = [rand(200 + i) for i in range(8)]
    hist = [0, 2, 3, 4, 5, 6, 7]  # evaluations whose outputs enter the history
    for i in range(8):
        o = outs
        if i == 0:
            comb, x_from, t, t_prev = o[0], xs[0], 958, 925
        elif i == 1:
            comb, x_from, t, t_prev = (o[1] + o[0]) / 2, xs[0], 958, 925
        else:
            h = [o[k] for k in hist[:hist.index(i) + 1]][-4:]
            x_from, t = xs[i], 958 - 33 * (i - 1)
            t_prev = t - 33
            if len(h) == 2:
                comb = (3 * h[-1] - h[-2]) / 2
            elif len(h) == 3:
                comb = (23 * h[-1] - 16 * h[-2] + 5 * h[-3]) / 12
            else:
                comb = (55 * h[-1] - 59 * h[-2] + 37 * h[-3] - 9 * h[-4]) / 24
        a_t, a_prev = ac[t], ac[t_prev]
        eps = comb if prediction_type == 'epsilon' else np.sqrt(a_t) * comb + np.sqrt(1 - a_t) * x_from
        nxt, carry = pndm.step(i, outs[i].float(), xs[i].float())
        torch.testing.assert_close(nxt.double(), transfer(x_from, a_t, a_prev, eps), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(carry.double(), np.sqrt(a_prev / a_t) * x_from, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('change,word', [
    (dict(name='euler'), 'scheduler.name'),
    (dict(prediction_type='sample'), 'scheduler.prediction_type'),
    (dict(beta_schedule='linear'), 'scheduler.beta_schedule'),
    (dict(eta=0.5), 'scheduler.eta'),
    (dict(name='pndm'), 'skip_prk_steps'),
    (dict(name='pndm', skip_prk_steps=False), 'skip_prk_steps'),
])
def test_refuses_what_it_does_not_implement(change, word):
    c = cfg(**change)
    assert any(word in b for b in schedulers.unsupported(c))
    with pytest.raises(ValueError, match=word):
        schedulers.sampler(c, 30, 'cpu')


def test_implements_the_benchmarks_samplers():
    assert schedulers.unsupported(cfg()) == []
    assert schedulers.unsupported(cfg(prediction_type='v_prediction')) == []
    assert schedulers.unsupported(cfg(name='pndm', skip_prk_steps=True)) == []
