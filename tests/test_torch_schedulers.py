"""The port's schedulers against daam_tpu's: tables, steps and state."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daam_tpu.pipeline import schedulers as jax_schedulers
from daam_tpu.pipeline.schedulers import get_scheduler as jax_get_scheduler
from daam_tpu_torch.pipeline import schedulers
from daam_tpu_torch.pipeline.schedulers import get_scheduler

# The arithmetic tables of each scheduler (float64 numpy cast to float32 on
# both sides), and the control tables the port keeps on the host.
TABLES = {'ddim': ('timesteps', 'alpha_t', 'alpha_prev'),
          'pndm': ('timesteps', 'alpha_t', 'alpha_prev', 'use_cur', 'push', 'order'),
          'euler': ('timesteps', 'sigmas'),
          'dpm++': ('timesteps', 'alpha_sqrt', 'lambda', 'c_sample', 'c_d',
                    'first_order')}
# The sample-shaped state a step carries to the next.
CARRIED = {'ddim': (), 'pndm': ('ets', 'cur_sample'), 'euler': (),
           'dpm++': ('prev_x0',)}
# A DDIM step is a few fp32 ops; the multistep combinations and Euler's
# division by sigma round more.
RTOL = {'ddim': 1e-6, 'pndm': 1e-5, 'euler': 1e-5, 'dpm++': 1e-5}
SHAPE = (1, 4, 8, 8)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize('prediction_type', ['epsilon', 'v_prediction'])
@pytest.mark.parametrize('num_steps', [1, 2, 3, 10, 50])
def test_ddim_tables_and_steps_match_daam_tpu(num_steps, prediction_type):
    _match_daam_tpu('ddim', num_steps, prediction_type)


@pytest.mark.parametrize('prediction_type', ['epsilon', 'v_prediction'])
@pytest.mark.parametrize('num_steps', [1, 2, 3, 10, 50])
@pytest.mark.parametrize('name', ['pndm', 'euler', 'dpm++'])
def test_tables_and_steps_match_daam_tpu(name, num_steps, prediction_type):
    _match_daam_tpu(name, num_steps, prediction_type)


def _match_daam_tpu(name, num_steps, prediction_type):
    """Tables are equal exactly.  Every step starts both sides from the
    same sample, so one step's fp32 rounding is what is compared (it would
    compound over 50 steps), within RTOL.  The carried state (PNDM's eps
    history and saved sample, DPM++'s previous x0) evolves on each side
    over the whole schedule and must agree at every step, at the same
    tolerance."""
    ours = get_scheduler(name, prediction_type)
    theirs = jax_get_scheduler(name, prediction_type)
    n = ours.num_scan_steps(num_steps)
    assert n == theirs.num_scan_steps(num_steps)
    assert ours.init_noise_sigma == theirs.init_noise_sigma

    state = ours.init_state(num_steps, SHAPE)
    jstate = theirs.init_state(num_steps, SHAPE)
    assert sorted(state) == sorted(jstate)
    for key in TABLES[name]:
        np.testing.assert_array_equal(_np(state[key]), np.asarray(jstate[key]),
                                      err_msg=key)
        assert len(state[key]) >= n, key
    for key in TABLES[name][1:]:
        if np.asarray(jstate[key]).dtype == np.float32:
            assert state[key].dtype == torch.float32, key

    rng = np.random.RandomState(num_steps)
    sample = rng.randn(*SHAPE).astype(np.float32)
    for i in range(n):
        out = rng.randn(*SHAPE).astype(np.float32)
        x = ours.scale_model_input(state, torch.from_numpy(sample), i)
        jx = theirs.scale_model_input(jstate, jnp.asarray(sample), i)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6, atol=0)
        prev, state = ours.step(state, i, torch.from_numpy(out),
                                torch.from_numpy(sample))
        jprev, jstate = theirs.step(jstate, i, jnp.asarray(out), jnp.asarray(sample))
        np.testing.assert_allclose(prev.numpy(), np.asarray(jprev), rtol=RTOL[name],
                                   atol=1e-6, err_msg=f'step {i}')
        for key in CARRIED[name]:
            np.testing.assert_allclose(state[key].numpy(), np.asarray(jstate[key]),
                                       rtol=RTOL[name], atol=1e-6, err_msg=f'{key} {i}')
        sample = np.array(jprev)


@pytest.mark.parametrize('num_steps, evaluations', [(1, 1), (2, 3), (3, 4), (10, 11)])
def test_pndm_evaluates_the_second_timestep_twice(num_steps, evaluations):
    """num_steps + 1 UNet evaluations past one step; the repeated timestep's
    output is not pushed, and the step after it restarts from the first
    step's sample; the order of the multistep rises to 4 and stays."""
    sched = get_scheduler('pndm')
    state = sched.init_state(num_steps, SHAPE)
    assert sched.num_scan_steps(num_steps) == evaluations
    ts = state['timesteps'].tolist()
    assert len(ts) == evaluations
    if num_steps > 1:
        assert ts[1] == ts[2] and list(state['push']).count(0) == 1
        assert state['push'][1] == 0 and state['use_cur'][1] == 1
        assert list(state['order']) == [min(i, 4) for i in range(evaluations)]
    # eps history: newest first, the repeated timestep's output left out
    outs = [torch.full(SHAPE, float(i + 1)) for i in range(evaluations)]
    sample = torch.zeros(SHAPE)
    for i, out in enumerate(outs):
        _, state = sched.step(state, i, out, sample)
    pushed = [o for i, o in enumerate(outs) if state['push'][i]][::-1][:4]
    for got, want in zip(state['ets'], pushed):
        assert torch.equal(got, want)


def test_euler_scales_the_noise_and_the_model_input():
    """init_noise_sigma = √(σ_max² + 1) ≈ 14.6 for SD's betas, and the
    model sees sample / √(σ_i² + 1)."""
    sched = get_scheduler('euler')
    assert 14.5 < sched.init_noise_sigma < 14.7
    state = sched.init_state(10, SHAPE)
    sigma = state['sigmas'][0]
    x = torch.ones(SHAPE)
    torch.testing.assert_close(sched.scale_model_input(state, x, 0),
                               x / torch.sqrt(sigma ** 2 + 1))
    assert state['sigmas'][-1] == 0 and len(state['sigmas']) == 11


@pytest.mark.parametrize('num_steps, last_first_order', [(10, 1), (14, 1), (15, 0), (50, 0)])
def test_dpm_first_order_final_step_below_15_steps(num_steps, last_first_order):
    state = get_scheduler('dpm++').init_state(num_steps, SHAPE)
    assert state['first_order'][-1] == last_first_order
    assert int(np.sum(state['first_order'])) == last_first_order
    assert torch.isfinite(state['lambda']).all()
    assert state['c_sample'][-1] == 0 and state['c_d'][-1] == 1


def test_registry_and_unknown_name_match_daam_tpu():
    assert sorted(schedulers.SCHEDULERS) == sorted(jax_schedulers.SCHEDULERS)
    for name, cls in schedulers.SCHEDULERS.items():
        assert cls.__name__ == jax_schedulers.SCHEDULERS[name].__name__, name
    assert type(get_scheduler('dpmsolver')) is type(get_scheduler('dpm++'))
    assert get_scheduler('pndm', 'v_prediction').prediction_type == 'v_prediction'
    with pytest.raises(KeyError) as ours:
        get_scheduler('lms')
    with pytest.raises(KeyError) as theirs:
        jax_get_scheduler('lms')
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize('name', ['pndm', 'dpm++'])
def test_state_lives_on_the_device_and_control_tables_on_the_host(name):
    """Branching tables are numpy / Python ints, so a step never reads the
    device to decide its path."""
    state = get_scheduler(name).init_state(10, SHAPE, device='cpu')
    for key, val in state.items():
        if key in CARRIED[name] or key == 'timesteps' or (
                key in TABLES[name] and np.asarray(val).dtype.kind == 'f'):
            assert torch.is_tensor(val), key
        else:
            assert not torch.is_tensor(val), key
