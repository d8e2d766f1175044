"""Data-parallel generation over ``torch.distributed``: two real processes.

``tests/torch_mp_child.py`` runs twice, joined in a Gloo group through
``init_distributed()`` from ``RANK``/``WORLD_SIZE``/``MASTER_*`` (what
``torchrun`` sets), and runs ``generate_batch`` on ``tiny`` over 4 prompts
and then 3 (an uneven tail, padded).  Both ranks must hold every image and
every prompt's heat maps; the images must equal, bit for bit, a
single-process ``generate_batch`` and one ``pipe`` call per prompt, and the
heat maps must agree to fp32 rounding.  Every child has a timeout and runs
in a session of its own, which is killed whole on failure.  In one process,
``init_distributed()`` is a no-op, ``fetch_global`` is ``x.cpu().numpy()``,
and ``generate_batch`` refuses a trace that saves or loads heads.
"""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from daam_tpu_torch import StableDiffusionPipeline, trace
from daam_tpu_torch.parallel import fetch_global, generate_batch, init_distributed, is_multi_process

from torch_mp_child import PROMPTS, STEPS

REPO = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / 'torch_mp_child.py'
WORLD = 2
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def mp_outputs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp('torch-mp')
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS=str(torch.get_num_threads()),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get('PYTHONPATH', '')]))
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(outdir)],
                              env={**env, 'RANK': str(rank)}, cwd=str(REPO),
                              start_new_session=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:  # on a timeout or an error the whole session goes
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and (outdir / f'ok.{rank}').exists(), \
            f'rank {rank} failed (rc={p.returncode}):\n{log[-4000:]}'
    return outdir


@pytest.fixture(scope='module')
def truth():
    """In this process: ``generate_batch`` without a group, and one
    pipeline call per prompt (prompt i seeded i)."""
    pipe = StableDiffusionPipeline.from_pretrained('tiny', device='cpu')
    with trace(pipe) as tc:
        out = generate_batch(pipe, PROMPTS, num_inference_steps=STEPS, seed=0)
        batch = [(np.asarray(im), tc.compute_global_heat_map(batch_idx=i).heat_maps.numpy())
                 for i, im in enumerate(out.images)]
    single = []
    for i, prompt in enumerate(PROMPTS):
        with trace(pipe) as tc:
            out = pipe(prompt, num_inference_steps=STEPS,
                       generator=torch.Generator('cpu').manual_seed(i))
            single.append((np.asarray(out.images[0]),
                           tc.compute_global_heat_map().heat_maps.numpy()))
    return batch, single


@pytest.mark.parametrize('n', [4, 3])
def test_ranks_hold_every_prompt(mp_outputs, n):
    for i in range(n):
        for name in (f'img{n}-{i}', f'maps{n}-{i}'):
            np.testing.assert_array_equal(np.load(mp_outputs / f'{name}.0.npy'),
                                          np.load(mp_outputs / f'{name}.1.npy'), err_msg=name)
    assert not (mp_outputs / f'img{n}-{n}.0.npy').exists()  # the padding is sliced off


@pytest.mark.parametrize('n', [4, 3])
def test_two_processes_equal_one(mp_outputs, truth, n):
    batch, single = truth
    for i in range(n):
        image = np.load(mp_outputs / f'img{n}-{i}.0.npy')
        maps = np.load(mp_outputs / f'maps{n}-{i}.0.npy')
        for ref_image, ref_maps in (batch[i], single[i]):
            assert image.dtype == np.uint8 and image.shape == (16, 16, 3)
            np.testing.assert_array_equal(image, ref_image)
            np.testing.assert_allclose(maps, ref_maps, rtol=1e-5, atol=1e-7)


def test_single_process_defaults(monkeypatch):
    for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False and not is_multi_process()
    x = torch.arange(6.0).reshape(2, 3)
    out = fetch_global(x)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, x.numpy())
    np.testing.assert_array_equal(fetch_global(np.ones(3)), np.ones(3))


@pytest.mark.parametrize('flag', ['save_heads', 'load_heads'])
def test_generate_batch_refuses_head_replay(flag):
    """A replay buffer holds one pipeline call, and ``generate_batch``
    makes one per prompt: under ``save_heads`` or ``load_heads`` it raises
    before any call."""
    pipe = StableDiffusionPipeline.from_pretrained('tiny', device='cpu')
    calls = []
    pipe.unet.register_forward_pre_hook(lambda *_: calls.append(1))
    with trace(pipe, data_dir='mp-replay', persist_heads=False, **{flag: True}):
        with pytest.raises(ValueError, match='save_heads or load_heads'):
            generate_batch(pipe, PROMPTS[:2], num_inference_steps=STEPS, seed=5)
    assert calls == []
