"""The head-replay path of daam_tpu_torch against daam_tpu.

* The plain version of the ``cross_attention_probs`` kernel (K5) against
  ``daam_tpu``'s Pallas kernel in interpret mode and its jnp path, fp32 at
  atol 1e-5 (the same fp32 arithmetic in another order), and with
  ``cond_only`` and bf16 P at 3e-2, as ``tests/test_pallas_attention.py``
  holds the Pallas kernel.
* ``cross_attention`` with ``capture`` 'full'/'cond' and with replayed
  probabilities (alone and under ``'acc'``) against ``daam_tpu``'s.
* On ``tiny``, with the same params (``from_jax_params``) and the same
  injected latents as ``tests/test_torch_pipeline.py``: the fp32
  ``save_heads`` buffer per layer and step (atol 1e-4), the per-step maps
  from the buffer and from ``time_chunk_steps=1`` snapshots with
  ``low_memory=True``, and the ``.npz`` exchanged both ways (images within
  2/255, heat maps per token Spearman ≥ 0.99 and ``_assert_close``).
* The port's own analogues of ``tests/test_heads_io.py`` and
  ``tests/test_pipeline_trace.py:125-150``.

The kernel itself runs only on a CUDA card (``cuda`` marker).
"""

import importlib
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daam_tpu import trace as jax_trace
from daam_tpu.ops import attention as jax_attention
from daam_tpu.ops import pallas_attention as P
from daam_tpu.pipeline.sd import StableDiffusionPipeline as JaxPipeline
from daam_tpu_torch import StableDiffusionPipeline, release_heads, set_seed, trace
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config
from daam_tpu_torch.ops import attention as A
from daam_tpu_torch.ops import kernels

from test_e2e_fidelity_torch import _assert_close, _spearman
from test_torch_attention import _head_major_view, _merged, _packed_view, _qkv
from test_torch_models import jax_params

jax_trace_mod = importlib.import_module('daam_tpu.trace')
trace_mod = importlib.import_module('daam_tpu_torch.trace')

ATOL = 1e-5
PROMPT = 'A dog runs across the field .'
PROMPT2 = 'A cat sits on the mat .'
STEPS = 3
VIEWS = {'head_major': _head_major_view, 'packed': _packed_view}


@pytest.fixture
def jax_kernel_mode():
    mode = jax_attention.get_kernel_mode()
    yield jax_attention.set_kernel_mode
    jax_attention.set_kernel_mode(mode)


@pytest.fixture
def registries(monkeypatch, tmp_path):
    """Empty head registries in both packages and a private cache dir."""
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path))
    monkeypatch.setattr(jax_trace_mod, '_HEAD_CACHE', OrderedDict())
    monkeypatch.setattr(trace_mod, '_HEAD_CACHE', OrderedDict())
    return tmp_path


# ---------------------------------------------------------------------------
# K5 and the cross_attention contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('Lq,Lk', [(64, 77), (100, 77), (64, 13)])
@pytest.mark.parametrize('layout', ['head_major', 'packed'])
def test_cross_attention_probs_plain_matches_daam_tpu(Lq, Lk, layout,
                                                      jax_kernel_mode):
    B, H, hd = 2, 2, 64
    q, k, v = _qkv(B, H, Lq, Lk, hd, seed=Lq + Lk)
    view = VIEWS[layout]
    out, p = A.cross_attention_probs(view(q), view(k), view(v))
    assert out.shape == (B, Lq, H * hd)
    assert p.dtype == torch.float32 and p.shape == (B, H, Lq, Lk)

    pallas_out, pallas_p = P.cross_attention_probs(*map(jnp.asarray, (q, k, v)),
                                                   q_tile=64)
    jax_kernel_mode('jnp')
    jnp_out, jnp_p = jax_attention.cross_attention(*map(jnp.asarray, (q, k, v)),
                                                   capture='full')
    for ref_out, ref_p in ((pallas_out, pallas_p), (jnp_out, jnp_p)):
        np.testing.assert_allclose(out.numpy(), _merged(ref_out), rtol=0, atol=ATOL)
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize('layout', ['head_major', 'packed'])
def test_cross_attention_probs_cond_only_bf16(layout):
    """bf16 inputs and P, conditional half only (CFG layout [uncond; cond]):
    O is defined for every row, P for the second half of the batch."""
    B, H, Lq, Lk = 4, 2, 64, 77
    q, k, v = _qkv(B, H, Lq, Lk, 64, seed=3)
    view = VIEWS[layout]
    out, p = A.cross_attention_probs(
        *(view(t).to(torch.bfloat16) for t in (q, k, v)), cond_only=True,
        probs_dtype=torch.bfloat16)
    ref_out, ref_p = P.cross_attention_probs(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), q_tile=32,
        cond_only=True, probs_dtype=jnp.bfloat16)
    assert out.dtype == p.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               _merged(np.asarray(ref_out, np.float32)),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(p[B // 2:].float().numpy(),
                               np.asarray(ref_p[B // 2:], np.float32),
                               rtol=3e-2, atol=1e-2)


@pytest.mark.parametrize('capture', ['full', 'cond', True])
def test_cross_attention_capture_matches_daam_tpu(capture, jax_kernel_mode):
    B, H, Lq, Lk, hd = 4, 2, 40, 77, 64
    q, k, v = _qkv(B, H, Lq, Lk, hd, seed=5)
    out, probs = A.cross_attention(*map(_packed_view, (q, k, v)), capture=capture)
    jax_kernel_mode('jnp')
    jout, jprobs = jax_attention.cross_attention(*map(jnp.asarray, (q, k, v)),
                                                 capture=capture)
    np.testing.assert_allclose(out.numpy(), _merged(jout), rtol=0, atol=ATOL)
    assert probs.shape == (B, H, Lq, Lk)
    if capture == 'cond':  # bf16, conditional half defined
        assert probs.dtype == torch.bfloat16 and jprobs.dtype == jnp.bfloat16
        np.testing.assert_allclose(probs[B // 2:].float().numpy(),
                                   np.asarray(jprobs[B // 2:], np.float32),
                                   rtol=0, atol=1 / 128)
    else:
        assert probs.dtype == torch.float32
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize('capture', [False, 'full', 'acc'])
def test_cross_attention_replay_matches_daam_tpu(capture, jax_kernel_mode):
    """Replayed probabilities replace the computed ones before the value
    product; under 'acc' their conditional half goes into the accumulator."""
    B, H, Lq, Lk, hd = 4, 2, 40, 77, 64
    q, k, v = _qkv(B, H, Lq, Lk, hd, seed=6)
    logits = np.random.RandomState(7).randn(B, H, Lq, Lk).astype(np.float32)
    replay = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    acc = torch.zeros(B // 2, H, Lk, Lq)
    ours = A.cross_attention(*map(_packed_view, (q, k, v)), capture=capture,
                             replay_probs=torch.from_numpy(replay),
                             acc=acc if capture == 'acc' else None)
    jax_kernel_mode('jnp')
    jacc = jnp.zeros(P.cross_acc_shape(B // 2, H, Lq, Lk), jnp.float32)
    jout, jprobs = jax_attention.cross_attention(
        *map(jnp.asarray, (q, k, v)), capture=capture,
        replay_probs=jnp.asarray(replay),
        acc=jacc if capture == 'acc' else None)
    if capture == 'full':
        ours, probs = ours
        np.testing.assert_array_equal(probs.numpy(), np.asarray(jprobs))
    np.testing.assert_allclose(ours.numpy(), _merged(jout), rtol=0, atol=ATOL)
    if capture == 'acc':
        np.testing.assert_allclose(acc.numpy(),
                                   np.asarray(jprobs)[:, :, :Lk, :Lq],
                                   rtol=0, atol=ATOL)


def test_cross_attention_rejects_unknown_capture():
    q, k, v = (_packed_view(t) for t in _qkv(2, 2, 8, 77, 16, seed=1))
    with pytest.raises(ValueError, match='capture'):
        A.cross_attention(q, k, v, capture='probs')
    with pytest.raises(ValueError, match='accumulator'):
        A.cross_attention(q, k, v, capture='acc')


# ---------------------------------------------------------------------------
# the replay path on tiny, against daam_tpu
# ---------------------------------------------------------------------------

def _np_maps(heat_maps):
    return [np.asarray(h.heat_maps.numpy() if torch.is_tensor(h.heat_maps)
                       else h.heat_maps, dtype=np.float32) for h in heat_maps]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Save, exchange and replay, in both packages, on shared params."""
    with pytest.MonkeyPatch.context() as mp:
        return _runs(mp, tmp_path_factory)


def _runs(mp, tmp_path_factory):
    mp.setenv('XDG_CACHE_HOME', str(tmp_path_factory.mktemp('cache')))
    mp.setattr(jax_trace_mod, '_HEAD_CACHE', OrderedDict())
    mp.setattr(trace_mod, '_HEAD_CACHE', OrderedDict())
    npz = tmp_path_factory.mktemp('heads')
    config = get_pipeline_config('tiny')
    params = jax_params(config, seed=4)
    key = jax.random.PRNGKey(7)
    jpipe = JaxPipeline(config, params)
    jpipe.heads_dtype = jnp.float32
    s = config.unet.sample_size
    latents = (np.asarray(jax.random.normal(key, (1, s, s, 4))) *
               jpipe.scheduler.init_noise_sigma).transpose(0, 3, 1, 2)
    r = {}

    with jax_trace(jpipe, save_heads=True, persist_heads=False,
                   data_dir='jax-save') as jtc:
        jpipe(PROMPT, num_inference_steps=STEPS, generator=key, output_type='np')
        r['jbuf'] = {n: np.asarray(a) for n, a in jtc.replay_buffer(STEPS).items()}
        r['jmap'] = np.asarray(jtc.compute_global_heat_map().heat_maps)
        r['jtime'] = _np_maps(jtc.compute_time_global_heat_maps())
        jtc.dump_heads(npz / 'jax.npz')

    pipe = StableDiffusionPipeline(config, **W.load_modules(
        config, W.from_jax_params(params), device='cpu'))
    pipe.heads_dtype = torch.float32
    with trace(pipe, save_heads=True, persist_heads=False,
               data_dir='port-save') as tc:
        out = pipe(PROMPT, num_inference_steps=STEPS, latents=latents,
                   output_type='np')
        r['image'] = out.images[0]
        r['buf'] = tc.replay_buffer(STEPS)
        r['map'] = tc.compute_global_heat_map().heat_maps.numpy()
        r['time'] = _np_maps(tc.compute_time_global_heat_maps())
    pipe.heads_dtype = torch.bfloat16  # the reverse exchange goes through fp16
    with trace(pipe, save_heads=True, persist_heads=False,
               data_dir='port-save-bf16') as tc:
        pipe(PROMPT, num_inference_steps=STEPS, latents=latents)
        tc.dump_heads(npz / 'port.npz')

    # Each package replays each file into the second prompt.
    for src in ('jax', 'port'):
        with jax_trace(jpipe, load_heads=True, data_dir=f'jax-load-{src}') as jtc:
            jtc.load_heads_from(npz / f'{src}.npz')
            jout = jpipe(PROMPT2, num_inference_steps=STEPS, generator=key,
                         output_type='np')
            r[f'jload_{src}'] = (jout.images[0], np.asarray(
                jtc.compute_global_heat_map().heat_maps))
        with trace(pipe, load_heads=True, data_dir=f'port-load-{src}') as tc:
            tc.load_heads_from(npz / f'{src}.npz')
            out = pipe(PROMPT2, num_inference_steps=STEPS, latents=latents,
                       output_type='np')
            r[f'load_{src}'] = (out.images[0],
                                tc.compute_global_heat_map().heat_maps.numpy())

    # Per-step maps from accumulator snapshots, with low_memory.
    with jax_trace(jpipe, low_memory=True, time_chunk_steps=1) as jtc:
        jpipe(PROMPT, num_inference_steps=STEPS, generator=key)
        r['jlow_map'] = np.asarray(jtc.compute_global_heat_map().heat_maps)
        r['jlow_time'] = _np_maps(jtc.compute_time_global_heat_maps())
        r['jlow_layers'] = list(jtc.layer_names)
    with trace(pipe, low_memory=True, time_chunk_steps=1) as tc:
        pipe(PROMPT, num_inference_steps=STEPS, latents=latents)
        r['low_map'] = tc.compute_global_heat_map().heat_maps.numpy()
        r['low_time'] = _np_maps(tc.compute_time_global_heat_maps())
        r['low_layers'] = list(tc.layer_names)
        r['low_blocks'] = (dict(tc.batch_heat_maps), list(tc.time_blocks))
    return r


def _assert_maps_match(ours, theirs):
    assert ours.shape == theirs.shape
    _assert_close(ours, theirs)


def test_save_buffer_matches_daam_tpu(runs):
    """fp32 save_heads buffer: every layer (the mid block's included), every
    step, every CFG row."""
    buf, jbuf = runs['buf'], runs['jbuf']
    assert sorted(buf) == sorted(jbuf) == ['down_0_0', 'mid_0', 'up_0_0', 'up_0_1']
    for name, a in buf.items():
        assert a.dtype == torch.float32 and a.device.type == 'cpu'
        assert tuple(a.shape) == jbuf[name].shape
        assert a.shape[:2] == (STEPS, 2) and a.shape[-1] == 77
        for step in range(STEPS):
            np.testing.assert_allclose(a[step].numpy(), jbuf[name][step],
                                       rtol=0, atol=1e-4, err_msg=f'{name} {step}')


def test_save_run_heat_maps_match_daam_tpu(runs):
    """Under save_heads the maps come from the 'full' capture's P."""
    _assert_maps_match(runs['map'], runs['jmap'])


def test_time_maps_from_buffer_match_daam_tpu(runs):
    assert len(runs['time']) == len(runs['jtime']) == STEPS
    for ours, theirs in zip(runs['time'], runs['jtime']):
        _assert_maps_match(ours, theirs)
    # the per-step maps add up to the trajectory map (up to the clamp)
    np.testing.assert_allclose(np.sum(runs['time'], axis=0), runs['map'],
                               rtol=0.08, atol=5e-3)


@pytest.mark.parametrize('src', ['jax', 'port'])
def test_npz_exchange_replays_like_daam_tpu(runs, src):
    """A buffer dumped by one package and replayed into another prompt by
    both gives the same images and maps (jax.npz is fp32, port.npz fp16)."""
    (image, heat), (jimage, jheat) = runs[f'load_{src}'], runs[f'jload_{src}']
    assert np.abs(image - jimage).max() <= 2 / 255
    for tok in range(heat.shape[0]):
        assert _spearman(heat[tok], jheat[tok]) >= 0.99, tok
    _assert_maps_match(heat, jheat)


def test_low_memory_snapshot_time_maps_match_daam_tpu(runs):
    assert runs['low_layers'] == runs['jlow_layers'] == ['up-attn-0', 'down-attn-0']
    _assert_maps_match(runs['low_map'], runs['jlow_map'])
    assert len(runs['low_time']) == len(runs['jlow_time']) == STEPS
    for ours, theirs in zip(runs['low_time'], runs['jlow_time']):
        _assert_maps_match(ours, theirs)
    # the snapshots are fp16 differences that add up to the accumulator
    final, snaps = runs['low_blocks']
    for factor, block in final.items():
        total = sum(s[factor].float() for s in snaps)
        np.testing.assert_allclose(total.numpy(), block.numpy(), rtol=5e-3,
                                   atol=5e-4)


# ---------------------------------------------------------------------------
# the port on its own (tests/test_heads_io.py, test_pipeline_trace.py:125-150)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def pipe():
    return StableDiffusionPipeline.from_pretrained('tiny', device='cpu')


def _image(pipe, prompt, data_dir=None, seed=0, steps=2, **trace_kwargs):
    """One generation (traced when ``trace_kwargs`` are given) as uint8."""
    gen = set_seed(seed, device='cpu')
    if not trace_kwargs:
        return np.asarray(pipe(prompt, num_inference_steps=steps,
                               generator=gen).images[0])
    with trace(pipe, data_dir=data_dir, **trace_kwargs):
        return np.asarray(pipe(prompt, num_inference_steps=steps,
                               generator=gen).images[0])


def test_replay_reproduces_same_prompt(pipe, registries):
    saved = _image(pipe, 'a dog runs', 'same', save_heads=True)
    replayed = _image(pipe, 'a dog runs', 'same', load_heads=True)
    np.testing.assert_allclose(saved.astype(np.float32),
                               replayed.astype(np.float32), atol=2.0)


def test_full_precision_replay_is_exact(pipe, registries):
    pipe.heads_dtype = torch.float32
    try:
        saved = _image(pipe, 'a dog runs', 'fp32', seed=1, steps=3, save_heads=True)
    finally:
        pipe.heads_dtype = torch.bfloat16
    with np.load(trace(pipe, data_dir='fp32').heads_path()) as data:
        assert all(data[n].dtype == np.float32 for n in data.files)
    np.testing.assert_array_equal(
        saved, _image(pipe, 'a dog runs', 'fp32', seed=1, steps=3, load_heads=True))


def test_transplant_changes_the_image(pipe, registries):
    _image(pipe, 'a dog runs', 'swap', save_heads=True)
    transplanted = _image(pipe, 'a cat runs', 'swap', load_heads=True)
    assert not np.array_equal(transplanted, _image(pipe, 'a cat runs'))


def test_persist_and_restart_round_trip(pipe, registries):
    """save_heads persists on exit; with the registry emptied (a restart)
    load_heads reads the file back."""
    with trace(pipe, save_heads=True, data_dir='restart') as tc:
        saved = np.asarray(pipe('a dog runs', num_inference_steps=2,
                                generator=set_seed(0, device='cpu')).images[0])
    path = tc.heads_path()
    assert path == registries / 'daam_tpu' / 'heads' / 'restart.npz'
    assert path.stat().st_size > 0
    assert release_heads('restart') and not release_heads('restart')
    replayed = _image(pipe, 'a dog runs', 'restart', load_heads=True)
    np.testing.assert_allclose(saved.astype(np.float32),
                               replayed.astype(np.float32), atol=4.0)
    assert list(trace_mod._HEAD_CACHE) == ['restart']


def test_heads_path_matches_daam_tpu(pipe, registries):
    """The same data_dir names the same file in both packages."""
    for key in ('default', 'a b/c', 'x' * 60):
        ours = trace(pipe, data_dir=key).heads_path()
        # daam_tpu's heads_path reads only data_dir
        theirs = jax_trace_mod.DiffusionHeatMapHooker.heads_path(
            type('Key', (), {'data_dir': key})())
        assert ours == theirs, key


def test_persist_heads_opt_out(pipe, registries):
    with trace(pipe, save_heads=True, data_dir='no-persist',
               persist_heads=False) as tc:
        pipe('a dog runs', num_inference_steps=2, generator=set_seed(0, device='cpu'))
    assert not tc.heads_path().exists()
    assert 'no-persist' in trace_mod._HEAD_CACHE


def test_replay_missing_raises(pipe, registries):
    with trace(pipe, load_heads=True, data_dir='nonexistent-key'):
        with pytest.raises(RuntimeError, match='No saved attention heads'):
            pipe('a dog runs', num_inference_steps=2)


def test_replay_step_count_and_geometry_mismatch_raise(pipe, registries):
    _image(pipe, 'a dog runs', 'short', save_heads=True)
    with trace(pipe, load_heads=True, data_dir='short'):
        with pytest.raises(RuntimeError, match='covers 2 sampling steps'):
            pipe('a dog runs', num_inference_steps=5)
        with pytest.raises(RuntimeError, match='same batch size'):
            pipe(['a dog runs', 'a cat sits'], num_inference_steps=2)


def test_head_cache_lru_eviction_and_release(pipe, registries, monkeypatch):
    monkeypatch.setattr(trace_mod, '_HEAD_CACHE_MAX', 2)
    for i in range(3):
        _image(pipe, 'a dog', f'lru-{i}', seed=i, save_heads=True)
    assert list(trace_mod._HEAD_CACHE) == ['lru-1', 'lru-2']
    # the evicted entry reloads from its file, evicting the oldest in turn
    _image(pipe, 'a dog', 'lru-0', load_heads=True)
    assert list(trace_mod._HEAD_CACHE) == ['lru-2', 'lru-0']
    assert release_heads('lru-2') is True
    assert release_heads('lru-2') is False
    assert release_heads() is True
    assert len(trace_mod._HEAD_CACHE) == 0


def test_time_maps_without_any_source_raises(pipe, registries):
    with trace(pipe, data_dir='no-time-source') as tc:
        pipe('a dog', num_inference_steps=2)
        with pytest.raises(RuntimeError, match='time_chunk_steps'):
            tc.compute_time_global_heat_maps()


def test_time_maps_chunked_coarser_granularity(pipe):
    with trace(pipe, time_chunk_steps=2) as tc:
        pipe('a cat', num_inference_steps=5)
        assert len(tc.compute_time_global_heat_maps()) == 3  # 2 + 2 + 1


def test_save_heads_chunked_matches_single_chunk(pipe, registries):
    """heads_chunk_steps only bounds device memory: 2 + 2 + 1 steps give the
    buffer of one chunk."""
    bufs = []
    for chunk in (8, 2):
        pipe.heads_chunk_steps = chunk
        try:
            with trace(pipe, save_heads=True, data_dir=f'chunk{chunk}',
                       persist_heads=False) as tc:
                pipe('a cat on a mat', num_inference_steps=5,
                     generator=set_seed(3, device='cpu'))
                bufs.append(tc.replay_buffer(5))
        finally:
            pipe.heads_chunk_steps = 8
    assert sorted(bufs[0]) == sorted(bufs[1])
    for name, a in bufs[0].items():
        assert a.shape[0] == 5
        torch.testing.assert_close(a, bufs[1][name], rtol=0, atol=0)


def test_layer_heads_and_mid_block_located(pipe):
    assert trace(pipe).layer_heads == [2, 2, 2]
    tc = trace(pipe, save_heads=True)
    assert tc.layer_names == ['up-attn-0', 'up-attn-1', 'down-attn-0',
                              'mid-attn-0']
    assert tc.layer_heads == [2, 2, 2, 4]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc (the kernels run only there)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('hd', kernels.HEAD_DIMS)
@pytest.mark.parametrize('Lk', [77, 13])
@pytest.mark.parametrize('probs_dtype', [torch.float32, torch.bfloat16])
def test_cross_attention_probs_kernel_matches_plain_on_card(hd, Lk, probs_dtype,
                                                            cuda_device):
    B, H, Lq = 4, 3, 100
    q, k, v = (_packed_view(t).to(cuda_device)
               for t in _qkv(B, H, Lq, Lk, hd, seed=hd + Lk))
    n = kernels.launches['cross_attention_probs']
    for cond_only in (False, True):
        out, p = kernels.cross_attention_probs(q, k, v, cond_only, probs_dtype)
        ref_out, ref_p = A.cross_attention_probs_plain(q, k, v, cond_only,
                                                       probs_dtype)
        torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-4)
        rows = slice(B // 2, None) if cond_only else slice(None)
        atol = 1e-5 if probs_dtype == torch.float32 else 1 / 128
        torch.testing.assert_close(p[rows].float(), ref_p[rows].float(),
                                   rtol=0, atol=atol)
    assert kernels.launches['cross_attention_probs'] == n + 2
