"""daam_tpu_torch.ops.attention against daam_tpu's attention ops.

The plain versions of the two ported kernels (``flash_attention``, K2 with
K3's packed layout as its strided entry; ``cross_attention_acc``, K1 with
K4's layout) are held against ``daam_tpu``'s jnp path and its Pallas kernels
in interpret mode, in fp32 with atol 1e-5: both sides do the same fp32
arithmetic and differ only in summation order; and K2's in bf16 with atol
2e-2, the card's bf16 gate, since the two round P and O at other points.
The kernels themselves run only on a CUDA card; ``tests/test_torch_cuda.py``
holds them against the plain versions there at every head dim.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daam_tpu.ops import attention as jax_attention
from daam_tpu.ops import pallas_attention as P
from daam_tpu_torch.models.configs import cross_attention_layout, get_pipeline_config
from daam_tpu_torch.ops import attention as A
from daam_tpu_torch.ops import kernels

ATOL = 1e-5


def _qkv(B, H, Lq, Lk, hd, seed):
    """Head-major (B, H, L, hd) fp32 inputs from a numpy seed."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Lq, hd).astype(np.float32),
            rng.randn(B, H, Lk, hd).astype(np.float32),
            rng.randn(B, H, Lk, hd).astype(np.float32))


def _head_major_view(x: np.ndarray) -> torch.Tensor:
    """(B, H, L, hd) array → (B, L, H, hd) strided view (no copy)."""
    return torch.from_numpy(x).transpose(1, 2)


def _packed(x: np.ndarray) -> np.ndarray:
    """(B, H, L, hd) → the (B, L, H·hd) projection layout."""
    B, H, L, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B, L, H * hd))


def _packed_view(x: np.ndarray) -> torch.Tensor:
    """(B, H, L, hd) array → (B, L, H, hd) view of its packed layout."""
    return torch.from_numpy(_packed(x)).unflatten(-1, (x.shape[1], -1))


def _merged(o_head_major) -> np.ndarray:
    """daam_tpu (B, H, L, hd) output → (B, L, H·hd)."""
    return _packed(np.asarray(o_head_major))


@pytest.fixture
def jax_kernel_mode():
    mode = jax_attention.get_kernel_mode()
    yield jax_attention.set_kernel_mode
    jax_attention.set_kernel_mode(mode)


@pytest.mark.parametrize('Lk', [77, 600, 1100])
@pytest.mark.parametrize('layout', ['head_major', 'packed'])
def test_flash_attention_plain_matches_daam_tpu(Lk, layout, jax_kernel_mode):
    """K2/K3: the plain version equals daam_tpu's jnp path and its Pallas
    kernel (interpret mode), across the 512-key online-chunk branch."""
    B, H, Lq, hd = 2, 2, 40, 64
    q, k, v = _qkv(B, H, Lq, Lk, hd, seed=Lk)
    view = _head_major_view if layout == 'head_major' else _packed_view
    ours = A.flash_attention(view(q), view(k), view(v)).numpy()

    jax_kernel_mode('jnp')
    jnp_out = _merged(jax_attention.self_attention(*map(jnp.asarray, (q, k, v))))
    if layout == 'head_major':
        pallas = _merged(P.flash_self_attention(*map(jnp.asarray, (q, k, v))))
    else:
        pallas = np.asarray(P.flash_self_attention_packed(
            *(jnp.asarray(_packed(t)) for t in (q, k, v)), heads=H))

    assert ours.shape == (B, Lq, H * hd)
    np.testing.assert_allclose(ours, jnp_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=ATOL)


@pytest.mark.parametrize('Lk', [77, 600, 1100])
@pytest.mark.parametrize('layout', ['head_major', 'packed'])
def test_flash_attention_plain_matches_daam_tpu_bf16(Lk, layout):
    """K2/K3 in bf16: the plain version against daam_tpu's Pallas kernel
    (interpret mode) on the same inputs cast to bf16, across the 512-key
    online-chunk branch.  The Pallas body rounds unnormalized P to bf16 and
    divides O after PV; the plain version rounds normalized P: atol 2e-2."""
    B, H, Lq, hd = 2, 2, 40, 64
    q, k, v = _qkv(B, H, Lq, Lk, hd, seed=Lk + 1)
    view = _head_major_view if layout == 'head_major' else _packed_view
    ours = A.flash_attention(*(view(t).to(torch.bfloat16) for t in (q, k, v)))
    assert ours.dtype == torch.bfloat16 and ours.shape == (B, Lq, H * hd)

    bf16 = lambda t: jnp.asarray(t, jnp.bfloat16)  # noqa: E731
    if layout == 'head_major':
        pallas = P.flash_self_attention(*map(bf16, (q, k, v)))
        pallas = _merged(pallas.astype(jnp.float32))
    else:
        pallas = np.asarray(P.flash_self_attention_packed(
            *(bf16(_packed(t)) for t in (q, k, v)), heads=H).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), pallas, rtol=0, atol=2e-2)


@pytest.mark.parametrize('layout', ['head_major', 'packed'])
def test_cross_attention_acc_plain_matches_daam_tpu(layout):
    """K1/K4: output and accumulator equal the Pallas kernels' over two
    calls into the same accumulator; the port's unpadded (B, H, 77, Lq)
    accumulator equals the Pallas one's valid region."""
    B, H, Lq, Lk, hd = 1, 2, 40, 77, 64
    view = _head_major_view if layout == 'head_major' else _packed_view
    acc = torch.zeros(B, H, Lk, Lq)
    acc_jax = jnp.zeros(P.cross_acc_shape(B, H, Lq, Lk), jnp.float32)
    for seed in (0, 1):
        q, k, v = _qkv(B, H, Lq, Lk, hd, seed=seed)
        ours = A.cross_attention_acc(view(q), view(k), view(v), acc).numpy()
        if layout == 'head_major':
            out, acc_jax = P.cross_attention_acc(
                *map(jnp.asarray, (q, k, v)), acc_jax)
            out = _merged(out)
        else:
            out, acc_jax = P.cross_attention_acc_packed(
                *(jnp.asarray(_packed(t)) for t in (q, k, v)), acc_jax, heads=H)
            out = np.asarray(out)
        np.testing.assert_allclose(ours, out, rtol=0, atol=ATOL)
    acc_jax = np.asarray(acc_jax)
    np.testing.assert_allclose(acc.numpy(), acc_jax[:, :, :Lk, :Lq],
                               rtol=0, atol=ATOL)
    assert np.all(acc_jax[:, :, Lk:] == 0) and np.all(acc_jax[:, :, :, Lq:] == 0)


def test_cross_attention_capture_acc_matches_daam_tpu(jax_kernel_mode):
    """The CFG dispatch: uncond half through flash_attention, cond half adds
    Pᵀ into acc; equal to daam_tpu's jnp path."""
    B, H, Lq, Lk, hd = 4, 2, 40, 77, 64
    q, k, v = _qkv(B, H, Lq, Lk, hd, seed=8)
    acc = torch.zeros(B // 2, H, Lk, Lq)
    ours = A.cross_attention(*map(_packed_view, (q, k, v)), capture='acc',
                             acc=acc).numpy()

    jax_kernel_mode('jnp')
    out, acc_jax = jax_attention.cross_attention(
        *map(jnp.asarray, (q, k, v)), capture='acc',
        acc=jnp.zeros(P.cross_acc_shape(B // 2, H, Lq, Lk), jnp.float32))
    np.testing.assert_allclose(ours, _merged(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_jax)[:, :, :Lk, :Lq],
                               rtol=0, atol=ATOL)


def test_finalize_acc_blocks_match_daam_tpu_layout():
    """finalize_acc: the port's per-layer accumulators give the same
    (B, L, H, T, h, w) blocks as daam_tpu's slicing of its padded ones
    (pipeline/sd.py:212-228)."""
    from daam_tpu_torch.pipeline.sd import StableDiffusionPipeline

    pipe = StableDiffusionPipeline.from_pretrained('tiny', device='cpu')
    config = get_pipeline_config('tiny')
    layout = {i.name: i for i in cross_attention_layout(config.unet)}
    spec = ((12, ('up_0_0', 'up_0_1', 'down_0_0'), (0, 1, 2)),)
    lh = lw = config.unet.sample_size
    rng = np.random.RandomState(3)
    ours_acc, jax_acc = {}, {}
    for name in spec[0][1]:
        info = layout[name]
        hw = (lh // info.downscale) * (lw // info.downscale)
        padded = np.zeros(P.cross_acc_shape(1, info.heads, hw, 77), np.float32)
        padded[:, :, :77, :hw] = rng.rand(1, info.heads, 77, hw)
        jax_acc[name] = padded
        ours_acc[name] = torch.from_numpy(padded[:, :, :77, :hw].copy())
    blocks = pipe.finalize_acc(ours_acc, spec, 1, lh, lw)
    expect = np.stack([jax_acc[n][:, :layout[n].heads, :77, :lh * lw]
                       .reshape(1, layout[n].heads, 77, lh, lw)
                       for n in spec[0][1]], axis=1)
    assert blocks[12].shape == expect.shape == (1, 3, 2, 77, lh, lw)
    np.testing.assert_array_equal(blocks[12].numpy(), expect)


def test_dispatch_cpu_takes_plain_and_cuda_mode_raises():
    """A CPU tensor takes the plain version without touching a counter; the
    'cuda' mode sends it to the kernel wrapper, which refuses it."""
    q, k, v = (_packed_view(t) for t in _qkv(1, 2, 8, 77, 16, seed=1))
    before = dict(kernels.launches)
    A.flash_attention(q, k, v)
    A.cross_attention_acc(q, k, v, torch.zeros(1, 2, 77, 8))
    assert kernels.launches == before
    try:
        A.set_kernel_mode('cuda')
        with pytest.raises(ValueError, match='CUDA tensor'):
            A.flash_attention(q, k, v)
        with pytest.raises(ValueError, match='CUDA tensor'):
            A.cross_attention_acc(q, k, v, torch.zeros(1, 2, 77, 8))
    finally:
        A.set_kernel_mode('auto')
    with pytest.raises(ValueError):
        A.set_kernel_mode('triton')


def _view_of(shape, layout, dtype=torch.bfloat16, offset=0):
    """A (B, L, H, hd) view of a flat CPU buffer, starting `offset` elements
    in: head-major, packed, or packed with the rows padded by one element."""
    B, L, H, hd = shape
    if layout == 'head_major':
        n, size, stride = B * H * L * hd, (B, H, L, hd), None
    elif layout == 'packed':
        n, size, stride = B * L * H * hd, (B, L, H, hd), None
    else:  # 'padded_rows': row stride H·hd + 1
        row = H * hd + 1
        n, size, stride = B * L * row, (B, L, H, hd), (L * row, row, hd, 1)
    flat = torch.zeros(n + offset, dtype=dtype)
    if stride is not None:
        return flat.as_strided(size, stride, offset)
    t = flat[offset:].view(size)
    return t.transpose(1, 2) if layout == 'head_major' else t


@pytest.mark.parametrize('layout, offset, ok', [
    ('head_major', 0, True), ('packed', 0, True),   # every main-path view
    ('packed', 8, True),                            # q[bc:] style offsets
    ('packed', 3, False),                           # base off 16 bytes
    ('padded_rows', 0, False)])                     # row stride 321 elements
def test_tma_view_error(layout, offset, ok):
    """The bf16 wrapper's TMA check, as a pure function of shape, strides
    and address: aligned views pass, others name what is wrong."""
    t = _view_of((2, 10, 5, 64), layout, offset=offset)
    why = kernels.tma_view_error(t.shape, t.stride(), t.data_ptr(),
                                 t.element_size())
    assert (why is None) == ok, why
    if not ok:
        assert ('aligned' in why) == (offset % 8 != 0)
        assert ('strides' in why) == (layout == 'padded_rows')


def test_tma_view_error_strides_in_bytes():
    """Strides count in bytes: 8 bf16 elements or 4 fp32 make 16 bytes."""
    shape = (1, 4, 1, 16)
    assert kernels.tma_view_error(shape, (64, 16, 16, 1), 0, 2) is None
    assert kernels.tma_view_error(shape, (64, 12, 12, 1), 0, 2) is not None
    assert kernels.tma_view_error(shape, (64, 12, 12, 1), 0, 4) is None
    assert kernels.tma_view_error(shape, (0, 16, 16, 1), 0, 2) is not None


def test_library_path_tracks_headers(tmp_path, monkeypatch):
    """Editing a .cuh under csrc/ changes the build path (so the library is
    rebuilt), as editing a .cu does; other files do not enter the hash."""
    (tmp_path / 'attention.cu').write_text('#include "hopper.cuh"\n')
    (tmp_path / 'hopper.cuh').write_text('// v1\n')
    monkeypatch.setattr(kernels, '_CSRC', tmp_path)
    first = kernels._library_path()
    assert kernels._library_path() == first
    (tmp_path / 'notes.txt').write_text('not a source')
    assert kernels._library_path() == first
    (tmp_path / 'hopper.cuh').write_text('// v2\n')
    second = kernels._library_path()
    assert second != first and second.name == 'libattention.so'
    (tmp_path / 'attention.cu').write_text('// edited\n')
    assert kernels._library_path() not in (first, second)


def test_launch_counters_include_the_tensor_core_route():
    """reset_launches zeroes every counter, those of the bf16 and the fp32
    tensor-core routes included."""
    for name in ('flash_attention_wgmma', 'cross_attention_acc_mma',
                 'cross_attention_probs_mma', 'flash_attention_tf32x3',
                 'cross_attention_acc_tf32x3'):
        kernels.launches[name] += 3
    kernels.reset_launches()
    assert set(kernels.launches) == {'flash_attention', 'flash_attention_wgmma',
                                     'flash_attention_tf32x3',
                                     'cross_attention_acc',
                                     'cross_attention_acc_mma',
                                     'cross_attention_acc_tf32x3',
                                     'cross_attention_probs',
                                     'cross_attention_probs_mma'}
    assert not any(kernels.launches.values())


@pytest.mark.parametrize('Lq', [64, 100])
@pytest.mark.parametrize('layout', ['head_major', 'packed'])
def test_cross_attention_acc_plain_matches_daam_tpu_bf16(layout, Lq):
    """K1/K4 in bf16: the plain version against daam_tpu's Pallas kernels
    (interpret mode) on the same inputs cast to bf16, two calls into one
    accumulator; Lq = 100 is not a multiple of the tensor-core kernel's
    64-query block.  Both round normalized P to bf16 before PV, in other
    summation orders: O within the bf16 gate 2e-2.  Both form P in fp32
    from the same bf16 products, so the fp32 accumulator meets the fp32
    gate 1e-5."""
    B, H, Lk, hd = 1, 2, 77, 64
    view = _head_major_view if layout == 'head_major' else _packed_view
    bf16 = lambda t: jnp.asarray(t, jnp.bfloat16)  # noqa: E731
    acc = torch.zeros(B, H, Lk, Lq)
    acc_jax = jnp.zeros(P.cross_acc_shape(B, H, Lq, Lk), jnp.float32)
    for seed in (10, 11):
        q, k, v = _qkv(B, H, Lq, Lk, hd, seed=seed)
        ours = A.cross_attention_acc(*(view(t).to(torch.bfloat16) for t in (q, k, v)),
                                     acc)
        assert ours.dtype == torch.bfloat16 and ours.shape == (B, Lq, H * hd)
        if layout == 'head_major':
            out, acc_jax = P.cross_attention_acc(*map(bf16, (q, k, v)), acc_jax)
            out = _merged(out.astype(jnp.float32))
        else:
            out, acc_jax = P.cross_attention_acc_packed(
                *(bf16(_packed(t)) for t in (q, k, v)), acc_jax, heads=H)
            out = np.asarray(out.astype(jnp.float32))
        np.testing.assert_allclose(ours.float().numpy(), out, rtol=0, atol=2e-2)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_jax)[:, :, :Lk, :Lq],
                               rtol=0, atol=ATOL)


def _views(q, k, v):
    return {n: (t.shape, t.stride(), t.data_ptr())
            for n, t in (('q', q), ('k', k), ('v', v))}


@pytest.mark.parametrize('layout, offset, ok', [
    ('head_major', 0, True), ('packed', 0, True), ('packed', 8, True),
    ('packed', 3, False), ('padded_rows', 0, False)])
def test_cross_route_error_views(layout, offset, ok):
    """The bf16 K1/K5 route copies q, k and v in 16-byte pieces: the views of
    the paths pass, a misaligned base or row stride is named."""
    q = _view_of((1, 64, 5, 64), layout, offset=offset)
    k = v = _view_of((1, 77, 5, 64), 'packed')
    for kw in ({'acc_ptr': 0}, {}):
        why = kernels.cross_route_error(_views(q, k, v), 64, **kw)
        assert (why is None) == ok, why
        if not ok:
            assert why.startswith('q: ')


@pytest.mark.parametrize('layout, offset, ok', [
    ('head_major', 0, True), ('packed', 0, True),
    ('packed', 4, True),                            # q[bc:] style: 16 bytes in
    ('packed', 2, False),                           # base 8 bytes off 16
    ('padded_rows', 0, False)])                     # row stride 321 floats
def test_fp32_views_of_the_tensor_core_routes(layout, offset, ok):
    """fp32 K1 and K2 copy q, k and v in 16-byte pieces too: 4 floats make
    16 bytes, so the views of the paths pass and a misaligned base or row
    stride is named."""
    q = _view_of((1, 64, 5, 64), layout, torch.float32, offset=offset)
    k = _view_of((1, 77, 5, 64), 'packed', torch.float32)
    why = kernels.tma_view_error(q.shape, q.stride(), q.data_ptr(), 4)
    assert (why is None) == ok, why
    why = kernels.cross_route_error(_views(q, k, k), 64, acc_ptr=0, itemsize=4)
    assert (why is None) == ok, why
    if not ok:
        assert why.startswith('q: ')


def test_cross_route_error_accumulator():
    """acc moves in 16-byte pieces: an aligned base and Lq % 4 == 0; P has
    no such rule."""
    q = _view_of((1, 64, 5, 64), 'packed')
    k = _view_of((1, 77, 5, 64), 'packed')
    views = _views(q, k, k)
    assert kernels.cross_route_error(views, 64, acc_ptr=4096) is None
    assert 'aligned' in kernels.cross_route_error(views, 64, acc_ptr=4100)
    assert 'Lq % 4' in kernels.cross_route_error(views, 62, acc_ptr=4096)
    assert kernels.cross_route_error(views, 62) is None
