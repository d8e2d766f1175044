"""The hand-written kernels against their plain versions, on a CUDA card.

This file imports torch, numpy and ``daam_tpu_torch`` only, and needs
nothing from ``tests/conftest.py`` (which imports JAX), so it runs on a GPU
machine without JAX:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

``chip_smoke.py`` runs it so.  Every case carries the ``cuda`` marker and
skips without a card, as in the CPU test run.  Gates as in ``chip_smoke.py``
phase 2, with TF32 off for the plain side: fp32 outputs within 1e-4, the
accumulator and fp32 P within 1e-5, bf16 outputs within 2e-2, bf16 P within
1/128.
"""

import numpy as np
import pytest
import torch

from daam_tpu_torch.ops import attention as A
from daam_tpu_torch.ops import kernels


def _qkv(B, H, Lq, Lk, hd, seed):
    """Head-major (B, H, L, hd) fp32 inputs from a numpy seed."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Lq, hd).astype(np.float32),
            rng.randn(B, H, Lk, hd).astype(np.float32),
            rng.randn(B, H, Lk, hd).astype(np.float32))


def _head_major_view(x: np.ndarray) -> torch.Tensor:
    """(B, H, L, hd) array → (B, L, H, hd) strided view (no copy)."""
    return torch.from_numpy(x).transpose(1, 2)


def _packed_view(x: np.ndarray) -> torch.Tensor:
    """(B, H, L, hd) array → (B, L, H, hd) view of its (B, L, H·hd) layout."""
    B, H, L, hd = x.shape
    packed = np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B, L, H * hd))
    return torch.from_numpy(packed).unflatten(-1, (H, hd))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc (the kernels run only there)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('hd', kernels.HEAD_DIMS)
@pytest.mark.parametrize('Lk', [77, 600])
def test_kernels_match_plain_on_card(hd, Lk, cuda_device):
    B, H, Lq = 2, 3, 100
    # fp32: K2 and K1 on the tensor cores in 3xTF32, both layouts; K1 at any
    # Lk (its kernel streams 80-key chunks), two calls into one accumulator
    n = dict(kernels.launches)
    acc = torch.rand(B, H, Lk, Lq, device=cuda_device)
    acc_plain = acc.clone()
    for view in (_packed_view, _head_major_view):
        q, k, v = (view(t).to(cuda_device) for t in _qkv(B, H, Lq, Lk, hd, seed=hd))
        torch.testing.assert_close(kernels.flash_attention(q, k, v),
                                   A.flash_attention_plain(q, k, v),
                                   rtol=0, atol=1e-4)
        q1, k1, v1 = (view(t).to(cuda_device) for t in _qkv(B, H, Lq, Lk, hd, seed=hd + 2))
        out = kernels.cross_attention_acc(q1, k1, v1, acc)
        torch.testing.assert_close(
            out, A.cross_attention_acc_plain(q1, k1, v1, acc_plain), rtol=0, atol=1e-4)
    torch.testing.assert_close(acc, acc_plain, rtol=0, atol=1e-5)
    for name in ('flash_attention', 'cross_attention_acc'):
        assert kernels.launches[name] == n[name] + 2
        assert kernels.launches[name + '_tf32x3'] == n[name + '_tf32x3'] + 2
    # fp32 K2 outside the wgmma head dims runs flash_attention_tf32x3_kernel
    mma = 2 * (hd not in kernels.TF32X3_WGMMA_HEAD_DIMS)
    assert kernels.launches['flash_attention_tf32x3_mma'] == n['flash_attention_tf32x3_mma'] + mma
    assert kernels.launches['flash_attention_wgmma'] == n['flash_attention_wgmma']
    assert kernels.launches['cross_attention_acc_mma'] == n['cross_attention_acc_mma']
    # the fp32 routes copy in 16-byte pieces: a base 4 bytes off 16 raises
    padded = torch.zeros(B, Lq, H * hd + 4, device=cuda_device)[..., 1:H * hd + 1]
    with pytest.raises(ValueError, match='cp.async'):
        kernels.flash_attention(padded.unflatten(-1, (H, hd)), k, v)
    with pytest.raises(ValueError, match='tensor cores'):
        kernels.cross_attention_acc(padded.unflatten(-1, (H, hd)), k1, v1, acc)

    # bf16: K2 on the tensor cores, at this head dim, both layouts; the
    # bf16 gate is 2e-2.
    n = dict(kernels.launches)
    for view in (_packed_view, _head_major_view):
        qb, kb, vb = (view(t).to(cuda_device, torch.bfloat16)
                      for t in _qkv(B, H, Lq, Lk, hd, seed=hd + 1))
        torch.testing.assert_close(kernels.flash_attention(qb, kb, vb).float(),
                                   A.flash_attention_plain(qb, kb, vb).float(),
                                   rtol=0, atol=2e-2)
    assert kernels.launches['flash_attention'] == n['flash_attention'] + 2
    assert kernels.launches['flash_attention_wgmma'] == n['flash_attention_wgmma'] + 2
    assert kernels.launches['flash_attention_tf32x3'] == n['flash_attention_tf32x3']
    assert kernels.launches['flash_attention_tf32x3_mma'] == n['flash_attention_tf32x3_mma']
    with pytest.raises(ValueError, match='TMA'):
        padded = torch.zeros(B, Lq, H * hd + 8, device=cuda_device,
                             dtype=torch.bfloat16)[..., 1:H * hd + 1]
        kernels.flash_attention(padded.unflatten(-1, (H, hd)), kb, vb)

    # bf16 K1 and K5 on the tensor cores, at this head dim, both layouts,
    # two calls into one accumulator, P in both types with cond_only; a block
    # holds q, k, v and its fp32 P span in 227 KB, which 256 keys fit up to
    # hd 128 and 200 (three 80-key chunks) at hd 160
    lk_mma = min(Lk, 256 if hd <= 128 else 200)
    n = dict(kernels.launches)
    acc = torch.rand(B, H, lk_mma, Lq, device=cuda_device)
    acc_plain = acc.clone()
    for view in (_packed_view, _head_major_view):
        qb, kb, vb = (view(t).to(cuda_device, torch.bfloat16)
                      for t in _qkv(B, H, Lq, lk_mma, hd, seed=hd + 3))
        torch.testing.assert_close(
            kernels.cross_attention_acc(qb, kb, vb, acc).float(),
            A.cross_attention_acc_plain(qb, kb, vb, acc_plain).float(),
            rtol=0, atol=2e-2)
        for pdt, cond_only in ((torch.float32, False), (torch.bfloat16, True)):
            o, p = kernels.cross_attention_probs(qb, kb, vb, cond_only, pdt)
            ro, rp = A.cross_attention_probs_plain(qb, kb, vb, cond_only, pdt)
            rows = slice(B // 2, None) if cond_only else slice(None)
            torch.testing.assert_close(o.float(), ro.float(), rtol=0, atol=2e-2)
            torch.testing.assert_close(p[rows].float(), rp[rows].float(), rtol=0,
                                       atol=1e-5 if pdt == torch.float32 else 1 / 128)
    torch.testing.assert_close(acc, acc_plain, rtol=0, atol=1e-5)
    for name, count in (('cross_attention_acc', 2), ('cross_attention_probs', 4)):
        assert kernels.launches[name] == n[name] + count
        assert kernels.launches[name + '_mma'] == n[name + '_mma'] + count
    assert kernels.launches['cross_attention_acc_tf32x3'] == n['cross_attention_acc_tf32x3']
    with pytest.raises(ValueError, match='tensor cores'):  # Lq % 4 != 0
        kernels.cross_attention_acc(qb[:, :Lq - 2], kb, vb, torch.zeros(
            B, H, lk_mma, Lq - 2, device=cuda_device))
    # the entry point refuses a block past 227 KB of shared memory
    kl = torch.zeros(B, 4096, H, hd, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match='launch failed'):
        kernels.cross_attention_probs(qb, kl, kl)


@pytest.mark.cuda
@pytest.mark.parametrize('hd', kernels.HEAD_DIMS)
@pytest.mark.parametrize('Lk', [77, 13, 200, 600])
@pytest.mark.parametrize('probs_dtype', [torch.float32, torch.bfloat16])
def test_cross_attention_probs_kernel_matches_plain_on_card(hd, Lk, probs_dtype,
                                                            cuda_device):
    """fp32 K5 on the tensor cores in 3xTF32, P in either type, with and
    without cond_only; Lk 200 and 600 stream 80-key chunks."""
    B, H, Lq = 4, 3, 100
    q, k, v = (_packed_view(t).to(cuda_device)
               for t in _qkv(B, H, Lq, Lk, hd, seed=hd + Lk))
    n = dict(kernels.launches)
    for cond_only in (False, True):
        out, p = kernels.cross_attention_probs(q, k, v, cond_only, probs_dtype)
        ref_out, ref_p = A.cross_attention_probs_plain(q, k, v, cond_only,
                                                       probs_dtype)
        torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-4)
        rows = slice(B // 2, None) if cond_only else slice(None)
        atol = 1e-5 if probs_dtype == torch.float32 else 1 / 128
        torch.testing.assert_close(p[rows].float(), ref_p[rows].float(),
                                   rtol=0, atol=atol)
    assert kernels.launches['cross_attention_probs'] == n['cross_attention_probs'] + 2
    assert (kernels.launches['cross_attention_probs_tf32x3']
            == n['cross_attention_probs_tf32x3'] + 2)
    assert kernels.launches['cross_attention_probs_mma'] == n['cross_attention_probs_mma']
    # it copies q, k and v in 16-byte pieces: a base 4 bytes off 16 raises
    # before anything is launched
    n = dict(kernels.launches)
    padded = torch.zeros(B, Lq, H * hd + 4, device=cuda_device)[..., 1:H * hd + 1]
    with pytest.raises(ValueError, match='tensor cores'):
        kernels.cross_attention_probs(padded.unflatten(-1, (H, hd)), k, v, False,
                                      probs_dtype)
    assert kernels.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize('hd', kernels.TF32X3_WGMMA_HEAD_DIMS)
@pytest.mark.parametrize('Lk', [1, 7, 63, 65, 100, 300])
def test_fp32_flash_attention_wgmma_at_ragged_lk_on_card(hd, Lk, cuda_device):
    """fp32 K2 on its wgmma kernel at Lk that are not a multiple of its
    key tile (64 keys, 32 at hd 80 and 128), below one k8 step among them, and at
    Lq = 130 (a second 128-query block of 2 rows), both layouts."""
    B, H, Lq = 2, 3, 130
    n = kernels.launches['flash_attention_tf32x3']
    for view in (_packed_view, _head_major_view):
        q, k, v = (view(t).to(cuda_device) for t in _qkv(B, H, Lq, Lk, hd, seed=hd + Lk))
        torch.testing.assert_close(kernels.flash_attention(q, k, v),
                                   A.flash_attention_plain(q, k, v), rtol=0, atol=1e-4)
    assert kernels.launches['flash_attention_tf32x3'] == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [40, 64, 80])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernels_at_cfg_batch_8_on_card(dtype, hd, cuda_device):
    """Batch 4 of prompts, CFG batch 8: K2 on the unconditional half, K1 on
    the conditional half, a view four batch strides into the projection
    output, through ``cross_attention(capture='acc')`` and directly; K5 with
    ``cond_only`` at B = 8, rows 4–7 written.  Gates as above by dtype."""
    B, H, Lq, Lk = 8, 5, 256, 77
    bf16 = dtype == torch.bfloat16
    tol, route = (2e-2, '_mma') if bf16 else (1e-4, '_tf32x3')
    q, k, v = (_packed_view(t).to(cuda_device, dtype)
               for t in _qkv(B, H, Lq, Lk, hd, seed=hd + 8))
    assert q[B // 2:].data_ptr() == q.data_ptr() + (B // 2) * q.stride(0) * q.element_size()
    acc = torch.rand(B // 2, H, Lk, Lq, device=cuda_device)
    acc_plain = acc.clone()
    n = dict(kernels.launches)
    out = A.cross_attention(q, k, v, capture='acc', acc=acc)
    A.set_kernel_mode('torch')
    try:
        ref = A.cross_attention(q, k, v, capture='acc', acc=acc_plain)
    finally:
        A.set_kernel_mode('auto')
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(acc, acc_plain, rtol=0, atol=1e-5)
    flash_route = '_wgmma' if bf16 else '_tf32x3'
    assert kernels.launches['flash_attention' + flash_route] == \
        n['flash_attention' + flash_route] + 1
    assert kernels.launches['cross_attention_acc' + route] == \
        n['cross_attention_acc' + route] + 1
    # the halves directly, each against its plain version
    bc = B // 2
    torch.testing.assert_close(
        kernels.flash_attention(q[:bc], k[:bc], v[:bc]).float(),
        A.flash_attention_plain(q[:bc], k[:bc], v[:bc]).float(), rtol=0, atol=tol)
    acc2, acc2_plain = torch.zeros_like(acc), torch.zeros_like(acc)
    torch.testing.assert_close(
        kernels.cross_attention_acc(q[bc:], k[bc:], v[bc:], acc2).float(),
        A.cross_attention_acc_plain(q[bc:], k[bc:], v[bc:], acc2_plain).float(),
        rtol=0, atol=tol)
    torch.testing.assert_close(acc2, acc2_plain, rtol=0, atol=1e-5)
    for pdt in (torch.float32, torch.bfloat16):
        o, p = kernels.cross_attention_probs(q, k, v, True, pdt)
        ro, rp = A.cross_attention_probs_plain(q, k, v, True, pdt)
        torch.testing.assert_close(o.float(), ro.float(), rtol=0, atol=tol)
        torch.testing.assert_close(p[bc:].float(), rp[bc:].float(), rtol=0,
                                   atol=1e-5 if pdt == torch.float32 else 1 / 128)
    assert kernels.launches['cross_attention_probs' + route] == \
        n['cross_attention_probs' + route] + 2


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [8, 48, 96, 256])
def test_head_dims_without_kernels_raise_on_card(hd, cuda_device):
    """A head dim outside HEAD_DIMS raises before anything is launched, in
    both dtypes and for each kernel; nothing falls back to the plain version."""
    n = dict(kernels.launches)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_packed_view(t).to(cuda_device, dtype)
                   for t in _qkv(2, 2, 64, 77, hd, seed=hd))
        acc = torch.zeros(2, 2, 77, 64, device=cuda_device)
        for call in (lambda: kernels.flash_attention(q, k, v),
                     lambda: kernels.cross_attention_acc(q, k, v, acc),
                     lambda: kernels.cross_attention_probs(q, k, v)):
            with pytest.raises(ValueError, match=f'head dim {hd} not in'):
                call()
    assert kernels.launches == n


def _write_safetensors(path, tensors):
    """The format by hand (the card's machine need not have the package):
    8-byte little-endian header length, JSON header, raw bytes."""
    import json
    import struct

    names = {torch.float16: 'F16', torch.bfloat16: 'BF16', torch.float32: 'F32'}
    header, offset = {'__metadata__': {'format': 'pt'}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {'dtype': names[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b' ' * (-len(raw) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(raw)) + raw)
        for t in tensors.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy().data)


@pytest.mark.cuda
def test_safetensors_reader_on_a_2gb_file_on_card(tmp_path, cuda_device):
    """Offsets past 2**31: a 2.2 GB fp16 tensor, then a bf16 and an fp32
    one behind it, read through the memory map and moved to the card."""
    from daam_tpu_torch.models.weights import read_safetensors

    g = torch.Generator().manual_seed(0)
    big = torch.zeros(1_100_000_000, dtype=torch.float16)
    big[::4099] = torch.randn(big[::4099].shape, generator=g).half()
    tensors = {'big': big, 'after.bf16': torch.randn(3, 5, generator=g).bfloat16(),
               'after.f32': torch.randn(7, generator=g)}
    path = tmp_path / 'large.safetensors'
    _write_safetensors(path, tensors)
    assert path.stat().st_size > 2 ** 31
    got = read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
        assert torch.equal(got[name].to(cuda_device), t.to(cuda_device)), name
    del got
    path.unlink()


def _masks(n, h, w, seed):
    rng = np.random.RandomState(seed)
    out = np.zeros((n, h, w), np.float32)
    for m in out:
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        m[y0:y0 + rng.randint(h // 8, h // 2), x0:x0 + rng.randint(w // 8, w // 2)] = 1
        flip = rng.rand(h, w) < 0.02
        m[flip] = 1 - m[flip]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('pred_hw,truth_hw', [((512, 512), (512, 512)),
                                              ((64, 64), (512, 512)),
                                              ((512, 512), (480, 640))])
def test_evaluation_on_card_matches_cpu(pred_hw, truth_hw, cuda_device):
    """The same binarized pixels and IoU/IoA on the card as on the CPU,
    whatever the global TF32 setting (restored after the call)."""
    from daam_tpu_torch import evaluate as E

    p, t = _masks(5, *pred_hw, seed=1), _masks(3, *truth_hw, seed=2)
    cpu = E._binarize_resize(torch.from_numpy(p), truth_hw)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = E._binarize_resize(torch.from_numpy(p).to(cuda_device), truth_hw)
        assert torch.equal(card.cpu(), cpu)
        for fn in (E.iou_matrix, E.ioa_matrix):
            a, b = fn(p, t, device=cuda_device), fn(p, t, device='cpu')
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            assert a.max() > 0
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _png_pixels(path) -> np.ndarray:
    import PIL.Image

    with PIL.Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


@pytest.mark.cuda
def test_overlays_on_card_match_the_host_route(tmp_path, cuda_device, monkeypatch):
    """Every word of one SD 2.1 512² experiment, drawn on the card
    (``csrc/overlay.cu``) and on the host where matplotlib is absent: pixels
    within one level on at most 0.5% of a PNG's pixels (the limits of
    ``tests/test_torch_kernel_emulation.py``), ``output.png`` equal, the
    card's files within 1% of Pillow's size for the same pixels, one
    ``overlay_resample`` a word and one ``png_scanlines`` a PNG on the card,
    and no launch on the host's pass."""
    import io
    import sys

    import PIL.Image

    from daam_tpu_torch import StableDiffusionPipeline, trace
    from daam_tpu_torch.experiment import GenerationExperiment

    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    pipe = StableDiffusionPipeline.from_pretrained('v2-1-base', device=cuda_device)
    with trace(pipe) as tc:
        out = pipe('A dog runs across the field .', num_inference_steps=2,
                   generator=torch.Generator(device=cuda_device).manual_seed(0))
        card = tc.to_experiment(tmp_path / 'card')
    card.image = out.images[0]
    host = GenerationExperiment(card.image, card.global_heat_map, card.prompt,
                                path=tmp_path / 'host', tokenizer=card.tokenizer)
    launched = dict(kernels.launches)
    card.save(heat_maps=False)
    card_paths = card.save_all_heat_maps()
    mid = dict(kernels.launches)
    host.save(heat_maps=False)
    host_paths = host.save_all_heat_maps()
    words = sorted(card_paths)
    assert words and words == sorted(host_paths)
    assert mid['overlay_resample'] - launched['overlay_resample'] == len(words)
    assert mid['png_scanlines'] - launched['png_scanlines'] == len(words) + 1
    assert dict(kernels.launches) == mid
    pairs = [(card_paths[w], host_paths[w]) for w in words]
    for ours, theirs in pairs + [(card.path / 'output.png', host.path / 'output.png')]:
        a, b = _png_pixels(ours), _png_pixels(theirs)
        diff = np.abs(a.astype(np.int16) - b).max(-1)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, (ours.name, diff.max(),
                                                                (diff > 0).mean())
        buf = io.BytesIO()
        PIL.Image.fromarray(a).save(buf, format='PNG')
        assert abs(ours.stat().st_size - len(buf.getvalue())) <= 0.01 * len(buf.getvalue())
    np.testing.assert_array_equal(_png_pixels(card.path / 'output.png'), np.asarray(card.image))


def _idat_rows(path) -> bytes:
    """A PNG file's IDAT, inflated."""
    import struct
    import zlib

    data, pos, idat = path.read_bytes(), 8, b''
    while pos < len(data):
        n, = struct.unpack('>I', data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b'IDAT':
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return zlib.decompress(idat)


@pytest.mark.cuda
def test_cli_pngs_on_card_deflate_in_stripes(tmp_path, cuda_device, monkeypatch):
    """A 512² ``daam-torch`` request's PNGs (``output.png`` and every
    word's), written on the card's route with the configurations' two
    PyTorch threads: one ``png_scanlines`` a PNG, each deflated in two
    stripes (``write_png`` returns them), as against one stream on one
    thread.  Each file inflates to the rows of the same experiment written
    with one thread, reads back to its pixels, and is no more than 0.1%
    over it."""
    import sys

    from daam_tpu_torch import StableDiffusionPipeline, png, trace

    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    taken, write_png = [], png.write_png

    def recording_write_png(*args):
        taken.append(write_png(*args))
        return taken[-1]
    monkeypatch.setattr(png, 'write_png', recording_write_png)
    pipe = StableDiffusionPipeline.from_pretrained('v2-1-base', device=cuda_device)
    with trace(pipe) as tc:
        out = pipe('A dog runs across the field .', num_inference_steps=2,
                   generator=torch.Generator(device=cuda_device).manual_seed(0))
        exps = {n: tc.to_experiment(tmp_path / str(n)) for n in (1, 2)}
    saved = torch.get_num_threads()
    written = {}
    try:
        for n, exp in exps.items():
            exp.image = out.images[0]
            torch.set_num_threads(n)
            taken.clear()
            launched = kernels.launches['png_scanlines']
            exp.save(heat_maps=False)
            paths = exp.save_all_heat_maps()
            written[n] = {'output.png': exp.path / 'output.png', **paths}
            assert paths and taken == [n] * (len(paths) + 1)
            assert kernels.launches['png_scanlines'] - launched == len(paths) + 1
    finally:
        torch.set_num_threads(saved)
    assert sorted(written[1]) == sorted(written[2])
    for name, one in written[1].items():
        striped = written[2][name]
        assert _idat_rows(striped) == _idat_rows(one), name
        np.testing.assert_array_equal(_png_pixels(striped), _png_pixels(one))
        assert striped.stat().st_size <= 1.001 * one.stat().st_size, name
    np.testing.assert_array_equal(_png_pixels(written[2]['output.png']),
                                  np.asarray(out.images[0]))


@pytest.mark.cuda
def test_v2_1_large_request_states_its_route_on_card(cuda_device):
    """A 2-step traced request of ``v2-1-large`` (768², v-prediction): the
    ``call`` span states v-prediction and the 96² heat-map grid, the
    ``decode`` span an untiled decode of the 96² latent; with spans off
    nothing is recorded."""
    from daam_tpu_torch import StableDiffusionPipeline, profiling, trace

    pipe = StableDiffusionPipeline.from_pretrained('v2-1-large', device=cuda_device)

    def request():
        with trace(pipe):
            pipe('A dog runs across the field .', num_inference_steps=2, output_type='np',
                 generator=torch.Generator(device=cuda_device).manual_seed(0))

    profiling.clear()
    profiling.enable()
    try:
        request()
    finally:
        profiling.disable()
    records = profiling.spans()
    profiling.clear()
    request()
    assert profiling.spans() == []
    call = [r for r in records if r.name == 'call']
    decode = [r for r in records if r.name == 'decode']
    assert len(call) == 1 and len(decode) == 1 and decode[0].parent == call[0].id
    assert call[0].attrs['v_prediction'] == 1 and call[0].attrs['grid'] == 96
    assert decode[0].attrs == {'tiled': 0, 'latent': 96}


@pytest.mark.cuda
@pytest.mark.parametrize('preset,dtype,scheduler', [('tiny', torch.float32, 'ddim'),
                                                    ('tiny-xl', torch.bfloat16, 'ddim'),
                                                    ('tiny-v1', torch.float32, 'pndm')])
def test_unet_graph_replays_equal_eager_on_card(preset, dtype, scheduler, cuda_device,
                                                monkeypatch):
    """Traced requests of 4 steps (E UNet evaluations: 4, PNDM's 5) whose
    evaluations replay CUDA graphs against the same requests run eager (the
    lease held by the test): every evaluation's ``eps`` and accumulators,
    the images, the blocks and the ``time_chunk_steps`` snapshots bit for
    bit, the launch counts equal; ``unet_graph`` counts one capture, E - 2
    replays and one eager evaluation in the first request, E replays in the
    next, and that next request leaves the first's blocks as they were.
    ``tiny-v1`` runs under PNDM, whose history the step carries between
    replays, with its second level widened to 320 channels, so that the mid
    block's hd 160 takes fp32 K2's mma.sync route
    (``flash_attention_tf32x3_mma``) beside hd 16 on wgmma."""
    from dataclasses import replace

    from daam_tpu_torch import StableDiffusionPipeline, trace
    from daam_tpu_torch.models import configs
    from daam_tpu_torch.models.unet import FeedForward
    from daam_tpu_torch.pipeline import unet_graph

    N = 4
    if preset == 'tiny-v1':
        base = configs.MODEL_PRESETS[preset]
        monkeypatch.setitem(configs.MODEL_PRESETS, preset, replace(
            base, unet=replace(base.unet, block_out_channels=(32, 320))))
    pipe = StableDiffusionPipeline.from_pretrained(preset, device=cuda_device, dtype=dtype,
                                                   scheduler=scheduler)
    E = pipe.scheduler.num_scan_steps(N)
    evals = []
    call = unet_graph._Request.__call__

    def recording(self, *args, **kwargs):
        eps = call(self, *args, **kwargs)
        evals.append((eps.clone(), {n: a.clone() for n, a in (kwargs['acc'] or {}).items()},
                      self.graph))
        return eps

    monkeypatch.setattr(unet_graph._Request, '__call__', recording)

    def request(prompt, time_chunk_steps=None, eager=False):
        evals.clear()
        launches, counts = dict(kernels.launches), dict(unet_graph.counts)
        lease = pipe.unet_graphs._lease
        if eager:
            lease.acquire()
        try:
            with trace(pipe, time_chunk_steps=time_chunk_steps) as tc:
                out = pipe(prompt, num_inference_steps=N, output_type='np',
                           generator=torch.Generator(device=cuda_device).manual_seed(0))
        finally:
            if eager:
                lease.release()
        torch.cuda.synchronize()
        return {'image': out.images[0], 'blocks': dict(tc.batch_heat_maps),
                'snaps': [dict(b) for b in tc.time_blocks], 'evals': list(evals),
                'launches': {k: n - launches[k] for k, n in kernels.launches.items()},
                'counts': {k: n - counts[k] for k, n in unet_graph.counts.items()}}

    def assert_equal(run, ref):
        assert (run['image'] == ref['image']).all()
        assert run['launches'] == ref['launches'] and ref['launches']['cross_attention_acc'] > 0
        for f, block in ref['blocks'].items():
            assert torch.equal(run['blocks'][f], block)
        assert len(run['snaps']) == len(ref['snaps'])
        for a, b in zip(run['snaps'], ref['snaps']):
            assert all(torch.equal(a[f], b[f]) for f in b)
        assert len(run['evals']) == len(ref['evals']) == E
        for (eps, accs, _), (eps_ref, accs_ref, _) in zip(run['evals'], ref['evals']):
            assert torch.equal(eps, eps_ref)
            assert accs.keys() == accs_ref.keys() and len(accs) > 0
            assert all(torch.equal(accs[n], accs_ref[n]) for n in accs)

    first, second = 'A dog runs across the field .', 'A red cat sleeps on a bed .'
    eager = {p: request(p, eager=True) for p in (first, second)}
    feed_forwards = sum(isinstance(m, FeedForward) for m in pipe.unet.modules())
    for run in eager.values():
        assert run['counts'] == {'captures': 0, 'replays': 0, 'eager': E}
        # one GEGLU kernel a transformer block's feed-forward an evaluation;
        # the replays below add what their capture recorded (assert_equal)
        assert run['launches']['geglu'] == feed_forwards * E > 0
        assert [g for *_, g in run['evals']] == [0] * E
    if preset == 'tiny-v1':  # the mid block's self- and cross-attention at hd 160
        assert eager[first]['launches']['flash_attention_tf32x3_mma'] == 2 * E
    one = request(first)
    assert one['counts'] == {'captures': 1, 'replays': E - 2, 'eager': 1}
    assert [g for *_, g in one['evals']] == [0] + [1] * (E - 1)
    assert_equal(one, eager[first])
    two = request(second)
    assert two['counts'] == {'captures': 0, 'replays': E, 'eager': 0}
    assert [g for *_, g in two['evals']] == [1] * E
    assert_equal(two, eager[second])
    assert not any(torch.equal(two['blocks'][f], b) for f, b in one['blocks'].items())
    for f, block in eager[first]['blocks'].items():  # the first request's blocks held
        assert torch.equal(one['blocks'][f], block)
    snaps = request(first, time_chunk_steps=2)
    assert snaps['counts'] == {'captures': 0, 'replays': E, 'eager': 0}
    assert_equal(snaps, request(first, time_chunk_steps=2, eager=True))
    assert len(snaps['snaps']) == -(-E // 2)
    assert len(pipe.unet_graphs.entries) == 1


# (rows, w) of the feed-forward's gate: SDXL's at 64² and 32² (CFG rows
# 8,192 and 2,048), SD 2.1-512's three levels, and ragged ones (w not a
# multiple of a 16-byte chunk: one element a step)
GEGLU_SHAPES = [(8192, 2560), (2048, 5120), (8192, 1280), (2048, 2560), (512, 5120),
                (37, 52), (1000, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', GEGLU_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_geglu_kernel_equals_the_chain_on_card(dtype, shape, cuda_device):
    """``kernels.geglu`` against the feed-forward's former line, ``h *
    F.gelu(gate.float()).to(h.dtype)`` on the card: bit for bit (the same
    float GELU, term for term, and the same two roundings), and again from a
    base off 16 bytes, which takes the kernel one element at a time; one
    launch counted a call."""
    from daam_tpu_torch.ops.geglu import geglu_plain

    rows, w = shape
    g = torch.Generator(device=cuda_device).manual_seed(rows + w)
    x = torch.randn(rows, 2 * w, device=cuda_device, generator=g)
    x[:, w:] *= 2.5  # gates out to the GELU's flat negative tail
    x = x.to(dtype)
    n = kernels.launches['geglu']
    out = kernels.geglu(x)
    assert out.dtype == dtype and out.shape == (rows, w) and out.is_contiguous()
    assert torch.equal(out, geglu_plain(x))
    off = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)[1:].view_as(x)
    off.copy_(x)
    assert off.data_ptr() % 16
    assert torch.equal(kernels.geglu(off), out)
    assert kernels.launches['geglu'] == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_feed_forward_takes_the_geglu_kernel_on_card(dtype, cuda_device):
    """An SDXL-shaped ``FeedForward`` (dim 640 at 64², CFG batch 2) gives
    the same output through the kernel as through the former chain, and
    counts one ``geglu`` launch a call."""
    import torch.nn.functional as F

    from daam_tpu_torch.models.unet import FeedForward

    torch.manual_seed(0)
    ff = FeedForward(640).to(cuda_device, dtype)
    x = torch.randn(2, 4096, 640, device=cuda_device).to(dtype)
    n = kernels.launches['geglu']
    with torch.no_grad():
        out = ff(x)
        assert kernels.launches['geglu'] == n + 1
        h, gate = ff.net[0].proj(x).chunk(2, dim=-1)
        want = ff.net[2](h * F.gelu(gate.float()).to(h.dtype))
    assert torch.equal(out, want)
