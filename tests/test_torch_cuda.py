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
    with pytest.raises(ValueError, match='TMA'):
        padded = torch.zeros(B, Lq, H * hd + 8, device=cuda_device,
                             dtype=torch.bfloat16)[..., 1:H * hd + 1]
        kernels.flash_attention(padded.unflatten(-1, (H, hd)), kb, vb)

    # bf16 K1 and K5 on the tensor cores, at this head dim, both layouts,
    # two calls into one accumulator, P in both types with cond_only; a block
    # holds q, k, v and its fp32 P span in 227 KB, which 256 keys fit at
    # every head dim
    lk_mma = min(Lk, 256)
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
@pytest.mark.parametrize('Lk', [77, 13])
@pytest.mark.parametrize('probs_dtype', [torch.float32, torch.bfloat16])
def test_cross_attention_probs_kernel_matches_plain_on_card(hd, Lk, probs_dtype,
                                                            cuda_device):
    """fp32 K5 (CUDA cores), P in either type, with and without cond_only."""
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
    assert kernels.launches['cross_attention_probs_mma'] == n['cross_attention_probs_mma']
