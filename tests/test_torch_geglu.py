"""The feed-forward's GEGLU gate: its dispatch on the CPU, against daam_tpu.

``ops.geglu.geglu`` takes the plain chain for a CPU tensor and the kernel of
``csrc/geglu.cu`` for a CUDA one; the kernel itself runs on the CPU emulator
(``tests/test_torch_kernel_emulation.py``) and on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from daam_tpu_torch.models.unet import FeedForward
from daam_tpu_torch.ops import geglu as G
from daam_tpu_torch.ops import kernels


def _x(rows, w, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(2 * rng.randn(rows, 2 * w).astype(np.float32)).to(dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_geglu_on_cpu_is_the_chain(dtype):
    """A CPU tensor takes the plain chain: the feed-forward's former line,
    bit for bit, and no kernel launch."""
    x = _x(33, 40, dtype)
    n = dict(kernels.launches)
    h, gate = x.chunk(2, dim=-1)
    assert torch.equal(G.geglu(x), h * F.gelu(gate.float()).to(h.dtype))
    assert torch.equal(G.geglu(x), G.geglu_plain(x))
    assert dict(kernels.launches) == n


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_geglu_plain_matches_daam_tpu(dtype):
    """The plain chain against daam_tpu's ``FeedForward`` gate, on the same
    inputs: fp32 within the model tests' 1e-4 relative, bf16 within one
    bf16 ulp at |h|·max(|g|, 1) (the two frameworks' fp32 erf differ in
    their last bits, which may round the bf16 GELU the other way)."""
    x = _x(17, 24, dtype, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x.float().numpy(), jdt)
    h, gate = jnp.split(xj, 2, axis=-1)
    theirs = h * jax.nn.gelu(gate.astype(jnp.float32), approximate=False).astype(h.dtype)
    theirs = torch.from_numpy(np.array(theirs.astype(jnp.float32)))
    ours = G.geglu_plain(x).float()
    if dtype == torch.float32:
        torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-5)
    else:
        w = x.shape[1] // 2
        scale = x[:, :w].float().abs() * x[:, w:].float().abs().clamp_min(1)
        assert ((ours - theirs).abs() <= scale * 2 ** -7).all()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_feed_forward_routes_through_geglu(dtype):
    """``FeedForward`` is ``net.2(geglu(net.0.proj(x)))``: on the CPU the
    former chain, bit for bit."""
    torch.manual_seed(0)
    ff = FeedForward(8).to(dtype)
    x = torch.randn(2, 5, 8).to(dtype)
    with torch.no_grad():
        h, gate = ff.net[0].proj(x).chunk(2, dim=-1)
        want = ff.net[2](h * F.gelu(gate.float()).to(h.dtype))
        assert torch.equal(ff(x), want)


@pytest.mark.parametrize('make, match', [
    (lambda: _x(4, 8, torch.float16), 'dtype'),
    (lambda: _x(4, 16, torch.float32)[:, :16], 'contiguous'),
    (lambda: torch.zeros(4, 7), r'\(\.\.\., 2w\)'),
    (lambda: torch.zeros(0, 8), r'\(\.\.\., 2w\)'),
    (lambda: _x(4, 8, torch.bfloat16), 'CUDA tensor')])
def test_geglu_kernel_refuses_what_it_cannot_take(make, match):
    """The launcher raises before it loads or launches anything: a dtype
    other than fp32 or bf16, a strided input, an odd or empty last axis, a
    tensor off the card."""
    n = dict(kernels.launches)
    with pytest.raises(ValueError, match=match):
        kernels.geglu(make())
    assert dict(kernels.launches) == n
