"""Build and launch the hand-written CUDA kernels of ``csrc/attention.cu``,
``csrc/overlay.cu`` and ``csrc/geglu.cu``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under
``build/daam_tpu_torch/<hash of the sources, headers and flags>/libattention.so``
in the checkout, and bound with :mod:`ctypes`.  Nothing here touches CUDA at
import time, so CPU-only hosts import the module freely; the launchers raise
on a tensor that is not on a CUDA device.

Each launcher checks device, dtype, shape and strides, allocates its output
with ``torch.empty``, launches on PyTorch's current stream without
synchronizing, raises if the launch reported a CUDA error, and then adds one
to its count in :data:`launches` (the proof that a run went through the
kernel).  The plain PyTorch versions of the same functions live in
:mod:`daam_tpu_torch.ops.attention` and :mod:`daam_tpu_torch.ops.geglu`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from .. import profiling

__all__ = ['flash_attention', 'cross_attention_acc', 'cross_attention_probs',
           'overlay_resample', 'png_scanlines', 'geglu', 'launches', 'reset_launches',
           'load_library', 'tma_view_error', 'cross_route_error', 'HEAD_DIMS',
           'TF32X3_WGMMA_HEAD_DIMS']

_CSRC = Path(__file__).resolve().parents[1] / 'csrc'
_BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'daam_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
HEAD_DIMS = (16, 32, 40, 64, 80, 128, 160)
#: The head dims at which fp32 :func:`flash_attention` runs
#: ``flash_attention_tf32x3_wgmma_kernel`` (``wgmma_tf32x3_serves`` in
#: ``csrc/attention.cu``); the others run ``flash_attention_tf32x3_kernel``.
TF32X3_WGMMA_HEAD_DIMS = (16, 32, 40, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1

#: Kernel launches since the last :func:`reset_launches`, by launcher name:
#: the ``launches`` group of the program's counters
#: (:func:`daam_tpu_torch.profiling.counters`).
#: ``flash_attention_wgmma``, ``cross_attention_acc_mma`` and
#: ``cross_attention_probs_mma`` count the launches of the bf16 routes,
#: ``flash_attention_tf32x3``, ``cross_attention_acc_tf32x3`` and
#: ``cross_attention_probs_tf32x3`` those of the fp32 routes (all on the
#: tensor cores); the launcher's own total counts them too.
#: ``flash_attention_tf32x3_mma`` counts the fp32 ``flash_attention`` calls
#: that run ``flash_attention_tf32x3_kernel`` (the head dims outside
#: :data:`TF32X3_WGMMA_HEAD_DIMS`), which ``flash_attention_tf32x3`` counts
#: too.
#: ``overlay_resample`` and ``png_scanlines`` count the overlay kernels of
#: ``csrc/overlay.cu``: one of each an overlay drawn on the card, and one
#: ``png_scanlines`` an image written as it is.  ``geglu`` counts the
#: feed-forward gates of ``csrc/geglu.cu``: one a transformer block's
#: feed-forward on the card.
launches = profiling.counter_group('launches', (
    'flash_attention', 'flash_attention_wgmma', 'flash_attention_tf32x3',
    'flash_attention_tf32x3_mma',
    'cross_attention_acc', 'cross_attention_acc_mma', 'cross_attention_acc_tf32x3',
    'cross_attention_probs', 'cross_attention_probs_mma', 'cross_attention_probs_tf32x3',
    'overlay_resample', 'png_scanlines', 'geglu'))

_lib: Optional[ctypes.CDLL] = None
#: Seconds the first :func:`load_library` spent building and loading.
build_seconds: Optional[float] = None
#: ``nvcc`` output of the build of the loaded library (``-Xptxas -v``:
#: registers and spills per kernel), kept beside it as ``build.log``.
build_log: str = ''


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library_path() -> Path:
    """Build path keyed by the flags and every source and header."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted([*_CSRC.glob('*.cu'), *_CSRC.glob('*.cuh')]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_ROOT / digest.hexdigest()[:16] / 'libattention.so'


def _build(out: Path) -> str:
    nvcc = shutil.which('nvcc') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp),
           *(str(s) for s in sorted(_CSRC.glob('*.cu')))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{proc.stderr}')
    log = proc.stdout + proc.stderr
    tmp_log = out.with_name(f'build.log.{os.getpid()}.tmp')
    tmp_log.write_text(log)
    # atomic: a concurrent build never sees half a file
    os.replace(tmp_log, out.parent / 'build.log')
    os.replace(tmp, out)
    return log


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    path = _library_path()
    if not path.exists():
        build_log = _build(path)
    else:
        log = path.parent / 'build.log'
        build_log = log.read_text() if log.exists() else ''
    lib = ctypes.CDLL(str(path))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    common = [i, i, ptr, ptr, ptr, ptr]  # device, hd, q, k, v, o
    dims = [i] * 4 + [i] * 9 + [ctypes.c_float, ptr]
    for fn, extra in ((lib.daam_flash_attention_tf32x3, [ptr]),
                      (lib.daam_flash_attention_wgmma, []),
                      (lib.daam_cross_attention_acc_tf32x3, [ptr]),
                      (lib.daam_cross_attention_acc_mma, [ptr]),
                      (lib.daam_cross_attention_probs_tf32x3, [ptr, i, i]),
                      (lib.daam_cross_attention_probs_mma, [ptr, i, i])):
        fn.argtypes = common + extra + dims
        fn.restype = i
    lib.daam_flash_attention_tf32x3_scratch.argtypes = [i] * 4
    lib.daam_flash_attention_tf32x3_scratch.restype = ctypes.c_longlong
    lib.daam_overlay_scratch_floats.argtypes = [i, i]
    lib.daam_overlay_scratch_floats.restype = ctypes.c_longlong
    lib.daam_overlay_resample.argtypes = [i, ptr, i, i, i, i, ptr, ptr]
    lib.daam_overlay_resample.restype = i
    lib.daam_png_scanlines.argtypes = [i, ptr, ptr, ptr] + [i] * 4 + [ptr, ptr]
    lib.daam_png_scanlines.restype = i
    lib.daam_geglu.argtypes = [i, i, ptr, ptr, i, i, ptr]
    lib.daam_geglu.restype = i
    lib.daam_error_string.argtypes = [i]
    lib.daam_error_string.restype = ctypes.c_char_p
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Validate (B, L, H, hd) views; returns (B, Lq, Lk, H, hd)."""
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
        if t.dim() != 4:
            raise ValueError(f'{name} must be a (B, L, H, hd) view, '
                             f'got shape {tuple(t.shape)}')
        if t.stride(3) != 1:
            raise ValueError(f'{name}: the head dim must be contiguous, '
                             f'strides {t.stride()}')
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f'{name}: dtype {t.dtype} not supported')
        if max(t.stride()) > _INT_MAX:
            raise ValueError(f'{name}: strides {t.stride()} exceed int32')
    if not (q.device == k.device == v.device):
        raise ValueError('q, k and v must be on one device')
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f'dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}')
    B, Lq, H, hd = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, hd) or v.shape != k.shape:
        raise ValueError(f'k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do '
                         f'not match q {tuple(q.shape)}')
    if hd not in HEAD_DIMS:
        raise ValueError(f'head dim {hd} not in {HEAD_DIMS}')
    if min(B, Lq, Lk, H) < 1 or B * Lq * H * hd > _INT_MAX:
        raise ValueError(f'unsupported sizes B={B} Lq={Lq} Lk={Lk} H={H}')
    return B, Lq, Lk, H, hd


def tma_view_error(shape, strides, data_ptr: int,
                   itemsize: int) -> Optional[str]:
    """Why a (B, L, H, hd) view cannot be a TMA or 16-byte cp.async source,
    or None if it can.

    Both need a 16-byte-aligned base and b, l, h strides that are positive
    multiples of 16 bytes (the hd stride is 1).  Pure: shapes, strides in
    elements and the address as integers.
    """
    if data_ptr % 16:
        return f'base address {data_ptr:#x} is not 16-byte aligned'
    if any(s <= 0 or (s * itemsize) % 16 for s in strides[:3]):
        return (f'strides {tuple(strides)} of shape {tuple(shape)}: b, l and '
                f'h strides must be positive multiples of 16 bytes')
    return None


def cross_route_error(views, Lq: int, acc_ptr=None,
                      itemsize: int = 2) -> Optional[str]:
    """Why a ``cross_attention_acc`` kernel (``acc_ptr`` given) or a
    ``cross_attention_probs`` kernel, bf16 or fp32 (``itemsize`` 4), cannot
    take these operands, or None.

    ``views``: ``{name: (shape, strides, data_ptr)}`` of the q, k and v
    views, which the kernels copy in 16-byte pieces (the conditions of
    :func:`tma_view_error`).  The accumulator tile moves in 16-byte pieces
    too: acc's base must be 16-byte aligned and Lq a multiple of 4.  Pure:
    shapes, strides and addresses as integers.  (An Lk whose block does not
    fit in shared memory is refused by the bf16 kernels' entry point, and
    the launch raises; the fp32 kernels stream long Lk through.)
    """
    for name, (shape, strides, ptr) in views.items():
        why = tma_view_error(shape, strides, ptr, itemsize)
        if why:
            return f'{name}: {why}'
    if acc_ptr is not None:
        if acc_ptr % 16:
            return f'acc base address {acc_ptr:#x} is not 16-byte aligned'
        if Lq % 4:
            return f'Lq={Lq}: the accumulator tile needs Lq % 4 == 0'
    return None


def _route_check(name, q, k, v, Lq, **kw):
    why = cross_route_error({n: (t.shape, t.stride(), t.data_ptr())
                             for n, t in (('q', q), ('k', k), ('v', v))},
                            Lq, itemsize=q.element_size(), **kw)
    if why:
        raise ValueError(f'{q.dtype} {name} runs on the tensor cores, which '
                         f'cannot take this call: {why}')


def _args(q, k, v):
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    return strides, ctypes.c_float(q.shape[3] ** -0.5), \
        torch.cuda.current_stream(q.device).cuda_stream


def _raise_on(err: int, name: str):
    if err:
        msg = load_library().daam_error_string(err).decode()
        raise RuntimeError(f'{name} launch failed: CUDA error {err} ({msg})')


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √hd) v on the card.

    ``q``: (B, Lq, H, hd), ``k``/``v``: (B, Lk, H, hd) views with a
    contiguous hd axis.  Returns (B, Lq, H·hd).

    The kernel is chosen by dtype; all run on the tensor cores.  bf16 takes
    ``flash_attention_wgmma_kernel`` (wgmma for both products, TMA loads).
    fp32 runs both products in 3xTF32 (each operand split into two TF32
    parts and three products taken, which keeps fp32 accuracy): at the
    head dims of :data:`TF32X3_WGMMA_HEAD_DIMS` on wgmma, as
    ``split_kv_tf32x3_kernel`` (K and V split once per call into a scratch
    tensor this wrapper allocates, V transposed) and
    ``flash_attention_tf32x3_wgmma_kernel`` (its thread 0 bulk-copies the
    split tiles into a ring of stages); at the others on
    ``flash_attention_tf32x3_kernel`` (mma.sync, cp.async loads).  Each call
    counts once on ``launches['flash_attention_tf32x3']``, and a call on
    the mma.sync route once more on ``flash_attention_tf32x3_mma``.  TMA, cp.async
    and the split's loads all read in 16-byte pieces, so every view needs a
    16-byte-aligned base and b, l, h strides that are multiples of 16 bytes
    (:func:`tma_view_error`; any other view raises).
    """
    B, Lq, Lk, H, hd = _check_qkv(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    for name, t in (('q', q), ('k', k), ('v', v)):
        why = tma_view_error(t.shape, t.stride(), t.data_ptr(), t.element_size())
        if why:
            raise ValueError(f'{name}: {q.dtype} flash_attention reads its inputs '
                             f'by {"TMA" if bf16 else "16-byte loads (cp.async)"}: '
                             f'{why}')
    o = torch.empty(B, Lq, H * hd, dtype=q.dtype, device=q.device)
    strides, scale, stream = _args(q, k, v)
    lib = load_library()
    if bf16:
        err = lib.daam_flash_attention_wgmma(
            q.device.index, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, H, Lq, Lk, *strides, scale, stream)
    else:
        # the split K/V tiles the wgmma route copies from (0 bytes on the
        # mma.sync route; -1 for a head dim without kernels, which raises)
        n = lib.daam_flash_attention_tf32x3_scratch(hd, B, H, Lk)
        scratch = (torch.empty(n, dtype=torch.uint8, device=q.device)
                   if n > 0 else None)
        err = lib.daam_flash_attention_tf32x3(
            q.device.index, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, H, Lq, Lk, *strides, scale, stream)
    _raise_on(err, 'flash_attention')
    launches['flash_attention'] += 1
    launches['flash_attention_wgmma' if bf16 else 'flash_attention_tf32x3'] += 1
    if not bf16 and n == 0:  # no split: the mma.sync route
        launches['flash_attention_tf32x3_mma'] += 1
    return o


def cross_attention_acc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
    """Cross-attention that also adds Pᵀ into ``acc`` in place.

    ``q``: (B, Lq, H, hd), ``k``/``v``: (B, Lk, H, hd) views as for
    :func:`flash_attention`; ``acc``: contiguous fp32 (B, H, Lk, Lq).
    Returns the attention output (B, Lq, H·hd).

    The kernel is chosen by dtype; both run on the tensor cores with
    16-byte copies of the operands and of the acc tile, and raise on a call
    they cannot take (:func:`cross_route_error`).  bf16 takes
    ``cross_attention_mma_kernel`` (mma.sync for both products; an Lk whose
    block passes 227 KB of shared memory fails at launch), fp32
    ``cross_attention_tf32x3_kernel`` (the same block in 3xTF32, as
    :func:`flash_attention`; it streams a long Lk through in 80-key chunks,
    so every Lk fits).
    """
    B, Lq, Lk, H, hd = _check_qkv(q, k, v)
    if acc.dtype != torch.float32 or tuple(acc.shape) != (B, H, Lk, Lq) \
            or not acc.is_contiguous() or acc.device != q.device:
        raise ValueError(f'acc must be contiguous fp32 {(B, H, Lk, Lq)} on '
                         f'{q.device}, got {acc.dtype} {tuple(acc.shape)} '
                         f'on {acc.device}')
    bf16 = q.dtype == torch.bfloat16
    _route_check('cross_attention_acc', q, k, v, Lq, acc_ptr=acc.data_ptr())
    o = torch.empty(B, Lq, H * hd, dtype=q.dtype, device=q.device)
    strides, scale, stream = _args(q, k, v)
    lib = load_library()
    launch = (lib.daam_cross_attention_acc_mma if bf16
              else lib.daam_cross_attention_acc_tf32x3)
    err = launch(q.device.index, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), acc.data_ptr(), B, H, Lq, Lk, *strides, scale,
                 stream)
    _raise_on(err, 'cross_attention_acc')
    launches['cross_attention_acc'] += 1
    launches['cross_attention_acc_mma' if bf16 else 'cross_attention_acc_tf32x3'] += 1
    return o


def cross_attention_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cond_only: bool = False,
                          probs_dtype: torch.dtype = torch.float32):
    """Cross-attention that also writes its probabilities out.

    ``q``: (B, Lq, H, hd), ``k``/``v``: (B, Lk, H, hd) views as for
    :func:`flash_attention`.  Returns ``(o, p)``: the output (B, Lq, H·hd)
    and P (B, H, Lq, Lk) in ``probs_dtype`` (float32 or bfloat16).  With
    ``cond_only`` (CFG layout ``[uncond; cond]``) the rows of the first B/2
    samples of P are left unwritten.

    The kernel is chosen by the dtype of q, k and v; both run on the tensor
    cores with 16-byte copies of the operands, and raise on a call
    :func:`cross_route_error` refuses.  bf16 takes
    ``cross_attention_mma_kernel`` (an Lk whose block passes 227 KB of
    shared memory fails at launch), fp32 ``cross_attention_tf32x3_kernel``
    (3xTF32, as :func:`cross_attention_acc`; every Lk fits).  Each writes
    P through a staging tile in shared memory.
    """
    B, Lq, Lk, H, hd = _check_qkv(q, k, v)
    if probs_dtype not in _DTYPE_CODES:
        raise ValueError(f'probs_dtype {probs_dtype} not supported')
    bf16 = q.dtype == torch.bfloat16
    _route_check('cross_attention_probs', q, k, v, Lq)
    o = torch.empty(B, Lq, H * hd, dtype=q.dtype, device=q.device)
    p = torch.empty(B, H, Lq, Lk, dtype=probs_dtype, device=q.device)
    strides, scale, stream = _args(q, k, v)
    lib = load_library()
    launch = (lib.daam_cross_attention_probs_mma if bf16
              else lib.daam_cross_attention_probs_tf32x3)
    err = launch(q.device.index, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), p.data_ptr(), _DTYPE_CODES[probs_dtype],
                 B // 2 if cond_only else 0, B, H, Lq, Lk, *strides, scale,
                 stream)
    _raise_on(err, 'cross_attention_probs')
    launches['cross_attention_probs'] += 1
    launches['cross_attention_probs_mma' if bf16 else 'cross_attention_probs_tf32x3'] += 1
    return o, p


def _on_card(name: str, t: Optional[torch.Tensor], dtype: torch.dtype, dim: int):
    if t is None or not t.is_cuda or t.dtype != dtype or t.dim() != dim \
            or not t.is_contiguous():
        got = 'None' if t is None else f'{t.dtype} {tuple(t.shape)} on {t.device}'
        raise ValueError(f'{name} must be a contiguous {dim}-d {dtype} CUDA tensor, '
                         f'got {got}')


def overlay_resample(heat: torch.Tensor, size) -> torch.Tensor:
    """A word's (h, w) fp32 map resampled on the card to ``size`` = (H, W)
    as ``F.interpolate(mode='bicubic', align_corners=False)`` resamples it,
    for :func:`png_scanlines`.

    Returns the scratch ``overlay_resample_kernel`` writes: the (H, W) map
    flattened, then its blocks' partial minima and maxima.
    """
    _on_card('heat', heat, torch.float32, 2)
    H, W = (int(n) for n in size)
    if min(H, W) < 1 or H * W > _INT_MAX:
        raise ValueError(f'unsupported size {(H, W)}')
    lib = load_library()
    scratch = torch.empty(lib.daam_overlay_scratch_floats(H, W), dtype=torch.float32,
                          device=heat.device)
    err = lib.daam_overlay_resample(heat.device.index, heat.data_ptr(), heat.shape[0],
                                    heat.shape[1], H, W, scratch.data_ptr(),
                                    torch.cuda.current_stream(heat.device).cuda_stream)
    _raise_on(err, 'overlay_resample')
    launches['overlay_resample'] += 1
    return scratch


def png_scanlines(image: torch.Tensor, resampled: Optional[torch.Tensor] = None,
                  lut: Optional[torch.Tensor] = None, color_normalize: bool = True,
                  filtered: bool = True) -> torch.Tensor:
    """The PNG scanlines of an (H, W, 3) uint8 image on the card, as the
    (H, 1 + 3W) uint8 rows a PNG's IDAT deflates: each row's filter type
    byte, then its bytes filtered as Pillow filters them (its choice among
    None, Sub, Up and Paeth), or unfiltered (type 0) when ``filtered`` is
    false.

    With ``resampled`` (what :func:`overlay_resample` returned at this
    size) and ``lut`` (the float64 (256, 3) jet table) the rows are the
    heat-map overlay ``heatmap._jet_composite`` draws, rounded to uint8:
    the map min-max normalized as ``expand_as`` normalizes it, coloured
    with ``color_normalize`` as the composite colours it.  Without them
    the rows are the image's own.
    """
    _on_card('image', image, torch.uint8, 3)
    H, W, C = image.shape
    if C != 3 or H * (1 + 3 * W) > _INT_MAX:
        raise ValueError(f'image must be (H, W, 3), got {tuple(image.shape)}')
    lib = load_library()
    if resampled is not None:
        _on_card('resampled', resampled, torch.float32, 1)
        _on_card('lut', lut, torch.float64, 2)
        if resampled.numel() != lib.daam_overlay_scratch_floats(H, W) \
                or tuple(lut.shape) != (256, 3) or resampled.device != image.device:
            raise ValueError('resampled must be overlay_resample\'s scratch at the '
                             'image\'s size and lut the (256, 3) table, on its device')
    out = torch.empty(H, 1 + 3 * W, dtype=torch.uint8, device=image.device)
    err = lib.daam_png_scanlines(
        image.device.index, image.data_ptr(),
        None if resampled is None else resampled.data_ptr(),
        None if resampled is None else lut.data_ptr(), H, W, int(color_normalize),
        int(filtered), out.data_ptr(),
        torch.cuda.current_stream(image.device).cuda_stream)
    _raise_on(err, 'png_scanlines')
    launches['png_scanlines'] += 1
    return out


def geglu(x: torch.Tensor) -> torch.Tensor:
    """``h * gelu(gate)`` of a feed-forward's projection output on the card,
    in one pass (``geglu_kernel``).

    ``x``: contiguous bf16 or fp32 (..., 2w), ``h`` its first w columns and
    the gate the last w.  Returns contiguous (..., w) in ``x``'s dtype,
    equal to :func:`daam_tpu_torch.ops.geglu.geglu_plain`: the exact-erf GELU
    in fp32 rounded to the dtype, then the product rounded to it.  Rows
    move as 16-byte chunks where w and the bases allow, else one element at
    a time; every width runs the kernel.
    """
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f'x: dtype {x.dtype} not supported')
    if not x.is_contiguous():
        raise ValueError(f'x must be contiguous, strides {x.stride()}')
    if x.dim() < 1 or x.shape[-1] % 2 or x.numel() == 0 or x.numel() > _INT_MAX:
        raise ValueError(f'x must be a non-empty (..., 2w) tensor of at most 2^31 - 1 '
                         f'elements, got shape {tuple(x.shape)}')
    if not x.is_cuda:
        raise ValueError(f'x must be a CUDA tensor, got {x.device}')
    w = x.shape[-1] // 2
    out = torch.empty(*x.shape[:-1], w, dtype=x.dtype, device=x.device)
    err = load_library().daam_geglu(x.device.index, _DTYPE_CODES[x.dtype], x.data_ptr(),
                                    out.data_ptr(), x.numel() // (2 * w), w,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'geglu')
    launches['geglu'] += 1
    return out
