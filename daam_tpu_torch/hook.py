"""Object-hooking layer (API parity with reference ``daam/hook.py``).

Counterpart of ``daam_tpu/hook.py``.  Tracing installs the trace on the
pipeline object, which then runs its UNet with the capture the trace asks
for (``'acc'``, or ``'full'`` under ``save_heads``); the model's modules
are never patched.  The hookers are how trace contexts attach to and
detach from pipeline objects, and a public utility for reversible
attribute surgery on any Python object (:meth:`ObjectHooker.monkey_patch`,
undone on unhook).

``UNetCrossAttentionLocator`` enumerates the UNet's cross-attention layers in
the reference's order (up → down → mid, ``daam/hook.py:110-114``) from the
static model config rather than by walking live modules.
"""

import functools
import itertools
from typing import Any, Dict, Generic, List, Optional, Set, TypeVar

from .models.configs import CrossAttnLayerInfo, cross_attention_layout

__all__ = ['ObjectHooker', 'ModuleLocator', 'AggregateHooker',
           'UNetCrossAttentionLocator']

ModuleType = TypeVar('ModuleType')
ModuleListType = TypeVar('ModuleListType', bound=List)

_SAVED_PREFIX = 'old_fn_'  # key prefix in old_state (reference-compatible)


class ModuleLocator(Generic[ModuleType]):
    """Finds hookable sub-objects of a model (reference ``daam/hook.py:17-19``)."""

    def locate(self, model) -> List[ModuleType]:
        raise NotImplementedError


class ObjectHooker(Generic[ModuleType]):
    """Reversible attachment to one object, with the context-manager
    protocol (reference ``daam/hook.py:22-73``).  Subclasses implement
    ``_hook_impl`` (and optionally ``_unhook_impl``), where
    :meth:`monkey_patch` replaces attributes; unhooking restores them.
    Saved originals live in ``self.old_state`` under ``'old_fn_<name>'``
    keys, as in the reference, and :meth:`monkey_super` calls them."""

    def __init__(self, module: ModuleType):
        self.module: ModuleType = module
        self.hooked = False
        self.old_state: Dict[str, Any] = {}

    def __enter__(self) -> 'ObjectHooker':
        return self.hook()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.unhook()

    def hook(self) -> 'ObjectHooker':
        if self.hooked:
            raise RuntimeError('Already hooked module')
        self.old_state = {}
        self.hooked = True
        self._hook_impl()
        return self

    def unhook(self) -> 'ObjectHooker':
        if not self.hooked:
            raise RuntimeError('Module is not hooked')
        self._restore_all()
        self.hooked = False
        self._unhook_impl()
        return self

    def _restore_all(self):
        for key, original in self.old_state.items():
            if key.startswith(_SAVED_PREFIX):
                setattr(self.module, key[len(_SAVED_PREFIX):], original)

    def monkey_patch(self, fn_name: str, fn, strict: bool = True):
        """Replace ``module.<fn_name>`` with ``fn(module, ...)``, saving the
        original for :meth:`unhook` and :meth:`monkey_super`.  With
        ``strict=False`` a missing attribute is ignored (the reference
        patches ``run_safety_checker`` so, since SDXL lacks it,
        ``daam/trace.py:185``)."""
        if not hasattr(self.module, fn_name):
            if strict:
                raise AttributeError(
                    f'{type(self.module).__name__} has no attribute {fn_name!r}')
            return
        self.old_state[_SAVED_PREFIX + fn_name] = getattr(self.module, fn_name)
        setattr(self.module, fn_name, functools.partial(fn, self.module))

    def monkey_super(self, fn_name: str, *args, **kwargs):
        """Call the saved original of a patched method."""
        return self.old_state[_SAVED_PREFIX + fn_name](*args, **kwargs)

    def _hook_impl(self):
        raise NotImplementedError

    def _unhook_impl(self):
        pass


class AggregateHooker(ObjectHooker[ModuleListType]):
    """A hooker over a list of hookers: hook/unhook fan out
    (reference ``daam/hook.py:76-86``)."""

    def _hook_impl(self):
        for child in self.module:
            child.hook()

    def _unhook_impl(self):
        for child in self.module:
            child.unhook()

    def register_hook(self, hook: ObjectHooker):
        self.module.append(hook)


class UNetCrossAttentionLocator(ModuleLocator[CrossAttnLayerInfo]):
    """Enumerate cross-attention layers in reference locator order.

    Mirrors ``daam/hook.py:89-127``: up blocks first (model order: deepest
    level first), then down, then optionally the mid block; ``restrict``
    filters by index *within* each UNet block, and ``layer_names`` records
    ``'{up|down|mid}-attn-{i}'`` labels per block (the ``low_memory`` mode
    passes ``restrict={0}``, reference ``daam/trace.py:35``).
    """

    def __init__(self, restrict: Optional[Set[int]] = None,
                 locate_middle_block: bool = False):
        self.restrict = restrict
        self.layer_names: List[str] = []
        self.locate_middle_block = locate_middle_block

    def _keep(self, index_in_block: int) -> bool:
        return self.restrict is None or index_in_block in self.restrict

    def locate(self, unet) -> List[CrossAttnLayerInfo]:
        """``unet``: a UNet config, a UNet module, or a pipeline's unet shim.

        Global ``layer_idx`` is the index in the located (filtered) list,
        matching the reference's ``enumerate(locator.locate(...))`` numbering
        (``daam/trace.py:50``).
        """
        config = getattr(unet, 'config', unet)
        self.layer_names.clear()

        candidates = [
            info for info in cross_attention_layout(config)
            if self.locate_middle_block or info.position != 'mid'
        ]

        located: List[CrossAttnLayerInfo] = []
        by_block = itertools.groupby(candidates,
                                     key=lambda x: (x.position, x.level))
        for (position, _level), group in by_block:
            kept = [info for i, info in enumerate(group) if self._keep(i)]
            self.layer_names.extend(
                f'{position}-attn-{i}' for i in range(len(kept)))
            located.extend(kept)

        return [info._replace(layer_idx=i) for i, info in enumerate(located)]
