"""Object-hooking layer (API parity with reference ``daam/hook.py``).

The part of ``daam_tpu/hook.py`` that tracing needs.  Tracing installs the
trace on the pipeline object, which then runs its UNet with the capture
the trace asks for (``'acc'``, or ``'full'`` under ``save_heads``); the
model's modules are never patched.  The hookers are how trace
contexts attach to and detach from pipeline objects.

``UNetCrossAttentionLocator`` enumerates the UNet's cross-attention layers in
the reference's order (up → down → mid, ``daam/hook.py:110-114``) from the
static model config rather than by walking live modules.
"""

import itertools
from typing import Generic, List, Optional, Set, TypeVar

from .models.configs import CrossAttnLayerInfo, cross_attention_layout

__all__ = ['ObjectHooker', 'ModuleLocator', 'AggregateHooker',
           'UNetCrossAttentionLocator']

ModuleType = TypeVar('ModuleType')
ModuleListType = TypeVar('ModuleListType', bound=List)


class ModuleLocator(Generic[ModuleType]):
    """Finds hookable sub-objects of a model (reference ``daam/hook.py:17-19``)."""

    def locate(self, model) -> List[ModuleType]:
        raise NotImplementedError


class ObjectHooker(Generic[ModuleType]):
    """Reversible attachment to one object, with the context-manager
    protocol (reference ``daam/hook.py:22-73``).  Subclasses implement
    ``_hook_impl`` and ``_unhook_impl``."""

    def __init__(self, module: ModuleType):
        self.module: ModuleType = module
        self.hooked = False

    def __enter__(self) -> 'ObjectHooker':
        return self.hook()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.unhook()

    def hook(self) -> 'ObjectHooker':
        if self.hooked:
            raise RuntimeError('Already hooked module')
        self.hooked = True
        self._hook_impl()
        return self

    def unhook(self) -> 'ObjectHooker':
        if not self.hooked:
            raise RuntimeError('Module is not hooked')
        self.hooked = False
        self._unhook_impl()
        return self

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
