"""Model architecture configs with presets for the SD family the reference supports.

A copy of ``daam_tpu/models/configs.py`` (pure dataclasses, held equal to it
by ``tests/test_torch_shared.py``), plus the cross-attention layer layout of
``daam_tpu/models/unet.py`` (``CrossAttnLayerInfo``,
``cross_attention_layout``), a pure walk over the config.  The port keeps its
own copy because importing anything from ``daam_tpu`` imports JAX.

The reference's model registry (``daam/run/generate.py:23-30``) covers SD 1.5,
SD 2.x/2.1 (base and large), and SDXL base 1.0.  Tiny presets exist for tests
and CI (random weights, same topology).
"""

from dataclasses import dataclass, field, replace
from typing import List, NamedTuple, Optional, Tuple

__all__ = ['CLIPTextConfig', 'UNetConfig', 'VAEConfig', 'PipelineConfig',
           'get_pipeline_config', 'MODEL_PRESETS', 'CrossAttnLayerInfo',
           'cross_attention_layout']


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = 'gelu'          # 'gelu' (OpenCLIP) or 'quick_gelu' (CLIP-L)
    layer_norm_eps: float = 1e-5
    # SDXL's second encoder exposes a projected pooled embedding.
    projection_dim: Optional[int] = None


@dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    # Per-level ('level' = resolution level, 0 = finest): 'cross' (block with
    # text transformer) or 'plain'.  SD1/SD2: cross at levels 0-2, plain at the
    # deepest level of the up path.
    down_block_types: Tuple[str, ...] = ('cross', 'cross', 'cross', 'plain')
    up_block_types: Tuple[str, ...] = ('cross', 'cross', 'cross', 'plain')
    layers_per_block: int = 2
    # Heads per level (diffusers attention_head_dim for SD2; SD1.x uses 8 everywhere).
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    # Transformer depth per level (SDXL: (1, 2, 10)).
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    cross_attention_dim: int = 1024
    use_linear_projection: bool = True
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    mid_block_attn: bool = True
    # SDXL text_time conditioning: pooled text emb + 6 time ids.
    addition_embed_type: Optional[str] = None  # None | 'text_time'
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215

    @property
    def scale_factor(self) -> int:
        """Spatial down/up factor between pixels and latents (8 for SD)."""
        return 2 ** (len(self.block_out_channels) - 1)


@dataclass(frozen=True)
class PipelineConfig:
    name: str = 'sd2-1-base'
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    text_2: Optional[CLIPTextConfig] = None  # SDXL second encoder
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    prediction_type: str = 'epsilon'  # 'epsilon' | 'v_prediction'
    is_sdxl: bool = False
    default_guidance_scale: float = 7.5

    @property
    def image_size(self) -> int:
        return self.unet.sample_size * self.vae.scale_factor


_CLIP_L = CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                         num_hidden_layers=12, num_attention_heads=12,
                         hidden_act='quick_gelu')
_OPENCLIP_H = CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                             num_hidden_layers=23, num_attention_heads=16,
                             hidden_act='gelu')
_OPENCLIP_BIGG = CLIPTextConfig(hidden_size=1280, intermediate_size=5120,
                                num_hidden_layers=32, num_attention_heads=20,
                                hidden_act='gelu', projection_dim=1280)

_SD15_UNET = UNetConfig(
    sample_size=64, attention_head_dim=(8, 8, 8, 8), cross_attention_dim=768,
    use_linear_projection=False)
_SD2_UNET_BASE = UNetConfig(sample_size=64, cross_attention_dim=1024)
_SD2_UNET_LARGE = replace(_SD2_UNET_BASE, sample_size=96)
_SDXL_UNET = UNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    down_block_types=('plain', 'cross', 'cross'),
    up_block_types=('plain', 'cross', 'cross'),
    attention_head_dim=(5, 10, 20),
    transformer_layers_per_block=(0, 2, 10),
    cross_attention_dim=2048,
    addition_embed_type='text_time',
    projection_class_embeddings_input_dim=2816,
)

_TINY = PipelineConfig(
    name='tiny',
    text=CLIPTextConfig(vocab_size=49408, hidden_size=32,
                        intermediate_size=64, num_hidden_layers=2,
                        num_attention_heads=2),
    unet=UNetConfig(sample_size=8, block_out_channels=(32, 64),
                    down_block_types=('cross', 'plain'),
                    up_block_types=('cross', 'plain'),
                    layers_per_block=1, attention_head_dim=(2, 4),
                    transformer_layers_per_block=(1, 1),
                    cross_attention_dim=32, norm_num_groups=8),
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                  norm_num_groups=8, sample_size=64))

MODEL_PRESETS = {
    'v1': PipelineConfig(name='v1', text=_CLIP_L, unet=_SD15_UNET),
    'v2-base': PipelineConfig(name='v2-base', text=_OPENCLIP_H, unet=_SD2_UNET_BASE),
    'v2-large': PipelineConfig(name='v2-large', text=_OPENCLIP_H,
                               unet=_SD2_UNET_LARGE,
                               vae=VAEConfig(sample_size=768),
                               prediction_type='v_prediction'),
    'v2-1-base': PipelineConfig(name='v2-1-base', text=_OPENCLIP_H,
                                unet=_SD2_UNET_BASE),
    'v2-1-large': PipelineConfig(name='v2-1-large', text=_OPENCLIP_H,
                                 unet=_SD2_UNET_LARGE,
                                 vae=VAEConfig(sample_size=768),
                                 prediction_type='v_prediction'),
    'xl-base-1.0': PipelineConfig(name='xl-base-1.0', text=_CLIP_L,
                                  text_2=_OPENCLIP_BIGG, unet=_SDXL_UNET,
                                  vae=VAEConfig(sample_size=1024,
                                                scaling_factor=0.13025),
                                  is_sdxl=True, default_guidance_scale=5.0),
    # Tiny presets: same topology, test-sized. 'tiny' mirrors SD2 (single
    # encoder), 'tiny-v' SD 2.x 768 (v-prediction); 'tiny-xl' mirrors SDXL
    # (dual encoder + text_time embedding).
    'tiny': _TINY,
    'tiny-v': replace(_TINY, name='tiny-v', prediction_type='v_prediction'),
    # 'tiny-v1' mirrors SD 1.x geometry: conv 1×1 proj_in/out
    # (use_linear_projection=False) and a uniform head count, so head_dim
    # differs per level like v1's 40/80/160.
    'tiny-v1': PipelineConfig(
        name='tiny-v1',
        text=CLIPTextConfig(vocab_size=49408, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=2, hidden_act='quick_gelu'),
        unet=UNetConfig(sample_size=8, block_out_channels=(32, 64),
                        down_block_types=('cross', 'plain'),
                        up_block_types=('cross', 'plain'),
                        layers_per_block=1, attention_head_dim=(2, 2),
                        transformer_layers_per_block=(1, 1),
                        cross_attention_dim=32, norm_num_groups=8,
                        use_linear_projection=False),
        vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                      norm_num_groups=8, sample_size=64)),
    'tiny-xl': PipelineConfig(
        name='tiny-xl',
        text=CLIPTextConfig(vocab_size=49408, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=2),
        text_2=CLIPTextConfig(vocab_size=49408, hidden_size=64,
                              intermediate_size=128, num_hidden_layers=2,
                              num_attention_heads=2, projection_dim=64),
        unet=UNetConfig(sample_size=8, block_out_channels=(32, 64),
                        down_block_types=('plain', 'cross'),
                        up_block_types=('plain', 'cross'),
                        layers_per_block=1, attention_head_dim=(2, 4),
                        transformer_layers_per_block=(0, 2),
                        cross_attention_dim=96, norm_num_groups=8,
                        addition_embed_type='text_time',
                        addition_time_embed_dim=8,
                        projection_class_embeddings_input_dim=64 + 6 * 8),
        vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                      norm_num_groups=8, sample_size=64),
        is_sdxl=True),
}


def get_pipeline_config(name: str) -> PipelineConfig:
    if name not in MODEL_PRESETS:
        raise KeyError(f'Unknown model preset {name!r}; '
                       f'available: {sorted(MODEL_PRESETS)}')
    return MODEL_PRESETS[name]


class CrossAttnLayerInfo(NamedTuple):
    name: str          # UNet-internal layer name (capture key)
    layer_idx: int     # global DAAM layer index (reference locator order)
    position: str      # 'up' | 'down' | 'mid'
    level: int         # resolution level in the UNet
    heads: int
    downscale: int     # spatial downscale vs latent grid (1, 2, 4, 8)


def _level_layer_names(config: UNetConfig, position: str, level: int) -> List[str]:
    """Capture-key names of cross-attn transformer blocks at one level."""
    depth = config.transformer_layers_per_block[level]
    n_attn = config.layers_per_block if position == 'down' else config.layers_per_block + 1
    if position == 'mid':
        n_attn = 1
    names = []
    for i in range(n_attn):
        base = f'{position}_{level}_{i}' if position != 'mid' else 'mid_0'
        if depth > 1:
            names.extend(f'{base}.{d}' for d in range(depth))
        else:
            names.append(base)
    return names


def cross_attention_layout(config: UNetConfig) -> List[CrossAttnLayerInfo]:
    """All cross-attention layers in reference locator order (up → down → mid,
    reference ``daam/hook.py:110-114``), with global layer indices."""
    infos: List[CrossAttnLayerInfo] = []
    n_levels = len(config.block_out_channels)

    def add(position, level):
        heads = config.attention_head_dim[level]
        downscale = 2 ** level
        for name in _level_layer_names(config, position, level):
            infos.append(CrossAttnLayerInfo(name, -1, position, level, heads, downscale))

    # Reference order: up blocks in *model* order (deepest level first,
    # ``model.up_blocks[0]`` is the lowest resolution), then down blocks
    # (finest first), then mid (``daam/hook.py:110-114``).
    for level in reversed(range(n_levels)):
        if config.up_block_types[level] == 'cross':
            add('up', level)
    for level in range(n_levels):
        if config.down_block_types[level] == 'cross':
            add('down', level)
    if config.mid_block_attn:
        # mid block sits at the deepest level
        depth = max(config.transformer_layers_per_block[-1], 1)
        heads = config.attention_head_dim[-1]
        downscale = 2 ** (n_levels - 1)
        base = 'mid_0'
        names = [f'{base}.{d}' for d in range(depth)] if depth > 1 else [base]
        for name in names:
            infos.append(CrossAttnLayerInfo(name, -1, 'mid', n_levels - 1, heads, downscale))

    return [info._replace(layer_idx=i) for i, info in enumerate(infos)]
