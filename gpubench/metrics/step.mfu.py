"""The window's model FLOP over its seconds, as a share of the card's dense
tensor-core peak for the configuration's dtype (TF32 for float32, whose
convolutions and attention run on the tensor cores; bf16 for bfloat16).
FLOP: every convolution, linear and attention product of the text
encoders, the UNet (per evaluation, times the steps) and the VAE decode,
counted from the shapes (``core/counters.py``)."""

from gpubench.core import counters

LAYER = 'Whole step'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'host_clock'
MOVES = 'images_per_s'


def read(data):
    if data['window_s'] <= 0:
        return None
    cfg = data['cfg']
    flop = sum(counters.model_flop(cfg, len(r['prompts']), counters.MODE[r['kind']])['total']
               for _, runs in data['records'] for r in runs)
    return 100.0 * flop / data['window_s'] / counters.peak_flops(cfg['dtype'])
