"""Milliseconds the card is idle inside the program's ``unet`` spans, per
UNet evaluation of the profiled request: the host's dispatch of one
evaluation that the card does not hide."""

from gpubench.core import spans

LAYER = 'Pipeline'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'device_trace'
MOVES = 'images_per_s'

def read(data):
    sp = spans.program_spans(data)
    unet = [(s, e) for s, e, name, _ in sp or [] if name == 'unet']
    if not unet:
        return None
    return spans.overlap(data['profile'].gaps, unet) / 1e3 / len(unet)
