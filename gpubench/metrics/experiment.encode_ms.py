"""Milliseconds per image of the program's ``overlay.encode`` spans in the
profiled request: the overlay drawn and written as a PNG (PIL, or
matplotlib where installed)."""

from gpubench.core import spans

LAYER = 'Experiment'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'
MOVES = 'images_per_s'

def read(data):
    sp = spans.program_spans(data)
    us = [e - s for s, e, name, _ in sp or [] if name == 'overlay.encode']
    n = spans.images(data)
    return sum(us) / 1e3 / n if us and n else None
