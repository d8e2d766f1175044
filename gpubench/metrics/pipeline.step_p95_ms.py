"""95th percentile of the window's denoising steps (CUDA events recorded in
the step callback), where the host sets the pace and the tail is its stalls;
``step_p95_ms`` of the cells where the card sets it."""

from statistics import quantiles

LAYER = 'Pipeline'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'device_trace'
MOVES = 'images_per_s'

def read(data):
    ms = [x for _, runs in data['records'] for r in runs for x in r['clock'].step_ms()]
    return quantiles(ms, n=20)[-1] if len(ms) > 1 else None
