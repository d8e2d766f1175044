"""Mean milliseconds of a denoising step over the window's pipeline calls:
each call's time from its first step's end to its last step's end (CUDA
events recorded in the step callback) over the steps between."""

LAYER = 'Pipeline'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'device_trace'
MOVES = 'images_per_s'

def read(data):
    ms = [x for _, runs in data['records'] for r in runs for x in r['clock'].step_ms()[1:]]
    return sum(ms) / len(ms) if ms else None
