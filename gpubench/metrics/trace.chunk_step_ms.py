"""Mean milliseconds of the save runs' steps that end a chunk of the heads
buffer (every ``heads_chunk_steps``-th UNet evaluation and the last): the
steps that stack the chunk's probabilities and copy them to host memory."""

from gpubench.core import counters

LAYER = 'Trace'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'device_trace'
MOVES = 'images_per_s'

def read(data):
    chunk, n = data['chunk'], counters.evaluations(data['cfg'], data['steps'])
    ends = {i for i in range(n) if (i + 1) % chunk == 0 or i == n - 1}
    ms = [m for _, runs in data['records'] for r in runs if r['kind'] == 'save'
          for i, m in enumerate(r['clock'].step_ms()) if i in ends]
    return sum(ms) / len(ms) if ms else None
