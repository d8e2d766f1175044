"""Mean milliseconds per image of ``to_experiment``, ``save`` and every
``save_heat_map`` of the prompt (the files written); host clock."""

LAYER = 'Experiment'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'
MOVES = 'images_per_s'

def read(data):
    ms = [t * 1e3 for _, runs in data['records'] for r in runs
          for t in r['clock'].spans.get('experiment', [])]
    return sum(ms) / len(ms) if ms else None
