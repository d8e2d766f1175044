"""Mean milliseconds per image of ``compute_global_heat_map`` and every
``compute_word_heat_map`` of the prompt, with the maps fetched to host
memory (which synchronizes); host clock."""

LAYER = 'Heat maps'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'
MOVES = 'images_per_s'

def read(data):
    ms = [t * 1e3 for _, runs in data['records'] for r in runs
          for t in r['clock'].spans.get('maps', [])]
    return sum(ms) / len(ms) if ms else None
