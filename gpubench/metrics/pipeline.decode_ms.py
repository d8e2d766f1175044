"""Mean milliseconds from a call's last denoising step to its images on the
host: the VAE decode (tiled where the configuration tiles it),
``finalize_acc``, the copy to host memory and the safety-checker slot
(CUDA events)."""

LAYER = 'Pipeline'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'device_trace'
MOVES = 'images_per_s'

def read(data):
    ms = [r['clock'].decode_ms() for _, runs in data['records'] for r in runs
          if r['clock'].timed]
    return sum(ms) / len(ms) if ms else None
