"""Run one cell of the benchmark of ``daam_tpu_torch`` once.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints the run's result as the last line of standard output (one
JSON object) and the numbers that decided ``correct`` as the last lines of
standard error.  Build and kernel caches stay inside the checkout; the
run's files go under ``TMPDIR``.
"""

import json
import os
import sys
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), so that the
    interpreter's own start counts as set-up."""
    try:
        fields = Path('/proc/self/stat').read_text().rsplit(')', 1)[1].split()
        ticks = os.sysconf('SC_CLK_TCK')
        uptime = float(Path('/proc/uptime').read_text().split()[0])
        return max(0.0, uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.monotonic() - _process_age_s()
REPO = Path(__file__).resolve().parents[1]
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'), ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = str(REPO / 'build' / 'gpubench' / sub)
os.environ['USE_FLAX'] = '0'
os.environ['USE_JAX'] = '0'
sys.path.insert(0, str(REPO))


def _threads(argv) -> None:
    """The cell's configuration's CPU threads (``host.torch_threads``), set
    before PyTorch loads; an unknown cell is left to the runner to refuse."""
    from gpubench.core import spec

    try:
        name = argv[argv.index('--workload') + 1]
        bench = spec.benchmark()
        config = {w['name']: w['config'] for w in bench['workloads']}[name]
        cfg = json.loads((spec.ROOT / 'configs' / f'{config}.json').read_text())
        os.environ['OMP_NUM_THREADS'] = str(cfg['host']['torch_threads'])
    except (ValueError, IndexError, KeyError, OSError):
        pass


if __name__ == '__main__':
    _threads(sys.argv[1:])
    from gpubench.core.runner import main
    sys.exit(main(sys.argv[1:], t_start=T_START))
