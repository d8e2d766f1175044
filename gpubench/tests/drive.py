"""Drive a run of the harness on the CPU at a test size: the look for a
chip skipped, the configuration swapped for a fixture of the same model at
the ``tiny``/``tiny-xl`` presets' sizes, everything else as a run."""

import contextlib
import io
import json
import shutil
import tempfile
from pathlib import Path

from gpubench.core import runner

FIXTURES = Path(__file__).with_name('fixtures')
TEST_CONFIG = {'sd21-base-512-fp32': 'tiny', 'sdxl-base-1024-bf16': 'tiny-xl'}


def run_cell(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
             trace: int = 0) -> dict:
    """The result line of one run, as a dict (``checks``: each number and
    its limit)."""
    from gpubench.core import spec

    cell = spec.cell(workload, spec.benchmark())
    cfg = json.loads((FIXTURES / f"{TEST_CONFIG[cell['workload']['config']]}.json").read_text())
    out, err = io.StringIO(), io.StringIO()
    own, before = tempfile.mkdtemp(prefix='gpubench-test-'), tempfile.tempdir
    tempfile.tempdir = own  # the run's files, apart from other workers'
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = runner.main(['--workload', workload, '--seed', str(seed), '--seconds',
                              str(seconds), '--trace', str(trace)], device='cpu', config=cfg)
    finally:
        tempfile.tempdir = before
        shutil.rmtree(own, ignore_errors=True)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])
