"""Drive a run of the harness on the CPU at a test size: the look for a
chip skipped, the configuration swapped for its fixture (the same model at
a test preset's sizes), everything else as a run.

A configuration's fixture is the file under ``fixtures/`` whose
``test_size_of`` lists the configuration's name, so a new configuration
brings a fixture file and edits nothing here.  A fixture whose
``program_preset`` the program lacks states it as ``test_preset``: a preset
of the program (``base``) with the fields given beside it replaced, which
:func:`program_preset` registers while a run needs it.
"""

import contextlib
import dataclasses
import io
import json
import shutil
import tempfile
from pathlib import Path

from gpubench.core import runner

FIXTURES = Path(__file__).with_name('fixtures')


def fixture(config: str) -> dict:
    """The fixture of configuration ``config``."""
    found = [json.loads(p.read_text()) for p in sorted(FIXTURES.glob('*.json'))]
    found = [f for f in found if config in f.get('test_size_of', [])]
    if len(found) != 1:
        raise LookupError(f'{len(found)} fixtures list {config!r} in test_size_of; one should')
    return found[0]


@contextlib.contextmanager
def program_preset(cfg: dict):
    """The program knows ``cfg``'s preset while the block runs."""
    from daam_tpu_torch.models import configs

    name, test = cfg['program_preset'], cfg.get('test_preset')
    if test is None or name in configs.MODEL_PRESETS:
        yield
        return
    fields = {k: v for k, v in test.items() if k != 'base'}
    configs.MODEL_PRESETS[name] = dataclasses.replace(
        configs.get_pipeline_config(test['base']), name=name, **fields)
    try:
        yield
    finally:
        del configs.MODEL_PRESETS[name]


def run_cell(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
             trace: int = 0, config: dict = None) -> dict:
    """The result line of one run, as a dict (``checks``: each number and
    its limit).  ``config``: a fixture in place of the cell's own."""
    from gpubench.core import spec

    cell = spec.cell(workload, spec.benchmark())
    cfg = config or fixture(cell['workload']['config'])
    out, err = io.StringIO(), io.StringIO()
    own, before = tempfile.mkdtemp(prefix='gpubench-test-'), tempfile.tempdir
    tempfile.tempdir = own  # the run's files, apart from other workers'
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), program_preset(cfg):
            rc = runner.main(['--workload', workload, '--seed', str(seed), '--seconds',
                              str(seconds), '--trace', str(trace)], device='cpu', config=cfg)
    finally:
        tempfile.tempdir = before
        shutil.rmtree(own, ignore_errors=True)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])
