"""Run directories (counterpart of ``axtrack_tpu/utils/rundirs.py``,
reference axtrack/utils.py:21-71): OUTPUT_DIR/runs/<exp>/runNN_<date>/
with models/, metrics/ and preproc_data/. OUTPUT_DIR is read from
``config`` at each call."""
import os
from datetime import datetime

from .. import config


def create_logging_dirs(exp_name):
    """Make the next run directory of ``exp_name``. Returns
    ((run_dir, models_dir, metrics_dir), run_label)."""
    exp_dir = f'{config.OUTPUT_DIR}/runs/{exp_name}'
    os.makedirs(exp_dir, exist_ok=True)
    runs = [int(r[3:5]) for r in os.listdir(exp_dir) if r.startswith('run')]
    if 99 in runs:
        raise RuntimeError('Run dir full (run99 in there), tidy up!')
    run = 0 if not runs else max(runs) + 1
    run_label = f'run{run:0>2}_' + datetime.now().strftime('%d.%m.%Y_%H.%M.%S')
    run_dir = f'{exp_dir}/{run_label}'
    models_dir = f'{run_dir}/models'
    metrics_dir = f'{run_dir}/metrics'
    preproc_data_dir = f'{run_dir}/preproc_data/'
    for d in [run_dir, models_dir, metrics_dir, preproc_data_dir]:
        os.makedirs(d)
    return (run_dir, models_dir, metrics_dir), run_label


def get_run_dir(exp_dir, run):
    """The directory of ``exp_dir`` whose name contains ``run`` ('run00')."""
    run_dir = [rd for rd in sorted(os.listdir(exp_dir)) if run in rd]
    if not run_dir:
        raise FileNotFoundError(f'Run not found: exp_dir: {exp_dir} run: {run}')
    return f'{exp_dir}/{run_dir[0]}'
