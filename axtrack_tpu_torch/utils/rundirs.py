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


def clean_rundirs(exp_name, delete_runs_min_epochs=None,
                  delete_all_except=None, keep_only_latest_model=False,
                  filetype='csv'):
    """Tidy up an experiment's run directories (reference utils.py:40-64):
    print each run's epochs (its ``metrics/E%04d.<filetype>`` files),
    checkpoints (``models/*``) and notes; with ``keep_only_latest_model``
    delete all but the last checkpoint; delete runs of fewer than
    ``delete_runs_min_epochs`` epochs, or every run whose number is not in
    ``delete_all_except``."""
    import glob
    import json
    import shutil
    if delete_all_except is not None:
        if not all(isinstance(run, int) for run in delete_all_except):
            raise ValueError('`delete_all_except` should only contain '
                             'integers.')
    exp_dir = f'{config.OUTPUT_DIR}/runs/{exp_name}'
    for d in sorted(os.listdir(exp_dir)):
        n_metrics = len([
            f for f in glob.glob(f'{exp_dir}/{d}/metrics/E*.{filetype}')
            if not f.endswith(f'_metrics.{filetype}')])
        models = sorted(glob.glob(f'{exp_dir}/{d}/models/*'))
        try:
            with open(f'{exp_dir}/{d}/params.json') as f:
                notes = json.load(f).get('NOTES', '')
        except OSError:
            notes = '<no params>'
        print(f'{d} - Epochs: {n_metrics}, models saved: {len(models)}, '
              f'{notes}', flush=True)

        if keep_only_latest_model and len(models) > 1:
            for model in models[:-1]:
                if os.path.isdir(model):
                    shutil.rmtree(model)
                else:
                    os.remove(model)
            print(f'{len(models) - 1} models --deleted--')
        if delete_runs_min_epochs and n_metrics < delete_runs_min_epochs:
            shutil.rmtree(f'{exp_dir}/{d}')
            print('--deleted--\n')
        elif (delete_all_except is not None
              and int(d[3:d.find('_')]) not in delete_all_except):
            shutil.rmtree(f'{exp_dir}/{d}')
            print('--deleted--\n')
