"""Experiment driver — the training entry point.

PyTorch counterpart of ``axtrack_tpu/train/experiment.py`` (reference
experiment/experiment.py:49-157): run_experiment, optimize and
save_epoch_results. A run directory holds params.json/.txt, the epoch
metrics as ``metrics/E%04d.csv`` (the JAX package's rows, columns and
values), the augmentation draws (``metrics/transform_draws.jsonl``), the
preprocessing samples and the ``models/E%04d.pt`` checkpoints.

Deliberate differences from the JAX package: no ``E%04d.pkl`` (a pandas
object, and the port has no pandas), and the checkpoint epochs' detection
videos are skipped until the viz port (ROADMAP M17).
"""
import csv
import json
import os
import time

from .. import config
from ..params import (get_default_parameters, write_parameters,
                      check_parameters, params2text)
from ..utils import set_seed, create_logging_dirs, save_preproc_metrics
from . import engine
from .checkpoint import save_checkpoint


def run_experiment(exp_name, parameters, save_results=True, mesh=None):
    """Train on P['DEVICE'] for P['EPOCHS'] epochs (reference
    experiment.py:49-72). Returns the TrainState."""
    if mesh is not None:
        raise NotImplementedError(
            'mesh-parallel training is a later slice of the port '
            '(ROADMAP M14)')
    set_seed(parameters['SEED'])
    print(f'Running Experiment: {exp_name}', flush=True)
    check_parameters(parameters, get_default_parameters())
    if save_results:
        dirs, run_label = create_logging_dirs(exp_name)
        RUN_DIR, MODELS_DIR, METRICS_DIR = dirs
        write_parameters(f'{RUN_DIR}/params.json', parameters)
        print('\tSaving: ', run_label)
    else:
        RUN_DIR, MODELS_DIR, METRICS_DIR = None, None, None
        print('\tRun is not saved!')
    print(params2text(parameters), flush=True)

    train_data, test_data = engine.setup_data(parameters)
    state = engine.setup_model(parameters)
    optimize(parameters, train_data, test_data, state, save_results,
             MODELS_DIR, METRICS_DIR, RUN_DIR)
    return state


def optimize(parameters, train_data, test_data, state, save_results,
             MODELS_DIR, METRICS_DIR, RUN_DIR):
    """The epoch loop (reference experiment.py:75-112)."""
    tstart = None
    for epoch in range(parameters['EPOCHS']):
        last_epoch_dt = round(time.time() - tstart) if tstart else ''
        tstart = time.time()
        print(f'\n\n\nEpoch {epoch}/{parameters["EPOCHS"]}, last epoch took: '
              f'{last_epoch_dt}s\n{config.SPACER}', flush=True)
        epoch_info = {
            'train': engine.one_epoch(train_data, state, parameters, epoch,
                                      train=True),
            'test': engine.one_epoch(test_data, state, parameters, epoch,
                                     train=False)}
        summary = epoch_info['train'].get('total_summed_loss')
        if summary is not None:
            print(config.SPACER, f'\n epoch {epoch}: train loss '
                  f'{summary:.3f}')
        if save_results:
            save_epoch_results(epoch_info, epoch, parameters, train_data,
                               test_data, state, MODELS_DIR, METRICS_DIR,
                               RUN_DIR)


def write_epoch_csv(fname, epoch, epoch_info):
    """One epoch's metrics as the JAX package's ``E%04d.csv``: a header of
    two blank index columns and the metric names (a (metric, threshold)
    name as its tuple's text), then a row (epoch, 'train'|'test', values)
    per dataset."""
    names = list(epoch_info['train'])
    names += [n for n in epoch_info['test'] if n not in names]
    with open(fname, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(['', ''] + [str(n) for n in names])
        for which in ('train', 'test'):
            info = epoch_info[which]
            w.writerow([epoch, which] + [repr(float(info[n])) if n in info
                                         else '' for n in names])


def save_epoch_results(epoch_info, epoch, parameters, train_data, test_data,
                       state, MODELS_DIR, METRICS_DIR, RUN_DIR):
    """(reference experiment.py:114-142)"""
    write_epoch_csv(f'{METRICS_DIR}/E{epoch:0>4}.csv', epoch, epoch_info)
    # this epoch's augmentation draws: with the seeded generators they make
    # any epoch's input reconstructible
    with open(f'{METRICS_DIR}/transform_draws.jsonl', 'a') as f:
        f.write(json.dumps({
            'epoch': epoch,
            'train': getattr(train_data, 'last_transform_configs', None),
            'test': getattr(test_data, 'last_transform_configs', None),
        }) + '\n')

    if epoch == 0 and parameters['PLOT_PREPROC']:
        os.makedirs(f'{RUN_DIR}/preproc_data/', exist_ok=True)
        save_preproc_metrics(f'{RUN_DIR}/preproc_data/', train_data,
                             test_data)

    if epoch in parameters['MODEL_CHECKPOINTS']:
        save_checkpoint(state, filename=f'{MODELS_DIR}/E{epoch:0>4}')
        os.makedirs(f'{METRICS_DIR}/{epoch:0>4}_results/', exist_ok=True)
        print('(video render skipped: rendering detections is a later '
              'slice of the port, ROADMAP M17)')
