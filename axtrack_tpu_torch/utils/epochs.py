"""Epoch metrics of a run, gathered over its epochs, and runs stitched
together (counterpart of ``axtrack_tpu/utils/epochs.py``, reference
utils.py:112-181).

The JAX package reads its ``E%04d.pkl`` DataFrames and returns
DataFrames; the port reads its own ``metrics/E%04d.csv`` files
(``train.experiment.write_epoch_csv``) and returns tables: dicts holding
'epoch' (int64 [n]) and then one float64 [n] column a key, the keys being
the DataFrame's column tuples in its column order, NaN where a value is
missing. The gathered tables are cached as ``loss_all_epochs.csv`` and
``metrics_all_epochs.csv`` beside the epoch files.
"""
import ast
import csv
import glob
import os

import numpy as np

from .. import config
from .rundirs import get_run_dir


def _name(text):
    """A metric name of a CSV header: a (metric, threshold) tuple's text
    back to the tuple."""
    return ast.literal_eval(text) if text.startswith('(') else text


def _cell(text):
    return float(text) if text else np.nan


def read_table(fname):
    """A table written by ``write_table``."""
    with open(fname, newline='') as f:
        rows = list(csv.reader(f))
    table = {'epoch': np.asarray([int(r[0]) for r in rows[1:]], np.int64)}
    for j, name in enumerate(rows[0][1:]):
        table[_name(name)] = np.asarray([_cell(r[1 + j]) for r in rows[1:]],
                                        np.float64)
    return table


def write_table(fname, table):
    """A table as CSV: a header of 'epoch' and the columns' tuples as
    text, then one row an epoch (NaN as an empty cell)."""
    cols = [k for k in table if k != 'epoch']
    with open(fname, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(['epoch'] + [str(c) for c in cols])
        for i, e in enumerate(table['epoch']):
            w.writerow([int(e)] + ['' if np.isnan(table[c][i])
                                   else repr(float(table[c][i]))
                                   for c in cols])


def _table(epochs, columns):
    """A table from epochs and {column: {epoch: value}}."""
    table = {'epoch': np.asarray(epochs, np.int64)}
    for c, vals in columns.items():
        table[c] = np.asarray([vals.get(e, np.nan) for e in epochs],
                              np.float64)
    return table


def create_all_epochs_info(metrics_dir):
    """Gather a run's ``E%04d.csv`` files into (loss_all_epochs,
    metrics_all_epochs) (reference utils.py:112-131), and write both.

    The epoch files have a row (epoch, 'train'|'test') and columns: the
    loss names and, every 10th epoch, (metric, threshold) tuples. The
    loss table has the columns (name, split), each name's splits in sorted
    order, and the threshold with the highest mean test F1 adds its
    metrics as (metric, split); the metrics table has the columns
    (metric, threshold, split)."""
    files = sorted(f for f in glob.glob(f'{metrics_dir}/E*.csv')
                   if not f.endswith('_metrics.csv'))
    names, values = [], {}           # values[(name, split)][epoch]
    for fname in files:
        with open(fname, newline='') as f:
            rows = list(csv.reader(f))
        header = [_name(n) for n in rows[0][2:]]
        names += [n for n in header if n not in names]
        for r in rows[1:]:
            for n, v in zip(header, r[2:]):
                values.setdefault((n, r[1]), {})[int(r[0])] = _cell(v)
    epochs = sorted({e for vals in values.values() for e in vals})
    splits = sorted({s for _, s in values})

    def key(n, s):
        return (*n, s) if isinstance(n, tuple) else (n, s)
    info = _table(epochs, {key(n, s): values.get((n, s), {}) for n in names
                           if not isinstance(n, tuple) for s in splits})
    metrics = _table(epochs, {key(n, s): values.get((n, s), {})
                              for n in names if isinstance(n, tuple)
                              for s in splits})

    f1_test = {c[1]: v for c, v in metrics.items()
               if c != 'epoch' and c[0] == 'F1' and c[2] == 'test'}
    means = {thr: np.nanmean(v) if np.isfinite(v).any() else np.nan
             for thr, v in f1_test.items()}
    if any(np.isfinite(m) for m in means.values()):
        best_thr = max((m, -i, thr) for i, (thr, m) in enumerate(
            means.items()) if np.isfinite(m))[2]
        for c, v in metrics.items():
            if c != 'epoch' and c[1] == best_thr:
                info[(c[0], c[2])] = v
    write_table(f'{metrics_dir}/loss_all_epochs.csv', info)
    write_table(f'{metrics_dir}/metrics_all_epochs.csv', metrics)
    return info, metrics


def get_all_epoch_data(exp_name, run, recreate=False,
                       use_prepend_ifavail=True):
    """A run's (loss_all_epochs, metrics_all_epochs) tables: the cached
    ones (the prepended ones when they exist and ``use_prepend_ifavail``),
    gathered anew when missing or with ``recreate`` (reference
    utils.py:133-152)."""
    run_dir = get_run_dir(f'{config.OUTPUT_DIR}/runs/{exp_name}/', run)
    info_fname = f'{run_dir}/metrics/loss_all_epochs.csv'
    metrics_fname = f'{run_dir}/metrics/metrics_all_epochs.csv'
    if use_prepend_ifavail:
        p_info = info_fname.replace('.csv', '_prepend.csv')
        if os.path.exists(p_info):
            info_fname = p_info
            metrics_fname = metrics_fname.replace('.csv', '_prepend.csv')
    if not os.path.exists(info_fname) or recreate:
        create_all_epochs_info(f'{run_dir}/metrics/')
    return read_table(info_fname), read_table(metrics_fname)


def _until(table, until_e):
    keep = table['epoch'] <= until_e
    return {k: v[keep] for k, v in table.items()}


def _concat(a, b):
    """Rows of ``a`` then ``b``, columns in first-appearance order."""
    na, nb = len(a['epoch']), len(b['epoch'])
    out = {}
    for k in list(a) + [k for k in b if k not in a]:
        out[k] = np.concatenate([a.get(k, np.full(na, np.nan)),
                                 b.get(k, np.full(nb, np.nan))])
    return out


def prepend_prev_run(exp_name, older_run, newer_run, older_run_until_e=None,
                     newer_run_until_e=None):
    """Put an older run's epoch history in front of a newer run's, whose
    epochs are shifted to follow it, as the newer run's
    ``*_all_epochs_prepend.csv`` (reference utils.py:154-181)."""
    print(f'Prepending {older_run} to {newer_run} (<= output).')
    run_dir = get_run_dir(f'{config.OUTPUT_DIR}/runs/{exp_name}/', newer_run)
    tables = []
    for run, until_e in ((older_run, older_run_until_e),
                         (newer_run, newer_run_until_e)):
        info, metrics = get_all_epoch_data(exp_name, run,
                                           use_prepend_ifavail=False)
        if until_e:
            info, metrics = _until(info, until_e), _until(metrics, until_e)
        tables.append((info, metrics))
    (old_info, old_metrics), (info, metrics) = tables
    shift = old_info['epoch'][-1] + 1
    info = dict(info, epoch=info['epoch'] + shift)
    metrics = dict(metrics, epoch=metrics['epoch'] + shift)
    write_table(f'{run_dir}/metrics/loss_all_epochs_prepend.csv',
                _concat(old_info, info))
    write_table(f'{run_dir}/metrics/metrics_all_epochs_prepend.csv',
                _concat(old_metrics, metrics))
