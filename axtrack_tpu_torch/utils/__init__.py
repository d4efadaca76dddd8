"""Infrastructure helpers (counterpart of ``axtrack_tpu/utils``): seeding,
the TF32 switch of f32 compute, matplotlib's TeX switch, the
standardization scaler of a bundle, the preprocessing samples of a run and
their reader, run directories and the tri-state stage cache."""
import contextlib
import csv
import pickle
import threading

import numpy as np
import torch

from .caching import StageCache  # noqa: F401
from .rundirs import create_logging_dirs, get_run_dir, clean_rundirs  # noqa: F401


def set_seed(seed):
    """Seed numpy's and torch's global generators (reference utils.py:73-76
    seeds torch+numpy). Components that draw random numbers take an
    explicit ``torch.Generator`` instead of relying on this."""
    np.random.seed(seed)
    torch.manual_seed(seed)


_tf32_lock = threading.Lock()
_tf32_holders = 0
_tf32_saved = None


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block.

    The switches are process-global while the block may be entered by
    several threads at once (one a shard of the mesh, or an eager
    association beside the next movie's detection). So the block holds a
    count: the first thread in saves the switches and turns TF32 off, the
    last one out restores them, and no thread inside ever sees TF32 on."""
    global _tf32_holders, _tf32_saved
    with _tf32_lock:
        if _tf32_holders == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_holders += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_holders -= 1
            if _tf32_holders == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved


def turn_tex(on_off):
    """Toggle TeX rendering in matplotlib (reference utils.py:320-325):
    'on' only where a latex binary exists, else nothing changes (and
    matplotlib is not imported)."""
    import shutil
    if on_off == 'on' and shutil.which('latex'):
        import matplotlib.pyplot as plt
        plt.rc('text', usetex=True)
        plt.rc('text.latex', preamble=r'\usepackage{amsmath} \usepackage{upgreek}'
                                      r' \usepackage{underscore}')
    elif on_off == 'off':
        import matplotlib.pyplot as plt
        plt.rc('text', usetex=False)


def get_data_standardization_scaler(fname):
    """Load a standardization scaler tuple ('zscore', (var, mean)).
    Supports the reference's pickle format (utils.py:346-349) and json."""
    if fname.endswith('.json'):
        import json
        with open(fname) as f:
            kind, scalers = json.load(f)
        return (kind, tuple(scalers) if scalers is not None else None)
    with open(fname, 'rb') as file:
        return pickle.load(file)


PREPROC_SAMPLES = int(1e6)


def save_preproc_metrics(dest_dir, dataset1, dataset2=None):
    """Sample PREPROC_SAMPLES pixels (with replacement) of the first and
    last frame after each captured preprocessing step to CSV, for
    distribution-shift checks (reference utils.py:90-110). The CSV has the
    JAX package's layout: three header rows (dataset, step, 't_0'/'t_-1'),
    then one row a sample led by its index. Returns the file name."""
    n = PREPROC_SAMPLES
    idx = np.random.default_rng().choice(
        dataset1.plot_data['Original'][0].size, n)
    cols, names = [], []
    for ds in [dataset1] + ([dataset2] if dataset2 is not None else []):
        for step, (first, last) in ds.plot_data.items():
            for frame, tag in ((first, 't_0'), (last, 't_-1')):
                cols.append(np.asarray(frame, np.float32).reshape(-1)[idx])
                names.append((ds.name, step, tag))
    fname = f'{dest_dir}/{dataset1.name}_preproc_data.csv'
    with open(fname, 'w', newline='') as f:
        header = csv.writer(f, lineterminator='\n')
        for level in range(3):
            header.writerow([''] + [nm[level] for nm in names])
        for lo in range(0, n, 2 ** 16):           # rows in chunks
            hi = min(lo + 2 ** 16, n)
            np.savetxt(f, np.column_stack([np.arange(lo, hi)]
                                          + [c[lo:hi] for c in cols]),
                       fmt=['%d'] + ['%.9g'] * len(cols), delimiter=',')
    return fname


def read_preproc_metrics(fname, datasets=None):
    """The samples of a ``save_preproc_metrics`` CSV as a dict (dataset,
    step, 't_0'|'t_-1') -> f32[n], in the file's column order; only the
    columns of ``datasets`` (names) when given."""
    with open(fname, newline='') as f:
        header = [next(csv.reader([f.readline()]))[1:] for _ in range(3)]
        names = list(zip(*header))
        cols = [i for i, nm in enumerate(names)
                if datasets is None or nm[0] in datasets]
        vals = np.loadtxt(f, delimiter=',', dtype=np.float32, ndmin=2,
                          usecols=[1 + i for i in cols])
    return {names[i]: vals[:, j] for j, i in enumerate(cols)}
