"""Infrastructure helpers (counterpart of ``axtrack_tpu/utils``): seeding,
the standardization scaler of a bundle, and the tri-state stage cache."""
import pickle

import numpy as np
import torch

from .caching import StageCache  # noqa: F401


def set_seed(seed):
    """Seed numpy's and torch's global generators (reference utils.py:73-76
    seeds torch+numpy). Components that draw random numbers take an
    explicit ``torch.Generator`` instead of relying on this."""
    np.random.seed(seed)
    torch.manual_seed(seed)


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
