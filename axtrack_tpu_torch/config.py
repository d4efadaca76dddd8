"""Global constants, paths and device resolution.

PyTorch counterpart of ``axtrack_tpu/config.py``. The bundle directory and
the data directories are the same; the device is a ``torch.device``.

Device policy: the port's entry points run on the GPU. ``'auto'`` (the
bundle's ``DEVICE``) means ``'cuda'``, and ``None`` means
``DEFAULT_DEVICE``: the ``AXTRACK_DEVICE`` environment variable, as in the
JAX package, else ``'auto'``. A caller that wants the CPU passes
``device='cpu'`` or sets ``AXTRACK_DEVICE=cpu``, as the tests do. Asking
for CUDA on a machine without a card raises instead of falling back.
"""
import os

import torch

PKG_DIR = os.path.abspath(os.path.dirname(__file__) + '/..')

_DATA_DIR = os.environ.get('AXTRACK_DATA_DIR', os.path.join(PKG_DIR, 'data'))
DEPLOYED_MODEL_DIR = os.environ.get(
    'AXTRACK_DEPLOYED_MODEL_DIR', os.path.join(PKG_DIR, 'deployed_model'))
TRAINING_DATA_DIR = os.path.join(_DATA_DIR, 'training_data')
OUTPUT_DIR = os.environ.get(
    'AXTRACK_OUTPUT_DIR', os.path.join(_DATA_DIR, 'model_output'))

DEFAULT_DEVICE = os.environ.get('AXTRACK_DEVICE', 'auto')
DEFAULT_NUM_WORKERS = 3

SPACER = '========================================================'


def resolve_device(device=None):
    """Map a device preference to a ``torch.device``.

    None -> DEFAULT_DEVICE; 'auto' -> 'cuda'. Any CUDA device raises
    RuntimeError when no card is present; the CPU is used only when asked
    for by name.
    """
    if device is None:
        device = DEFAULT_DEVICE
    if isinstance(device, torch.device):
        dev = device
    elif device == 'auto':
        dev = torch.device('cuda')
    else:
        dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'axtrack_tpu_torch runs on an NVIDIA GPU by default and none is '
            "available; pass device='cpu' to run on the CPU")
    return dev
