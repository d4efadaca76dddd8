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

# Video encoder: 'ffmpeg' if on PATH, else 'gif' (PIL)
VIDEO_ENCODER = 'ffmpeg' if any(
    os.access(os.path.join(p, 'ffmpeg'), os.X_OK)
    for p in os.environ.get('PATH', '').split(os.pathsep) if p) else 'gif'

SPACER = '========================================================'

# Train/test frame splits of the reference's merged training movie
# (reference config.py:19-23: 37, 80 and 210 frames)
WHOLE_DATASET_TRAIN_FRAMES = (list(range(2, 37 + 80 - 20 - 4))
                              + list(range(37 + 80 + 20 + 4, 37 + 80 + 210 - 2)))
WHOLE_DATASET_TEST_FRAMES = list(range(37 + 80 - 20, 37 + 80 + 20))
ALLTRAIN_DATASET_TRAIN_FRAMES = range(2, 37 + 80 + 210 - 2)
ALLTRAIN_DATASET_TEST_FRAMES = range(2, 6)

# Plot style (reference config.py:26-53)
TRAIN_Ps = {'linewidth': 3, 'alpha': .8, 'linestyle': ':'}
TEST_Ps = {'linewidth': 3, 'alpha': .8}
PREDICTED_BOXES_KWARGS = {'alpha': 1, 'linestyle': 'dashed', 'linewidth': 1,
                          'facecolor': 'none', 'edgecolor': 'hsv'}
GROUNDTRUTH_BOXES_KWARGS = {'alpha': .6, 'linestyle': 'solid',
                            'linewidth': 1.2, 'facecolor': 'none',
                            'edgecolor': 'white'}
FP_BOXES_KWARGS = {'alpha': .8, 'linestyle': 'solid', 'linewidth': 1,
                   'facecolor': 'none', 'edgecolor': 'orange'}
FN_BOXES_KWARGS = {'alpha': .8, 'linestyle': 'solid', 'linewidth': 1,
                   'facecolor': 'none', 'edgecolor': 'teal'}

FIGURE_FILETYPE = 'svg'
VIDEO_FILETYPE = 'mp4' if VIDEO_ENCODER == 'ffmpeg' else 'gif'
SMALL_FONTS = 14.5
FONTS = 18
SMALL_FIGSIZE = (4.5, 3.5)
MEDIUM_FIGSIZE = (5.6, 4.2)
LARGE_FIGSIZE = (14.6, 6.8)
BARPLOT_HEIGHT = 4.2

DARK_GRAY = '#6b6b6b'
GRAY = '#858585'
LIGHT_GRAY = '#cfcfcf'
DEFAULT_COLORS = ['#729C27', '#A85C2A', '#1B6C5C', '#892259', '#273673',
                  '#A0F40A', '#08C6A1', '#FF6B0B', '#E20A7C', '#2042CD']


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
