"""axtrack_tpu_torch — the PyTorch/CUDA port of ``axtrack_tpu/`` for
NVIDIA GPUs.

Same public surface as ``axtrack_tpu``, written in PyTorch, with the
chamfer geodesic kernel in CUDA C++ (``csrc/chamfer.cu``): inference
(setup_inference -> prepare_input_data -> inference -> IDed_dets_all ->
visualize_inference), training (``train.experiment.run_experiment`` ->
``deploy_run``), training-data preparation (``data.prep``) and run
evaluation (``evaluation``). The package imports no JAX and nothing of
``axtrack_tpu``; it runs on the GPU unless a caller passes
``device='cpu'`` or sets ``AXTRACK_DEVICE=cpu``.
"""
import importlib

# the public names resolve on first use (PEP 562), so a process that needs
# only the host tracking code (the MCF search's spawned workers) does not
# import torch
_LAZY = {name: '.interface' for name in (
    'setup_inference', 'prepare_input_data', 'inference', 'inference_many',
    'visualize_inference', 'deploy_run')}
_LAZY.update({name: '.config' for name in (
    'PKG_DIR', 'DEPLOYED_MODEL_DIR', 'OUTPUT_DIR', 'TRAINING_DATA_DIR',
    'DEFAULT_DEVICE', 'VIDEO_ENCODER', 'resolve_device')})
_LAZY['_compute_astar_path'] = '.utils.paths'

__all__ = list(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
    return getattr(importlib.import_module(_LAZY[name], __name__), name)
