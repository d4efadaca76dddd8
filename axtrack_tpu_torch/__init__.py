"""axtrack_tpu_torch — the PyTorch/CUDA port of ``axtrack_tpu/`` for
NVIDIA GPUs.

Same public surface as ``axtrack_tpu``, written in PyTorch, with the
chamfer geodesic kernel in CUDA C++ (``csrc/chamfer.cu``): inference
(setup_inference -> prepare_input_data -> inference -> IDed_dets_all) and
training (``train.experiment.run_experiment`` -> ``deploy_run``). The
package imports no JAX and nothing of ``axtrack_tpu``; it runs on the GPU
unless a caller passes ``device='cpu'`` or sets ``AXTRACK_DEVICE=cpu``.
"""
from .interface import (setup_inference, prepare_input_data, inference,
                        inference_many, visualize_inference, deploy_run)
from .config import (PKG_DIR, DEPLOYED_MODEL_DIR, OUTPUT_DIR,
                     TRAINING_DATA_DIR, DEFAULT_DEVICE, resolve_device)

__all__ = ['setup_inference', 'prepare_input_data', 'inference',
           'inference_many', 'deploy_run', 'visualize_inference', 'PKG_DIR',
           'DEPLOYED_MODEL_DIR', 'OUTPUT_DIR', 'TRAINING_DATA_DIR',
           'DEFAULT_DEVICE', 'resolve_device']
