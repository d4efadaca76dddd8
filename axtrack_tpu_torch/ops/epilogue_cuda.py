"""The conv-block epilogue for Hopper, and its plain version.

A conv-spec block of the detector (``models/yolo.py``: ``CNNBlock``) ends
in the conv bias, BatchNorm, the leaky ReLU and, where the spec's next
entry is 'M', a 2x2 max-pool. In eval mode these are one pass over the
convolution's output: ``csrc/epilogue.cu`` (CUDA C++ for sm_90a, plain C
interface), built by nvcc into ``_build/`` at first use and loaded with
``ctypes`` as K1 is (``geodesic_cuda.build``, ``Library``).
``epilogue`` is the one entry: a CUDA tensor launches the kernel, a CPU
tensor runs ``epilogue_plain``; there is no fallback from one to the
other. Each launch counts on the wrapper (``epilogue_kernel.launches``)
and on the calling context's trace record (``epilogues``).
"""
import ctypes
import os

import torch
import torch.nn.functional as F

from .geodesic_cuda import Library, LaunchCounter
from ..utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, 'csrc', 'epilogue.cu')


def epilogue_plain(x, conv_bias, bn_weight, bn_bias, running_mean,
                   running_var, eps, negative_slope, pool):
    """The block's modules in order on ``x`` f32 [N, C, H, W], the
    convolution without its bias: the bias add, eval-mode ``batch_norm``,
    ``leaky_relu`` and, with ``pool``, ``max_pool2d(2, 2)``."""
    t = x + conv_bias[:, None, None]
    y = F.batch_norm(t, running_mean, running_var, bn_weight, bn_bias,
                     False, 0.0, eps)
    y = F.leaky_relu(y, negative_slope)
    return F.max_pool2d(y, 2, 2) if pool else y


def _bind(lib):
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.axt_epilogue.argtypes = [P] * 7 + [Fl, Fl] + [I] * 6 + [P]
    lib.axt_epilogue.restype = I


_library = Library(SOURCE, _bind)


class EpilogueKernel(LaunchCounter):
    """ctypes binding of ``axt_epilogue`` with its launch count
    (``LaunchCounter``); ``epilogue_plain``'s arguments and result."""

    def __call__(self, x, conv_bias, bn_weight, bn_bias, running_mean,
                 running_var, eps, negative_slope, pool):
        if not x.is_cuda:
            raise ValueError('the epilogue kernel takes CUDA tensors; use '
                             'epilogue()')
        if (x.dtype != torch.float32 or x.ndim != 4
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f'x must be a contiguous, 16-byte aligned f32 '
                             f'[N, C, H, W] tensor, got {x.dtype} '
                             f'{tuple(x.shape)} at {x.data_ptr():#x}')
        N, C, H, W = x.shape
        params = (conv_bias, bn_weight, bn_bias, running_mean, running_var)
        for p in params:
            if (p.device != x.device or p.dtype != torch.float32
                    or tuple(p.shape) != (C,) or not p.is_contiguous()):
                raise ValueError(f'each parameter must be a contiguous f32 '
                                 f'[{C}] tensor on {x.device}, got '
                                 f'{p.dtype} {tuple(p.shape)} on {p.device}')
        pool = bool(pool)
        vec = W % 4 == 0 if pool else (H * W) % 4 == 0      # as the kernel
        items = (H // 2) * (W // (4 if vec else 2)) if pool else (
            H * W // (4 if vec else 1))
        if N * items >= 2 ** 31:
            raise ValueError(f'{N} planes of {H}x{W} are more than the '
                             f'kernel indexes a channel')
        out = torch.empty((N, C, H // 2, W // 2) if pool else (N, C, H, W),
                          dtype=torch.float32, device=x.device)
        lib = _library.get()
        with torch.cuda.device(x.device):
            err = lib.axt_epilogue(
                x.data_ptr(), out.data_ptr(),
                *(p.data_ptr() for p in params), float(eps),
                float(negative_slope), N, C, H, W, int(pool),
                torch.cuda.get_device_properties(
                    x.device).multi_processor_count,
                torch.cuda.current_stream(x.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f'epilogue kernel launch failed: CUDA '
                                   f'error {err}')
            self._count()
            profiling.count('epilogues')
        return out


epilogue_kernel = EpilogueKernel()


def epilogue(x, conv_bias, bn_weight, bn_bias, running_mean, running_var,
             eps, negative_slope, pool):
    """The kernel on a CUDA tensor, ``epilogue_plain`` on a CPU tensor."""
    if x.is_cuda:
        return epilogue_kernel(x, conv_bias, bn_weight, bn_bias, running_mean,
                               running_var, eps, negative_slope, pool)
    return epilogue_plain(x, conv_bias, bn_weight, bn_bias, running_mean,
                          running_var, eps, negative_slope, pool)
