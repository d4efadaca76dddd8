"""Chamfer kernel K1 for Hopper, and the host side around it.

Counterpart of ``axtrack_tpu/ops/geodesic_pallas.py``. The kernel itself
is ``csrc/chamfer.cu`` (CUDA C++ for sm_90a, plain C interface): nvcc builds
it into ``_build/`` at first use and ``ctypes`` loads it. ``chamfer`` is
the one entry: CUDA tensors launch the kernel, CPU tensors run the plain
version ``geodesic.chamfer_plain``; there is no fallback from one to the
other.

The host helpers keep the JAX package's contracts: sources are padded to a
bucketed count (``src_bucket``, ``_pad_srcs``), each source gets the crop of
the window-padded mask around it with its own cell forced passable
(``geodesic.crops_for``), and ``_locally_consistent`` certifies that a set
of maps is exact, so a caller may run few sweeps and continue (doubling)
only when the certificate fails (``batched_windows_converged``).
"""
import ctypes
import os
import shutil
import subprocess
import threading
import warnings

import torch

from .geodesic import INF, window_origins, crops_for, chamfer_plain

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, 'csrc', 'chamfer.cu')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

SRC_BLOCK = 16


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the chamfer kernel is built from '
                       f'{SOURCE} on the machine with the GPU')


def build(source=SOURCE, build_dir=BUILD_DIR):
    """Compile ``source`` with nvcc into ``build_dir`` unless an up-to-date
    library is there. Returns (library path, nvcc's report or '')."""
    name = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(build_dir, f'lib{name}.so')
    if (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(source)):
        return lib, ''
    os.makedirs(build_dir, exist_ok=True)
    tmp = f'{lib}.{os.getpid()}.tmp'
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source}:\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib, proc.stderr


class ChamferKernel:
    """ctypes binding of ``axt_chamfer`` with a launch counter.

    ``launches`` counts the kernel launches this object made; it is
    incremented at the launch and nowhere else."""

    def __init__(self):
        self.launches = 0
        self.build_report = ''
        self._fn = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._fn is None:
                path, self.build_report = build()
                fn = ctypes.CDLL(path).axt_chamfer
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def __call__(self, crops, local, sweeps, init=None):
        if not crops.is_cuda:
            raise ValueError('ChamferKernel takes CUDA tensors; use chamfer()')
        dev = crops.device
        if crops.dtype not in (torch.uint8, torch.bool) or crops.ndim != 3:
            raise ValueError(f'crops must be uint8/bool [N, W, W], got '
                             f'{crops.dtype} {tuple(crops.shape)}')
        N, W, W2 = crops.shape
        if W != W2 or W % 8 or not 8 <= W <= 1024:
            raise ValueError(f'window must be square, a multiple of 8 and at '
                             f'most 1024, got {W}x{W2}')
        if not crops.is_contiguous():
            raise ValueError('crops must be contiguous')
        if (local.device != dev or local.dtype != torch.int32
                or tuple(local.shape) != (N, 2) or not local.is_contiguous()):
            raise ValueError('local must be a contiguous int32 [N, 2] tensor '
                             'on the crops device')
        if init is not None and (
                init.device != dev or init.dtype != torch.float32
                or tuple(init.shape) != (N, W, W)
                or not init.is_contiguous()):
            raise ValueError('init must be a contiguous f32 [N, W, W] tensor '
                             'on the crops device')
        if int(sweeps) < 1:
            raise ValueError('sweeps must be >= 1')
        for t in (crops, init):
            if t is not None and t.data_ptr() % 16:
                raise ValueError('crops/init must be 16-byte aligned')
        out = torch.empty((N, W, W), dtype=torch.float32, device=dev)
        if N == 0:
            return out
        fn = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(crops.data_ptr(), local.data_ptr(),
                     init.data_ptr() if init is not None else None,
                     out.data_ptr(), N, W, int(sweeps), stream)
        if err != 0:
            raise RuntimeError(f'chamfer kernel launch failed: CUDA error '
                               f'{err}')
        self.launches += 1
        return out


chamfer_kernel = ChamferKernel()


def chamfer(crops, local, sweeps, init=None):
    """``sweeps`` chamfer sweeps per window: f32 [N, W, W] step distances.

    CUDA tensors launch K1 (``chamfer_kernel``); CPU tensors run the plain
    version. See ``geodesic.chamfer_plain`` for the arguments."""
    if crops.is_cuda:
        return chamfer_kernel(crops.contiguous().view(torch.uint8),
                              local.to(torch.int32).contiguous(), sweeps,
                              None if init is None else init.contiguous())
    return chamfer_plain(crops, local, sweeps, init)


def _src_block(window):
    """The JAX kernel's sources-per-program, kept for the bucket sizes."""
    if window <= 512:
        return SRC_BLOCK
    blk = max(1, (SRC_BLOCK * 512 * 512) // (window * window))
    while blk & (blk - 1):
        blk &= blk - 1
    return blk


def src_bucket(n, window):
    """Padded source-count bucket for ``n`` real sources: a power of two
    below 128, then multiples of 64 (``axtrack_tpu``'s buckets)."""
    np_ = _src_block(window)
    while np_ < n:
        np_ *= 2
    if np_ > 128:
        np_ = -(-n // 64) * 64
    return np_


def _pad_srcs(passable_padded, srcs_yx, window):
    """Pad sources with (0, 0) to the bucketed count and derive the crop
    origins and local source coordinates. Returns (N, Np, origins, local)."""
    Hp, Wp = passable_padded.shape
    srcs = torch.as_tensor(srcs_yx, device=passable_padded.device)
    srcs = srcs.to(torch.int64).reshape(-1, 2)
    N = srcs.shape[0]
    Np = src_bucket(N, window)
    srcs_p = torch.cat([srcs, srcs.new_zeros((Np - N, 2))])
    origins, local = window_origins(srcs_p, window, Hp, Wp)
    return N, Np, origins, local


def _locally_consistent(dmaps, crops):
    """Exactness certificate for chamfer maps (``axtrack_tpu``'s
    ``_locally_consistent``): the maps are upper bounds by construction, so
    if every passable cell satisfies d <= min(4-neighbour d) + 1 they are
    the exact geodesic distances. Returns a 0-dim bool tensor."""
    nb = torch.full_like(dmaps, INF)
    torch.minimum(nb[:, 1:], dmaps[:, :-1], out=nb[:, 1:])
    torch.minimum(nb[:, :-1], dmaps[:, 1:], out=nb[:, :-1])
    torch.minimum(nb[:, :, 1:], dmaps[:, :, :-1], out=nb[:, :, 1:])
    torch.minimum(nb[:, :, :-1], dmaps[:, :, 1:], out=nb[:, :, :-1])
    bad = crops.to(torch.bool) & (dmaps > nb + 1.5) & (dmaps > 0.5)
    return ~bad.any()


def batched_windows_probed(passable_padded, srcs_yx, window, max_sweeps=1):
    """``max_sweeps`` sweeps of K1 plus the exactness certificate of the N
    real maps. Returns (dmaps f32[N, W, W], origins[N, 2], converged)."""
    N, Np, origins, local = _pad_srcs(passable_padded, srcs_yx, window)
    crops = crops_for(passable_padded, origins, local, window)
    dmaps = chamfer(crops, local, max_sweeps)
    converged = _locally_consistent(dmaps[:N], crops[:N])
    return dmaps[:N], origins[:N], converged


def _continue_windows(passable_padded, srcs_yx, dmaps, window, sweeps):
    """``sweeps`` more sweeps from earlier maps. Returns (dmaps, converged)."""
    N, Np, origins, local = _pad_srcs(passable_padded, srcs_yx, window)
    crops = crops_for(passable_padded, origins, local, window)
    init = torch.cat([dmaps, dmaps.new_full((Np - N, window, window), INF)])
    out = chamfer(crops, local, sweeps, init=init)
    return out[:N], _locally_consistent(out[:N], crops[:N])


def batched_windows_converged(passable_padded, srcs_yx, window,
                              max_sweeps=8, max_total_sweeps=512):
    """Distance maps with an exactness guarantee: run ``max_sweeps``
    sweeps, certify, and while the certificate fails CONTINUE from the
    current maps with a doubled budget (``axtrack_tpu``'s
    ``batched_windows_converged``, geodesic_pallas.py:403-437)."""
    dmaps, origins, converged = batched_windows_probed(
        passable_padded, srcs_yx, window, max_sweeps=max_sweeps)
    total = max_sweeps
    while True:
        if bool(converged):
            return dmaps, origins
        if total >= max_total_sweeps:
            warnings.warn(
                f'geodesic chamfer not converged after {total} sweeps; '
                f'distances may be over-reported on this mask')
            return dmaps, origins
        dmaps, converged = _continue_windows(passable_padded, srcs_yx,
                                             dmaps, window, total)
        total *= 2
