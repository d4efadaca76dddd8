"""Chamfer kernel K1 for Hopper, and the host side around it.

Counterpart of ``axtrack_tpu/ops/geodesic_pallas.py``. The kernel itself
is ``csrc/chamfer.cu`` (CUDA C++ for sm_90a, plain C interface): nvcc builds
it into ``_build/`` at first use and ``ctypes`` loads it. It reads the
window-padded mask bit-packed once (``pack_mask``), gathers each window's
rows itself and returns the maps with a per-window exactness certificate.
``chamfer_windows`` is the one entry: CUDA tensors launch the kernel, CPU
tensors run the plain version ``chamfer_windows_plain`` (``crops_for`` +
``geodesic.chamfer_plain`` + ``_window_consistent``); there is no fallback
from one to the other.

The host helpers keep the JAX package's contracts: sources are padded to a
bucketed count (``src_bucket``, ``_pad_srcs``), each source's window has
its own cell forced passable, and the certificate says whether a set of
maps is exact, so a caller may run few sweeps and continue (doubling) only
when it fails (``batched_windows_converged``).
"""
import ctypes
import os
import shutil
import subprocess
import threading
import warnings

import torch

from .geodesic import INF, window_origins, crops_for, chamfer_plain
from ..utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, 'csrc', 'chamfer.cu')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

SRC_BLOCK = 16


def _nvcc(source):
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError(f'nvcc not found: {source} is built on the machine '
                       'with the GPU')


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
    proc = subprocess.run([_nvcc(source), *NVCC_FLAGS, '-o', tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source}:\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib, proc.stderr


def pack_mask(passable_padded):
    """Bit-pack the window-padded bool mask [Hp, Wp]: bit c % 32 of word
    c // 32 of a row is column c. Rows are padded to whole words plus one
    spare word, so the kernel's two-word read at any column < Wp stays in
    its row. Returns (int32 [Hp, row_words], row_words)."""
    Hp, Wp = passable_padded.shape
    row_words = -(-Wp // 32) + 1
    dev = passable_padded.device
    cells = torch.zeros((Hp, row_words * 32), dtype=torch.int64, device=dev)
    cells[:, :Wp] = passable_padded.to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dev),
        torch.arange(32, dtype=torch.int64, device=dev))
    words = (cells.view(Hp, row_words, 32) * weights).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).contiguous(), row_words


def unpack_mask(mask_bits, row_words):
    """bool [Hp, 32 * row_words] from ``pack_mask``'s words."""
    words = mask_bits.to(torch.int64).reshape(-1, row_words, 1) & 0xffffffff
    shifts = torch.arange(32, dtype=torch.int64, device=mask_bits.device)
    return ((words >> shifts) & 1).bool().reshape(words.shape[0], -1)


def default_warps_per_window(window):
    """Warps that share one window in K1: 4 cells a thread up to 512
    columns, 8 at 1024 (csrc/chamfer.cu)."""
    return min(4, max(1, window // 128))


def blocks_per_sm(bands, warps_per_window, n_sms):
    """How many of K1's blocks may share an SM (1, 2 or 4): the fewest for
    which the bands' total rows, spread over the SMs' windows, take no
    longer than the longest band (the windows start longest first). One
    small device-to-host copy."""
    rows = (bands[:, 1] - bands[:, 0] + 1).clamp_min(0)
    longest, total = profiling.to_host(
        torch.stack([rows.max(), rows.sum()])).tolist()
    per_block = 4 // warps_per_window
    for k in (1, 2):
        if total <= longest * n_sms * k * per_block:
            return k
    return 4


class Library:
    """The nvcc build of a kernel source (``build``), loaded with ctypes
    once, at the first ``get()``; ``bind(lib)`` declares its functions'
    argument and result types."""

    def __init__(self, source, bind):
        self.source, self.bind = source, bind
        self._lib = None
        self._lock = threading.Lock()

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build(self.source)[0])
                self.bind(lib)
                self._lib = lib
        return self._lib


def _bind_chamfer(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.axt_chamfer_bands.argtypes = [P, I, I, P, P, P, I, I, P]
    lib.axt_chamfer.argtypes = [P, I, I] + [P] * 7 + [I] * 5 + [P]
    lib.axt_chamfer_bands.restype = I
    lib.axt_chamfer.restype = I


_library = Library(SOURCE, _bind_chamfer)


def _check_windows(mask_bits, row_words, origins, local, window):
    if not mask_bits.is_cuda:
        raise ValueError('K1 takes CUDA tensors; use chamfer_windows()')
    if (mask_bits.dtype != torch.int32 or mask_bits.ndim != 2
            or mask_bits.shape[1] != row_words or row_words < 2
            or not mask_bits.is_contiguous()):
        raise ValueError(f'mask_bits must be a contiguous int32 [H, '
                         f'{row_words}] tensor, got {mask_bits.dtype} '
                         f'{tuple(mask_bits.shape)}')
    W = int(window)
    if W % 8 or not 8 <= W <= 1024:
        raise ValueError(f'window must be a multiple of 8 and at most 1024, '
                         f'got {W}')
    N = origins.shape[0] if origins.ndim == 2 else -1
    for name, t in (('origins', origins), ('local', local)):
        if (t.device != mask_bits.device or t.dtype != torch.int32
                or tuple(t.shape) != (N, 2) or not t.is_contiguous()):
            raise ValueError(f'{name} must be a contiguous int32 [N, 2] '
                             f'tensor on the mask device')
    return N, W


class LaunchCounter:
    """``launches``: the launches of a kernel wrapper, counted by
    ``_count`` at the launch and nowhere else. Threads (the shards of a
    mesh, an eager association) launch at once, so the count takes a lock,
    and each thread also keeps its own count (``thread_launches``)."""

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _count(self):
        with self._lock:
            self.launches += 1
        self._local.launches = self.thread_launches() + 1

    def thread_launches(self):
        """The launches the calling thread has made."""
        return getattr(self._local, 'launches', 0)


class ChamferBandsKernel(LaunchCounter):
    """ctypes binding of ``axt_chamfer_bands`` (K1's band pass): int32
    [N, 2] first and last row of each window holding a passable cell, or
    (W, -1), with its launch count."""

    def __call__(self, mask_bits, row_words, origins, local, window):
        N, W = _check_windows(mask_bits, row_words, origins, local, window)
        bands = torch.empty((N, 2), dtype=torch.int32,
                            device=mask_bits.device)
        if N == 0:
            return bands
        lib = _library.get()
        with torch.cuda.device(mask_bits.device):
            err = lib.axt_chamfer_bands(
                mask_bits.data_ptr(), row_words, mask_bits.shape[0],
                origins.data_ptr(), local.data_ptr(), bands.data_ptr(), N, W,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f'chamfer band kernel launch failed: CUDA '
                                   f'error {err}')
            self._count()
        return bands


class ChamferKernel(LaunchCounter):
    """ctypes binding of ``axt_chamfer`` (K1) with a launch counter
    (``LaunchCounter``). When ``events`` is a list,
    each call appends a (start, end) pair of CUDA events around its band
    pass and its sweeps, so a caller can time K1 inside a larger stage."""

    def __init__(self, bands_kernel):
        super().__init__()
        self.events = None
        self.bands_kernel = bands_kernel

    def __call__(self, mask_bits, row_words, origins, local, window, sweeps,
                 init=None, warps_per_window=None):
        """K1 on the card: (maps f32 [N, W, W], ok int32 [N]); see
        ``chamfer_windows_plain`` for the arguments. Its band pass runs
        first; the windows then start longest band first."""
        N, W = _check_windows(mask_bits, row_words, origins, local, window)
        dev = mask_bits.device
        if init is not None and (
                init.device != dev or init.dtype != torch.float32
                or tuple(init.shape) != (N, W, W)
                or not init.is_contiguous() or init.data_ptr() % 16):
            raise ValueError('init must be a contiguous, 16-byte aligned f32 '
                             '[N, W, W] tensor on the mask device')
        if int(sweeps) < 1:
            raise ValueError('sweeps must be >= 1')
        wpw = (default_warps_per_window(W) if warps_per_window is None
               else int(warps_per_window))
        if wpw not in (1, 2, 4):
            raise ValueError('warps_per_window must be 1, 2 or 4')
        out = torch.empty((N, W, W), dtype=torch.float32, device=dev)
        ok = torch.empty((N,), dtype=torch.int32, device=dev)
        if N == 0:
            return out, ok
        lib = _library.get()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            if self.events is not None:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record(stream)
            bands = self.bands_kernel(mask_bits, row_words, origins, local, W)
            order = torch.argsort(bands[:, 0] - bands[:, 1], stable=True)
            order = order.to(torch.int32)
            k = blocks_per_sm(bands, wpw, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            err = lib.axt_chamfer(
                mask_bits.data_ptr(), row_words, mask_bits.shape[0],
                origins.data_ptr(), local.data_ptr(), order.data_ptr(),
                bands.data_ptr(),
                init.data_ptr() if init is not None else None,
                out.data_ptr(), ok.data_ptr(), N, W, int(sweeps), wpw, k,
                stream.cuda_stream)
            if err != 0:
                raise RuntimeError(f'chamfer kernel launch failed: CUDA '
                                   f'error {err}')
            self._count()
            if self.events is not None:
                ev[1].record(stream)
                self.events.append(ev)
        return out, ok


chamfer_bands_kernel = ChamferBandsKernel()
chamfer_kernel = ChamferKernel(chamfer_bands_kernel)


def chamfer_windows_plain(mask_bits, row_words, origins, local, window,
                          sweeps, init=None):
    """Plain version of K1 (``chamfer_kernel``), with the same arguments
    and results.

    mask_bits, row_words: the padded mask from ``pack_mask``; origins,
      local: int [N, 2] window origins in the padded mask and source (y, x)
      in each window (a source outside its window seeds nothing);
      init: optional f32 [N, W, W] maps to CONTINUE from.
    Returns (maps f32 [N, W, W] after ``sweeps`` sweeps, ok int32 [N]: 1
    where the window's maps pass the exactness certificate)."""
    passable = unpack_mask(mask_bits, row_words)
    crops = crops_for(passable, origins.long(), local.long(), window)
    maps = chamfer_plain(crops, local, sweeps, init)
    return maps, _window_consistent(maps, crops).to(torch.int32)


def window_bands_plain(mask_bits, row_words, origins, local, window):
    """Plain version of K1's band pass (``chamfer_bands_kernel``): int32
    [N, 2] first and last row of each window that holds a passable cell
    (the source cell forced), (W, -1) when none does
    (``axtrack_tpu``'s ``_window_bands``)."""
    passable = unpack_mask(mask_bits, row_words)
    crops = crops_for(passable, origins.long(), local.long(), window)
    rows = crops.any(dim=2)
    idx = torch.arange(window, device=crops.device)
    lo = torch.where(rows, idx, window).amin(dim=1)
    hi = torch.where(rows, idx, -1).amax(dim=1)
    return torch.stack([lo, hi], -1).to(torch.int32)


def chamfer_windows(mask_bits, row_words, origins, local, window, sweeps,
                    init=None):
    """K1 on CUDA tensors, its plain version on CPU tensors: (maps, ok)."""
    if mask_bits.is_cuda:
        return chamfer_kernel(mask_bits, row_words,
                              origins.to(torch.int32).contiguous(),
                              local.to(torch.int32).contiguous(), window,
                              sweeps,
                              None if init is None else init.contiguous())
    return chamfer_windows_plain(mask_bits, row_words, origins, local, window,
                                 sweeps, init)


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


def _window_consistent(dmaps, crops):
    """Exactness certificate for chamfer maps, per window (``axtrack_tpu``'s
    ``_locally_consistent`` without the final all): the maps are upper
    bounds by construction, so if every passable cell satisfies
    d <= min(4-neighbour d) + 1 they are the exact geodesic distances.
    Returns bool [N]."""
    nb = torch.full_like(dmaps, INF)
    torch.minimum(nb[:, 1:], dmaps[:, :-1], out=nb[:, 1:])
    torch.minimum(nb[:, :-1], dmaps[:, 1:], out=nb[:, :-1])
    torch.minimum(nb[:, :, 1:], dmaps[:, :, :-1], out=nb[:, :, 1:])
    torch.minimum(nb[:, :, :-1], dmaps[:, :, 1:], out=nb[:, :, :-1])
    bad = crops.to(torch.bool) & (dmaps > nb + 1.5) & (dmaps > 0.5)
    return ~bad.flatten(1).any(dim=1)


def _locally_consistent(dmaps, crops):
    """The certificate of a set of maps: a 0-dim bool tensor."""
    return _window_consistent(dmaps, crops).all()


def batched_windows_probed(passable_padded, srcs_yx, window, max_sweeps=1,
                           bits=None):
    """``max_sweeps`` sweeps of K1 plus the exactness certificate of the N
    real maps. ``bits`` is ``pack_mask(passable_padded)`` when the caller
    keeps it. Returns (dmaps f32[N, W, W], origins[N, 2], converged).

    ``converged`` holds only when every real window's flag is 1: K1 flags
    a window whose origin leaves the bitmap with -1 (its maps are INF),
    and that counts as not certified."""
    N, Np, origins, local = _pad_srcs(passable_padded, srcs_yx, window)
    bits = pack_mask(passable_padded) if bits is None else bits
    dmaps, ok = chamfer_windows(*bits, origins, local, window, max_sweeps)
    return dmaps[:N], origins[:N], (ok[:N] == 1).all()


def _continue_windows(passable_padded, srcs_yx, dmaps, window, sweeps,
                      bits=None):
    """``sweeps`` more sweeps from earlier maps. Returns (dmaps, converged),
    ``converged`` as in ``batched_windows_probed`` (a -1 flag fails it)."""
    N, Np, origins, local = _pad_srcs(passable_padded, srcs_yx, window)
    bits = pack_mask(passable_padded) if bits is None else bits
    init = torch.cat([dmaps, dmaps.new_full((Np - N, window, window), INF)])
    out, ok = chamfer_windows(*bits, origins, local, window, sweeps, init)
    return out[:N], (ok[:N] == 1).all()


def batched_windows_converged(passable_padded, srcs_yx, window,
                              max_sweeps=8, max_total_sweeps=512, bits=None):
    """Distance maps with an exactness guarantee: run ``max_sweeps``
    sweeps, certify, and while the certificate fails CONTINUE from the
    current maps with a doubled budget (``axtrack_tpu``'s
    ``batched_windows_converged``, geodesic_pallas.py:403-437)."""
    bits = pack_mask(passable_padded) if bits is None else bits
    dmaps, origins, converged = batched_windows_probed(
        passable_padded, srcs_yx, window, max_sweeps=max_sweeps, bits=bits)
    total = max_sweeps
    while True:
        if bool(profiling.to_host(converged)):
            return dmaps, origins
        if total >= max_total_sweeps:
            warnings.warn(
                f'geodesic chamfer not converged after {total} sweeps; '
                f'distances may be over-reported on this mask')
            return dmaps, origins
        dmaps, converged = _continue_windows(passable_padded, srcs_yx,
                                             dmaps, window, total, bits)
        total *= 2
