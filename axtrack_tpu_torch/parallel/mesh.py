"""The device mesh of the serving path, and the threads that drive it.

PyTorch counterpart of the serving part of ``axtrack_tpu/parallel/mesh.py``
(``make_mesh``, ``replicate``). The JAX package is single-controller: one
call in one process returns the whole result while XLA runs the shards. The
port keeps that contract without ``torch.distributed``: one process drives a
grid of devices, one host thread a data shard (``run_shards``). Each thread
enters its device and runs on the launching thread's current stream of
that device, which is idle while the launching thread waits for the
shards: one card's host syncs (a certificate read, an NMS count) stall
only its shards, and a card's shards allocate from the pool the single
path allocates from (a new stream would keep a pool of its own beside the
cached one, and a deployed-size movie then runs the card out of memory).

A device may appear more than once in a mesh. That is the port's
counterpart of XLA's forced host device count: the CPU tests run 2, 4 and 8
shards on ``[torch.device('cpu')] * n``, and one card runs several logical
shards, each launching its kernels as a shard of a multi-card run would.
It is a means of testing, not a feature of serving. Shards of one device
share its stream and take turns under its ``device_lock`` while they hold
a CNN group, so the card holds one group's frames and activations at a
time, as it does for the single path.

The tensor-parallel layouts (partition specs, ``shard_params``,
``shard_batch``, the constrain helpers, ``sharded_inference_fn``,
``distribute_state``) belong to the training half and are not here yet
(ROADMAP M14b).
"""
import copy
import threading

import numpy as np
import torch


class Mesh:
    """A [n_data, n_model] grid of ``torch.device``s with the JAX mesh's
    axis names: ``shape`` is {'data': n_data, 'model': n_model}. The serving
    path runs one shard a data row, on the row's first device."""

    def __init__(self, devices):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2 or self.devices.size == 0:
            raise ValueError('a mesh is a non-empty [n_data, n_model] grid '
                             'of devices')
        self.shape = {'data': self.devices.shape[0],
                      'model': self.devices.shape[1]}

    @property
    def data_devices(self):
        """The device of each data shard, in shard order."""
        return [self.devices[i, 0] for i in range(self.shape['data'])]


def make_mesh(n_data=None, n_model=None, devices=None):
    """A ('data', 'model') mesh over ``devices`` (JAX ``make_mesh``'s rule:
    ``n_model`` defaults to 2 on an even count above 1, else 1, and
    ``n_data`` to what is left). Without ``devices``, every CUDA device;
    without a card that raises, as the port's entry points do."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'make_mesh() takes every CUDA device and none is available; '
                "pass devices=[torch.device('cpu')] * n to run on the CPU")
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_model is None:
        n_model = 2 if n % 2 == 0 and n > 1 else 1
    if n_data is None:
        n_data = n // n_model
    if n_data < 1 or n_data * n_model > n:
        raise ValueError(f'a {n_data} x {n_model} mesh needs '
                         f'{n_data * n_model} devices, got {n}')
    grid = np.empty((n_data, n_model), dtype=object)
    for i in range(n_data):
        for j in range(n_model):
            grid[i, j] = devices[i * n_model + j]
    return Mesh(grid)


def replicate(model, mesh):
    """One copy of ``model`` a data shard, on the shard's device
    (``copy.deepcopy(model).to(dev)``, in eval mode); the caller's model
    is not moved. A detector that is not an ``nn.Module`` (a callable
    oracle ``f(t, X) -> grid``) holds no weights and is shared."""
    if not isinstance(model, torch.nn.Module):
        return [model] * mesh.shape['data']
    return [copy.deepcopy(model).to(dev).eval()
            for dev in mesh.data_devices]


_LOCKS = {}
_LOCKS_GUARD = threading.Lock()


def device_lock(device):
    """The process's lock of ``device``, held by a shard's thread while it
    reads, tiles and detects a CNN group there (``longmovie.block_grids``),
    so shards that share the device take turns."""
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(torch.device(device), threading.Lock())


class DeviceThread(threading.Thread):
    """``fn(*args)`` on a host thread of its own, under ``torch.no_grad``;
    on a card inside ``torch.cuda.device(device)`` and on ``stream`` (by
    default a new stream of that device), which first waits for the work
    the launching thread had queued on the device when the thread was
    made. The stream is synchronized before the thread lets go of ``fn``
    and its arguments, so no tensor the thread used goes back to the
    caching allocator while the stream still reads it. ``result()`` joins
    and returns ``fn``'s result, or raises its exception."""

    def __init__(self, fn, device, *args, stream=None):
        super().__init__()
        self.device = torch.device(device)
        self._fn, self._args = fn, args
        self._result = self._error = None
        self._ready = None
        self._stream = stream
        if self.device.type == 'cuda':
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self.device))

    def run(self):
        try:
            with torch.no_grad():
                if self._ready is None:
                    self._result = self._fn(*self._args)
                    return
                with torch.cuda.device(self.device):
                    stream = (self._stream if self._stream is not None
                              else torch.cuda.Stream(self.device))
                    stream.wait_event(self._ready)
                    try:
                        with torch.cuda.stream(stream):
                            self._result = self._fn(*self._args)
                    finally:
                        stream.synchronize()
        except BaseException as e:          # re-raised by result()
            self._error = e
        finally:
            self._fn = self._args = self._stream = None

    def result(self):
        self.join()
        if self._error is not None:
            raise self._error
        return self._result


def run_shards(fn, devices):
    """``fn(i, devices[i])`` for every shard i at once, one
    ``DeviceThread`` each, on a card the launching thread's current stream
    of it (module docstring). Waits for all of them, then returns their
    results in shard order, or raises the first failing shard's
    exception."""
    threads = [DeviceThread(fn, dev, i, dev, stream=(
        torch.cuda.current_stream(dev) if torch.device(dev).type == 'cuda'
        else None)) for i, dev in enumerate(devices)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [t.result() for t in threads]
