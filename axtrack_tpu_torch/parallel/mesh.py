"""The device mesh: serving across shards, and training on a mesh.

PyTorch counterpart of ``axtrack_tpu/parallel/mesh.py``. The JAX package
is single-controller: one call in one process returns the whole result
while XLA runs the shards. The port keeps that contract without
``torch.distributed``: one process drives a grid of devices, one host
thread a data shard (``run_shards``). Each thread
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

Training on a mesh (``distribute_state``, then the engine's steps). XLA's
GSPMD runs one global batch; so does the mesh step here, in one process
and one autograd graph:

- the batch's rows are split over 'data' (``shard_batch``); a batch the
  axis does not divide stays whole on the first row, as JAX's
  ``dp_constrain`` leaves a remainder batch unsharded. Each data row runs
  the conv trunk on its first device, on a host thread of its own in the
  caller's grad mode (``MeshRows``);
- every BatchNorm in train mode takes its statistics over all rows
  (``CrossShardStats``, reached through ``models/yolo.BATCH_NORM_SYNC``):
  flax's mean and E[x^2] - mean^2, summed over the rows in row order by
  tensor ops, so gradients flow back through the sums;
- the hidden FC layers alternate column- and row-parallel over 'model'
  (``param_partition_spec``, ``shard_params``, ``ShardedLinear``); a
  row-parallel layer's partial products are summed in shard order on the
  row's first device. The output head, the convs and the BatchNorms are
  replicated: their one copy lives on the mesh's first device and reaches
  a row's device by ``.to`` (``replicate_put``), whose backward brings the
  gradients home;
- the rows' grids meet on the first device for the loss (a sum, divided
  by the global batch size), one ``backward()`` runs, and one optimizer
  step updates the sharded parameters where they live.

No collective blocks inside the backward: every cross-row sum is a node of
the one graph (autograd runs all of one device's backward on one thread,
and logical shards share their device). Across processes
(``parallel/multihost.py``) each process runs its own rows; the
BatchNorm sums cross processes by a differentiable all-reduce, each
process calls ``backward()`` on its own share of the loss, and the
gradients are all-reduced after it (``reduce_grads``).

JAX's three ``*_constrain`` helpers are XLA annotations with no eager
counterpart; their effects live here: ``dp_constrain``'s batch split is
``shard_batch`` inside the mesh step; ``frames_constrain``'s split of a
training chunk's preprocessing over 'data' and ``replicate_constrain``'s
one gather of the chunk's tiles are ``train/bigmovie.py``'s
``ChunkRows`` and ``assemble_chunk``, whose batches reach the mesh step
already split over the rows (a list, ``shard_batch``'s form).
"""
import copy
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch
from torch import nn

from ..models.yolo import BATCH_NORM_SYNC, SeededDropout, dtype_linear
from ..utils import profiling


class Mesh:
    """A [n_data, n_model] grid of ``torch.device``s with the JAX mesh's
    axis names: ``shape`` is {'data': n_data, 'model': n_model}. The serving
    path runs one shard a data row, on the row's first device.

    ``devices`` is this process's grid. A mesh over ``processes`` processes
    (``multihost.make_global_mesh``) holds global data rows
    ``process_index * n`` to ``process_index * n + n - 1`` here, so
    ``shape['data']`` counts the rows of every process; 'model' stays
    within a process."""

    def __init__(self, devices, processes=1, process_index=0):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2 or self.devices.size == 0:
            raise ValueError('a mesh is a non-empty [n_data, n_model] grid '
                             'of devices')
        self.processes, self.process_index = processes, process_index
        self.shape = {'data': self.devices.shape[0] * processes,
                      'model': self.devices.shape[1]}

    @property
    def data_devices(self):
        """The device of each of this process's data rows, in row order."""
        return [self.devices[i, 0] for i in range(self.devices.shape[0])]

    @property
    def primary(self):
        """The mesh's first device: a training run's datasets and the one
        copy of its replicated parameters live there."""
        return self.devices[0, 0]


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
        return [model] * len(mesh.data_devices)
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
    and returns ``fn``'s result, or raises its exception. ``trace``: the
    trace record (and parent span) the thread records into
    (``utils/profiling.current()``); by default the launching thread's at
    the time the thread is made."""

    def __init__(self, fn, device, *args, stream=None, trace=None):
        super().__init__()
        self.device = torch.device(device)
        self._fn, self._args = fn, args
        self._result = self._error = None
        self._ready = None
        self._stream = stream
        self._trace = profiling.current() if trace is None else trace
        if self.device.type == 'cuda':
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self.device))

    def run(self):
        try:
            with torch.no_grad(), profiling.attach(self._trace):
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
                        profiling.to_host(stream)
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


# ---------------------------------------------------------------- training

# seconds a data row waits for the others at a BatchNorm before the step
# fails (a row that dies releases them at once, ``CrossShardStats.abort``)
ROW_SYNC_TIMEOUT_S = 600.0


def same_device(a, b):
    """Whether two device specs name one device (``'cuda'`` is the
    current card; the CPU has one device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != 'cuda':
        return True
    cur = torch.cuda.current_device
    return ((a.index if a.index is not None else cur())
            == (b.index if b.index is not None else cur()))


class ShardedLinear(nn.Module):
    """An FC layer split over the mesh's 'model' axis. torch's weight is
    [out, in] where flax's kernel is [in, out]: a 'column' layer keeps
    block j of the output features (weight rows and bias) on model device
    j, a 'row' layer block j of the input features (weight columns), its
    bias whole on the first. Computes in ``dtype`` by ``dtype_linear``,
    as ``DtypeLinear`` does; it runs only inside a mesh step
    (``mesh_forward``), and ``gathered_model`` gives the single-device
    model."""

    def __init__(self, linear, layout, devices):
        super().__init__()
        if layout not in ('column', 'row'):
            raise ValueError(f'unknown layout {layout!r}')
        self.layout = layout
        self.dtype = getattr(linear, 'dtype', torch.float32)
        self.dim = 0 if layout == 'column' else 1

        def own(t, dev):
            return nn.Parameter(torch.empty(t.shape, dtype=t.dtype,
                                            device=dev).copy_(t))
        n = len(devices)
        w, b = linear.weight.detach(), linear.bias.detach()
        self.weight_shards = nn.ParameterList(
            own(c, d) for c, d in zip(w.chunk(n, self.dim), devices))
        if layout == 'column':
            self.bias_shards = nn.ParameterList(
                own(c, d) for c, d in zip(b.chunk(n), devices))
        else:
            self.bias = own(b, devices[0])

    def pieces(self):
        """(name, shards, dim) of the single-device layer's weight and
        bias."""
        bias = (list(self.bias_shards) if self.layout == 'column'
                else [self.bias])
        return [('weight', list(self.weight_shards), self.dim),
                ('bias', bias, 0)]


def linear_names(model):
    """Names of the model's FC layers in order, the output head last: the
    ``nn.Linear`` (or ``ShardedLinear``) modules of ``model.fcs``, which
    are flax's Dense_0, Dense_1, ..."""
    return [f'fcs.{i}' for i, m in enumerate(model.fcs)
            if isinstance(m, (nn.Linear, ShardedLinear))]


def param_partition_spec(name, shape, linear_order=()):
    """The JAX package's PartitionSpec of one parameter, as a tuple in
    flax's orientation ([in, out] for a kernel), from its state-dict name
    and torch shape. The hidden FC layers alternate column-parallel,
    (None, 'model'), and row-parallel, ('model', None), with a
    column-parallel bias ('model',); the output head, the convs and the
    BatchNorms are replicated, (). ``linear_order`` is
    ``linear_names(model)``: the position there, not the module index,
    decides the layout (JAX's ``param_partition_spec``)."""
    prefix = name.rpartition('.')[0]
    if prefix not in linear_order or len(shape) < 1:
        return ()
    pos = list(linear_order).index(prefix)
    if pos == len(linear_order) - 1:
        return ()                               # output head: replicated
    if len(shape) == 2 and min(shape) >= 2:
        return (None, 'model') if pos % 2 == 0 else ('model', None)
    if len(shape) == 1 and pos % 2 == 0 and shape[0] >= 2:
        return ('model',)
    return ()


def shard_params(model, mesh):
    """Split ``model``'s hidden FC layers over 'model' in place: each layer
    whose spec is column- or row-parallel and whose split dimension the
    axis divides becomes a ``ShardedLinear`` with its shards on
    ``mesh.devices[0]``; every other parameter is replicated (JAX's
    ``shard_params`` replicates what does not divide). Nothing is split on
    a 'model' axis of 1. Returns ``model``."""
    n = mesh.shape['model']
    order = linear_names(model)
    for prefix in order:
        idx = int(prefix.split('.')[1])
        lin = model.fcs[idx]
        if isinstance(lin, ShardedLinear):
            raise ValueError(f'{prefix} is split already')
        spec = param_partition_spec(f'{prefix}.weight', lin.weight.shape,
                                    order)
        if n == 1 or not spec:
            continue
        layout = 'column' if spec == (None, 'model') else 'row'
        if lin.weight.shape[0 if layout == 'column' else 1] % n:
            continue
        model.fcs[idx] = ShardedLinear(lin, layout, list(mesh.devices[0]))
    return model


def param_pieces(model):
    """(name, tensors, dim) for each parameter of the single-device model,
    in its ``named_parameters`` order: the tensors of ``model`` that hold
    it, the shards of a ``ShardedLinear`` joined along ``dim``."""
    out = []
    sharded = []
    for name, m in model.named_modules():
        if any(name.startswith(f'{s}.') for s in sharded):
            continue
        pre = f'{name}.' if name else ''
        if isinstance(m, ShardedLinear):
            sharded.append(name)
            out += [(pre + n, ts, dim) for n, ts, dim in m.pieces()]
        else:
            out += [(pre + n, [p], 0)
                    for n, p in m.named_parameters(recurse=False)]
    return out


def gathered_state_dict(model, device='cpu'):
    """The single-device state dict of ``model`` on ``device``: a
    ``ShardedLinear``'s shards put back together as ``weight`` and
    ``bias``."""
    pieces = param_pieces(model)
    sd = {name: torch.cat([t.detach().to(device) for t in ts], dim)
          for name, ts, dim in pieces}
    params = {id(t) for _, ts, _ in pieces for t in ts}
    for name, t in model.state_dict(keep_vars=True).items():
        if id(t) not in params:
            sd[name] = t.detach().to(device, copy=True)
    return sd


def gathered_model(model, P):
    """A single-device copy of a model ``shard_params`` split, on its first
    device, in eval mode (JAX's ``jax.device_get`` of the sharded params
    before the epoch's F1 sweep)."""
    from ..models.yolo import build_model
    dev = next(model.parameters()).device
    with torch.device('meta'):
        full = build_model(P, dtype=model.dtype, fc_dtype=model.fc_dtype)
    full.load_state_dict(gathered_state_dict(model, dev), assign=True)
    return full.eval()


def replicate_put(tensors, mesh):
    """One copy of ``tensors`` (a dict of them) a data row of this process,
    on the row's first device (JAX's ``replicate_put``). The copies are
    ``.to``, so gradients flow back, and a row on a tensor's device gets
    the tensor itself."""
    return [{k: t.to(dev) for k, t in tensors.items()}
            for dev in mesh.data_devices]


def batch_size(batch, mesh):
    """The global batch size of ``batch``: a tensor, or a list of the
    parts of this process's data rows (``shard_batch``'s form, one part a
    row, each 1 / n_data of the batch)."""
    if isinstance(batch, list):
        return batch[0].shape[0] * mesh.shape['data']
    return batch.shape[0]


def shard_batch(batch, mesh):
    """The rows of ``batch`` held by this process's data rows: a list with
    one part a row, on the row's first device. A batch whose size the
    'data' axis does not divide stays whole, on the first row (JAX's
    ``dp_constrain`` leaves a remainder batch unsharded). A list is a
    batch split so already (the chunked epoch gathers each row's part on
    the row's device) and is returned as it is."""
    if isinstance(batch, list):
        return batch
    B = batch.shape[0]
    if B % mesh.shape['data']:
        return [batch.to(mesh.primary)]
    b = B // mesh.shape['data']
    lo = mesh.process_index * len(mesh.data_devices)
    return [batch[(lo + i) * b:(lo + i + 1) * b].to(dev)
            for i, dev in enumerate(mesh.data_devices)]


class CrossShardStats:
    """BatchNorm statistics over every data row of one mesh step: flax's
    mean and E[x^2] - mean^2 of the whole batch.

    Each row's thread hands its per-channel sums in; the first row adds
    them in row order (then across processes, by a differentiable
    all-reduce over ``group``) and every row reads the total on its own
    device. All of it is tensor ops, so gradients flow back to each row
    through the sums in the step's one ``backward()``. The first row
    updates the running statistics with the global mean and biased
    variance. ``n_rows`` counts this process's rows, ``n_global`` the rows
    of all processes (each of the same size)."""

    def __init__(self, n_rows, n_global, group=None):
        self.n_rows, self.n_global, self.group = n_rows, n_global, group
        self._barrier = threading.Barrier(n_rows, timeout=ROW_SYNC_TIMEOUT_S)
        self._parts = [None] * n_rows
        self._total = None

    def abort(self):
        """Release the other rows of a failed one (they raise
        ``threading.BrokenBarrierError``)."""
        self._barrier.abort()

    def all_sum(self, row, t):
        """The sum of every row's ``t``, on ``t``'s device."""
        self._parts[row] = t
        self._barrier.wait()
        if row == 0:
            total = t
            for part in self._parts[1:]:
                total = total + part.to(t.device)
            if self.group is not None:
                import torch.distributed.nn.functional as dist_nn
                total = dist_nn.all_reduce(total, group=self.group)
            self._total = total
        self._barrier.wait()
        return self._total.to(t.device)

    def batch_norm(self, row, bn, x):
        """``bn`` (a ``FlaxBatchNorm2d`` in train mode) on row ``row``'s
        f32 input ``x`` [b, C, H, W]."""
        n = x.numel() // x.shape[1]
        sums = torch.stack([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3))])
        total = self.all_sum(row, sums)
        count = n * self.n_global
        mean = total[0] / count
        var = (total[1] / count - mean * mean).clamp_min(0.0)
        if row == 0:
            with torch.no_grad():
                bn.running_mean.lerp_(mean, bn.momentum)
                bn.running_var.lerp_(var, bn.momentum)
                bn.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + bn.bias[:, None, None])


class MeshRows:
    """What the data rows of mesh steps keep from one step to the next:
    row 0 runs on the calling thread and ``model.ConvNet`` itself; row i >
    0 on a host thread of its own, with a meta-device copy of the trunk
    (``replicas[i]``) that ``torch.func.functional_call`` fills with the
    parameters and buffers put on its device. The threads live as long as
    this object: PyTorch keeps its cuDNN execution plans per thread, so a
    new thread a step would plan every convolution of the forward again,
    on the host, each step."""

    def __init__(self):
        self.replicas = {}
        self._pool = None
        self._workers = 0

    def replica(self, i, trunk):
        """Row i's copy of ``trunk``, each of its modules in the train or
        eval mode of the trunk's at this call (one copy serves the train
        and the eval steps)."""
        if i not in self.replicas:
            self.replicas[i] = copy.deepcopy(trunk).to('meta')
        for mine, theirs in zip(self.replicas[i].modules(), trunk.modules()):
            mine.training = theirs.training
        return self.replicas[i]

    def run(self, fn, devices, abort=None):
        """``fn(i)`` for each data row i at once, each row's thread in the
        caller's grad mode and trace record, inside its row's card and on
        the caller's current stream of it (no sync: the caller's later work
        on that stream comes after). Waits for all rows, then returns their
        results in row order, or raises the first failing row's exception
        (a row released by ``abort``, called as soon as a row fails, only
        if no other row failed)."""
        if len(devices) == 1:
            return [fn(0)]
        if self._workers < len(devices) - 1:
            self.close()
            self._workers = len(devices) - 1
            self._pool = ThreadPoolExecutor(self._workers,
                                            thread_name_prefix='mesh-row')
        grad = torch.is_grad_enabled()
        trace = profiling.current()
        streams = [torch.cuda.current_stream(d) if d.type == 'cuda' else None
                   for d in devices]

        def body(i):
            try:
                with torch.set_grad_enabled(grad), profiling.attach(trace), (
                        torch.cuda.device(devices[i]) if streams[i] is not None
                        else nullcontext()), (
                        torch.cuda.stream(streams[i])
                        if streams[i] is not None else nullcontext()):
                    return fn(i)
            except BaseException:
                if abort is not None:
                    abort()
                raise
        futures = [self._pool.submit(body, i)
                   for i in range(1, len(devices))]
        out, errors = [None] * len(devices), [None] * len(devices)
        try:
            out[0] = body(0)
        except BaseException as e:          # re-raised below
            errors[0] = e
        for i, f in enumerate(futures, 1):
            try:
                out[i] = f.result()
            except BaseException as e:      # re-raised below
                errors[i] = e
        failed = [e for e in errors if e is not None]
        if failed:
            raise next((e for e in failed
                        if not isinstance(e, threading.BrokenBarrierError)),
                       failed[0])
        return out

    def close(self):
        """End the row threads."""
        if self._pool is not None:
            self._pool.shutdown()
        self._pool, self._workers = None, 0


def _fc_head(fcs, x, devices):
    """``fcs`` (Flatten, the FC spec's modules, the head) on one data row's
    features ``x``, the ``ShardedLinear`` layers over the row's model
    devices ``devices``. Between layers the activations are whole on the
    row's first device or split over the model devices (a list)."""
    d0 = devices[0]
    parts = None

    def whole():
        return torch.cat([p.to(d0) for p in parts], 1)
    for m in fcs:
        if isinstance(m, ShardedLinear) and m.layout == 'column':
            if parts is not None:
                x = whole()
            parts = [dtype_linear(x.to(d), w.to(d), b.to(d), m.dtype)
                     for d, w, b in zip(devices, m.weight_shards,
                                        m.bias_shards)]
        elif isinstance(m, ShardedLinear):
            if parts is None:
                parts = [p.to(d) for p, d in
                         zip(x.chunk(len(devices), 1), devices)]
            x = dtype_linear(parts, list(m.weight_shards), m.bias, m.dtype)
            parts = None
        elif isinstance(m, nn.Linear):
            if parts is not None:
                x, parts = whole(), None
            x = dtype_linear(x, m.weight.to(d0), m.bias.to(d0),
                             getattr(m, 'dtype', torch.float32))
        elif isinstance(m, SeededDropout) and m.training and m.p:
            raise NotImplementedError(
                'dropout on a mesh would draw its masks by shard; train '
                'an ARCHITECTURE with dropout on one device')
        elif parts is not None:                 # elementwise: by shard
            parts = [m(p) for p in parts]
        else:
            x = m(x)
    return whole() if parts is not None else x


def mesh_forward(model, mesh, X, rows=None):
    """``model(X)`` on the mesh: X's rows over 'data' (``shard_batch``),
    each data row's conv trunk on the row's first device, the FC layers
    of ``shard_params`` over the row's model devices. In train mode every
    BatchNorm takes its statistics over the whole batch
    (``CrossShardStats``; across processes too). ``rows`` (a ``MeshRows``
    the caller keeps across calls; a new one by default) runs the data
    rows. Returns the grids of this process's rows, each on its row's
    first device, in row order. ``X`` may also be split over this
    process's rows already (a list, ``shard_batch``'s form)."""
    parts = shard_batch(X, mesh)
    rows = MeshRows() if rows is None else rows
    split = batch_size(X, mesh) % mesh.shape['data'] == 0
    n_global = mesh.shape['data'] if split else 1
    group = None
    if split and mesh.processes > 1:
        import torch.distributed as dist
        group = dist.group.WORLD
    sync = (CrossShardStats(len(parts), n_global, group)
            if model.training and (len(parts) > 1 or group is not None)
            else None)
    trunk = model.ConvNet
    if len(parts) > 1:
        moved = replicate_put({**dict(trunk.named_parameters()),
                               **dict(trunk.named_buffers())}, mesh)

    def row(i):
        token = BATCH_NORM_SYNC.set(
            None if sync is None else
            lambda bn, x: sync.batch_norm(i, bn, x))
        try:
            if i == 0:
                feats = trunk(parts[0])
            else:
                feats = torch.func.functional_call(
                    rows.replica(i, trunk), moved[i], (parts[i],))
            pred = _fc_head(model.fcs, feats.float(), list(mesh.devices[i]))
        finally:
            BATCH_NORM_SYNC.reset(token)
        return pred.reshape(pred.shape[0], model.Sx, model.Sy, 3)
    return rows.run(row, mesh.data_devices[:len(parts)],
                    abort=None if sync is None else sync.abort)


def mesh_loss(model, mesh, X, target, loss_fn, rows=None):
    """The loss of a mesh step: ``mesh_forward``'s grids of this process's
    rows meet on the mesh's first device, with their targets, for
    ``loss_fn(grids, targets) -> (loss, components)``. Across processes
    each process's loss is its share of the global batch's (the loss is a
    sum over the batch divided by its size), so its ``backward()`` gives
    this process's part of the gradients (``reduce_grads`` adds them), and
    the components returned are the global batch's (all-reduced, detached).
    Returns (loss, components)."""
    import torch.distributed as dist
    preds = mesh_forward(model, mesh, X, rows)
    tgts = shard_batch(target, mesh)
    dev = mesh.primary
    pred = torch.cat([p.to(dev) for p in preds])
    tgt = torch.cat([t.to(dev) for t in tgts])
    loss, comps = loss_fn(pred, tgt)
    B = batch_size(X, mesh)
    if mesh.processes > 1 and B % mesh.shape['data'] == 0:
        share = pred.shape[0] / B
        loss = loss * share
        keys = sorted(comps)
        table = torch.stack([comps[k].detach() for k in keys]) * share
        dist.all_reduce(table)
        comps = dict(zip(keys, table.unbind()))
    return loss, comps


def reduce_grads(model, mesh, batch_size):
    """Across processes, the sum of every process's gradients of a batch
    the mesh split (a batch left whole runs alike on every process)."""
    if mesh.processes == 1 or batch_size % mesh.shape['data']:
        return
    import torch.distributed as dist
    for p in model.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad)


def sharded_inference_fn(model, mesh):
    """The eval-mode forward of ``model`` with the tiles over 'data' and
    the FC head over 'model' (JAX's ``sharded_inference_fn``): a copy of
    ``model`` split by ``shard_params`` (``model`` itself is not changed).
    Returns fn(X f32[N, C, ts, ts]) -> grids f32[N, Sx, Sy, 3] of this
    process's rows, on the mesh's first device."""
    sharded = shard_params(copy.deepcopy(model).to(mesh.primary).eval(),
                           mesh)
    rows = MeshRows()

    @torch.no_grad()
    def fn(X):
        return torch.cat([g.to(mesh.primary) for g in
                          mesh_forward(sharded, mesh, X, rows)])
    return fn


def distribute_state(state, mesh):
    """Place a ``TrainState`` on the mesh (JAX's ``distribute_state``):
    the model on the mesh's first device with its hidden FC layers split
    over 'model' (``shard_params``), the optimizer made anew over the
    split parameters (its moments start at zero, as JAX re-initializes
    them: distribute before training, not mid-run) at the current learning
    rate, and ``state.mesh`` set, which turns the engine's steps into mesh
    steps. Returns ``state``."""
    if state.mesh is not None:
        raise ValueError('the state is on a mesh already')
    state.model.to(mesh.primary)
    shard_params(state.model, mesh)
    old = state.optimizer
    state.optimizer = type(old)(state.model.parameters(), **old.defaults)
    for group in state.optimizer.param_groups:
        group['lr'] = old.param_groups[0]['lr']
    state.mesh = mesh
    return state
