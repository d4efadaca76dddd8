"""Chunk-resident training epochs for staged movies beyond the device budget.

PyTorch counterpart of ``axtrack_tpu/train/bigmovie.py``. The reference
trains its deployed model on 323 frames of 2920x6364 (~24 GB as f32). A
staged movie (``data/timelapse.py``) keeps its raw uint16 on the host and,
when it fits, resident on the card; each epoch walks the frame axis in
chunks: the chunk's raw frames (copied ahead on a side stream unless
resident) -> preprocess -> the epoch's augmentation transform -> tile ->
kept-tile gather, all on the device, then ``engine.train_step`` (or
``eval_step``) over every batch of the chunk. The steps are the engine's,
with runtime transform values, so nothing is compiled per epoch.

Shuffle semantics (the JAX package's): chunk order is shuffled and pairs
are shuffled within a chunk; the draws come from the ``TrainState``'s
generator. With SHUFFLE=False the plan equals the JAX package's.

DROP_LAST semantics: chunk lengths are aligned so every non-tail chunk's
pair count is a multiple of the batch size, so only the tail chunk drops a
remainder, unless the budget allows fewer frames than the alignment step.

The chunk budget is ``AXTRACK_CHUNK_BUDGET`` (bytes of device working
set a chunk), else an eighth of the card's memory; on the CPU no limit.

On a mesh with more than one data row (``state.mesh``) a chunk's frames
are split over 'data', as the JAX package's ``frames_constrain`` splits
them: each data row copies, preprocesses, transforms and tiles its own
contiguous slice of the chunk on its first device, on its ``MeshRows``
thread; the kept tiles of the whole chunk are then assembled once a
chunk on every data row's device (``replicate_constrain``'s one gather;
across processes one ``torch.distributed`` all-gather), and each batch's
rows are gathered on the device of the data row that trains them
(``ChunkRows``, ``assemble_chunk``). The assembled tiles are bit-equal
to one device's: every op of the chain works frame by frame.
"""
import os

import numpy as np
import torch

from ..data.timelapse import ChunkCopier
from ..parallel.mesh import same_device
from . import engine


def default_chunk_budget(device):
    """Bytes of device working set one chunk may use: AXTRACK_CHUNK_BUDGET,
    else an eighth of the card's memory (a resident movie takes at most a
    quarter); None (no limit) on the CPU."""
    if os.environ.get('AXTRACK_CHUNK_BUDGET'):
        return int(os.environ['AXTRACK_CHUNK_BUDGET'])
    if device.type != 'cuda':
        return None
    return torch.cuda.get_device_properties(device).total_memory // 8


def plan_chunks(dataset, P, shuffle=None, chunk_budget=None, rng=None):
    """One epoch's chunk plan (``axtrack_tpu``'s ``plan_chunks``).

    Returns (chunks, K): chunks is a list of dicts with
      lo/hi   — frame range (indices into the staged movie, incl. halo)
      t0/t1   — centre-timepoint range [t0, t1) covered by the chunk
      batches — int64[n_full, BATCH_SIZE] flat (t * K + tile) indices
      rest    — int64[r] leftover pairs (< one batch)
    ``rng`` (a ``np.random.Generator``) draws the shuffles.
    """
    K = dataset.ntiles_kept
    tp = np.asarray(dataset.timepoints_indices)
    T = dataset.sizet
    tc = dataset.temporal_context
    H, W, ts = dataset.sizey, dataset.sizex, dataset.tilesize
    # device working set a frame: kept tiles, the preprocessed and the
    # transformed frame (f32) and the raw u16 frame
    per_frame = K * ts * ts * 4 + H * W * 10
    if chunk_budget is None:
        chunk_budget = default_chunk_budget(dataset.device)
    C_t = T if chunk_budget is None else max(1, min(T, chunk_budget
                                                    // per_frame))
    bs = P['BATCH_SIZE']
    if P['DROP_LAST'] and C_t < T:
        step = bs // int(np.gcd(K, bs))      # smallest c with c*K % bs == 0
        if step <= C_t:
            C_t = (C_t // step) * step
    if shuffle is None:
        shuffle = P['SHUFFLE']
    if shuffle and rng is None:
        raise ValueError('a shuffled plan needs rng= (the TrainState '
                         'generator)')

    starts = np.arange(0, T, C_t)
    if shuffle:
        rng.shuffle(starts)
    chunks = []
    for t0 in starts:
        t0, t1 = int(t0), int(min(t0 + C_t, T))
        pairs = (np.arange(t0, t1)[:, None] * K
                 + np.arange(K)[None]).ravel().astype(np.int64)
        if shuffle:
            rng.shuffle(pairs)
        n_full = len(pairs) // bs
        chunks.append(dict(t0=t0, t1=t1, lo=int(tp[t0:t1].min() - tc),
                           hi=int(tp[t0:t1].max() + tc + 1),
                           batches=pairs[:n_full * bs].reshape(n_full, bs),
                           rest=pairs[n_full * bs:]))
    return chunks, K


def frame_slices(lo, hi, n_rows):
    """Frames [lo, hi) cut into ``n_rows`` contiguous slices, one a data
    row in row order, as even as can be (the later rows one frame longer
    where the count does not divide); a row may get none. Returns a list
    of (a, b)."""
    n = hi - lo
    bounds = [lo + n * r // n_rows for r in range(n_rows + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


class ChunkRows:
    """Who builds a chunk's kept tiles, and where they are assembled.

    Without a mesh, or on a mesh with one data row, one row: the dataset's
    device builds the whole chunk (``range_tiles``). On a mesh with more
    data rows the chunk's frames are split over 'data' (JAX's
    ``frames_constrain``): each data row of this process builds its own
    slice (``frame_slices``) on its first device, on its ``MeshRows``
    thread, from its own host copy (``ChunkCopier``) of a streamed staged
    movie or from the resident copy; then the whole chunk is assembled
    once on each distinct device of this process's rows and the dataset's
    (JAX's ``replicate_constrain``), through one ``torch.distributed``
    all-gather when other processes hold rows. A device that holds several
    logical rows holds one assembled chunk."""

    def __init__(self, dataset, mesh, rows):
        """``mesh``: the state's (or None); ``rows``: its ``MeshRows``."""
        self.dataset = dataset
        split = mesh is not None and mesh.shape['data'] > 1
        self.mesh = mesh if split else None
        self.devices = (list(mesh.data_devices) if split
                        else [dataset.device])
        self.n_global = mesh.shape['data'] if split else 1
        self.first = (mesh.process_index * len(self.devices) if split
                      else 0)
        self.rows = rows
        self.copiers = [ChunkCopier(d) for d in self.devices]
        self.targets = []
        for d in [dataset.device, *self.devices]:
            if not any(same_device(d, e) for e in self.targets):
                self.targets.append(d)

    def slices(self, lo, hi):
        """(a, b) of every data row of the mesh, in global row order."""
        return frame_slices(lo, hi, self.n_global)

    def own(self, lo, hi):
        """The slices of this process's rows."""
        return self.slices(lo, hi)[self.first:self.first + len(self.devices)]

    def fetch(self, lo, hi):
        """Start each row's host copy of its slice (``tiles_source``)."""
        return [c.start(self.dataset.tiles_source(a, b)) if b > a else None
                for c, (a, b) in zip(self.copiers, self.own(lo, hi))]

    def wait(self, pending):
        """The rows' copies of a ``fetch``, ready on their devices."""
        return [c.wait(p) for c, p in zip(self.copiers, pending)]

    def copy_seconds(self):
        return sum(c.seconds() for c in self.copiers)


def assemble_chunk(chunk_rows, lo, hi, copied):
    """The kept tiles of frames [lo, hi) built by ``chunk_rows``' rows
    (``copied``: their ``fetch`` after ``wait``) and assembled: a dict
    device -> f32 [hi-lo, K, ts, ts], one entry a device of
    ``chunk_rows.targets``, each bit-equal to the dataset's
    ``range_tiles(lo, hi)``."""
    cr, ds = chunk_rows, chunk_rows.dataset
    own = cr.own(lo, hi)

    def build(i):
        a, b = own[i]
        if b == a:
            return None
        return ds.range_tiles(a, b, copied[i], device=cr.devices[i])
    with torch.no_grad():
        parts = cr.rows.run(build, cr.devices)
        parts = [p for p in parts if p is not None]
        if cr.mesh is not None and cr.mesh.processes > 1:
            parts = [_all_gather_frames(cr, parts, lo, hi)]
        return {d: (parts[0].to(d) if len(parts) == 1 else
                    torch.cat([p.to(d) for p in parts]))
                for d in cr.targets}


def _all_gather_frames(cr, parts, lo, hi):
    """Every process's slices of the chunk, in frame order, on this
    process's first row device: one all-gather of each process's block of
    frames, padded to the longest block (the blocks' lengths follow from
    ``frame_slices``)."""
    import torch.distributed as dist
    ds, dev = cr.dataset, cr.devices[0]
    n_local = len(cr.devices)
    slices = cr.slices(lo, hi)
    sizes = [slices[(p + 1) * n_local - 1][1] - slices[p * n_local][0]
             for p in range(cr.mesh.processes)]
    shape = (ds.ntiles_kept, ds.tilesize, ds.tilesize)
    block = torch.zeros((max(sizes), *shape), device=dev)
    r = 0
    for part in parts:
        block[r:r + len(part)] = part.to(dev)
        r += len(part)
    blocks = [torch.empty_like(block) for _ in sizes]
    dist.all_gather(blocks, block)
    return torch.cat([b[:n] for b, n in zip(blocks, sizes)])


def run_epoch_chunked(state, dataset, which_dataset, P, plan=None):
    """One chunk-resident epoch over a staged dataset whose
    ``construct_tiles`` prepared the epoch (``_chunk_epoch``). Each batch
    is what ``engine.run_epoch`` would gather for the same flat indices;
    only the batch order is chunk-major. On a mesh with more than one data
    row each chunk's frames are split over 'data' (``ChunkRows``) and a
    batch the axis divides is gathered a row's part on the row's device.
    Returns the per-batch loss components like ``engine.run_epoch``;
    ``state.copy_seconds`` is the device time its host->device chunk
    copies took."""
    if dataset._chunk_epoch is None:
        raise RuntimeError('construct_tiles() has not prepared a chunked '
                           'epoch')
    dataset.ensure_resident_u16()
    chunks, K = plan if plan is not None else plan_chunks(dataset, P,
                                                          rng=state.rng)
    cr = ChunkRows(dataset, state.mesh, state.mesh_rows)
    dev = dataset.device
    tc = dataset.temporal_context
    tps = {d: torch.as_tensor(dataset.timepoints_indices, device=d)
           for d in cr.targets}
    offs = {d: torch.arange(-tc, tc + 1, device=d) for d in cr.targets}
    print(f'LOSS (chunked, {len(chunks)} chunks): ', end='', flush=True)

    def gather(tiles, lo, idx, d):
        """The tiles of flat indices ``idx`` from the chunk on ``d``."""
        d = next(t for t in cr.targets if same_device(t, d))
        idx = torch.as_tensor(idx, device=d)
        ctx = (tps[d][idx // K] - lo)[:, None] + offs[d]
        return tiles[d][ctx, (idx % K)[:, None]]

    def batches():
        pending = cr.fetch(chunks[0]['lo'], chunks[0]['hi']) if chunks \
            else None
        for i, ch in enumerate(chunks):
            lo = ch['lo']
            copied = cr.wait(pending)
            if i + 1 < len(chunks):     # the next copy overlaps this chunk
                pending = cr.fetch(chunks[i + 1]['lo'], chunks[i + 1]['hi'])
            tiles = assemble_chunk(cr, lo, ch['hi'], copied)
            del copied
            sets = list(ch['batches'])
            if len(ch['rest']) and not P['DROP_LAST']:
                sets.append(ch['rest'])
            for idx in sets:
                flat = torch.as_tensor(idx, device=dev)
                target = dataset.target_tiled[tps[dev][flat // K], flat % K]
                if cr.n_global > 1 and len(idx) % cr.n_global == 0:
                    b = len(idx) // cr.n_global
                    X = [gather(tiles, lo, idx[g * b:(g + 1) * b], d)
                         for g, d in enumerate(cr.devices, cr.first)]
                else:
                    X = gather(tiles, lo, flat, dev)
                yield X, target
            del tiles

    out = engine.run_steps(state, which_dataset, batches())
    state.copy_seconds = cr.copy_seconds()
    return out
