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

On a mesh (``state.mesh``) the chunk is copied, preprocessed and tiled on
the mesh's first device, where the dataset lives, and each batch is split
over 'data' in the engine's mesh step. The JAX package also splits the
chunk's frames over 'data' for the preprocessing (its
``frames_constrain``); the port does not yet.
"""
import os

import numpy as np
import torch

from ..data.timelapse import ChunkCopier
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


def run_epoch_chunked(state, dataset, which_dataset, P, plan=None):
    """One chunk-resident epoch over a staged dataset whose
    ``construct_tiles`` prepared the epoch (``_chunk_epoch``). Each batch
    is what ``engine.run_epoch`` would gather for the same flat indices;
    only the batch order is chunk-major. Returns the per-batch loss
    components like ``engine.run_epoch``; ``state.copy_seconds`` is the
    device time its host->device chunk copies took."""
    if dataset._chunk_epoch is None:
        raise RuntimeError('construct_tiles() has not prepared a chunked '
                           'epoch')
    dataset.ensure_resident_u16()
    chunks, K = plan if plan is not None else plan_chunks(dataset, P,
                                                          rng=state.rng)
    dev = dataset.device
    tp = torch.as_tensor(dataset.timepoints_indices, device=dev)
    tc = dataset.temporal_context
    offs = torch.arange(-tc, tc + 1, device=dev)
    copier = ChunkCopier(dev)
    print(f'LOSS (chunked, {len(chunks)} chunks): ', end='', flush=True)

    def fetch(ch):
        return copier.start(dataset.tiles_source(ch['lo'], ch['hi']))

    def batches():
        pending = fetch(chunks[0]) if chunks else None
        for i, ch in enumerate(chunks):
            copied = copier.wait(pending)
            if i + 1 < len(chunks):
                pending = fetch(chunks[i + 1])
            tiles = dataset.range_tiles(ch['lo'], ch['hi'], copied)
            del copied
            sets = list(ch['batches'])
            if len(ch['rest']) and not P['DROP_LAST']:
                sets.append(ch['rest'])
            for idx in sets:
                idx = torch.as_tensor(idx, device=dev)
                t_all, k = tp[idx // K], idx % K
                ctx = (t_all - ch['lo'])[:, None] + offs
                yield tiles[ctx, k[:, None]], dataset.target_tiled[t_all, k]
            del tiles

    out = engine.run_steps(state, which_dataset, batches())
    state.copy_seconds = copier.seconds()
    return out
