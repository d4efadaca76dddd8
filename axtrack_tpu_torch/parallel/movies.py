"""Multi-movie detection across the mesh's data devices.

PyTorch counterpart of ``axtrack_tpu/parallel/movies.py``. Independent
movies of one shape are split into contiguous runs over the data devices
(``shard_movies``) and each device detects its movies, one host thread a
device (``mesh.run_shards``); the movies never meet. Each movie is
standardized by its own mean of per-frame nonzero stds and detected by the
shard-side loop of ``longmovie`` (``block_grids``, ``decode_block``) as the
single path detects it: the same CNN groups (``detections.batch_frames``
over its centre frames), decode and distance NMS.
"""
import numpy as np
import torch

from .mesh import replicate, run_shards
from .longmovie import (FrameSource, block_grids, decode_block, group_stds,
                        shard_blocks, shard_groups)
from ..detections import batch_frames
from ..ops import preproc as PP
from ..utils import exact_f32


def shard_movies(frames_u16, mesh):
    """Split [M, T_all, H, W] uint16 movies over the mesh's data devices:
    a list over the devices of their contiguous run of movies on that
    device, as int16 bits [m_i, T_all, H, W] (m_i may be 0)."""
    x = frames_u16
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int16))
    if x.dtype == torch.uint16:
        x = x.view(torch.int16)
    devices = mesh.data_devices
    return [x[a:b].to(dev)
            for (a, b), dev in zip(shard_blocks(len(x), len(devices)),
                                   devices)]


def batched_movie_detector(model, mesh, params, n_frames, tile_flat_idx,
                           tile_yx, max_dets=256):
    """A multi-movie detector: returns fn(movies, mask) -> host (conf, x, y,
    alive), each [M, n_frames, max_dets], the detections of the centre
    frames TEMPORAL_CONTEXT..TEMPORAL_CONTEXT + n_frames of each movie at
    conf >= 0.55. ``movies``: [M, T_all, H, W] uint16, or
    ``shard_movies``' list; ``mask`` bool[H, W]; ``tile_flat_idx`` /
    ``tile_yx``: the kept-tile table the movies share."""
    ts = params['TILESIZE']
    tc = params['TEMPORAL_CONTEXT']
    K = len(tile_flat_idx)
    models = replicate(model, mesh)

    def one_movie(i, dev, raw, keep):
        source = FrameSource(raw)
        H, W = raw.shape[1:]
        groups = shard_groups(n_frames, batch_frames(
            models[i], ts, K, H, W, n_frames, dev), 1)[0]
        var = float(group_stds(source, groups, n_frames, tc, dev,
                               end=len(raw)).mean())

        def preprocess(block, dev):
            return PP.preprocess_frames(PP.u16_to_float(block), keep, 0.0,
                                        params['CLIP_LOWERLIM'], var)
        grids = block_grids(models[i], params, source, groups, dev,
                            tile_flat_idx, preprocess)
        return decode_block(grids, tile_yx, params, 0.55, max_dets)[0]

    def fn(movies, mask):
        if not isinstance(movies, list):
            movies = shard_movies(movies, mesh)

        def work(i, dev):
            keep = torch.from_numpy(np.asarray(mask, bool)).to(dev)
            return [one_movie(i, dev, raw, keep) for raw in movies[i]]

        with exact_f32():
            out = [p for part in run_shards(work, mesh.data_devices)
                   for p in part]
        if not out:
            empty = np.zeros((0, n_frames, max_dets), np.float32)
            return empty, empty, empty, empty.astype(bool)
        packed = np.stack(out, axis=1)             # [4, M, n_frames, D]
        return packed[0], packed[1], packed[2], packed[3] > 0.5

    return fn
