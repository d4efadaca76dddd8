"""Long-movie sequence parallelism: ONE movie's frames sharded over a mesh.

PyTorch counterpart of ``axtrack_tpu/parallel/longmovie.py``. One host
thread drives each data shard of the mesh (``mesh.run_shards``):

- detection: the single path's CNN groups of the movie's centre frames
  (``detections.batch_frames``, ``frame_groups``) are dealt out whole to
  the shards in contiguous runs (``shard_groups``). A shard reads,
  preprocesses, tiles and detects its groups one at a time, then decodes
  and runs the distance NMS on its frames, with the dataset's kept-tile
  table and the single path's CNN, decode and NMS;
- association: detections are small and every shard sees all of them;
  the source frames are split into contiguous blocks (``shard_blocks``),
  and each shard is the chamfer source for the detections of its block
  and runs the single path's flushes (``detections.lookback_distances``:
  K1, the exactness certificate and the doubling sweep budget) on its
  device, giving the lookback pairs of gaps 1..max_gap. Each shard returns
  whether all its flushes were certified.

Halos are read, not exchanged. The JAX package ``ppermute``s the temporal
context between neighbour chips because its frames already sit sharded on
them. Here a shard copies each group's frames, with ``TEMPORAL_CONTEXT``
frames on each side, straight from where the movie lives
(``FrameSource``): the primary device's f32 movie (a device-to-device
copy), a staged movie's raw uint16 (resident on the device or pinned on
the host, preprocessed on the shard's device with the stage constants),
or a host f32 stack.

Exactness against the single path: every CNN call of a shard is a call of
the single path, with the same frames in the same order, so the card picks
the same convolution and GEMM algorithms and rounds alike (a batch of
another size may not: cuBLAS picks its GEMM by the row count, and cuDNN
rounds a 1-frame batch otherwise). The decode keeps ``max_dets`` slots a
frame; while no frame fills them (its pre-NMS count, ``n_decoded``, stays
below) the detections are those of the single path's
``MAX_DETS_PER_FRAME`` slots, since the decode ranks by a stable sort.
A movie with fewer groups than shards leaves shards without detection
work; they still take their share of the association.

Standardization of raw uint16 frames: ``var_scalar`` (the train scaler),
or with None the movie-global mean of the per-frame nonzero stds of the
movie's frames (lead and trail context included), computed a group at a
time by the group's shard and averaged over all of them in frame order,
so every shard count gives the same scalar.
"""
import numpy as np
import torch

from .mesh import device_lock, replicate, run_shards
from ..detections import (batch_frames, balanced_group_size, frame_groups,
                          lookback_distances)
from ..ops import geodesic_cuda as GC
from ..ops import preproc as PP
from ..ops import tiling as TL
from ..ops.decode import decode_tiled, distance_nms
from ..utils import exact_f32, profiling


def shard_blocks(n_items, n_dev):
    """[(a, b)] of each data shard: n_items (frames, CNN groups or movies)
    in contiguous blocks of ceil(n_items / n_dev), the last ones shorter or
    empty."""
    size = -(-n_items // n_dev) if n_items else 0
    return [(min(i * size, n_items), min((i + 1) * size, n_items))
            for i in range(n_dev)]


class FrameSource:
    """The frames E[j] = frames[offset + j] of a movie, zero where that
    index falls outside [0, hi) (a movie without temporal context at an
    end). ``frames``: a [T, H, W] numpy array or tensor on any device,
    uint16 raw, or f32; uint16 is carried as its int16 bits."""

    def __init__(self, frames, offset=0, hi=None):
        x = frames
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)
            x = torch.from_numpy(x.view(np.int16) if x.dtype == np.uint16
                                 else x)
        if x.dtype == torch.uint16:
            x = x.view(torch.int16)
        self.x, self.offset = x, int(offset)
        self.hi = len(x) if hi is None else min(int(hi), len(x))

    def read(self, a, b, device):
        """Frames E[a:b] on ``device``."""
        v0 = min(max(a, -self.offset), b)
        v1 = max(min(b, self.hi - self.offset), v0)
        body = profiling.to_device(self.x[self.offset + v0:self.offset + v1],
                                   device, non_blocking=True)
        if v0 == a and v1 == b:
            return body

        def zeros(n):
            return torch.zeros((n, *self.x.shape[1:]), dtype=self.x.dtype,
                               device=device)
        return torch.cat([zeros(v0 - a), body, zeros(b - v1)])


def shard_groups(n_real, batch_size, n_dev):
    """The single path's CNN groups of the n_real centre frames
    (``frame_groups`` of ``balanced_group_size``), dealt out whole to the
    n_dev shards in contiguous runs (``shard_blocks`` over the groups): a
    list over shards of their groups, each a list of consecutive centre
    positions. A shard's CNN calls are then the single path's calls."""
    groups = frame_groups(list(range(n_real)),
                          balanced_group_size(max(n_real, 1), batch_size))
    return [groups[a:b] for a, b in shard_blocks(len(groups), n_dev)]


def group_stds(source, groups, n_real, tc, dev, end=None):
    """Per-frame nonzero stds (of u / 65535, unmasked) of the frames of
    E[0:end] (default n_real + 2 tc) that ``groups`` own: each group's
    centres, the lead context with the movie's first group and the frames
    after the last centre with its last group. Read a group at a time, so
    the pieces are the same whichever shard owns a group."""
    end = n_real + 2 * tc if end is None else end
    out = [torch.zeros(0)]
    for group in groups:
        g0, g1 = group[0], group[-1] + 1
        a = 0 if g0 == 0 else tc + g0
        b = end if g1 == n_real else tc + g1
        with device_lock(dev):
            _, std, _ = PP.nonzero_stats(PP.u16_to_float(
                source.read(a, b, dev)))
            out.append(profiling.to_host(std))
    return torch.cat(out)


def block_grids(model, params, source, groups, dev, flat_idx, preprocess):
    """The detector's grids f32[n, K, Sx, Sy, 3] on ``dev`` of the centre
    frames of ``groups`` (a shard's ``shard_groups``), or None without
    groups. A group at a time, holding ``device_lock(dev)``: its frames
    E[g0:g1 + 2 tc] read from ``source``, ``preprocess(block, dev)``,
    tiled, the kept tiles ``flat_idx`` taken, and one CNN call (a callable
    detector ``f(t, X NHWC [K, ts, ts, C])``: one call a frame). A shard
    holds one group's frames and activations at a time, as the single path
    does."""
    if not groups:
        return None
    tc, ts = params['TEMPORAL_CONTEXT'], params['TILESIZE']
    kept = profiling.to_device(np.asarray(flat_idx), dev).long()
    module = isinstance(model, torch.nn.Module)
    out = []
    for group in groups:
        g0, n = group[0], len(group)
        with device_lock(dev):
            proc = preprocess(source.read(g0, g0 + n + 2 * tc, dev), dev)
            tiles = TL.tile_frames(proc, ts)
            tiles = tiles.reshape(len(proc), -1, ts, ts)[:, kept]
            del proc
            if not module:
                for j in range(n):
                    X = tiles[j:j + 2 * tc + 1].transpose(0, 1)
                    g = model(g0 + j, X.movedim(1, -1))
                    if not isinstance(g, torch.Tensor):
                        g = torch.from_numpy(np.asarray(g))
                    out.append(g.to(dev, torch.float32)[None])
                continue
            X = torch.cat([tiles[j:j + 2 * tc + 1].transpose(0, 1)
                           .flatten(1, -3) for j in range(n)])
            del tiles
            g = model(X)
            out.append(g.reshape(n, len(kept), *g.shape[1:]))
            del X
    return torch.cat(out)


def sharded_grids(mesh, model, params, source, n_real, flat_idx, mask=None,
                  var_scalar=None, preprocessed=False, stage=None,
                  batch_size=None):
    """The detector's grids of the centre frames E[tc:tc + n_real] of
    ``source``, each data shard its whole groups (``shard_groups``) on its
    device (``block_grids``): a list over shards of f32[n_i, K, Sx, Sy, 3]
    (None for a shard without groups).

    ``model``: an ``nn.Module`` taking f32[N, C, ts, ts] tile stacks, or a
    callable ``f(t, X NHWC [K, ts, ts, C]) -> grid`` called a frame (t the
    centre's position). The frames are raw uint16 standardized by
    ``var_scalar`` (module docstring), preprocessed f32
    (``preprocessed``), or a staged movie's uint16 with its constants
    (``stage``). ``batch_size``: frames a CNN call (default
    ``detections.batch_frames`` of the movie)."""
    tc = params['TEMPORAL_CONTEXT']
    ts = params['TILESIZE']
    devices = mesh.data_devices
    H, W = source.x.shape[1:]
    if batch_size is None:
        batch_size = batch_frames(model, ts, len(flat_idx), H, W, n_real,
                                  devices[0])
    dealt = shard_groups(n_real, batch_size, len(devices))
    models = replicate(model, mesh)
    raw = not preprocessed and stage is None
    if raw:
        masks = {d: torch.from_numpy(np.asarray(mask, bool)).to(d)
                 for d in set(devices)}
        if var_scalar is None:
            var_scalar = float(torch.cat(run_shards(
                lambda i, dev: group_stds(source, dealt[i], n_real, tc, dev),
                devices)).mean())

    def preprocess(block, dev):
        if preprocessed:
            return block
        if stage is not None:
            return PP.staged_preprocess_u16(
                block, stage['offset'], stage['lower'], stage['var'],
                log_correct=stage['log'])
        return PP.preprocess_frames(
            PP.u16_to_float(block), masks[dev], 0.0,
            params['CLIP_LOWERLIM'], var_scalar)

    with exact_f32():
        return run_shards(lambda i, dev: block_grids(
            models[i], params, source, dealt[i], dev, flat_idx, preprocess),
            devices)


def decode_block(grids, tile_yx, params, conf_thr, max_dets):
    """Decode + distance NMS of f32[n, K, Sx, Sy, 3] grids on their
    device. Returns host (f32[4, n, max_dets]: conf, x, y and alive;
    n_decoded [n]: the pre-NMS count a frame, == max_dets iff the decode
    slots filled)."""
    dec = decode_tiled(grids, tile_yx, conf_thr, params['TILESIZE'],
                       max_dets=max_dets)
    alive = distance_nms(dec['conf'], dec['x'], dec['y'], dec['valid'],
                         params['NON_MAX_SUPRESSION_DIST'])
    packed = torch.stack([dec['conf'], dec['x'], dec['y'],
                          alive.to(torch.float32)])
    return (profiling.to_host(packed).numpy(),
            profiling.to_host(dec['valid'].sum(-1)).numpy())


def decode_shards(mesh, grids, tile_yx, params, conf_thr, max_dets):
    """``decode_block`` of each shard's grids on its device. Returns host
    (conf, x, y, alive, n_decoded), each [n_frames, max_dets] but
    n_decoded [n_frames]."""
    parts = [p for p in run_shards(
        lambda i, dev: None if grids[i] is None else decode_block(
            grids[i], tile_yx, params, conf_thr, max_dets),
        mesh.data_devices) if p is not None]
    if not parts:
        empty = np.zeros((0, max_dets), np.float32)
        return empty, empty, empty, empty.astype(bool), np.zeros(0, int)
    packed = np.concatenate([p[0] for p in parts], axis=1)
    n_dec = np.concatenate([p[1] for p in parts])
    return packed[0], packed[1], packed[2], packed[3] > 0.5, n_dec


def sharded_assoc(mesh, frame_dets, masks, window, max_gap=2,
                  max_dist=500.0, sweeps=1):
    """Lookback-pair distances with the SOURCE frames sharded: shard i
    runs ``detections.lookback_distances`` for the sources of its block
    (``shard_blocks``) on its device. ``frame_dets``: per-frame dicts with
    int 'x', 'y' (all frames); ``masks``: {device: (window-padded mask,
    its ``GC.pack_mask``)}; ``sweeps``: each shard's first sweep budget.

    Returns (astar_dists {(t, gap): f32[n_s, n_t]}, ok bool[n_dev]: every
    flush of the shard certified, the flush records with their shard, the
    largest next-flush budget of the shards, K1 launches a shard)."""
    devices = mesh.data_devices
    blocks = shard_blocks(len(frame_dets), len(devices))

    def work(i, dev):
        c0, c1 = blocks[i]
        n0 = GC.chamfer_kernel.thread_launches()
        padded, bits = masks[dev]
        out = lookback_distances(frame_dets, range(c0, c1), max_gap, window,
                                 padded, bits, float(max_dist), sweeps)
        return out + (GC.chamfer_kernel.thread_launches() - n0,)

    outs = run_shards(work, devices)
    astar_dists = {}
    for out in outs:
        astar_dists.update(out[0])
    ok = np.array([all(f['certified'] for f in out[1]) for out in outs])
    flushes = [dict(f, shard=i) for i, out in enumerate(outs)
               for f in out[1]]
    return (astar_dists, ok, flushes, max(out[2] for out in outs),
            [out[3] for out in outs])


def build_sharded_detector(mesh, model, params, n_frames, flat_idx, tile_yx,
                           max_dets=64, conf_thr=0.55, var_scalar=None,
                           preprocessed=False, stage=None, batch_size=None):
    """Single-movie detector with the frame axis sharded over the data
    devices (JAX ``build_sharded_detector``'s counterpart).

    Returns fn(frames, mask) -> host (conf, x, y, alive, n_decoded), each
    [n_frames, max_dets] but n_decoded [n_frames]. ``frames``: the
    n_frames centre frames with TEMPORAL_CONTEXT frames on each side, as
    an array or a ``FrameSource`` (raw uint16; preprocessed f32 with
    ``preprocessed``; staged uint16 with ``stage`` = a staged Timelapse's
    ``_stage``); ``mask`` bool[H, W] (raw frames only)."""
    def fn(frames, mask=None):
        source = (frames if isinstance(frames, FrameSource)
                  else FrameSource(frames))
        grids = sharded_grids(mesh, model, params, source, n_frames,
                              flat_idx, mask, var_scalar, preprocessed,
                              stage, batch_size)
        return decode_shards(mesh, grids, tile_yx, params, conf_thr,
                             max_dets)
    return fn


def window_masks(mask, window, devices):
    """{device: (window-padded bool mask, its ``GC.pack_mask``)}."""
    padded = torch.from_numpy(pad_mask_for_windows(mask, window))
    out = {}
    for d in devices:
        if d not in out:
            p = padded.to(d)
            out[d] = (p, GC.pack_mask(p))
    return out


def build_sharded_assoc(mesh, window=512, max_gap=2, max_dist=500.0,
                        max_sweeps=8):
    """Association with the source frames sharded over the data devices
    (JAX ``build_sharded_assoc``'s counterpart). Returns fn(mask,
    frame_dets) -> (astar_dists, ok bool[n_dev]); ``mask`` bool[H, W],
    ``frame_dets`` per-frame dicts with 'x', 'y'. ``max_sweeps`` is each
    shard's first sweep budget; the certificate doubles it as needed."""
    def fn(mask, frame_dets):
        masks = window_masks(mask, window, mesh.data_devices)
        out = sharded_assoc(mesh, frame_dets, masks, window, max_gap,
                            max_dist, max_sweeps)
        return out[0], out[1]
    return fn


def pad_mask_for_windows(mask, window):
    """Zero-pad a bool mask so both dims are >= window (chamfer crops)."""
    Hp = max(window - mask.shape[0], 0)
    Wp = max(window - mask.shape[1], 0)
    return np.pad(np.asarray(mask, bool), ((0, Hp), (0, Wp)))


def long_movie_pipeline(mesh, model, params, frames, mask, max_dets=64,
                        window=512, max_sweeps=8, var_scalar=None,
                        flat_idx=None, tile_yx=None, conf_thr=0.55,
                        preprocessed=False, max_gap=2, max_dist=500.0,
                        stage=None, batch_size=None):
    """End-to-end sharded detect + associate for one long movie.

    frames: [T_total, H, W] INCLUDING TEMPORAL_CONTEXT leading and
    trailing context frames (raw uint16; preprocessed f32 with
    ``preprocessed``; a staged movie's masked raw uint16 with ``stage``).
    flat_idx / tile_yx: the kept-tile table; None derives it from the
    mask. Returns (frame_dets: per-frame dicts of conf f32, x, y int32 and
    n_decoded; astar_dists {(t, gap): f32[n_{t-gap}, n_t]}; ok bool[n_dev]
    per-shard certificates) in the host format ``detections.py`` and
    ``track/tracker.py`` read."""
    tc = params['TEMPORAL_CONTEXT']
    ts = params['TILESIZE']
    n_real = frames.shape[0] - 2 * tc
    H, W = frames.shape[1:]
    if flat_idx is None:
        ny, nx = TL.n_tiles(H, ts), TL.n_tiles(W, ts)
        mpad = np.zeros((ny * ts, nx * ts), bool)
        mpad[:H, :W] = np.asarray(mask)
        keep = mpad.reshape(ny, ts, nx, ts).any((1, 3))
        flat_idx, tile_yx = TL.tile_index_table(keep)
    detect = build_sharded_detector(
        mesh, model, params, n_real, flat_idx, tile_yx, max_dets=max_dets,
        conf_thr=conf_thr, var_scalar=var_scalar, preprocessed=preprocessed,
        stage=stage, batch_size=batch_size)
    conf, x, y, alive, n_dec = detect(frames, mask)
    frame_dets = [{'conf': conf[t][alive[t]].astype(np.float32),
                   'x': x[t][alive[t]].astype(np.int32),
                   'y': y[t][alive[t]].astype(np.int32),
                   'n_decoded': int(n_dec[t])} for t in range(n_real)]
    assoc = build_sharded_assoc(mesh, window=window, max_gap=max_gap,
                                max_dist=max_dist, max_sweeps=max_sweeps)
    astar_dists, ok = assoc(mask, frame_dets)
    return frame_dets, astar_dists, ok

