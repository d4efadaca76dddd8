"""Timelapse dataset — the preprocessing, labels and tiling data layer.

PyTorch counterpart of ``axtrack_tpu/data/timelapse.py``: read + mask +
offset + pad, the clip/log/standardize chain, the motion channels, the
anchor labels, the timepoint slice with temporal context, the tile stack
with its kept-tile table, the YOLO targets and the per-epoch augmentation
draw, and the whole-object cache. The labels live as numpy arrays
(``ops/targets.py``), the targets on ``device``.

Where the movie lives depends on its size against the movie budget
(``Timelapse._DEVICE_MOVIE_BUDGET``, the f32 bytes of movie the
whole-movie path may hold; ``n_seqs`` movies in the motion modes):

- within it, the whole movie, its tiles and its targets are tensors on
  ``device``;
- beyond it, a uint16 movie (no motion channels, no framewise
  standardization) is *staged*: its raw integers stay on the host, pinned
  on a card, masked and padded, and resident on the device too when they
  fit ``_RESIDENT_U16_BUDGET``. Preprocessing, augmentation and tiling run
  on the device a chunk of frames at a time (``range_tiles``), with the
  same ops as the whole-movie path, so the tiles are bit-equal to its
  tiles; nothing movie-sized in f32 is ever allocated. Training runs
  chunk-resident epochs (``train/bigmovie.py``);
- any other movie beyond it stays on the host in f32, preprocessed and
  tiled on the device in frame chunks; its tile stack ``X_tiled`` is a host
  tensor from which detection copies frame groups and training streams
  batches.

The budgets are the JAX package's names: the class attributes, else the
environment variables ``AXTRACK_DEVICE_MOVIE_BUDGET`` and
``AXTRACK_RESIDENT_U16_BUDGET`` (read at each use), else a quarter of the
card's memory each; on the CPU no limit. Host chunks cross to the card on
a side stream (``ChunkCopier``) so the next chunk's copy overlaps the
current chunk's work.
"""
import os
import pickle
import zlib

import numpy as np
import torch

from ..config import resolve_device
from ..ops import preproc as P
from ..ops import tiling as TL
from ..ops.targets import read_labels_csv, flat_labels, labels_to_yolo_grid
from .augment import (draw_transform_config, config_to_transform_params,
                      transform_frames, transform_anchors)
from .tiffio import img_as_float32, read_tiff_raw

IDENTITY = dict(dy=0, dx=0, flip_y=False, flip_x=False, angle=0.0)


def device_budget(device):
    """Bytes of f32 movie the whole-movie path may hold on ``device``: a
    quarter of a card's memory, since ``construct_tiles`` holds the movie,
    its transformed copy, the padded tile stack and the kept tiles at once.
    None (no limit) on the CPU."""
    if device.type != 'cuda':
        return None
    return torch.cuda.get_device_properties(device).total_memory // 4


def budget(override, env, device):
    """A byte budget: ``override`` if not None, else the environment
    variable ``env`` if set, else ``device_budget(device)``."""
    if override is not None:
        return int(override)
    if os.environ.get(env):
        return int(os.environ[env])
    return device_budget(device)


class ChunkCopier:
    """Copies host chunks to the device on a side CUDA stream, so that the
    next chunk's copy runs while the current chunk computes (the JAX
    package's pipelined chunk loop). ``start`` begins a copy, ``wait``
    makes the current stream wait for it before the chunk is used. On the
    CPU a chunk is used as it is. ``seconds()`` is the device time of the
    copies so far (CUDA events; it synchronizes)."""

    def __init__(self, device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == 'cuda'
                       else None)
        self.events = []

    def start(self, host):
        if host is None or self.stream is None:
            return host
        with torch.cuda.stream(self.stream):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = host.to(self.device, non_blocking=True)
            ev[1].record()
        self.events.append(ev)
        return out

    def wait(self, copied):
        if copied is not None and self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            copied.record_stream(current)
        return copied

    def seconds(self):
        if not self.events:
            return 0.0
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


class Timelapse:
    # f32 bytes of movie (times n_seqs) the whole-movie path may hold;
    # None: AXTRACK_DEVICE_MOVIE_BUDGET, else a quarter of the card
    _DEVICE_MOVIE_BUDGET = None
    # raw u16 bytes of a staged movie that may stay resident on the card;
    # None: AXTRACK_RESIDENT_U16_BUDGET, else a quarter of the card
    _RESIDENT_U16_BUDGET = None

    def __init__(self, imseq_path, labels_csv, mask_path, timepoints, offset,
                 log_correct, standardize_framewise, standardize, name,
                 use_motion_filtered='exclude', use_sparse=False,
                 use_transforms=(), contrast_llim=None, plot=False, pad=None,
                 Sy=12, Sx=12, tilesize=512, cache=None, from_cache=None,
                 temporal_context=2, notes=None, pixelsize=None, dt=None,
                 incubation_time=None, seeding_datetime=None, device=None,
                 seed=42):
        """``seed`` (the run's SEED) and the name seed the augmentation
        draws, as the JAX package seeds them from its global seed.
        ``imseq_path`` may also be an in-memory [T, H, W] array (uint16 raw
        or float32 in [0, 1]); it is not modified."""
        self.name = name
        print(f'Data: {name}')
        self.device = resolve_device(device)
        self.transform_configs = dict.fromkeys(use_transforms or (), 0)
        self._rng = np.random.default_rng(
            [int(seed), zlib.crc32((name or '').encode())])
        self._X_u16_dev = self._u16_pixmax = None

        if from_cache:
            self._load_cache(from_cache)
            return

        self.plot_data = {}
        self.dt = dt
        self.incubation_time = incubation_time
        self.seeding_datetime = seeding_datetime
        self.pixelsize = pixelsize
        self.notes = notes

        self.timepoints = timepoints
        self.pad = pad
        self.use_sparse = use_sparse
        self.use_motion_filtered = use_motion_filtered
        self.temporal_context = temporal_context
        self.motion_gaussian_filter_std = 3
        self.motion_lowerlim = .1
        self.Sy, self.Sx = Sy, Sx
        self.tilesize = tilesize
        self._standardize_framewise = standardize_framewise

        frames, mask = self._read_tiff(imseq_path, mask_path, offset, plot)
        self.sizet, self.sizey, self.sizex = frames.shape
        self.size_chnls, self.size_colchnls = self._get_channelsizes()
        self.xtiles = TL.n_tiles(self.sizex, tilesize)
        self.ytiles = TL.n_tiles(self.sizey, tilesize)

        if self._u16_staged:
            self.stnd_scaler = self._preprocess_staged(
                frames, contrast_llim, log_correct, standardize, cache, plot)
        else:
            frames, self.stnd_scaler = self._preprocess(
                frames, contrast_llim, log_correct, standardize,
                standardize_framewise, cache, plot)
        self.mask = mask
        self.p_motion_seq, self.n_motion_seq = self._compute_motion(
            frames, standardize, plot)
        self.target = self._load_bboxes(labels_csv)
        self.timepoints_indices, self.sizet, frames = \
            self._slice_timepoints(frames)
        # X: dense frames incl. temporal-context neighbours: f32 on device,
        # or on the host (f32, or the raw u16 of a staged movie)
        self.X = frames

        self.X_tiled, self.target_tiled, self.tile_info = None, None, None
        self.last_transform_configs = None
        self._tile_flat_idx, self._tile_yx = None, None
        self._chunk_epoch = None
        if cache:
            self._save_cache(cache)

    # ------------------------------------------------------------ budgets
    def _movie_budget(self):
        return budget(self._DEVICE_MOVIE_BUDGET,
                      'AXTRACK_DEVICE_MOVIE_BUDGET', self.device)

    def _chunk_frames(self, shape, bytes_per_px):
        """Frames of a [T, H, W] movie that one device chunk may hold, at
        ``bytes_per_px`` of working set a pixel: the movie budget's worth,
        all T without a budget."""
        b = self._movie_budget()
        if b is None:
            return max(1, shape[0])
        return max(1, int(b // (bytes_per_px * shape[1] * shape[2])))

    def _host_empty(self, shape, dtype):
        """An uninitialised host tensor, pinned when the device is a card
        (so chunk copies from it are asynchronous)."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == 'cuda')

    def _map(self, x, fn, *per_frame, halo=0):
        """``fn(frames, *per_frame slices)`` over the movie ``x``: at once
        for a movie on the device; chunk by chunk on the device for a movie
        on the host, the results back on the host. A chunk is given
        ``halo`` frames before it, whose results are dropped. ``fn`` returns
        a tensor or a tuple of them, one frame per input frame."""
        if not self._on_host:
            return fn(x, *per_frame)
        # a numpy x (the raw movie) reaches fn as numpy chunks
        T = x.shape[0]
        chunk = self._chunk_frames(x.shape, 16)
        out = None
        for t0 in range(0, T, chunk):
            t1 = min(T, t0 + chunk)
            a = max(0, t0 - halo)
            xin = x[a:t1]
            if isinstance(xin, torch.Tensor):
                xin = xin.to(self.device)
            y = fn(xin, *[p[a:t1] for p in per_frame])
            y = y if isinstance(y, tuple) else (y,)
            if out is None:
                out = tuple(self._host_empty((T, *v.shape[1:]), v.dtype)
                            for v in y)
            for o, v in zip(out, y):
                o[t0:t1].copy_(v[t0 - a:])
        return out if len(out) > 1 else out[0]

    def _stats(self, x):
        """``P.nonzero_stats`` of every frame of ``x`` (on the device, by
        chunks for a movie on the host)."""
        if not self._on_host:
            return P.nonzero_stats(x)
        chunk = self._chunk_frames(x.shape, 16)
        parts = [P.nonzero_stats(x[t0:t0 + chunk].to(self.device))
                 for t0 in range(0, x.shape[0], chunk)]
        return tuple(torch.cat(p) for p in zip(*parts))

    # ------------------------------------------------------------------ io
    def _read_tiff(self, path, mask_path, offset, plot):
        """Read + mask + offset + pad (reference Timelapse.py:205-243).
        ``path`` may also be an in-memory [T, H, W] array (uint16 raw or
        float32 in [0, 1]).

        Decides where the movie lives (module docstring) and returns (the
        movie, bool[H, W] numpy mask): f32 on device; f32 on the host; or,
        staged, the raw uint16 on the host, masked and padded, with the
        intensity offset deferred to the device preprocessing
        (``_stage_offset``)."""
        print('Loading .tif image...', end='', flush=True)
        raw = path if isinstance(path, np.ndarray) else read_tiff_raw(path)
        n_seqs = 1 if self.use_motion_filtered == 'exclude' else 3
        limit = self._movie_budget()
        self._on_host = limit is not None and raw.size * 4 * n_seqs > limit
        self._u16_staged = (self._on_host and raw.dtype == np.uint16
                            and self.use_motion_filtered == 'exclude'
                            and not self._standardize_framewise)
        if self._on_host:
            print(f'{raw.size * 4 * n_seqs / 1e9:.1f} GB of f32 movie is '
                  f'beyond the budget of {limit / 1e9:.1f} GB: '
                  f'{"staged u16" if self._u16_staged else "host f32"}...',
                  end='', flush=True)

        print('masking...', end='', flush=True)
        if mask_path and not str(mask_path).endswith('None'):
            mask = np.load(mask_path).astype(bool)
        else:
            mask = np.ones(raw.shape[1:], bool)
        if mask.ndim == 3:       # reference stacks one mask per frame
            mask = mask[0]
        if offset:
            offset = offset / 2 ** 16 if isinstance(offset, int) else offset
            print(f'offsetting by {offset:.4f} (0-1)...', end='', flush=True)
        top, right, bottom, left = (self.pad if self.pad is not None
                                    and any(self.pad) else (0, 0, 0, 0))
        if self.timepoints is None:
            self.timepoints = list(range(self.temporal_context,
                                         raw.shape[0] - self.temporal_context))
        else:
            self.timepoints = list(self.timepoints)

        if self._u16_staged:
            self._stage_offset = float(offset or 0.0)
            imseq = self._stage_u16(raw, mask, (top, right, bottom, left))
            if plot:
                self.plot_data['Original'] = tuple(
                    P.staged_preprocess_u16(imseq[t].view(torch.int16),
                                            offset or 0.0, 0.0, 1.0,
                                            log_correct=False).numpy()
                    for t in (self.timepoints[0], self.timepoints[-1]))
        else:
            mask_dev = torch.from_numpy(mask).to(self.device)

            def to_frames(chunk):
                # img_as_float32 on the device: numpy's f32 division
                if chunk.dtype == np.uint16:
                    x = P.u16_to_float(torch.from_numpy(
                        np.ascontiguousarray(chunk).view(np.int16)).to(
                            self.device))
                elif chunk.dtype == np.uint8:
                    x = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                        self.device).to(torch.float32)
                    x = x / torch.tensor(255.0, device=self.device)
                else:
                    x = torch.from_numpy(img_as_float32(chunk)).to(
                        self.device)
                x = torch.where(mask_dev, x, 0.0)
                if offset:
                    x = torch.clamp_min(x - offset, 0)
                return torch.nn.functional.pad(x, (left, right, top, bottom))

            if self._on_host:
                imseq = self._map(raw, to_frames)
            else:
                imseq = to_frames(raw)
            self._capture(plot, 'Original', imseq)
        if any((top, right, bottom, left)):
            print('padding...', end='', flush=True)
            mask = np.pad(mask, ((top, bottom), (left, right)))
        print('Done.')
        return imseq, mask

    def _stage_u16(self, raw, mask, pad):
        """The staged movie: the raw integers times the mask, zero-padded,
        in a host uint16 tensor (pinned on a card)."""
        top, right, bottom, left = pad
        T, H, W = raw.shape
        out = self._host_empty((T, H + top + bottom, W + left + right),
                               torch.uint16)
        o = out.numpy()
        inner = o[:, top:top + H, left:left + W]
        if mask.all():
            np.copyto(inner, raw)
        else:
            np.multiply(raw, mask.astype(np.uint16), out=inner)
        for sl in (np.s_[:, :top], np.s_[:, top + H:], np.s_[:, :, :left],
                   np.s_[:, :, left + W:]):
            o[sl] = 0
        return out

    def _capture(self, plot, label, x):
        if plot:
            self.plot_data[label] = (x[self.timepoints[0]].cpu().numpy(),
                                     x[self.timepoints[-1]].cpu().numpy())

    def _preprocess(self, x, contrast_llim, log_correct, standardize,
                    standardize_framewise, cache, plot):
        """Clip/log/standardize chain (reference Timelapse.py:245-326), on
        the device (by chunks for a movie on the host)."""
        lower = 0.0
        if contrast_llim:
            lower = (contrast_llim / 2 ** 16 if isinstance(contrast_llim, int)
                     else contrast_llim)
        if lower:
            x = self._map(x, lambda c: torch.where(c < lower, 0.0, c))
            print(f'Image clipped to min value: {lower:.4f} (0-1)')
        self._capture(plot, 'Clipped', x)
        if log_correct:
            x = self._map(x, P.adjust_log)
            self._capture(plot, 'Log-Adjusted', x)

        stnd_scaler = (None, None)
        mode = standardize[0] if isinstance(standardize, (tuple, list)) \
            else standardize
        if mode:
            print(f'Standardizing image values ({mode})...', end='', flush=True)
            passed = standardize[1] if isinstance(standardize, (tuple, list)) \
                else None
            if passed is not None and not standardize_framewise:
                var_scalar, mean_scalar = passed
                x = self._map(x, lambda c: c / var_scalar)
                stnd_scaler = (mode, (float(var_scalar), float(mean_scalar)))
                print('using passed scalers...', end='')
            elif standardize_framewise:
                mean, std, mx = self._stats(x)
                per_frame = std if mode == 'zscore' else mx
                x = self._map(x, lambda c, d: c / d[:, None, None], per_frame)
                stnd_scaler = (mode, None)
            else:
                var_scalar, mean_scalar = P.stnd_scaler_from_stats(
                    *self._stats(x), mode)
                x = self._map(x, lambda c: c / var_scalar)
                stnd_scaler = (mode, (var_scalar, mean_scalar))
            self._capture(
                plot, f'Standardized (frame-wize: {standardize_framewise})', x)
        self._write_scaler(cache, stnd_scaler)
        print('Done.')
        return x, stnd_scaler

    def _write_scaler(self, cache, stnd_scaler):
        if cache and 'train' in (self.name or ''):
            fname = f'{cache}/{self.name}_stnd_scaler.pkl'
            with open(fname, 'wb') as file:
                print('writing standardization scaler to file...', end='')
                pickle.dump(stnd_scaler, file)

    def _preprocess_staged(self, frames, contrast_llim, log_correct,
                           standardize, cache, plot):
        """Staged preprocessing (``axtrack_tpu``'s ``_preprocess_staged``):
        the frames stay raw uint16 on the host (and resident on the device
        when they fit). One chunked device pass computes the per-frame
        nonzero statistics of the preprocessed frames, for the scaler, and
        the untransformed per-frame non-empty-tile table
        (``_nonempty_table``, bool[T, ny, nx]). With a passed scaler no
        movie-sized f32 array is allocated. Returns the scaler."""
        self.X = frames
        lower = 0.0
        if contrast_llim:
            lower = (contrast_llim / 2 ** 16 if isinstance(contrast_llim, int)
                     else contrast_llim)
        if lower:
            print(f'Image clipped to min value: {lower:.4f} (0-1) [staged]')
        mode = standardize[0] if isinstance(standardize, (tuple, list)) \
            else standardize
        passed = standardize[1] if isinstance(standardize, (tuple, list)) \
            else None
        self._stage = dict(offset=self._stage_offset, lower=float(lower),
                           log=bool(log_correct), var=1.0)
        self.ensure_resident_u16()

        T = frames.shape[0]
        chunk = self._chunk_frames(frames.shape, 14)
        print(f'Staged preprocessing ({T} frames, chunks of {chunk})...',
              end='', flush=True)
        stats, non_empty = [], []
        for t0 in range(0, T, chunk):
            x = self._staged_frames(t0, min(T, t0 + chunk))
            stats.append(P.nonzero_stats(x))
            tiles = TL.tile_frames(x, self.tilesize)
            non_empty.append((tiles > 0).any(dim=4).any(dim=3))
            del x, tiles
        self._nonempty_table = torch.cat(non_empty).cpu().numpy()
        print('Done.')

        stnd_scaler = (None, None)
        if mode:
            print(f'Standardizing image values ({mode}, staged)...', end='',
                  flush=True)
            if passed is not None:
                var_scalar, mean_scalar = passed
                print('using passed scalers...', end='')
            else:
                var_scalar, mean_scalar = P.stnd_scaler_from_stats(
                    *[torch.cat(s) for s in zip(*stats)], mode)
            stnd_scaler = (mode, (float(var_scalar), float(mean_scalar)))
            self._stage['var'] = float(var_scalar)
            print('Done.')
        if plot:
            self.plot_data['Standardized (staged)'] = tuple(
                self._staged_frames(t, t + 1)[0].cpu().numpy()
                for t in (self.timepoints[0], self.timepoints[-1]))
        self._write_scaler(cache, stnd_scaler)
        return stnd_scaler

    def _compute_motion(self, frames, standardize, plot):
        """Motion channels (deprecated path, reference Timelapse.py:328-368).
        Returns (pos, neg) [T, H, W] where the movie lives, or (None, None)
        when excluded."""
        if self.use_motion_filtered == 'exclude':
            return None, None
        pos, neg = self._map(frames, lambda c: P.motion_frames(
            c, sigma=self.motion_gaussian_filter_std,
            lowerlim=self.motion_lowerlim), halo=1)
        if standardize:
            _, pstd, _ = self._stats(pos[1:])
            _, nstd, _ = self._stats(neg[1:])
            pscale, nscale = pstd.mean(), nstd.mean()
            pos = self._map(pos, lambda c: c / pscale)
            neg = self._map(neg, lambda c: c / nscale)
        self._capture(plot, 'Positive Motion', pos)
        self._capture(plot, 'Negative Motion', neg)
        return pos, neg

    def _load_bboxes(self, labels_csv):
        """Anchor labels of every movie frame (reference
        Timelapse.py:370-384): dict of 'anchor_y', 'anchor_x' (f64 [T, A],
        NaN where unlabelled, shifted by the padding) and 'axons' (names).
        No labels file gives A = 0."""
        if labels_csv is None:
            empty = np.zeros((self.sizet, 0))
            return {'anchor_y': empty, 'anchor_x': empty.copy(),
                    'axons': []}
        ay, ax, axons = read_labels_csv(labels_csv, self.pad)
        return {'anchor_y': ay, 'anchor_x': ax, 'axons': axons}

    def _slice_timepoints(self, frames):
        """Slice frames, motion channels, the staged movie's tables and the
        labels to the requested timepoints + context neighbours (reference
        Timelapse.py:386-413)."""
        tps = self.timepoints
        print(f'Slicing timepoints to t={tps} (n={len(tps)})')
        self.t_discontinuities = [i for i in range(1, len(tps))
                                  if tps[i] != tps[i - 1] + 1]
        if self.temporal_context:
            ext = set()
            for t in tps:
                for tpad in range(1, self.temporal_context + 1):
                    ext.update((t - tpad, t, t + tpad))
            all_tps = sorted(ext)
        else:
            all_tps = list(tps)
        timepoints_indices = [all_tps.index(tp) for tp in tps]
        if all_tps != list(range(frames.shape[0])):
            frames = self._take(frames, all_tps)
            if self.p_motion_seq is not None:
                self.p_motion_seq = self._take(self.p_motion_seq, all_tps)
                self.n_motion_seq = self._take(self.n_motion_seq, all_tps)
            if self._u16_staged:
                # the resident copy follows the host slice: a view for a
                # contiguous range, else a new copy of the gathered frames
                self._nonempty_table = self._nonempty_table[all_tps]
                resident = self._X_u16_dev is not None
                self.X = frames
                if resident and all_tps[-1] - all_tps[0] + 1 == len(all_tps):
                    self._X_u16_dev = self._X_u16_dev[all_tps[0]:
                                                      all_tps[-1] + 1]
                elif resident:
                    self._X_u16_dev = None
                    self.ensure_resident_u16()
        for k in ('anchor_y', 'anchor_x'):
            self.target[k] = self.target[k][all_tps]
        return timepoints_indices, len(tps), frames

    def _take(self, x, idx):
        """x[idx] along frames: a view for a contiguous range, else a gather
        (into pinned memory for a movie on the host)."""
        if idx == list(range(idx[0], idx[-1] + 1)):
            return x[idx[0]:idx[-1] + 1]
        if x.device.type == 'cuda' or not self._on_host:
            return x[torch.as_tensor(idx, device=x.device)]
        out = self._host_empty((len(idx), *x.shape[1:]), x.dtype)
        bits = torch.int16 if x.dtype == torch.uint16 else x.dtype
        torch.index_select(x.view(bits), 0, torch.as_tensor(idx),
                           out=out.view(bits))
        return out

    # ---------------------------------------------------- staged movies
    def ensure_resident_u16(self):
        """Copy a staged movie's raw u16 to the device once, if it fits
        ``_RESIDENT_U16_BUDGET`` (decided before any copy; a failing copy
        raises). Returns True when the movie is resident."""
        if not self._u16_staged:
            return False
        if self._X_u16_dev is not None:
            return True
        limit = budget(self._RESIDENT_U16_BUDGET,
                       'AXTRACK_RESIDENT_U16_BUDGET', self.device)
        if limit is not None and self.X.numel() * 2 > limit:
            return False
        self._ship_resident_u16()
        return True

    def _ship_resident_u16(self):
        print(f'Copying the raw u16 movie to {self.device} once '
              f'({self.X.numel() * 2 / 1e9:.1f} GB)...', end='', flush=True)
        self._X_u16_dev = self.X.view(torch.int16).to(self.device)
        print('Done.', flush=True)

    def release_device_arrays(self):
        """Drop this movie's device caches: a staged movie's resident raw
        u16 (``_X_u16_dev``) and its per-pixel maximum, a tile stack on the
        device, and the association's window-padded masks and their bits
        (``_padded_mask_dev``, ``_mask_bits_dev``, a device each). Serving
        a queue of movies (``interface.inference_many``) would otherwise
        hold them all. Each is rebuilt on demand: the next
        ``construct_tiles`` tiles again (and makes a staged movie resident
        again when it fits), the next association pads the mask again. A
        movie whose frames live on the device (``X``) keeps them: there is
        no other copy. Only references are dropped: a thread that still
        reads one of them (an eager association) holds its own."""
        self._X_u16_dev = self._u16_pixmax = None
        self._padded_mask_dev = self._mask_bits_dev = None
        if not self._on_host:
            self.X_tiled = None
        self._tiles_clean = False

    def staged_chunk(self, lo, hi):
        """Raw u16 frames [lo:hi) of a staged movie on the device (as int16
        bits): a slice of the resident copy, else a copy from the host."""
        if self._X_u16_dev is not None:
            return self._X_u16_dev[lo:hi]
        return self.X[lo:hi].view(torch.int16).to(self.device)

    def _staged_frames(self, lo, hi, raw=None):
        """Preprocessed frames [lo:hi) of a staged movie, f32 on the
        device; ``raw`` is their u16 already on the device, if copied."""
        s = self._stage
        return P.staged_preprocess_u16(
            self.staged_chunk(lo, hi) if raw is None else raw, s['offset'],
            s['lower'], s['var'], log_correct=s['log'])

    def _staged_keep(self, dy, dx, flip_y, flip_x, angle):
        """Kept-tile mask bool[ny, nx] of a staged movie under a transform,
        from one [H, W] image. A tile of the transformed movie is non-empty
        iff the transformed indicator of "a nonzero pixel in some frame"
        has mass in it: the transform moves every frame's pixels the same
        way (nearest-pixel rotation, shifts, flips), and the preprocessing
        is nondecreasing in the raw value, so "some frame > 0" is
        "preprocess(per-pixel max) > 0"."""
        if self._u16_pixmax is None:
            T = self.X.shape[0]
            chunk = self._chunk_frames(self.X.shape, 10)
            for t0 in range(0, T, chunk):
                m = (self.staged_chunk(t0, min(T, t0 + chunk))
                     .to(torch.int32) & 0xffff).amax(dim=0)
                self._u16_pixmax = (m if self._u16_pixmax is None
                                    else torch.maximum(self._u16_pixmax, m))
        s = self._stage
        ind = (P.staged_preprocess_u16(self._u16_pixmax[None], s['offset'],
                                       s['lower'], 1.0, log_correct=s['log'])
               > 0).to(torch.float32)
        ind = transform_frames(ind, dy=dy, dx=dx, flip_y=flip_y,
                               flip_x=flip_x, angle=angle or 0.0)
        tiles = TL.tile_frames(ind[0], self.tilesize)
        return (tiles > 0).any(dim=3).any(dim=2).cpu().numpy()

    def _kept(self):
        return torch.as_tensor(self._tile_flat_idx, device=self.device).long()

    def _staged_range_tiles(self, lo, hi, raw=None):
        """Kept tiles f32[hi-lo, K, ts, ts] of a staged movie's frames
        [lo:hi), preprocessed and transformed (the epoch's transform) on
        the device."""
        x = transform_frames(self._staged_frames(lo, hi, raw),
                             **(self._chunk_epoch or IDENTITY))
        flat = TL.tile_frames(x, self.tilesize).reshape(
            x.shape[0], self.ytiles * self.xtiles, self.tilesize,
            self.tilesize)
        return flat[:, self._kept()]

    def materialize_tiles(self):
        """Fill ``X_tiled`` of a staged movie as a host tensor, a chunk of
        frames at a time (preprocess, the epoch's transform, tile and
        gather on the device). Nothing on the port's paths needs it: the
        detection and the epochs build tiles a chunk at a time."""
        if self.X_tiled is not None or not self._u16_staged:
            return
        T = self.X.shape[0]
        chunk = self._chunk_frames(self.X.shape, 32)
        out = None
        for t0 in range(0, T, chunk):
            t1 = min(T, t0 + chunk)
            tiles = self._staged_range_tiles(t0, t1)
            if out is None:
                out = self._host_empty((T, *tiles.shape[1:]), tiles.dtype)
            out[t0:t1].copy_(tiles)
        self.X_tiled = out

    def tiles_source(self, lo, hi):
        """The host data that ``range_tiles(lo, hi)`` needs on the device,
        for a ``ChunkCopier`` to copy ahead: a staged movie's raw u16
        frames unless resident, or a slice of a host ``X_tiled``; None when
        the device holds it already."""
        if self._u16_staged and self.X_tiled is None:
            if self._X_u16_dev is not None:
                return None
            return self.X[lo:hi].view(torch.int16)
        if self.X_tiled.device != self.device:
            return self.X_tiled[lo:hi]
        return None

    def range_tiles(self, lo, hi, copied=None):
        """Kept tiles of frames [lo:hi) on the device, f32[hi-lo, K, ts,
        ts] ([hi-lo, K, C_col, ts, ts] in the motion modes): built from the
        raw u16 for a staged movie, else a slice of ``X_tiled``.
        ``copied``: ``tiles_source(lo, hi)`` already on the device."""
        if self._u16_staged and self.X_tiled is None:
            return self._staged_range_tiles(lo, hi, copied)
        if copied is not None:
            return copied
        return self.X_tiled[lo:hi].to(self.device)

    # ------------------------------------------------------------ caching
    _CACHE_SKIP = ('_rng', 'device', '_padded_mask_dev', '_mask_bits_dev',
                   '_X_u16_dev', '_u16_pixmax')
    _DEVICE_ARRAYS = ('X', 'X_tiled', 'target_tiled', 'p_motion_seq',
                      'n_motion_seq')
    # arrays that stay on the host for a movie beyond the budget
    _HOST_ARRAYS = ('X', 'X_tiled', 'p_motion_seq', 'n_motion_seq')

    def _save_cache(self, cache):
        with open(f'{cache}/{self.name}_dataset_cached.pkl', 'wb') as file:
            print('Serializing dataset for caching', end='...')
            state = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else v)
                     for k, v in self.__dict__.items()
                     if k not in self._CACHE_SKIP}
            pickle.dump(state, file, protocol=4)
        print('Done.\n', flush=True)

    def _load_cache(self, from_cache):
        """Restore a cached dataset. Its arrays go back to the device, but
        for a movie beyond the budget, whose movie and host tiles stay on
        the host (a staged movie's ``X`` as uint16); a staged movie is made
        resident again if it fits."""
        print('Loading dataset from cache', end='...', flush=True)
        dataset_file = f'{from_cache}/{self.name}_dataset_cached.pkl'
        if not os.path.exists(dataset_file):
            raise FileNotFoundError(f'No cached dataset found: {dataset_file}')
        with open(dataset_file, 'rb') as file:
            cached = pickle.load(file)
        self._on_host = self._u16_staged = False
        self._chunk_epoch = None
        self.__dict__.update({k: v for k, v in cached.items()
                              if k not in self._DEVICE_ARRAYS})
        for n in self._DEVICE_ARRAYS:
            v = cached.get(n)
            if v is not None:
                v = torch.from_numpy(v)
                if self._on_host and n in self._HOST_ARRAYS:
                    if self.device.type == 'cuda':
                        v = v.pin_memory()
                else:
                    v = v.to(self.device)
            setattr(self, n, v)
        self._tiles_clean = False
        self.ensure_resident_u16()
        print('Done.\n', flush=True)

    # ----------------------------------------------------------- tiling
    def construct_tiles(self, force_no_transformation=False):
        """Build X_tiled, target_tiled and tile_info for the current epoch
        (reference Timelapse.py:492-566). Each call with transforms draws
        a new configuration from the dataset's generator
        (``last_transform_configs``); untransformed tiles, once built, are
        reused.

        X_tiled: f32[T_all, K, ts, ts] ([T_all, K, C_col, ts, ts] in the
        motion modes, whose motion channels stay untransformed as in the
        JAX package), on device, or on the host for a movie beyond the
        budget (two chunked passes: the kept set, then the tiles). A staged
        movie builds none: it keeps the kept-tile table and the epoch's
        transform (``_chunk_epoch``), and ``range_tiles`` builds tiles a
        chunk at a time. target_tiled: f32[T_all, K, Sx, Sy, 4] on device;
        tile_info: numpy f32[ny, nx, T_all, 2] of (tile non-empty, positive
        labels in it); a staged movie's non-empty column is its
        untransformed table, as in the JAX package."""
        wants_clean = force_no_transformation or not self.transform_configs
        self.ensure_resident_u16()
        built = (self.X_tiled is not None
                 or (self._u16_staged and self._tile_flat_idx is not None))
        if wants_clean and built and getattr(self, '_tiles_clean', False):
            return
        self._tiles_clean = wants_clean
        anchor_y, anchor_x = self.target['anchor_y'], self.target['anchor_x']
        self.last_transform_configs = None
        dy = dx = 0
        flip_y = flip_x = False
        angle = None
        if self.transform_configs and not force_no_transformation:
            cfg = draw_transform_config(self.transform_configs, self._rng)
            dy, dx, flip_y, flip_x, angle = config_to_transform_params(cfg)
            anchor_y, anchor_x = transform_anchors(
                anchor_y, anchor_x, angle, flip_y, flip_x, dy, dx,
                self.sizey, self.sizex)
            self.last_transform_configs = cfg
            print(f'New transform config set: {cfg}')
        print(f'Tiling {self.name} data...', end='', flush=True)
        ts = self.tilesize
        T_all = self.X.shape[0]
        transform = dict(dy=int(dy), dx=int(dx), flip_y=bool(flip_y),
                         flip_x=bool(flip_x), angle=float(angle or 0.0))
        self._chunk_epoch = None
        self.X_tiled = None
        if self._u16_staged:
            keep = self._staged_keep(**transform)
            if not keep.any():
                keep[0, 0] = True
            self._tile_flat_idx, self._tile_yx = TL.tile_index_table(keep)
            self._chunk_epoch = transform
            non_empty = torch.from_numpy(self._nonempty_table).to(self.device)
        elif self._on_host:
            non_empty = self._tile_host_movie(transform)
        else:
            tiles = TL.tile_frames(transform_frames(self.X, **transform), ts)
            non_empty = (tiles > 0).any(dim=4).any(dim=3)     # [T, ny, nx]
            keep = non_empty.any(dim=0).cpu().numpy()
            if not keep.any():
                keep[0, 0] = True                    # degenerate all-empty
            self._tile_flat_idx, self._tile_yx = TL.tile_index_table(keep)
            self.X_tiled = self._kept_channels(
                tiles.reshape(T_all, self.ytiles * self.xtiles, ts, ts),
                self.p_motion_seq, self.n_motion_seq)
            del tiles
        kept = self._kept()

        grid = labels_to_yolo_grid(
            *flat_labels(anchor_y, anchor_x), ny=self.ytiles, nx=self.xtiles,
            Sy=self.Sy, Sx=self.Sx, tilesize=ts, n_frames=T_all,
            device=self.device)
        grid = grid.reshape(T_all, self.ytiles * self.xtiles, self.Sx,
                            self.Sy, 4)
        self.target_tiled = grid[:, kept]
        # tile_info [ny, nx, T_all, 2] (Timelapse.py:551-553)
        npos = torch.zeros((T_all, self.ytiles * self.xtiles),
                           device=self.device)
        npos[:, kept] = self.target_tiled[..., 0].sum((-1, -2))
        info = torch.stack([non_empty.to(torch.float32),
                            npos.reshape(non_empty.shape)], -1)
        self.tile_info = info.movedim(0, 2).cpu().numpy()
        print('Done.', flush=True)

    def _kept_channels(self, flat, pmotion, nmotion):
        """Kept tiles of f32[n, ny*nx, ts, ts] frame tiles; in the motion
        modes stacked with the motion sequences' tiles as (img?, pos, neg)
        colour channels a tile (Timelapse.py:426-433)."""
        kept = self._kept()
        if self.use_motion_filtered == 'exclude':
            return flat[:, kept]
        chans = [] if self.use_motion_filtered == 'only' else [flat]
        for mseq in (pmotion, nmotion):
            chans.append(TL.tile_frames(mseq, self.tilesize).reshape(
                flat.shape))
        return torch.stack([c[:, kept] for c in chans], dim=2)

    def _tile_host_movie(self, transform):
        """construct_tiles for a movie on the host: pass 1 transforms and
        tiles each chunk on the device for the kept set, pass 2 gathers the
        kept tiles into a host ``X_tiled``. Returns the non-empty table
        bool[T, ny, nx] on the device."""
        ts, T_all = self.tilesize, self.X.shape[0]
        chunk = self._chunk_frames(self.X.shape, 16)
        dev = self.device

        def frame_tiles(t0, t1):
            x = transform_frames(self.X[t0:t1].to(dev), **transform)
            return TL.tile_frames(x, ts).reshape(
                t1 - t0, self.ytiles * self.xtiles, ts, ts)

        spans = [(t0, min(T_all, t0 + chunk)) for t0 in range(0, T_all,
                                                              chunk)]
        non_empty = torch.cat([(frame_tiles(*s) > 0).any(dim=3).any(dim=2)
                               for s in spans])
        keep = non_empty.any(dim=0).reshape(self.ytiles, self.xtiles)
        keep = keep.cpu().numpy()
        if not keep.any():
            keep[0, 0] = True
        self._tile_flat_idx, self._tile_yx = TL.tile_index_table(keep)
        motion = self.use_motion_filtered != 'exclude'
        for t0, t1 in spans:
            tiles = self._kept_channels(
                frame_tiles(t0, t1),
                *([self.p_motion_seq[t0:t1].to(dev),
                   self.n_motion_seq[t0:t1].to(dev)] if motion
                  else [None, None]))
            if self.X_tiled is None:
                self.X_tiled = self._host_empty((T_all, *tiles.shape[1:]),
                                                tiles.dtype)
            self.X_tiled[t0:t1].copy_(tiles)
        return non_empty.reshape(T_all, self.ytiles, self.xtiles)

    # ------------------------------------------------- dataset interface
    @property
    def ntiles_kept(self):
        if self._tile_flat_idx is None:
            raise RuntimeError('No tiles yet. Run dataset.construct_tiles() '
                               'first.')
        return len(self._tile_flat_idx)

    def __len__(self):
        return self.sizet * self.ntiles_kept

    def unfold_idx(self, idx):
        return divmod(idx, self.ntiles_kept)

    def fold_idx(self, idx):
        t_idx, tile_idx = idx
        return t_idx * self.ntiles_kept + tile_idx

    def flat_tile_idx2yx_tile_idx(self, tile_idx):
        fi = int(self._tile_flat_idx[tile_idx])
        return divmod(fi, self.xtiles)

    def _context_tiles(self, t_all):
        """Kept tiles of the context frames around t_all on the device:
        f32[C_f, K, ts, ts] ([C_f, K, C_col, ts, ts] in the motion modes)."""
        tc = self.temporal_context
        return self.range_tiles(t_all - tc, t_all + tc + 1)

    def __getitem__(self, idx):
        """(X f32[ts, ts, C] NHWC, target f32[Sx, Sy, 4]) for one
        (timepoint, tile) pair, on device (reference Timelapse.py:111-125;
        the layout of ``axtrack_tpu``'s version)."""
        t_idx, tile_idx = self.unfold_idx(idx)
        t_all = self.timepoints_indices[t_idx]
        X = self._context_tiles(t_all)[:, tile_idx]
        X = X.reshape(-1, *X.shape[-2:])       # motion modes: frame-major
        return X.movedim(0, -1), self.target_tiled[t_all, tile_idx]

    def get_frametiles_stack(self, timepoint):
        """All tiles of one frame: (f32[K, ts, ts, C] NHWC, f32[K, Sx, Sy,
        4]) on device, the layout of ``axtrack_tpu``'s version (reference
        Timelapse.py:150-157)."""
        t_all = self.timepoints_indices[timepoint]
        X = self._context_tiles(t_all).transpose(0, 1)
        X = X.reshape(X.shape[0], -1, *X.shape[-2:])      # frame-major
        return X.movedim(1, -1), self.target_tiled[t_all]

    def get_frame_image(self, timepoint):
        """Full processed frame f32[H, W] on the device (a staged movie
        preprocesses the one frame)."""
        t_all = self.timepoints_indices[timepoint]
        if self._u16_staged:
            return self._staged_frames(t_all, t_all + 1)[0]
        return self.X[t_all].to(self.device)

    def _get_channelsizes(self):
        ncol = {'exclude': 1, 'only': 2, 'include': 3}[self.use_motion_filtered]
        return (self.temporal_context * 2 + 1) * ncol, ncol
