"""Timelapse dataset — the preprocessing, labels and tiling data layer.

PyTorch counterpart of ``axtrack_tpu/data/timelapse.py``: read + mask +
offset + pad, the clip/log/standardize chain, the motion channels, the
anchor labels, the timepoint slice with temporal context, the tile stack
with its kept-tile table, the YOLO targets and the per-epoch augmentation
draw, and the whole-object cache. The movie, its tiles and its targets
live as tensors on ``device``; the labels as numpy arrays
(``ops/targets.py``).

Not ported (ROADMAP M13b): the JAX package's staged-u16 path and its
chunked path for movies beyond the device budget. The port keeps the whole
movie on the device, and raises for a movie beyond ``device_budget``.
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


def device_budget(device):
    """Bytes of f32 movie the whole-movie path may hold on ``device``: a
    quarter of a card's memory, since ``construct_tiles`` holds the movie,
    its transformed copy, the padded tile stack and the kept tiles at once.
    None (no limit) on the CPU."""
    if device.type != 'cuda':
        return None
    return torch.cuda.get_device_properties(device).total_memory // 4


class Timelapse:
    def __init__(self, imseq_path, labels_csv, mask_path, timepoints, offset,
                 log_correct, standardize_framewise, standardize, name,
                 use_motion_filtered='exclude', use_sparse=False,
                 use_transforms=(), contrast_llim=None, plot=False, pad=None,
                 Sy=12, Sx=12, tilesize=512, cache=None, from_cache=None,
                 temporal_context=2, notes=None, pixelsize=None, dt=None,
                 incubation_time=None, seeding_datetime=None, device=None,
                 seed=42):
        """``seed`` (the run's SEED) and the name seed the augmentation
        draws, as the JAX package seeds them from its global seed."""
        self.name = name
        print(f'Data: {name}')
        self.device = resolve_device(device)
        self.transform_configs = dict.fromkeys(use_transforms or (), 0)
        self._rng = np.random.default_rng(
            [int(seed), zlib.crc32((name or '').encode())])

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

        frames, mask = self._read_tiff(imseq_path, mask_path, offset, plot)
        self.sizet, self.sizey, self.sizex = frames.shape
        self.size_chnls, self.size_colchnls = self._get_channelsizes()
        self.xtiles = TL.n_tiles(self.sizex, tilesize)
        self.ytiles = TL.n_tiles(self.sizey, tilesize)

        frames, self.stnd_scaler = self._preprocess(
            frames, contrast_llim, log_correct, standardize,
            standardize_framewise, cache, plot)
        self.mask = mask
        self.p_motion_seq, self.n_motion_seq = self._compute_motion(
            frames, standardize, plot)
        self.target = self._load_bboxes(labels_csv)
        self.timepoints_indices, self.sizet, frames = \
            self._slice_timepoints(frames)
        # X: dense frames incl. temporal-context neighbours, on device
        self.X = frames

        self.X_tiled, self.target_tiled, self.tile_info = None, None, None
        self.last_transform_configs = None
        self._tile_flat_idx, self._tile_yx = None, None
        if cache:
            self._save_cache(cache)

    # ------------------------------------------------------------------ io
    def _read_tiff(self, path, mask_path, offset, plot):
        """Read + mask + offset + pad (reference Timelapse.py:205-243).
        ``path`` may also be an in-memory [T, H, W] array (uint16 raw or
        float32 in [0, 1]). Returns (f32[T, H, W] on device, bool[H, W]
        numpy mask)."""
        print('Loading .tif image...', end='', flush=True)
        raw = path if isinstance(path, np.ndarray) else read_tiff_raw(path)
        n_seqs = 1 if self.use_motion_filtered == 'exclude' else 3
        budget = device_budget(self.device)
        if budget is not None and raw.size * 4 * n_seqs > budget:
            raise NotImplementedError(
                f'{raw.size * 4 * n_seqs / 1e9:.1f} GB of f32 movie is '
                f'beyond the whole-movie budget of {budget / 1e9:.1f} GB on '
                f'{self.device}: the staged-u16 and chunked paths for such '
                'movies are a later slice of the port (ROADMAP M13b)')
        if raw.dtype in (np.uint8, np.uint16):
            # img_as_float32 on the device: the same IEEE f32 division
            scale = np.float32(255.0 if raw.dtype == np.uint8 else 65535.0)
            imseq = torch.from_numpy(np.ascontiguousarray(raw).view(
                np.int8 if raw.dtype == np.uint8 else np.int16))
            imseq = imseq.to(self.device)
            imseq = (imseq.view(torch.uint8) if raw.dtype == np.uint8
                     else imseq.to(torch.int32) & 0xffff)
            imseq = imseq.to(torch.float32) / float(scale)
        else:
            imseq = torch.from_numpy(img_as_float32(raw)).to(self.device)

        print('masking...', end='', flush=True)
        if mask_path and not str(mask_path).endswith('None'):
            mask = np.load(mask_path).astype(bool)
        else:
            mask = np.ones(imseq.shape[1:], bool)
        if mask.ndim == 3:       # reference stacks one mask per frame
            mask = mask[0]
        imseq = torch.where(torch.from_numpy(mask).to(self.device), imseq,
                            0.0)
        if offset:
            offset = offset / 2 ** 16 if isinstance(offset, int) else offset
            print(f'offsetting by {offset:.4f} (0-1)...', end='', flush=True)
            imseq = torch.clamp_min(imseq - offset, 0)
        if self.pad is not None and any(self.pad):
            print('padding...', end='', flush=True)
            top, right, bottom, left = self.pad
            imseq = torch.nn.functional.pad(imseq, (left, right, top, bottom))
            mask = np.pad(mask, ((top, bottom), (left, right)))

        if self.timepoints is None:
            self.timepoints = list(range(self.temporal_context,
                                         imseq.shape[0] - self.temporal_context))
        else:
            self.timepoints = list(self.timepoints)
        self._capture(plot, 'Original', imseq)
        print('Done.')
        return imseq, mask

    def _capture(self, plot, label, x):
        if plot:
            self.plot_data[label] = (x[self.timepoints[0]].cpu().numpy(),
                                     x[self.timepoints[-1]].cpu().numpy())

    def _preprocess(self, x, contrast_llim, log_correct, standardize,
                    standardize_framewise, cache, plot):
        """Clip/log/standardize chain (reference Timelapse.py:245-326)."""
        lower = 0.0
        if contrast_llim:
            lower = (contrast_llim / 2 ** 16 if isinstance(contrast_llim, int)
                     else contrast_llim)
        if lower:
            x = torch.where(x < lower, 0.0, x)
            print(f'Image clipped to min value: {lower:.4f} (0-1)')
        self._capture(plot, 'Clipped', x)
        if log_correct:
            x = P.adjust_log(x)
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
                x = x / var_scalar
                stnd_scaler = (mode, (float(var_scalar), float(mean_scalar)))
                print('using passed scalers...', end='')
            elif standardize_framewise:
                mean, std, mx = P.nonzero_stats(x)
                per_frame = std if mode == 'zscore' else mx
                x = x / per_frame[:, None, None]
                stnd_scaler = (mode, None)
            else:
                var_scalar, mean_scalar = P.compute_stnd_scaler(x, mode)
                x = x / var_scalar
                stnd_scaler = (mode, (var_scalar, mean_scalar))
            self._capture(
                plot, f'Standardized (frame-wize: {standardize_framewise})', x)

        if cache and 'train' in (self.name or ''):
            fname = f'{cache}/{self.name}_stnd_scaler.pkl'
            with open(fname, 'wb') as file:
                print('writing standardization scaler to file...', end='')
                pickle.dump(stnd_scaler, file)
        print('Done.')
        return x, stnd_scaler

    def _compute_motion(self, frames, standardize, plot):
        """Motion channels (deprecated path, reference Timelapse.py:328-368).
        Returns (pos, neg) [T, H, W] on device, or (None, None) when
        excluded."""
        if self.use_motion_filtered == 'exclude':
            return None, None
        pos, neg = P.motion_frames(frames,
                                   sigma=self.motion_gaussian_filter_std,
                                   lowerlim=self.motion_lowerlim)
        if standardize:
            _, pstd, _ = P.nonzero_stats(pos[1:])
            _, nstd, _ = P.nonzero_stats(neg[1:])
            pos = pos / pstd.mean()
            neg = neg / nstd.mean()
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
        """Slice frames, motion channels and labels to the requested
        timepoints + context neighbours (reference Timelapse.py:386-413)."""
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
            sel = torch.as_tensor(all_tps, device=frames.device)
            frames = frames[sel]
            if self.p_motion_seq is not None:
                self.p_motion_seq = self.p_motion_seq[sel]
                self.n_motion_seq = self.n_motion_seq[sel]
        for k in ('anchor_y', 'anchor_x'):
            self.target[k] = self.target[k][all_tps]
        return timepoints_indices, len(tps), frames

    # ------------------------------------------------------------ caching
    _CACHE_SKIP = ('_rng', 'device', '_padded_mask_dev', '_mask_bits_dev')
    _DEVICE_ARRAYS = ('X', 'X_tiled', 'target_tiled', 'p_motion_seq',
                      'n_motion_seq')

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
        print('Loading dataset from cache', end='...', flush=True)
        dataset_file = f'{from_cache}/{self.name}_dataset_cached.pkl'
        if not os.path.exists(dataset_file):
            raise FileNotFoundError(f'No cached dataset found: {dataset_file}')
        with open(dataset_file, 'rb') as file:
            cached = pickle.load(file)
        for n, v in cached.items():
            if n in self._DEVICE_ARRAYS and v is not None:
                v = torch.from_numpy(v).to(self.device)
            setattr(self, n, v)
        self._tiles_clean = False
        print('Done.\n', flush=True)

    # ----------------------------------------------------------- tiling
    def construct_tiles(self, force_no_transformation=False):
        """Build X_tiled, target_tiled and tile_info for the current epoch
        (reference Timelapse.py:492-566). Each call with transforms draws
        a new configuration from the dataset's generator
        (``last_transform_configs``); untransformed tiles, once built, are
        reused.

        X_tiled: f32[T_all, K, ts, ts] on device ([T_all, K, C_col, ts, ts]
        in the motion modes, whose motion channels stay untransformed as in
        the JAX package); target_tiled: f32[T_all, K, Sx, Sy, 4] on device;
        tile_info: numpy f32[ny, nx, T_all, 2] of (tile non-empty, positive
        labels in it)."""
        wants_clean = force_no_transformation or not self.transform_configs
        if (wants_clean and self.X_tiled is not None
                and getattr(self, '_tiles_clean', False)):
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
        X = transform_frames(self.X, dy=dy, dx=dx, flip_y=flip_y,
                             flip_x=flip_x, angle=angle or 0.0)
        tiles = TL.tile_frames(X, ts)                # [T_all, ny, nx, ts, ts]
        non_empty = (tiles > 0).any(dim=4).any(dim=3)        # [T, ny, nx]
        keep = non_empty.any(dim=0).cpu().numpy()
        if not keep.any():
            keep[0, 0] = True                        # degenerate all-empty
        self._tile_flat_idx, self._tile_yx = TL.tile_index_table(keep)
        kept = torch.as_tensor(self._tile_flat_idx, device=X.device).long()
        flat = tiles.reshape(T_all, self.ytiles * self.xtiles, ts, ts)
        if self.use_motion_filtered == 'exclude':
            self.X_tiled = flat[:, kept]
        else:
            # (img?, pos, neg) colour channels a tile (Timelapse.py:426-433)
            chans = [] if self.use_motion_filtered == 'only' else [flat]
            for mseq in (self.p_motion_seq, self.n_motion_seq):
                chans.append(TL.tile_frames(mseq, ts).reshape(
                    T_all, self.ytiles * self.xtiles, ts, ts))
            self.X_tiled = torch.stack([c[:, kept] for c in chans], dim=2)
        del tiles, flat, X

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

    def __getitem__(self, idx):
        """(X f32[ts, ts, C] NHWC, target f32[Sx, Sy, 4]) for one
        (timepoint, tile) pair, on device (reference Timelapse.py:111-125;
        the layout of ``axtrack_tpu``'s version)."""
        t_idx, tile_idx = self.unfold_idx(idx)
        t_all = self.timepoints_indices[t_idx]
        tc = self.temporal_context
        X = self.X_tiled[t_all - tc:t_all + tc + 1, tile_idx]
        X = X.reshape(-1, *X.shape[-2:])       # motion modes: frame-major
        return X.movedim(0, -1), self.target_tiled[t_all, tile_idx]

    def get_frametiles_stack(self, timepoint):
        """All tiles of one frame: (f32[K, ts, ts, C] NHWC, f32[K, Sx, Sy,
        4]) on device, the layout of ``axtrack_tpu``'s version (reference
        Timelapse.py:150-157)."""
        t_all = self.timepoints_indices[timepoint]
        tc = self.temporal_context
        X = self.X_tiled[t_all - tc:t_all + tc + 1].transpose(0, 1)
        X = X.reshape(X.shape[0], -1, *X.shape[-2:])      # frame-major
        return X.movedim(1, -1), self.target_tiled[t_all]

    def get_frame_image(self, timepoint):
        """Full processed frame f32[H, W] (a device tensor)."""
        return self.X[self.timepoints_indices[timepoint]]

    def _get_channelsizes(self):
        ncol = {'exclude': 1, 'only': 2, 'include': 3}[self.use_motion_filtered]
        return (self.temporal_context * 2 + 1) * ncol, ncol
