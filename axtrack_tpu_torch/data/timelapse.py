"""Timelapse dataset — the preprocessing + tiling data layer, inference
subset.

PyTorch counterpart of ``axtrack_tpu/data/timelapse.py`` for unlabelled
inference movies: read + mask + offset + pad, the clip/log/standardize
chain, the timepoint slice with temporal context, the untransformed tile
stack with its kept-tile table, and the whole-object cache. The movie and
its tiles live as tensors on ``device``.

Left for later slices (ROADMAP): labels and YOLO targets, augmentation
transforms, motion channels and the staged-u16 big-movie path (M13).
"""
import os
import pickle

import numpy as np
import torch

from ..config import resolve_device
from ..ops import preproc as P
from ..ops import tiling as TL
from .tiffio import img_as_float32, read_tiff_raw


class Timelapse:
    def __init__(self, imseq_path, labels_csv, mask_path, timepoints, offset,
                 log_correct, standardize_framewise, standardize, name,
                 use_motion_filtered='exclude', use_sparse=False,
                 use_transforms=(), contrast_llim=None, plot=False, pad=None,
                 Sy=12, Sx=12, tilesize=512, cache=None, from_cache=None,
                 temporal_context=2, notes=None, pixelsize=None, dt=None,
                 incubation_time=None, seeding_datetime=None, device=None):
        if labels_csv is not None:
            raise NotImplementedError(
                'labelled movies (YOLO targets) belong to the training port '
                '(ROADMAP M13)')
        if use_motion_filtered != 'exclude':
            raise NotImplementedError(
                'motion channels belong to the training port (ROADMAP M13)')
        self.name = name
        print(f'Data: {name}')
        self.device = resolve_device(device)
        self.transform_configs = dict.fromkeys(use_transforms or (), 0)

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
        self.timepoints_indices, self.sizet, frames = \
            self._slice_timepoints(frames)
        # X: dense frames incl. temporal-context neighbours, on device
        self.X = frames

        self.X_tiled = None
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

    def _slice_timepoints(self, frames):
        """Slice to requested timepoints + context neighbours
        (reference Timelapse.py:386-413)."""
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
            frames = frames[torch.as_tensor(all_tps, device=frames.device)]
        return timepoints_indices, len(tps), frames

    # ------------------------------------------------------------ caching
    _CACHE_SKIP = ('_padded_mask_dev',)

    def _save_cache(self, cache):
        with open(f'{cache}/{self.name}_dataset_cached.pkl', 'wb') as file:
            print('Serializing dataset for caching', end='...')
            state = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else v)
                     for k, v in self.__dict__.items()
                     if k not in self._CACHE_SKIP and k != 'device'}
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
            if n in ('X', 'X_tiled') and v is not None:
                v = torch.from_numpy(v).to(self.device)
            setattr(self, n, v)
        self._tiles_clean = False
        print('Done.\n', flush=True)

    # ----------------------------------------------------------- tiling
    def construct_tiles(self, force_no_transformation=False):
        """Build X_tiled and the kept-tile table (reference
        Timelapse.py:492-566), untransformed. X_tiled: f32[T_all, K, ts, ts]
        on device."""
        if self.transform_configs and not force_no_transformation:
            raise NotImplementedError(
                'augmentation transforms belong to the training port '
                '(ROADMAP M13)')
        if self.X_tiled is not None and getattr(self, '_tiles_clean', False):
            return
        print(f'Tiling {self.name} data...', end='', flush=True)
        ts = self.tilesize
        T_all = self.X.shape[0]
        tiles = TL.tile_frames(self.X, ts)           # [T_all, ny, nx, ts, ts]
        keep = TL.nonempty_tile_mask(tiles)
        if not keep.any():
            keep[0, 0] = True                        # degenerate all-empty
        self._tile_flat_idx, self._tile_yx = TL.tile_index_table(keep)
        flat = tiles.reshape(T_all, self.ytiles * self.xtiles, ts, ts)
        self.X_tiled = flat[:, torch.as_tensor(self._tile_flat_idx,
                                               device=flat.device).long()]
        self._tiles_clean = True
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

    def get_frametiles_stack(self, timepoint):
        """All tiles of one frame: (f32[K, ts, ts, C] NHWC, None) — the
        layout of ``axtrack_tpu``'s version; unlabelled data has no target
        grid."""
        t_all = self.timepoints_indices[timepoint]
        tc = self.temporal_context
        X = self.X_tiled[t_all - tc:t_all + tc + 1]
        return X.movedim(0, -1), None

    def get_frame_image(self, timepoint):
        """Full processed frame f32[H, W] (a device tensor)."""
        return self.X[self.timepoints_indices[timepoint]]

    def _get_channelsizes(self):
        ncol = {'exclude': 1, 'only': 2, 'include': 3}[self.use_motion_filtered]
        return (self.temporal_context * 2 + 1) * ncol, ncol
