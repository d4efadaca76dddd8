"""Whole-movie augmentation on the device.

PyTorch counterpart of ``axtrack_tpu/data/augment.py`` (reference
axtrack/data_utils.py:7-174): the same per-epoch draws, mapped to the
same (dy, dx, flip_y, flip_x, angle), applied to the dense [T, H, W]
movie in torch and to the anchor arrays in numpy.

Semantics copied from the JAX package, including its two conventions:
- the image is rotated by nearest sampling through the inverse of the
  anchor formula (f32 source coordinates, rounded half to even);
- frames flip about (size - 1) / 2 (an index reversal) while anchors flip
  about (size + 1) / 2, 2 px apart (ROADMAP F6, a reference fault kept so
  the targets equal the JAX package's).
"""
import math

import numpy as np
import torch


def draw_transform_config(use_transforms, rng):
    """dict key -> uniform draw from ``rng`` (a ``np.random.Generator``),
    rounded to 3 decimals (data_utils.py:141)."""
    return {key: round(float(rng.random()), 3) for key in use_transforms}


def config_to_transform_params(transform_configs):
    """Map the draws to (dy, dx, flip_y, flip_x, angle_deg or None)
    (data_utils.py:146-165): translate fires at u > .6 with
    d = round(512 * (u - .75)); 'hflip' flips the y axis and 'vflip' the x
    axis (the reference's naming); rotation fires at u > .6 with
    angle = u * 40 - 20 degrees."""
    dy, dx = 0, 0
    if transform_configs.get('translateY', 0) > .6:
        dy = round(512 * (transform_configs.get('translateY', 0) - .75))
    if transform_configs.get('translateX', 0) > .6:
        dx = round(512 * (transform_configs.get('translateX', 0) - .75))
    flip_y = transform_configs.get('hflip', 0) > .6
    flip_x = transform_configs.get('vflip', 0) > .6
    angle = None
    if transform_configs.get('rot', 0) > .6:
        angle = transform_configs['rot'] * 40 - 20
    return dy, dx, flip_y, flip_x, angle


def rotation_source(H, W, angle, device=None):
    """f32 source coordinates (y_src, x_src) [H, W] of each output pixel
    for a rotation by ``angle`` degrees about ((H+1)/2, (W+1)/2): the
    inverse of the anchor map, computed in f32 as the JAX package does."""
    theta = torch.tensor(angle, dtype=torch.float32) * math.pi / 180.0
    c, s = torch.cos(-theta).to(device), torch.sin(-theta).to(device)
    y_mid = (H + 1) / 2.0
    x_mid = (W + 1) / 2.0
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    x_src = (xx - x_mid) * c + (yy - y_mid) * s + x_mid
    y_src = -(xx - x_mid) * s + (yy - y_mid) * c + y_mid
    return y_src, x_src


def transform_frames(X, dy=0, dx=0, flip_y=False, flip_x=False, angle=0.0):
    """Translate -> flip -> rotate [T, H, W] frames (the reference's order,
    data_utils.py:26-62), zero fill outside, on X's device."""
    T, H, W = X.shape
    if dy or dx:
        X = torch.roll(X, (dy, dx), dims=(1, 2))
        ys = torch.arange(H, device=X.device) - dy
        xs = torch.arange(W, device=X.device) - dx
        keep = (((ys >= 0) & (ys < H))[:, None]
                & ((xs >= 0) & (xs < W))[None, :])
        X = torch.where(keep[None], X, 0.0)
    if flip_y:
        X = torch.flip(X, (1,))
    if flip_x:
        X = torch.flip(X, (2,))
    if angle:
        y_src, x_src = rotation_source(H, W, angle, X.device)
        xi = torch.round(x_src).to(torch.int64)
        yi = torch.round(y_src).to(torch.int64)
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        src = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        X = torch.where(ok[None], X.reshape(T, H * W)[:, src], 0.0)
    return X


def transform_anchors(anchor_y, anchor_x, angle, flip_y, flip_x, dy, dx,
                      sizey, sizex):
    """The anchor transform on f64 [T, A] arrays (``transform_anchors`` of
    the JAX package, reference data_utils.py:64-137): translate (anchors
    within 1 px of the border or beyond -> NaN), flip about (size+1)/2,
    rotate with round and in-bounds drop, then round. NaN marks a dropped
    anchor. Returns (anchor_y, anchor_x)."""
    y = np.array(anchor_y, np.float64)
    x = np.array(anchor_x, np.float64)
    if dy:
        y = y + dy
        y = np.where((y <= 1) | (y >= sizey - 1), np.nan, y)
    if dx:
        x = x + dx
        x = np.where((x <= 1) | (x >= sizex - 1), np.nan, x)
    y_mid = (sizey + 1) / 2.0
    x_mid = (sizex + 1) / 2.0
    if flip_y:
        y = y_mid + (y_mid - y)
    if flip_x:
        x = x_mid + (x_mid - x)
    if angle:
        theta = angle * np.pi / 180.0
        x_rot = np.round((x - x_mid) * np.cos(theta)
                         + (y - y_mid) * np.sin(theta) + x_mid)
        y_rot = np.round(-(x - x_mid) * np.sin(theta)
                         + (y - y_mid) * np.cos(theta) + y_mid)
        with np.errstate(invalid='ignore'):
            ok = (x_rot > 0) & (x_rot < sizex) & (y_rot > 0) & (y_rot < sizey)
        x = np.where(ok, x_rot, np.nan)
        y = np.where(ok, y_rot, np.nan)
    return np.round(y), np.round(x)


def apply_transformations(transform_configs, X, target, sizey, sizex, rng):
    """Draw a fresh config from ``rng`` and transform the frames and the
    anchors together (``axtrack_tpu``'s ``apply_transformations``,
    reference data_utils.py:139-174). X: [T, H, W] tensor; target: the
    port's label table, a dict with f64 [T, A] 'anchor_y' and 'anchor_x'
    (its other keys are kept). Returns (X, target, the drawn config)."""
    transform_configs = draw_transform_config(transform_configs, rng)
    dy, dx, flip_y, flip_x, angle = config_to_transform_params(
        transform_configs)
    X = transform_frames(X, dy=dy, dx=dx, flip_y=flip_y, flip_x=flip_x,
                         angle=angle or 0.0)
    anchor_y, anchor_x = transform_anchors(
        target['anchor_y'], target['anchor_x'], angle, flip_y, flip_x, dy,
        dx, sizey, sizex)
    target = dict(target, anchor_y=anchor_y, anchor_x=anchor_x)
    return X, target, transform_configs
