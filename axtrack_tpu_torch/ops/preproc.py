"""Preprocessing ops on dense ``f32[T, H, W]`` tensors.

PyTorch counterpart of ``axtrack_tpu/ops/preproc.py``: mask -> intensity
offset -> clip -> log-adjust -> standardize, elementwise on whatever device
the frames live on. Statistics follow the reference: per-frame mean/std
over the *nonzero* pixels only (Timelapse.py:290-291).

Motion frames (``motion_frames``) and the staged-u16 path are not on the
deployed inference path; they come with the training port (ROADMAP M13).
"""
import torch


def adjust_log(image, gain=1.0):
    """skimage.exposure.adjust_log for float images: gain * log2(1 + x)."""
    return gain * torch.log2(1.0 + image)


def preprocess_frames(imseq, mask, offset, clip_lowerlim, var_scalar,
                      log_correct=True):
    """Fused per-pixel preprocessing chain (see ``axtrack_tpu``'s
    ``preprocess_frames`` for the reference line of each step).

    Args:
      imseq: f32[T, H, W] raw intensities in [0, 1].
      mask: bool[H, W] or [T, H, W], or None; pixels outside are zeroed.
      offset: scalar subtracted then clamped at 0; 0.0 for none.
      clip_lowerlim: values below this become 0; 0.0 for none.
      var_scalar: standardization divisor; 1.0 for none.
    Returns f32[T, H, W].
    """
    x = imseq
    if mask is not None:
        m = mask.to(torch.bool)
        if m.ndim == 2:
            m = m[None]
        x = torch.where(m, x, 0.0)
    x = torch.clamp_min(x - offset, 0.0)
    x = torch.where(x < clip_lowerlim, 0.0, x)
    if log_correct:
        x = adjust_log(x)
    return x / var_scalar


def nonzero_stats(frames):
    """Per-frame (mean, std, max) over nonzero pixels; std is the population
    std (ddof=0). Returns three f32[T] tensors."""
    nz = frames != 0
    n = nz.sum(dim=(1, 2)).clamp_min(1)
    s = frames.sum(dim=(1, 2))
    mean = s / n
    dev = torch.where(nz, (frames - mean[:, None, None]) ** 2, 0.0)
    var = dev.sum(dim=(1, 2)) / n
    mx = frames.amax(dim=(1, 2))
    return mean, torch.sqrt(var), mx


def compute_stnd_scaler(frames, standardize='zscore'):
    """Movie-global standardization scalars from per-frame nonzero stats
    (Timelapse.py:296-300). Returns (var_scalar, mean_scalar) floats."""
    mean, std, mx = nonzero_stats(frames)
    if standardize == 'zscore':
        return float(std.mean()), float(mean.mean())
    if standardize == '0to1':
        return float(mx.max()), 0.0
    raise ValueError(f'unknown standardize mode {standardize!r}')
