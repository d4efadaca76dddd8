"""Preprocessing ops on dense ``f32[T, H, W]`` tensors.

PyTorch counterpart of ``axtrack_tpu/ops/preproc.py``: mask -> intensity
offset -> clip -> log-adjust -> standardize, elementwise on whatever device
the frames live on. Statistics follow the reference: per-frame mean/std
over the *nonzero* pixels only (Timelapse.py:290-291).

The staged-u16 path of the JAX package is not ported (ROADMAP M13b).
"""
import torch
import torch.nn.functional as F


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


def gaussian_kernel1d(sigma, truncate=4.0):
    radius = int(truncate * float(sigma) + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(frames, sigma=3.0):
    """Separable gaussian blur of [T, H, W] with zero padding (the JAX
    package's ``gaussian_blur``, replacing skimage.filters.gaussian,
    Timelapse.py:340)."""
    k = gaussian_kernel1d(sigma).to(frames.device)
    r = (k.shape[0] - 1) // 2
    x = F.conv2d(frames[:, None], k.reshape(1, 1, -1, 1), padding=(r, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1), padding=(0, r))
    return x[:, 0]


def motion_frames(frames, sigma=3.0, lowerlim=0.1):
    """Temporal-difference motion channels (deprecated in the reference,
    Timelapse.py:328-368): the blurred frame difference split into its
    positive and negative parts, |diff| < lowerlim zeroed. Returns
    (pos [T, H, W], neg [T, H, W]); frame 0 is zeros."""
    diff = gaussian_blur(frames[1:] - frames[:-1], sigma)
    diff = torch.where(diff.abs() < lowerlim, 0.0, diff)
    zero = torch.zeros_like(frames[:1])
    return (torch.cat([zero, diff.clamp_min(0.0)]),
            torch.cat([zero, (-diff).clamp_min(0.0)]))
