"""Preprocessing ops on dense ``f32[T, H, W]`` tensors.

PyTorch counterpart of ``axtrack_tpu/ops/preproc.py``: mask -> intensity
offset -> clip -> log-adjust -> standardize, elementwise on whatever device
the frames live on. Statistics follow the reference: per-frame mean/std
over the *nonzero* pixels only (Timelapse.py:290-291).

``staged_preprocess_u16`` is the same chain on raw uint16 frames, for
movies kept as integers on the host (``data/timelapse.py``'s staged mode):
with the same ops in the same order as the whole-movie path, a staged
movie's frames are bit-equal to the whole movie's on one device.
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


def u16_to_float(raw):
    """img_as_float32 of raw uint16 frames on their device: the integers
    (uint16, or their bits as int16) as f32, divided by 65535 and rounded
    once, as numpy divides. The divisor is a tensor on the frames' device:
    with a Python number PyTorch's CUDA kernel multiplies by its
    reciprocal, which rounds some quotients the other way, and a movie
    converted on the host would then differ from one converted on the
    card."""
    if raw.dtype == torch.uint16:
        raw = raw.view(torch.int16)
    x = (raw.to(torch.int32) & 0xffff).to(torch.float32)
    return x / torch.tensor(65535.0, device=x.device)


def staged_preprocess_u16(raw, offset, clip_lowerlim, var_scalar,
                          log_correct=True):
    """``preprocess_frames`` for raw uint16 frames (``axtrack_tpu``'s
    ``staged_preprocess_u16``): u / 65535, then max(x - offset, 0), the
    clip, log2(1 + x) and the division by ``var_scalar``. Mask and padding
    were applied to the integers. Returns f32[T, H, W]."""
    x = torch.clamp_min(u16_to_float(raw) - offset, 0.0)
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
    return stnd_scaler_from_stats(*nonzero_stats(frames), standardize)


def stnd_scaler_from_stats(mean, std, mx, standardize='zscore'):
    """``compute_stnd_scaler`` from the per-frame (mean, std, max) of every
    frame, e.g. concatenated over chunks of frames."""
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
