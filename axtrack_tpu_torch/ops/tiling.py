"""Frame <-> tile-grid conversion (``axtrack_tpu/ops/tiling.py``'s
counterpart).

Tiles come from a zero-pad and a reshape, not from per-tile splits, and the
non-empty-tile mask becomes a gather index so the detector only sees
occupied tiles (reference Timelapse.py:492-566).
"""
import numpy as np
import torch
import torch.nn.functional as F


def n_tiles(size, tilesize):
    return -(-size // tilesize)


def tile_frames(frames, tilesize):
    """[..., H, W] -> [..., ny, nx, ts, ts], zero-padding the bottom/right
    edge tiles (reference pads with ZeroPad2d, Timelapse.py:524-528)."""
    *lead, H, W = frames.shape
    ny, nx = n_tiles(H, tilesize), n_tiles(W, tilesize)
    x = F.pad(frames, (0, nx * tilesize - W, 0, ny * tilesize - H))
    x = x.reshape(*lead, ny, tilesize, nx, tilesize)
    return x.movedim(-3, -2)


def untile_frames(tiles, H, W):
    """Inverse of tile_frames: [..., ny, nx, ts, ts] -> [..., H, W]."""
    *lead, ny, nx, ts, _ = tiles.shape
    x = tiles.movedim(-2, -3).reshape(*lead, ny * ts, nx * ts)
    return x[..., :H, :W]


def nonempty_tile_mask(tiles):
    """[T, ny, nx, ts, ts] -> bool[ny, nx] numpy: tile has any pixel > 0 in
    any frame (Timelapse.py:551-558)."""
    return (tiles > 0).any(dim=4).any(dim=3).any(dim=0).cpu().numpy()


def tile_index_table(keep_mask):
    """Flat indices (into ny*nx) of kept tiles + their (ty, tx) coordinates,
    row-major over the tile grid (Timelapse.py:141-148). numpy int32."""
    keep_mask = np.asarray(keep_mask)
    flat = np.flatnonzero(keep_mask.ravel()).astype(np.int32)
    ty, tx = np.divmod(flat, keep_mask.shape[1])
    return flat, np.stack([ty, tx], -1).astype(np.int32)


def temporal_context_stack(frames_tiled, center_indices, temporal_context=2):
    """Per-frame detector input: each center frame with its
    +-temporal_context neighbours as channels (Timelapse.py:111-125).

    frames_tiled: f32[T_all, K, ts, ts]; center_indices: int[T].
    Returns f32[T, K, ts, ts, C] (NHWC, as ``axtrack_tpu``'s version)."""
    offs = torch.arange(-temporal_context, temporal_context + 1,
                        device=frames_tiled.device)
    idx = torch.as_tensor(center_indices, device=frames_tiled.device)
    x = frames_tiled[idx[:, None] + offs[None, :]]        # [T, C, K, ts, ts]
    return x.movedim(1, -1)
