"""Batched masked geodesic distance transform — the plain PyTorch version.

Counterpart of ``axtrack_tpu/ops/geodesic.py``. For every source detection
it computes the 4-connected geodesic step distance over a window of the
segmentation mask (off-mask cells impassable, the source cell always
passable, INF = 1e9 where unreachable), by Gauss-Seidel chamfer sweeps:
each sweep scans the rows top->bottom and then bottom->top; per row,
``cand = min(d, prev + 1)`` and then an obstacle-respecting min-plus
relaxation along the row.

The row relaxation is written as two segmented prefix-min scans: within a
run of passable cells, ``min_j (c[j] + |i - j|)`` equals
``i + cummin_j (c[j] - j)`` from the left (and the mirror from the right),
and a run restarts at every blocked cell. That is the same function as the
(c, k) associative scan of the JAX version; every value is an exact
integer below 2**24 or exactly INF, so the two are bit-equal.

This module is the reference the CUDA kernel (``geodesic_cuda.py``,
``csrc/chamfer.cu``) is held to, and what the CPU runs.
"""
import torch

from ..config import resolve_device

INF = 1e9
INF_I = 1_000_000_000
# separates segments in the segmented prefix-min; larger than any c - j
_SEG = 1 << 32


def _row_min_plus(c, passable):
    """min over j in i's passable run of c[j] + |i - j| (forward and
    backward), INF on blocked cells. c: int64[..., W] in [0, INF]."""
    W = c.shape[-1]
    idx = torch.arange(W, device=c.device, dtype=torch.int64)
    c = torch.where(passable, c, INF_I)
    seg = torch.cumsum(~passable, -1, dtype=torch.int64) * _SEG
    fwd = torch.cummin(c - idx - seg, -1).values + idx + seg
    c_r, p_r = c.flip(-1), passable.flip(-1)
    seg_r = torch.cumsum(~p_r, -1, dtype=torch.int64) * _SEG
    bwd = (torch.cummin(c_r - idx - seg_r, -1).values + idx + seg_r).flip(-1)
    return torch.where(passable, torch.minimum(fwd, bwd), INF_I)


def _sweep(d, passable):
    """One chamfer iteration over int64 maps d[N, H, W] (in place)."""
    H = d.shape[1]
    for rows in (range(H), range(H - 1, -1, -1)):
        prev = torch.full_like(d[:, 0], INF_I)
        for r in rows:
            cand = torch.minimum(d[:, r], prev + 1)
            prev = _row_min_plus(cand, passable[:, r])
            d[:, r] = prev
    return d


def chamfer_plain(crops, local, sweeps, init=None):
    """Chamfer sweeps over crops, the plain core of K1's plain version
    (``geodesic_cuda.chamfer_windows_plain``).

    crops: bool/uint8 [N, W, W] passable flags, source cells already forced
      passable; local: int [N, 2] source (y, x) in each crop (a source
      outside its crop seeds nothing); init: optional f32 [N, W, W] maps
      to CONTINUE from.
    Runs ``sweeps`` sweeps (stopping early at the fixpoint, which changes
    no value) and returns f32 [N, W, W] step distances, INF unreachable.
    """
    passable = crops.to(torch.bool)
    N, W, _ = passable.shape
    if init is None:
        d = torch.full((N, W, W), INF_I, dtype=torch.int64,
                       device=passable.device)
        n, ly, lx = _inside(local.to(passable.device), W)
        d[n, ly, lx] = 0
    else:
        d = init.to(torch.int64)
    for _ in range(sweeps):
        before = d.clone()
        _sweep(d, passable)
        if torch.equal(before, d):
            break
    return d.to(torch.float32)


def _inside(local, window):
    """(window index, y, x) of the sources whose cell lies inside their
    window. A source outside it (a detection in the zero padding of the
    last tile row or column, or at a slightly negative coordinate) seeds
    nothing, so its map stays INF: the semantics of the TPU kernel."""
    local = local.to(torch.int64)
    ok = ((local >= 0) & (local < window)).all(dim=1)
    n = torch.nonzero(ok).squeeze(1)
    return n, local[n, 0], local[n, 1]


def window_origins(srcs_yx, window, Hp, Wp):
    """Crop origins (oy, ox) clipped into the padded frame, and the sources'
    local coordinates inside their crops."""
    oy = (srcs_yx[:, 0] - window // 2).clamp(0, Hp - window)
    ox = (srcs_yx[:, 1] - window // 2).clamp(0, Wp - window)
    origins = torch.stack([oy, ox], -1)
    return origins, srcs_yx - origins


def crops_for(passable_padded, origins, local, window):
    """bool [N, W, W] windows of the padded mask at ``origins`` with each
    source cell inside its window forced passable (A* ignores the start
    cell's weight)."""
    ar = torch.arange(window, device=passable_padded.device)
    rows = (origins[:, 0, None] + ar)[:, :, None]
    cols = (origins[:, 1, None] + ar)[:, None, :]
    crops = passable_padded[rows, cols]
    n, ly, lx = _inside(local, window)
    crops[n, ly, lx] = True
    return crops


def _batched_windows(passable_padded, srcs_yx, window, max_sweeps):
    """Distance maps for N sources on per-source crops (plain version of
    ``_batched_windows`` in ``axtrack_tpu/ops/geodesic.py``).

    passable_padded: bool[Hp, Wp] (pre-padded so any window fits).
    srcs_yx: int[N, 2] source coords in padded frame coords.
    Returns (dmaps f32[N, window, window], origins int64[N, 2]).
    """
    Hp, Wp = passable_padded.shape
    srcs = torch.as_tensor(srcs_yx, device=passable_padded.device)
    srcs = srcs.to(torch.int64).reshape(-1, 2)
    origins, local = window_origins(srcs, window, Hp, Wp)
    crops = crops_for(passable_padded, origins, local, window)
    return chamfer_plain(crops, local, max_sweeps), origins


def batched_windows(passable_padded, srcs_yx, window, max_sweeps=8,
                    converge=False, bits=None):
    """Distance maps for N sources. CUDA tensors go through the chamfer
    kernel (``geodesic_cuda``), CPU tensors through the plain version.
    ``bits`` is the caller's ``geodesic_cuda.pack_mask(passable_padded)``.

    converge=True guarantees exactness on any mask geometry: the maps are
    certified with the local-consistency check and the sweep budget doubles
    until it holds (``geodesic_cuda.batched_windows_converged``).
    """
    from . import geodesic_cuda as GC
    if converge:
        return GC.batched_windows_converged(passable_padded, srcs_yx, window,
                                            max_sweeps=max_sweeps, bits=bits)
    if passable_padded.is_cuda:
        dmaps, origins, _ = GC.batched_windows_probed(
            passable_padded, srcs_yx, window, max_sweeps, bits=bits)
        return dmaps, origins
    return _batched_windows(passable_padded, srcs_yx, window, max_sweeps)


def gather_targets(dmaps, origins, tgts_yx, max_dist, window):
    """Read target distances from each source's window.

    Returns f32[N_src, N_tgt] node-count distances (steps + 1); targets
    outside the window or beyond ``max_dist`` read ``max_dist``, the
    reference's "unreachable" (mincostflow_models.py:103-118).
    """
    ly = tgts_yx[None, :, 0] - origins[:, 0, None]             # [N, M]
    lx = tgts_yx[None, :, 1] - origins[:, 1, None]
    inside = (ly >= 0) & (ly < window) & (lx >= 0) & (lx < window)
    n = torch.arange(len(dmaps), device=dmaps.device)[:, None]
    steps = dmaps[n, ly.clamp(0, window - 1), lx.clamp(0, window - 1)]
    nodecount = steps + 1.0
    ok = inside & (nodecount <= max_dist)
    return torch.where(ok, nodecount, float(max_dist))


def gather_pairs(dmaps, origins, rows, tgts_yx, max_dist, window):
    """``gather_targets`` of many (sources, targets) pairs of one set of
    maps in one batch: entry [p, i, j] is ``gather_targets(dmaps[rows[p]],
    origins[rows[p]], tgts_yx[p], max_dist, window)[i, j]``, the same
    reads and comparisons.

    rows: int64 [P, S] each pair's source rows of ``dmaps`` (padding rows
      name any valid row); tgts_yx: int64 [P, M, 2] each pair's targets
      (padding targets any coordinates). Returns f32 [P, S, M].
    """
    org = origins[rows]                                        # [P, S, 2]
    ly = tgts_yx[:, None, :, 0] - org[:, :, None, 0]           # [P, S, M]
    lx = tgts_yx[:, None, :, 1] - org[:, :, None, 1]
    inside = (ly >= 0) & (ly < window) & (lx >= 0) & (lx < window)
    steps = dmaps[rows[:, :, None], ly.clamp(0, window - 1),
                  lx.clamp(0, window - 1)]
    nodecount = steps + 1.0
    ok = inside & (nodecount <= max_dist)
    return torch.where(ok, nodecount, float(max_dist))


def geodesic_pairwise(mask, sources_yx, targets_yx, max_dist=500,
                      window=1024, max_sweeps=8, device=None):
    """All-pairs geodesic node-count distances between two point sets on a
    mask (``axtrack_tpu``'s ``geodesic_pairwise``): the device-side
    drop-in for ``native.astar_pairwise``, with unreachable encoded as
    ``max_dist`` (the reference's distance capping).

    Exactness condition: ``window >= 2*max_dist + 1`` (any geodesic of
    <= max_dist steps stays within the source's L1 ball, which then fits
    the crop). A smaller window under-reports far distances as the cap;
    so do too few sweeps on a mask whose geodesics turn back often (the
    maps are not certified here: ``max_sweeps`` sweeps run, no more).

    mask: bool[H, W] (True = passable); sources_yx, targets_yx: int[N, 2]
    / int[M, 2] (y, x); each a numpy array or a tensor. The window is
    clamped to the mask (a multiple of 8) and the mask padded at the
    bottom and right to fit it. On a card the maps come from K1
    (``geodesic_cuda.batched_windows_probed``), which takes windows of at
    most 1024 and raises its ``ValueError`` for a larger one; there is no
    fallback to the plain version. On the CPU the plain version runs.
    Returns f32[N, M] on ``device`` (``config.resolve_device``: the card
    unless the CPU is asked for).
    """
    dev = resolve_device(device)
    mask = torch.as_tensor(mask).to(device=dev, dtype=torch.bool)
    H, W = mask.shape
    window = min(window, max(_round_up(max(H, W), 8), 8))
    padded = torch.nn.functional.pad(
        mask, (0, max(window - W, 0), 0, max(window - H, 0)))
    srcs = torch.as_tensor(sources_yx).to(dev, torch.int64).reshape(-1, 2)
    tgts = torch.as_tensor(targets_yx).to(dev, torch.int64).reshape(-1, 2)
    dmaps, origins = batched_windows(padded, srcs, window, max_sweeps)
    return gather_targets(dmaps, origins, tgts, max_dist, window)


def _round_up(x, m):
    return -(-x // m) * m
