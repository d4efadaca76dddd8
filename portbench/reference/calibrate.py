"""BatchNorm statistics for seeded weights, as a trained checkpoint has
them: those of the data the detector serves.

A net drawn with PyTorch's default initialisation has every BatchNorm at
identity (running mean 0, variance 1). Normalising with those, a deep
trunk without a residual path on most of its layers shrinks its signal
layer by layer (MobileNetV3-Small's features reach a std of ~1e-8), every
tile gives the same detections, and a comparison of detections cannot see
the trunk. Calibrated, each BatchNorm normalises its input as training
would have left it.

``batch`` makes the calibration tiles from a raw movie the way
``detect.grids`` feeds the CNN: its first ``FRAMES`` centre frames with
their +-TEMPORAL_CONTEXT neighbours, preprocessed with the bundle's
scaler, tiled, the kept tiles, each centre frame's stack as
``detect.centre_stacks`` gives it. ``calibrate`` runs the reference trunk
once over them in train mode under ``model.exact`` and writes each
BatchNorm's batch mean and biased variance, the statistics it normalised
with (``model.bn`` reports them), into that layer's ``running_mean`` and
``running_var``. In one pass layer k's statistics are taken with the
earlier layers normalised by their own, so the calibrated net's eval
forward on this batch is its train forward.

Plain torch; imports nothing of the program.
"""
import contextlib

import torch

from . import detect as D
from . import model as M

MEAN = '.running_mean'
# centre frames in the calibration batch, the same for every configuration
FRAMES = 2


def batch(raw, mask, var, params, device):
    """The calibration tiles f32[FRAMES * K, C, ts, ts] of a raw uint16
    movie [T, H, W] and its mask, centre frame by centre frame."""
    ts, tc = params['TILESIZE'], params['TEMPORAL_CONTEXT']
    x = D.preprocess(raw[:FRAMES + 2 * tc], mask, var, device,
                     log_correct=params['LOG_CORRECT'])
    t, _, _ = D.tiles(x, ts)
    del x
    return torch.cat(list(D.centre_stacks(t[:, D.kept_tiles(t)], tc)))


@contextlib.contextmanager
def _exact():
    """``model.exact`` and cuDNN's deterministic algorithms inside the
    block, the switches as they were after it (the program's set-up
    follows)."""
    c, m = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = c.allow_tf32, m.allow_tf32, c.benchmark, c.deterministic
    c.benchmark, c.deterministic = False, True
    M.exact()
    try:
        yield
    finally:
        c.allow_tf32, m.allow_tf32, c.benchmark, c.deterministic = saved


def _batchnorms(a):
    """Every BatchNorm's dict of tensors (``model.bn_sd``) in a net."""
    if isinstance(a, dict):
        if {'scale', 'bias', 'mean', 'var'} <= set(a):
            yield a
        else:
            for v in a.values():
                yield from _batchnorms(v)
    elif isinstance(a, (list, tuple)):
        for v in a:
            yield from _batchnorms(v)


def calibrate(sd, params, tiles):
    """A copy of the state dict ``sd`` (the reference's PyTorch names)
    whose every BatchNorm's running statistics are those of ``tiles``; a
    ValueError where the trunk normalises with a BatchNorm that is not the
    state dict's, with one twice, or never with one the state dict holds."""
    layers = {id(v): k[:-len(MEAN)] for k, v in sd.items()
              if k.endswith(MEAN)}
    net = M.from_state_dict(sd, params)
    found = {}
    for p in _batchnorms(net['trunk']):
        if id(p['mean']) not in layers:
            raise ValueError('the trunk holds a BatchNorm whose running_mean '
                             'is not the state dict\'s own')
        pre = layers[id(p['mean'])]
        if found.setdefault(pre, p) is not p:
            raise ValueError(f'the trunk holds {pre} twice')
        p['batch'] = []
    with _exact(), torch.no_grad():
        M.trunk(net, tiles, M.Ops(), train=True)
    out = dict(sd)
    for pre in sorted(set(layers.values())):
        seen = found[pre]['batch'] if pre in found else []
        if len(seen) != 1:
            raise ValueError(f'the trunk normalised with {pre} {len(seen)} '
                             f'times in one pass')
        out[pre + MEAN], out[pre + '.running_var'] = seen[0]
    return out
