"""A configuration's bundle and weights.

A configuration file names a bundle directory of the checkout (its
params.json, scaler and checkpoint), parameter overrides, and where the
weights come from, by one of three recipes:

- ``"weights": "bundle"`` serves the bundle's own checkpoint as a user
  does (``setup_inference(dest_dir)``, no weights argument);
- ``"weights": "seeded"`` draws them on the device (``seeded_state_dict``)
  from the configuration's ``weights_seed`` and hands them over as
  ``weights=``, so that every run serves the same detector (a random
  net's detections, and with them the association's load, depend on its
  weights), and the run's seed draws the movies; BatchNorm sits at
  identity (running mean 0, variance 1);
- ``"weights": "seeded"`` with ``"calibration": "<mix>"`` draws the same
  weights and then gives every BatchNorm the statistics a trained
  checkpoint's would have, those of the data it serves (``calibrated``):
  one movie of the mix ``traffic/<mix>.json`` made from ``weights_seed``,
  the kept tiles of its first ``calibrate.FRAMES`` centre frames through
  the reference trunk in train mode (``reference/calibrate.py``). At
  identity a deep trunk without a residual path on most of its layers
  shrinks its signal to nothing (MobileNetV3-Small's features reach a std
  of ~1e-8), every tile gives the same detections, and the check cannot
  see the trunk. The weights depend on the configuration alone: one net
  for every run and cell of it. The calibration runs in set-up, but its
  seconds (``ctx.calibration_s``) are left out of ``setup_s``, as the
  reference check's are: it is the reference's work, and a user's set-up
  loads a checkpoint instead.

A bundle with overrides is written, with its scaler, under the run's
temporary directory.
"""
import json
import math
import os
import pickle
import shutil
import time

import torch

from ..reference import calibrate as C
from . import movie

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'traffic')


def bundle_dir(ctx):
    return os.path.join(ctx.root, ctx.config['bundle'])


def params_json(ctx):
    """The bundle's params.json as stored (tuples as {'__tuple__': ..}),
    with the configuration's overrides."""
    with open(os.path.join(bundle_dir(ctx), 'params.json')) as f:
        P = json.load(f)
    P.update(ctx.config.get('overrides', {}))
    return P


def bundle(ctx):
    """(the bundle directory to serve, the weights argument)."""
    src = bundle_dir(ctx)
    if ctx.config.get('overrides'):
        dst = os.path.join(ctx.tmp, 'bundle')
        os.makedirs(dst, exist_ok=True)
        with open(os.path.join(dst, 'params.json'), 'w') as f:
            json.dump(params_json(ctx), f, indent=1)
        shutil.copy(os.path.join(src, 'train_stnd_scaler.pkl'), dst)
        src = dst
    if ctx.config['weights'] == 'bundle':
        if ctx.config.get('overrides'):
            raise ValueError('a bundle checkpoint serves the bundle as it '
                             'is: overrides need seeded weights')
        if 'calibration' in ctx.config:
            raise ValueError('a bundle checkpoint brings its own BatchNorm '
                             'statistics: calibration needs seeded weights')
        return src, None
    sd = seeded_state_dict(port_params(src), ctx.config['weights_seed'],
                           ctx.device)
    if 'calibration' in ctx.config:
        sd = calibrated(ctx, sd)
    return src, sd


def scaler_var(ctx):
    """The bundle's standardisation scaler: the variance the preprocessed
    frames are divided by."""
    with open(os.path.join(bundle_dir(ctx), 'train_stnd_scaler.pkl'),
              'rb') as f:
        _, (var, _mean) = pickle.load(f)
    return var


def calibrated(ctx, sd):
    """``sd`` with every BatchNorm's running statistics those of the
    configuration's calibration batch (see the module docstring); the
    seconds it took in ``ctx.calibration_s``."""
    sync = (torch.cuda.synchronize if ctx.device.type == 'cuda'
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    with open(os.path.join(TRAFFIC,
                           f'{ctx.config["calibration"]}.json')) as f:
        mix = json.load(f)
    P = params_json(ctx)
    mv = movie.make_movie(mix, ctx.config['weights_seed'], ctx.device,
                          P['TILESIZE'])
    tiles = C.batch(mv['raw'], mv['mask'], scaler_var(ctx), P, ctx.device)
    del mv
    out = C.calibrate(sd, P, tiles)
    sync()
    ctx.calibration_s = time.perf_counter() - t0
    return out


def port_params(directory):
    """The port's reading of a bundle's parameters."""
    from axtrack_tpu_torch.params import load_parameters
    return load_parameters(None, None, from_directory=directory)


def seeded_state_dict(P, seed, device):
    """The detector's state dict at P's architecture with PyTorch's default
    initialisation drawn from ``seed`` on ``device`` in one call: every
    conv and linear weight and bias uniform in +-1/sqrt(fan_in) of its
    weight, BatchNorm at identity. Names and shapes are the port's
    (its model built on the meta device)."""
    from axtrack_tpu_torch.models.yolo import build_model
    with torch.device('meta'):
        model = build_model(P)
    sd = model.state_dict()
    uniform, bounds = [], {}
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            b = 1.0 / math.sqrt(m.weight[0].numel())
            for p in ('weight', 'bias'):
                if getattr(m, p) is not None:
                    key = f'{name}.{p}'
                    uniform.append(key)
                    bounds[key] = b
    total = sum(sd[k].numel() for k in uniform)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for key in uniform:
        n = sd[key].numel()
        out[key] = ((u[off:off + n] * 2 - 1) * bounds[key]).reshape(
            sd[key].shape)
        off += n
    for key, v in sd.items():
        if key in out:
            continue
        if key.endswith('num_batches_tracked'):
            out[key] = torch.zeros((), dtype=torch.long, device=device)
        elif key.endswith(('running_var', '.weight')):
            out[key] = torch.ones(v.shape, device=device)
        else:
            out[key] = torch.zeros(v.shape, device=device)
    return out
