"""A configuration's bundle and weights.

A configuration file names a bundle directory of the checkout (its
params.json, scaler and checkpoint), parameter overrides, and where the
weights come from: 'bundle' serves the bundle's own checkpoint as a user
does (``setup_inference(dest_dir)``, no weights argument); 'seeded' draws
them on the device (``seeded_state_dict``) from the configuration's
``weights_seed`` and hands them over as ``weights=``, so that every run
serves the same detector (a random net's detections, and
with them the association's load, depend on its weights), and the run's
seed draws the movies. A bundle with overrides is written, with its
scaler, under the run's temporary directory.
"""
import json
import math
import os
import shutil

import torch


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
        return src, None
    return src, seeded_state_dict(port_params(src),
                                  ctx.config['weights_seed'], ctx.device)


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
