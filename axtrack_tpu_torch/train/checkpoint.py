"""Checkpoints as ``torch.save`` files.

PyTorch counterpart of ``axtrack_tpu/train/checkpoint.py`` (reference
utils.py:258-288): one ``E%04d.pt`` file per saved epoch holding the model
``state_dict`` (parameters and BatchNorm statistics), the Adam state and
the epoch. The reference's own ``E*.pth`` files load too, their weights
only (``models/torch_convert.py``). ``state_from_jax`` carries a JAX
training checkpoint across (then ``parallel.mesh.distribute_state`` onto a
mesh). A state on a mesh is saved in the single-device layout.
"""
import glob
import os

import numpy as np
import torch

from .. import config
from ..models.torch_convert import load_torch_checkpoint
from ..models.yolo import build_model, weights_from_jax
from ..parallel.mesh import gathered_state_dict, param_pieces


def save_checkpoint(state, filename, include_opt=True):
    """Save model + optimizer + epoch to ``filename`` (``.pt`` appended
    when missing). include_opt=False drops the Adam moments, as deployment
    bundles do. A state on a mesh is saved in the single-device layout:
    the shards of its split FC layers, and of their optimizer moments,
    put back together, so ``deploy_run`` serves it and ``LOAD_MODEL``
    resumes it on one device. Returns the path."""
    print('=> Saving model checkpoint')
    path = filename if filename.endswith('.pt') else f'{filename}.pt'
    ckpt = {'model': gathered_state_dict(state.model),
            'epoch': int(state.epoch)}
    if include_opt:
        ckpt['optimizer'] = gathered_optimizer_state(state)
    torch.save(ckpt, path)
    return path


def gathered_optimizer_state(state):
    """The optimizer's ``state_dict`` on the CPU as the single-device
    model's optimizer would hold it: a split parameter's moments joined
    like the parameter (``parallel.mesh.param_pieces``)."""
    opt = state.optimizer.state_dict()
    if len(opt['param_groups']) != 1:
        raise ValueError('a checkpoint holds one parameter group')
    pieces = param_pieces(state.model)

    def join(key, value, parts, dim):
        if not torch.is_tensor(value):
            return value
        if value.dim() == 0:
            return value.detach().cpu()
        return torch.cat([s[key].detach().cpu() for s in parts], dim)
    opt['state'] = {}
    for i, (_, tensors, dim) in enumerate(pieces):
        parts = [state.optimizer.state.get(t) for t in tensors]
        if parts[0]:
            opt['state'][i] = {k: join(k, v, parts, dim)
                               for k, v in parts[0].items()}
    opt['param_groups'][0]['params'] = list(range(len(pieces)))
    return opt


def checkpoint_file(load_model):
    """The checkpoint file ``load_model`` names: a ``.pt`` or ``.pth``
    path, a directory (the first ``E*.pt`` in it, as the reference takes
    the first of a sorted glob, else the first ``E*.pth``), or [exp_name,
    run, epoch|'latest'] under OUTPUT_DIR/runs."""
    if isinstance(load_model, (str, os.PathLike)):
        load_model = str(load_model)
        if load_model.endswith(('.pt', '.pth')):
            return load_model
        cands = (sorted(glob.glob(f'{load_model}/E*.pt'))
                 or sorted(glob.glob(f'{load_model}/E*.pth')))
        if not cands:
            raise FileNotFoundError(
                f'no E*.pt or E*.pth checkpoint in {load_model}')
        return cands[0]
    exp_name, run, epoch = load_model
    from ..utils.rundirs import get_run_dir
    run_dir = get_run_dir(f'{config.OUTPUT_DIR}/runs/{exp_name}/', run)
    if epoch == 'latest':
        cands = sorted(glob.glob(f'{run_dir}/models/E*.pt'))
        if not cands:
            raise FileNotFoundError(f'no checkpoint in {run_dir}/models')
        return cands[-1]
    return f'{run_dir}/models/E{epoch:0>4}.pt'


def restore(ckpt, state):
    """Load a checkpoint dict ({'model', 'optimizer'?, 'epoch'}) into a
    TrainState; without 'optimizer' the Adam state stays as it is."""
    state.model.load_state_dict(ckpt['model'])
    if ckpt.get('optimizer') is not None:
        state.optimizer.load_state_dict(ckpt['optimizer'])
    state.epoch = int(ckpt.get('epoch', 0))


def load_checkpoint(load_model, state):
    """Restore the checkpoint ``load_model`` names into ``state``
    (reference utils.py:265-288). A reference ``.pth`` file gives the
    weights only: the Adam state and the epoch stay as they are."""
    file = checkpoint_file(load_model)
    print(f'=> Loading model checkpoint... {file}', flush=True)
    if file.endswith('.pth'):
        state.model.load_state_dict(load_torch_checkpoint(file, state.P))
        return
    restore(torch.load(file, map_location='cpu', weights_only=True), state)


def state_from_jax(ckpt_np, P):
    """A checkpoint dict of the port from a JAX training checkpoint given
    as numpy trees: 'params', 'batch_stats', optionally the Adam moments
    'mu', 'nu' (trees shaped like 'params') with their step 'count', and
    'epoch'. Weights and moments go through ``weights_from_jax``, so FC1's
    rows of both are permuted to the NCHW flatten order. The learning rate
    is the one the JAX run holds at that epoch."""
    from .engine import make_optimizer
    stats = ckpt_np['batch_stats']
    epoch = int(np.asarray(ckpt_np.get('epoch', 0)))
    out = {'model': weights_from_jax({'params': ckpt_np['params'],
                                      'batch_stats': stats}, P),
           'epoch': epoch}
    if 'mu' in ckpt_np:
        model = build_model(P)
        mu = weights_from_jax({'params': ckpt_np['mu'], 'batch_stats': stats},
                              P)
        nu = weights_from_jax({'params': ckpt_np['nu'], 'batch_stats': stats},
                              P)
        step = torch.tensor(float(np.asarray(ckpt_np['count'])),
                            dtype=torch.float32)
        opt = make_optimizer(model, P, epoch).state_dict()
        opt['state'] = {i: {'step': step.clone(), 'exp_avg': mu[name],
                            'exp_avg_sq': nu[name]}
                        for i, (name, _) in enumerate(
                            model.named_parameters())}
        out['optimizer'] = opt
    return out
