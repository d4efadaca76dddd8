"""Checkpoints as ``torch.save`` files, and the JAX package's orbax
checkpoints read without JAX.

PyTorch counterpart of ``axtrack_tpu/train/checkpoint.py`` (reference
utils.py:258-288): one ``E%04d.pt`` file per saved epoch holding the model
``state_dict`` (parameters and BatchNorm statistics), the Adam state and
the epoch. The reference's own ``E*.pth`` files load too, their weights
only (``models/torch_convert.py``). The JAX package's ``E%04d/`` orbax
directories (OCDBT + zarr v2, ``read_orbax``) load through
``state_from_jax``: weights, epoch and, from a training checkpoint, Adam's
moments and step. A state on a mesh is saved in the single-device layout
(then ``parallel.mesh.distribute_state`` puts it back on a mesh).
"""
import glob
import itertools
import json
import math
import os

import numpy as np
import torch

from .. import config
from ..models.torch_convert import load_torch_checkpoint
from ..models.yolo import build_model, weights_from_jax
from ..parallel.mesh import gathered_state_dict, param_pieces
from ..utils import zstd
from .ocdbt import OcdbtStore


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
    """The checkpoint ``load_model`` names: a ``.pt`` or ``.pth`` path or
    an orbax directory as it is; a directory of checkpoints (its first
    ``E*.pt``, else its first ``E*/`` orbax directory, as the JAX package
    and the reference take the first of a sorted glob, else its first
    ``E*.pth``); or [exp_name, run, epoch|'latest'] under OUTPUT_DIR/runs:
    ``models/E%04d.pt``, else the JAX package's ``models/E%04d/``, and for
    'latest' the highest epoch of either kind."""
    if isinstance(load_model, (str, os.PathLike)):
        load_model = str(load_model)
        if load_model.endswith(('.pt', '.pth')) or _is_orbax(load_model):
            return load_model
        cands = (sorted(glob.glob(f'{load_model}/E*.pt'))
                 or sorted(c for c in glob.glob(f'{load_model}/E*')
                           if os.path.isdir(c))
                 or sorted(glob.glob(f'{load_model}/E*.pth')))
        if not cands:
            raise FileNotFoundError(
                f'no E*.pt, E*/ (orbax) or E*.pth checkpoint in {load_model}')
        return cands[0]
    exp_name, run, epoch = load_model
    from ..utils.rundirs import get_run_dir
    run_dir = get_run_dir(f'{config.OUTPUT_DIR}/runs/{exp_name}/', run)
    if epoch == 'latest':
        cands = [c for c in glob.glob(f'{run_dir}/models/E*')
                 if c.endswith('.pt') or os.path.isdir(c)]
        if not cands:
            raise FileNotFoundError(f'no checkpoint in {run_dir}/models')
        # E%04d names sort by epoch, and an epoch's .pt after its orbax
        # directory
        return sorted(cands)[-1]
    file = f'{run_dir}/models/E{epoch:0>4}.pt'
    orbax = f'{run_dir}/models/E{epoch:0>4}'
    return orbax if not os.path.exists(file) and os.path.isdir(orbax) else file


def _is_orbax(path):
    """Whether ``path`` is an orbax checkpoint directory."""
    return os.path.isfile(os.path.join(str(path), '_METADATA'))


def restore(ckpt, state):
    """Load a checkpoint dict ({'model', 'optimizer'?, 'epoch'}) into a
    TrainState; without 'optimizer' the Adam state stays as it is."""
    state.model.load_state_dict(ckpt['model'])
    if ckpt.get('optimizer') is not None:
        state.optimizer.load_state_dict(ckpt['optimizer'])
    state.epoch = int(ckpt.get('epoch', 0))


def read_checkpoint(file, P):
    """The checkpoint dict ({'model', 'optimizer'?, 'epoch'}) of an
    ``E*.pt`` file or of a JAX orbax directory at architecture P."""
    if os.path.isdir(file):
        return state_from_jax(orbax_arrays(read_orbax(file)), P)
    return torch.load(file, map_location='cpu', weights_only=True)


def load_checkpoint(load_model, state):
    """Restore the checkpoint ``load_model`` names into ``state``
    (reference utils.py:265-288). A reference ``.pth`` file gives the
    weights only, and a JAX deployment bundle (saved without its
    optimizer state) weights and epoch: the rest of the state stays as it
    is."""
    file = checkpoint_file(load_model)
    print(f'=> Loading model checkpoint... {file}', flush=True)
    if file.endswith('.pth'):
        state.model.load_state_dict(load_torch_checkpoint(file, state.P))
        return
    restore(read_checkpoint(file, state.P), state)


# orbax's _METADATA: key types of a tree path and the leaf value types
_SEQUENCE, _DICT = 1, 2
_EMPTY = {'None': lambda: None, 'Dict': dict, 'List': list}
_ARRAYS = ('np.ndarray', 'jax.Array', 'scalar')


def read_orbax(path):
    """The tree an orbax ``PyTreeCheckpointer().restore(path)`` gives (the
    counterpart of the JAX package's ``_restore``), read with numpy and
    the system's libzstd: nested dicts, lists for sequences, numpy arrays
    of the stored dtype and shape, Python scalars for scalar leaves, and
    None, {} or [] for empty ones. Reads checkpoints written with OCDBT
    and zarr v2 (orbax's default); anything else raises ValueError."""
    path = str(path)
    with open(os.path.join(path, '_METADATA')) as f:
        meta = json.load(f)
    if not meta.get('use_ocdbt') or meta.get('use_zarr3'):
        raise ValueError(f'{path}: only OCDBT with zarr v2 is read, this '
                         f'checkpoint has use_ocdbt={meta.get("use_ocdbt")}, '
                         f'use_zarr3={meta.get("use_zarr3")}')
    store = OcdbtStore(path)
    root = {}
    for entry in meta['tree_metadata'].values():
        keys = entry['key_metadata']
        value = entry['value_metadata']['value_type']
        if value in _EMPTY:
            leaf = _EMPTY[value]()
        elif value in _ARRAYS:
            leaf = read_zarr(store, '.'.join(str(k['key']) for k in keys))
            if value == 'scalar':
                leaf = leaf.item()
        else:
            raise ValueError(f'{path}: leaf value type {value!r} is not read')
        node = root
        for k, nxt in zip(keys, keys[1:] + [None]):
            if k['key_type'] not in (_SEQUENCE, _DICT):
                raise ValueError(f'{path}: key type {k["key_type"]} is not '
                                 'read')
            key = int(k['key']) if k['key_type'] == _SEQUENCE else k['key']
            if nxt is None:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})
    return _sequences(root)


def _sequences(root):
    """The dicts whose keys are sequence indices, as lists."""
    def walk(node):
        if not isinstance(node, dict) or not node:
            return node
        out = {k: walk(v) for k, v in node.items()}
        if all(isinstance(k, int) for k in out):
            if sorted(out) != list(range(len(out))):
                raise ValueError(f'sequence indices {sorted(out)} are not '
                                 '0..n-1')
            return [out[i] for i in range(len(out))]
        return out
    return walk(root)


def read_zarr(store, name):
    """The zarr v2 array ``name`` of an OCDBT store: its ``.zarray``, then
    each chunk of its grid, zstd-compressed or raw. A missing chunk is
    the fill value; with none (null) it raises."""
    meta = json.loads(bytes(store.read(f'{name}/.zarray')))
    for key, want in (('zarr_format', 2), ('order', 'C'), ('filters', None)):
        if meta.get(key) != want:
            raise ValueError(f'{name}: {key} {meta.get(key)!r} is not read '
                             f'(only {want!r})')
    comp = meta.get('compressor')
    if comp is not None and comp.get('id') != 'zstd':
        raise ValueError(f'{name}: compressor {comp.get("id")!r} is not '
                         'read (only zstd or none)')
    try:
        dtype = np.dtype(meta['dtype'])
    except TypeError:
        raise ValueError(f'{name}: dtype {meta["dtype"]!r} is not read')
    if dtype.hasobject or dtype.fields:
        raise ValueError(f'{name}: dtype {meta["dtype"]!r} is not read')
    shape, chunks = tuple(meta['shape']), tuple(meta['chunks'])
    if len(chunks) != len(shape) or min(chunks, default=1) < 1:
        raise ValueError(f'{name}: chunks {chunks} for shape {shape}')
    sep = meta.get('dimension_separator', '.')
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    n_bytes = math.prod(chunks) * dtype.itemsize

    def chunk(idx):
        key = f'{name}/{sep.join(map(str, idx)) if shape else "0"}'
        try:
            buf = store.read(key)
        except KeyError:
            if meta.get('fill_value') is None:
                raise ValueError(f'{name}: chunk {key} is missing and the '
                                 'array has no fill value')
            return None
        raw = (zstd.decompress(buf, n_bytes) if comp is not None
               else np.frombuffer(buf, np.uint8))
        if raw.nbytes != n_bytes:
            raise ValueError(f'{name}: chunk {key} holds {raw.nbytes} bytes, '
                             f'expected {n_bytes}')
        return raw.view(dtype).reshape(chunks)

    if tuple(chunks) == shape:
        out = chunk((0,) * len(shape))
        if out is not None:
            return out if comp is not None else out.copy()
    out = np.empty(shape, dtype)
    for idx in itertools.product(*map(range, grid)):
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        got = chunk(idx)
        if got is None:
            out[dst] = _fill(meta['fill_value'], dtype)
        else:
            out[dst] = got[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


def _fill(value, dtype):
    """A zarr v2 fill value (JSON numbers, or 'NaN' / 'Infinity' /
    '-Infinity' for floats)."""
    named = {'NaN': np.nan, 'Infinity': np.inf, '-Infinity': -np.inf}
    return np.asarray(named.get(value, value), dtype)


def orbax_arrays(tree):
    """What ``state_from_jax`` takes, from a JAX checkpoint tree as
    ``read_orbax`` gives it: 'params', 'batch_stats' and 'epoch', and from
    a training checkpoint Adam's 'mu', 'nu' and 'count' out of the JAX
    optimizer ``inject_hyperparams(chain(add_decayed_weights,
    scale_by_adam, scale))`` (``axtrack_tpu/train/engine.py:87-93``),
    whose state is saved as {'count', 'hyperparams', 'hyperparams_states',
    'inner_state': [None, {'count', 'mu', 'nu'}, None]}."""
    out = {'params': tree['params'], 'batch_stats': tree.get('batch_stats',
                                                             {}),
           'epoch': tree.get('epoch', 0)}
    opt = tree.get('opt_state')
    if opt is not None:
        inner = opt.get('inner_state') if isinstance(opt, dict) else None
        adam = (inner[1] if isinstance(inner, list) and len(inner) == 3
                else None)
        if not (isinstance(adam, dict) and {'count', 'mu', 'nu'} <= set(adam)):
            raise ValueError(
                'opt_state is not the JAX package\'s optimizer '
                '(inject_hyperparams(chain(add_decayed_weights, '
                'scale_by_adam, scale))): no inner_state[1] with count, mu '
                'and nu')
        out.update(mu=adam['mu'], nu=adam['nu'], count=adam['count'])
    return out


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
