"""Port parity: the reference's ``.pth`` checkpoints and torchvision
weights (``axtrack_tpu_torch/models/torch_convert.py``).

- A file in the reference's layout, written here with ``torch.save`` (the
  wrapped ``{'state_dict', 'optimizer', 'lr_schedular'}`` with a real Adam
  state, or a bare state dict without BatchNorm counters), goes through
  the JAX package's torch-free reader and through the port's
  ``torch.load(weights_only=True)`` loader: the port's weights must equal
  the JAX package's carried across by ``weights_from_jax`` bit for bit,
  and the grids agree to atol 1e-5 and rtol 1e-5 (f32 summation order).
- A raw torchvision state dict spliced into a backbone: the layers the
  port loads and skips are the JAX package's, and the resulting weights
  equal the JAX package's merged variables exactly.
- A bundle holding only ``E1000.pth``: ``setup_inference -> inference``
  on the CPU gives the JAX package's ``IDed_dets_all``
  (``assert_frame_equal``). No decoded cell may lie within 1e-5 of the
  confidence threshold or within 1e-4 px of a rounding boundary, no two
  within 1e-5 of each other in a frame (their order decides NMS and the
  identity solve's ties), and no detection at a negative coordinate
  (ROADMAP F3), so that f32 summation order cannot decide a detection or
  an identity; the test asserts so.
"""
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from _seeded_flax import seeded_flax_variables
from axtrack_tpu import interface as JI
from axtrack_tpu.models.torch_convert import (
    backbone_state_dict_to_flax, load_torch_checkpoint as jax_load_pth)
from axtrack_tpu.models.yolo import build_model as jax_build_model
from axtrack_tpu.params import load_parameters as jax_load_parameters
from axtrack_tpu.train import engine as JE
from axtrack_tpu_torch import interface as PI
from axtrack_tpu_torch.data.synthetic import make_synthetic_timelapse
from axtrack_tpu_torch.data.tiffio import write_tiff
from axtrack_tpu_torch.models import torch_convert as PT
from axtrack_tpu_torch.models.backbones import BACKBONES, flax_path
from axtrack_tpu_torch.models.yolo import (build_model, init_weights,
                                           weights_from_jax)
from axtrack_tpu_torch.params import get_default_parameters, write_parameters
from axtrack_tpu_torch.train import engine as PE
from axtrack_tpu_torch.train.checkpoint import (checkpoint_file,
                                                load_checkpoint)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS = 64
TINY = [[(3, 8, 2, 1), 'M', (3, 16, 1, 1), 'M'],
        [('FC', 32), ('activation', 'sigmoid')]]


def _P(arch, **kw):
    P = get_default_parameters()
    P.update(ARCHITECTURE=arch, TILESIZE=TS, **kw)
    return P


def _reference_file(path, sd, wrapped=True):
    """``torch.save`` in the reference's layout (utils.py:258-263): the
    state dict with an Adam state after one step and a LambdaLR state."""
    if wrapped:
        params = [torch.nn.Parameter(v.clone()) for k, v in sd.items()
                  if v.is_floating_point() and 'running' not in k]
        opt = torch.optim.Adam(params, lr=5e-4)
        for p in params:
            p.grad = torch.full_like(p, 0.01)
        opt.step()
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda e: 0.9 ** e)
        sd = {'state_dict': sd, 'optimizer': opt.state_dict(),
              'lr_schedular': sched.state_dict()}
    torch.save(sd, path)


def _jax_grid(P, variables, X):
    jm = jax_build_model(P)
    pred = jax.jit(functools.partial(jm.apply, train=False))(variables, X)
    return np.asarray(jm.reshape_grid(pred))


@pytest.mark.parametrize('arch, wrapped', [('tiny', True),
                                           ('mobilenet', True),
                                           ('resnet', False)])
def test_reference_pth_equals_jax(tmp_path, arch, wrapped):
    P = _P(TINY if arch == 'tiny' else arch)
    variables = seeded_flax_variables(jax_build_model(P), P, seed=11)
    sd = weights_from_jax(variables, P)
    if not wrapped:
        sd = {k: v for k, v in sd.items() if 'num_batches' not in k}
    path = str(tmp_path / 'E1000.pth')
    _reference_file(path, sd, wrapped)

    got = PT.load_torch_checkpoint(path, P)
    jv = jax_load_pth(path, P)
    want = weights_from_jax(jv, P)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    _, model, _ = PI.setup_inference(str(tmp_path / 'p'), device='cpu',
                                     deployed_dir=_bundle(tmp_path, P),
                                     weights=path)
    X = np.random.default_rng(12).random((3, TS, TS, 5)).astype(np.float32)
    with torch.no_grad():
        grid = model(torch.from_numpy(X).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(grid, _jax_grid(P, jv, X), rtol=1e-5,
                               atol=1e-5)


def _torchvision_dict(which, seed):
    """A raw torchvision state dict of ``which`` (3-channel stem, its
    classifier), built from the port's stack with torchvision's key names
    and first module: mobilenet's stem is Conv2dNormActivation
    (features.0.0 / .1), alexnet's an 11x11 conv, resnet's conv1 a bias-free
    7x7 conv."""
    g = torch.Generator().manual_seed(seed)
    stack = BACKBONES[which](3)
    sd = {k: torch.rand(v.shape, generator=g) + 0.5 if 'running_var' in k
          else torch.randn(v.shape, generator=g)
          for k, v in stack.state_dict().items()}
    out = {}
    for k, v in sd.items():
        i, _, tail = k.partition('.')
        i = int(i[len('block_'):])
        if which == 'resnet':
            name = ({0: 'conv1', 1: 'bn1'}.get(i) or f'layer{i - 3}')
        else:
            name = f'features.{i}'
        out[f'{name}.{tail}'] = v
    if which == 'mobilenet':
        del out['features.0.weight'], out['features.0.bias']
        out['features.0.0.weight'] = torch.randn(16, 3, 3, 3, generator=g)
        for k in ('weight', 'bias', 'running_mean', 'running_var'):
            out[f'features.0.1.{k}'] = torch.rand(16, generator=g) + 0.5
        out['classifier.0.weight'] = torch.randn(1024, 576, generator=g)
    elif which == 'alexnet':
        out['features.0.weight'] = torch.randn(64, 3, 11, 11, generator=g)
        out['classifier.1.weight'] = torch.randn(4096, 9216, generator=g)
    else:
        del out['conv1.bias']
        out['conv1.weight'] = torch.randn(64, 3, 7, 7, generator=g)
        out['fc.weight'] = torch.randn(1000, 512, generator=g)
    return out


_LEAF = {'Conv2d': {'weight': 'kernel', 'bias': 'bias'},
         'BatchNorm2d': {'weight': 'scale', 'bias': 'bias',
                         'running_mean': 'mean', 'running_var': 'var'}}


def _flax_name(model, key):
    """'backbone/<flax path>/<leaf>' of a port state-dict key."""
    name, _, leaf = key[len('ConvNet.'):].rpartition('.')
    module = model.ConvNet.get_submodule(name)
    kind = 'Conv2d' if isinstance(module, torch.nn.Conv2d) else 'BatchNorm2d'
    return '/'.join(('backbone',) + flax_path(model.ConvNet, name)
                    + (_LEAF[kind][leaf],))


@pytest.mark.parametrize('which', ['mobilenet', 'alexnet', 'resnet'])
def test_torchvision_splice_equals_jax(which):
    P = _P(which)
    variables = seeded_flax_variables(jax_build_model(P), P, seed=13)
    raw = _torchvision_dict(which, seed=14)
    merged, jloaded, jskipped = backbone_state_dict_to_flax(raw, which, P,
                                                            variables)
    model = build_model(P)
    model.load_state_dict(weights_from_jax(variables, P))
    loaded, skipped = PT.load_backbone_state_dict(model, raw, which)

    assert {_flax_name(model, k) for k in loaded} == set(jloaded)
    # JAX reports a shape-incompatible leaf by its flax path and a layer
    # absent from the dict by its torch-style prefix ('block_0'); it does
    # not report a leaf it leaves as it was without a counterpart (resnet's
    # stem bias)
    for s in jskipped:
        if s.startswith('backbone/'):
            assert s in {_flax_name(model, k) for k in skipped}, s
        else:
            assert any(k.startswith(f'ConvNet.{s}.') for k in skipped), s
    stem = {'mobilenet': ['ConvNet.block_0.weight', 'ConvNet.block_0.bias'],
            'alexnet': ['ConvNet.block_0.weight'],
            'resnet': ['ConvNet.block_0.weight', 'ConvNet.block_0.bias']}
    assert skipped == stem[which]
    want = weights_from_jax(merged, P)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def _bundle(tmp_path, P, name='bundle'):
    bundle = tmp_path / name
    bundle.mkdir(exist_ok=True)
    write_parameters(str(bundle / 'params.json'), P)
    with open(bundle / 'train_stnd_scaler.pkl', 'wb') as f:
        pickle.dump(('zscore', (0.0142, 0.0128)), f)
    return str(bundle)


def test_pth_only_bundle_inference_equals_jax(tmp_path, monkeypatch):
    frames, mask, _, _ = make_synthetic_timelapse(
        T=8, H=128, W=256, n_axons=4, seed=11, n_channels=3)
    data = tmp_path / 'data'
    data.mkdir()
    write_tiff(str(data / 'movie.tif'), frames)
    np.save(data / 'mask.npy', mask)
    P = jax_load_parameters(None, None,
                            from_directory=os.path.join(REPO,
                                                        'deployed_model'))
    P.update(ARCHITECTURE='mobilenet', TILESIZE=TS, MCF_MIN_FLOW=1,
             MCF_MAX_FLOW=50)
    bundle = _bundle(tmp_path, P)
    variables = seeded_flax_variables(jax_build_model(P), P, seed=15)
    # the last layer as a detector's: few confident cells, offsets near
    # mid-cell (so no anchor falls outside the frame, ROADMAP F3)
    last = variables['params']['Dense_2']
    last['kernel'].reshape(1024, -1, 3)[..., 1:] *= 0.2
    last['bias'].reshape(-1, 3)[:, 0] = -0.6
    last['bias'].reshape(-1, 3)[:, 1:] = 0.5
    _reference_file(os.path.join(bundle, 'E1000.pth'),
                    weights_from_jax(variables, P))
    assert sorted(os.listdir(bundle)) == ['E1000.pth', 'params.json',
                                          'params.txt',
                                          'train_stnd_scaler.pkl']
    # the JAX package's setup_model draws a flax init before it loads the
    # checkpoint (10-30 s eagerly for mobilenet); the file replaces it
    monkeypatch.setattr(JE, 'init_variables', lambda model, P, seed: (
        jax.tree.map(jnp.asarray, seeded_flax_variables(model, P, 0))))

    jparams, jmodel, jscaler = JI.setup_inference(str(tmp_path / 'j'),
                                                  deployed_dir=bundle)
    jtl = JI.prepare_input_data('movie.tif', jparams, str(tmp_path / 'j'),
                                str(data), jscaler, mask_fname='mask.npy',
                                use_cached_datasets=None)
    pparams, pmodel, pscaler = PI.setup_inference(
        str(tmp_path / 'p'), device='cpu', deployed_dir=bundle)
    assert pparams['ARCHITECTURE'] == 'mobilenet'
    ptl = PI.prepare_input_data('movie.tif', pparams, str(tmp_path / 'p'),
                                str(data), pscaler, mask_fname='mask.npy',
                                use_cached_datasets=None)
    jax_ax = JI.inference(jtl, jmodel, str(tmp_path / 'j'), jparams,
                          None, None, None)
    port_ax = PI.inference(ptl, pmodel, str(tmp_path / 'p'), pparams,
                           None, None, None)

    # no detection or identity that f32 summation order could decide
    jm, jv = jmodel
    thr, S, nms = 0.55, 12, P['NON_MAX_SUPRESSION_DIST']
    apply = jax.jit(functools.partial(jm.apply, train=False))
    n_dets = 0
    for t in range(jtl.sizet):
        g = np.asarray(apply(jv, jtl.get_frametiles_stack(t)[0])).reshape(
            -1, S, S, 3)
        ty, tx = (np.asarray(jtl._tile_yx)[:, i, None, None] for i in (0, 1))
        px = (g[..., 1] + np.arange(S)[:, None]) * TS / S + tx * TS
        py = (g[..., 2] + np.arange(S)[None, :]) * TS / S + ty * TS
        assert not (np.abs(g[..., 0] - thr) < 1e-5).any()
        keep = g[..., 0] >= thr
        assert not ((np.abs(px % 1 - 0.5) < 1e-4)
                    | (np.abs(py % 1 - 0.5) < 1e-4))[keep].any()
        # cells NMS weighs against each other differ in confidence
        c, x, y = g[..., 0][keep], px[keep], py[keep]
        close = np.hypot(x[:, None] - x, y[:, None] - y) <= nms + 2
        np.fill_diagonal(close, False)
        assert (np.abs(c[:, None] - c)[close] > 1e-5).all()
        d = jax_ax.get_frame_dets('all', t)
        assert (d['anchor_x'] >= 0).all() and (d['anchor_y'] >= 0).all()
        n_dets += len(d)
    assert n_dets >= 4 * jtl.sizet
    pd.testing.assert_frame_equal(port_ax.IDed_dets_all,
                                  jax_ax.IDed_dets_all)
    assert len(port_ax.IDed_dets_all) >= 3


def test_checkpoint_file_and_load_from_pth(tmp_path):
    """A bundle's E*.pt wins over an E*.pth; with only E*.pth files the
    first of the sorted glob loads, weights only: the Adam state and the
    epoch stay as they were."""
    P = _P(TINY, DEVICE='cpu')
    state = PE.setup_model(P)
    state.epoch = 5
    opt_before = state.optimizer.state_dict()
    ref = init_weights(build_model(P), torch.Generator().manual_seed(3))
    for name, seed in (('E0900.pth', 3), ('E1000.pth', 4)):
        w = init_weights(build_model(P), torch.Generator().manual_seed(seed))
        _reference_file(str(tmp_path / name), w.state_dict())
    assert checkpoint_file(str(tmp_path)) == str(tmp_path / 'E0900.pth')
    load_checkpoint(str(tmp_path), state)
    for k, v in ref.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    assert state.epoch == 5
    assert state.optimizer.state_dict() == opt_before
    torch.save({'model': ref.state_dict(), 'epoch': 1},
               str(tmp_path / 'E0001.pt'))
    assert checkpoint_file(str(tmp_path)) == str(tmp_path / 'E0001.pt')
    with pytest.raises(FileNotFoundError, match='E\\*.pth'):
        checkpoint_file(str(tmp_path / 'nothing'))
