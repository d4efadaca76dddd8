"""Seeded weights with calibrated BatchNorm statistics (``lib/config.py``'s
third recipe, ``reference/calibrate.py``), on the CPU at 64-px tiles with
the ResNet-18 trunk."""
import json
import os
from types import SimpleNamespace

import pytest
import torch

from _small import ROOT
from portbench.lib import config, movie
from portbench.reference import calibrate as C
from portbench.reference import model as M

SEEDED = {'bundle': 'deployed_model',
          'overrides': {'ARCHITECTURE': 'resnet', 'TILESIZE': 64},
          'weights': 'seeded', 'weights_seed': 3}
CALIBRATED = dict(SEEDED, calibration='calib_tiny')
MIX = {'frames': 6, 'height': 256, 'width': 512, 'cones': 4, 'channels': 2,
       'channel_height': 60}


@pytest.fixture
def traffic(tmp_path, monkeypatch):
    """A movie20-like mix at the test's size as traffic/calib_tiny.json."""
    with open(os.path.join(config.TRAFFIC, 'movie20.json')) as f:
        mix = dict(json.load(f), **MIX)
    (tmp_path / 'calib_tiny.json').write_text(json.dumps(mix))
    monkeypatch.setattr(config, 'TRAFFIC', str(tmp_path))
    return mix


def ctx_of(conf, tmp_path):
    tmp = tmp_path / 'run'
    tmp.mkdir(exist_ok=True)
    return SimpleNamespace(root=ROOT, config=conf, device=torch.device('cpu'),
                           tmp=str(tmp), calibration_s=0.0)


def calibration_batch(ctx, mix):
    P = config.params_json(ctx)
    mv = movie.make_movie(mix, ctx.config['weights_seed'], ctx.device,
                          P['TILESIZE'])
    return C.batch(mv['raw'], mv['mask'], config.scaler_var(ctx), P,
                   ctx.device), P


def test_without_the_key_the_weights_are_seeded_state_dicts(tmp_path):
    ctx = ctx_of(SEEDED, tmp_path)
    src, sd = config.bundle(ctx)
    ref = config.seeded_state_dict(config.port_params(src), 3, ctx.device)
    assert sd.keys() == ref.keys()
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k


def test_calibration_is_deterministic_and_moves_only_the_statistics(
        tmp_path, traffic):
    ctx = ctx_of(CALIBRATED, tmp_path)
    _, a = config.bundle(ctx)
    _, b = config.bundle(ctx)
    _, seeded = config.bundle(ctx_of(SEEDED, tmp_path))
    assert a.keys() == b.keys() == seeded.keys()
    stats = [k for k in a if k.endswith(('running_mean', 'running_var'))]
    assert len(stats) == 2 * 20                 # ResNet-18's BatchNorms
    for k in a:
        assert torch.equal(a[k], b[k]), k
        if k not in stats:
            assert torch.equal(a[k], seeded[k]), k


def test_calibrated_statistics_are_no_identity(tmp_path, traffic):
    _, sd = config.bundle(ctx_of(CALIBRATED, tmp_path))
    for k, v in sd.items():
        if k.endswith('running_var'):
            assert bool((v > 0).all()), k
            assert not torch.equal(v, torch.ones_like(v)), k
        elif k.endswith('running_mean'):
            assert not torch.equal(v, torch.zeros_like(v)), k


def test_eval_forward_on_the_calibration_batch_is_the_train_forward(
        tmp_path, traffic):
    ctx = ctx_of(CALIBRATED, tmp_path)
    _, sd = config.bundle(ctx)
    X, P = calibration_batch(ctx, traffic)
    net = M.from_state_dict(sd, P)
    with torch.no_grad():
        for fn in (M.trunk, M.forward):
            ev = fn(net, X, M.Ops(), train=False)
            tr = fn(net, X, M.Ops(), train=True)
            assert float((ev - tr).abs().max()) <= 1e-5 * float(
                tr.abs().max()), fn.__name__


def test_seeded_features_are_faint_and_calibrated_ones_are_not(tmp_path,
                                                               traffic):
    ctx = ctx_of(CALIBRATED, tmp_path)
    _, sd = config.bundle(ctx)
    _, seeded = config.bundle(ctx_of(SEEDED, tmp_path))
    X, P = calibration_batch(ctx, traffic)
    with torch.no_grad():
        std = [float(M.trunk(M.from_state_dict(w, P), X, M.Ops()).std())
               for w in (seeded, sd)]
    assert std[1] > 5 * std[0]


def _copy_stem_statistic(net):
    """The stem's BatchNorm with a copy of its running mean."""
    stem = net['trunk']['stem_bn']
    net['trunk']['stem_bn'] = dict(stem, mean=stem['mean'].clone())
    return net


def _bypass_stem(trunk):
    """A trunk that normalises its stem with a copy of its tensors."""
    def bypassing(net, x, ops, train=False):
        net = dict(net, stem_bn=dict(net['stem_bn']))
        net['stem_bn'].pop('batch', None)
        return trunk(net, x, ops, train)
    return bypassing


@pytest.mark.parametrize('fault, message', [
    ('copied', 'not the state dict'), ('bypassed', r'block_1 0 times')])
def test_a_trunk_that_hides_a_batchnorm_is_refused(tmp_path, traffic, fault,
                                                   message):
    ctx = ctx_of(CALIBRATED, tmp_path)
    _, sd = config.bundle(ctx_of(SEEDED, tmp_path))
    X, P = calibration_batch(ctx, traffic)
    with pytest.MonkeyPatch.context() as mp:
        if fault == 'copied':
            real = M.from_state_dict
            mp.setattr(M, 'from_state_dict', lambda sd_, params:
                       _copy_stem_statistic(real(sd_, params)))
        else:
            resnet = M.trunk_module('resnet')
            mp.setattr(resnet, 'trunk', _bypass_stem(resnet.trunk))
        with pytest.raises(ValueError, match=message):
            C.calibrate(sd, P, X)


def test_calibration_with_a_bundle_checkpoint_is_refused(tmp_path):
    conf = {'bundle': 'deployed_model', 'overrides': {}, 'weights': 'bundle',
            'calibration': 'movie20'}
    with pytest.raises(ValueError, match='calibration'):
        config.bundle(ctx_of(conf, tmp_path))


def test_the_calibration_is_timed_apart_from_set_up(tmp_path, traffic):
    seeded, calibrated = ctx_of(SEEDED, tmp_path), ctx_of(CALIBRATED, tmp_path)
    config.bundle(seeded)
    config.bundle(calibrated)
    assert seeded.calibration_s == 0.0
    assert calibrated.calibration_s > 0.0
