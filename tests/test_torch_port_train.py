"""Port parity: the loss, BatchNorm in train mode, the train step, the
device-resident epoch, resuming from a JAX checkpoint and the port's own
checkpoints.

Both packages start from the same weights: the JAX package's flax init,
carried across with ``weights_from_jax``. Its conv biases are zero at
init, and under train-mode BatchNorm their gradient is zero analytically:
what the frameworks compute is rounding noise (up to ~5e-4 here, summed
over 80k positions). Adam's first step moves every parameter by about
lr * sign(g), so with zero biases the noise's sign would decide steps of
+-lr. The conv biases are therefore given seeded values of magnitude
0.05-0.1 on both sides, and WEIGHT_DECAY is 0.05, so the weight-decay
term of their gradient (>= 2.5e-3) fixes its sign. (Biases large enough
to do that at the default decay shift the conv outputs' means so far
that flax's E[x^2] - E[x]^2 variance loses the digits the tolerances
below need.)

Tolerances: loss components rtol 1e-6; running statistics after one
train-mode forward rtol 1e-5 (flax computes the variance as E[x^2] -
E[x]^2), with an absolute floor of 1e-6 for the means, which are sums of
~16k terms of either sign and may lie near zero; one train step: loss
rtol 1e-5 and every parameter atol 1e-6 (but for the few whose gradient
sign f32 does not determine, see the test); an epoch's per-batch
losses, and the epoch after resuming from a JAX checkpoint, rtol 1e-4
(torch and optax round Adam's update in different orders). The port's own checkpoints round-trip bit-exactly, and a resumed
CPU run equals the uninterrupted one exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axtrack_tpu.models.loss import yolo_loss as jax_yolo_loss
from axtrack_tpu.params import get_default_parameters as jax_defaults
from axtrack_tpu.train import engine as JE
from axtrack_tpu.utils import set_seed as jax_set_seed
from axtrack_tpu_torch.data.synthetic import write_fixture
from axtrack_tpu_torch.models.loss import yolo_loss
from axtrack_tpu_torch.models.yolo import (build_model, weights_from_jax,
                                           SeededDropout)
from axtrack_tpu_torch.params import get_default_parameters
from axtrack_tpu_torch.train import engine as PE
from axtrack_tpu_torch.train.checkpoint import (save_checkpoint,
                                                load_checkpoint,
                                                state_from_jax)

torch.set_num_threads(1)
TINY = [[(3, 8, 2, 1), (3, 16, 2, 1), 'M', (3, 16, 1, 1), 'M'],
        [('FC', 128), ('activation', 'sigmoid')]]


def _params(tmp_path, **kw):
    fx = write_fixture(str(tmp_path), name='train_movie', T=10, H=256,
                       W=512, n_axons=6, seed=5, n_channels=4)
    P = get_default_parameters()
    P.update(TIMELAPSE_FILE=fx['tif'], LABELS_FILE=fx['labels'],
             MASK_FILE=fx['mask'], TRAIN_TIMEPOINTS=list(range(2, 8)),
             TEST_TIMEPOINTS=[2, 3], TILESIZE=256, BATCH_SIZE=5, CACHE=None,
             FROM_CACHE=None, PLOT_PREPROC=False, USE_TRANSFORMS=[],
             LR=2e-3, SHUFFLE=False, ARCHITECTURE=TINY, DEVICE='cpu',
             WEIGHT_DECAY=0.05)
    P.update(kw)
    return P


def _jax_P(P):
    JP = jax_defaults()
    JP.update({k: v for k, v in P.items() if k != 'DEVICE'})
    return JP


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _states(P, with_data=True):
    """The JAX TrainState (flax init, seeded conv biases of magnitude
    0.05-0.1) and
    the port's TrainState with the same weights; plus both packages'
    train/test datasets."""
    JP = _jax_P(P)
    jax_set_seed(P['SEED'])
    jdata = JE.setup_data(JP) if with_data else (None, None)
    js = JE.setup_model(JP)
    rng = np.random.default_rng(0)
    for blk in js.params.values():
        if 'Conv_0' in blk:
            n = blk['Conv_0']['bias'].shape
            blk['Conv_0']['bias'] = jnp.asarray(
                rng.uniform(.05, .1, n) * rng.choice([-1, 1], n), jnp.float32)
    pdata = PE.setup_data(P) if with_data else (None, None)
    ps = PE.setup_model(P)
    ps.model.load_state_dict(weights_from_jax(_np_tree(js.variables), P))
    return js, ps, jdata, pdata


def test_loss_components_equal_jax():
    rng = np.random.default_rng(3)
    B, S = 6, 12
    pred = rng.normal(0, 1, (B, S, S, 3)).astype(np.float32)
    tgt = np.zeros((B, S, S, 4), np.float32)
    hit = rng.random((B, S, S)) < 0.05
    tgt[hit, 0] = 1
    tgt[hit, 1:3] = rng.random((hit.sum(), 2))
    _, want = jax_yolo_loss(jnp.asarray(pred.reshape(B, -1)),
                            jnp.asarray(tgt), S, S)
    loss, got = yolo_loss(torch.from_numpy(pred), torch.from_numpy(tgt), S, S)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(loss) == float(got['total_summed_loss'])


def test_batchnorm_running_stats_equal_jax(tmp_path):
    P = _params(tmp_path)
    js, ps, _, _ = _states(P, with_data=False)
    X = np.random.default_rng(1).random((4, 256, 256, 5)).astype(np.float32)
    out, mut = js.model.apply(js.variables, jnp.asarray(X), train=True,
                              mutable=['batch_stats'])
    ps.model.train()
    got = ps.model(torch.from_numpy(X).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().numpy().reshape(4, -1),
                               np.asarray(out), rtol=1e-4, atol=1e-5)
    js.batch_stats = mut['batch_stats']
    sd = ps.model.state_dict()
    want = weights_from_jax(_np_tree(js.variables), P)
    keys = [k for k in want if 'running' in k]
    assert len(keys) == 6
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6 if 'mean' in k else 0, err_msg=k)


def test_train_step_equals_jax(tmp_path):
    """One train step from the same weights and batch: the loss and every
    parameter after the Adam step.

    Adam's first step is lr * g / (|g| + eps), about lr * sign(g), so it
    is ill-conditioned where g is small: where a gradient (with its weight
    decay) is below 4x the two frameworks' difference in it, its sign is
    not determined in f32, and where the step's sensitivity lr * eps *
    |dg| / (|g| + eps)^2 to that difference exceeds half the tolerance, the
    step differs by more than it. Those elements (tens of 584k) are left
    out and must be under 0.1% of the parameters."""
    P = _params(tmp_path)
    JP = _jax_P(P)
    js, ps, (jtrain, _), (ptrain, _) = _states(P)
    jtrain.construct_tiles()
    ptrain.construct_tiles()
    idx = np.array([0, 3, 4, 7, 11])
    X, tgt = JE.gather_batch(jtrain, idx)
    pX, ptgt = PE.gather_batch(ptrain, idx)
    np.testing.assert_allclose(pX.permute(0, 2, 3, 1).numpy(), X, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ptgt.numpy(), tgt)

    def jax_loss(p):
        out, _ = js.model.apply({'params': p, 'batch_stats': js.batch_stats},
                                jnp.asarray(X), train=True,
                                mutable=['batch_stats'])
        return jax_yolo_loss(out, jnp.asarray(tgt), 12, 12)[0]

    g = jax.tree.map(lambda a, b: np.asarray(a) + P['WEIGHT_DECAY']
                     * np.asarray(b), jax.grad(jax_loss)(js.params),
                     js.params)
    jgrad = weights_from_jax({'params': g,
                              'batch_stats': _np_tree(js.batch_stats)}, P)
    before = {n: p.detach().clone() for n, p in ps.model.named_parameters()}
    train_step, _ = JE.make_train_step(js.model, js.tx, JP)
    (js.params, js.batch_stats, js.opt_state, loss,
     _) = train_step(js.params, js.batch_stats, js.opt_state,
                     jnp.asarray(X), jnp.asarray(tgt))
    comps = PE.train_step(ps, pX, ptgt)
    np.testing.assert_allclose(float(comps['total_summed_loss']),
                               float(loss), rtol=1e-5)
    want = weights_from_jax(_np_tree(js.variables), P)
    got = ps.model.state_dict()
    n_ties = n_all = 0
    for name, p in ps.model.named_parameters():
        gp = p.grad + P['WEIGHT_DECAY'] * before[name]
        gj, dg = jgrad[name], (gp - jgrad[name]).abs()
        tie = ((gj.abs() < 4 * dg)
               | (P['LR'] * 1e-8 * dg / (gj.abs() + 1e-8) ** 2 > 5e-7))
        n_ties += int(tie.sum())
        n_all += tie.numel()
        np.testing.assert_allclose(got[name][~tie].numpy(),
                                   want[name][~tie].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
    assert n_ties < 1e-3 * n_all, (n_ties, n_all)


def _jax_epoch(js, data, which, JP):
    if not hasattr(js, '_steps'):
        js._steps = JE.make_train_step(js.model, js.tx, JP)
    data.construct_tiles()
    df = JE.run_epoch_device(js, js._steps, data, which, JP,
                             np.arange(len(data)))
    return {k: df.loc[k].to_numpy() for k in df.index}


def _port_epoch(ps, data, which, P):
    data.construct_tiles()
    return PE.run_epoch(ps, data, which, P, np.arange(len(data)))


def _assert_losses_close(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_epoch_per_batch_losses_equal_jax(tmp_path):
    """A train epoch (full batches and the remainder), then a test epoch,
    SHUFFLE off and no transforms."""
    P = _params(tmp_path)
    JP = _jax_P(P)
    js, ps, (jtrain, jtest), (ptrain, ptest) = _states(P)
    want = _jax_epoch(js, jtrain, 'train', JP)
    got = _port_epoch(ps, ptrain, 'train', P)
    assert len(ptrain) % P['BATCH_SIZE']
    assert len(got['total_summed_loss']) == -(-len(ptrain) // P['BATCH_SIZE'])
    _assert_losses_close(got, want, 1e-4)
    _assert_losses_close(_port_epoch(ps, ptest, 'test', P),
                         _jax_epoch(js, jtest, 'test', JP), 1e-4)


def test_resume_from_jax_checkpoint(tmp_path):
    """JAX trains an epoch; its params, batch stats, Adam moments and epoch
    go through ``state_from_jax``; the next epoch's losses agree."""
    P = _params(tmp_path)
    JP = _jax_P(P)
    js, ps, (jtrain, _), (ptrain, _) = _states(P)
    _jax_epoch(js, jtrain, 'train', JP)
    js.set_epoch_lr(2)
    adam = js.opt_state.inner_state[1]
    ckpt = state_from_jax({'params': _np_tree(js.params),
                           'batch_stats': _np_tree(js.batch_stats),
                           'mu': _np_tree(adam.mu), 'nu': _np_tree(adam.nu),
                           'count': np.asarray(adam.count),
                           'epoch': js.epoch}, P)
    fresh = PE.setup_model(P)
    from axtrack_tpu_torch.train.checkpoint import restore
    restore(ckpt, fresh)
    assert fresh.epoch == 2
    assert math.isclose(fresh.optimizer.param_groups[0]['lr'],
                        float(js.opt_state.hyperparams['learning_rate']),
                        rel_tol=1e-6)
    want = _jax_epoch(js, jtrain, 'train', JP)
    _assert_losses_close(_port_epoch(fresh, ptrain, 'train', P), want, 1e-4)


def test_checkpoint_roundtrip_and_resume_exact(tmp_path):
    P = _params(tmp_path)
    _, ps, _, (ptrain, _) = _states(P)
    first = _port_epoch(ps, ptrain, 'train', P)
    ps.set_epoch_lr(1)
    path = save_checkpoint(ps, str(tmp_path / 'E0001'))
    assert path.endswith('E0001.pt')
    uninterrupted = _port_epoch(ps, ptrain, 'train', P)

    resumed = PE.setup_model(P)
    load_checkpoint(str(tmp_path), resumed)
    assert resumed.epoch == 1
    ckpt = torch.load(path, weights_only=True)
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, ckpt['model'][k]), k
    for i, s in resumed.optimizer.state_dict()['state'].items():
        for k, v in s.items():
            assert torch.equal(v, ckpt['optimizer']['state'][i][k]), (i, k)
    again = _port_epoch(resumed, ptrain, 'train', P)
    for k in uninterrupted:
        np.testing.assert_array_equal(again[k], uninterrupted[k])
    assert not np.array_equal(first['total_summed_loss'],
                              again['total_summed_loss'])


def test_one_epoch_metrics_and_lr(tmp_path):
    """one_epoch: loss means, the 13-threshold metrics every 10th epoch,
    and the learning rate stepped to epoch + 1 after a train epoch."""
    P = _params(tmp_path)
    _, ps, _, (ptrain, ptest) = _states(P)
    info = PE.one_epoch(ptrain, ps, P, epoch=0, train=True)
    assert ('F1', 0.7) in info and ('precision', 0.55) in info
    assert ps.epoch == 1
    assert math.isclose(ps.optimizer.param_groups[0]['lr'],
                        P['LR'] * math.e ** (-1 / P['LR_DECAYRATE']))
    info = PE.one_epoch(ptest, ps, P, epoch=1, train=False)
    assert sorted(info) == ['total_no_object_loss', 'total_object_loss',
                            'total_pos_labels_rate', 'total_summed_loss',
                            'total_xy_anchors_loss']
    assert ps.epoch == 1
    for E in (10, 100):
        ps.set_epoch_lr(E)
        assert math.isclose(ps.optimizer.param_groups[0]['lr'],
                            P['LR'] * math.e ** (-math.sqrt(E)
                                                 / P['LR_DECAYRATE']))


def test_seeded_dropout():
    P = get_default_parameters()
    P.update(TILESIZE=64, ARCHITECTURE=[
        [(3, 4, 2, 1), 'M'], [('FC', 16), ('dropout', 0.5),
                              ('activation', 'sigmoid')]])
    x = torch.rand(3, 5, 64, 64, generator=torch.Generator().manual_seed(0))
    sd = build_model(P).state_dict()
    outs = []
    for _ in range(2):
        m = build_model(P).train()
        m.load_state_dict(sd)
        torch.manual_seed(len(outs))        # the global generator is unused
        outs.append([m(x) for _ in range(2)])
    drop = [mod for mod in m.modules() if isinstance(mod, SeededDropout)]
    assert len(drop) == 1
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], outs[0][1])
    m.eval()
    assert torch.equal(m(x), m(x))
