"""Port parity for training on a mesh: the partition specs, the sharded
parameters, the mesh step (data-parallel over 'data', the FC head
tensor-parallel over 'model', BatchNorm over every shard), the mesh epoch,
the chunked epoch, ``run_experiment(mesh=)`` and ``sharded_inference_fn``.

The port's meshes are fake shards of the CPU, ``make_mesh(devices=[cpu] *
8)`` (4 x 2), against the JAX package's 8 virtual CPU devices. Tolerances
are the JAX package's own for its mesh against one device
(``tests/test_parallel.py``): at the deployed architecture, the loss rtol
1e-5 and the gradients rtol 1e-4 / atol 1e-5; a mesh epoch (SGD, whose
step does not amplify rounding as Adam's first step does) per-batch
losses rtol 2e-3 and parameters rtol 2e-3 / atol 3e-4. BatchNorm's
running statistics after one train-mode forward rtol 1e-5, with an
absolute floor of 1e-6 for the means (sums of either sign that may lie
near zero; ``test_torch_port_train.py`` holds them so); the sharded
eval-mode grid atol 1e-5.
"""
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axtrack_tpu.parallel import mesh as JM
from axtrack_tpu.params import get_default_parameters as jax_defaults
from axtrack_tpu.train import engine as JE
from axtrack_tpu.models.yolo import build_model as jax_build_model
from axtrack_tpu_torch import config
from axtrack_tpu_torch import interface as PI
from axtrack_tpu_torch.data.synthetic import write_fixture
from axtrack_tpu_torch.data.timelapse import Timelapse
from axtrack_tpu_torch.models.loss import yolo_loss
from axtrack_tpu_torch.models.yolo import build_model, weights_from_jax
from axtrack_tpu_torch.parallel import mesh as M
from axtrack_tpu_torch.params import (get_default_parameters,
                                      load_parameters)
from axtrack_tpu_torch.train import bigmovie as PB
from axtrack_tpu_torch.train import engine as PE
from axtrack_tpu_torch.train.experiment import run_experiment

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
# TestShardedEpoch's architecture: FC 64 column-, FC 64 row-parallel
SMALL = [[(3, 8, 2, 1), (3, 16, 2, 1), 'M', (3, 16, 1, 1), 'M'],
         [('FC', 64), ('activation', 'sigmoid'),
          ('FC', 64), ('activation', 'sigmoid')]]
EPOCH_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-3, 3e-4


def _mesh(n_data=4, n_model=2):
    return M.make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


def _deployed_P():
    P = load_parameters(None, None,
                        from_directory=os.path.join(REPO, 'deployed_model'))
    P.update(DEVICE='cpu', LOAD_MODEL=None)
    return P


def _train_P(tmp_path, **kw):
    """TestShardedEpoch's data and settings (tests/test_parallel.py)."""
    fx = write_fixture(str(tmp_path), T=10, H=256, W=512, n_axons=4, seed=5,
                       n_channels=4)
    P = get_default_parameters()
    P.update(TIMELAPSE_FILE=fx['tif'], LABELS_FILE=fx['labels'],
             MASK_FILE=fx['mask'], TRAIN_TIMEPOINTS=list(range(2, 8)),
             TEST_TIMEPOINTS=[2, 3], TILESIZE=128, BATCH_SIZE=8, CACHE=None,
             FROM_CACHE=None, PLOT_PREPROC=False, USE_TRANSFORMS=[],
             SHUFFLE=False, ARCHITECTURE=SMALL, DEVICE='cpu')
    P.update(kw)
    return P


def _jax_P(P):
    JP = jax_defaults()
    JP.update({k: v for k, v in P.items() if k != 'DEVICE'})
    return JP


def _sgd_states(P):
    """TestShardedEpoch's SGD state of the JAX package (flax init, lr
    2e-4) and the port's with the same weights and rate."""
    from tests.test_bigmovie import TestChunkedEpoch
    js = TestChunkedEpoch._sgd_state(_jax_P(P))
    ps = PE.setup_model(P)
    ps.model.load_state_dict(weights_from_jax(
        jax.tree.map(np.asarray, js.variables), P))
    ps.optimizer = torch.optim.SGD(ps.model.parameters(), lr=2e-4)
    return js, ps


def _port_sgd_state(P, sd):
    state = PE.setup_model(P)
    state.model.load_state_dict(sd)
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=2e-4)
    return state


def _assert_params_close(got, want):
    """Parameters and running statistics (flax counts no batches)."""
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def _specs_by_dense(tree, dense_order):
    specs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = '/'.join(str(getattr(p, 'key', p)) for p in path)
        specs[name] = tuple(JM.param_partition_spec(path, leaf, dense_order))
    return specs


@pytest.mark.parametrize('fc', ['deployed', 63])
def test_partition_specs_equal_jax(fc):
    """Every parameter's spec at the deployed architecture, and at an FC
    width of 63, which the 'model' axis of 2 does not divide: the spec
    says column-parallel and ``shard_params`` replicates it, as JAX's
    does."""
    P = _deployed_P()
    if fc != 'deployed':
        P.update(TILESIZE=64, ARCHITECTURE=[
            [(3, 8, 2, 1), 'M', (3, 8, 1, 1), 'M'],
            [('FC', fc), ('activation', 'sigmoid')]])
    JP = _jax_P(P)
    jm = jax_build_model(JP)
    ts = P['TILESIZE']
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, ts, ts, 5)))
    jspecs = _specs_by_dense(shapes['params'],
                             JM._dense_order(shapes['params']))
    with torch.device('meta'):
        model = build_model(P)
    order = M.linear_names(model)
    got = {n: M.param_partition_spec(n, p.shape, order)
           for n, p in model.named_parameters()}
    assert len(order) == sum(1 for n in jspecs if n.endswith('/kernel')
                             and n.startswith('Dense'))
    for m, prefix in enumerate(order):
        assert got.pop(f'{prefix}.weight') == jspecs.pop(f'Dense_{m}/kernel')
        assert got.pop(f'{prefix}.bias') == jspecs.pop(f'Dense_{m}/bias')
    assert set(got.values()) == {()} and set(jspecs.values()) == {()}
    if fc == 'deployed':
        return
    model = build_model(P)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    M.shard_params(model, _mesh())
    assert not any(isinstance(m, M.ShardedLinear) for m in model.modules())
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize('n_model', [2, 4])
def test_shard_params_put_back_equal_the_weights(n_model):
    """The shards of the column- and row-parallel layers, joined, are the
    full weights; each shard holds 1/n_model of its layer on its 'model'
    device, and so do its Adam moments after a step."""
    P = get_default_parameters()
    P.update(TILESIZE=64, BATCH_SIZE=8, DEVICE='cpu', ARCHITECTURE=SMALL)
    state = PE.setup_model(P)
    full = {k: v.clone() for k, v in state.model.state_dict().items()}
    mesh = _mesh(8 // n_model, n_model)
    M.distribute_state(state, mesh)
    layers = [m for m in state.model.fcs if isinstance(m, M.ShardedLinear)]
    assert [m.layout for m in layers] == ['column', 'row']
    col, row = layers
    assert [tuple(w.shape) for w in col.weight_shards] == [(64 // n_model,
                                                            256)] * n_model
    assert [tuple(b.shape) for b in col.bias_shards] == [(64 // n_model,)] \
        * n_model
    assert [tuple(w.shape) for w in row.weight_shards] == [(64, 64 //
                                                            n_model)] * n_model
    assert tuple(row.bias.shape) == (64,)
    got = M.gathered_state_dict(state.model)
    assert sorted(got) == sorted(full)
    for k in full:
        assert torch.equal(got[k], full[k]), k
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.random((8, 5, 64, 64), np.float32))
    PE.train_step(state, X, torch.zeros(8, 12, 12, 4))
    for shard in list(col.weight_shards) + list(row.weight_shards):
        moments = state.optimizer.state[shard]
        assert moments['exp_avg'].shape == shard.shape
        assert moments['exp_avg_sq'].device == shard.device
    with pytest.raises(ValueError, match='mesh already'):
        M.distribute_state(state, mesh)


def test_full_architecture_loss_and_grads_equal_one_device():
    """TestFullScaleTP at the deployed architecture: batch 8 of 512-px
    tiles, eval-mode forward, the loss and every gradient of the 4 x 2
    mesh step against one device."""
    P = _deployed_P()
    state = PE.setup_model(P)
    model = state.model.eval()
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.random((8, 5, 512, 512), np.float32))
    tgt = torch.zeros(8, 12, 12, 4)
    kw = dict(Sy=P['SY'], Sx=P['SX'], lambda_obj=P['L_OBJECT'],
              lambda_noobj=P['L_NOBJECT'],
              lambda_coord_anchor=P['L_COORD_ANCHOR'])
    loss, _ = yolo_loss(model(X), tgt, **kw)
    loss.backward()
    want = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    mesh = _mesh()
    M.shard_params(model, mesh)
    fc0 = model.fcs[1]
    assert isinstance(fc0, M.ShardedLinear) and fc0.layout == 'column'
    assert fc0.weight_shards[0].shape == (512, 40960)
    assert isinstance(model.fcs[3], M.ShardedLinear)
    assert not isinstance(model.fcs[5], M.ShardedLinear)    # the head
    got_loss, _ = M.mesh_loss(model, mesh, X, tgt,
                              lambda p, t: yolo_loss(p, t, **kw))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()),
                               float(loss.detach()), rtol=1e-5)
    pieces = M.param_pieces(model)
    assert [n for n, _, _ in pieces] == list(want)
    for name, tensors, dim in pieces:
        g = torch.cat([t.grad for t in tensors], dim)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_mesh_epoch_equals_jax_mesh_and_one_device(tmp_path):
    """TestShardedEpoch: one train epoch on the 4 x 2 mesh (SGD) against
    the JAX package's epoch on its 4 x 2 mesh and the port's on one
    device, over the same batches (a remainder batch stays whole)."""
    P = _train_P(tmp_path)
    JP = _jax_P(P)
    jtrain, _ = JE.setup_data(JP, skip_test=True)
    JE.prepare_data(jtrain)
    ptrain, _ = PE.setup_data(P, skip_test=True)
    PE.prepare_data(ptrain)
    indices = np.arange(len(ptrain))
    assert len(indices) == len(jtrain) and len(indices) >= 2 * 8
    js, ps = _sgd_states(P)
    js = JM.distribute_state(js, JM.make_mesh())
    single = _port_sgd_state(P, ps.model.state_dict())
    M.distribute_state(ps, _mesh())
    want = JE.run_epoch_device(js, js._steps, jtrain, 'train', JP, indices)
    got = PE.run_epoch(ps, ptrain, 'train', P, indices)
    alone = PE.run_epoch(single, ptrain, 'train', P, indices)
    for other in (want.loc['total_summed_loss'].to_numpy(),
                  alone['total_summed_loss']):
        np.testing.assert_allclose(got['total_summed_loss'], other,
                                   rtol=EPOCH_RTOL)
    params = M.gathered_state_dict(ps.model)
    _assert_params_close(params, weights_from_jax(
        jax.tree.map(np.asarray, js.variables), P))
    _assert_params_close(params, single.model.state_dict())


def test_one_epoch_on_a_distributed_state(tmp_path):
    """one_epoch at epoch 0 (the run_experiment route, with its F1 sweep on
    the gathered model) on a distributed Adam state: the F1 keys are there
    and the mean loss is the single device's."""
    P = _train_P(tmp_path)
    train, _ = PE.setup_data(P, skip_test=True)

    def run(mesh):
        state = PE.setup_model(P)
        if mesh is not None:
            M.distribute_state(state, mesh)
        return PE.one_epoch(train, state, P, epoch=0, train=True,
                            min_pos_rate=0)
    want = run(None)
    got = run(_mesh())
    assert ('F1', 0.7) in got and set(got) == set(want)
    np.testing.assert_allclose(got['total_summed_loss'],
                               want['total_summed_loss'], rtol=EPOCH_RTOL)


def test_chunked_epoch_on_a_mesh_equals_one_device(tmp_path, monkeypatch):
    """TestShardedEpoch's chunked case: a staged movie's chunk-resident
    epoch at batch 4 on the 4 x 2 mesh (a tile a data row) against the
    same plan on one device."""
    P = _train_P(tmp_path, BATCH_SIZE=4)
    with monkeypatch.context() as m:
        m.setattr(Timelapse, '_DEVICE_MOVIE_BUDGET', 512 * 1024)
        m.setattr(Timelapse, '_RESIDENT_U16_BUDGET', 0)
        staged, _ = PE.setup_data(P, skip_test=True)
    assert staged._u16_staged
    PE.prepare_data(staged)
    K = staged.ntiles_kept
    plan = PB.plan_chunks(staged, P, chunk_budget=2 * (
        K * 128 * 128 * 4 + 256 * 512 * 10))
    assert len(plan[0]) > 1
    assert any(len(ch['rest']) for ch in plan[0])
    states = [PE.setup_model(P) for _ in range(2)]
    for s in states:
        s.optimizer = torch.optim.SGD(s.model.parameters(), lr=2e-4)
    M.distribute_state(states[0], _mesh())
    got, want = (PB.run_epoch_chunked(s, staged, 'train', P, plan=plan)
                 for s in states)
    assert staged.X_tiled is None
    np.testing.assert_allclose(got['total_summed_loss'],
                               want['total_summed_loss'], rtol=EPOCH_RTOL)
    _assert_params_close(M.gathered_state_dict(states[0].model),
                         states[1].model.state_dict())


@pytest.mark.parametrize('arch', ['yolo', 'resnet'])
def test_cross_shard_batchnorm_running_stats(arch):
    """One train-mode forward of batch 8 on the 4 x 2 mesh: every
    BatchNorm's running mean and variance are those of the whole batch on
    one device."""
    P = get_default_parameters()
    P.update(TILESIZE=64, DEVICE='cpu',
             ARCHITECTURE=SMALL if arch == 'yolo' else arch)
    model = build_model(P).train()
    single = build_model(P).train()
    single.load_state_dict(model.state_dict())
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(0.3, 1, (8, 5, 64, 64)).astype(
        np.float32))
    want = single(X)
    M.shard_params(model, _mesh())
    got = torch.cat(M.mesh_forward(model, _mesh(), X))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    keys = [k for k in single.state_dict() if 'running' in k]
    assert len(keys) == {'yolo': 6, 'resnet': 40}[arch]
    sd = M.gathered_state_dict(model)
    for k in keys:
        np.testing.assert_allclose(
            sd[k].numpy(), single.state_dict()[k].numpy(), rtol=1e-5,
            atol=1e-6 if 'mean' in k else 0, err_msg=k)


@pytest.mark.parametrize('order', [('train', 'eval', 'train', 'eval'),
                                   ('eval', 'train', 'eval')])
def test_train_and_eval_steps_alternate_on_a_mesh(order):
    """The train and eval steps of one state in turn on the 2 x 2 mesh, as
    an epoch pair of run_experiment takes them (SGD): each step's loss
    components, and the parameters and BatchNorm running statistics after
    the last, are those of the same steps on one device. Every data row
    runs each step in that step's mode, so an eval step normalises with
    the running statistics and leaves them as they were."""
    P = get_default_parameters()
    P.update(TILESIZE=64, BATCH_SIZE=8, DEVICE='cpu', ARCHITECTURE=SMALL)
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.normal(0.3, 1, (8, 5, 64, 64)).astype(
        np.float32))
    tgt = torch.zeros(8, P['SX'], P['SY'], 4)
    hit = torch.from_numpy(rng.random((8, P['SX'], P['SY'])) < 0.05)
    tgt[..., 0] = hit.float()
    tgt[..., 1:3] = torch.from_numpy(
        rng.random((8, P['SX'], P['SY'], 2), np.float32)) * hit[..., None]
    single = _port_sgd_state(P, PE.setup_model(P).model.state_dict())
    state = _port_sgd_state(P, single.model.state_dict())
    M.distribute_state(state, _mesh(2, 2))
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=2e-4)
    for which in order:
        step = PE.train_step if which == 'train' else PE.eval_step
        got, want = step(state, X, tgt), step(single, X, tgt)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=EPOCH_RTOL, err_msg=(which, k))
    _assert_params_close(M.gathered_state_dict(state.model),
                         single.model.state_dict())


def test_run_experiment_on_a_mesh_then_deploy_and_resume(tmp_path,
                                                         monkeypatch):
    """run_experiment(mesh=2 x 2) writes E0001.pt in the single-device
    layout (weights and Adam moments), deploy_run -> setup_inference ->
    inference serves it, and LOAD_MODEL resumes it on one device."""
    monkeypatch.setattr(config, 'OUTPUT_DIR', str(tmp_path / 'out'))
    P = _train_P(tmp_path / 'fix', TILESIZE=256, BATCH_SIZE=4, EPOCHS=2,
                 MODEL_CHECKPOINTS=(1,), CACHE=str(tmp_path / 'cache'),
                 MCF_MIN_FLOW=1, MCF_MAX_FLOW=50, LR=2e-3,
                 USE_TRANSFORMS=['vflip', 'translateX'])
    os.makedirs(P['CACHE'])
    with pytest.raises(ValueError, match="first device"):
        run_experiment('exp', P, save_results=False,
                       mesh=M.make_mesh(devices=[torch.device('meta')]))
    state = run_experiment('exp', P, save_results=True, mesh=_mesh(2, 2))
    assert state.mesh is not None and state.epoch == 2
    assert any(isinstance(m, M.ShardedLinear) for m in state.model.fcs)
    ckpt_file, = glob.glob(str(tmp_path / 'out/runs/exp/run00_*/models/'
                               'E0001.pt'))
    ckpt = torch.load(ckpt_file, weights_only=True)
    single = build_model(P)
    assert {k: v.shape for k, v in ckpt['model'].items()} == \
        {k: v.shape for k, v in single.state_dict().items()}
    shapes = [p.shape for p in single.parameters()]
    moments = ckpt['optimizer']['state']
    assert sorted(moments) == list(range(len(shapes)))
    for i, shape in enumerate(shapes):
        assert moments[i]['exp_avg'].shape == shape
        assert moments[i]['exp_avg_sq'].shape == shape

    bundle = PI.deploy_run('exp', 'run00', 1,
                           dest_dir=str(tmp_path / 'bundle'))
    dest = str(tmp_path / 'inference')
    params, model, scaler = PI.setup_inference(dest, device='cpu',
                                               deployed_dir=bundle)
    for k, v in model.state_dict().items():
        assert torch.equal(ckpt['model'][k], v), k
    tl = PI.prepare_input_data(os.path.basename(P['TIMELAPSE_FILE']),
                               params, dest,
                               os.path.dirname(P['TIMELAPSE_FILE']), scaler,
                               mask_fname=os.path.basename(P['MASK_FILE']),
                               use_cached_datasets=None)
    ax = PI.inference(tl, model, dest, params, None, None, None)
    ids, arr = ax.IDed_dets
    assert len(ids) and arr.shape == (len(ids), len(ax), 3)

    resumed = PE.setup_model(dict(P, LOAD_MODEL=['exp', 'run00', 1]))
    assert resumed.epoch == 2 and resumed.mesh is None
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, ckpt['model'][k]), k
    assert resumed.optimizer.state_dict()['state'][0]['exp_avg'].shape == \
        shapes[0]
    info = PE.one_epoch(PE.setup_data(P, skip_test=True)[0], resumed, P,
                        epoch=2, min_pos_rate=0)
    assert np.isfinite(info['total_summed_loss'])


def test_sharded_inference_fn_equals_one_device():
    """The eval-mode grid of tiles over 'data' and the FC head over
    'model', for a batch the axis divides and one it does not (left
    whole); the caller's model is not split."""
    P = get_default_parameters()
    P.update(TILESIZE=64, DEVICE='cpu', ARCHITECTURE=SMALL)
    model = build_model(P).eval()
    fn = M.sharded_inference_fn(model, _mesh())
    assert not any(isinstance(m, M.ShardedLinear) for m in model.modules())
    rng = np.random.default_rng(2)
    for n in (8, 7):
        X = torch.from_numpy(rng.random((n, 5, 64, 64), np.float32))
        with torch.no_grad():
            want = model(X)
        got = fn(X)
        assert got.shape == want.shape == (n, 12, 12, 3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
