"""Port parity for movies beyond the device budget: the staged-u16
Timelapse, the chunked host-f32 Timelapse, chunk-resident training epochs
and chunked detection.

Both packages are forced onto their big-movie paths on a small fixture by
their budgets: the class attribute ``Timelapse._DEVICE_MOVIE_BUDGET`` (the
environment variable ``AXTRACK_DEVICE_MOVIE_BUDGET`` does the same in the
port), ``_RESIDENT_U16_BUDGET`` = 0 to stream a staged movie's chunks, and
the chunk budget of ``plan_chunks``.

Tolerances: a staged movie's frames rtol 1e-6 / atol 1e-6 against the
JAX package's whole-movie frames (XLA's log2 against PyTorch's, as in
test_torch_port_data.py), and atol 2e-5 against its staged frames and
tiles: the JAX package's staged chain is one jitted program, whose
log2(1 + x) rounds otherwise than its whole-movie chain's eager ops, by up
to 8.6e-6 here; 2e-5 is the tolerance its own tests/test_bigmovie.py holds
its staged tiles to. A computed scaler rtol 1e-6; kept-tile tables,
non-empty tables, raw integers and target grids exact; a chunked epoch's
per-batch losses rtol 1e-4 (test_torch_port_train.py's epoch tolerance).
Within the port, staged (resident and streamed) and host-f32 datasets are
bit-equal to the whole-movie dataset, and so are their detections,
association distances and identities at the same ``chunk_frames``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from axtrack_tpu.data.timelapse import Timelapse as JTimelapse
from axtrack_tpu.params import get_default_parameters as jax_defaults
from axtrack_tpu.train import engine as JE
from axtrack_tpu.train import bigmovie as JB
from axtrack_tpu.utils import set_seed as jax_set_seed
from axtrack_tpu_torch.data.synthetic import write_fixture
from axtrack_tpu_torch.data.tiffio import read_tiff_raw
from axtrack_tpu_torch.data.timelapse import Timelapse
from axtrack_tpu_torch.models.yolo import weights_from_jax
from axtrack_tpu_torch.params import get_default_parameters
from axtrack_tpu_torch.train import bigmovie as PB
from axtrack_tpu_torch.train import engine as PE

torch.set_num_threads(1)
SMALL_BUDGET = 512 * 1024          # forces the big-movie paths
TINY = [[(3, 8, 2, 1), (3, 16, 2, 1), 'M', (3, 16, 1, 1), 'M'],
        [('FC', 128), ('activation', 'sigmoid')]]
RTOL = ATOL = 1e-6
JAX_STAGED_ATOL = 2e-5


def _params(tmp_path, **kw):
    fx = write_fixture(str(tmp_path), name='train_movie', T=10, H=256,
                       W=512, n_axons=4, seed=5, n_channels=4)
    P = get_default_parameters()
    P.update(TIMELAPSE_FILE=fx['tif'], LABELS_FILE=fx['labels'],
             MASK_FILE=fx['mask'], TRAIN_TIMEPOINTS=list(range(2, 8)),
             TEST_TIMEPOINTS=[2, 3], TILESIZE=128, BATCH_SIZE=4, CACHE=None,
             FROM_CACHE=None, PLOT_PREPROC=False, SHUFFLE=False,
             USE_TRANSFORMS=['translateY', 'translateX', 'hflip', 'vflip'],
             ARCHITECTURE=TINY, DEVICE='cpu', LR=2e-3, WEIGHT_DECAY=0.05)
    P.update(kw)
    return P


def _jax_P(P):
    JP = jax_defaults()
    JP.update({k: v for k, v in P.items() if k != 'DEVICE'})
    return JP


def _port_data(P, monkeypatch, budget=SMALL_BUDGET, resident=None):
    with monkeypatch.context() as m:
        m.setattr(Timelapse, '_DEVICE_MOVIE_BUDGET', budget)
        m.setattr(Timelapse, '_RESIDENT_U16_BUDGET', resident)
        return PE.setup_data(P, skip_test=True)[0]


def _jax_data(P, monkeypatch, budget=SMALL_BUDGET):
    jax_set_seed(P['SEED'])
    with monkeypatch.context() as m:
        m.setattr(JTimelapse, '_DEVICE_MOVIE_BUDGET', budget)
        return JE.setup_data(_jax_P(P), skip_test=True)[0]


class ScriptedRng:
    """Yields a scripted value per transform-config draw."""

    def __init__(self, script):
        self.script = list(script)

    def random(self):
        return self.script.pop(0)


def _script(P, n_epochs):
    """Per epoch a different draw: translateY 0.95 (dy=+102), then vflip
    0.9 and translateX 0.65 (dx=-51), then hflip 0.8, then nothing."""
    fire = [{'translateY': .95}, {'vflip': .9, 'translateX': .65},
            {'hflip': .8}, {}]
    return [fire[e % len(fire)].get(k, .5) for e in range(n_epochs)
            for k in P['USE_TRANSFORMS']]


def test_staged_dataset_equals_jax_staged(tmp_path, monkeypatch):
    """Computed scaler, raw integers, non-empty table, kept tiles, targets,
    frames and tile stacks of the staged dataset against JAX's staged
    one."""
    P = _params(tmp_path)
    jd = _jax_data(P, monkeypatch)
    jwhole = _jax_data(P, monkeypatch, budget=4 * 1024 ** 3)
    pd_ = _port_data(P, monkeypatch)
    assert jd._u16_staged and pd_._u16_staged and not jwhole._u16_staged
    assert pd_.X.dtype == torch.uint16 and pd_.X.device.type == 'cpu'
    np.testing.assert_array_equal(pd_.X.numpy(), jd.X)
    np.testing.assert_array_equal(pd_._nonempty_table, jd._nonempty_table)
    assert pd_.stnd_scaler[0] == jd.stnd_scaler[0] == 'zscore'
    np.testing.assert_allclose(pd_.stnd_scaler[1], jd.stnd_scaler[1],
                               rtol=RTOL)
    jd.construct_tiles(force_no_transformation=True)
    pd_.construct_tiles(force_no_transformation=True)
    assert jd.X_tiled is None and pd_.X_tiled is None
    np.testing.assert_array_equal(pd_._tile_flat_idx, jd._tile_flat_idx)
    np.testing.assert_array_equal(pd_.target_tiled.numpy(),
                                  np.asarray(jd.target_tiled))
    np.testing.assert_array_equal(pd_.tile_info, jd.tile_info)
    for t in range(pd_.sizet):
        img = pd_.get_frame_image(t).numpy()
        np.testing.assert_allclose(img, jwhole.get_frame_image(t),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(img, jd.get_frame_image(t),
                                   rtol=0, atol=JAX_STAGED_ATOL)
        X, tgt = pd_.get_frametiles_stack(t)
        jX, jtgt = jd.get_frametiles_stack(t)
        np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0,
                                   atol=JAX_STAGED_ATOL)
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))
    assert len(pd_) == len(jd)
    for idx in (0, len(pd_) // 2, len(pd_) - 1):
        X, tgt = pd_[idx]
        jX, jtgt = jd[idx]
        np.testing.assert_allclose(X.numpy(), jX, rtol=0,
                                   atol=JAX_STAGED_ATOL)
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))


def test_transformed_keep_sets_equal_jax_and_whole_movie(tmp_path,
                                                         monkeypatch):
    """The kept-tile set from the per-pixel max equals JAX's staged one and
    the port's whole-movie one for each scripted draw."""
    P = _params(tmp_path)
    jd = _jax_data(P, monkeypatch)
    staged = _port_data(P, monkeypatch)
    whole = _port_data(P, monkeypatch, budget=None)
    assert not whole._on_host
    script = _script(P, 4)
    for d in (jd, staged, whole):
        d._rng = ScriptedRng(script)
    keep_sets = set()
    for _ in range(4):
        for d in (jd, staged, whole):
            d.construct_tiles()
        assert (staged.last_transform_configs == jd.last_transform_configs
                == whole.last_transform_configs)
        np.testing.assert_array_equal(staged._tile_flat_idx,
                                      jd._tile_flat_idx)
        np.testing.assert_array_equal(staged._tile_flat_idx,
                                      whole._tile_flat_idx)
        np.testing.assert_array_equal(staged.target_tiled.numpy(),
                                      np.asarray(jd.target_tiled))
        assert staged._chunk_epoch == dict(jd._chunk_epoch)
        keep_sets.add(tuple(staged._tile_flat_idx))
        # the transformed tiles of the staged route equal the whole movie's
        for t in (0, staged.sizet - 1):
            assert torch.equal(staged.get_frametiles_stack(t)[0],
                               whole.get_frametiles_stack(t)[0])
    assert len(keep_sets) > 1


@pytest.mark.parametrize('route', ['resident', 'streamed', 'host_f32'])
def test_big_movie_routes_bit_equal_whole_movie(tmp_path, monkeypatch,
                                                route):
    """Staged (resident and streamed) and host-f32 datasets give the whole
    movie's scaler, tables, tiles, frames, items and targets exactly."""
    P = _params(tmp_path, USE_TRANSFORMS=[])
    whole = _port_data(P, monkeypatch, budget=None)
    if route == 'host_f32':
        P = dict(P, TIMELAPSE_FILE=read_tiff_raw(P['TIMELAPSE_FILE'])
                 / np.float32(65535.0))
    big = _port_data(P, monkeypatch,
                     resident=0 if route == 'streamed' else None)
    assert big._on_host and big._u16_staged == (route != 'host_f32')
    assert (big._X_u16_dev is None) == (route != 'resident')
    assert big.stnd_scaler == whole.stnd_scaler
    for d in (whole, big):
        d.construct_tiles(force_no_transformation=True)
    np.testing.assert_array_equal(big._tile_flat_idx, whole._tile_flat_idx)
    np.testing.assert_array_equal(big.tile_info, whole.tile_info)
    assert torch.equal(big.target_tiled, whole.target_tiled)
    if route == 'host_f32':
        assert torch.equal(big.X_tiled, whole.X_tiled)
    for t in range(big.sizet):
        assert torch.equal(big.get_frame_image(t), whole.get_frame_image(t))
        assert torch.equal(big.get_frametiles_stack(t)[0],
                           whole.get_frametiles_stack(t)[0])
    for idx in (0, len(big) // 2, len(big) - 1):
        assert torch.equal(big[idx][0], whole[idx][0])
    if big._u16_staged:
        big.materialize_tiles()
        assert big.X_tiled.device.type == 'cpu'
        assert torch.equal(big.X_tiled, whole.X_tiled)


@pytest.mark.parametrize('mode', ['include', 'framewise'])
def test_host_f32_other_modes_equal_whole_movie(tmp_path, monkeypatch, mode):
    """A uint16 movie that may not be staged (motion channels, framewise
    standardization) takes the host-f32 path: its chunked preprocessing
    (motion frames with a one-frame halo, chunked statistics) and tiles
    equal the whole movie's to rtol 1e-6."""
    kw = (dict(USE_MOTION_DATA='include') if mode == 'include'
          else dict(STANDARDIZE_FRAMEWISE=True))
    P = _params(tmp_path, USE_TRANSFORMS=[], **kw)
    whole = _port_data(P, monkeypatch, budget=None)
    big = _port_data(P, monkeypatch)
    assert big._on_host and not big._u16_staged
    for d in (whole, big):
        d.construct_tiles(force_no_transformation=True)
    np.testing.assert_array_equal(big._tile_flat_idx, whole._tile_flat_idx)
    assert big.X_tiled.shape == whole.X_tiled.shape
    np.testing.assert_allclose(big.X_tiled.numpy(), whole.X_tiled.numpy(),
                               rtol=RTOL, atol=ATOL)
    X, _ = big.get_frametiles_stack(1)
    np.testing.assert_allclose(X.numpy(),
                               whole.get_frametiles_stack(1)[0].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_plan_chunks_equals_jax(tmp_path, monkeypatch):
    """SHUFFLE=False plans equal JAX's chunk for chunk (DROP_LAST off and
    on); a shuffled plan from the state's generator covers every pair once;
    a chunk with no full batch under DROP_LAST yields an empty epoch."""
    P = _params(tmp_path)
    jd = _jax_data(P, monkeypatch)
    pd_ = _port_data(P, monkeypatch)
    jd.construct_tiles(force_no_transformation=True)
    pd_.construct_tiles(force_no_transformation=True)
    K = pd_.ntiles_kept
    budget = 2 * (K * 128 * 128 * 4 + 256 * 512 * 10)
    for drop_last in (False, True):
        P2 = dict(P, DROP_LAST=drop_last, BATCH_SIZE=6)
        want, jK = JB.plan_chunks(jd, _jax_P(P2), shuffle=False,
                                  chunk_budget=budget)
        got, pK = PB.plan_chunks(pd_, P2, chunk_budget=budget)
        assert pK == jK == K and len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert {k: g[k] for k in ('t0', 't1', 'lo', 'hi')} == \
                {k: w[k] for k in ('t0', 't1', 'lo', 'hi')}
            np.testing.assert_array_equal(g['batches'], w['batches'])
            np.testing.assert_array_equal(g['rest'], w['rest'])
    with pytest.raises(ValueError, match='rng'):
        PB.plan_chunks(pd_, P, shuffle=True, chunk_budget=budget)
    chunks, _ = PB.plan_chunks(pd_, P, shuffle=True, chunk_budget=budget,
                               rng=np.random.default_rng(0))
    seen = np.concatenate([np.concatenate([c['batches'].ravel(), c['rest']])
                           for c in chunks])
    np.testing.assert_array_equal(np.sort(seen), np.arange(pd_.sizet * K))
    assert not np.array_equal(seen, np.arange(pd_.sizet * K))

    P3 = dict(P, DROP_LAST=True, BATCH_SIZE=10 ** 6)
    state = PE.setup_model(P3)
    before = [p.detach().clone() for p in state.model.parameters()]
    assert PB.run_epoch_chunked(state, pd_, 'train', P3) == {}
    assert all(torch.equal(a, b) for a, b in
               zip(before, state.model.parameters()))


def _states(P):
    """The JAX TrainState (flax init, seeded conv biases, as
    test_torch_port_train.py sets them) and the port's with its weights."""
    JP = _jax_P(P)
    jax_set_seed(P['SEED'])
    js = JE.setup_model(JP)
    rng = np.random.default_rng(0)
    for blk in js.params.values():
        if 'Conv_0' in blk:
            n = blk['Conv_0']['bias'].shape
            blk['Conv_0']['bias'] = jnp.asarray(
                rng.uniform(.05, .1, n) * rng.choice([-1, 1], n), jnp.float32)
    js._steps = JE.make_train_step(js.model, js.tx, JP)
    ps = PE.setup_model(P)
    ps.model.load_state_dict(weights_from_jax(
        jax.tree.map(np.asarray, js.variables), P))
    return js, ps


def test_chunked_epoch_equals_jax(tmp_path, monkeypatch):
    """Two chunk-resident epochs with scripted transform draws (the second
    changes the kept set), SHUFFLE off, the same plan and the same weights:
    per-batch losses equal JAX's ``run_epoch_chunked`` to rtol 1e-4, and
    the port's chunked epoch equals its whole-movie epoch over the same
    batches exactly."""
    P = _params(tmp_path)
    JP = _jax_P(P)
    jd = _jax_data(P, monkeypatch)
    pd_ = _port_data(P, monkeypatch, resident=0)
    whole = _port_data(P, monkeypatch, budget=None)
    script = _script(P, 2)
    for d in (jd, pd_, whole):
        d._rng = ScriptedRng(script)
    js, ps = _states(P)
    _, ps_whole = _states(P)
    keep_sets = []
    for epoch in range(2):
        for d in (jd, pd_, whole):
            PE.prepare_data(d)
        keep_sets.append(tuple(pd_._tile_flat_idx))
        K = pd_.ntiles_kept
        budget = 2 * (K * 128 * 128 * 4 + 256 * 512 * 10)
        jplan = JB.plan_chunks(jd, JP, shuffle=False, chunk_budget=budget)
        plan = PB.plan_chunks(pd_, P, chunk_budget=budget)
        assert len(plan[0]) > 1
        want = JB.run_epoch_chunked(js, jd, 'train', JP, plan=jplan)
        got = PB.run_epoch_chunked(ps, pd_, 'train', P, plan=plan)
        assert pd_.X_tiled is None
        assert sorted(got) == sorted(want.index)
        for k in got:
            np.testing.assert_allclose(got[k], want.loc[k].to_numpy(),
                                       rtol=1e-4, err_msg=k)
        replay = []
        for ch in plan[0]:
            replay += list(ch['batches']) + ([ch['rest']] if len(ch['rest'])
                                             else [])
        same = PE.run_batches(ps_whole, whole, 'train', replay)
        for k in got:
            np.testing.assert_array_equal(got[k], same[k])
    assert keep_sets[0] != keep_sets[1]
    for a, b in zip(ps.model.state_dict().values(),
                    ps_whole.model.state_dict().values()):
        assert torch.equal(a, b)


def test_one_epoch_on_staged_dataset(tmp_path, monkeypatch):
    """one_epoch routes a staged dataset (train with the epoch-0 F1 pass,
    then eval) through the chunked epoch; nothing is materialized."""
    P = _params(tmp_path)
    pd_ = _port_data(P, monkeypatch)
    monkeypatch.setenv('AXTRACK_CHUNK_BUDGET', str(3 * 256 * 512 * 10))
    state = PE.setup_model(P)
    info = PE.one_epoch(pd_, state, P, epoch=0, train=True, min_pos_rate=0)
    assert pd_.X_tiled is None and ('F1', 0.7) in info
    assert np.isfinite(info['total_summed_loss'])
    assert info['total_summed_loss'] > 0
    info = PE.one_epoch(pd_, state, P, epoch=1, train=False, min_pos_rate=0)
    assert pd_.X_tiled is None and info['total_summed_loss'] > 0


def test_host_f32_epoch_streams_like_device_epoch(tmp_path, monkeypatch):
    """A host-f32 dataset's epoch gathers its batches on the host: the
    losses and the weights after it equal the whole movie's exactly."""
    P = _params(tmp_path, USE_TRANSFORMS=[])
    whole = _port_data(P, monkeypatch, budget=None)
    big = _port_data(dict(P, TIMELAPSE_FILE=read_tiff_raw(
        P['TIMELAPSE_FILE']) / np.float32(65535.0)), monkeypatch)
    states = [PE.setup_model(P), PE.setup_model(P)]
    out = [PE.one_epoch(d, s, P, epoch=1) for d, s in zip((whole, big),
                                                           states)]
    assert not big._u16_staged and big.X_tiled.device.type == 'cpu'
    assert out[0] == out[1]
    for a, b in zip(*[s.model.state_dict().values() for s in states]):
        assert torch.equal(a, b)


def test_load_cache_keeps_staged_u16_on_host(tmp_path, monkeypatch):
    P = _params(tmp_path, CACHE=str(tmp_path))
    pd_ = _port_data(P, monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(Timelapse, '_DEVICE_MOVIE_BUDGET', SMALL_BUDGET)
        back = Timelapse(None, None, None, None, None, None, None, None,
                         'train', from_cache=str(tmp_path), device='cpu')
    assert back._u16_staged and back.X.dtype == torch.uint16
    assert back.X.device.type == 'cpu' and torch.equal(back.X, pd_.X)
    assert back._X_u16_dev is not None            # resident again
    for d in (pd_, back):
        d.construct_tiles(force_no_transformation=True)
    assert torch.equal(back.get_frametiles_stack(2)[0],
                       pd_.get_frametiles_stack(2)[0])
