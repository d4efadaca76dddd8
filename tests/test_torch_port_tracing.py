"""The port's trace records (``axtrack_tpu_torch/utils/profiling.py``) on
the CPU: the spans of a small inference nest as the call runs its stages,
``timings`` are their durations, the counters agree with what the call
reports, every movie of ``inference_many`` and of the sharded route keeps
its spans in its own record, the spans and a ``torch.profiler`` trace
share one clock, no ``record_function`` is entered with the profiler off,
the log is bounded, and ``one_epoch`` opens a record an epoch.

A seeded synthetic movie (12 frames of 128x128 with a channel mask, 8
centre frames) and a tiny seeded detector (TILESIZE 64) keep each call
at a fraction of a second. Nothing here compares with the JAX package.
"""
import numpy as np
import pytest
import torch

from axtrack_tpu_torch import interface as PI
from axtrack_tpu_torch.data.synthetic import (make_synthetic_timelapse,
                                              write_fixture)
from axtrack_tpu_torch.data.timelapse import Timelapse
from axtrack_tpu_torch.models.yolo import build_model, init_weights
from axtrack_tpu_torch.params import get_default_parameters
from axtrack_tpu_torch.parallel.mesh import make_mesh
from axtrack_tpu_torch.train import engine as PE
from axtrack_tpu_torch.utils import profiling

torch.set_num_threads(1)
TINY = [[(3, 8, 2, 1), 'M', (3, 16, 1, 1), 'M'],
        [('FC', 32), ('activation', 'sigmoid')]]
# the spans of an inference call and the span each must lie in
PARENT = {'tiling': 'inference', 'detect': 'inference',
          'association': 'inference', 'association.flush': 'association',
          'mcf': 'inference', 'mcf.build': 'mcf', 'mcf.solve': 'mcf'}


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """(params, the tiny detector, a function making movie ``i``'s
    Timelapse, a destination directory) on the CPU."""
    root = tmp_path_factory.mktemp('tracing')
    P = get_default_parameters()
    P.update(TILESIZE=64, MCF_MIN_FLOW=1, MCF_MAX_FLOW=50, ARCHITECTURE=TINY)
    model = init_weights(build_model(P),
                         torch.Generator().manual_seed(3)).eval()

    def movie(i=0):
        frames, mask, _, _ = make_synthetic_timelapse(
            T=12, H=128, W=128, n_axons=4, seed=11 + i, n_channels=3)
        np.save(root / f'mask{i}.npy', mask)
        return Timelapse((frames * 65535.0 + 0.5).astype(np.uint16), None,
                         str(root / f'mask{i}.npy'), None, None, True, False,
                         ('zscore', (0.0142, 0.0128)), f'movie{i}',
                         tilesize=64, device='cpu')
    return P, model, movie, str(root)


def _by_name(record):
    out = {}
    for i, s in enumerate(record.spans):
        out.setdefault(s[0], []).append(i)
    return out


def _inside(record, child, parent):
    c, p = record.spans[child], record.spans[parent]
    return p[2] <= c[2] and c[2] + c[3] <= p[2] + p[3]


def test_inference_spans_nest_and_give_the_timings(served):
    P, model, movie, dest = served
    ax = PI.inference(movie(), model, dest, P, None, None, None)
    assert ax.IDed_dets_all is not None
    rec = ax.trace
    assert rec.kind == 'inference' and rec.meta == {'movie': 'movie0'}
    assert rec in profiling.records()
    names = _by_name(rec)
    assert set(names) == {*PARENT, 'inference', 'IDed_dets'}
    assert all(s[3] is not None and s[3] >= 0 for s in rec.spans)
    (root,) = names['inference']
    assert rec.spans[root][1] is None
    for name, parent in PARENT.items():
        for i in names[name]:
            assert rec.spans[rec.spans[i][1]][0] == parent, name
            assert _inside(rec, i, rec.spans[i][1]), name
    # _agg_IDed_dets in the call, the DataFrame on the first read after it
    agg, frame = names['IDed_dets']
    assert rec.spans[agg][1] == root and _inside(rec, agg, root)
    assert rec.spans[frame][1] is None
    assert rec.spans[frame][2] >= rec.spans[root][2] + rec.spans[root][3]
    ax.IDed_dets_all
    assert len(_by_name(rec)['IDed_dets']) == 2

    for k in ('detect', 'association', 'mcf'):
        (i,) = names[k]
        assert ax.timings[k] == rec.spans[i][3] / 1e9
        assert rec.summary()[k] == {'total_s': ax.timings[k], 'calls': 1}
    flushes = ax.assoc_flushes
    assert len(flushes) >= 1 and len(names['association.flush']) == len(
        flushes)
    assert rec.counters['flushes'] == len(flushes)
    assert rec.counters['sweeps'] == sum(f['sweeps'] for f in flushes)
    # nothing crosses to a card on the CPU
    assert rec.counters.get('syncs', 0) == rec.counters.get('h2d', 0) == 0
    summary = rec.summary()
    assert summary['IDed_dets']['calls'] == 2
    assert summary['mcf']['total_s'] == pytest.approx(ax.timings['mcf'])
    children = sum(rec.spans[i][3] for i, s in enumerate(rec.spans)
                   if s[1] == root)
    assert 0 <= rec.spans[root][3] - children < rec.spans[root][3]


def test_each_movie_keeps_its_spans_in_its_own_record(served):
    P, model, movie, dest = served
    tls = [movie(0), movie(1)]
    many = PI.inference_many(tls, model, dest, P, depth=2,
                             detections_cache=None, astar_paths_cache=None,
                             assigedIDs_cache=None)
    assert [a.trace.meta['movie'] for a in many] == ['movie0', 'movie1']
    for ax in many:
        rec = ax.trace
        names = _by_name(rec)
        # detection, then the identity solve; the eager association on its
        # thread, a root that may outlast the detection's span
        assert len(names['inference']) == 2
        assert len(names['detect']) == len(names['association']) == 1
        (assoc,) = names['association']
        assert rec.spans[assoc][1] is None
        assert ax.timings['association'] == rec.spans[assoc][3] / 1e9
        assert rec.counters['flushes'] == len(ax.assoc_flushes)
        for i in names['association.flush']:
            assert rec.spans[i][1] == assoc and _inside(rec, i, assoc)

    mesh = make_mesh(n_model=1, devices=[torch.device('cpu')] * 2)
    shards = [PI.inference(tl, model, dest, P, None, None, None,
                           shard_frames=True, mesh=mesh) for tl in tls]
    for ax in shards:
        rec = ax.trace
        names = _by_name(rec)
        (assoc,) = names['association']
        # each shard's thread records its flushes in this movie's record
        assert len(names['association.flush']) == len(ax.assoc_flushes)
        assert len({f['shard'] for f in ax.assoc_flushes}) == 2
        for i in names['association.flush']:
            assert rec.spans[i][1] == assoc and _inside(rec, i, assoc)
        (det,) = names['detect']
        assert ax.timings['detect'] == rec.spans[det][3] / 1e9
    assert shards[0].trace is not shards[1].trace


def test_spans_and_the_profiler_share_one_clock(served):
    from torch.profiler import ProfilerActivity, profile
    P, model, movie, dest = served
    tl = movie()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ax = PI.inference(tl, model, dest, P, None, None, None)
    events = sorted((ev.start_ns(), ev.end_ns(), ev.name()[len('axtrack.'):])
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith('axtrack.'))
    names = {n for _, _, n in events}
    assert {'detect.forward', 'detect.decode'} <= names
    rec = ax.trace
    matched = 0
    for name, idx in _by_name(rec).items():
        evs = [e for e in events if e[2] == name]
        assert len(evs) == len(idx), name
        for (s, e, _), i in zip(evs, idx):
            start, dur = rec.spans[i][2], rec.spans[i][3]
            assert start - 1e6 <= s and e <= start + dur + 1e6, name
            matched += 1
    assert matched == len(rec.spans)


def test_no_record_function_with_the_profiler_off(served, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    P, model, movie, dest = served
    tl = movie()
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, 'record_function', counting)
    PI.inference(tl, model, dest, P, None, None, None)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        PI.inference(tl, model, dest, P, None, None, None)
    assert 'axtrack.inference' in entered


def test_the_log_is_bounded():
    made = []
    for k in range(profiling.LOG_RECORDS + 5):
        r = profiling.StageTimer('test', k=k)
        with r.span('x'):
            pass
        made.append(r)
    log = profiling.records()
    assert len(log) == profiling.LOG_RECORDS
    assert log == made[5:]
    # a record with no span never enters the log
    profiling.StageTimer('test')
    assert profiling.records() == log


def test_one_epoch_opens_a_record_an_epoch(tmp_path):
    fx = write_fixture(str(tmp_path), name='train_movie', T=10, H=256,
                       W=512, n_axons=6, seed=5, n_channels=4)
    P = get_default_parameters()
    P.update(TIMELAPSE_FILE=fx['tif'], LABELS_FILE=fx['labels'],
             MASK_FILE=fx['mask'], TRAIN_TIMEPOINTS=list(range(2, 8)),
             TEST_TIMEPOINTS=[2, 3], TILESIZE=256, BATCH_SIZE=5, CACHE=None,
             FROM_CACHE=None, PLOT_PREPROC=False, USE_TRANSFORMS=['vflip'],
             SHUFFLE=False, ARCHITECTURE=[[(3, 8, 2, 1), 'M'],
                                          [('FC', 32),
                                           ('activation', 'sigmoid')]],
             DEVICE='cpu')
    train, test = PE.setup_data(P)
    state = PE.setup_model(P)
    before = set(map(id, profiling.records()))
    for epoch in (10, 11):
        PE.one_epoch(train, state, P, epoch, train=True)
        PE.one_epoch(test, state, P, epoch, train=False)
    recs = [r for r in profiling.records() if id(r) not in before]
    assert [(r.kind, r.meta) for r in recs] == [
        ('epoch', {'epoch': e, 'train': t})
        for e in (10, 11) for t in (True, False)]
    for r in recs:
        names = _by_name(r)
        (root,) = names['epoch']
        # one prepare_data span a draw: the first and each redraw
        assert len(names['prepare_data']) == r.counters['redraws'] + 1
        assert len(names['tiling']) >= len(names['prepare_data'])
        (steps,) = names['steps']
        assert r.spans[steps][1] == root and _inside(r, steps, root)
        for i in names['prepare_data']:
            assert r.spans[i][1] == root and _inside(r, i, root)
        # the every-10th-epoch F1 pass detects inside its epoch's record
        if r.meta['epoch'] == 10:
            (f1,) = names['f1']
            (det,) = names['detect']
            assert r.spans[det][1] == f1 and _inside(r, det, f1)
        else:
            assert 'f1' not in names and 'detect' not in names
