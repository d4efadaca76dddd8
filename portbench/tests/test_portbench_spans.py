"""The readers of the program's spans and counters (``lib/spans.py``)
take exactly the window's calls or epochs: the inference and training
entries' windows run at a size the CPU holds, each reader's value is
worked out again from the records the window added, and a planted extra
record (a call or an epoch outside the window) changes nothing."""
import shutil
import tempfile
import time
from types import SimpleNamespace

import pytest
import torch

from _small import MOVIE, ROOT, TRAIN
from portbench.lib import harness, spans

INFER = {'tiling_ms': lambda r: 1e3 * spans.seconds(r, 'tiling'),
         'ided_ms': lambda r: 1e3 * spans.seconds(r, 'IDed_dets'),
         'glue_ms': lambda r: 1e3 * spans.self_seconds(r, 'inference'),
         'mcf_solve_ms': lambda r: 1e3 * spans.seconds(r, 'mcf.solve'),
         'syncs.infer': lambda r: r.counters.get('syncs', 0),
         'h2d.infer': lambda r: r.counters.get('h2d', 0),
         'flushes.assoc': lambda r: r.counters.get('flushes', 0)}
TRAINING = {'data_ms.train': lambda r: 1e3 * spans.seconds(r,
                                                           'prepare_data'),
            'syncs.train': lambda r: r.counters.get('syncs', 0)}


def _window(workload, mix, seconds):
    """Set-up and the window of ``workload`` on the CPU with tracing off:
    (the window's record, the trace records the window added)."""
    from axtrack_tpu_torch.utils import profiling
    _, _, conf, base = harness.cell_of(ROOT, workload)
    tmp = tempfile.mkdtemp(prefix='portbench-spans-')
    ctx = SimpleNamespace(root=ROOT, seed=5, trace=False,
                          device=torch.device('cpu'), config=conf,
                          mix=dict(base, **mix), tmp=tmp)
    try:
        entry = harness.entry_of(ctx.mix)
        st = entry.setup(ctx)
        before = set(map(id, profiling.records()))
        rec = entry.window(st, seconds, ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    added = [r for r in profiling.records() if id(r) not in before]
    return rec, added


def _plant(kind, spans_at, **meta):
    """A finished record of ``kind`` with a span of each (name, seconds)
    and a large count of every counter the readers read."""
    from axtrack_tpu_torch.utils import profiling
    r = profiling.StageTimer(kind, **meta)
    with r.span(spans_at[0][0]):
        pass
    r.spans = [[n, None, time.time_ns(), int(s * 1e9)] for n, s in spans_at]
    for name in ('syncs', 'h2d', 'flushes', 'sweeps'):
        r.count(name, 1000)
    return r


def _read(name, rec):
    return harness.reader(name).read(rec)


def test_inference_readers_take_exactly_the_window_calls():
    rec, added = _window('deployed.movie20', MOVIE, 0.3)
    calls = [r for r in added if r.kind == 'inference']
    assert len(calls) == len(rec['calls']) >= 1
    for c, r in zip(rec['calls'], calls):
        for k in spans.KEYS:
            assert c['timings'][k] == spans.seconds(r, k)
    got = {name: _read(name, rec) for name in [*INFER, 'sweeps.assoc']}
    for name, value in INFER.items():
        want = sum(map(value, calls)) / len(calls)
        assert got[name] == pytest.approx(want, rel=1e-12), name
    assert got['flushes.assoc'] >= 1
    assert got['sweeps.assoc'] == sum(
        r.counters.get('sweeps', 0) for r in calls) / sum(
        r.counters.get('flushes', 0) for r in calls)
    assert got['tiling_ms'] > 0 and got['glue_ms'] > 0

    # a call outside the window, slower in every stage
    _plant('inference', [('inference', 9.0), ('tiling', 1.0),
                         ('detect', 1.0), ('association', 1.0),
                         ('mcf', 1.0), ('mcf.solve', 0.5),
                         ('IDed_dets', 1.0)], movie='planted')
    assert {name: _read(name, rec) for name in got} == got
    # a window call without its record reads nothing
    gone = dict(rec, calls=rec['calls'] + [
        {'timings': {'detect': 2.0, 'association': 2.0, 'mcf': 2.0}}])
    assert all(_read(name, gone) is None for name in got)


def test_training_readers_take_exactly_the_window_epochs():
    rec, added = _window('deployed.train16', TRAIN, 0.3)
    n = len(rec['epochs'])
    epochs = [r for r in added if r.kind == 'epoch']
    assert sorted((r.meta['epoch'], r.meta['train']) for r in epochs) == [
        (e, t) for e in range(1, n + 1) for t in (False, True)]
    got = {name: _read(name, rec) for name in TRAINING}
    for name, value in TRAINING.items():
        assert got[name] == pytest.approx(
            sum(map(value, epochs)) / n, rel=1e-12), name
    assert got['data_ms.train'] > 0

    # the set-up's epoch and the one after the window, slower
    for e in (0, n + 1):
        for train in (True, False):
            _plant('epoch', [('epoch', 9.0), ('prepare_data', 5.0)],
                   epoch=e, train=train)
    assert {name: _read(name, rec) for name in got} == got


def test_a_program_without_records_reads_nothing(monkeypatch):
    from axtrack_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, 'records')
    rec = {'calls': [{'timings': {k: 1.0 for k in spans.KEYS}}],
           'epochs': [{'train_tiles': 1, 'test_tiles': 1}]}
    for name in [*INFER, 'sweeps.assoc', *TRAINING]:
        assert _read(name, rec) is None
