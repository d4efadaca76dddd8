"""A training chunk's frames split over 'data' (``train/bigmovie.py``:
``frame_slices``, ``ChunkRows``, ``assemble_chunk``), the port's
counterpart of the JAX package's ``frames_constrain`` /
``replicate_constrain`` in its chunk program.

On fake CPU meshes (``make_mesh(devices=[cpu] * n)``), with the plan of
``test_torch_port_mesh_train.py``'s chunked case: each data row builds
only its own contiguous slice of each chunk (recorded at
``Timelapse.range_tiles``, on the rows' threads), the slices cover the
chunk exactly once, the assembled tiles are bit-equal to one device's
``range_tiles(lo, hi)`` (every op of the chain works frame by frame), and
the epoch equals one device's within the bounds the JAX package holds its
mesh to (``tests/test_parallel.py``: SGD, per-batch losses rtol 2e-3,
parameters rtol 2e-3 / atol 3e-4). A chunk of fewer frames than data rows
leaves rows without frames. Across two processes (gloo on localhost,
``tests/_torch_chunk_worker.py``) the slices of the other process's rows
arrive by one all-gather a chunk.
"""
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from axtrack_tpu_torch.data.synthetic import write_fixture
from axtrack_tpu_torch.data.timelapse import Timelapse
from axtrack_tpu_torch.parallel import mesh as M
from axtrack_tpu_torch.params import get_default_parameters
from axtrack_tpu_torch.train import bigmovie as PB
from axtrack_tpu_torch.train import engine as PE

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device('cpu')
SMALL = [[(3, 8, 2, 1), (3, 16, 2, 1), 'M', (3, 16, 1, 1), 'M'],
         [('FC', 64), ('activation', 'sigmoid'),
          ('FC', 64), ('activation', 'sigmoid')]]
EPOCH_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-3, 3e-4


def fixture(directory):
    """TestShardedEpoch's movie (10 frames of 256 x 512) written into
    ``directory``: its file names."""
    fx = write_fixture(str(directory), T=10, H=256, W=512, n_axons=4,
                       seed=5, n_channels=4)
    return {k: fx[k] for k in ('tif', 'labels', 'mask')}


def staged_P(fx, **kw):
    """TestShardedEpoch's settings on the movie ``fx`` (128-px tiles,
    batch 4, no augmentation, no shuffle)."""
    P = get_default_parameters()
    P.update(TIMELAPSE_FILE=fx['tif'], LABELS_FILE=fx['labels'],
             MASK_FILE=fx['mask'], TRAIN_TIMEPOINTS=list(range(2, 8)),
             TEST_TIMEPOINTS=[2, 3], TILESIZE=128, BATCH_SIZE=4, CACHE=None,
             FROM_CACHE=None, PLOT_PREPROC=False, USE_TRANSFORMS=[],
             SHUFFLE=False, ARCHITECTURE=SMALL, DEVICE='cpu')
    P.update(kw)
    return P


def staged_dataset(P):
    """The movie staged and streamed (budgets lowered), tiled."""
    saved = Timelapse._DEVICE_MOVIE_BUDGET, Timelapse._RESIDENT_U16_BUDGET
    Timelapse._DEVICE_MOVIE_BUDGET, Timelapse._RESIDENT_U16_BUDGET = \
        512 * 1024, 0
    try:
        staged, _ = PE.setup_data(P, skip_test=True)
    finally:
        Timelapse._DEVICE_MOVIE_BUDGET, Timelapse._RESIDENT_U16_BUDGET = saved
    assert staged._u16_staged and staged._X_u16_dev is None
    PE.prepare_data(staged)
    return staged


def chunk_budget(staged, frames):
    """The chunk budget of ``frames`` centre timepoints."""
    K = staged.ntiles_kept
    return frames * (K * 128 * 128 * 4 + staged.sizey * staged.sizex * 10)


def plan(staged, P, frames):
    """A plan of chunks of ``frames`` centre timepoints."""
    return PB.plan_chunks(staged, P,
                          chunk_budget=chunk_budget(staged, frames))


def sgd_state(P, mesh=None):
    """The seeded model of P with SGD at 2e-4, on ``mesh`` if given."""
    state = PE.setup_model(P)
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=2e-4)
    return M.distribute_state(state, mesh) if mesh is not None else state


class Recorder:
    """Records each ``range_tiles`` call (frames, calling thread) and each
    chunk ``assemble_chunk`` returns: (lo, hi, its tiles cloned, the
    ``range_tiles`` calls made while it was built)."""

    def __init__(self):
        self.calls, self.chunks = [], []
        self._lock = threading.Lock()
        self._range_tiles = Timelapse.range_tiles
        self._assemble = PB.assemble_chunk

    def install(self, monkeypatch):
        rec = self

        def range_tiles(ds, lo, hi, copied=None, device=None):
            with rec._lock:
                rec.calls.append((lo, hi, threading.get_ident()))
            return rec._range_tiles(ds, lo, hi, copied, device)

        def assemble_chunk(cr, lo, hi, copied):
            start = len(rec.calls)
            tiles = rec._assemble(cr, lo, hi, copied)
            rec.chunks.append((lo, hi, {d: t.clone()
                                        for d, t in tiles.items()},
                               rec.calls[start:]))
            return tiles
        monkeypatch.setattr(Timelapse, 'range_tiles', range_tiles)
        monkeypatch.setattr(PB, 'assemble_chunk', assemble_chunk)

    def tiles_equal_one_device(self, staged):
        """Every assembled chunk is bit-equal to one device's tiles."""
        return all(torch.equal(t, self._range_tiles(staged, lo, hi))
                   for lo, hi, tiles, _ in self.chunks
                   for t in tiles.values())

    def built(self):
        """The sorted (a, b) slices built for each recorded chunk."""
        return [sorted((a, b) for a, b, _ in calls)
                for *_, calls in self.chunks]


def epoch_close(got, want):
    """The mesh epoch's losses and parameters against one device's."""
    np.testing.assert_allclose(got[0]['total_summed_loss'],
                               want[0]['total_summed_loss'], rtol=EPOCH_RTOL)
    a = M.gathered_state_dict(got[1].model)
    b = want[1].model.state_dict()
    assert sorted(a) == sorted(b)
    for k in b:
        if not k.endswith('num_batches_tracked'):
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize('n,rows', [(6, 4), (7, 4), (5, 8), (1, 2), (9, 3)])
def test_frame_slices_cover_the_chunk_once(n, rows):
    slices = PB.frame_slices(10, 10 + n, rows)
    assert len(slices) == rows
    assert slices[0][0] == 10 and slices[-1][1] == 10 + n
    assert all(a <= b for a, b in slices)
    assert all(slices[i][1] == slices[i + 1][0] for i in range(rows - 1))
    sizes = [b - a for a, b in slices]
    assert max(sizes) - min(sizes) <= 1


def _split_epoch(tmp_path, monkeypatch, n_data, frames, **kw):
    P = staged_P(fixture(tmp_path), **kw)
    staged = staged_dataset(P)
    chunks, K = plan(staged, P, frames)
    assert len(chunks) > 1
    rec = Recorder()
    rec.install(monkeypatch)
    mesh = M.make_mesh(n_data, 8 // n_data, devices=[CPU] * 8)
    states = sgd_state(P, mesh), sgd_state(P)
    got = (PB.run_epoch_chunked(states[0], staged, 'train', P,
                                plan=(chunks, K)), states[0])
    want = (PB.run_epoch_chunked(states[1], staged, 'train', P,
                                 plan=(chunks, K)), states[1])
    assert staged.X_tiled is None
    assert [(lo, hi) for lo, hi, *_ in rec.chunks] == 2 * [
        (ch['lo'], ch['hi']) for ch in chunks]
    # on the mesh each row built its own slice, and only that, on the
    # rows' threads; on one device the whole chunk
    built = rec.built()
    assert built[:len(chunks)] == [
        sorted(s for s in PB.frame_slices(ch['lo'], ch['hi'], n_data)
               if s[1] > s[0]) for ch in chunks]
    assert built[len(chunks):] == [[(ch['lo'], ch['hi'])] for ch in chunks]
    threads = {t for *_, calls in rec.chunks[:len(chunks)]
               for *_, t in calls}
    assert len(threads) > 1
    assert all(len(tiles) == 1 for _, _, tiles, _ in rec.chunks)
    assert rec.tiles_equal_one_device(staged)
    epoch_close(got, want)
    return chunks, K


def test_chunk_frames_split_over_data_on_a_4x2_mesh(tmp_path, monkeypatch):
    """The 4 x 2 mesh at batch 4 (a tile a data row; each chunk's
    remainder batch stays whole on the first row), chunks of one centre
    timepoint (5 frames: 1 + 1 + 1 + 2 a row)."""
    chunks, _ = _split_epoch(tmp_path, monkeypatch, 4, 1)
    assert all(len(ch['batches']) and len(ch['rest']) for ch in chunks)
    assert {ch['hi'] - ch['lo'] for ch in chunks} == {5}


def test_chunk_of_fewer_frames_than_data_rows(tmp_path, monkeypatch):
    """The 8 x 1 mesh at batch 8, chunks of one centre timepoint (5
    frames over 8 rows: three rows build nothing)."""
    chunks, K = _split_epoch(tmp_path, monkeypatch, 8, 1, BATCH_SIZE=8)
    assert {ch['hi'] - ch['lo'] for ch in chunks} == {5}
    assert sum(b == a for a, b in PB.frame_slices(0, 5, 8)) == 3
    assert any(len(ch['batches']) for ch in chunks), K


def test_split_epoch_equals_jax_mesh_epoch(tmp_path, monkeypatch):
    """The JAX package's chunked epoch on its 4 x 2 mesh (the set-up of
    ``tests/test_parallel.py``'s chunked case, whose ``frames_constrain``
    splits each chunk's frames over 'data') against the port's split
    epoch on its 4 x 2 mesh: the same staged movie, weights and plan (one
    centre timepoint a chunk); per-batch losses and parameters within the
    mesh bounds."""
    import jax
    from axtrack_tpu.data.timelapse import Timelapse as JTimelapse
    from axtrack_tpu.parallel import mesh as JM
    from axtrack_tpu.params import get_default_parameters as jax_defaults
    from axtrack_tpu.train import bigmovie as JB
    from axtrack_tpu.train import engine as JE
    from axtrack_tpu.utils import set_seed as jax_set_seed
    from axtrack_tpu_torch.models.yolo import weights_from_jax
    from tests.test_bigmovie import TestChunkedEpoch
    P = staged_P(fixture(tmp_path))
    JP = jax_defaults()
    JP.update({k: v for k, v in P.items() if k != 'DEVICE'})
    staged = staged_dataset(P)
    jax_set_seed(P['SEED'])
    monkeypatch.setattr(JTimelapse, '_DEVICE_MOVIE_BUDGET', 512 * 1024)
    jd, _ = JE.setup_data(JP, skip_test=True)
    assert jd._u16_staged
    JE.prepare_data(jd)
    chunks, K = plan(staged, P, 1)
    jchunks, jK = JB.plan_chunks(jd, JP, shuffle=False,
                                 chunk_budget=chunk_budget(staged, 1))
    assert len(chunks) > 1 and K == jK
    assert [(c['lo'], c['hi']) for c in chunks] == [
        (c['lo'], c['hi']) for c in jchunks]
    assert all(np.array_equal(a['batches'], b['batches'])
               and np.array_equal(a['rest'], b['rest'])
               for a, b in zip(chunks, jchunks))

    js = TestChunkedEpoch._sgd_state(JP)
    state = PE.setup_model(P)
    state.model.load_state_dict(weights_from_jax(
        jax.tree.map(np.asarray, js.variables), P))
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=2e-4)
    js = JM.distribute_state(js, JM.make_mesh())        # 'data' 4, 'model' 2
    M.distribute_state(state, M.make_mesh(4, 2, devices=[CPU] * 8))
    rec = Recorder()
    rec.install(monkeypatch)
    want = JB.run_epoch_chunked(js, jd, 'train', JP, plan=(jchunks, jK))
    got = PB.run_epoch_chunked(state, staged, 'train', P, plan=(chunks, K))
    assert rec.built() == [
        sorted(s for s in PB.frame_slices(ch['lo'], ch['hi'], 4)
               if s[1] > s[0]) for ch in chunks]
    np.testing.assert_allclose(
        got['total_summed_loss'],
        np.asarray(want.loc['total_summed_loss'], float), rtol=EPOCH_RTOL)
    a = M.gathered_state_dict(state.model)
    b = weights_from_jax(jax.tree.map(np.asarray, js.variables), P)
    assert sorted(a) == sorted(b)
    for k in b:
        if not k.endswith('num_batches_tracked'):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_split_a_chunk(tmp_path):
    """Two processes, two data rows each (a 4 x 1 mesh over gloo): each
    process builds the slices of its own rows, the all-gathered chunk is
    bit-equal to one device's, and the epoch equals one device's."""
    fx = fixture(tmp_path)
    coord = f'127.0.0.1:{_free_port()}'
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, '_torch_chunk_worker.py'),
         coord, '2', str(rank), json.dumps(fx)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out[-3000:]}'
    res = [json.loads(line.split(' ', 1)[1]) for out in outs
           for line in out.splitlines() if line.startswith('CHUNK_OK ')]
    assert sorted(r['rank'] for r in res) == [0, 1], outs
    assert all(r['tiles_equal'] and r['epoch_close'] for r in res), res
    assert res[0]['losses'] == res[1]['losses']
    for ch, *built in zip(res[0]['chunks'], res[0]['built'],
                          res[1]['built']):
        slices = [tuple(s) for s in PB.frame_slices(*ch, 4)]
        assert [tuple(s) for s in built[0]] == [s for s in slices[:2]
                                                if s[1] > s[0]]
        assert [tuple(s) for s in built[1]] == [s for s in slices[2:]
                                                if s[1] > s[0]]
