"""Worker process of the port's two-process chunk-split test
(test_torch_port_chunk_split.py).

Run as: python _torch_chunk_worker.py <coordinator host:port> <world>
<rank> <the fixture's file names as JSON>

Each process drives two CPU devices as two data rows (``make_global_mesh``
with a 'model' axis of 1), so the global mesh is 4 x 1 with 'data'
spanning the processes. It trains one chunk-resident SGD epoch of the
fixture's staged movie on the mesh and one on a single device from the
same weights, and prints one line, ``CHUNK_OK`` and a JSON object: the
chunks, the slices this process built of each, whether every assembled
chunk was bit-equal to one device's tiles, the mesh epoch's losses and
whether the epoch held the mesh bounds against one device.
"""
import json
import os
import sys

coord, world, rank, fx = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                          json.loads(sys.argv[4]))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from axtrack_tpu_torch.parallel import multihost  # noqa: E402
from axtrack_tpu_torch.train import bigmovie as PB  # noqa: E402
from tests.test_torch_port_chunk_split import (  # noqa: E402
    Recorder, epoch_close, plan, sgd_state, staged_P, staged_dataset)


class Patch:
    """The part of pytest's monkeypatch that ``Recorder.install`` uses."""

    @staticmethod
    def setattr(obj, name, value):
        setattr(obj, name, value)


torch.set_num_threads(1)
multihost.INIT_TIMEOUT_S = 120.0         # room for a loaded test machine
assert multihost.init_distributed(coord, world, rank) == (world, rank)
mesh = multihost.make_global_mesh(n_model=1,
                                  devices=[torch.device('cpu')] * 2)
assert mesh.shape == {'data': 2 * world, 'model': 1}, mesh.shape

P = staged_P(fx)
staged = staged_dataset(P)
chunks, K = plan(staged, P, 1)
rec = Recorder()
rec.install(Patch)
states = sgd_state(P, mesh), sgd_state(P)
got = PB.run_epoch_chunked(states[0], staged, 'train', P, plan=(chunks, K))
built = rec.built()
tiles_equal = rec.tiles_equal_one_device(staged)
want = PB.run_epoch_chunked(states[1], staged, 'train', P, plan=(chunks, K))
try:
    epoch_close((got, states[0]), (want, states[1]))
    close = True
except AssertionError as e:
    print(e, flush=True)
    close = False
print('CHUNK_OK ' + json.dumps({
    'rank': rank, 'chunks': [(ch['lo'], ch['hi']) for ch in chunks],
    'built': built, 'tiles_equal': tiles_equal,
    'losses': [float(x) for x in got['total_summed_loss']],
    'epoch_close': close}), flush=True)
torch.distributed.destroy_process_group()
