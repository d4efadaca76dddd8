"""Worker process of the port's two-process test
(test_torch_port_multihost.py).

Run as: python _torch_mh_worker.py <coordinator host:port> <world> <rank>

Each process drives two CPU devices as one data row with a 'model' axis of
2 (``make_global_mesh``), so the global mesh is 2 x 2 with 'data' spanning
the processes. It checks the rendezvous, a cross-process sum, and one
sharded train step of the whole batch (each process taking its rows):
prints the step's loss, the loss of a one-process step on the whole
batch from the same weights, a checksum of the parameters after the step
and how many of them lie more than 1e-6 from the one-process step's
(Adam's first step moves a parameter by about lr * sign(g), so where g
is rounding noise its sign may differ).
"""
import os
import sys

coord, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed.nn.functional as dist_nn  # noqa: E402

from axtrack_tpu_torch.params import get_default_parameters  # noqa: E402
from axtrack_tpu_torch.parallel.mesh import (  # noqa: E402
    distribute_state, gathered_state_dict)
from axtrack_tpu_torch.parallel import multihost  # noqa: E402
from axtrack_tpu_torch.parallel.multihost import (  # noqa: E402
    init_distributed, make_global_mesh)
from axtrack_tpu_torch.train import engine  # noqa: E402

torch.set_num_threads(1)
multihost.INIT_TIMEOUT_S = 120.0         # room for a loaded test machine
n, i = init_distributed(coord, world, rank)
assert (n, i) == (world, rank), (n, i)
assert init_distributed() == (world, rank)          # idempotent

mesh = make_global_mesh(n_model=2, devices=[torch.device('cpu')] * 2)
assert mesh.shape == {'data': world, 'model': 2}, mesh.shape

# 1) a cross-process sum
local = torch.arange(8, dtype=torch.float32) + 100 * rank
total = float(dist_nn.all_reduce(local).sum())
want = sum(float(np.arange(8).sum() + 100 * 8 * r) for r in range(world))
assert total == want, (total, want)

# 2) one sharded train step: 'data' spans the processes, 'model' within
P = get_default_parameters()
P.update(BATCH_SIZE=8, TILESIZE=64, DEVICE='cpu', ARCHITECTURE=[
    [(3, 8, 2, 1), (3, 16, 2, 1), 'M', (3, 16, 1, 1), 'M'],
    [('FC', 64), ('activation', 'sigmoid')]])
rng = np.random.default_rng(0)                   # the same draw everywhere
X = torch.from_numpy(rng.random((8, 5, 64, 64), np.float32))
tgt = torch.zeros(8, P['SX'], P['SY'], 4)
hit = torch.from_numpy(rng.random((8, P['SX'], P['SY'])) < 0.05)
tgt[..., 0] = hit.float()
tgt[..., 1:3] = torch.from_numpy(
    rng.random((8, P['SX'], P['SY'], 2), np.float32)) * hit[..., None]

state = distribute_state(engine.setup_model(P), mesh)
loss = float(engine.train_step(state, X, tgt)['total_summed_loss'])
alone = engine.setup_model(P)
loss_alone = float(engine.train_step(alone, X, tgt)['total_summed_loss'])
got = gathered_state_dict(state.model)
checksum = sum(float(v.double().sum()) for v in got.values())
want = alone.model.state_dict()
apart = sum(int(((got[k] - want[k]).abs() > 1e-6).sum()) for k in want)
count = sum(v.numel() for v in want.values())
print(f'MH_OK rank={rank} loss={loss!r} alone={loss_alone!r} '
      f'params={checksum!r} apart={apart} of={count}', flush=True)
torch.distributed.destroy_process_group()
