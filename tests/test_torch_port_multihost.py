"""The port's training across processes (``parallel/multihost.py``).

The single-process form: ``init_distributed()`` without a cluster is
(1, 0) and idempotent, and ``make_global_mesh`` is then the local mesh; an
explicit rendezvous that cannot complete raises within its timeout. Then
the counterpart of ``tests/test_multihost2.py``: two processes over gloo
on localhost (``tests/_torch_mh_worker.py``), each one data row of a 2 x 2
mesh, sum across processes and take one sharded train step of one batch.
Their losses must be identical, and equal a one-process step on the whole
batch at rtol 1e-5; their parameters after the step must be identical,
and all but 0.1% of them within 1e-6 of the one-process step's (the rule
of ``test_torch_port_train.py``'s Adam step: where a gradient is rounding
noise, Adam's first step follows its sign).
"""
import os
import socket
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from axtrack_tpu_torch.parallel import multihost
from axtrack_tpu_torch.parallel.multihost import (init_distributed,
                                                  make_global_mesh)

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_single_process_degenerate_form(monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    assert init_distributed() == (1, 0)
    assert init_distributed() == (1, 0)           # idempotent
    assert not dist.is_initialized()
    mesh = make_global_mesh(n_model=2,
                            devices=[torch.device('cpu')] * 8)
    assert mesh.shape == {'data': 4, 'model': 2}
    assert (mesh.processes, mesh.process_index) == (1, 0)


def test_explicit_rendezvous_that_fails_raises_within_its_timeout(
        monkeypatch):
    with pytest.raises(ValueError, match='rank'):
        init_distributed('127.0.0.1:1', 2)
    monkeypatch.setattr(multihost, 'INIT_TIMEOUT_S', 3.0)
    t0 = time.perf_counter()
    with pytest.raises(dist.DistError):     # nobody listens: rank 1 of 2
        init_distributed(f'127.0.0.1:{_free_port()}', 2, 1)
    assert time.perf_counter() - t0 < 60
    assert not dist.is_initialized()


def test_two_processes_train_one_sharded_step():
    coord = f'127.0.0.1:{_free_port()}'
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, '_torch_mh_worker.py'), coord,
         '2', str(rank)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
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
    ok = [dict(kv.split('=') for kv in line.split()[1:])
          for out in outs for line in out.splitlines()
          if line.startswith('MH_OK')]
    assert sorted(r['rank'] for r in ok) == ['0', '1'], outs
    assert ok[0]['loss'] == ok[1]['loss']
    assert ok[0]['params'] == ok[1]['params']
    loss, alone = float(ok[0]['loss']), float(ok[0]['alone'])
    assert abs(loss - alone) <= 1e-5 * abs(alone), (loss, alone)
    assert int(ok[0]['apart']) < 1e-3 * int(ok[0]['of']), ok[0]
