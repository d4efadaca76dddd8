"""Training across processes: ``torch.distributed`` set-up and the global
mesh.

PyTorch counterpart of ``axtrack_tpu/parallel/multihost.py``. One process
drives the cards of its host as a single controller (``parallel/mesh.py``);
across hosts, one process each, the data rows of the mesh span the
processes and the 'model' axis stays within one. The mesh step then sums
the BatchNorm statistics across processes by a differentiable all-reduce,
every process calls ``backward()`` on its own share of the loss, and the
gradients are all-reduced after it (``mesh.mesh_loss``,
``mesh.reduce_grads``): a backward on the all-reduced loss would scale the
gradients by the number of processes.

Nothing on the card's machine tells a program of a cluster: the caller
gives the coordinator's address, the world size and the rank, or launches
with ``torchrun``, whose environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) the no-argument form reads. Collectives run over
gloo on the CPU and over NCCL between cards.
"""
import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

# seconds a rendezvous (and a collective) may take before it raises
INIT_TIMEOUT_S = 60.0


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join the process group (idempotent); returns (world size, rank).

    Explicit values rendezvous at ``tcp://coordinator_address`` ('host:port'
    of rank 0) as rank ``process_id`` of ``num_processes``, and a failure
    raises within ``INIT_TIMEOUT_S`` seconds: a wrong address or world
    size must not turn a job of many processes into independent runs. With no
    arguments, ``torchrun``'s environment is used when it names more than
    one process; without it the result is (1, 0)."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    explicit = not (coordinator_address is None and num_processes is None)
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError('an explicit rendezvous needs the coordinator '
                             'address, the number of processes and this '
                             "process's rank")
        init = dict(init_method=f'tcp://{coordinator_address}',
                    world_size=int(num_processes), rank=int(process_id))
    elif int(os.environ.get('WORLD_SIZE', '1')) > 1:
        init = dict(init_method='env://')
    else:
        return 1, 0
    backend = ('cpu:gloo,cuda:nccl' if torch.cuda.is_available()
               else 'gloo')
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=INIT_TIMEOUT_S), **init)
    return dist.get_world_size(), dist.get_rank()


def make_global_mesh(n_model=None, devices=None):
    """A ('data', 'model') mesh over every process: this process's
    ``devices`` (default every CUDA device of its host) form its own data
    rows with ``n_model`` of them a row (``make_mesh``'s rule), and the
    'data' axis runs on through the rows of the other processes, so
    tensor-parallel sums stay within a host and only the data-parallel
    reductions cross processes. Call ``init_distributed`` first; every
    process must hold the same grid shape."""
    local = make_mesh(n_model=n_model, devices=devices)
    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    return Mesh(local.devices, processes=world, process_index=rank)
