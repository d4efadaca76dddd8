"""The port on the GPU: kernel K1 against its plain version, and the
inference path on cuda against the same path on the CPU.

These tests need an NVIDIA GPU with nvcc (sm_90a) and are marked ``cuda``;
on a machine without one they skip. Run them on the card with
``python -m pytest -m cuda tests/test_torch_port_cuda.py``.
"""
import numpy as np
import pytest
import torch

from axtrack_tpu_torch.ops import geodesic as G
from axtrack_tpu_torch.ops import geodesic_cuda as GC

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (K1 is CUDA C++ with no CPU mode)')
    return torch.device('cuda')


def _case(W, seed, blob):
    rng = np.random.default_rng(seed)
    H = W + 40
    if blob:
        mask = rng.random((H, H + 24)) > 0.35
    else:
        mask = np.zeros((H, H + 24), bool)
        for y in range(10, H - 20, 40):
            mask[y:y + 12] = True
        mask[:, 5:25] = True
    ys, xs = np.nonzero(mask)
    pick = rng.choice(len(ys), 6, replace=False)
    srcs = np.stack([ys[pick], xs[pick]], -1)
    srcs[0] = (-2, 3)                      # outside its window: seeds nothing
    return mask, srcs


@pytest.mark.parametrize('W', [128, 512, 1024])
@pytest.mark.parametrize('blob', [False, True])
def test_k1_bit_equal_plain(dev, W, blob):
    mask, srcs = _case(W, W, blob)
    m = torch.from_numpy(mask).to(dev)
    origins, local = G.window_origins(torch.from_numpy(srcs).to(dev), W,
                                      *mask.shape)
    crops = G.crops_for(m, origins, local, W)
    before = GC.chamfer_kernel.launches
    for sweeps in (1, 2):
        k = GC.chamfer(crops, local, sweeps)
        assert torch.equal(k, G.chamfer_plain(crops, local, sweeps))
        kc = GC.chamfer(crops, local, sweeps, init=k)
        assert torch.equal(kc, G.chamfer_plain(crops, local, sweeps, init=k))
    assert GC.chamfer_kernel.launches == before + 4
    dk, _ = GC.batched_windows_converged(m, torch.from_numpy(srcs).to(dev),
                                         W, max_sweeps=1)
    assert torch.equal(dk, G.chamfer_plain(crops, local, 4 * W))


def test_k1_rejects_bad_inputs(dev):
    crops = torch.ones(2, 64, 64, dtype=torch.uint8, device=dev)
    local = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(crops.float(), local, 1)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(crops[:, :, :60], local, 1)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(crops, local.long(), 1)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(crops, local, 0)
