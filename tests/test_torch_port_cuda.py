"""The port on the GPU: kernel K1 against its plain version.

These tests need an NVIDIA GPU with nvcc (sm_90a) and are marked ``cuda``;
on a machine without one they skip. Run them on the card with
``python -m pytest -q --noconftest -m cuda tests/test_torch_port_cuda.py``.
K1 reads the bit-packed mask and returns the maps and one certificate flag
a window; both must equal the plain version's exactly (the maps are
integer step counts).
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


def _case(W, seed, maze):
    rng = np.random.default_rng(seed)
    H = W + 40
    if maze:
        mask = np.zeros((H, H + 24), bool)
        for k, y in enumerate(range(4, H - 40, 32)):
            mask[y:y + 6, 4:H + 20] = True
            x0 = H + 14 if k % 2 == 0 else 4
            mask[y:y + 38, x0:x0 + 6] = True
    else:
        mask = rng.random((H, H + 24)) > 0.35
    ys, xs = np.nonzero(mask)
    pick = rng.choice(len(ys), 6, replace=False)
    srcs = np.stack([ys[pick], xs[pick]], -1)
    srcs[0] = (-2, 3)                      # outside its window: seeds nothing
    return mask, srcs


@pytest.mark.parametrize('W', [128, 512, 1024])
@pytest.mark.parametrize('maze', [False, True])
def test_k1_bit_equal_plain(dev, W, maze):
    mask, srcs = _case(W, W, maze)
    m = torch.from_numpy(mask).to(dev)
    bits, row_words = GC.pack_mask(m)
    origins, local = G.window_origins(torch.from_numpy(srcs).to(dev), W,
                                      *mask.shape)
    before = GC.chamfer_kernel.launches
    for sweeps in (1, 2):
        k, kok = GC.chamfer_windows(bits, row_words, origins, local, W,
                                    sweeps)
        p, pok = GC.chamfer_windows_plain(bits, row_words, origins, local, W,
                                          sweeps)
        assert torch.equal(k, p) and torch.equal(kok, pok)
        kc, kcok = GC.chamfer_windows(bits, row_words, origins, local, W,
                                      sweeps, init=k)
        pc, pcok = GC.chamfer_windows_plain(bits, row_words, origins, local,
                                            W, sweeps, init=k)
        assert torch.equal(kc, pc) and torch.equal(kcok, pcok)
    assert GC.chamfer_kernel.launches == before + 4
    dk, _ = GC.batched_windows_converged(m, torch.from_numpy(srcs).to(dev),
                                         W, max_sweeps=1)
    dp, _ = GC.chamfer_windows_plain(bits, row_words, origins, local, W,
                                     4 * W)
    assert torch.equal(dk, dp)


def test_k1_rejects_bad_inputs(dev):
    bits, row_words = GC.pack_mask(torch.ones(80, 80, dtype=torch.bool,
                                              device=dev))
    o = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(bits.float(), row_words, o, o, 64, 1)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(bits, row_words + 1, o, o, 64, 1)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(bits, row_words, o.long(), o, 64, 1)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(bits, row_words, o, o, 60, 1)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(bits, row_words, o, o, 64, 0)
    with pytest.raises(ValueError):
        GC.chamfer_kernel(bits, row_words, o, o, 64, 1,
                          init=torch.zeros(2, 64, 60, device=dev))
