"""The port on the GPU: kernel K1 against its plain version, and the
training path's device code, the auction tracker and the mixed-precision
detector against the CPU.

These tests need an NVIDIA GPU with nvcc (sm_90a) and are marked ``cuda``;
on a machine without one they skip. Run them on the card with
``python -m pytest -q --noconftest -m cuda tests/test_torch_port_cuda.py``.
K1 reads the bit-packed mask and returns the maps and one certificate flag
a window; both must equal the plain version's exactly (the maps are
integer step counts). The YOLO targets (with colliding labels) and the
translate/flip transforms must equal the CPU's exactly; a train step's
loss agrees with the CPU's to rtol 1e-4 (cuDNN sums in another order).
"""
import numpy as np
import pytest
import torch

from axtrack_tpu_torch.data import augment as PA
from axtrack_tpu_torch.ops import geodesic as G
from axtrack_tpu_torch.ops import geodesic_cuda as GC
from axtrack_tpu_torch.ops import targets as PTG

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


def test_k1_out_of_range_origin_fails_the_certificate(dev, monkeypatch):
    """K1 flags a window whose origin leaves the bitmap with -1 and INF
    maps; the flush's certificate must then fail (ROADMAP F4)."""
    mask = torch.ones(200, 240, dtype=torch.bool, device=dev)
    bits, row_words = GC.pack_mask(mask)
    srcs = torch.tensor([[20, 20], [100, 100], [150, 200]], device=dev)
    origins, local = G.window_origins(srcs, 64, 200, 240)
    origins[1, 0] = 190                        # rows 190..253 of 200
    maps, ok = GC.chamfer_windows(bits, row_words, origins, local, 64, 64)
    torch.cuda.synchronize()
    assert ok.tolist() == [1, -1, 1]
    assert bool((maps[1] == G.INF).all())
    _, _, converged = GC.batched_windows_probed(mask, srcs, 64,
                                                max_sweeps=64)
    assert bool(converged)
    real = GC.window_origins

    def shifted(srcs_p, window, Hp, Wp):
        o, loc = real(srcs_p, window, Hp, Wp)
        o[1, 0] = Hp - window // 2
        return o, loc
    monkeypatch.setattr(GC, 'window_origins', shifted)
    dmaps, _, converged = GC.batched_windows_probed(mask, srcs, 64,
                                                    max_sweeps=64)
    assert not bool(converged)
    _, converged = GC._continue_windows(mask, srcs, dmaps, 64, 1)
    assert not bool(converged)


def test_targets_and_transforms_equal_cpu(dev):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 300, (400, 2)).astype(np.float32)  # collisions too
    ids = rng.integers(0, 40, 400).astype(np.int32)
    t = rng.integers(0, 5, 400).astype(np.int32)
    valid = rng.random(400) > 0.2
    cpu = PTG.labels_to_yolo_grid(a, ids, t, valid, 3, 3, 12, 12, 128, 5)
    gpu = PTG.labels_to_yolo_grid(a, ids, t, valid, 3, 3, 12, 12, 128, 5,
                                  device=dev)
    assert torch.equal(gpu.cpu(), cpu)
    X = torch.from_numpy(rng.random((3, 70, 90)).astype(np.float32))
    for kw in (dict(dy=12, dx=-30), dict(flip_y=True), dict(flip_x=True),
               dict(dy=-5, dx=7, flip_y=True, flip_x=True)):
        assert torch.equal(PA.transform_frames(X.to(dev), **kw).cpu(),
                           PA.transform_frames(X, **kw))


def test_train_step_gpu_equals_cpu(dev):
    from axtrack_tpu_torch.models.yolo import build_model, init_weights
    from axtrack_tpu_torch.params import get_default_parameters
    from axtrack_tpu_torch.train import engine as PE
    P = get_default_parameters()
    P.update(TILESIZE=128, ARCHITECTURE=[
        [(3, 8, 2, 1), (3, 16, 2, 1), 'M', (3, 16, 1, 1), 'M'],
        [('FC', 64), ('activation', 'sigmoid')]])
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.random((6, 5, 128, 128)).astype(np.float32))
    tgt = torch.zeros(6, 12, 12, 4)
    tgt[:, 3, 4] = torch.tensor([1.0, 0.3, 0.6, 0.0])
    losses = {}
    for d in ('cpu', dev):
        P['DEVICE'] = str(d)
        model = init_weights(build_model(P), torch.Generator().manual_seed(0))
        state = PE.TrainState(model.to(d), None, P)
        state.optimizer = PE.make_optimizer(state.model, P)
        with PE.exact_f32():
            losses[str(d)] = [float(PE.train_step(state, X.to(d), tgt.to(d))
                                    ['total_summed_loss']) for _ in range(3)]
    np.testing.assert_allclose(losses[str(dev)], losses['cpu'], rtol=1e-4)


def test_auction_and_online_tracker_gpu_equal_cpu(dev):
    """The auction (chunked convergence checks on the card) and the online
    tracker give the CPU's assignments and trajectories."""
    from axtrack_tpu_torch.track import lap_device as L
    rng = np.random.default_rng(4)
    cost = rng.random((16, 24)).astype(np.float32)
    cost[rng.random((16, 24)) < 0.3] = L.BIG
    rv = torch.from_numpy(rng.random(16) < 0.9)
    cv = torch.ones(24, dtype=torch.bool)
    for scale in (True, False):
        a = L.auction_lap(torch.from_numpy(cost), rv, cv, scale=scale)
        b = L.auction_lap(torch.from_numpy(cost).to(dev), rv.to(dev),
                          cv.to(dev), scale=scale)
        assert torch.equal(a, b.cpu())
    P = dict(MCF_EDGE_COST_THR=0.7, MCF_ENTRY_EXIT_COST=2, MCF_MISS_RATE=0.6,
             MCF_MAX_NUM_MISSES=1, MCF_MAX_CONF_COST=4.6,
             MCF_CONF_CAPPING_METHOD='scale_to_max')
    counts = rng.integers(0, 7, 10)
    frames = [{'conf': (0.6 + 0.4 * rng.random(n)).astype(np.float32),
               'x': rng.integers(0, 400, n).astype(np.int32),
               'y': rng.integers(0, 400, n).astype(np.int32)}
              for n in counts]
    dists = {}
    for t in range(1, 10):
        for g in (1, 2):
            if t - g >= 0:
                D = rng.integers(5, 1000, (counts[t - g], counts[t]))
                dists[(t, g)] = np.where(D > 400, 500, D).astype(np.float32)
    want = L.OnlineTracker(P, 'cpu').track(frames, dists)
    assert L.OnlineTracker(P, dev).track(frames, dists) == want
    assert L.OnlineTracker(P, dev).track_host(frames, dists) == want


def test_mixed_precision_detection_runs_on_the_card(dev):
    """'mixed' (bf16 convolutions, f32 head) on cuda: f32 grids, within
    chip_smoke's bound of the CPU's 'mixed' and of cuda's f32 and unequal
    to the latter; its conv features nearer the CPU's 'mixed' than a
    quarter of their distance from cuda's f32 (a mode computing in f32
    would be as far from the CPU's 'mixed' as f32 is)."""
    import os
    import sys
    from axtrack_tpu_torch.interface import PRECISIONS
    from axtrack_tpu_torch.models.yolo import build_model, init_weights
    from axtrack_tpu_torch.params import load_parameters
    from axtrack_tpu_torch.train.engine import exact_f32
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from chip_smoke import PRECISION_GRID_ATOL
    P = load_parameters(None, None,
                        from_directory=os.path.join(repo, 'deployed_model'))
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, 512, 512)).astype(np.float32))
    grids, feats = {}, {}
    for mode, d in (('mixed', 'cpu'), ('mixed', dev), ('f32', dev)):
        m = init_weights(build_model(P, *PRECISIONS[mode]),
                         torch.Generator().manual_seed(0)).eval().to(d)
        with torch.no_grad(), exact_f32():
            g = m(X.to(d))
            feats[(mode, str(d))] = m.ConvNet(X.to(d)).cpu()
        assert g.dtype == torch.float32 and g.shape == (2, 12, 12, 3)
        grids[(mode, str(d))] = g.cpu()
    gpu = grids[('mixed', 'cuda')]
    assert torch.isfinite(gpu).all()
    assert (gpu - grids[('mixed', 'cpu')]).abs().max() <= \
        PRECISION_GRID_ATOL['mixed']
    assert 0 < (gpu - grids[('f32', 'cuda')]).abs().max() <= \
        PRECISION_GRID_ATOL['mixed']
    f = feats[('mixed', 'cuda')]
    assert ((f - feats[('mixed', 'cpu')]).abs().mean()
            < (f - feats[('f32', 'cuda')]).abs().mean() / 4)
