"""The output check at a size the CPU holds: the control (the reference
at TF32 in the program's place) and planted faults read above the
limits, and a run whose timed path is broken underneath comes out not
correct, once for each fault the cell can have."""
import numpy as np
import pytest
import torch

from _small import MOVIE, TRAIN, run
from portbench.lib.check import LIMITS


def test_inference_control_and_planted_faults_read_above_the_limits():
    out = run('deployed.movie20', MOVIE, control=True)
    assert out['correct']
    notes = out['notes']
    assert notes['control_det_gap'] > LIMITS['det_gap']
    assert notes['fault_moved_det_gap'] > LIMITS['det_gap']
    assert notes['fault_half_det_gap'] > LIMITS['det_gap']
    assert notes['fault_dist_gap'] > LIMITS['dist_gap']
    assert notes['fault_split_id_gap'] > LIMITS['id_gap']


def test_training_control_and_half_batch_read_above_the_limits():
    out = run('deployed.train16', TRAIN, control=True)
    assert out['correct']
    for reading in ('control', 'half_batch'):
        nums = out['notes'][reading][0]
        assert any(nums[k] > LIMITS[k] for k in nums), (reading, nums)


def _moved(mp):
    from axtrack_tpu_torch import detections as AD
    orig = AD.decode_tiled

    def fault(*a, **k):
        dec = orig(*a, **k)
        dec['x'][..., 0] += 3                # the most confident each frame
        return dec
    mp.setattr(AD, 'decode_tiled', fault)


def _half_tiles(mp):
    from axtrack_tpu_torch.models.yolo import YOLOAxTrack
    orig = YOLOAxTrack.forward

    def fault(self, x):
        g = orig(self, x[:len(x) // 2])
        return torch.cat([g, g.new_zeros((len(x) - len(g), *g.shape[1:]))])
    mp.setattr(YOLOAxTrack, 'forward', fault)


def _distance(mp):
    from axtrack_tpu_torch import detections as AD
    orig = AD.lookback_distances

    def fault(*a, **k):
        dists, flushes, sweeps = orig(*a, **k)
        for v in dists.values():
            near = np.argwhere(v < 500)
            if len(near):
                v[tuple(near[0])] += 1
                break
        return dists, flushes, sweeps
    mp.setattr(AD, 'lookback_distances', fault)


def _identity(mp):
    from axtrack_tpu_torch.track import tracker
    orig = tracker.assign_identities

    def fault(*a, **k):
        res = orig(*a, **k)
        trajs = sorted(res.trajectories, key=len)
        long_ = trajs.pop()
        half = len(long_) // 2
        return tracker.TrackGraphResult(
            trajs + [long_[:half], long_[half:]], res.flow, res.total_cost)
    mp.setattr(tracker, 'assign_identities', fault)


def _unchanged(mp):
    from axtrack_tpu_torch.train import engine

    class Frozen(torch.optim.Adam):
        def step(self, closure=None):
            return None
    mp.setattr(engine, 'make_optimizer', lambda model, P, epoch=0: Frozen(
        model.parameters(), lr=engine.epoch_lr(P, epoch),
        weight_decay=P['WEIGHT_DECAY']))


def _half_batch(mp):
    from axtrack_tpu_torch.train import engine
    orig = engine._loss

    def fault(state, X, target):
        n = len(X) // 2
        return orig(state, X[:n], target[:n])
    mp.setattr(engine, '_loss', fault)


@pytest.mark.parametrize('workload, mix, plant, number', [
    ('deployed.movie20', MOVIE, _moved, 'det_gap'),
    ('deployed.movie20', MOVIE, _half_tiles, 'det_gap'),
    ('deployed.movie20', MOVIE, _distance, 'dist_gap'),
    ('deployed.movie20', MOVIE, _identity, 'id_gap'),
    ('deployed.train16', TRAIN, _unchanged, 'change_gap'),
    ('deployed.train16', TRAIN, _half_batch, 'loss_gap'),
], ids=['answer-altered', 'half-the-tiles', 'distance-altered',
        'identity-altered', 'state-unchanged', 'half-the-batch'])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, mix,
                                            plant, number):
    plant(monkeypatch)
    out = run(workload, mix)
    assert not out['correct']
    assert out['checks'][number]['value'] > out['checks'][number]['limit']
