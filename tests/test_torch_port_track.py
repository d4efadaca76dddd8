"""Port parity: the min-cost-flow identity solve.

The port's tracker is a copy of the JAX package's host code over its own
build of native/mcf.cpp; on the same seeded detections and distances the
trajectories, the flow vector and the total cost must be equal.
"""
import numpy as np
import pytest
import torch

from axtrack_tpu.track import tracker as jax_tracker
from axtrack_tpu_torch.track import tracker

torch.set_num_threads(1)

MCF = {'MCF_EDGE_COST_THR': 0.7, 'MCF_ENTRY_EXIT_COST': 2,
       'MCF_MISS_RATE': 0.6, 'MCF_MAX_NUM_MISSES': 1, 'MCF_MIN_FLOW': 1,
       'MCF_MAX_FLOW': 60, 'MCF_MAX_CONF_COST': 4.6, 'MCF_VIS_SIM_WEIGHT': 0,
       'MCF_CONF_CAPPING_METHOD': 'scale_to_max'}


def _problem(seed, T=6, n=12):
    """Axons drifting right with jitter, plus clutter; distances are the
    L1 node counts capped at 500 (what the association stage delivers)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 400, (n, 2))
    dets = []
    for t in range(T):
        keep = rng.random(n) > 0.15
        pos = base[keep] + [0, 9 * t] + rng.normal(0, 2, (keep.sum(), 2))
        clutter = rng.uniform(0, 400, (rng.integers(0, 3), 2))
        pos = np.concatenate([pos, clutter])
        conf = np.concatenate([rng.uniform(0.7, 1.0, keep.sum()),
                               rng.uniform(0.55, 0.7, len(clutter))])
        dets.append({'conf': conf.astype(np.float32),
                     'x': pos[:, 1].astype(np.int32),
                     'y': pos[:, 0].astype(np.int32)})
    dists = {}
    for t in range(T):
        for gap in (1, 2):
            s = t - gap
            if s < 0:
                continue
            d = (np.abs(dets[s]['x'][:, None] - dets[t]['x'][None])
                 + np.abs(dets[s]['y'][:, None] - dets[t]['y'][None]) + 1)
            dists[(t, gap)] = np.minimum(d, 500).astype(np.float32)
    return dets, dists


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_assign_identities_equals_jax(seed):
    dets, dists = _problem(seed)
    want = jax_tracker.assign_identities(dets, dists, MCF)
    got = tracker.assign_identities(dets, dists, MCF)
    assert got.trajectories == want.trajectories
    np.testing.assert_array_equal(got.flow, want.flow)
    assert got.total_cost == want.total_cost
    assert len(got.trajectories) > 0


def test_infeasible_flow_returns_none():
    dets, dists = _problem(3, T=3, n=2)
    params = dict(MCF, MCF_MIN_FLOW=500, MCF_MAX_FLOW=600)
    assert jax_tracker.assign_identities(dets, dists, params) is None
    assert tracker.assign_identities(dets, dists, params) is None
