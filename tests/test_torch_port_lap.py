"""Port parity: the auction LAP and the online tracker
(``axtrack_tpu_torch/track/lap_device.py``) against the JAX package's, on
the CPU.

Assignments and trajectories must be equal, not close: both run the same
f32 arithmetic, and ties go to the first maximum on both sides. The
tracker's costs take a log, where torch and XLA may differ by an ulp; the
seeded movies have integer distances, so equal costs stay equal on both
sides and no decision sits within an ulp of a tie.

The port reads the loop condition once per chunk of rounds (1, 2, 4, ...
up to ``CHECK_EVERY``); caps of 1, 7 and 32 must give the JAX package's
assignments, also where the iteration cap ends the loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axtrack_tpu.track import lap_device as J
from axtrack_tpu_torch.track import lap_device as L

torch.set_num_threads(1)
BIG = L.BIG


def _jax_lap(cost, rv, cv, **kw):
    return np.asarray(J.auction_lap(jnp.asarray(cost, jnp.float32),
                                    jnp.asarray(rv), jnp.asarray(cv), **kw))


def _port_lap(cost, rv, cv, **kw):
    return L.auction_lap(torch.from_numpy(np.asarray(cost, np.float32)),
                         torch.from_numpy(rv), torch.from_numpy(cv),
                         **kw).numpy()


def _jax_fb(cost, pv, ov, fb, **kw):
    return np.asarray(J.auction_lap_fallback(
        jnp.asarray(cost, jnp.float32), jnp.asarray(pv), jnp.asarray(ov),
        jnp.asarray(fb, jnp.float32), **kw))


def _port_fb(cost, pv, ov, fb, **kw):
    return L.auction_lap_fallback(
        torch.from_numpy(np.asarray(cost, np.float32)), torch.from_numpy(pv),
        torch.from_numpy(ov), torch.from_numpy(np.asarray(fb, np.float32)),
        **kw).numpy()


def _lap_cases(seed):
    """(name, cost, row_valid, col_valid): square, rectangular, forbidden,
    padded, all-forbidden rows and tied costs."""
    rng = np.random.default_rng(seed)
    sq = rng.random((8, 8)).astype(np.float32)
    rect = rng.random((5, 9)).astype(np.float32)
    tall = rng.random((9, 5)).astype(np.float32)
    forb = rng.random((8, 8)).astype(np.float32)
    forb[rng.random((8, 8)) < 0.4] = BIG
    forb[0, :] = BIG                                  # all-forbidden row
    pad = rng.random((8, 8)).astype(np.float32)
    pad_rv = np.array([True] * 5 + [False] * 3)
    pad_cv = np.array([True] * 6 + [False] * 2)
    ties = rng.integers(0, 3, (8, 8)).astype(np.float32)
    one = np.full((8, 8), BIG, np.float32)
    one[1, 1] = 1.0
    t8 = np.ones(8, bool)
    return [('square', sq, t8, t8),
            ('rect', rect, np.ones(5, bool), np.ones(9, bool)),
            ('tall', tall, np.ones(9, bool), np.ones(5, bool)),
            ('forbidden', forb, t8, t8),
            ('padded', pad, pad_rv, pad_cv),
            ('ties', ties, t8, t8),
            ('one_feasible', one, t8, t8)]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_auction_lap_equals_jax(seed):
    for name, cost, rv, cv in _lap_cases(seed):
        for kw in ({}, {'eps': 1e-4}, {'scale': False}):
            if name == 'tall':
                # more feasible rows than columns: a price war to the cap,
                # which the test cuts to keep the host loop short
                kw = dict(kw, n_iters=150)
            want = _jax_lap(cost, rv, cv, **kw)
            got = _port_lap(cost, rv, cv, **kw)
            np.testing.assert_array_equal(got, want, err_msg=f'{name} {kw}')
    # the one-feasible case ends with the rest unassigned, not spinning
    got = _port_lap(*_lap_cases(seed)[-1][1:])
    assert got[1] == 1 and (np.delete(got, 1) == -1).all()


def _fallback_cases(seed):
    """The JAX package's asymmetric cases (tests/test_lap_device.py) and
    seeded ones."""
    cases = []
    cost = np.full((8, 8), BIG, np.float32)
    cost[0, 0], cost[1, 0] = 5.0, 1.0
    pv = np.zeros(8, bool)
    pv[:2] = True
    ov = np.zeros(8, bool)
    ov[0] = True
    cases.append((cost, pv, ov, np.full(8, 10.0, np.float32)))
    cost = np.full((8, 8), BIG, np.float32)
    cost[0, 0], cost[1, 0], cost[2, 0] = 3.0, 0.5, 2.0
    pv = np.zeros(8, bool)
    pv[:3] = True
    cases.append((cost, pv, ov.copy(), np.full(8, 10.0, np.float32)))
    cost = np.full((8, 8), BIG, np.float32)
    cost[0, 0] = 5.0
    pv = np.zeros(8, bool)
    pv[0] = True
    cases.append((cost, pv, ov.copy(), np.full(8, 2.0, np.float32)))
    rng = np.random.default_rng(seed)
    cases.append((rng.random((8, 8)).astype(np.float32), np.ones(8, bool),
                  np.ones(8, bool), np.full(8, 100.0, np.float32)))
    cost = rng.random((8, 16)).astype(np.float32) * 4
    cost[rng.random((8, 16)) < 0.5] = BIG
    pv = rng.random(8) < 0.8
    cases.append((cost, pv, rng.random(16) < 0.7,
                  rng.uniform(1, 3, 8).astype(np.float32)))
    return cases


@pytest.mark.parametrize('seed', [0, 1])
def test_auction_fallback_equals_jax(seed):
    cases = _fallback_cases(seed)
    for i, (cost, pv, ov, fb) in enumerate(cases):
        for kw in ({}, {'eps': 1e-4}):
            np.testing.assert_array_equal(_port_fb(cost, pv, ov, fb, **kw),
                                          _jax_fb(cost, pv, ov, fb, **kw),
                                          err_msg=f'case {i} {kw}')
    a, b, c = (_port_fb(*cases[k]) for k in range(3))
    assert a[1] == 0 and a[0] == -1
    assert b[1] == 0 and b[0] == -1 and b[2] == -1
    assert c[0] == -1


@pytest.mark.parametrize('check_every', [1, 7, 32])
def test_chunked_check_keeps_assignments_and_caps(check_every, monkeypatch):
    """Chunked convergence checks against the JAX package's while loop,
    with the default cap and with caps that end the loop early."""
    monkeypatch.setattr(L, 'CHECK_EVERY', check_every)
    rng = np.random.default_rng(5)
    cost = rng.random((16, 16)).astype(np.float32)
    t16 = np.ones(16, bool)
    for n_iters in (3, 13, 40, 150, 4000):
        for scale in (True, False):
            want = _jax_lap(cost, t16, t16, n_iters=n_iters, scale=scale)
            got = _port_lap(cost, t16, t16, n_iters=n_iters, scale=scale)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f'{n_iters} {scale}')
        if n_iters > 150:
            continue
        # the two-bidders-one-object price war runs to the cap
        cost2 = np.full((8, 8), BIG, np.float32)
        cost2[0, 0], cost2[1, 0] = 1.0, 1.0
        np.testing.assert_array_equal(
            _port_lap(cost2, np.ones(8, bool), np.ones(8, bool),
                      n_iters=n_iters),
            _jax_lap(cost2, np.ones(8, bool), np.ones(8, bool),
                     n_iters=n_iters))
    L.reset_stats()
    _port_lap(cost, t16, t16, n_iters=40, scale=False)
    rounds, syncs = L.read_stats()
    # chunks of 1, 2, 4, ... rounds, at most check_every, one sync each
    chunks, left = [], 40
    while left > 0:
        chunks.append(min(2 ** len(chunks), check_every, left))
        left -= chunks[-1]
    assert 0 < rounds <= 40
    assert 1 <= syncs <= len(chunks) and sum(chunks[:syncs]) >= rounds


PARAMS = dict(MCF_EDGE_COST_THR=0.7, MCF_ENTRY_EXIT_COST=2,
              MCF_MISS_RATE=0.6, MCF_MAX_NUM_MISSES=1, MCF_MAX_CONF_COST=4.6,
              MCF_CONF_CAPPING_METHOD='scale_to_max')


def _movie(seed, T=8, max_n=7, max_misses=1):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_n, T)
    frames = []
    for t in range(T):
        n = int(counts[t])
        frames.append({
            'conf': (0.6 + 0.4 * rng.random(n)).astype(np.float32),
            'x': rng.integers(0, 400, n).astype(np.int32),
            'y': rng.integers(0, 400, n).astype(np.int32)})
    dists = {}
    for t in range(1, T):
        for g in range(1, max_misses + 2):
            s = t - g
            if s < 0:
                continue
            D = rng.integers(5, 1000, (int(counts[s]), int(counts[t]))
                             ).astype(np.float32)
            D[D > 400] = 500.0          # unreachable beyond the cap
            dists[(t, g)] = D
    return frames, dists


@pytest.mark.parametrize('seed,max_misses', [(0, 1), (1, 1), (2, 1),
                                             (3, 2), (4, 3)])
def test_online_tracker_equals_jax(seed, max_misses):
    frames, dists = _movie(seed, max_misses=max_misses)
    P = dict(PARAMS, MCF_MAX_NUM_MISSES=max_misses)
    want = J.OnlineTracker(P).track(frames, dists)
    port = L.OnlineTracker(P, 'cpu')
    got = port.track(frames, dists)
    assert got == want
    assert port.track_host(frames, dists) == got
    assert any(len(tr) > 1 for tr in got)


def test_online_tracker_edge_cases():
    port = L.OnlineTracker(PARAMS, 'cpu')
    assert port.track([], {}) == []
    f = lambda *p: {'conf': np.full(len(p), 0.95, np.float32),  # noqa: E731
                    'x': np.array([q[0] for q in p], np.int32),
                    'y': np.array([q[1] for q in p], np.int32)}
    frames = [f((10, 10)), f(), f((30, 10))]
    dists = {(1, 1): np.zeros((1, 0), np.float32),
             (2, 1): np.zeros((0, 1), np.float32),
             (2, 2): np.array([[22.]], np.float32)}
    got = port.track(frames, dists)
    assert got == J.OnlineTracker(PARAMS).track(frames, dists)
    assert [tr for tr in got if [t for t, _ in tr] == [0, 2]]
