"""Port parity for ``ops/geodesic.py: geodesic_pairwise``, the all-pairs
geodesic distance between two point sets on a mask.

Each case runs the same seeded points through the JAX package's
``geodesic_pairwise`` (its lax route, as on any CPU) and the port's on
``device='cpu'`` (the plain version). The distances are integer node
counts or the cap, so the two must be exactly equal. The mask families are
those of ``tests/test_geodesic.py``; where that file holds the JAX function
to the C++ A* oracle (``native.astar_pairwise``), the port is held to it
too. Two cases of the port's own: a mask smaller than the window (the
window clamps to the mask) and sources on the border of a mask larger
than the window (their windows clip against the edges).
"""
import numpy as np
import pytest
import torch

from axtrack_tpu.ops.geodesic import geodesic_pairwise as jax_pairwise
from axtrack_tpu_torch import native
from axtrack_tpu_torch.ops.geodesic import geodesic_pairwise

torch.set_num_threads(1)


def oracle_pairwise(mask, srcs, tgts, max_dist):
    wts = np.where(mask, 1.0, 2.0 ** 16).astype(np.float32)
    d = native.astar_pairwise(wts, srcs, tgts, max_dist).astype(np.float32)
    d[d < 0] = max_dist
    return d


def random_points(mask, n, rng):
    ys, xs = np.where(mask)
    idx = rng.choice(len(ys), n, replace=False)
    return np.stack([ys[idx], xs[idx]], -1).astype(np.int32)


def open_grid(rng):
    mask = np.ones((64, 64), bool)
    return (mask, random_points(mask, 5, rng), random_points(mask, 7, rng),
            dict(max_dist=500, window=64, max_sweeps=4))


def two_channels(rng):
    mask = np.zeros((96, 128), bool)
    mask[10:25, :] = True
    mask[70:85, :] = True
    mask[10:85, 60:66] = True
    return (mask, random_points(mask, 8, rng), random_points(mask, 8, rng),
            dict(max_dist=500, window=128, max_sweeps=8))


def serpentine(rng):
    mask = np.zeros((64, 64), bool)
    for i, y in enumerate(range(2, 62, 8)):
        mask[y:y + 4, 2:62] = True
        if y + 8 < 62:
            if i % 2 == 0:
                mask[y:y + 12, 58:62] = True
            else:
                mask[y:y + 12, 2:6] = True
    return (mask, np.array([[4, 4]], np.int32), random_points(mask, 10, rng),
            dict(max_dist=500, window=64, max_sweeps=16))


def unreachable_and_cap(rng):
    mask = np.ones((64, 64), bool)
    mask[:, 30:34] = False
    return (mask, np.array([[32, 5]], np.int32),
            np.array([[32, 60], [32, 6]], np.int32),
            dict(max_dist=500, window=64))


def off_mask_source(rng):
    mask = np.ones((32, 32), bool)
    mask[10, 10] = False
    return (mask, np.array([[10, 10]], np.int32),
            np.array([[10, 12]], np.int32), dict(max_dist=500, window=32))


def off_mask_target(rng):
    mask = np.ones((32, 32), bool)
    mask[20, 20] = False
    return (mask, np.array([[5, 5]], np.int32),
            np.array([[20, 20]], np.int32), dict(max_dist=500, window=32))


def window_smaller_than_mask(rng):
    mask = np.ones((256, 512), bool)
    mask[100:140, :] = False
    mask[100:140, 250:260] = True
    return (mask, np.array([[50, 250], [200, 250]], np.int32),
            np.array([[50, 260], [200, 260], [50, 251]], np.int32),
            dict(max_dist=200, window=256, max_sweeps=8))


def mask_smaller_than_window(rng):
    """The default window (1024) clamps to the mask, 40 x 50 -> 56."""
    mask = rng.random((40, 50)) > 0.3
    mask[20, :] = True
    mask[:, 25] = True
    return (mask, random_points(mask, 6, rng), random_points(mask, 9, rng),
            dict(max_dist=500, max_sweeps=8))


def sources_at_the_border(rng):
    """A 64 x 96 mask, a 32-px window: every corner and edge source's
    window is clipped into the mask."""
    mask = np.ones((64, 96), bool)
    mask[30:34, 10:90] = False
    srcs = np.array([[0, 0], [63, 95], [0, 95], [63, 0], [31, 0], [0, 48],
                     [63, 48], [32, 95]], np.int32)
    return (mask, srcs, random_points(mask, 12, rng),
            dict(max_dist=15, window=32, max_sweeps=8))


# (case, whether tests/test_geodesic.py or this file holds it to A*)
CASES = [(open_grid, False), (two_channels, True), (serpentine, True),
         (unreachable_and_cap, False), (off_mask_source, True),
         (off_mask_target, False), (window_smaller_than_mask, True),
         (mask_smaller_than_window, True), (sources_at_the_border, True)]


@pytest.mark.parametrize('case,oracle', CASES,
                         ids=[c.__name__ for c, _ in CASES])
def test_geodesic_pairwise_equals_jax(case, oracle):
    mask, srcs, tgts, kw = case(np.random.default_rng(0))
    want = np.asarray(jax_pairwise(mask, srcs, tgts, **kw))
    got = geodesic_pairwise(mask, srcs, tgts, device='cpu', **kw)
    assert got.device.type == 'cpu' and got.dtype == torch.float32
    assert got.shape == (len(srcs), len(tgts))
    np.testing.assert_array_equal(got.numpy(), want)
    if oracle:
        np.testing.assert_array_equal(
            got.numpy(), oracle_pairwise(mask, srcs, tgts, kw['max_dist']))
    if case is open_grid:
        l1 = np.abs(srcs[:, None] - tgts[None]).sum(-1) + 1
        np.testing.assert_array_equal(got.numpy(), np.minimum(l1, 500))
    if case is unreachable_and_cap:
        assert got[0].tolist() == [500, 2]


def test_geodesic_pairwise_takes_tensors():
    """Tensors in place of numpy arrays give the same distances."""
    mask, srcs, tgts, kw = two_channels(np.random.default_rng(3))
    want = geodesic_pairwise(mask, srcs, tgts, device='cpu', **kw)
    got = geodesic_pairwise(torch.from_numpy(mask), torch.from_numpy(srcs),
                            torch.from_numpy(tgts).long(), device='cpu', **kw)
    assert torch.equal(got, want)
