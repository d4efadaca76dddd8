"""Port parity: YOLO decode and distance NMS, exact.

Random grids with deliberately tied confidences (rounded to 1/8) check the
tie order of the ranking (JAX's top_k keeps ties in index order; the port
sorts stably), and max_dets below the number of candidates checks the
saturation of the slot count. Alive masks, coordinates, confidences and
validity must be equal, not close.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from axtrack_tpu.ops.decode import (decode_tiled as jax_decode,
                                    distance_nms as jax_nms)
from axtrack_tpu_torch.ops.decode import decode_tiled, distance_nms

torch.set_num_threads(1)


def _grids(seed, K=7, ties=True):
    rng = np.random.default_rng(seed)
    g = rng.random((K, 12, 12, 4)).astype(np.float32)
    if ties:
        g[..., 0] = np.round(g[..., 0] * 8) / 8
    g[..., 3] = rng.integers(0, 50, g.shape[:-1])
    tyx = np.stack([rng.integers(0, 3, K), rng.integers(0, 4, K)],
                   -1).astype(np.int32)
    return g, tyx


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('max_dets', [40, 1024])
def test_decode_and_nms_equal_jax(seed, max_dets):
    g, tyx = _grids(seed)
    want = jax_decode(jnp.asarray(g), jnp.asarray(tyx), 0.55, 256,
                      max_dets=max_dets)
    got = decode_tiled(torch.from_numpy(g), torch.from_numpy(tyx), 0.55, 256,
                       max_dets=max_dets)
    for k in ('conf', 'x', 'y', 'ids', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # saturation: more candidates than slots -> every slot is valid
    n_cand = int((g[..., 0] >= 0.55).sum())
    assert int(got['valid'].sum()) == min(n_cand, max_dets)
    for radius in (23, 3.5, 40):
        alive_j = np.asarray(jax_nms(want['conf'], want['x'], want['y'],
                                     want['valid'], radius))
        alive_p = distance_nms(got['conf'], got['x'], got['y'],
                               got['valid'], radius).numpy()
        np.testing.assert_array_equal(alive_p, alive_j)


def test_batched_frames_equal_per_frame_jax():
    """The port decodes and suppresses all frames in one batched call;
    every frame must equal JAX's per-frame result."""
    frames = [_grids(10 + i, ties=False) for i in range(3)]
    tyx = frames[0][1]
    G = np.stack([f[0][..., :3] for f in frames])
    got = decode_tiled(torch.from_numpy(G), torch.from_numpy(tyx), 0.55,
                       128, max_dets=64)
    alive = distance_nms(got['conf'], got['x'], got['y'], got['valid'], 23)
    for i in range(3):
        want = jax_decode(jnp.asarray(G[i]), jnp.asarray(tyx), 0.55, 128,
                          max_dets=64)
        alive_j = jax_nms(want['conf'], want['x'], want['y'], want['valid'],
                          23)
        for k in ('conf', 'x', 'y', 'valid'):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]))
        np.testing.assert_array_equal(alive[i].numpy(), np.asarray(alive_j))


def test_nms_chain_and_exact_radius():
    """A suppression chain a > b > c (a kills b, so c survives) and
    detections at exactly the radius (not suppressed: dist < r is strict)."""
    conf = np.array([.9, .8, .7, .6, .5], np.float32)
    x = np.array([0, 10, 20, 100, 123], np.float32)
    y = np.zeros(5, np.float32)
    valid = np.ones(5, bool)
    want = np.asarray(jax.jit(jax_nms)(conf, x, y, valid, 15.0))
    got = distance_nms(*map(torch.from_numpy, (conf, x, y, valid)),
                       15).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [True, False, True, True, True])
    got23 = distance_nms(*map(torch.from_numpy, (conf, x, y, valid)),
                         23).numpy()
    assert got23[4]                      # |123 - 100| == 23 is not < 23
