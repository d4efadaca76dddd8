"""Port parity: the plain geodesic chamfer (the CUDA kernel's reference).

Bit-equality, not closeness: every distance is an integer step count or
INF = 1e9, so the port's plain version must equal JAX's lax version
(``geodesic._batched_windows``) exactly at fixed sweep counts 1, 2 and 4,
for the fresh variant and for the continuation variant (s sweeps, then
continue from those maps; Gauss-Seidel sweeps compose, so that equals
JAX's fresh run of s + s sweeps). Masks are the families of
tests/test_geodesic.py. Converged maps read at targets equal the C++ A*
oracle's node counts (steps + 1).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from axtrack_tpu import native as jax_native
from axtrack_tpu.ops import geodesic as JG
from axtrack_tpu_torch import native
from axtrack_tpu_torch.ops import geodesic as G
from axtrack_tpu_torch.ops import geodesic_cuda as GC

torch.set_num_threads(1)


def _serpentine():
    mask = np.zeros((64, 64), bool)
    for i, y in enumerate(range(2, 62, 8)):
        mask[y:y + 4, 2:62] = True
        if y + 8 < 62:
            if i % 2 == 0:
                mask[y:y + 12, 58:62] = True
            else:
                mask[y:y + 12, 2:6] = True
    return mask.T.copy(), np.array([[4, 4], [30, 30], [60, 10]], np.int32)


def _random_blob():
    rng = np.random.default_rng(1)
    mask = rng.random((80, 80)) > 0.35
    mask[40, :] = True
    return mask, np.array([[40, 3], [10, 70], [75, 40], [0, 0]], np.int32)


def _thin_band():
    mask = np.zeros((96, 128), bool)
    mask[30:38, :] = True
    mask[70:74, 20:100] = True
    mask[38:70, 60:64] = True
    return mask, np.array([[33, 10], [71, 90], [50, 61], [33, 120], [31, 64],
                           [72, 40], [33, 2]], np.int32)


def _pad_window():
    mask = np.zeros((64, 64), bool)
    mask[40:46, :] = True
    return mask, np.array([[42, 5], [43, 30], [41, 60], [0, 0]], np.int32)


MASKS = {'serpentine': (_serpentine, 64), 'random_blob': (_random_blob, 64),
         'thin_band': (_thin_band, 96), 'pad_window': (_pad_window, 64)}


@pytest.mark.parametrize('sweeps', [1, 2, 4])
@pytest.mark.parametrize('family', sorted(MASKS))
def test_plain_bit_equal_jax_fresh_and_continued(family, sweeps):
    make, window = MASKS[family]
    mask, srcs = make()
    want, want_o = JG._batched_windows(jnp.asarray(mask), jnp.asarray(srcs),
                                       window, sweeps)
    got, got_o = G._batched_windows(torch.from_numpy(mask),
                                    torch.from_numpy(srcs), window, sweeps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))

    # continuation: `sweeps` more sweeps from the maps above
    origins, local = G.window_origins(torch.from_numpy(srcs).long(), window,
                                      *mask.shape)
    crops = G.crops_for(torch.from_numpy(mask), origins, local, window)
    cont = G.chamfer_plain(crops, local, sweeps, init=got)
    want2, _ = JG._batched_windows(jnp.asarray(mask), jnp.asarray(srcs),
                                   window, 2 * sweeps)
    np.testing.assert_array_equal(cont.numpy(), np.asarray(want2))


def _oracle(mask, srcs, tgts, cap):
    wts = np.where(mask, 1.0, 2.0 ** 16).astype(np.float32)
    d = jax_native.astar_pairwise(wts, srcs, tgts, cap).astype(np.float32)
    d[d < 0] = cap
    return d


@pytest.mark.parametrize('family', sorted(MASKS))
def test_converged_equals_astar_oracle(family):
    mask, srcs = MASKS[family][0]()
    rng = np.random.default_rng(7)
    ys, xs = np.nonzero(mask)
    pick = rng.choice(len(ys), 12, replace=False)
    tgts = np.stack([ys[pick], xs[pick]], -1).astype(np.int32)
    # a window covering the whole frame, so every path fits in it
    window = G._round_up(max(mask.shape), 8)
    padded = np.zeros((window, window), bool)
    padded[:mask.shape[0], :mask.shape[1]] = mask
    dmaps, origins = G.batched_windows(torch.from_numpy(padded),
                                       torch.from_numpy(srcs), window, 1,
                                       converge=True)
    got = G.gather_targets(dmaps, origins, torch.from_numpy(tgts).long(),
                           500.0, window).numpy()
    np.testing.assert_array_equal(got, _oracle(mask, srcs, tgts, 500))


def test_certificate_and_continue_match_pallas_interpret():
    """The host route around the kernel (bucketed padding, probe
    certificate, continuation) equals the Pallas route run in interpret
    mode on the serpentine, where 2 sweeps under-converge."""
    from axtrack_tpu.ops import geodesic_pallas as GP
    mask, srcs = _serpentine()
    m_j, m_p = jnp.asarray(mask), torch.from_numpy(mask)
    d_j, o_j, ok_j = GP.batched_windows_probed(m_j, srcs, 64, max_sweeps=2,
                                               interpret=True)
    d_p, o_p, ok_p = GC.batched_windows_probed(m_p, torch.from_numpy(srcs),
                                               64, max_sweeps=2)
    assert bool(ok_p) == bool(ok_j) is False
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(o_p.numpy(), np.asarray(o_j))
    c_j, cok_j = GP._continue_windows_pallas(m_j, srcs, d_j, 64, 2,
                                             interpret=True)
    c_p, cok_p = GC._continue_windows(m_p, torch.from_numpy(srcs), d_p, 64, 2)
    assert bool(cok_p) == bool(cok_j)
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_j))


def test_host_helpers_equal_jax():
    from axtrack_tpu.ops import geodesic_pallas as GP
    for n, w in [(1, 64), (5, 512), (100, 512), (129, 512), (305, 512),
                 (1000, 512), (3, 1024), (700, 1024)]:
        assert GC.src_bucket(n, w) == GP.src_bucket(n, w), (n, w)
    mask = np.random.default_rng(3).random((100, 140)) > 0.5
    srcs = np.array([[0, 0], [50, 70], [99, 139], [10, 130]], np.int32)
    N, Np, o_j, l_j = GP._pad_srcs(jnp.asarray(mask), srcs, 64)
    N2, Np2, o_p, l_p = GC._pad_srcs(torch.from_numpy(mask),
                                     torch.from_numpy(srcs), 64)
    assert (N, Np) == (N2, Np2)
    np.testing.assert_array_equal(o_p.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(l_p.numpy(), np.asarray(l_j))
    c_j = GP._crops_for(jnp.asarray(mask), o_j, l_j, 64, Np)
    c_p = G.crops_for(torch.from_numpy(mask), o_p, l_p, 64)
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_j) > 0.5)
    d = np.asarray(JG._batched_windows(jnp.asarray(mask), srcs, 64, 1)[0])
    crops = np.asarray(c_j)[:N]
    assert bool(GC._locally_consistent(torch.from_numpy(d),
                                       torch.from_numpy(crops))) == bool(
        GP._locally_consistent(jnp.asarray(d), jnp.asarray(crops)))


def test_native_astar_copy_equals_jax_build():
    mask, srcs = _thin_band()
    wts = np.where(mask, 1.0, 2.0 ** 16).astype(np.float32)
    tgts = srcs[::-1].copy()
    np.testing.assert_array_equal(
        native.astar_pairwise(wts, srcs, tgts, 200),
        jax_native.astar_pairwise(wts, srcs, tgts, 200))


def test_cpu_tensors_never_reach_the_kernel():
    mask, srcs = _pad_window()
    before = GC.chamfer_kernel.launches
    GC.batched_windows_probed(torch.from_numpy(mask), torch.from_numpy(srcs),
                              64, 2)
    assert GC.chamfer_kernel.launches == before
    with pytest.raises(ValueError):
        GC.chamfer_kernel(torch.zeros(1, 8, 8, dtype=torch.uint8),
                          torch.zeros(1, 2, dtype=torch.int32), 1)


def test_source_outside_window_seeds_nothing():
    """A source at a negative coordinate (an untrained detector can emit
    one) or beyond the padded mask seeds nothing: all-INF map, as the
    Pallas kernel gives. JAX's lax route instead wraps a negative crop
    index to the far side of the window (ROADMAP F3)."""
    from axtrack_tpu.ops import geodesic_pallas as GP
    mask = np.ones((64, 96), bool)
    srcs = np.array([[-3, 10], [10, 100], [70, 10], [5, 5]], np.int32)
    want, _ = GP.batched_windows_pallas(jnp.asarray(mask), srcs, 64,
                                        max_sweeps=2, interpret=True)
    got, _ = G.batched_windows(torch.from_numpy(mask), torch.from_numpy(srcs),
                               64, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:3] == G.INF).all() and got[3].min() == 0
