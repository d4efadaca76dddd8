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
    bits, row_words = GC.pack_mask(torch.from_numpy(mask))
    with pytest.raises(ValueError):
        GC.chamfer_kernel(bits, row_words,
                          torch.zeros(1, 2, dtype=torch.int32),
                          torch.zeros(1, 2, dtype=torch.int32), 64, 1)


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


# ---- K1's plain version on the bit-packed mask (the kernel's contract)

def _windows(mask, srcs, window):
    """(bits, row_words, N, origins, local) of the port's probe route."""
    m = torch.from_numpy(mask)
    N, Np, origins, local = GC._pad_srcs(m, torch.from_numpy(srcs), window)
    return (*GC.pack_mask(m), N, origins, local)


@pytest.mark.parametrize('sweeps', [1, 2])
@pytest.mark.parametrize('family', sorted(MASKS))
def test_windows_plain_equals_pallas_probed(family, sweeps):
    """chamfer_windows_plain on the packed mask: the Pallas route's maps
    bit for bit (interpret mode), fresh and continued, and its per-window
    flags' conjunction over the real windows is the Pallas certificate."""
    from axtrack_tpu.ops import geodesic_pallas as GP
    make, window = MASKS[family]
    mask, srcs = make()
    bits, row_words, N, origins, local = _windows(mask, srcs, window)
    d_j, _, ok_j = GP.batched_windows_probed(jnp.asarray(mask), srcs, window,
                                             max_sweeps=sweeps,
                                             interpret=True)
    maps, ok = GC.chamfer_windows_plain(bits, row_words, origins, local,
                                        window, sweeps)
    assert maps.dtype == torch.float32 and ok.dtype == torch.int32
    np.testing.assert_array_equal(maps[:N].numpy(), np.asarray(d_j))
    assert bool(ok[:N].all()) == bool(ok_j)

    c_j, cok_j = GP._continue_windows_pallas(jnp.asarray(mask), srcs, d_j,
                                             window, sweeps, interpret=True)
    cont, cok = GC.chamfer_windows_plain(bits, row_words, origins, local,
                                         window, sweeps, init=maps)
    np.testing.assert_array_equal(cont[:N].numpy(), np.asarray(c_j))
    assert bool(cok[:N].all()) == bool(cok_j)


@pytest.mark.parametrize('sweeps', [1, 2, 8])
@pytest.mark.parametrize('family', ['random_blob', 'serpentine'])
def test_window_flags_equal_single_window_certificate(family, sweeps):
    """Each window's flag is the certificate of that window alone. On the
    maze (serpentine) every window fails at 1 and 2 sweeps; on the blob at
    1 sweep some windows fail and others pass."""
    make, window = MASKS[family]
    mask, srcs = make()
    bits, row_words, N, origins, local = _windows(mask, srcs, window)
    maps, ok = GC.chamfer_windows_plain(bits, row_words, origins, local,
                                        window, sweeps)
    crops = G.crops_for(torch.from_numpy(mask), origins, local, window)
    want = [bool(GC._locally_consistent(maps[n:n + 1], crops[n:n + 1]))
            for n in range(len(maps))]
    assert ok.tolist() == [int(w) for w in want]
    if family == 'serpentine' and sweeps < 8:
        assert not any(want[:N])
    if family == 'random_blob' and sweeps == 1:
        assert 0 < sum(want[:N]) < N


@pytest.mark.parametrize('width', [1, 31, 32, 33, 63, 100, 130])
def test_pack_mask_round_trip(width):
    rng = np.random.default_rng(width)
    mask = rng.random((5, width)) > 0.5
    mask[0] = True
    bits, row_words = GC.pack_mask(torch.from_numpy(mask))
    assert bits.dtype == torch.int32 and row_words == -(-width // 32) + 1
    assert tuple(bits.shape) == (5, row_words)
    back = GC.unpack_mask(bits, row_words).numpy()
    np.testing.assert_array_equal(back[:, :width], mask)
    assert not back[:, width:].any()


@pytest.mark.parametrize('per_thread', [1, 2, 4, 8, 16, 32])
def test_funnel_read_every_offset(per_thread):
    """The kernel's read of a thread's columns [c, c + E): the two words
    that hold bit c, joined and shifted right by c % 32 (__funnelshift_r),
    low E bits kept. Done in numpy at every column offset 0-31; the spare
    word keeps the second word inside the row."""
    rng = np.random.default_rng(per_thread)
    width = 200
    mask = rng.random((3, width)) > 0.5
    bits, row_words = GC.pack_mask(torch.from_numpy(mask))
    words = bits.numpy().view(np.uint32).astype(np.uint64)
    keep = (1 << per_thread) - 1
    for c in range(0, width):
        q = c >> 5
        assert q + 1 < row_words
        for y in range(3):
            joined = (words[y, q + 1] << np.uint64(32)) | words[y, q]
            got = int(joined >> np.uint64(c & 31)) & 0xffffffff & keep
            cols = mask[y, c:c + per_thread]
            want = sum(1 << e for e, p in enumerate(cols) if p)
            assert got == want, (c, y)


def test_windows_plain_source_outside_window_seeds_nothing():
    """A source outside its window seeds nothing and forces no cell: its
    map stays INF and its window is certified (nothing is wrong there)."""
    mask = np.ones((64, 96), bool)
    srcs = np.array([[-3, 10], [10, 100], [70, 10], [5, 5]], np.int32)
    bits, row_words, N, origins, local = _windows(mask, srcs, 64)
    maps, ok = GC.chamfer_windows_plain(bits, row_words, origins, local, 64,
                                        2)
    assert (maps[:3] == G.INF).all() and maps[3].min() == 0
    assert ok[:N].tolist() == [1, 1, 1, 1]
    got, _ = G.batched_windows(torch.from_numpy(mask),
                               torch.from_numpy(srcs), 64, 2)
    np.testing.assert_array_equal(maps[:N].numpy(), got.numpy())


@pytest.mark.parametrize('family', sorted(MASKS))
def test_window_bands_plain_equal_jax(family):
    """K1's band pass (plain version) equals the Pallas route's
    ``_window_bands`` on its crops. (A source at a negative coordinate is
    left out: the Pallas route's crop gather wraps its index and forces a
    cell at the far side of the window passable; ROADMAP F3.)"""
    from axtrack_tpu.ops import geodesic_pallas as GP
    make, window = MASKS[family]
    mask, srcs = make()
    bits, row_words, N, origins, local = _windows(mask, srcs, window)
    Np = len(origins)
    crops = GP._crops_for(jnp.asarray(mask), jnp.asarray(origins.numpy()),
                          jnp.asarray(local.numpy()), window, Np)
    lo, hi = GP._window_bands(crops)
    got = GC.window_bands_plain(bits, row_words, origins, local, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([np.asarray(lo), np.asarray(hi)],
                                           -1))


def _kernel_row_relax(cand, passable, E):
    """numpy mirror of K1's row relax (csrc/chamfer.cu), in f32 as the
    kernel computes it: each thread's E cells run both ways from INF, the
    threads' runs are joined by segmented min-scans (segments end at
    threads holding a blocked cell), and the carries enter each cell with
    its distance to the thread's edge."""
    f32, INF = np.float32, np.float32(G.INF)
    T = len(cand) // E
    x = np.where(passable, cand, INF).astype(f32).reshape(T, E)
    w = np.where(passable, f32(1), INF).astype(f32).reshape(T, E)
    f0, b0, lw, rw = (np.empty_like(x) for _ in range(4))
    run, dist = np.full(T, INF, f32), np.zeros(T, f32)
    for e in range(E):
        run = np.minimum(x[:, e], run + w[:, e])
        dist = dist + w[:, e]
        f0[:, e], lw[:, e] = run, dist
    run, dist = np.full(T, INF, f32), np.zeros(T, f32)
    for e in range(E - 1, -1, -1):
        run = np.minimum(x[:, e], run + w[:, e])
        dist = dist + w[:, e]
        b0[:, e], rw[:, e] = run, dist
    broken = ~passable.reshape(T, E).all(axis=1)
    lane = np.arange(T)
    uf = np.where(f0[:, -1] < INF, f0[:, -1] - f32(E) * lane, INF).astype(f32)
    ub = np.where(b0[:, 0] < INF, b0[:, 0] + f32(E) * lane, INF).astype(f32)
    cl, cr = np.full(T, INF, f32), np.full(T, INF, f32)
    for t in range(T):
        seg_lo = max([j for j in range(t) if broken[j]], default=0)
        seg_hi = min([j for j in range(t + 1, T) if broken[j]], default=T - 1)
        if t > 0:
            s = uf[seg_lo:t].min()
            cl[t] = s + f32(E * (t - 1)) if s < INF else INF
        if t < T - 1:
            s = ub[t + 1:seg_hi + 1].min()
            cr[t] = s - f32(E * (t + 1)) if s < INF else INF
    v = np.minimum(np.minimum(f0, cl[:, None] + lw),
                   np.minimum(b0, cr[:, None] + rw))
    return v.reshape(-1)


@pytest.mark.parametrize('E', [1, 4, 16])
def test_kernel_row_relax_mirror_equals_plain(E):
    """K1's f32 row algebra (mirrored in numpy) equals the plain version's
    int64 row relax bit for bit, INF rounding included."""
    rng = np.random.default_rng(E)
    W = 32 * E
    for trial in range(20):
        passable = rng.random(W) > rng.choice([0.02, 0.2, 0.6])
        cand = np.where(rng.random(W) < 0.1, rng.integers(0, 3 * W, W),
                        G.INF_I)
        want = G._row_min_plus(torch.from_numpy(cand.astype(np.int64)),
                               torch.from_numpy(passable)).numpy()
        got = _kernel_row_relax(cand.astype(np.float32), passable, E)
        np.testing.assert_array_equal(got, want.astype(np.float32))


# ---- the association's flushes (detections.lookback_distances)

# detections a frame: empty frames as sources and as targets (gap 1 and 2)
MOVIE_COUNTS = [5, 0, 7, 3, 0, 0, 6, 4, 8, 2]


def _movie(mask, seed):
    """Per-frame detections on ``mask``: mostly passable cells, and in some
    frames an off-mask cell and a cell at a negative coordinate."""
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero(mask)
    dets = []
    for t, n in enumerate(MOVIE_COUNTS):
        pick = rng.choice(len(ys), n, replace=False)
        y, x = ys[pick], xs[pick]
        if n and t % 3 == 0:
            off = np.argwhere(~mask)[rng.integers((~mask).sum())]
            y[0], x[0] = off
        if n > 1 and t % 4 == 2:
            y[1], x[1] = -2, 3
        dets.append({'y': y.astype(np.int32), 'x': x.astype(np.int32)})
    return dets


def _lookback_oracle(dets, padded, window, cap, max_gap):
    """Every lookback pair by itself: the source frame's converged maps
    and ``G.gather_targets`` of the target frame's detections, as the
    per-pair loop gathered them."""
    out = {}
    for s in range(len(dets) - 1):
        if len(dets[s]['y']) == 0:
            continue
        srcs = torch.from_numpy(np.stack([dets[s]['y'], dets[s]['x']], -1))
        dmaps, origins = G.batched_windows(padded, srcs.long(), window, 1,
                                           converge=True)
        for gap in range(1, max_gap + 1):
            t = s + gap
            if t < len(dets):
                tg = np.stack([dets[t]['y'], dets[t]['x']], -1)
                out[(t, gap)] = G.gather_targets(
                    dmaps, origins, torch.from_numpy(tg).long().reshape(-1, 2),
                    cap, window).numpy()
    return out


@pytest.mark.parametrize('case', ['whole', 'split', 'continued', 'never'])
@pytest.mark.parametrize('family', sorted(MASKS))
def test_lookback_distances_equal_per_pair_gathers(family, case,
                                                   monkeypatch):
    """The packed flush (one upload, one batched gather and one readback a
    K1 launch) gives the per-pair oracle's distances bit for bit: a window
    (32) smaller than the mask, so targets fall outside their source's
    window, a cap (12) below many distances, empty frames as sources and
    targets. 'split' cuts the flushes at 6 sources; 'continued' fails the
    first probe's certificate, so each flush certifies after one
    continuation; 'never' fails it with no continuation allowed, so the
    flush converges from scratch. One gather a K1 launch (and one after a
    convergence from scratch), counted as ``gathers``."""
    from axtrack_tpu_torch import detections as AD
    from axtrack_tpu_torch.utils import profiling
    mask = MASKS[family][0]()[0]
    window, cap, max_gap = 32, 12.0, 2
    padded = torch.from_numpy(mask)
    dets = _movie(mask, 11)
    sweeps = 8 if case == 'continued' else 1
    if case == 'split':
        monkeypatch.setattr(AD, 'MAX_SRC', 6)
    if case in ('continued', 'never'):
        probe, fails = GC.batched_windows_probed, [1]

        def failing_probe(*args, **kw):
            dmaps, origins, ok = probe(*args, **kw)
            if fails:                 # the first probe's certificate fails
                fails.pop()
                ok = torch.zeros_like(ok)
            return dmaps, origins, ok
        monkeypatch.setattr(GC, 'batched_windows_probed', failing_probe)
    if case == 'never':
        monkeypatch.setattr(AD, 'MAX_ASSOC_SWEEPS', 1)
    rec = profiling.StageTimer()
    with profiling.attach((rec, None)):
        got, flushes, _ = AD.lookback_distances(
            dets, range(len(dets) - 1), max_gap, window, padded,
            GC.pack_mask(padded), cap, sweeps)
    want = _lookback_oracle(dets, padded, window, cap, max_gap)
    assert set(got) == set(want)
    for key, D in want.items():
        assert got[key].dtype == np.float32
        assert np.array_equal(got[key], D), key
    assert any((D == cap).any() for D in want.values())
    assert any((D < cap).any() for D in want.values())
    if case == 'split':
        assert len(flushes) > 1
    if case == 'continued':
        assert [(f['budget'], f['sweeps'], f['certified'])
                for f in flushes] == [(8, 16, True)]
    if case == 'never':
        assert [(f['sweeps'], f['certified']) for f in flushes] == [
            (1, False)]
    assert rec.counters['gathers'] == sum(
        f['sweeps'].bit_length() - f['budget'].bit_length() + 1
        + (not f['certified']) for f in flushes)
