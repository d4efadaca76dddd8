"""Port parity: TIFF IO, preprocessing, tiling and the Timelapse dataset.

Inputs are seeded numpy draws fed to both packages. Tolerances: integer
tables, TIFF reads and the synthetic movie are exact. Preprocessed movies
are compared with rtol 1e-6 and atol 1e-6: XLA computes log2 as its own
log(1 + x) / log(2) and PyTorch as its log2, which differ by a few f32 ulp
(~1.2e-7 relative each), and standardization divides by ~0.014, so values
are O(30) and a relative bound is the one that means "a few ulp".
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from axtrack_tpu.data import tiffio as jtiff
from axtrack_tpu.data.synthetic import write_fixture
from axtrack_tpu.data.timelapse import Timelapse as JTimelapse
from axtrack_tpu.ops import preproc as JP, tiling as JT
from axtrack_tpu_torch.data import tiffio as ptiff
from axtrack_tpu_torch.data.synthetic import make_synthetic_timelapse
from axtrack_tpu_torch.data.timelapse import Timelapse
from axtrack_tpu_torch.ops import preproc as PP, tiling as PT

torch.set_num_threads(1)
ATOL = 1e-6
RTOL = 1e-6


@pytest.mark.parametrize('dtype', ['f32', 'u8', 'u16', 'i16'])
def test_tiff_reader_equals_jax(tmp_path, dtype):
    rng = np.random.default_rng(0)
    a = rng.random((3, 37, 53)).astype(np.float32)
    stack = {'f32': a, 'u8': (a * 255).astype(np.uint8),
             'u16': (a * 65535).astype(np.uint16),
             'i16': (a * 3000).astype(np.int16)}[dtype]
    path = str(tmp_path / 'm.tif')
    jtiff.write_tiff(path, stack)                 # written by PIL
    want = jtiff.read_tiff(path)
    got = ptiff.read_tiff(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and the port's writer produces a file the JAX reader agrees on
    path2 = str(tmp_path / 'p.tif')
    ptiff.write_tiff(path2, stack)
    np.testing.assert_array_equal(jtiff.read_tiff_raw(path2),
                                  ptiff.read_tiff_raw(path2))


def test_tiff_rejects_compressed(tmp_path):
    from PIL import Image
    path = str(tmp_path / 'c.tif')
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(
        path, compression='tiff_lzw')
    with pytest.raises(ValueError, match='compressed'):
        ptiff.read_tiff(path)


def test_preproc_ops_equal_jax():
    rng = np.random.default_rng(1)
    x = (rng.random((4, 40, 70)) * (rng.random((4, 40, 70)) > .5)
         ).astype(np.float32)
    m = rng.random((40, 70)) > .3
    want = np.asarray(JP.preprocess_frames(jnp.asarray(x), jnp.asarray(m),
                                           0.01, 0.05, 0.3))
    got = PP.preprocess_frames(torch.from_numpy(x), torch.from_numpy(m),
                               0.01, 0.05, 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for a, b in zip(JP.nonzero_stats(jnp.asarray(x)),
                    PP.nonzero_stats(torch.from_numpy(x))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=ATOL)
    ja = JP.compute_stnd_scaler(jnp.asarray(x))
    pa = PP.compute_stnd_scaler(torch.from_numpy(x))
    np.testing.assert_allclose(pa, ja, rtol=1e-6)


def test_tiling_ops_equal_jax():
    rng = np.random.default_rng(2)
    x = (rng.random((3, 50, 70)) * (rng.random((3, 50, 70)) > .97)
         ).astype(np.float32)
    t_j = np.asarray(JT.tile_frames(jnp.asarray(x), 16))
    t_p = PT.tile_frames(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(t_p.numpy(), t_j)
    np.testing.assert_array_equal(
        PT.untile_frames(t_p, 50, 70).numpy(),
        np.asarray(JT.untile_frames(jnp.asarray(t_j), 50, 70)))
    keep_j = JT.nonempty_tile_mask(jnp.asarray(t_j))
    keep_p = PT.nonempty_tile_mask(t_p)
    np.testing.assert_array_equal(keep_p, keep_j)
    for a, b in zip(JT.tile_index_table(keep_j),
                    PT.tile_index_table(keep_p)):
        np.testing.assert_array_equal(b, a)
    flat = t_j.reshape(3, -1, 16, 16)
    np.testing.assert_array_equal(
        PT.temporal_context_stack(torch.from_numpy(flat), [1], 1).numpy(),
        np.asarray(JT.temporal_context_stack(jnp.asarray(flat),
                                             jnp.asarray([1]), 1)))


def test_synthetic_movie_equals_jax():
    from axtrack_tpu.data.synthetic import make_synthetic_timelapse as jmake
    want = jmake(T=5, H=96, W=160, n_axons=4, seed=3, n_channels=3)
    got = make_synthetic_timelapse(T=5, H=96, W=160, n_axons=4, seed=3,
                                   n_channels=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize('variant', ['scaler_passed', 'scaler_computed'])
def test_timelapse_equals_jax(tmp_path, variant):
    fx = write_fixture(str(tmp_path), name='movie', T=8, H=128, W=256,
                       n_axons=4, seed=4, n_channels=3)
    scaler = (('zscore', (0.0142, 0.0128)) if variant == 'scaler_passed'
              else ('zscore', None))
    kw = dict(imseq_path=fx['tif'], labels_csv=None, mask_path=fx['mask'],
              timepoints=None, offset=None, log_correct=True,
              standardize_framewise=False, standardize=scaler, name='movie',
              use_transforms=[], contrast_llim=55 / 2 ** 16, plot=True,
              pad=[0, 8, 16, 4], Sy=12, Sx=12, tilesize=64, cache=None,
              from_cache=None, temporal_context=2)
    jt = JTimelapse(**kw)
    pt = Timelapse(**kw, device='cpu')
    assert pt.timepoints == jt.timepoints
    assert pt.timepoints_indices == jt.timepoints_indices
    assert (pt.sizet, pt.sizey, pt.sizex) == (jt.sizet, jt.sizey, jt.sizex)
    assert pt.stnd_scaler[0] == jt.stnd_scaler[0]
    np.testing.assert_allclose(pt.stnd_scaler[1], jt.stnd_scaler[1],
                               rtol=1e-6)
    np.testing.assert_array_equal(pt.mask, jt.mask)
    np.testing.assert_allclose(pt.X.numpy(), jt.X, rtol=RTOL, atol=ATOL)
    assert set(pt.plot_data) == set(jt.plot_data)
    for k in jt.plot_data:
        for a, b in zip(jt.plot_data[k], pt.plot_data[k]):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    jt.construct_tiles(force_no_transformation=True)
    pt.construct_tiles(force_no_transformation=True)
    np.testing.assert_array_equal(pt._tile_flat_idx, jt._tile_flat_idx)
    np.testing.assert_array_equal(pt._tile_yx, jt._tile_yx)
    np.testing.assert_allclose(pt.X_tiled.numpy(), np.asarray(jt.X_tiled),
                               rtol=RTOL, atol=ATOL)
    Xj, _ = jt.get_frametiles_stack(1)
    Xp, _ = pt.get_frametiles_stack(1)
    np.testing.assert_allclose(Xp.numpy(), np.asarray(Xj), rtol=RTOL,
                               atol=ATOL)


def test_timelapse_cache_roundtrip(tmp_path):
    frames, mask, _, _ = make_synthetic_timelapse(T=6, H=64, W=128, n_axons=2,
                                               seed=5, n_channels=2)
    np.save(tmp_path / 'mask.npy', mask)
    ptiff.write_tiff(str(tmp_path / 'm.tif'), frames)
    kw = dict(imseq_path=str(tmp_path / 'm.tif'), labels_csv=None,
              mask_path=str(tmp_path / 'mask.npy'), timepoints=None,
              offset=None, log_correct=True, standardize_framewise=False,
              standardize=('zscore', (0.02, 0.01)), name='m', tilesize=64,
              device='cpu')
    a = Timelapse(**kw, cache=str(tmp_path))
    b = Timelapse(**kw, from_cache=str(tmp_path))
    assert torch.equal(a.X, b.X)
    assert b.timepoints_indices == a.timepoints_indices
