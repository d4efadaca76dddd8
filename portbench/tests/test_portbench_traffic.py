"""The generator is deterministic in the seed, on any device."""
import numpy as np

from _small import MOVIE
from portbench.lib import movie

MIX = {'frames': 5, 'height': 300, 'width': 700, 'cones': 6,
       'start_span': 0.35, 'channels': 2, 'channel_height': 40,
       'speed': [4, 14], 'blob_sigma': 3.5, 'amplitude': 0.35,
       'noise': 0.004, 'background': 0.008}


def test_same_seed_same_movie_and_another_seed_another():
    seed = 2 ** 31 + 12345                    # past 32 signed bits
    a = movie.make_movie(MIX, seed, 'cpu', 128)
    b = movie.make_movie(MIX, seed, 'cpu', 128)
    c = movie.make_movie(MIX, seed + 1, 'cpu', 128)
    assert a['raw'].dtype == np.uint16 and a['raw'].shape == (5, 300, 700)
    for k in ('raw', 'mask', 'ys', 'xs'):
        np.testing.assert_array_equal(a[k], b[k])
    assert a['kept_tiles'] == b['kept_tiles']
    assert not np.array_equal(a['raw'], c['raw'])
    assert not np.array_equal(a['xs'], c['xs'])


def test_cones_sit_on_the_mask_and_off_it_is_zero():
    m = movie.make_movie(MIX, 3, 'cpu', 128)
    assert (m['raw'][:, ~m['mask']] == 0).all()
    ys = np.round(m['ys']).astype(int)
    xs = np.round(m['xs']).astype(int)
    assert m['mask'][ys, xs].all()


def test_the_test_mix_keys_are_mix_keys():
    assert set(MOVIE) <= set(MIX) | {'movies'}
