"""The A* path helper of the public surface (counterpart of
``axtrack_tpu/utils/paths.py``, reference utils.py:351-390)."""
import numpy as np
from scipy import sparse


def _compute_astar_path(source, target, weights, return_dist=True,
                        max_path_length=10000):
    """The A* path between two (y, x) cells of a weight matrix, by the
    port's native solver (``native/astar.cpp``).

    Returns a bool ``scipy.sparse.coo_matrix`` of the path's cells, or None
    when no path of at most ``max_path_length`` exists; with
    ``return_dist``, also the path's node count (None without a path)."""
    from .. import native
    path_coo = native.astar_path(np.asarray(weights, np.float32),
                                 (int(source[0]), int(source[1])),
                                 (int(target[0]), int(target[1])),
                                 max_path_length)
    if path_coo is None:
        return (None, None) if return_dist else None
    path = sparse.coo_matrix(
        (np.ones(path_coo.shape[0]), (path_coo[:, 0], path_coo[:, 1])),
        np.asarray(weights).shape, dtype=bool)
    return (path, path_coo.shape[0]) if return_dist else path
