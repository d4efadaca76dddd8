"""Port parity: the detector and ``weights_from_jax``.

The JAX package's variables (the deployed E0300 checkpoint, restored here
on the test side with orbax, and seeded flax inits of a tiny architecture)
are carried across with ``weights_from_jax``; both forwards run in f32 on
the CPU on the same seeded tiles. Tolerance rtol 1e-4 / atol 1e-5: the two
frameworks sum the convolutions and the 40960-long FC1 dot products in
different orders.
"""
import os

import jax
import numpy as np
import pytest
import torch

from axtrack_tpu.models.yolo import (build_model as jax_build_model,
                                     detect_axons, init_variables)
from axtrack_tpu.params import load_parameters as jax_load_parameters
from axtrack_tpu_torch.models.yolo import (build_model, init_weights,
                                           weights_from_jax)
from axtrack_tpu_torch.params import get_default_parameters

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, 'deployed_model')


def _torch_grid(P, variables_np, X_nhwc):
    model = build_model(P)
    model.load_state_dict(weights_from_jax(variables_np, P))
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(X_nhwc).permute(0, 3, 1, 2)).numpy()


def test_deployed_e0300_grids_equal_jax():
    import orbax.checkpoint as ocp
    P = jax_load_parameters(None, None, from_directory=BUNDLE)
    with ocp.PyTreeCheckpointer() as ckptr:
        ckpt = ckptr.restore(os.path.join(BUNDLE, 'E0300'))
    variables = {'params': ckpt['params'],
                 'batch_stats': ckpt['batch_stats']}
    X = np.random.default_rng(0).random((2, 512, 512, 5)).astype(np.float32)
    want = np.asarray(detect_axons(jax_build_model(P), variables, X))
    got = _torch_grid(P, variables, X)
    assert got.shape == want.shape == (2, 12, 12, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


TINY = [
    [[(3, 8, 2, 1), 'M', (3, 16, 1, 1), 'M'],
     [('FC', 32), ('activation', 'sigmoid')]],
    [[(3, 6, 1, 1), (3, 12, 2, 2), 'M', (3, 12, 1, 1)],
     [('FC', 16), ('activation', ('leaky_relu', 0.1)), ('FC', 8),
      ('activation', 'sigmoid')]],
]


@pytest.mark.parametrize('arch', [0, 1])
def test_tiny_architecture_grids_equal_jax(arch):
    P = get_default_parameters()
    P.update(TILESIZE=64, ARCHITECTURE=TINY[arch])
    jm = jax_build_model(P)
    variables = jax.tree.map(np.asarray, init_variables(jm, P, seed=arch))
    rng = np.random.default_rng(arch)
    # non-trivial BatchNorm statistics, so the running stats are exercised
    variables['batch_stats'] = jax.tree.map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        variables['batch_stats'])
    X = rng.random((3, 64, 64, 5)).astype(np.float32)
    want = np.asarray(detect_axons(jm, variables, X))
    got = _torch_grid(P, variables, X)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_state_dict_uses_reference_names():
    P = get_default_parameters()
    P.update(TILESIZE=64, ARCHITECTURE=TINY[0])
    keys = set(build_model(P).state_dict())
    assert 'ConvNet.ConvBlock_0.conv.weight' in keys
    assert 'ConvNet.ConvBlock_2.batchnorm.running_var' in keys
    assert {'fcs.1.weight', 'fcs.3.weight'} <= keys


def test_seeded_init_is_reproducible():
    P = get_default_parameters()
    P.update(TILESIZE=64, ARCHITECTURE=TINY[0])
    a = init_weights(build_model(P), torch.Generator().manual_seed(3))
    b = init_weights(build_model(P), torch.Generator().manual_seed(3))
    c = init_weights(build_model(P), torch.Generator().manual_seed(4))
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.fcs[1].weight, c.fcs[1].weight)
