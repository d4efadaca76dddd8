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


def _block_with_stats(C_in, C_out, stride, seed):
    """A seeded CNNBlock (leaky ReLU 0.1) with non-trivial BatchNorm
    parameters and running statistics, in eval mode."""
    from axtrack_tpu_torch.models.yolo import CNNBlock
    g = torch.Generator().manual_seed(seed)
    block = init_weights(CNNBlock(C_in, C_out, 3, stride, 1,
                                  ('leaky_relu', 0.1)), g)
    bn = block.batchnorm
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C_out, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(C_out, generator=g) * 0.3)
        bn.running_mean.copy_(torch.randn(C_out, generator=g))
        bn.running_var.copy_(torch.rand(C_out, generator=g) + 0.1)
    return block.eval()


@pytest.mark.parametrize('pool', [False, True])
@pytest.mark.parametrize('shape', [(2, 3, 4, 17, 23), (3, 5, 8, 16, 16)])
def test_epilogue_plain_equals_the_block_modules(shape, pool):
    """``epilogue_plain`` on a convolution without its bias equals, bit
    for bit, the block's modules after it: the bias add, the eval-mode
    BatchNorm, the LeakyReLU and, with ``pool``, ``nn.MaxPool2d(2, 2)``
    (odd sizes pool to the floor); NaNs included."""
    from axtrack_tpu_torch.ops.epilogue_cuda import epilogue_plain
    N, C_in, C, H, W = shape
    block = _block_with_stats(C_in, C, 1, seed=H)
    x = torch.randn(N, C, H, W, generator=torch.Generator().manual_seed(W))
    x[0, 0, 0, 1] = float('nan')
    bn = block.batchnorm
    want = block.activation(bn(x + block.conv.bias[:, None, None]))
    if pool:
        want = torch.nn.MaxPool2d(2, 2)(want)
    with torch.no_grad():
        got = epilogue_plain(x, block.conv.bias, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var, bn.eps,
                             block.activation.negative_slope, pool)
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got).any())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def test_epilogue_kernel_not_reached_off_the_card(monkeypatch):
    """The fused route engages only in eval mode, for an f32 conv, with a
    leaky ReLU, on a CUDA input, with grad mode off (``CNNBlock.fuses``):
    train mode, bf16 convs, grad mode and the CPU run the modules, and a
    CPU forward of the conv-spec stack never reaches the kernel (its
    ``launches`` stay as they were)."""
    from types import SimpleNamespace
    from axtrack_tpu_torch.models.yolo import CNNBlock
    from axtrack_tpu_torch.ops import epilogue_cuda as E

    def no_launch(*a, **k):
        raise AssertionError('the epilogue kernel was launched')
    monkeypatch.setattr(E.EpilogueKernel, '__call__', no_launch)
    card = SimpleNamespace(is_cuda=True)
    cpu = torch.zeros(1)
    block = _block_with_stats(3, 4, 1, seed=0)
    bf16 = CNNBlock(3, 4, 3, 1, 1, ('leaky_relu', 0.1),
                    dtype=torch.bfloat16).eval()
    sigmoid = CNNBlock(3, 4, 3, 1, 1, 'sigmoid').eval()
    with torch.no_grad():
        assert block.fuses(card)
        assert not block.fuses(cpu)
        assert not bf16.fuses(card)
        assert not sigmoid.fuses(card)
        assert not block.train().fuses(card)
    assert not block.eval().fuses(card)             # grad mode on
    P = get_default_parameters()
    P.update(TILESIZE=64, ARCHITECTURE=TINY[0])
    model = init_weights(build_model(P), torch.Generator().manual_seed(0))
    X = torch.randn(2, 5, 64, 64)
    before = E.epilogue_kernel.launches
    with torch.no_grad():
        model.eval()(X)
        model.train()(X)
    assert E.epilogue_kernel.launches == before


@pytest.mark.parametrize('arch', [0, 1])
def test_fused_stack_equals_the_modules_on_the_cpu(arch, monkeypatch):
    """The conv-spec stack's pairing of each block with the 2x2 max-pool
    after it: with the fused route forced on the CPU, where ``epilogue``
    runs ``epilogue_plain``, the stack gives what its modules give, bit
    for bit (the CPU's convolution adds its bias after the sum, as the
    bias-free convolution plus the plain epilogue does)."""
    from axtrack_tpu_torch.models import yolo
    P = get_default_parameters()
    P.update(TILESIZE=64, ARCHITECTURE=TINY[arch])
    model = init_weights(build_model(P),
                         torch.Generator().manual_seed(arch)).eval()
    g = torch.Generator().manual_seed(7)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g))
            m.running_var.copy_(torch.rand(m.num_features, generator=g)
                                + 0.5)
    X = torch.randn(3, 5, 64, 64, generator=g)
    with torch.no_grad():
        want = model(X)
        paired = []
        real = yolo.CNNBlock.fused

        def fused(self, x, pool):
            paired.append(pool)
            return real(self, x, pool)
        monkeypatch.setattr(yolo.CNNBlock, 'fuses', lambda self, x: True)
        monkeypatch.setattr(yolo.CNNBlock, 'fused', fused)
        got = model(X)
    spec = TINY[arch][0]
    assert paired == [i + 1 < len(spec) and spec[i + 1] == 'M'
                      for i, layer in enumerate(spec) if layer != 'M']
    assert torch.equal(got, want)


def test_state_dict_keys_unchanged_by_the_fused_stack():
    """``build_model(params)`` of the deployed bundle keeps the reference's
    keys: ``ConvNet.ConvBlock_{i}.conv`` and ``.batchnorm`` of each block,
    no key for a pool, and ``fcs.{j}``."""
    from axtrack_tpu_torch.models.yolo import ConvSpecNet
    from axtrack_tpu_torch.params import load_parameters
    model = build_model(load_parameters(None, None, from_directory=BUNDLE))
    assert isinstance(model.ConvNet, ConvSpecNet)
    blocks = [0, 1, 2, 4, 5, 7, 8, 10]
    want = set()
    for i in blocks:
        want |= {f'ConvNet.ConvBlock_{i}.conv.{k}' for k in ('weight',
                                                             'bias')}
        want |= {f'ConvNet.ConvBlock_{i}.batchnorm.{k}' for k in (
            'weight', 'bias', 'running_mean', 'running_var',
            'num_batches_tracked')}
    want |= {f'fcs.{j}.{k}' for j in (1, 3, 5) for k in ('weight', 'bias')}
    assert set(model.state_dict()) == want
