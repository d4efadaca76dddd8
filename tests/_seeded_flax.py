"""Seeded flax variables for the port's parity tests, drawn with numpy.

The tree's shapes come from ``jax.eval_shape`` of the JAX package's
``init`` (tracing only: a backbone's eager init takes 10-30 s on the CPU).
Conv and dense kernels draw from N(0, 2/fan_in) (He's init, so the
input's signal survives a backbone's depth), biases from U(+-0.1);
BatchNorm scales from U(0.5, 1.5), its biases U(+-0.1), running means
U(+-0.3) and variances U(0.5, 1.5), so no layer is the identity.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np


def seeded_flax_variables(module, P, seed, in_channels=5):
    """{'params', 'batch_stats'} of ``module`` (an ``axtrack_tpu``
    detector or backbone) as numpy arrays."""
    ts = P['TILESIZE']
    shapes = jax.eval_shape(functools.partial(module.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, ts, ts, in_channels)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == 'kernel':
            a = rng.normal(0, np.sqrt(2 / np.prod(shape[:-1])), shape)
        elif name == 'scale' or name == 'var':
            a = rng.uniform(0.5, 1.5, shape)
        elif name == 'mean':
            a = rng.uniform(-0.3, 0.3, shape)
        else:                                          # bias
            a = rng.uniform(-0.1, 0.1, shape)
        return a.astype(np.float32)
    out = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    out.setdefault('batch_stats', {})
    return out


def flax_variables_of(model, P):
    """The inverse of ``weights_from_jax`` for a backbone detector of the
    port: its weights as an ``axtrack_tpu`` variables tree of numpy
    arrays."""
    import torch
    from axtrack_tpu_torch.models.backbones import flax_path
    from axtrack_tpu_torch.models.yolo import (_nchw_to_nhwc_flat_perm,
                                               conv_out_shape)
    prm, stats = {'backbone': {}}, {'backbone': {}}

    def put(tree, path, leaf, t):
        for key in path:
            tree = tree.setdefault(key, {})
        tree[leaf] = t.detach().cpu().numpy()
    stack = model.ConvNet
    for name, m in stack.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            path = flax_path(stack, name)
            put(prm['backbone'], path, 'kernel',
                m.weight.permute(2, 3, 1, 0))
            if m.bias is not None:
                put(prm['backbone'], path, 'bias', m.bias)
        elif isinstance(m, torch.nn.BatchNorm2d):
            path = flax_path(stack, name)
            put(prm['backbone'], path, 'scale', m.weight)
            put(prm['backbone'], path, 'bias', m.bias)
            put(stats['backbone'], path, 'mean', m.running_mean)
            put(stats['backbone'], path, 'var', m.running_var)
    linears = [m for m in model.fcs if isinstance(m, torch.nn.Linear)]
    C, H, W = conv_out_shape(P['ARCHITECTURE'], P['TILESIZE'])
    for k, lin in enumerate(linears):
        w = lin.weight.detach().numpy()
        if k == 0:
            w = w[:, _nchw_to_nhwc_flat_perm(C, H, W)]
        prm[f'Dense_{k}'] = {'kernel': np.ascontiguousarray(w.T),
                             'bias': lin.bias.detach().numpy()}
    return {'params': prm,
            'batch_stats': stats if stats['backbone'] else {}}
