"""The conv spec trunk, the deployed detector's (LoaloaF/axtrack
machinelearning/model.py:5-53): params.json's ``ARCHITECTURE`` is a pair
(conv spec, FC spec); each conv spec entry (kernel, channels, stride,
groups) is a biased convolution with padding 1, BatchNorm and the
configuration's ``ACTIVATION_FUNCTION``, and 'M' a 2x2 max-pool.

Weights in the reference's PyTorch names
(``ConvNet.ConvBlock_{i}.conv/batchnorm``, i counting the 'M's too) or as
the flax variables of the repo's trained ``deployed_model/E0300``
(``from_flax``: ``CNNBlock_{k}`` counting convolutions only, kernels
HWIO).
"""
import torch
import torch.nn.functional as F

from .. import model as M

BN_EPS = 1e-5


def _layers(params):
    """(conv spec, activation spec) of a params.json dict."""
    return (M.untuple(params['ARCHITECTURE'])[0],
            M.untuple(params['ACTIVATION_FUNCTION']))


def from_flax(tree, params):
    """The trunk from flax variables ({'params', 'batch_stats'})."""
    conv_spec, act = _layers(params)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    prm, stats = tree['params'], tree['batch_stats']
    convs, k = [], 0
    for layer in conv_spec:
        if layer == 'M':
            convs.append('M')
            continue
        blk = prm[f'CNNBlock_{k}']
        convs.append({
            'w': f(blk['Conv_0']['kernel']).permute(3, 2, 0, 1).contiguous(),
            'b': f(blk['Conv_0']['bias']), 'stride': layer[2],
            'bn': {'scale': f(blk['BatchNorm_0']['scale']),
                   'bias': f(blk['BatchNorm_0']['bias']),
                   'mean': f(stats[f'CNNBlock_{k}']['BatchNorm_0']['mean']),
                   'var': f(stats[f'CNNBlock_{k}']['BatchNorm_0']['var'])}})
        k += 1
    return {'convs': convs, 'act': act}


def from_state_dict(sd, params):
    conv_spec, act = _layers(params)
    convs = []
    for i, layer in enumerate(conv_spec):
        if layer == 'M':
            convs.append('M')
            continue
        pre = f'ConvNet.ConvBlock_{i}'
        convs.append({'w': sd[f'{pre}.conv.weight'],
                      'b': sd[f'{pre}.conv.bias'], 'stride': layer[2],
                      'bn': M.bn_sd(sd, f'{pre}.batchnorm')})
    return {'convs': convs, 'act': act}


def shape_net(params, in_channels, tilesize):
    conv_spec, act = _layers(params)
    e = lambda *s: torch.empty(s, device='meta')  # noqa: E731
    bnp = lambda c: {k: e(c) for k in ('scale', 'bias', 'mean', 'var')}  # noqa
    c, h = in_channels, tilesize
    convs = []
    for layer in conv_spec:
        if layer == 'M':
            convs.append('M')
            h //= 2
            continue
        k, out_c, stride, _ = layer
        convs.append({'w': e(out_c, c, k, k), 'b': e(out_c),
                      'stride': stride, 'bn': bnp(out_c)})
        c, h = out_c, (h + 2 - k) // stride + 1
    return {'convs': convs, 'act': act}, c, h


def trunk(net, x, ops, train=False):
    act = M.activation(net['act'])
    for layer in net['convs']:
        if layer == 'M':
            x = F.max_pool2d(x, 2, 2)
        else:
            x = act(M.bn(ops.conv(x, layer['w'], layer['b'], layer['stride'],
                                  1), layer['bn'], train, BN_EPS))
    return x
