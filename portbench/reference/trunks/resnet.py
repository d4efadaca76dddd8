"""ResNet-18's trunk as the reference builds it (LoaloaF/axtrack
machinelearning/model.py:55-83; torchvision's resnet18, He et al.
arXiv:1512.03385): a biased 3x3 stride-2 padding-2 stem conv, its
BatchNorm, ReLU and a 3x3 stride-2 max-pool, then four stages of two
BasicBlocks at 64-128-256-512 channels.

Weights in the reference's PyTorch names: ``ConvNet.block_0`` (stem conv),
``block_1`` (its BatchNorm) and
``block_{4+k}.{j}.conv1/bn1/conv2/bn2/downsample.0/.1``.
"""
import torch
import torch.nn.functional as F

from .. import model as M

BN_EPS = 1e-5
# the stages' widths (torchvision: two blocks each)
WIDTHS = (64, 128, 256, 512)


def from_state_dict(sd, params):
    blocks = []
    for k, width in enumerate(WIDTHS):
        for j in range(2):
            pre = f'ConvNet.block_{4 + k}.{j}'
            stride = 2 if (k > 0 and j == 0) else 1
            blk = {'w1': sd[f'{pre}.conv1.weight'], 'stride': stride,
                   'bn1': M.bn_sd(sd, f'{pre}.bn1'),
                   'w2': sd[f'{pre}.conv2.weight'],
                   'bn2': M.bn_sd(sd, f'{pre}.bn2'), 'down': None}
            if f'{pre}.downsample.0.weight' in sd:
                blk['down'] = (sd[f'{pre}.downsample.0.weight'],
                               M.bn_sd(sd, f'{pre}.downsample.1'))
            blocks.append(blk)
    return {'stem': (sd['ConvNet.block_0.weight'], sd['ConvNet.block_0.bias']),
            'stem_bn': M.bn_sd(sd, 'ConvNet.block_1'), 'blocks': blocks}


def shape_net(params, in_channels, tilesize):
    e = lambda *s: torch.empty(s, device='meta')  # noqa: E731
    bnp = lambda c: {k: e(c) for k in ('scale', 'bias', 'mean', 'var')}  # noqa
    c, h = in_channels, tilesize
    net = {'stem': (e(64, c, 3, 3), e(64)), 'stem_bn': bnp(64), 'blocks': []}
    c, h = 64, (h + 4 - 3) // 2 + 1
    h = (h + 2 - 3) // 2 + 1
    for k, width in enumerate(WIDTHS):
        for j in range(2):
            stride = 2 if (k > 0 and j == 0) else 1
            down = ((e(width, c, 1, 1), bnp(width))
                    if stride != 1 or c != width else None)
            net['blocks'].append({'w1': e(width, c, 3, 3),
                                  'stride': stride, 'bn1': bnp(width),
                                  'w2': e(width, width, 3, 3),
                                  'bn2': bnp(width), 'down': down})
            h = (h + 2 - 3) // stride + 1
            c = width
    return net, c, h


def trunk(net, x, ops, train=False):
    w, b = net['stem']
    x = F.relu(M.bn(ops.conv(x, w, b, 2, 2), net['stem_bn'], train, BN_EPS))
    x = F.max_pool2d(x, 3, 2, 1)
    for blk in net['blocks']:
        h = F.relu(M.bn(ops.conv(x, blk['w1'], None, blk['stride'], 1),
                        blk['bn1'], train, BN_EPS))
        h = M.bn(ops.conv(h, blk['w2'], None, 1, 1), blk['bn2'], train,
                 BN_EPS)
        if blk['down'] is not None:
            w, p = blk['down']
            x = M.bn(ops.conv(x, w, None, blk['stride'], 0), p, train,
                     BN_EPS)
        x = F.relu(h + x)
    return x
