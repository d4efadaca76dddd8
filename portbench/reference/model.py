"""The plain reference detector: the YOLO_AXTrack forward (and, in train
mode, its loss) in plain torch functions, from the published description
(LoaloaF/axtrack machinelearning/model.py and loss.py; ResNet-18 as
torchvision builds it, He et al. arXiv:1512.03385, with the reference's
biased 3x3 stride-2 stem).

It imports nothing of the program. Weights come in one of two published
layouts, and this module reads each by its own rules:

- the flax variables of the repo's trained ``deployed_model/E0300``
  (``from_flax``): conv kernels HWIO, Dense kernels [in, out], and the
  conv features flattened in NHWC order, as flax flattens them;
- a state dict with the reference's PyTorch names (``from_state_dict``):
  ``ConvNet.ConvBlock_{i}.conv/batchnorm`` or, for ResNet-18,
  ``ConvNet.block_0`` (stem conv), ``block_1`` (its BatchNorm) and
  ``block_{4+k}.{j}.conv1/bn1/conv2/bn2/downsample.0/.1``; ``fcs.{j}``
  Linear layers; features flattened in NCHW order.

Precision: f32 with TF32 off (``exact``). ``precision='tf32'`` is the
control, the step below the configuration's precision: on a card the
convolutions and matmuls run with TF32 on; elsewhere their operands are
rounded to TF32 (10 mantissa bits, nearest even; gradients pass through
the rounding unchanged).
"""
import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
# ResNet-18's stages (torchvision: 64-128-256-512, two blocks each)
RESNET_WIDTHS = (64, 128, 256, 512)
# the FC head the reference puts on a backbone (model.py:55-83)
BACKBONE_HEAD = [('FC', 1024), ('activation', 'sigmoid'), ('FC', 1024),
                 ('activation', 'sigmoid')]


def exact():
    """TF32 off for cuDNN and cuBLAS (the configuration's precision)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def tf32(x):
    """f32 -> the nearest TF32 value (10 mantissa bits, ties to even)."""
    i = x.contiguous().view(torch.int32)
    low = i & 0x1FFF
    keep = i & ~0x1FFF
    up = (low > 0x1000) | ((low == 0x1000) & ((i & 0x2000) != 0))
    return torch.where(up, keep + 0x2000, keep).view(torch.float32)


@contextlib.contextmanager
def tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        exact()


class Ops:
    """conv2d and linear at a precision ('f32' or 'tf32'); ``macs``
    counts multiply-adds when ``count`` is set (``forward_flops``)."""

    def __init__(self, precision='f32', count=False):
        if precision not in ('f32', 'tf32'):
            raise ValueError(f'precision {precision!r}')
        self.low = precision == 'tf32'
        self.count = count
        self.macs = 0

    def _run(self, fn, x, w, *args):
        if not self.low:
            return fn(x, w, *args)
        if x.is_cuda:
            with tf32_on():
                return fn(x, w, *args)
        r = lambda a: a + (tf32(a.detach()) - a).detach()  # noqa: E731
        return fn(r(x), r(w), *args)

    def conv(self, x, w, b, stride, padding):
        y = self._run(F.conv2d, x, w, b, stride, padding)
        if self.count:
            self.macs += y.numel() * w[0].numel()
        return y

    def linear(self, x, w, b):
        y = self._run(F.linear, x, w, b)
        if self.count:
            self.macs += y.numel() * w.shape[1]
        return y


def activation(spec):
    name, *args = spec if isinstance(spec, (list, tuple)) else (spec,)
    if name == 'leaky_relu':
        return lambda x: F.leaky_relu(x, args[0] if args else 0.01)
    if name == 'sigmoid':
        return torch.sigmoid
    if name == 'relu':
        return F.relu
    raise ValueError(f'activation {spec!r}')


def _spec(a):
    """params.json's {'__tuple__': [...]} as a list."""
    if isinstance(a, dict) and '__tuple__' in a:
        return [_spec(v) for v in a['__tuple__']]
    if isinstance(a, list):
        return [_spec(v) for v in a]
    return a


def architecture(params):
    """(conv spec or 'resnet', FC spec, activation) of a bundle's
    params.json dict."""
    arch = _spec(params['ARCHITECTURE'])
    act = _spec(params['ACTIVATION_FUNCTION'])
    if isinstance(arch, str):
        return arch, BACKBONE_HEAD, act
    return arch[0], arch[1], act


def bn(x, p, train):
    """BatchNorm: batch statistics (biased variance) in train mode, the
    running ones otherwise."""
    if train:
        return F.batch_norm(x, None, None, p['scale'], p['bias'], True, 0.0,
                            BN_EPS)
    mean, var = p['mean'], p['var']
    inv = p['scale'] / torch.sqrt(var + BN_EPS)
    return (x - mean[:, None, None]) * inv[:, None, None] \
        + p['bias'][:, None, None]


def from_flax(tree, params):
    """The net from flax variables ({'params', 'batch_stats'}) of a conv
    spec architecture."""
    conv_spec, fc_spec, act = architecture(params)
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
    n_fc = sum(1 for e, _ in fc_spec if e == 'FC') + 1
    fcs = [{'w': f(prm[f'Dense_{m}']['kernel']).T.contiguous(),
            'b': f(prm[f'Dense_{m}']['bias'])} for m in range(n_fc)]
    return {'kind': 'spec', 'convs': convs, 'fcs': fcs, 'fc_spec': fc_spec,
            'act': act, 'flatten': 'nhwc', 'S': (params['SX'], params['SY'])}


def _bn_sd(sd, pre):
    return {'scale': sd[f'{pre}.weight'], 'bias': sd[f'{pre}.bias'],
            'mean': sd[f'{pre}.running_mean'],
            'var': sd[f'{pre}.running_var']}


def from_state_dict(sd, params):
    """The net from a state dict in the reference's PyTorch names (see the
    module docstring); the tensors are used as they are (no copy)."""
    conv_spec, fc_spec, act = architecture(params)
    net = {'fc_spec': fc_spec, 'act': act, 'flatten': 'nchw',
           'S': (params['SX'], params['SY'])}
    if conv_spec == 'resnet':
        blocks = []
        for k, width in enumerate(RESNET_WIDTHS):
            for j in range(2):
                pre = f'ConvNet.block_{4 + k}.{j}'
                stride = 2 if (k > 0 and j == 0) else 1
                blk = {'w1': sd[f'{pre}.conv1.weight'], 'stride': stride,
                       'bn1': _bn_sd(sd, f'{pre}.bn1'),
                       'w2': sd[f'{pre}.conv2.weight'],
                       'bn2': _bn_sd(sd, f'{pre}.bn2'), 'down': None}
                if f'{pre}.downsample.0.weight' in sd:
                    blk['down'] = (sd[f'{pre}.downsample.0.weight'],
                                   _bn_sd(sd, f'{pre}.downsample.1'))
                blocks.append(blk)
        net.update(kind='resnet', stem=(sd['ConvNet.block_0.weight'],
                                        sd['ConvNet.block_0.bias']),
                   stem_bn=_bn_sd(sd, 'ConvNet.block_1'), blocks=blocks)
    else:
        convs = []
        for i, layer in enumerate(conv_spec):
            if layer == 'M':
                convs.append('M')
                continue
            pre = f'ConvNet.ConvBlock_{i}'
            convs.append({'w': sd[f'{pre}.conv.weight'],
                          'b': sd[f'{pre}.conv.bias'], 'stride': layer[2],
                          'bn': _bn_sd(sd, f'{pre}.batchnorm')})
        net.update(kind='spec', convs=convs)
    # fcs: Flatten is 0, one module per FC spec element, the head last
    idx = [1 + j for j, (e, _) in enumerate(fc_spec) if e == 'FC']
    idx.append(1 + len(fc_spec))
    net['fcs'] = [{'w': sd[f'fcs.{j}.weight'], 'b': sd[f'fcs.{j}.bias']}
                  for j in idx]
    return net


def trunk(net, x, ops, train=False):
    """Conv features of NCHW tiles x."""
    if net['kind'] == 'resnet':
        w, b = net['stem']
        x = F.relu(bn(ops.conv(x, w, b, 2, 2), net['stem_bn'], train))
        x = F.max_pool2d(x, 3, 2, 1)
        for blk in net['blocks']:
            h = F.relu(bn(ops.conv(x, blk['w1'], None, blk['stride'], 1),
                          blk['bn1'], train))
            h = bn(ops.conv(h, blk['w2'], None, 1, 1), blk['bn2'], train)
            if blk['down'] is not None:
                w, p = blk['down']
                x = bn(ops.conv(x, w, None, blk['stride'], 0), p, train)
            x = F.relu(h + x)
        return x
    act = activation(net['act'])
    for layer in net['convs']:
        if layer == 'M':
            x = F.max_pool2d(x, 2, 2)
        else:
            x = act(bn(ops.conv(x, layer['w'], layer['b'], layer['stride'],
                                1), layer['bn'], train))
    return x


def forward(net, x, ops=None, train=False):
    """The grid f32[N, Sx, Sy, 3] of NCHW tiles x."""
    ops = ops or Ops()
    x = trunk(net, x, ops, train)
    x = (x.permute(0, 2, 3, 1) if net['flatten'] == 'nhwc' else x)
    x = x.reshape(x.shape[0], -1)
    m = 0
    for element, param in net['fc_spec']:
        if element == 'FC':
            x = ops.linear(x, net['fcs'][m]['w'], net['fcs'][m]['b'])
            m += 1
        elif element == 'activation':
            x = activation(param)(x)
        else:
            raise ValueError(f'FC element {element!r}')
    x = ops.linear(x, net['fcs'][m]['w'], net['fcs'][m]['b'])
    Sx, Sy = net['S']
    return x.reshape(x.shape[0], Sx, Sy, 3)


def yolo_loss(pred, target, P):
    """The reference's loss (machinelearning/loss.py), in the order of the
    port's frozen copy (``models/loss.py``): squared errors of the positive
    cells' offsets, of their confidences against 1 and of the empty cells'
    confidences against 0, each weighted and divided by the batch, then
    summed (no-object, object, offsets)."""
    bs = target.shape[0]
    obj = target[..., 0:1]
    xy = ((pred[..., 1:3] * obj - target[..., 1:3]) ** 2).sum()
    o = ((pred[..., 0:1] * obj - obj) ** 2).sum()
    no = ((pred[..., 0:1] * (1.0 - obj)) ** 2).sum()
    return sum([P['L_NOBJECT'] * no / bs, P['L_OBJECT'] * o / bs,
                P['L_COORD_ANCHOR'] * xy / bs])


def shape_net(params, in_channels, tilesize):
    """The net of a params.json's architecture with weights of the right
    shapes on the meta device (no values): for counting work."""
    conv_spec, fc_spec, act = architecture(params)
    e = lambda *s: torch.empty(s, device='meta')  # noqa: E731
    bnp = lambda c: {k: e(c) for k in ('scale', 'bias', 'mean', 'var')}  # noqa
    net = {'fc_spec': fc_spec, 'act': act, 'flatten': 'nchw',
           'S': (params['SX'], params['SY'])}
    c, h = in_channels, tilesize
    if conv_spec == 'resnet':
        net.update(kind='resnet', stem=(e(64, c, 3, 3), e(64)),
                   stem_bn=bnp(64), blocks=[])
        c, h = 64, (h + 4 - 3) // 2 + 1
        h = (h + 2 - 3) // 2 + 1
        for k, width in enumerate(RESNET_WIDTHS):
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
    else:
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
        net.update(kind='spec', convs=convs)
    d, fcs = c * h * h, []
    for element, param in fc_spec:
        if element == 'FC':
            fcs.append({'w': e(param, d), 'b': e(param)})
            d = param
    fcs.append({'w': e(params['SX'] * params['SY'] * 3, d),
                'b': e(params['SX'] * params['SY'] * 3)})
    net['fcs'] = fcs
    return net


def forward_flops(params, in_channels, tilesize):
    """Floating-point operations (2 a multiply-add of every convolution
    and linear layer) of one tile's forward at a params.json's
    architecture."""
    ops = Ops(count=True)
    forward(shape_net(params, in_channels, tilesize),
            torch.empty(1, in_channels, tilesize, tilesize, device='meta'),
            ops)
    return 2 * ops.macs
