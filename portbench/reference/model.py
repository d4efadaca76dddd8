"""The plain reference detector: the YOLO_AXTrack forward (and, in train
mode, its loss) in plain torch functions, from the published description
(LoaloaF/axtrack machinelearning/model.py and loss.py).

It imports nothing of the program. The net is a trunk, whose NCHW
features are flattened, then the FC head (``fc_spec``): the conv spec's
own FC spec, or the head the reference puts on every backbone.

Trunks live in ``trunks/<name>.py``, one file an architecture, found by
the name ``architecture(params)`` gives ('spec' for a conv spec list,
else params.json's ``ARCHITECTURE`` string); a name with no file is a
ValueError. Adding an architecture's reference adds its file, and this
module names none. A trunk file provides:

- ``from_state_dict(sd, params)``: the trunk's tensors from a state dict
  in the reference's PyTorch names (``ConvNet.*``), used as they are;
- ``shape_net(params, in_channels, tilesize)``: (the trunk with weights
  of the right shapes on the meta device, its output channels, its
  output side), for counting work;
- ``trunk(net, x, ops, train)``: the NCHW features of NCHW tiles x, every
  convolution through ``ops.conv`` (which counts its multiply-adds) and
  every BatchNorm through ``bn`` with the trunk's own eps and the dict of
  its tensors that ``from_state_dict`` put in the net (``bn_sd``: its
  'mean' the state dict's own ``running_mean``, by which ``calibrate.py``
  finds the layer's keys);
- optionally ``from_flax(tree, params)``: the trunk from flax variables.

Weights come in one of two published layouts, and this module reads the
head's part of each by its own rules:

- the flax variables of the repo's trained ``deployed_model/E0300``
  (``from_flax``): Dense kernels [in, out], and the conv features
  flattened in NHWC order, as flax flattens them;
- a state dict with the reference's PyTorch names (``from_state_dict``):
  ``fcs.{j}`` Linear layers; features flattened in NCHW order.

Precision: f32 with TF32 off (``exact``). ``precision='tf32'`` is the
control, the step below the configuration's precision: on a card the
convolutions and matmuls run with TF32 on; elsewhere their operands are
rounded to TF32 (10 mantissa bits, nearest even; gradients pass through
the rounding unchanged).
"""
import contextlib
import importlib
import os

import torch
import torch.nn.functional as F

# a trunk states its own BatchNorm eps; this is torch's default
BN_EPS = 1e-5
TRUNKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'trunks')
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

    def conv(self, x, w, b, stride, padding, groups=1):
        y = self._run(F.conv2d, x, w, b, stride, padding, 1, groups)
        if self.count:
            # w[0] is one output channel's fan-in: in / groups x k x k
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


def untuple(a):
    """params.json's {'__tuple__': [...]} as a list."""
    if isinstance(a, dict) and '__tuple__' in a:
        return [untuple(v) for v in a['__tuple__']]
    if isinstance(a, list):
        return [untuple(v) for v in a]
    return a


def architecture(params):
    """The trunk's name: 'spec' for a conv spec list, else params.json's
    ``ARCHITECTURE`` string itself."""
    arch = untuple(params['ARCHITECTURE'])
    return arch if isinstance(arch, str) else 'spec'


def fc_spec(params):
    """The FC head's spec: a conv spec architecture's own, else the head
    the reference puts on every backbone."""
    arch = untuple(params['ARCHITECTURE'])
    return BACKBONE_HEAD if isinstance(arch, str) else arch[1]


def trunk_module(name):
    """``trunks/<name>.py``, imported as ``portbench.reference.trunks.
    <name>``; a ValueError naming the file where there is none."""
    path = os.path.join(TRUNKS, f'{name}.py')
    if not (name.isidentifier() and os.path.isfile(path)):
        raise ValueError(f'ARCHITECTURE {name!r} has no reference trunk: '
                         f'no file {path}')
    return importlib.import_module(f'{__package__}.trunks.{name}')


def bn(x, p, train, eps=BN_EPS):
    """BatchNorm: batch statistics (biased variance) in train mode, the
    running ones otherwise; ``eps`` is the trunk's. Where ``p`` holds a
    list under 'batch' (``calibrate.py``), train mode normalises as eval
    mode does, with the batch's statistics in place of the running ones,
    and appends them to it as (mean, variance)."""
    if train and 'batch' not in p:
        return F.batch_norm(x, None, None, p['scale'], p['bias'], True, 0.0,
                            eps)
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        p['batch'].append((mean, var))
    else:
        mean, var = p['mean'], p['var']
    inv = p['scale'] / torch.sqrt(var + eps)
    return (x - mean[:, None, None]) * inv[:, None, None] \
        + p['bias'][:, None, None]


def bn_sd(sd, pre):
    """A BatchNorm's tensors from a state dict under the prefix ``pre``."""
    return {'scale': sd[f'{pre}.weight'], 'bias': sd[f'{pre}.bias'],
            'mean': sd[f'{pre}.running_mean'],
            'var': sd[f'{pre}.running_var']}


def _net(params, name, body, fcs, flatten):
    return {'arch': name, 'trunk': body, 'fcs': fcs,
            'fc_spec': fc_spec(params), 'flatten': flatten,
            'S': (params['SX'], params['SY'])}


def from_flax(tree, params):
    """The net from flax variables ({'params', 'batch_stats'}), for a trunk
    whose file reads them (``from_flax``); Dense kernels [in, out]."""
    name = architecture(params)
    body = trunk_module(name).from_flax(tree, params)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    prm = tree['params']
    n_fc = sum(1 for e, _ in fc_spec(params) if e == 'FC') + 1
    fcs = [{'w': f(prm[f'Dense_{m}']['kernel']).T.contiguous(),
            'b': f(prm[f'Dense_{m}']['bias'])} for m in range(n_fc)]
    return _net(params, name, body, fcs, 'nhwc')


def from_state_dict(sd, params):
    """The net from a state dict in the reference's PyTorch names (see the
    module docstring); the tensors are used as they are (no copy)."""
    name = architecture(params)
    body = trunk_module(name).from_state_dict(sd, params)
    # fcs: Flatten is 0, one module per FC spec element, the head last
    spec = fc_spec(params)
    idx = [1 + j for j, (e, _) in enumerate(spec) if e == 'FC']
    idx.append(1 + len(spec))
    fcs = [{'w': sd[f'fcs.{j}.weight'], 'b': sd[f'fcs.{j}.bias']}
           for j in idx]
    return _net(params, name, body, fcs, 'nchw')


def trunk(net, x, ops, train=False):
    """Conv features of NCHW tiles x."""
    return trunk_module(net['arch']).trunk(net['trunk'], x, ops, train)


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
    name = architecture(params)
    body, c, h = trunk_module(name).shape_net(params, in_channels, tilesize)
    e = lambda *s: torch.empty(s, device='meta')  # noqa: E731
    d, fcs = c * h * h, []
    for element, param in fc_spec(params):
        if element == 'FC':
            fcs.append({'w': e(param, d), 'b': e(param)})
            d = param
    fcs.append({'w': e(params['SX'] * params['SY'] * 3, d),
                'b': e(params['SX'] * params['SY'] * 3)})
    return _net(params, name, body, fcs, 'nchw')


def forward_flops(params, in_channels, tilesize):
    """Floating-point operations (2 a multiply-add of every convolution
    and linear layer) of one tile's forward at a params.json's
    architecture."""
    ops = Ops(count=True)
    forward(shape_net(params, in_channels, tilesize),
            torch.empty(1, in_channels, tilesize, tilesize, device='meta'),
            ops)
    return 2 * ops.macs
