"""YOLO_AXTrack detector as a ``torch.nn.Module``.

PyTorch counterpart of ``axtrack_tpu/models/yolo.py`` with the reference's
own layout (machinelearning/model.py:5-125): NCHW activations, a conv stack
built from the ARCHITECTURE spec under ``ConvNet.ConvBlock_{i}`` (conv with
padding 1, BatchNorm eps 1e-5, activation; 'M' is a 2x2 max-pool) or, for
an ARCHITECTURE string, a backbone stack as ``ConvNet``
(``models/backbones.py``), then ``fcs``: Flatten (NCHW order) ->
Linear/activation per the FC spec -> the Sy*Sx*3 head, reshaped to the
grid [N, Sx, Sy, 3].

In eval mode, with no autograd graph to record, a block whose conv computes
in f32 on a card runs its convolution without the bias and one hand-written
kernel for the bias, BatchNorm, leaky ReLU and the 2x2 max-pool that
follows it in the spec (``ConvSpecNet``, ``ops/epilogue_cuda.py``); the
modules, their names and the state dict stay as they are.

In train mode the BatchNorm layers update their running statistics as
flax does (momentum 0.9, the biased batch variance; ``FlaxBatchNorm2d``)
and dropout draws from an explicit generator (``SeededDropout``).

Compute dtypes follow the flax module's casts (``dtype``, ``fc_dtype``;
``axtrack_tpu/models/yolo.py:50-67,92-148``), not ``torch.autocast``: each
conv casts its input, weight and bias to ``dtype``, convolves and adds the
bias in ``dtype``; BatchNorm, the activation and the max-pool after it run
in f32; the flattened features are f32; each FC layer of the spec computes
in ``fc_dtype`` (None: ``dtype``) and is cast back to f32; the last layer
is always f32. Weights and the state dict stay f32.

``weights_from_jax`` carries the flax variables of ``axtrack_tpu`` across:
conv kernels HWIO -> OIHW, Dense kernels [in, out] -> [out, in], and FC1's
input rows permuted from the flax NHWC flatten order to this module's NCHW
order (the inverse of ``torch_convert._nchw_to_nhwc_flat_perm``). So the
state dict has the reference checkpoint's names and layout.
"""
import contextvars
import math

import numpy as np
import torch
import torch.nn as nn

from ..ops.epilogue_cuda import epilogue
from ..utils import exact_f32


def make_activation(spec):
    """Activation module from a framework-neutral spec ('sigmoid',
    ('leaky_relu', a), ...), as stored in params.json."""
    if isinstance(spec, (tuple, list)):
        name, *args = spec
    else:
        name, args = spec, ()
    name = name.lower()
    if name == 'leaky_relu':
        return nn.LeakyReLU(args[0] if args else 0.01)
    if name == 'sigmoid':
        return nn.Sigmoid()
    if name == 'relu':
        return nn.ReLU()
    if name == 'tanh':
        return nn.Tanh()
    raise ValueError(f'unknown activation {spec!r}')


# Set by a data row of a mesh step (``parallel/mesh.py``) to
# ``fn(bn, x)``: a train-mode BatchNorm then takes its statistics over
# every row of the step's batch.
BATCH_NORM_SYNC = contextvars.ContextVar('BATCH_NORM_SYNC', default=None)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d in f32 (its input is cast) whose train-mode update of
    the running statistics is flax's (``axtrack_tpu/models/yolo.py:67-68``):
    running = (1 - momentum) * running + momentum * batch statistic, with
    the *biased* batch variance (torch's own update uses the unbiased one).
    ``momentum`` is torch's: flax's is 1 minus it. Normalisation is
    unchanged: batch statistics in train mode, running ones in eval
    mode. Inside a mesh step the batch statistics are the whole batch's,
    across shards (``BATCH_NORM_SYNC``)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        x = x.float()
        if not self.training:
            return super().forward(x)
        sync = BATCH_NORM_SYNC.get()
        if sync is not None:
            return sync(self, x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return nn.functional.batch_norm(x, None, None, self.weight, self.bias,
                                        True, 0.0, self.eps)


class SeededDropout(nn.Module):
    """Dropout whose train-mode mask is drawn from a ``torch.Generator`` on
    the input's device, seeded with ``seed`` at its first use."""

    def __init__(self, p, seed=0):
        super().__init__()
        self.p, self.seed = float(p), int(seed)
        self._gen = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self._gen is None or self._gen.device != x.device:
            self._gen = torch.Generator(device=x.device).manual_seed(
                self.seed)
        keep = torch.rand(x.shape, generator=self._gen, device=x.device)
        return torch.where(keep >= self.p, x / (1.0 - self.p), 0.0)


class DtypeConv2d(nn.Conv2d):
    """nn.Conv2d computing in ``dtype`` as flax's ``nn.Conv(dtype=...)``:
    input and weight cast, the bias added in ``dtype`` after the
    convolution. The result stays in ``dtype``."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype == torch.float32:
            return super().forward(x)
        dt = self.dtype
        y = nn.functional.conv2d(x.to(dt), self.weight.to(dt), None,
                                 self.stride, self.padding, self.dilation,
                                 self.groups)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class CNNBlock(nn.Module):
    """Conv2d + BatchNorm + activation (reference model.py:5-18). The conv
    computes in ``dtype`` (``DtypeConv2d``); BatchNorm and the activation
    in f32."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, groups,
                 activation, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = DtypeConv2d(in_channels, out_channels, kernel_size,
                                stride, padding=1, groups=groups, bias=True,
                                dtype=dtype)
        self.batchnorm = FlaxBatchNorm2d(out_channels)
        self.activation = make_activation(activation)

    def forward(self, x):
        return self.activation(self.batchnorm(self.conv(x)))

    def fuses(self, x):
        """Whether ``ConvSpecNet`` runs this block on ``x`` as its
        convolution without the bias and one epilogue kernel: eval mode, an
        f32 conv, a leaky ReLU, a CUDA input, and grad mode off (the kernel
        has no backward)."""
        return (not self.training and self.dtype == torch.float32
                and x.is_cuda and isinstance(self.activation, nn.LeakyReLU)
                and not torch.is_grad_enabled())

    def fused(self, x, pool):
        """The block on ``x`` (``fuses``), followed by a 2x2 max-pool when
        ``pool``: the conv without its bias, then ``epilogue``."""
        conv, bn = self.conv, self.batchnorm
        y = conv._conv_forward(x, conv.weight, None)
        return epilogue(y, conv.bias, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var, bn.eps, self.activation.negative_slope,
                        pool)


class ConvSpecNet(nn.Sequential):
    """The conv-spec stack: ``ConvBlock_{i}`` a ``CNNBlock`` or, for 'M',
    an ``nn.MaxPool2d(2, 2)``. A block that ``fuses`` its input runs as
    its conv and one epilogue kernel, which also does the 2x2 max-pool
    right after the block (that module is then skipped); every other
    layer runs its modules as ``nn.Sequential`` does."""

    def forward(self, x):
        layers = list(self)
        i = 0
        while i < len(layers):
            layer = layers[i]
            if isinstance(layer, CNNBlock) and layer.fuses(x):
                pool = (i + 1 < len(layers)
                        and isinstance(layers[i + 1], nn.MaxPool2d))
                x = layer.fused(x, pool)
                i += 2 if pool else 1
            else:
                x = layer(x)
                i += 1
        return x


def dtype_linear(x, weight, bias, dtype):
    """flax's ``nn.Dense(dtype=...)`` followed by ``astype(f32)`` with
    torch's [out, in] weight: input and weight cast to ``dtype``, the bias
    cast and added after the product, the result f32 (in f32, one
    ``linear``). A layer split along its input features gives ``x`` and
    ``weight`` as lists of blocks (``parallel/mesh.py``): their products
    are summed in block order on the first block's device, then the bias
    is added."""
    if isinstance(x, torch.Tensor):
        if dtype == torch.float32:
            return nn.functional.linear(x, weight, bias)
        x, weight = [x], [weight]
    y = None
    for xi, wi in zip(x, weight):
        part = nn.functional.linear(xi.to(dtype), wi.to(xi.device, dtype))
        y = part if y is None else y + part.to(y.device)
    return (y + bias.to(y.device, dtype)).float()


class DtypeLinear(nn.Linear):
    """nn.Linear computing in ``dtype`` with an f32 result
    (``dtype_linear``)."""

    def __init__(self, in_features, out_features, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        return dtype_linear(x, self.weight, self.bias, self.dtype)


# the FC head of a backbone architecture (axtrack_tpu/models/yolo.py:102-107)
BACKBONE_HEAD = [('FC', 1024), ('activation', 'sigmoid'), ('FC', 1024),
                 ('activation', 'sigmoid')]


def split_architecture(architecture):
    """(conv spec or backbone name, FC spec) of an ARCHITECTURE value."""
    if isinstance(architecture, str):
        return architecture, BACKBONE_HEAD
    return architecture[0], architecture[1]


def conv_shapes(conv_spec, tilesize):
    """(C, H, W) of each layer's output in the conv stack: a conv spec
    (padding 1 throughout; 'M' a 2x2 max-pool) or a backbone name."""
    if isinstance(conv_spec, str):
        from .backbones import BACKBONES
        return [(c, h, h) for c, h in BACKBONES[conv_spec].shapes(tilesize)]
    h = w = tilesize
    c = None
    out = []
    for layer in conv_spec:
        if layer == 'M':
            h //= 2
            w //= 2
        else:
            k, c, stride, _ = layer
            h = (h + 2 - k) // stride + 1
            w = (w + 2 - k) // stride + 1
        out.append((c, h, w))
    return out


def conv_out_shape(conv_spec, tilesize):
    """(C, H, W) of the conv stack output (``conv_shapes``' last)."""
    return conv_shapes(conv_spec, tilesize)[-1]


class YOLOAxTrack(nn.Module):
    """The growth-cone detector. Input f32[N, C, ts, ts]; output the grid
    f32[N, Sx, Sy, 3] (dim 1 is the x grid cell, model.py:123).

    ``architecture`` is a [conv spec, FC spec] pair or a backbone name
    ('mobilenet', 'alexnet', 'resnet'; ``models/backbones.py``), which
    takes the ``BACKBONE_HEAD``. ``ConvNet`` gives the features either
    way."""

    def __init__(self, architecture, activation=('leaky_relu', 0.1),
                 tilesize=512, Sy=12, Sx=12, in_channels=5, seed=0,
                 dtype=torch.float32, fc_dtype=None):
        super().__init__()
        self.dtype, self.fc_dtype = dtype, fc_dtype
        conv_spec, fc_spec = split_architecture(architecture)
        self.Sy, self.Sx, self.tilesize = Sy, Sx, tilesize
        self.in_channels, self.conv_spec = in_channels, conv_spec
        if isinstance(conv_spec, str):
            from .backbones import BACKBONES
            if conv_spec not in BACKBONES:
                raise ValueError(f'unknown backbone {conv_spec!r}')
            self.ConvNet = BACKBONES[conv_spec](in_channels, dtype)
        else:
            self.ConvNet = ConvSpecNet()
            c = in_channels
            for i, layer in enumerate(conv_spec):
                if layer == 'M':
                    self.ConvNet.add_module(f'ConvBlock_{i}',
                                            nn.MaxPool2d(2, 2))
                else:
                    k, out_c, stride, groups = layer
                    self.ConvNet.add_module(f'ConvBlock_{i}', CNNBlock(
                        c, out_c, k, stride, groups, activation, dtype))
                    c = out_c
        C, H, W = conv_out_shape(conv_spec, tilesize)
        self.fcs = nn.Sequential(nn.Flatten())
        d = C * H * W
        head_dtype = dtype if fc_dtype is None else fc_dtype
        for j, (element_type, param) in enumerate(fc_spec):
            if element_type == 'FC':
                self.fcs.append(DtypeLinear(d, param, head_dtype))
                d = param
            elif element_type == 'dropout':
                self.fcs.append(SeededDropout(param, seed=seed + j))
            elif element_type == 'activation':
                self.fcs.append(make_activation(param))
            else:
                raise ValueError(f'unknown FC element {element_type!r}')
        self.fcs.append(nn.Linear(d, Sy * Sx * 3))

    def forward(self, x):
        pred = self.fcs(self.ConvNet(x).float())
        return pred.reshape(pred.shape[0], self.Sx, self.Sy, 3)

    def tile_floats(self):
        """About the most elements one tile's ``ConvNet`` forward holds at
        once: its input and three copies of the largest layer output (a
        layer's input and output, and a cast or normalised copy)."""
        largest = max(c * h * w for c, h, w in
                      conv_shapes(self.conv_spec, self.tilesize))
        return self.in_channels * self.tilesize ** 2 + 3 * largest


def initial_in_channels(params):
    """Input channel count from motion mode + temporal context."""
    per_frame = {'include': 3, 'only': 2,
                 'exclude': 1}[params['USE_MOTION_DATA']]
    return per_frame * (params['TEMPORAL_CONTEXT'] * 2 + 1)


def build_model(params, dtype=torch.float32, fc_dtype=None):
    """The detector of ``params``; ``dtype``/``fc_dtype`` as the JAX
    package's ``build_model`` (fc_dtype None follows dtype)."""
    return YOLOAxTrack(params['ARCHITECTURE'],
                       activation=params['ACTIVATION_FUNCTION'],
                       tilesize=params['TILESIZE'], Sy=params['SY'],
                       Sx=params['SX'],
                       in_channels=initial_in_channels(params),
                       seed=params.get('SEED', 0), dtype=dtype,
                       fc_dtype=fc_dtype)


@torch.no_grad()
def detect_axons(model, X):
    """Eval-mode batched tile inference (``axtrack_tpu``'s
    ``detect_axons``, reference model.py:119-125) with TF32 off on a card:
    X f32[ntiles, C, ts, ts] NCHW on the model's device. Returns the grid
    f32[ntiles, Sx, Sy, 3]; the model's train/eval mode is restored."""
    training = model.training
    model.eval()
    try:
        with exact_f32():
            return model(X)
    finally:
        model.train(training)


@torch.no_grad()
def init_weights(model, generator):
    """Seeded initialisation with PyTorch's default distributions
    (uniform +-1/sqrt(fan_in) for conv and linear weights and biases; BN at
    identity), drawn from ``generator`` on the CPU so a seed gives the same
    weights on every device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            for p in (m.weight, m.bias):
                if p is None:               # a conv followed by BatchNorm
                    continue
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                      generator=generator))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def _nchw_to_nhwc_flat_perm(C, H, W):
    """perm such that flax_rows[perm] receive torch rows: for flax flat
    index f = h*W*C + w*C + c, perm[f] = c*H*W + h*W + w."""
    hh, ww, cc = np.meshgrid(np.arange(H), np.arange(W), np.arange(C),
                             indexing='ij')
    return (cc * H * W + hh * W + ww).reshape(-1)


def _backbone_from_jax(prm, stats, which, in_channels):
    """State dict (keys relative to ``ConvNet``) of the backbone ``which``
    from the flax 'backbone' subtrees ``prm`` and ``stats``."""
    from .backbones import BACKBONES, flax_path
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree
    with torch.device('meta'):
        stack = BACKBONES[which](in_channels)
    sd = {}
    for name, m in stack.named_modules():
        if isinstance(m, nn.Conv2d):
            p = at(prm, flax_path(stack, name))
            sd[f'{name}.weight'] = f32(np.transpose(p['kernel'],
                                                    (3, 2, 0, 1)))
            if m.bias is not None:
                sd[f'{name}.bias'] = f32(p['bias'])
        elif isinstance(m, nn.BatchNorm2d):
            p, s = (at(t, flax_path(stack, name)) for t in (prm, stats))
            sd[f'{name}.weight'] = f32(p['scale'])
            sd[f'{name}.bias'] = f32(p['bias'])
            sd[f'{name}.running_mean'] = f32(s['mean'])
            sd[f'{name}.running_var'] = f32(s['var'])
            sd[f'{name}.num_batches_tracked'] = torch.tensor(0)
    return sd


def _conv_spec_from_jax(prm, stats, conv_spec):
    """State dict of a conv-spec ``ConvNet`` from the flax 'CNNBlock_k'
    subtrees."""
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd = {}
    k = 0
    for i, layer in enumerate(conv_spec):
        if layer == 'M':
            continue
        blk, pre = prm[f'CNNBlock_{k}'], f'ConvNet.ConvBlock_{i}'
        sd[f'{pre}.conv.weight'] = f32(
            np.transpose(blk['Conv_0']['kernel'], (3, 2, 0, 1)))
        sd[f'{pre}.conv.bias'] = f32(blk['Conv_0']['bias'])
        sd[f'{pre}.batchnorm.weight'] = f32(blk['BatchNorm_0']['scale'])
        sd[f'{pre}.batchnorm.bias'] = f32(blk['BatchNorm_0']['bias'])
        bs = stats[f'CNNBlock_{k}']['BatchNorm_0']
        sd[f'{pre}.batchnorm.running_mean'] = f32(bs['mean'])
        sd[f'{pre}.batchnorm.running_var'] = f32(bs['var'])
        sd[f'{pre}.batchnorm.num_batches_tracked'] = torch.tensor(0)
        k += 1
    return sd


def weights_from_jax(variables_np, params):
    """State dict for ``build_model(params)`` from ``axtrack_tpu``'s flax
    variables given as a tree of numpy arrays
    ({'params': {'CNNBlock_k' or 'backbone': ..., 'Dense_m': ...},
    'batch_stats': ...}).
    """
    prm = variables_np['params']
    stats = variables_np.get('batch_stats', {})
    conv_spec, fc_spec = split_architecture(params['ARCHITECTURE'])
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    if isinstance(conv_spec, str):
        backbone = _backbone_from_jax(prm['backbone'],
                                      stats.get('backbone', {}), conv_spec,
                                      initial_in_channels(params))
        sd = {f'ConvNet.{k}': v for k, v in backbone.items()}
    else:
        sd = _conv_spec_from_jax(prm, stats, conv_spec)
    # fcs indices of the Linears: Flatten is 0, then one module per fc_spec
    # element, the head appended last (model.py:105-117)
    linears = [1 + j for j, (et, _) in enumerate(fc_spec) if et == 'FC']
    linears.append(1 + len(fc_spec))
    C, H, W = conv_out_shape(conv_spec, params['TILESIZE'])
    for m, j in enumerate(linears):
        kernel = np.asarray(prm[f'Dense_{m}']['kernel'], np.float32)
        weight = kernel.T                                   # [out, in]
        if m == 0:
            if weight.shape[1] != C * H * W:
                raise ValueError(f'FC1 takes {weight.shape[1]} inputs, the '
                                 f'conv stack gives {(C, H, W)}')
            nchw = np.empty_like(weight)
            nchw[:, _nchw_to_nhwc_flat_perm(C, H, W)] = weight
            weight = nchw
        sd[f'fcs.{j}.weight'] = f32(weight)
        sd[f'fcs.{j}.bias'] = f32(prm[f'Dense_{m}']['bias'])
    return sd
