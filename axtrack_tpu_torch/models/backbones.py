"""The backbone feature stacks: the reference-modified torchvision models.

PyTorch counterpart of ``axtrack_tpu/models/backbones.py``. With
ARCHITECTURE 'mobilenet', 'alexnet' or 'resnet' the reference
(machinelearning/model.py:55-83) puts a torchvision feature extractor in
front of its FC head, with edits that change the computation:

- the first module is replaced by a biased ``Conv2d(in_c, out_c, 3,
  stride 2)``: 16 channels with padding 1 (mobilenet, which so loses the
  stem's BatchNorm and Hardswish), 64 with padding 2 (alexnet, resnet;
  resnet's ``bn1`` after it stays);
- on alexnet ``features[3]`` (the 5x5 conv) takes stride 2 and
  ``features[6]`` (a 3x3 conv) padding 2.

The reference's same assignments on the other stacks only store unused
attributes, so they are left out. Layers are NCHW ``nn.Module``s named so
that the state dict has the reference checkpoint's keys (``block_{i}``
for ``features[i]`` or resnet's i-th child, torchvision's names below
it), and torchvision's own keys map onto them through
``torch_convert.normalize_backbone_keys``.

Compute dtypes follow the flax modules' casts (``models/yolo.py``'s
rule): convolutions compute in ``dtype`` (``DtypeConv2d``), BatchNorm and
what follows it in f32; the squeeze-excite branch runs in f32 and scales
in its input's dtype; alexnet's ReLU and max-pool run in the conv's
dtype. BatchNorm updates its running statistics as flax does
(``FlaxBatchNorm2d``): mobilenet's with eps 1e-3 and flax momentum 0.99
(torch momentum 0.01), resnet's with 1e-5 and 0.9 (0.1).
"""
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .yolo import DtypeConv2d, FlaxBatchNorm2d


def hardswish(x):
    """torch F.hardswish: x * relu6(x + 3) / 6."""
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


def hardsigmoid(x):
    """torch F.hardsigmoid: relu6(x + 3) / 6."""
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


def _make_divisible(v, divisor=8):
    """torchvision.models._utils._make_divisible (channel rounding)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_out(h, k, s, p):
    return (h + 2 * p - k) // s + 1


_ACTS = {'relu': F.relu, 'hardswish': hardswish, None: lambda x: x}
# mobilenet's BatchNorm: eps 1e-3, flax momentum 0.99
_MOBILENET_BN = dict(eps=1e-3, momentum=0.01)


class _Stack(nn.Sequential):
    """A backbone: ``shapes(tilesize)`` lists (channels, side) of each
    layer's output on a square tile, in order; the last is ``out_hw``."""

    @classmethod
    def out_hw(cls, tilesize):
        c, h = cls.shapes(tilesize)[-1]
        return h, h, c


class ConvNormAct(nn.Sequential):
    """torchvision Conv2dNormActivation: bias-free conv ('0'), BatchNorm
    ('1'), activation. The conv computes in ``dtype``, the rest in f32."""

    def __init__(self, in_c, out_c, kernel, stride=1, groups=1, act='relu',
                 eps=1e-5, momentum=0.1, dtype=torch.float32):
        p = (kernel - 1) // 2                 # torchvision's padding
        super().__init__(
            DtypeConv2d(in_c, out_c, kernel, stride, p, groups=groups,
                        bias=False, dtype=dtype),
            FlaxBatchNorm2d(out_c, eps=eps, momentum=momentum))
        self.act = act

    def forward(self, x):
        return _ACTS[self.act](self[1](self[0](x)))


class SqueezeExcite(nn.Module):
    """torchvision SqueezeExcitation: average -> fc1 (1x1, biased) -> ReLU
    -> fc2 -> Hardsigmoid -> channel scale, in f32; the scale is cast to
    the input's dtype."""

    def __init__(self, c, squeeze_c):
        super().__init__()
        self.fc1 = nn.Conv2d(c, squeeze_c, 1)
        self.fc2 = nn.Conv2d(squeeze_c, c, 1)

    def forward(self, x):
        s = x.float().mean((2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * hardsigmoid(s).to(x.dtype)


class InvertedResidual(nn.Module):
    """torchvision mobilenetv3 InvertedResidual (dilation 1): ``block`` is
    [expand (absent when exp_c == in_c), dw, se (when use_se), project];
    ``parts`` names them as the flax module does."""

    def __init__(self, in_c, kernel, exp_c, out_c, use_se, act, stride,
                 dtype=torch.float32):
        super().__init__()
        layers, self.parts = [], []
        if exp_c != in_c:
            layers.append(ConvNormAct(in_c, exp_c, 1, act=act, dtype=dtype,
                                      **_MOBILENET_BN))
            self.parts.append('expand')
        layers.append(ConvNormAct(exp_c, exp_c, kernel, stride,
                                  groups=exp_c, act=act, dtype=dtype,
                                  **_MOBILENET_BN))
        self.parts.append('dw')
        if use_se:
            layers.append(SqueezeExcite(exp_c,
                                        _make_divisible(exp_c // 4, 8)))
            self.parts.append('se')
        layers.append(ConvNormAct(exp_c, out_c, 1, act=None, dtype=dtype,
                                  **_MOBILENET_BN))
        self.parts.append('project')
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and in_c == out_c

    def forward(self, x):
        h = self.block(x)
        return h + x if self.use_res else h


# mobilenet_v3_small bneck table (torchvision _mobilenet_v3_conf):
# (in_c, kernel, expanded_c, out_c, use_se, activation, stride)
MOBILENET_V3_SMALL_CONF = [
    (16, 3, 16, 16, True, 'relu', 2),
    (16, 3, 72, 24, False, 'relu', 2),
    (24, 3, 88, 24, False, 'relu', 1),
    (24, 5, 96, 40, True, 'hardswish', 2),
    (40, 5, 240, 40, True, 'hardswish', 1),
    (40, 5, 240, 40, True, 'hardswish', 1),
    (40, 5, 120, 48, True, 'hardswish', 1),
    (48, 5, 144, 48, True, 'hardswish', 1),
    (48, 5, 288, 96, True, 'hardswish', 2),
    (96, 5, 576, 96, True, 'hardswish', 1),
    (96, 5, 576, 96, True, 'hardswish', 1),
]


class MobileNetV3SmallFeatures(_Stack):
    """mobilenet_v3_small().features with the stem replaced by a bare
    biased Conv2d(in_c, 16, 3, stride 2, padding 1): ``block_0``, then the
    11 InvertedResiduals and the 96 -> 576 ConvNormAct (``block_12``)."""

    def __init__(self, in_c, dtype=torch.float32):
        layers = [('block_0', DtypeConv2d(in_c, 16, 3, 2, 1, dtype=dtype))]
        layers += [(f'block_{i + 1}', InvertedResidual(*cfg, dtype=dtype))
                   for i, cfg in enumerate(MOBILENET_V3_SMALL_CONF)]
        layers.append(('block_12', ConvNormAct(96, 576, 1, act='hardswish',
                                               dtype=dtype,
                                               **_MOBILENET_BN)))
        super().__init__(OrderedDict(layers))

    @staticmethod
    def shapes(tilesize):
        h = _conv_out(tilesize, 3, 2, 1)              # stem
        out = [(16, h)]
        for (in_c, k, exp_c, out_c, _, _, s) in MOBILENET_V3_SMALL_CONF:
            if exp_c != in_c:
                out.append((exp_c, h))                # expand
            h = _conv_out(h, k, s, (k - 1) // 2)
            out += [(exp_c, h), (out_c, h)]           # dw, project
        return out + [(576, h)]


class AlexNetFeatures(_Stack):
    """alexnet().features with the reference's three edits: block_0
    Conv(in, 64, 3, s2, p2), block_3 Conv(64, 192, 5, s2, p2), block_6
    Conv(192, 384, 3, p2), block_8/10 Conv 3x3 p1, max-pools 3/2. ReLU and
    max-pool run in the conv's dtype, as the flax module's do."""

    def __init__(self, in_c, dtype=torch.float32):
        def conv(i, o, k, s, p):
            return DtypeConv2d(i, o, k, s, p, dtype=dtype)
        super().__init__(OrderedDict([
            ('block_0', conv(in_c, 64, 3, 2, 2)), ('block_1', nn.ReLU()),
            ('block_2', nn.MaxPool2d(3, 2)),
            ('block_3', conv(64, 192, 5, 2, 2)), ('block_4', nn.ReLU()),
            ('block_5', nn.MaxPool2d(3, 2)),
            ('block_6', conv(192, 384, 3, 1, 2)), ('block_7', nn.ReLU()),
            ('block_8', conv(384, 256, 3, 1, 1)), ('block_9', nn.ReLU()),
            ('block_10', conv(256, 256, 3, 1, 1)), ('block_11', nn.ReLU()),
            ('block_12', nn.MaxPool2d(3, 2))]))

    @staticmethod
    def shapes(tilesize):
        out, h = [], tilesize
        for c, k, s, p in ((64, 3, 2, 2), (64, 3, 2, 0), (192, 5, 2, 2),
                           (192, 3, 2, 0), (384, 3, 1, 2), (256, 3, 1, 1),
                           (256, 3, 1, 1), (256, 3, 2, 0)):
            h = _conv_out(h, k, s, p)                 # conv or max-pool
            out.append((c, h))
        return out


class BasicBlock(nn.Module):
    """torchvision resnet BasicBlock: conv1/bn1/ReLU/conv2/bn2 plus the
    identity, or ``downsample`` (1x1 conv + BN) where the block changes
    stride and width."""

    def __init__(self, in_c, out_c, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = DtypeConv2d(in_c, out_c, 3, stride, 1, bias=False,
                                 dtype=dtype)
        self.bn1 = FlaxBatchNorm2d(out_c)
        self.conv2 = DtypeConv2d(out_c, out_c, 3, 1, 1, bias=False,
                                 dtype=dtype)
        self.bn2 = FlaxBatchNorm2d(out_c)
        self.downsample = None
        if stride != 1 or in_c != out_c:
            self.downsample = nn.Sequential(
                DtypeConv2d(in_c, out_c, 1, stride, 0, bias=False,
                            dtype=dtype),
                FlaxBatchNorm2d(out_c))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet18Features(_Stack):
    """[conv1, bn1, relu, maxpool, layer1..layer4] of resnet18() with
    conv1 replaced by a biased 3x3 stride-2 padding-2 conv: block_0
    (conv1), block_1 (bn1), block_{4+k} (layer{k+1}, two BasicBlocks)."""

    def __init__(self, in_c, dtype=torch.float32):
        layers = [('block_0', DtypeConv2d(in_c, 64, 3, 2, 2, dtype=dtype)),
                  ('block_1', FlaxBatchNorm2d(64)), ('block_2', nn.ReLU()),
                  ('block_3', nn.MaxPool2d(3, 2, 1))]
        c = 64
        for k, width in enumerate((64, 128, 256, 512)):
            stride = 2 if k > 0 else 1
            layers.append((f'block_{4 + k}', nn.Sequential(
                BasicBlock(c, width, stride, dtype),
                BasicBlock(width, width, 1, dtype))))
            c = width
        super().__init__(OrderedDict(layers))

    @staticmethod
    def shapes(tilesize):
        h = _conv_out(tilesize, 3, 2, 2)              # conv1
        out = [(64, h)]
        h = _conv_out(h, 3, 2, 1)                     # maxpool
        out.append((64, h))
        for k, width in enumerate((64, 128, 256, 512)):
            if k:                                     # layer2..4 stride 2
                h = _conv_out(h, 3, 2, 1)
            out.append((width, h))
        return out


BACKBONES = {
    'mobilenet': MobileNetV3SmallFeatures,
    'alexnet': AlexNetFeatures,
    'resnet': ResNet18Features,
}


def flax_path(stack, name):
    """The flax path (under the detector's 'backbone') of the conv, BN or
    squeeze-excite layer ``name`` (a module name of ``stack``)."""
    parts = name.split('.')
    if isinstance(stack, ResNet18Features) and len(parts) > 1:
        # block_{4+k}.{j}.(conv1|bn1|conv2|bn2|downsample.0|downsample.1)
        leaf = {'downsample.0': 'ds_conv', 'downsample.1': 'ds_bn'}.get(
            '.'.join(parts[2:]), parts[2])
        return (f'{parts[0]}_{parts[1]}', leaf)
    if isinstance(stack, MobileNetV3SmallFeatures) and len(parts) > 1:
        cna = {'0': 'conv', '1': 'bn'}
        if parts[1] == 'block':       # block_i.block.j.(0|1|fc1|fc2)
            part = getattr(stack, parts[0]).parts[int(parts[2])]
            return (parts[0], part, cna.get(parts[3], parts[3]))
        return (parts[0], cna[parts[1]])               # block_12.(0|1)
    return (parts[0],)
