"""Model summaries.

PyTorch counterpart of ``axtrack_tpu/models/summary.py`` (the reference's
torchsummary use and print_torchvision_models, utils.py:290-308):
parameter counts per top-level module and the output shape of a
detector, and the same for each built-in architecture.
"""
import torch

from ..params import get_default_parameters
from .yolo import build_model, init_weights, initial_in_channels


@torch.no_grad()
def model_summary(model, input_shape):
    """Parameter counts per top-level module ('ConvNet', 'fcs'), the
    total, and the output shape of an eval-mode forward of one input of
    ``input_shape`` (C, H, W), as text."""
    lines = [f'{"layer":36} {"params":>12}']
    total = 0
    for name, module in model.named_children():
        n = sum(p.numel() for p in module.parameters())
        lines.append(f'{name:36} {n:12,}')
        total += n
    lines.append(f'{"TOTAL":36} {total:12,}')
    p = next(model.parameters())
    x = torch.zeros((1, *input_shape), device=p.device)
    training = model.training
    try:
        out = model.eval()(x)
    finally:
        model.train(training)
    lines.append(f'input {tuple(x.shape)} -> output {tuple(out.shape)}')
    return '\n'.join(lines)


def print_backbone_models(params=None, tilesize=None):
    """Summaries of the backbone stacks and the ARCHITECTURE spec of
    ``params`` (default: the default parameters), with seeded weights."""
    P = dict(params or get_default_parameters())
    if tilesize:
        P['TILESIZE'] = tilesize
    c = initial_in_channels(P)
    for arch in ('alexnet', 'mobilenet', 'resnet', None):
        P2 = dict(P)
        if arch is not None:
            P2['ARCHITECTURE'] = arch
        print(f'\n=== {arch or "default (ARCHITECTURE spec)"} ===')
        model = init_weights(build_model(P2),
                             torch.Generator().manual_seed(0))
        print(model_summary(model, (c, P2['TILESIZE'], P2['TILESIZE'])))
