"""The reference's torch checkpoints and torchvision weights.

PyTorch counterpart of ``axtrack_tpu/models/torch_convert.py``. The
reference saves ``E{epoch}.pth`` files holding ``{"state_dict": ...,
"optimizer": ..., "lr_schedular": ...}`` (reference utils.py:258-263),
whose state dict has the reference model's keys, and the port's
``YOLOAxTrack`` has the same keys: ``ConvNet.ConvBlock_{i}...`` and
``fcs.{j}...`` for a conv spec, ``ConvNet.block_{i}...`` for a backbone
(``models/backbones.py``). A file is read with ``torch.load(...,
weights_only=True)``: it is content from outside, so no pickled code runs.
The optimizer and scheduler states are not read (the JAX package drops
them too).

``load_backbone_state_dict`` is the reference's ``_from_pretrained``
splice: a raw torchvision state dict (``features.{i}...``, or resnet18's
``conv1``/``bn1``/``layer{k}``) loads into every shape-compatible layer of
a backbone, the replaced stem and the FC head keep their weights.
"""
import torch


def normalize_backbone_keys(state_dict, which):
    """Keys as 'block_{i}.<tail>' (a reference checkpoint's 'ConvNet.'
    dropped, torchvision's 'features.{i}' and resnet's conv1 / bn1 /
    layer{n} renamed); 'fcs.*' and other keys pass through."""
    out = {}
    for k, v in state_dict.items():
        k2 = k[len('ConvNet.'):] if k.startswith('ConvNet.') else k
        if k2.startswith('features.'):
            i, _, tail = k2[len('features.'):].partition('.')
            k2 = f'block_{i}.{tail}'
        elif which == 'resnet':
            if k2.startswith('conv1.'):
                k2 = 'block_0.' + k2[len('conv1.'):]
            elif k2.startswith('bn1.'):
                k2 = 'block_1.' + k2[len('bn1.'):]
            elif k2.startswith('layer'):
                n, _, tail = k2[len('layer'):].partition('.')
                k2 = f'block_{3 + int(n)}.{tail}'
        out[k2] = v
    return out


def load_torch_checkpoint(path, P):
    """The state dict for ``build_model(P)`` from a reference ``.pth``
    file: the wrapped dict ({'state_dict', 'optimizer', 'lr_schedular'})
    or a bare state dict. A BatchNorm's ``num_batches_tracked``, absent
    from some files, is set to 0 (a counter the model does not read)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt.get('state_dict', ckpt)
    if isinstance(P['ARCHITECTURE'], str):
        sd = {(k if k.startswith('fcs.') else f'ConvNet.{k}'): v for k, v in
              normalize_backbone_keys(sd, P['ARCHITECTURE']).items()}
    sd = dict(sd)
    for k in list(sd):
        if k.endswith('.running_mean'):
            sd.setdefault(k[:-len('running_mean')] + 'num_batches_tracked',
                          torch.tensor(0))
    return sd


@torch.no_grad()
def load_backbone_state_dict(model, state_dict, which):
    """Loads a raw torchvision state dict of the backbone ``which`` into
    ``model.ConvNet`` wherever a layer's key and shape match (the
    reference's ``_from_pretrained``, model.py:55-83). The replaced stem
    (3 input channels in torchvision) and the FC head keep their weights,
    as do the BatchNorm counters.

    Returns (loaded, skipped): the model's state-dict keys that took a
    pretrained value, and those left as they were."""
    sd = normalize_backbone_keys(state_dict, which)
    loaded, skipped = [], []
    for k, v in model.ConvNet.state_dict().items():
        if k.endswith('num_batches_tracked'):
            continue
        if k in sd and sd[k].shape == v.shape:
            v.copy_(sd[k])
            loaded.append(f'ConvNet.{k}')
        else:
            skipped.append(f'ConvNet.{k}')
    return loaded, skipped
