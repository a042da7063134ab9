"""2D segmentation UNet in PyTorch (NCHW).

The counterpart of `spcl_tpu/models/unet.py` on its default `nhwc` path,
with the module names of the reference torch UNet
(reference semi_seg/arch/unet.py:100-297), so its state_dict keys are the
reference's (`_Conv1.conv.0.weight`, `_Up5.up.1.weight`, ...):

- ConvBlock `_ConvK.conv`: (conv3x3 -> BN -> ReLU) x 2, bias-free convs;
- UpConv `_UpK.up`: nearest-upsample x2 -> conv3x3 -> BN -> ReLU;
- `_Deconv_1x1`: 1x1 conv with bias, f32 logits.

`forward` returns a `{stage: activation}` dict (logits also under
"logits") and stops after `until`. Every stage exists in the module whatever
`until` is, so a checkpoint always holds the full state_dict; stages past
`until` are frozen by the trainer (models/masking.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .norm import batch_norm

ENCODER_NAMES: Tuple[str, ...] = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
DECODER_NAMES: Tuple[str, ...] = ("Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3",
                                  "Up2", "Up_conv2", "Deconv_1x1")
ARCH_ELEMENTS: Tuple[str, ...] = ENCODER_NAMES + DECODER_NAMES

# stages that produce returnable feature maps (reference `layer_dimension`)
LAYER_DIMENSION = {"Conv1": 1, "Conv2": 2, "Conv3": 4, "Conv4": 8, "Conv5": 16,
                   "Up_conv5": 8, "Up_conv4": 4, "Up_conv3": 2, "Up_conv2": 1,
                   "Deconv_1x1": None}


def arch_order(name: str) -> int:
    return ARCH_ELEMENTS.index(name)


def sort_arch(names: Sequence[str], reverse: bool = False) -> List[str]:
    return sorted(names, key=arch_order, reverse=reverse)


def get_channel_dim(layer_name: str, *, max_channel: int = 256, num_classes: int = None) -> int:
    if layer_name == "Deconv_1x1":
        if num_classes is None:
            raise ValueError("num_classes required for Deconv_1x1")
        return num_classes
    return int(LAYER_DIMENSION[layer_name] / 16 * max_channel)


def stages_up_to(until: Optional[str]) -> Tuple[str, ...]:
    """All computable stages up to and including `until` (None = all)."""
    if until is None:
        return tuple(LAYER_DIMENSION.keys())
    if until not in LAYER_DIMENSION:
        raise KeyError(f"`until` should be one of {list(LAYER_DIMENSION)}, got {until}")
    keys = list(LAYER_DIMENSION.keys())
    return tuple(keys[: keys.index(until) + 1])


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, momentum: float = 0.1):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            batch_norm(out_ch, momentum), nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
            batch_norm(out_ch, momentum), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.conv(x)


class UpConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, momentum: float = 0.1):
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            batch_norm(out_ch, momentum), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.up(x)


class UNet(nn.Module):
    """5-stage encoder / 4-stage decoder UNet with named-stage outputs."""

    def __init__(self, input_dim: int = 1, num_classes: int = 4, max_channel: int = 256,
                 momentum: float = 0.1):
        super().__init__()
        if max_channel % 16:
            raise ValueError(f"max_channel must be a multiple of 16, got {max_channel}")
        self.input_dim = int(input_dim)
        self.num_classes = int(num_classes)
        self.max_channel = int(max_channel)
        ch = {name: self.channel_dim(name) for name in LAYER_DIMENSION}
        self._Conv1 = ConvBlock(input_dim, ch["Conv1"], momentum)
        self._Conv2 = ConvBlock(ch["Conv1"], ch["Conv2"], momentum)
        self._Conv3 = ConvBlock(ch["Conv2"], ch["Conv3"], momentum)
        self._Conv4 = ConvBlock(ch["Conv3"], ch["Conv4"], momentum)
        self._Conv5 = ConvBlock(ch["Conv4"], ch["Conv5"], momentum)
        self._Up5 = UpConv(ch["Conv5"], ch["Up_conv5"], momentum)
        self._Up_conv5 = ConvBlock(2 * ch["Up_conv5"], ch["Up_conv5"], momentum)
        self._Up4 = UpConv(ch["Up_conv5"], ch["Up_conv4"], momentum)
        self._Up_conv4 = ConvBlock(2 * ch["Up_conv4"], ch["Up_conv4"], momentum)
        self._Up3 = UpConv(ch["Up_conv4"], ch["Up_conv3"], momentum)
        self._Up_conv3 = ConvBlock(2 * ch["Up_conv3"], ch["Up_conv3"], momentum)
        self._Up2 = UpConv(ch["Up_conv3"], ch["Up_conv2"], momentum)
        self._Up_conv2 = ConvBlock(2 * ch["Up_conv2"], ch["Up_conv2"], momentum)
        self._Deconv_1x1 = nn.Conv2d(ch["Up_conv2"], num_classes, 1)
        self._pool = nn.MaxPool2d(2, 2)

    def channel_dim(self, name: str) -> int:
        return get_channel_dim(name, max_channel=self.max_channel, num_classes=self.num_classes)

    def stage(self, name: str) -> nn.Module:
        """The submodule of a stage name (`Conv1` -> `_Conv1`)."""
        return getattr(self, f"_{name}")

    def forward(self, x: torch.Tensor, until: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Run the net on NCHW `x`, returning `{stage: activation}` for every
        computed stage; stops after `until`. The final logits live under both
        "Deconv_1x1" and "logits"."""
        stages_up_to(until)  # validates `until`
        acts: Dict[str, torch.Tensor] = {}
        e1 = self._Conv1(x)
        acts["Conv1"] = e1
        if until == "Conv1":
            return acts
        e2 = self._Conv2(self._pool(e1))
        acts["Conv2"] = e2
        if until == "Conv2":
            return acts
        e3 = self._Conv3(self._pool(e2))
        acts["Conv3"] = e3
        if until == "Conv3":
            return acts
        e4 = self._Conv4(self._pool(e3))
        acts["Conv4"] = e4
        if until == "Conv4":
            return acts
        e5 = self._Conv5(self._pool(e4))
        acts["Conv5"] = e5
        if until == "Conv5":
            return acts

        d5 = self._Up_conv5(torch.cat([e4, self._Up5(e5)], dim=1))
        acts["Up_conv5"] = d5
        if until == "Up_conv5":
            return acts
        d4 = self._Up_conv4(torch.cat([e3, self._Up4(d5)], dim=1))
        acts["Up_conv4"] = d4
        if until == "Up_conv4":
            return acts
        d3 = self._Up_conv3(torch.cat([e2, self._Up3(d4)], dim=1))
        acts["Up_conv3"] = d3
        if until == "Up_conv3":
            return acts
        d2 = self._Up_conv2(torch.cat([e1, self._Up2(d3)], dim=1))
        acts["Up_conv2"] = d2
        if until == "Up_conv2":
            return acts
        logits = self._Deconv_1x1(d2).float()
        acts["Deconv_1x1"] = logits
        acts["logits"] = logits
        return acts
