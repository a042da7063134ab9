"""2D segmentation UNet in PyTorch (NCHW).

The counterpart of `spcl_tpu/models/unet.py` on its default `nhwc` path,
with the module names of the reference torch UNet
(reference semi_seg/arch/unet.py:100-297), so its state_dict keys are the
reference's (`_Conv1.conv.0.weight`, `_Up5.up.1.weight`, ...):

- ConvBlock `_ConvK.conv`: (conv3x3 -> BN -> ReLU) x 2, bias-free convs;
- UpConv `_UpK.up`: nearest-upsample x2 -> conv3x3 -> BN -> ReLU;
  each BN -> ReLU pair runs as one function on a CUDA float32 NCHW input in
  train mode (`models/norm.py::bn_relu`);
- `_Deconv_1x1`: 1x1 conv with bias, f32 logits.

`forward` returns a `{stage: activation}` dict (logits also under
"logits") and stops after `until`. Every stage exists in the module whatever
`until` is, so a checkpoint always holds the full state_dict; stages past
`until` are frozen by the trainer (models/masking.py).

`small_c_layout="pallas"` (the JAX package's name for its fused stage
kernels, kept so one config serves both packages) runs Conv1 and Conv2 with
their pools through the fused CUDA stage (experimental/packed_stage.py) —
only in train mode and only for packable shapes, as
`spcl_tpu/models/unet.py:189-213` dispatches; eval mode and odd shapes take
the plain path. Parameters and state_dict keys are the same either way.

`small_c_layout="packed"` computes the function of spcl_tpu's lane-packed
stages (`experimental/packed_stage.py::PackedConvStage`, dispatched at
`spcl_tpu/models/unet.py:189-193`, :214-237) with PyTorch's own ops: Conv1
and Conv2 pool as the plain path does, but their BatchNorms are
`_PackedBN`'s (`CrossRankBatchNorm2d.packed`: the running variance takes
the biased batch variance; x * inv + shift) and, in bf16, their 3x3
convolutions round where the packed matmuls do (`packed_layout.py`), in
train AND eval mode, for the same packable shapes as `pallas`; other shapes
and the other stages take the plain path, as in spcl_tpu. The TPU's lane
layout itself has no counterpart on the GPU: the activations stay NCHW.

`dtype` is the compute dtype (`Arch.dtype`), as in spcl_tpu's UNet
(models/unet.py:148-176): float32 or bfloat16. The input is cast to it, the
convolutions take their float32 weights cast to it (`Conv2d`), and the
activations stay in it from stage to stage; BatchNorm reduces its statistics
in float32 and normalises in the compute dtype (models/norm.py); the logits
come back in float32. Parameters, BatchNorm buffers, gradients and optimizer
state stay float32. The dtype is explicit in the module, not
`torch.autocast`, which reaches neither the fused stage kernels nor the
rounding points of spcl_tpu's bf16 path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .norm import batch_norm, bn_relu
from .packed_layout import packed_conv
from ..experimental.packed_stage import packable, run_conv_stage
from ..utils.profiling import span

ENCODER_NAMES: Tuple[str, ...] = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
DECODER_NAMES: Tuple[str, ...] = ("Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3",
                                  "Up2", "Up_conv2", "Deconv_1x1")
ARCH_ELEMENTS: Tuple[str, ...] = ENCODER_NAMES + DECODER_NAMES

# stages that produce returnable feature maps (reference `layer_dimension`)
LAYER_DIMENSION = {"Conv1": 1, "Conv2": 2, "Conv3": 4, "Conv4": 8, "Conv5": 16,
                   "Up_conv5": 8, "Up_conv4": 4, "Up_conv3": 2, "Up_conv2": 1,
                   "Deconv_1x1": None}


# "nhwc" / "nchw": the plain path (one function in NCHW PyTorch); "pallas":
# the fused train-mode stage kernels for Conv1 / Conv2; "packed": the plain
# path with the arithmetic of spcl_tpu's packed stages (their BatchNorm; bf16
# convolutions rounded as theirs) at Conv1 / Conv2
SMALL_C_LAYOUTS: Tuple[str, ...] = ("nhwc", "nchw", "pallas", "packed")
DTYPES: Tuple[torch.dtype, ...] = (torch.float32, torch.bfloat16)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose float32 parameters meet the input in its dtype: under
    bfloat16 the weights (and bias) are rounded to it, as flax's
    `nn.Conv(dtype=...)` casts its kernel; the gradient comes back to the
    float32 parameters through the cast. Parameters and keys are
    `nn.Conv2d`'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


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
            Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            batch_norm(out_ch, momentum), nn.ReLU(inplace=True),
            Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
            batch_norm(out_ch, momentum), nn.ReLU(inplace=True))

    def forward(self, x):
        conv = self.conv
        x = bn_relu(conv[1], conv[2], conv[0](x))
        return bn_relu(conv[4], conv[5], conv[3](x))

    def packed(self, x, first: bool = False):
        """The block as spcl_tpu's `PackedConvStage` computes it: its
        convolutions (`packed_conv`; with `first`, the stage-1 input conv is
        the plain one, `first_conv_nhwc`) and BatchNorm (`_PackedBN`)."""
        conv = self.conv
        z = conv[0](x) if first else packed_conv(x, conv[0].weight)
        x = torch.relu(conv[1].packed(z))
        return torch.relu(conv[4].packed(packed_conv(x, conv[3].weight)))


class UpConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, momentum: float = 0.1):
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            batch_norm(out_ch, momentum), nn.ReLU(inplace=True))

    def forward(self, x):
        up = self.up
        return bn_relu(up[2], up[3], up[1](up[0](x)))


class UNet(nn.Module):
    """5-stage encoder / 4-stage decoder UNet with named-stage outputs."""

    ENCODER_NAMES = ENCODER_NAMES
    DECODER_NAMES = DECODER_NAMES
    ARCH_ELEMENTS = ARCH_ELEMENTS

    def __init__(self, input_dim: int = 1, num_classes: int = 4, max_channel: int = 256,
                 momentum: float = 0.1, small_c_layout: str = "nhwc",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if max_channel % 16:
            raise ValueError(f"max_channel must be a multiple of 16, got {max_channel}")
        if small_c_layout not in SMALL_C_LAYOUTS:
            raise ValueError(f"small_c_layout must be one of {SMALL_C_LAYOUTS}, "
                             f"got {small_c_layout!r}")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        self.small_c_layout = small_c_layout
        self.dtype = dtype
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
        self._Deconv_1x1 = Conv2d(ch["Up_conv2"], num_classes, 1)
        self._pool = nn.MaxPool2d(2, 2)

    def channel_dim(self, name: str) -> int:
        return get_channel_dim(name, max_channel=self.max_channel, num_classes=self.num_classes)

    def stage(self, name: str) -> nn.Module:
        """The submodule of a stage name (`Conv1` -> `_Conv1`)."""
        return getattr(self, f"_{name}")

    def _packable(self, x: torch.Tensor) -> bool:
        """spcl_tpu's `shapes_ok` (models/unet.py:189-191) on NCHW `x`."""
        return (x.shape[2] % 4 == 0
                and packable(x.shape[3], self.channel_dim("Conv1"), self.channel_dim("Conv2")))

    def _use_fused_stages(self, x: torch.Tensor) -> bool:
        """The dispatch of `spcl_tpu/models/unet.py:189-196`: the fused
        stages run in train mode on packable shapes; eval mode (running
        statistics) and odd shapes take the plain path."""
        return self.small_c_layout == "pallas" and self.training and self._packable(x)

    def forward(self, x: torch.Tensor, until: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Run the net on NCHW `x`, returning `{stage: activation}` for every
        computed stage; stops after `until`. The final logits live under both
        "Deconv_1x1" and "logits".

        Each stage runs in the span `spcl.unet.<stage>` (`utils/profiling.py`:
        open only while the torch profiler runs). Conv1's and Conv2's spans
        cover the 2x2 pool after them, which the fused path computes inside
        its stage; Conv4's and Conv5's the pool before them; a decoder
        stage's its upsampling block and the concatenation before it."""
        stages_up_to(until)  # validates `until`
        x = x.to(self.dtype)
        acts: Dict[str, torch.Tensor] = {}
        if self._use_fused_stages(x):
            # channels-last inside the two stages; `acts` holds NCHW views
            with span("spcl.unet.Conv1"):
                p1, e1 = run_conv_stage(self._Conv1, x, first_conv_plain=True)
                e1 = e1.permute(0, 3, 1, 2)
                acts["Conv1"] = e1
                if until == "Conv1":
                    return acts
            with span("spcl.unet.Conv2"):
                p2, e2 = run_conv_stage(self._Conv2, p1)
                e2 = e2.permute(0, 3, 1, 2)
                acts["Conv2"] = e2
                if until == "Conv2":
                    return acts
                p2 = p2.permute(0, 3, 1, 2)
        else:
            packed = self.small_c_layout == "packed" and self._packable(x)
            with span("spcl.unet.Conv1"):
                e1 = self._Conv1.packed(x, first=True) if packed else self._Conv1(x)
                acts["Conv1"] = e1
                if until == "Conv1":
                    return acts
                p1 = self._pool(e1)
            with span("spcl.unet.Conv2"):
                e2 = self._Conv2.packed(p1) if packed else self._Conv2(p1)
                acts["Conv2"] = e2
                if until == "Conv2":
                    return acts
                p2 = self._pool(e2)
        with span("spcl.unet.Conv3"):
            e3 = self._Conv3(p2)
            acts["Conv3"] = e3
            if until == "Conv3":
                return acts
        with span("spcl.unet.Conv4"):
            e4 = self._Conv4(self._pool(e3))
            acts["Conv4"] = e4
            if until == "Conv4":
                return acts
        with span("spcl.unet.Conv5"):
            e5 = self._Conv5(self._pool(e4))
            acts["Conv5"] = e5
            if until == "Conv5":
                return acts

        with span("spcl.unet.Up_conv5"):
            d5 = self._Up_conv5(torch.cat([e4, self._Up5(e5)], dim=1))
            acts["Up_conv5"] = d5
            if until == "Up_conv5":
                return acts
        with span("spcl.unet.Up_conv4"):
            d4 = self._Up_conv4(torch.cat([e3, self._Up4(d5)], dim=1))
            acts["Up_conv4"] = d4
            if until == "Up_conv4":
                return acts
        with span("spcl.unet.Up_conv3"):
            d3 = self._Up_conv3(torch.cat([e2, self._Up3(d4)], dim=1))
            acts["Up_conv3"] = d3
            if until == "Up_conv3":
                return acts
        with span("spcl.unet.Up_conv2"):
            d2 = self._Up_conv2(torch.cat([e1, self._Up2(d3)], dim=1))
            acts["Up_conv2"] = d2
            if until == "Up_conv2":
                return acts
        with span("spcl.unet.Deconv_1x1"):
            logits = self._Deconv_1x1(d2).float()
        acts["Deconv_1x1"] = logits
        acts["logits"] = logits
        return acts
