"""Swin-Unet (Cao et al., "Swin-Unet: Unet-like Pure Transformer for Medical
Image Segmentation", arXiv 2105.05537; `SwinTransformerSys` of its code, with
the Swin Transformer block of Liu et al., arXiv 2103.14030), selected by
`Arch.name: swin_unet`.

Written from the published equations, with the published module names, so
that the state_dict keys are `SwinTransformerSys`'s (`patch_embed.proj.weight`,
`layers.0.blocks.1.attn.qkv.weight`, `layers_up.1.upsample.expand.weight`,
`concat_back_dim.2.weight`, `output.weight`, ...); the relative index and the
shift masks are buffers made at build time and left out of the state_dict.

- Patch embedding: the 1-channel slice repeated to 3 channels (as the
  published forward does), `Conv2d(3, C, 4, stride 4)`, LayerNorm(C).
- Block: x = x + proj(W-MSA(LN(x))), x = x + fc2(GELU(fc1(LN(x)))), MLP
  ratio 4, exact-erf GELU; qkv = Linear(C, 3C, bias); the window attention
  is `ops/wattn_cuda.py::window_attention` (scale head_dim^-0.5, relative
  position bias, every second block shifted by ws // 2 with the published
  -100 mask; a stage whose side is at most the window is one unshifted
  window of its side). The qkv and output projections run in the image's
  token order: the roll and the partition are folded into the attention.
- Patch merging (closes encoder stages 1-3): concat of x[0::2, 0::2],
  x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2], LN(4C), Linear(4C, 2C, no
  bias). The encoder ends with LN(8C).
- Decoder: a patch expand (Linear(8C, 16C, no bias), 2 x 2 -> 4C, LN(4C)),
  then three up-stages at 4C / 2C / C, each the concatenation [x, skip] of
  the matching encoder layer's input, Linear(2C', C'), the blocks, and a
  patch expand on all but the last; LN(C), the x4 final expand (Linear(C,
  16C, no bias), 4 x 4 -> C, LN(C)) and `Conv2d(C, num_classes, 1, no bias)`.

Stages (the trainers' interface, as the UNet's): `Swin1` (the patch
embedding and encoder layer 1 with its merging), `Swin2`, `Swin3`, `Swin4`
(layer 4 and the final LayerNorm: the bottleneck, [B, 8C, H/32, W/32]),
`SwinUp3` (the first expand and the up-stage at 4C), `SwinUp2`, `SwinUp1`,
`Final` (LN, the x4 expand and the 1x1 logits). `forward(x, until=)` returns
{stage: NCHW features} (views of the channels-last tokens) up to `until`,
the logits (float32) also under "logits"; each stage runs in the span
`spcl.swin.<stage>` (`utils/profiling.py`).

Float32 only (`Arch.dtype: bfloat16` is refused); the linear layers run on
PyTorch's float32 path (cuBLAS, TF32 as the backends set it); no dropout or
stochastic depth (drop path 0).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.wattn_cuda import relative_index, shift_mask, window_attention
from ..utils.profiling import span

PATCH = 4                 # the published patch side, depths and MLP ratio (Swin-T)
DEPTHS = (2, 2, 2, 2)
MLP_RATIO = 4.0



def _init_weights(m: nn.Module) -> None:
    """The published initialisation: linear weights truncated N(0, 0.02^2),
    biases 0, LayerNorm 1 and 0."""
    if isinstance(m, nn.Linear):
        nn.init.trunc_normal_(m.weight, std=0.02)
        if m.bias is not None:
            nn.init.zeros_(m.bias)
    elif isinstance(m, nn.LayerNorm):
        nn.init.ones_(m.weight)
        nn.init.zeros_(m.bias)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class WindowAttention(nn.Module):
    """qkv, the window attention and proj of one block; the published
    parameter names (`relative_position_bias_table`, `qkv`, `proj`)."""

    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", relative_index(ws), persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], shift: int) -> torch.Tensor:
        o = window_attention(self.qkv(x), self.relative_position_bias_table,
                             self.relative_position_index, mask, heads=self.heads, ws=self.ws,
                             shift=shift, scale=self.scale)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class SwinBlock(nn.Module):
    """The Swin Transformer block at a side of `res` tokens; shifted by
    ws // 2 when `shifted` and the side exceeds the window."""

    def __init__(self, dim: int, res: int, heads: int, ws: int, shifted: bool,
                 mlp_ratio: float):
        super().__init__()
        if res <= ws:
            ws, shifted = res, False
        self.shift = ws // 2 if shifted else 0
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.register_buffer("attn_mask", shift_mask(res, res, ws, self.shift), persistent=False)

    def forward(self, x):
        x = x + self.attn(self.norm1(x), self.attn_mask, self.shift)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    """The published `PatchExpand` (scale 2: Linear(dim, 2 dim), each token's
    2 x 2 -> dim / 2 channels) and `FinalPatchExpand_X4` (scale 4:
    Linear(dim, 16 dim), 4 x 4 -> dim), then LayerNorm."""

    def __init__(self, dim: int, scale: int):
        super().__init__()
        self.scale = scale
        self.out = dim // 2 if scale == 2 else dim
        self.expand = nn.Linear(dim, scale * scale * self.out, bias=False)
        self.norm = nn.LayerNorm(self.out)

    def forward(self, x):
        b, h, w, _ = x.shape
        s = self.scale
        x = self.expand(x).reshape(b, h, w, s, s, self.out).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(b, h * s, w * s, self.out))


class BasicLayer(nn.Module):
    """`depth` blocks, alternately unshifted and shifted, then the merging
    (encoder) or the expand (decoder) when given."""

    def __init__(self, dim: int, res: int, depth: int, heads: int, ws: int, mlp_ratio: float,
                 downsample: bool = False, upsample: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList([SwinBlock(dim, res, heads, ws, i % 2 == 1, mlp_ratio)
                                     for i in range(depth)])
        if downsample:
            self.downsample = PatchMerging(dim)
        if upsample:
            self.upsample = PatchExpand(dim, 2)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        if hasattr(self, "upsample"):
            x = self.upsample(x)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinUNet(nn.Module):
    """Swin-Unet with named-stage outputs (see the module docstring)."""

    ENCODER_NAMES: Tuple[str, ...] = ("Swin1", "Swin2", "Swin3", "Swin4")
    DECODER_NAMES: Tuple[str, ...] = ("SwinUp3", "SwinUp2", "SwinUp1", "Final")
    ARCH_ELEMENTS: Tuple[str, ...] = ENCODER_NAMES + DECODER_NAMES
    dtype = torch.float32

    def __init__(self, input_dim: int = 1, num_classes: int = 4, img_size: int = 224,
                 embed_dim: int = 96, num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7):
        super().__init__()
        if input_dim not in (1, 3):
            raise ValueError(f"Swin-Unet takes 1- or 3-channel slices, got input_dim={input_dim}")
        depths, mlp_ratio, layers = DEPTHS, MLP_RATIO, len(DEPTHS)
        if len(num_heads) != layers:
            raise ValueError(f"Swin-Unet has {layers} encoder layers, got heads {num_heads}")
        side = img_size // PATCH
        if img_size % (PATCH * 2 ** (layers - 1)):
            raise ValueError(f"img_size {img_size} must be a multiple of "
                             f"{PATCH * 2 ** (layers - 1)}")
        self.input_dim, self.num_classes = int(input_dim), int(num_classes)
        self.img_size, self.embed_dim = int(img_size), int(embed_dim)
        c = embed_dim
        self.patch_embed = PatchEmbed(PATCH, c)
        self.layers = nn.ModuleList([
            BasicLayer(c * 2 ** i, side // 2 ** i, depths[i], num_heads[i], window_size,
                       mlp_ratio, downsample=i < layers - 1) for i in range(layers)])
        self.layers_up = nn.ModuleList()
        self.concat_back_dim = nn.ModuleList()
        for i in range(layers):
            j = layers - 1 - i
            dim = c * 2 ** j
            self.concat_back_dim.append(nn.Linear(2 * dim, dim) if i else nn.Identity())
            if i == 0:
                self.layers_up.append(PatchExpand(dim, 2))
            else:
                self.layers_up.append(BasicLayer(dim, side // 2 ** j, depths[j], num_heads[j],
                                                 window_size, mlp_ratio,
                                                 upsample=i < layers - 1))
        self.norm = nn.LayerNorm(c * 2 ** (layers - 1))
        self.norm_up = nn.LayerNorm(c)
        self.up = PatchExpand(c, 4)
        self.output = nn.Conv2d(c, num_classes, 1, bias=False)
        self.apply(_init_weights)
        self._channels = {"Swin1": 2 * c, "Swin2": 4 * c, "Swin3": 8 * c, "Swin4": 8 * c,
                          "SwinUp3": 2 * c, "SwinUp2": c, "SwinUp1": c, "Final": num_classes}

    def channel_dim(self, name: str) -> int:
        return self._channels[name]

    def stage(self, name: str) -> nn.Module:
        """The modules of a stage (an unregistered container of them)."""
        parts = {"Swin1": [self.patch_embed, self.layers[0]], "Swin2": [self.layers[1]],
                 "Swin3": [self.layers[2]], "Swin4": [self.layers[3], self.norm],
                 "SwinUp3": [self.layers_up[0], self.concat_back_dim[1], self.layers_up[1]],
                 "SwinUp2": [self.concat_back_dim[2], self.layers_up[2]],
                 "SwinUp1": [self.concat_back_dim[3], self.layers_up[3]],
                 "Final": [self.norm_up, self.up, self.output]}
        return nn.ModuleList(parts[name])

    def forward(self, x: torch.Tensor, until: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """{stage: NCHW features} of NCHW `x` up to `until` (None: all); the
        logits under "Final" and "logits"."""
        if until is not None and until not in self.ARCH_ELEMENTS:
            raise KeyError(f"`until` should be one of {list(self.ARCH_ELEMENTS)}, got {until}")
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(f"Swin-Unet was built for {self.img_size}^2 inputs, got "
                             f"{tuple(x.shape[2:])}")
        acts: Dict[str, torch.Tensor] = {}
        skips = []
        t = None
        for i, name in enumerate(self.ENCODER_NAMES):
            with span(f"spcl.swin.{name}"):
                if i == 0:
                    x = x.float()
                    t = self.patch_embed(x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x)
                skips.append(t)
                t = self.layers[i](t)
                if i == len(self.ENCODER_NAMES) - 1:
                    t = self.norm(t)
                acts[name] = _nchw(t)
            if until == name:
                return acts
        for i, name in enumerate(self.DECODER_NAMES[:-1], start=1):
            with span(f"spcl.swin.{name}"):
                if i == 1:
                    t = self.layers_up[0](t)
                t = self.concat_back_dim[i](torch.cat([t, skips[len(skips) - 1 - i]], dim=-1))
                t = self.layers_up[i](t)
                acts[name] = _nchw(t)
            if until == name:
                return acts
        with span("spcl.swin.Final"):
            t = self.up(self.norm_up(t))
            logits = self.output(_nchw(t)).float().contiguous()
        acts["Final"] = logits
        acts["logits"] = logits
        return acts
