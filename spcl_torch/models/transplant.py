"""Weights across: `spcl_tpu` (flax) variables -> this package's modules.

The inverse of `spcl_tpu/models/torch_import.py::flax_from_torch_state_dict`
plus the projection-head mapping, kept here as the port's own copy (the port
never imports `spcl_tpu`). Pure numpy in, numpy out; load the result with
`{k: torch.from_numpy(v)}`.

    flax Conv{k}/conv0, bn0, conv1, bn1  -> _Conv{k}.conv.0, .1, .3, .4
    flax Up{k}/conv, bn                  -> _Up{k}.up.1, .up.2
    flax Deconv_1x1 kernel, bias         -> _Deconv_1x1.weight, .bias
    flax head fc0/fc1 kernel, bias       -> fc0/fc1 .weight, .bias

Tensor transforms: conv kernels HWIO -> OIHW; Dense kernels [in, out] ->
Linear weights [out, in]; BN scale/bias/mean/var -> weight/bias/
running_mean/running_var, with num_batches_tracked = 0 (torch reads it only
when momentum=None).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

_CONV_BLOCKS = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5",
                "Up_conv5", "Up_conv4", "Up_conv3", "Up_conv2")
_UP_BLOCKS = ("Up5", "Up4", "Up3", "Up2")


def _f32(x) -> np.ndarray:
    # a writable contiguous copy: torch.from_numpy warns on read-only arrays
    return np.array(x, dtype=np.float32, order="C", copy=True)


def _hwio_to_oihw(w) -> np.ndarray:
    return _f32(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def unet_state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                              allow_partial: bool = False) -> Dict[str, np.ndarray]:
    """flax UNet `(params, batch_stats)` -> this package's UNet state_dict.

    `allow_partial=True` skips blocks absent from `params` (an encoder-only
    pretrain tree stops at `until`); load the result with strict=False."""
    sd: Dict[str, np.ndarray] = {}

    def put_bn(prefix: str, p: Mapping, s: Mapping) -> None:
        sd[f"{prefix}.weight"] = _f32(p["scale"])
        sd[f"{prefix}.bias"] = _f32(p["bias"])
        sd[f"{prefix}.running_mean"] = _f32(s["mean"])
        sd[f"{prefix}.running_var"] = _f32(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    def have(name: str) -> bool:
        if name in params:
            return True
        if not allow_partial:
            raise KeyError(f"block {name!r} missing from params; encoder-only trees "
                           f"need allow_partial=True (and strict=False on load)")
        return False

    for name in _CONV_BLOCKS:
        if not have(name):
            continue
        t = f"_{name}.conv"
        sd[f"{t}.0.weight"] = _hwio_to_oihw(params[name]["conv0"]["kernel"])
        put_bn(f"{t}.1", params[name]["bn0"], batch_stats[name]["bn0"])
        sd[f"{t}.3.weight"] = _hwio_to_oihw(params[name]["conv1"]["kernel"])
        put_bn(f"{t}.4", params[name]["bn1"], batch_stats[name]["bn1"])
    for name in _UP_BLOCKS:
        if not have(name):
            continue
        t = f"_{name}.up"
        sd[f"{t}.1.weight"] = _hwio_to_oihw(params[name]["conv"]["kernel"])
        put_bn(f"{t}.2", params[name]["bn"], batch_stats[name]["bn"])
    if have("Deconv_1x1"):
        sd["_Deconv_1x1.weight"] = _hwio_to_oihw(params["Deconv_1x1"]["kernel"])
        sd["_Deconv_1x1.bias"] = _f32(params["Deconv_1x1"]["bias"])
    return sd


def head_state_dict_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """flax ProjectionHead variables (`{"params": {...}}` or the bare params)
    -> this package's ProjectionHead state_dict."""
    params = variables.get("params", variables)
    sd: Dict[str, np.ndarray] = {}
    for name, layer in params.items():
        sd[f"{name}.weight"] = _f32(np.asarray(layer["kernel"]).T)
        sd[f"{name}.bias"] = _f32(layer["bias"])
    return sd
