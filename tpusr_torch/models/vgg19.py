"""VGG19 feature extractor for the SRGAN perceptual (content) loss.

Counterpart of ``tpusr/models/vgg19.py`` (reference utils/GAN.py:7-92,
Vgg19Loss): the conv stack through ReLU5_4 (torchvision ``features[:36]``),
after torchvision's ImageNet eval transform (shorter side to 256,
centre crop 224, normalise), applied to both images.

No weights are downloaded. ``TPUSR_VGG19_WEIGHTS`` names an npz in tpusr's
layout (``conv{b}_{i}.kernel`` HWIO, ``.bias``) or a torchvision vgg19
state dict (.pth); without it ``try_load_vgg19`` returns None and the
content loss is pixel MSE, as in tpusr. The port keeps its parameters as
{name: {'weight' OIHW, 'bias'}}. The 16 convs are plain ``F.conv2d``, as
tpusr leaves them to XLA. Images are NHWC at the public functions.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# (out_channels, n_convs) per block; 2x2 max pool after each block
_VGG19_BLOCKS = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

VGG19_WEIGHTS_ENV = "TPUSR_VGG19_WEIGHTS"


def vgg19_layer_names() -> list[str]:
    """Conv layer names 'conv{block}_{idx}' in forward order (16 convs)."""
    return [f"conv{b}_{i}" for b, (_, n) in enumerate(_VGG19_BLOCKS, 1)
            for i in range(1, n + 1)]


def vgg_preprocess(x: torch.Tensor) -> torch.Tensor:
    """torchvision's VGG19 eval transform over NHWC (nominally [0, 1]).

    Shorter side to 256, the long side int(256 * long / short) (truncated)
    and at least 224, antialiased bilinear; centre crop 224 at
    int(round((size - 224) / 2)); ImageNet normalisation with no rescale of
    float inputs, so [-1, 1] tensors pass through unchanged (the
    reference's quirk, tpusr vgg19.py:57-59).
    """
    _, h, w, _ = x.shape
    if h <= w:
        nh, nw = 256, max(224, int(256 * w / h))
    else:
        nh, nw = max(224, int(256 * h / w)), 256
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                      antialias=True, align_corners=False)
    top = int(round((nh - 224) / 2.0))
    left = int(round((nw - 224) / 2.0))
    y = y[:, :, top:top + 224, left:left + 224]
    mean = torch.tensor(_IMAGENET_MEAN, dtype=y.dtype, device=y.device)
    std = torch.tensor(_IMAGENET_STD, dtype=y.dtype, device=y.device)
    return ((y - mean.view(1, 3, 1, 1)) / std.view(1, 3, 1, 1)).permute(
        0, 2, 3, 1)


def vgg19_features(params: dict, x: torch.Tensor,
                   upto: str = "conv5_4") -> torch.Tensor:
    """The activation after ``upto``'s ReLU (NHWC), the conv stack with a
    ReLU after every conv and a 2x2 max pool between blocks.
    ``upto='conv5_4'`` is torchvision's features[:36]."""
    x = x.permute(0, 3, 1, 2)
    for b, (_, n_convs) in enumerate(_VGG19_BLOCKS, start=1):
        for i in range(1, n_convs + 1):
            name = f"conv{b}_{i}"
            p = params[name]
            x = torch.relu(F.conv2d(x, p["weight"].to(x.dtype),
                                    p["bias"].to(x.dtype), padding=1))
            if name == upto:
                return x.permute(0, 2, 3, 1)
        x = F.max_pool2d(x, 2)
    raise ValueError(f"unknown layer {upto!r}")


def load_vgg19_npz(path: str, device="cpu") -> dict:
    """tpusr's converted VGG19 npz (HWIO kernels) -> the port's params."""
    data = np.load(path)
    return {name: {
        "weight": torch.from_numpy(np.ascontiguousarray(
            data[f"{name}.kernel"].transpose(3, 2, 0, 1))).to(device),
        "bias": torch.from_numpy(data[f"{name}.bias"]).to(device)}
        for name in vgg19_layer_names()}


def load_torch_vgg19_features(state_dict: dict, device="cpu") -> dict:
    """A torchvision vgg19().features state dict (convs at features.{0, 2,
    5, 7, 10, ...}, OIHW) -> the port's params, mapped by position."""
    conv_indices = []
    idx = 0
    for _, n_convs in _VGG19_BLOCKS:
        for _ in range(n_convs):
            conv_indices.append(idx)
            idx += 2  # conv + relu
        idx += 1  # maxpool
    return {name: {
        "weight": torch.as_tensor(state_dict[f"{ti}.weight"]).float().to(
            device),
        "bias": torch.as_tensor(state_dict[f"{ti}.bias"]).float().to(device)}
        for name, ti in zip(vgg19_layer_names(), conv_indices)}


def try_load_vgg19(device="cpu") -> dict | None:
    """VGG19 feature weights from $TPUSR_VGG19_WEIGHTS (.npz, else a
    torchvision .pth), on ``device``; None without the file."""
    path = os.environ.get(VGG19_WEIGHTS_ENV, "")
    if not (path and os.path.exists(path)):
        return None
    if path.endswith(".npz"):
        return load_vgg19_npz(path, device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("features."): v for k, v in sd.items()}
    return load_torch_vgg19_features(sd, device)
