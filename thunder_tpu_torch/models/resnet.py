"""ResNet-style CNN in PyTorch: a 3x3 stem, stages of basic residual
blocks (stride 2 between stages, a 1x1 projection where the shape
changes), batch norm, a global average pool and a linear classifier.

The counterpart of ``thunder_tpu/models/resnet.py``: the same configs,
parameter tree and scale (:func:`init_params` from an explicit
``torch.Generator``; :func:`params_from_jax` carries the reference's numpy
tree across), NCHW layout, and the functional batch norm whose running
statistics are explicit state threaded through the step:
``forward(params, x, cfg, state, training) -> (logits, new_state)``, no
module mutation. The convolutions are ``F.conv2d`` (the reference's are
XLA's, not Pallas); the loss runs ``ce_fwd``. The running statistics carry
no gradient.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from thunder_tpu_torch.models import llama as _llama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.optim import tree_map


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet-tiny"
    num_classes: int = 10
    in_channels: int = 3
    width: int = 8                      # channels of the first stage
    stage_blocks: tuple = (1, 1, 1)     # residual blocks per stage (stride-2 between)
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    dtype: torch.dtype = torch.float32


CONFIGS = {
    "resnet-tiny": ResNetConfig(),
    "resnet18": ResNetConfig(name="resnet18", num_classes=1000, width=64,
                             stage_blocks=(2, 2, 2, 2)),
    "resnet34": ResNetConfig(name="resnet34", num_classes=1000, width=64,
                             stage_blocks=(3, 4, 6, 3)),
}


def _stages(cfg: ResNetConfig):
    """``(stage, block, c_in, c_out, stride)`` of every residual block."""
    c_in = cfg.width
    for si, n_blocks in enumerate(cfg.stage_blocks):
        c_out = cfg.width * (2 ** si)
        for bi in range(n_blocks):
            yield si, bi, c_in, c_out, 2 if (si > 0 and bi == 0) else 1
            c_in = c_out


def init_bn_state(cfg: ResNetConfig, device: str | torch.device = "cuda") -> dict:
    """Identity batch-norm statistics (zero mean, unit variance), float32."""
    def bn_state(c):
        return {"mean": torch.zeros(c, dtype=torch.float32, device=device),
                "var": torch.ones(c, dtype=torch.float32, device=device)}

    state = {"stem": bn_state(cfg.width), "stages": [[] for _ in cfg.stage_blocks]}
    for si, _bi, _ci, c_out, _s in _stages(cfg):
        state["stages"][si].append({"bn1": bn_state(c_out), "bn2": bn_state(c_out)})
    return state


def init_params(cfg: ResNetConfig, seed: int = 0, device: str | torch.device = "cuda"):
    """``(params, bn_state)``: conv weights ``N(0, 2 / fan_in)`` (He), the
    classifier ``N(0, 1 / c_in)``, batch-norm scales ones and biases zeros,
    in ``cfg.dtype``; ``bn_state`` holds the running mean and variance of
    every norm layer, to thread through :func:`forward` in training."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def conv(cout, cin, k):
        w = torch.randn((cout, cin, k, k), generator=gen, dtype=torch.float32, device=device)
        return w.mul_((2.0 / (cin * k * k)) ** 0.5).to(cfg.dtype)

    def bn(c):
        return {"scale": torch.ones(c, dtype=cfg.dtype, device=device),
                "bias": torch.zeros(c, dtype=cfg.dtype, device=device)}

    params = {"stem": {"w": conv(cfg.width, cfg.in_channels, 3), "bn": bn(cfg.width)},
              "stages": [[] for _ in cfg.stage_blocks], "fc": None}
    c_last = cfg.width
    for si, _bi, c_in, c_out, stride in _stages(cfg):
        blk = {"conv1": {"w": conv(c_out, c_in, 3), "bn": bn(c_out)},
               "conv2": {"w": conv(c_out, c_out, 3), "bn": bn(c_out)}, "down": None}
        if stride != 1 or c_in != c_out:
            blk["down"] = {"w": conv(c_out, c_in, 1)}
        params["stages"][si].append(blk)
        c_last = c_out
    w = torch.randn((cfg.num_classes, c_last), generator=gen, dtype=torch.float32,
                    device=device)
    params["fc"] = {"w": w.mul_((1.0 / c_last) ** 0.5).to(cfg.dtype),
                    "b": torch.zeros(cfg.num_classes, dtype=cfg.dtype, device=device)}
    return params, init_bn_state(cfg, device)


def params_from_jax(tree, device: str | torch.device = "cuda"):
    """The reference's ``init_params`` result (a ``(params, state)`` pair)
    or either tree alone, its leaves numpy arrays, on ``device``."""
    return tree_map(lambda a: _llama._tensor_from_numpy(a).to(device), tree)


def _batch_norm(x, p, s, cfg: ResNetConfig, training: bool):
    """Functional batch norm; returns ``(normalized, new_state)``. In
    training the batch statistics (float32, biased variance) normalise
    and the running ones move by ``bn_momentum``; in eval the running
    statistics normalise."""
    if training:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        m = cfg.bn_momentum
        with torch.no_grad():
            new_s = {"mean": s["mean"] * (1.0 - m) + mean * m,
                     "var": s["var"] * (1.0 - m) + var * m}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + cfg.bn_eps)
    scale = p["scale"] * inv.to(x.dtype)
    shift = p["bias"] - mean.to(x.dtype) * scale
    return x * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1), new_s


def forward(params: dict, x: torch.Tensor, cfg: ResNetConfig, state: dict | None = None,
            training: bool = False):
    """x (N, C, H, W) -> ``(logits, new_state)``. Without ``state`` it runs
    in eval mode on identity statistics."""
    if state is None:
        training = False
        state = init_bn_state(cfg, x.device)
    new_state = {"stem": None, "stages": []}
    h = F.conv2d(x, params["stem"]["w"], stride=1, padding=1)
    h, new_state["stem"] = _batch_norm(h, params["stem"]["bn"], state["stem"], cfg, training)
    h = torch.relu(h)
    for si, (stage_p, stage_s) in enumerate(zip(params["stages"], state["stages"])):
        ns_stage = []
        for bi, (blk, sblk) in enumerate(zip(stage_p, stage_s)):
            stride = 2 if (si > 0 and bi == 0) else 1
            r = h
            o = F.conv2d(h, blk["conv1"]["w"], stride=stride, padding=1)
            o, ns1 = _batch_norm(o, blk["conv1"]["bn"], sblk["bn1"], cfg, training)
            o = torch.relu(o)
            o = F.conv2d(o, blk["conv2"]["w"], stride=1, padding=1)
            o, ns2 = _batch_norm(o, blk["conv2"]["bn"], sblk["bn2"], cfg, training)
            if blk["down"] is not None:
                r = F.conv2d(r, blk["down"]["w"], stride=stride, padding=0)
            h = torch.relu(o + r)
            ns_stage.append({"bn1": ns1, "bn2": ns2})
        new_state["stages"].append(ns_stage)
    h = torch.mean(h, dim=(2, 3))   # global average pool
    logits = torch.matmul(h, params["fc"]["w"].t()) + params["fc"]["b"]
    return logits, new_state


def loss_fn(params: dict, x: torch.Tensor, targets: torch.Tensor, cfg: ResNetConfig,
            state: dict | None = None, training: bool = True):
    """Cross-entropy of the float32 logits; returns ``(loss, new_state)``."""
    logits, new_state = forward(params, x, cfg, state=state, training=training)
    return tnn.cross_entropy(logits.float(), targets), new_state
