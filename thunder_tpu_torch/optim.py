"""AdamW for the port's train step; the counterpart of
``thunder_tpu/optim.py`` ``AdamW`` (:167) in its default, per-step
multi-tensor form.

Parameters, gradients and optimizer state are trees of dicts and lists with
tensor leaves, the layout of :func:`thunder_tpu_torch.models.llama.init_params`.
The JAX package's ``update`` is a pure function whose buffers the train step
donates (``benchmarks/pretrain.py:92``); here ``update`` writes the new
parameters and moments into the same tensors in place, which is what that
donation achieves, and returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from thunder_tpu_torch.models.llama import _tensor_from_numpy
from thunder_tpu_torch.ops import optim as optim_ops


def tree_leaves(tree) -> list:
    """Leaves of a dict/list tree in the JAX package's flattening order
    (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


class AdamW:
    """Decoupled-weight-decay Adam with the reference's defaults.

    ``init(params)`` gives ``{"m", "v", "step"}``: zero moments in
    ``state_dtype`` and ``v_dtype`` (float32 unless given) and a float32
    step counter, all on the parameters' device. ``update(params, grads,
    state)`` advances the counter and computes the bias corrections
    ``1 - beta**step`` on the device (no host sync), then runs ONE
    ``fused_adamw`` per parameter dtype bucket, in place."""

    def __init__(self, lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 state_dtype: torch.dtype = torch.float32, v_dtype: torch.dtype | None = None):
        self.lr = lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.state_dtype = state_dtype
        self.v_dtype = v_dtype if v_dtype is not None else torch.float32

    def init(self, params) -> dict:
        device = tree_leaves(params)[0].device
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=self.state_dtype), params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=self.v_dtype), params),
                "step": torch.zeros((), dtype=torch.float32, device=device)}

    def state_from_jax(self, tree, device: str | torch.device = "cuda") -> dict:
        """The reference's AdamW state (``{"m", "v", "step"}``, its leaves
        already numpy arrays) as this optimizer's state on ``device``."""
        def conv(dtype):
            return lambda a: _tensor_from_numpy(a).to(device=device, dtype=dtype)

        return {"m": tree_map(conv(self.state_dtype), tree["m"]),
                "v": tree_map(conv(self.v_dtype), tree["v"]),
                "step": torch.tensor(float(np.asarray(tree["step"])), dtype=torch.float32,
                                     device=device)}

    @torch.no_grad()
    def update(self, params, grads, state):
        """One step, in place: returns ``(params, state)``, the same objects."""
        step = state["step"]
        step.add_(1.0)
        bc = torch.stack([1.0 - torch.pow(torch.full_like(step, b), step)
                          for b in (self.beta1, self.beta2)])
        buckets: dict[torch.dtype, list] = {}
        quads = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                    tree_leaves(state["v"]), strict=True)
        for quad in quads:
            if quad[1] is None:
                raise ValueError("AdamW.update: a parameter has no gradient")
            buckets.setdefault(quad[0].dtype, []).append(quad)
        for bucket in buckets.values():
            ps, gs, ms, vs = zip(*bucket)
            optim_ops.fused_adamw(ps, gs, ms, vs, bc, lr=self.lr, beta1=self.beta1,
                                  beta2=self.beta2, eps=self.eps,
                                  weight_decay=self.weight_decay)
        return params, state
