"""AdamW for the port's train steps; the counterpart of
``thunder_tpu/optim.py`` ``AdamW`` (:140) in its per-step multi-tensor form
and, with ``slab_persistent=True``, its slab-persistent form, with the
state-layout helpers ``SLAB_LAYOUT_VERSION``, ``opt_state_layout_version``
and ``adapt_opt_state`` (:101-128), and ``clip_grad_norm`` (:37).

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

# Optimizer-state layout versions, as the reference stamps them:
#   0 -- per-parameter m/v trees (no marker field)
#   1 -- per-dtype-bucket (rows, 128) slabs: "m"/"v" are dicts keyed by the
#        bucket's dtype name, plus a "layout_version" scalar
SLAB_LAYOUT_VERSION = 1


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


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def clip_grad_norm(grads, max_norm: float, *, eps: float = 1e-6):
    """Global-norm gradient clipping over a gradient tree, the reference's
    ``clip_grad_norm`` (``torch.nn.utils.clip_grad_norm_`` semantics).

    Returns ``(clipped, norm)``: ``norm`` is the L2 norm over every floating
    tensor leaf, its sum of squares accumulated in float32 leaf by leaf in
    :func:`tree_leaves` order (a 0-d float32 tensor on the grads' device);
    every such grad is multiplied in float32 by ``min(1, max_norm / (norm +
    eps))`` and cast back to its own dtype. Other leaves pass through. No
    host sync.

    The reference's ``params=`` argument, which sums the squares of sharded
    leaves across their mesh axis, comes with the port's distributed
    training (ROADMAP A.3); every leaf here is whole on one device."""
    leaves = [g for g in tree_leaves(grads)
              if isinstance(g, torch.Tensor) and g.is_floating_point()]
    if not leaves:
        raise ValueError("clip_grad_norm: the tree has no floating gradient")
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        gf = g.float()
        total = total + torch.sum(gf * gf)
    norm = torch.sqrt(total)
    scale = torch.clamp(float(max_norm) / (norm + eps), max=1.0)

    def clip(g):
        if isinstance(g, torch.Tensor) and g.is_floating_point():
            return (g.float() * scale).to(g.dtype)
        return g

    return tree_map(clip, grads), norm


def opt_state_layout_version(state) -> int:
    """Layout version of an optimizer state (0 when it has no marker)."""
    if isinstance(state, dict) and "layout_version" in state:
        return int(state["layout_version"])
    return 0


def adapt_opt_state(state, *, params, opt: AdamW):
    """``state`` in the layout ``opt`` runs: a per-parameter state packs into
    slabs for a ``slab_persistent`` optimizer, a slab state unpacks for
    another; a matching layout passes through untouched."""
    have = opt_state_layout_version(state)
    want = SLAB_LAYOUT_VERSION if opt.slab_persistent else 0
    if have == want:
        return state
    return opt.pack_state(params, state) if want else opt.unpack_state(params, state)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class AdamW:
    """Decoupled-weight-decay Adam with the reference's defaults.

    ``init(params)`` gives ``{"m", "v", "step"}``: zero moments in
    ``state_dtype`` and ``v_dtype`` (float32 unless given) and a float32
    step counter, all on the parameters' device. ``update(params, grads,
    state)`` advances the counter and computes the bias corrections
    ``1 - beta**step`` on the device (no host sync), then runs ONE
    ``fused_adamw`` per parameter dtype bucket, in place.

    ``slab_persistent=True`` keeps m and v in one ``(rows, 128)`` slab per
    parameter dtype bucket between steps (the reference's layout,
    :meth:`_slab_layout`): ``init`` gives ``{"m": {dtype name: slab}, "v":
    {...}, "step", "layout_version"}`` and ``update`` runs ONE
    ``fused_adamw_slab`` per bucket, which reads and writes the slabs in
    place; parameter updates are bit-identical to the per-step form. The
    reference refuses dist-annotated (sharded) parameters here; the port has
    no distributed training yet, so there is nothing to refuse."""

    def __init__(self, lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 state_dtype: torch.dtype = torch.float32, v_dtype: torch.dtype | None = None,
                 slab_persistent: bool = False):
        self.lr = lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.state_dtype = state_dtype
        self.v_dtype = v_dtype if v_dtype is not None else torch.float32
        self.slab_persistent = slab_persistent

    @property
    def _hyper(self) -> dict:
        return dict(lr=self.lr, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                    weight_decay=self.weight_decay)

    @staticmethod
    def _slab_layout(params) -> list:
        """The reference's bucket layout (optim.py:180): leaves in
        flattening order, bucketed by dtype name in order of first
        appearance. Returns ``[(dtype name, [(leaf index, shape, size)])]``;
        a member's slab run starts where the previous member's ends."""
        buckets: dict[str, list] = {}
        for i, p in enumerate(tree_leaves(params)):
            buckets.setdefault(_dtype_name(p), []).append((i, tuple(p.shape), p.numel()))
        return list(buckets.items())

    def _new_slabs(self, layout, device, fill):
        """One zero-padded ``(rows, 128)`` m and v slab per bucket; ``fill(key,
        slab, which)`` writes the members' runs (or leaves them zero)."""
        m_slabs, v_slabs = {}, {}
        for key, members in layout:
            rows_pad, _ = optim_ops.slab_geometry(sum(sz for _, _, sz in members))
            for slabs, dt, which in ((m_slabs, self.state_dtype, "m"),
                                     (v_slabs, self.v_dtype, "v")):
                slabs[key] = torch.zeros((rows_pad, optim_ops.SLAB_LANE), dtype=dt,
                                         device=device)
                fill(key, slabs[key], which)
        return m_slabs, v_slabs

    def _layout_version(self, device) -> torch.Tensor:
        return torch.tensor(SLAB_LAYOUT_VERSION, dtype=torch.int32, device=device)

    def init(self, params) -> dict:
        device = tree_leaves(params)[0].device
        step = torch.zeros((), dtype=torch.float32, device=device)
        if not self.slab_persistent:
            return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=self.state_dtype), params),
                    "v": tree_map(lambda p: torch.zeros_like(p, dtype=self.v_dtype), params),
                    "step": step}
        m, v = self._new_slabs(self._slab_layout(params), device, lambda *_: None)
        return {"m": m, "v": v, "step": step, "layout_version": self._layout_version(device)}

    def pack_state(self, params, state) -> dict:
        """A per-parameter state as slabs, on the parameters' device; moments
        saved wider than the configured dtypes are rounded to them."""
        if opt_state_layout_version(state) != 0:
            raise ValueError("pack_state: the state is already in the slab layout")
        layout = self._slab_layout(params)
        leaves = {"m": tree_leaves(state["m"]), "v": tree_leaves(state["v"])}
        device = tree_leaves(params)[0].device

        def fill(key, slab, which):
            members = dict(layout)[key]
            flat = torch.cat([leaves[which][i].reshape(-1).to(device=device, dtype=slab.dtype)
                              for i, _, _ in members])
            slab.view(-1)[:flat.numel()] = flat

        m, v = self._new_slabs(layout, device, fill)
        return {"m": m, "v": v, "step": state["step"].to(device=device, dtype=torch.float32),
                "layout_version": self._layout_version(device)}

    def unpack_state(self, params, state) -> dict:
        """A slab state as per-parameter trees (views of the slabs' runs)."""
        if opt_state_layout_version(state) != SLAB_LAYOUT_VERSION:
            raise ValueError("unpack_state: the state is not in the slab layout")
        leaves = {"m": [None] * len(tree_leaves(params)), "v": [None] * len(tree_leaves(params))}
        for key, members in self._slab_layout(params):
            for which in ("m", "v"):
                flat, off = state[which][key].reshape(-1), 0
                for i, shape, size in members:
                    leaves[which][i] = flat[off:off + size].reshape(shape)
                    off += size
        return {"m": tree_unflatten(params, leaves["m"]),
                "v": tree_unflatten(params, leaves["v"]), "step": state["step"]}

    def state_from_jax(self, tree, device: str | torch.device = "cuda") -> dict:
        """The reference's AdamW state, its leaves already numpy arrays, as
        this optimizer's state on ``device``: a per-parameter state with its
        moments in the configured dtypes, a slab state (``layout_version``
        1) slab for slab in the slabs' own dtypes."""
        def conv(dtype=None):
            return lambda a: _tensor_from_numpy(a).to(device=device, dtype=dtype)

        step = torch.tensor(float(np.asarray(tree["step"])), dtype=torch.float32, device=device)
        if opt_state_layout_version(tree) == SLAB_LAYOUT_VERSION:
            return {"m": {k: conv()(a) for k, a in tree["m"].items()},
                    "v": {k: conv()(a) for k, a in tree["v"].items()},
                    "step": step, "layout_version": self._layout_version(device)}
        return {"m": tree_map(conv(self.state_dtype), tree["m"]),
                "v": tree_map(conv(self.v_dtype), tree["v"]), "step": step}

    def _bias_corrections(self, state) -> torch.Tensor:
        step = state["step"]
        step.add_(1.0)
        return torch.stack([1.0 - torch.pow(torch.full_like(step, b), step)
                            for b in (self.beta1, self.beta2)])

    @torch.no_grad()
    def update(self, params, grads, state):
        """One step, in place: returns ``(params, state)``, the same objects."""
        if self.slab_persistent:
            return self._update_slab(params, grads, state)
        bc = self._bias_corrections(state)
        buckets: dict[torch.dtype, list] = {}
        quads = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                    tree_leaves(state["v"]), strict=True)
        for quad in quads:
            if quad[1] is None:
                raise ValueError("AdamW.update: a parameter has no gradient")
            buckets.setdefault(quad[0].dtype, []).append(quad)
        for bucket in buckets.values():
            ps, gs, ms, vs = zip(*bucket)
            optim_ops.fused_adamw(ps, gs, ms, vs, bc, **self._hyper)
        return params, state

    def _update_slab(self, params, grads, state):
        if not (isinstance(state, dict) and "layout_version" in state):   # no host sync
            raise ValueError("slab-persistent AdamW got a per-parameter state; convert it with "
                             "optim.adapt_opt_state(state, params=params, opt=opt) first")
        pleaves, gleaves = tree_leaves(params), tree_leaves(grads)
        if len(gleaves) != len(pleaves) or any(g is None for g in gleaves):
            raise ValueError("slab AdamW: every parameter needs a gradient")
        bc = self._bias_corrections(state)
        for key, members in self._slab_layout(params):
            idx = [i for i, _, _ in members]
            gs = [gleaves[i] for i in idx]
            if len({g.dtype for g in gs}) != 1:
                raise ValueError(f"slab AdamW: mixed grad dtypes in the {key} bucket")
            if key not in state["m"] or key not in state["v"]:
                raise ValueError(f"slab AdamW: the state has no slab for the {key} bucket "
                                 f"(parameters changed since init?)")
            optim_ops.fused_adamw_slab([pleaves[i] for i in idx], gs, state["m"][key],
                                       state["v"][key], bc,
                                       sizes=[sz for _, _, sz in members], **self._hyper)
        return params, state
