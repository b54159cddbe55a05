"""AdamW and SGD for the port's train steps; the counterpart of
``thunder_tpu/optim.py`` ``AdamW`` (:140) in its per-step multi-tensor form
and, with ``slab_persistent=True``, its slab-persistent form, with the
state-layout helpers ``SLAB_LAYOUT_VERSION``, ``opt_state_layout_version``
and ``adapt_opt_state`` (:101-128), ``SGD`` (:379) and ``clip_grad_norm``
(:37).

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
    (dict keys sorted, lists in order; None is an empty subtree, as in a
    JAX pytree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf, in :func:`tree_leaves` order; None
    stays None."""
    if tree is None:
        return None
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
    ``fused_adamw`` per parameter dtype bucket, in place. ``health(params,
    grads, state, loss)`` gives the numerics guard's health word of that
    step without taking it, and ``update(..., health=word)`` takes the step
    only where the word is healthy (the counter advances by the verdict).

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

    def _bias_corrections(self, state, commit: bool = True) -> torch.Tensor:
        """``[1 - beta1**(step + 1), 1 - beta2**(step + 1)]`` on the device;
        ``commit`` writes ``step + 1`` into the counter (a gated update
        leaves it to the verdict)."""
        nxt = state["step"] + 1.0
        if commit:
            state["step"].copy_(nxt)
        return torch.stack([1.0 - torch.pow(torch.full_like(nxt, b), nxt)
                            for b in (self.beta1, self.beta2)])

    def _buckets(self, params, grads, state):
        """``(kind, args, kwargs)`` for each dtype bucket: ``"step"`` with
        ``(params, grads, ms, vs)``, or ``"slab"`` with ``(params, grads,
        m_slab, v_slab)`` and the bucket's ``sizes``."""
        if self.slab_persistent:
            if not (isinstance(state, dict) and "layout_version" in state):   # no host sync
                raise ValueError("slab-persistent AdamW got a per-parameter state; convert it "
                                 "with optim.adapt_opt_state(state, params=params, opt=opt) "
                                 "first")
            pleaves, gleaves = tree_leaves(params), tree_leaves(grads)
            if len(gleaves) != len(pleaves) or any(g is None for g in gleaves):
                raise ValueError("slab AdamW: every parameter needs a gradient")
            out = []
            for key, members in self._slab_layout(params):
                idx = [i for i, _, _ in members]
                gs = [gleaves[i] for i in idx]
                if len({g.dtype for g in gs}) != 1:
                    raise ValueError(f"slab AdamW: mixed grad dtypes in the {key} bucket")
                if key not in state["m"] or key not in state["v"]:
                    raise ValueError(f"slab AdamW: the state has no slab for the {key} bucket "
                                     f"(parameters changed since init?)")
                out.append(("slab", ([pleaves[i] for i in idx], gs, state["m"][key],
                                     state["v"][key]), {"sizes": [sz for _, _, sz in members]}))
            return out
        buckets: dict[torch.dtype, list] = {}
        quads = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                    tree_leaves(state["v"]), strict=True)
        for quad in quads:
            if quad[1] is None:
                raise ValueError("AdamW.update: a parameter has no gradient")
            buckets.setdefault(quad[0].dtype, []).append(quad)
        return [("step", tuple(zip(*bucket)), {}) for bucket in buckets.values()]

    @torch.no_grad()
    def health(self, params, grads, state, loss: torch.Tensor) -> torch.Tensor:
        """The numerics guard's health word of the step ``update`` would take
        (float32 of ``runtime.sentinel.HEALTH_SIZE`` on the device: the
        non-finite grads, the non-finite loss, the non-finite new state as
        it would be stored, the global grad norm, the loss), from every
        bucket's health pass before any update runs. Writes nothing but the
        word; no host sync."""
        buckets = self._buckets(params, grads, state)
        bc = self._bias_corrections(state, commit=False)
        acc = torch.zeros(3, dtype=torch.float64, device=bc.device)
        for kind, args, kw in buckets:
            if kind == "slab":
                optim_ops.fused_adamw_slab_health(*args, bc, acc, **kw, **self._hyper)
            else:
                optim_ops.fused_adamw_health(*args, bc, acc, **self._hyper)
        lossf = loss.detach().float().reshape(())
        return torch.stack([acc[0].float(), (~torch.isfinite(lossf)).float(), acc[2].float(),
                            torch.sqrt(acc[1]).float(), lossf])

    @torch.no_grad()
    def update(self, params, grads, state, health: torch.Tensor | None = None):
        """One step, in place: returns ``(params, state)``, the same objects.

        ``health`` (from :meth:`health`, same arguments) gates the step on
        the device: an unhealthy word leaves params, moments and the step
        counter bit-identical, a healthy one takes exactly the ungated
        step."""
        buckets = self._buckets(params, grads, state)
        bc = self._bias_corrections(state, commit=health is None)
        for kind, args, kw in buckets:
            if kind == "slab":
                optim_ops.fused_adamw_slab(*args, bc, **kw, **self._hyper, health=health)
            else:
                optim_ops.fused_adamw(*args, bc, **self._hyper, health=health)
        if health is not None:
            state["step"].add_(optim_ops.healthy(health).float())
        return params, state


class SGD:
    """Stochastic gradient descent with optional momentum and (coupled)
    weight decay, the reference's ``SGD``: every update in float32 from the
    parameter and gradient taken to float32, the parameter stored back in
    its own dtype, the momentum buffers float32. No kernel: the reference
    has no Pallas kernel for it, so it runs as PyTorch elementwise ops.

    ``init(params)`` gives ``{"mom": zeros}`` with momentum and ``{}``
    without; ``update(params, grads, state)`` writes the new parameters
    and momenta into the same tensors in place, as :class:`AdamW` does, and
    returns ``(params, state)``."""

    def __init__(self, lr: float = 1e-2, momentum: float = 0.0, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params) -> dict:
        if self.momentum:
            return {"mom": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
        return {}

    @torch.no_grad()
    def update(self, params, grads, state):
        moms = tree_leaves(state["mom"]) if self.momentum else None
        for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads), strict=True)):
            pf, gf = p.float(), g.float()
            if self.weight_decay:
                gf = gf + pf * self.weight_decay
            if moms is not None:
                gf = moms[i].mul_(self.momentum).add_(gf)
            p.copy_((pf - gf * self.lr).to(p.dtype))
        return params, state
