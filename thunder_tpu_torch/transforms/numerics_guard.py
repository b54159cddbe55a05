"""The numerics guard: NaN/spike detection with a skipped step, for the
port's train steps.

The counterpart of ``thunder_tpu/transforms/numerics_guard.py``:
:class:`NumericsGuardTransform` (below) rewrites a compiled step as the
reference's does (``jit(step, transforms=[guard])``), and
:class:`NumericsGuard` guards the eager ``pretrain.train_step``. The
reference selects ``where(healthy, new, old)`` for every state leaf; the
port's optimizer updates the parameters and moments in place
(``csrc/fused_adamw.cu``), so the verdict must exist on the device before
the update writes anything. In the compiled step each optimizer bucket
takes its health pass and its gated update (the transform's docstring); an
eager guarded step does four things:

1. **Builds the health word on the device.** ``AdamW.health`` runs every
   bucket's health pass — the update's arithmetic without a store — and
   packs the non-finite counts of the grads, the loss and the new state,
   the global grad norm and the loss into one float32 word (layout:
   ``runtime.sentinel.IDX_*``).
2. **Injects deterministically.** When the ``numerics:grads`` /
   ``numerics:loss`` domains of ``runtime.faults.FaultPlan`` fire at this
   step — decided on the host from the schedule, with no device read —
   the grads / the loss are NaN-poisoned on the device before the health
   pass. ``numerics:kernel:<claim>`` poisons a routed kernel's output inside
   its guard (``ops.nn.routed``).
3. **Gates the optimizer.** ``AdamW.update(..., health=word)``: each update
   kernel reads the word and stores nothing unless it is healthy, and the
   step counter advances by the verdict, so a non-finite step leaves
   params, moments and ``step`` bit-identical.
4. **Fetches the word once** (the step's one host sync, as in the
   reference) and calls :meth:`NumericsSentinel.ingest`, which counts skips,
   raises ``LossSpike`` at the step that spiked, and raises
   ``SilentNumericsFault`` after ``bisect_after`` consecutive non-finite
   steps.

On ``SilentNumericsFault`` the guard bisects the kernels the step routed
(the guard's per-claim call counts): each probe re-runs the step — the
skipped step left the state bit-identical, so it is the same step — under
``quarantine.suppress`` and ``sentinel.probing()``, up to the health word,
committing nothing. The attributed claim joins the persisted quarantine and
the step runs again, committed, on the next rung down; corruption no
disabling removes raises ``PersistentNonFinite``. A probe needs a rung
below each suppressed kernel: on the CPU that is the plain version the
router runs there anyway, but on the card the train step's kernels have no
kernel rung below them and the port runs no plain version there, so a
bisection on the card raises ``PersistentNonFinite`` naming the
candidates. Restoring a checkpoint after a ``LossSpike`` is a trainer's
work (not ported yet).
"""

from __future__ import annotations

import torch

from thunder_tpu_torch import ops
from thunder_tpu_torch.core import dtypes, prims
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.fusion_passes import adamw_bucket_key
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.trace import tracectx
from thunder_tpu_torch.core.transform_common import Transform
from thunder_tpu_torch.core.utils import consumed_vars
from thunder_tpu_torch.observe import decisions as _decisions
from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.ops import opsymbol
from thunder_tpu_torch.ops import optim as optim_ops
from thunder_tpu_torch.optim import tree_map
from thunder_tpu_torch.runtime import faults as _faults
from thunder_tpu_torch.runtime import quarantine as _quarantine
from thunder_tpu_torch.runtime import sentinel as _sentinel


def _poison(t):
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t + float("nan")
    return t


class NumericsGuard:
    """Guards train steps with one :class:`NumericsSentinel` (its skip
    counts, loss EWMA and escalation state), configured by ``policy``."""

    fn_name = "train_step"   # the site fault events and replay bundles name

    def __init__(self, *, policy=None):
        self.sentinel = _sentinel.NumericsSentinel(policy=policy)
        self.routed: dict[str, int] = {}   # claims the last step routed, with calls
        self.last_health: list[float] | None = None   # the last step's health word

    def step(self, params, opt, opt_state, loss_and_grads, *, inputs=()):
        """One guarded step. ``loss_and_grads()`` computes ``(loss, grads)``
        from the current ``params`` (called again by a bisection probe and a
        re-run); ``opt`` is an :class:`~thunder_tpu_torch.optim.AdamW` whose
        state ``opt_state`` is updated in place; ``inputs`` go into replay
        bundles. Returns the loss (poisoned when
        ``numerics:loss`` fired)."""
        args = (params, opt, opt_state, loss_and_grads, inputs)
        try:
            return self._run(*args)
        except _sentinel.SilentNumericsFault as err:
            return self._bisect_and_rerun(err, args)

    def _run(self, params, opt, opt_state, loss_and_grads, inputs,
             commit: bool = True):
        sent = self.sentinel
        step = sent.steps + 1   # the step this call will become
        poison_grads = _faults.should_corrupt("numerics:grads", step=step, site=self.fn_name)
        poison_loss = _faults.should_corrupt("numerics:loss", step=step, site=self.fn_name)
        _faults.reset_claim_calls()
        loss, grads = loss_and_grads()
        if poison_grads:
            grads = tree_map(_poison, grads)
        if poison_loss:
            loss = _poison(loss)
        word = opt.health(params, grads, opt_state, loss)
        if commit:
            opt.update(params, grads, opt_state, health=word)
        self.routed = _faults.claim_calls()
        health = word.tolist()   # the one host fetch of the step
        self.last_health = health
        sent._replay_source = (self.fn_name, None, inputs, None)
        try:
            sent.ingest(health, has_state_select=True)
        finally:
            sent._replay_source = None
        return loss

    def _bisect_and_rerun(self, err, args):
        """Attribute persistent non-finite output to routed kernels: probes
        re-run the step with candidate claims suppressed, commit nothing,
        and read the verdict; offenders join the persisted quarantine, then
        the step runs again, committed."""
        sent = self.sentinel
        seen: set[str] = set()
        while True:
            candidates = [c for c in _sentinel.claimed_kernel_ids(self.routed) if c not in seen]
            if candidates:
                _observe.inc("runtime.bisections")
                _observe.event("bisection_started", fn=self.fn_name, candidates=len(candidates))

            def probe(disabled):
                with _quarantine.suppress(disabled), sent.probing():
                    self._run(*args, commit=False)
                return sent.last_verdict is not None and sent.last_verdict.healthy

            try:
                offenders = _sentinel.attribute_offenders(candidates, probe)
            except _faults.KernelExecutionError as e:
                if e.phase != _faults.QUARANTINED:
                    raise
                _observe.event("bisection_unattributed", fn=self.fn_name)
                raise _sentinel.PersistentNonFinite(
                    f"persistent non-finite output of {self.fn_name} cannot be bisected on "
                    f"the card ({e.claim_id} has no kernel rung below it); candidates: "
                    f"{candidates}") from err
            if not offenders:
                _observe.event("bisection_unattributed", fn=self.fn_name)
                raise _sentinel.PersistentNonFinite(
                    f"persistent non-finite output of {self.fn_name} could not be attributed "
                    f"to a routed kernel ({len(candidates)} candidates probed)") from err
            for offender in offenders:
                seen.add(offender)
                _quarantine.get_quarantine().add(
                    offender, phase="numerics",
                    reason=f"silent numerics fault attributed by bisection ({err})")
                _observe.inc("runtime.fallbacks")
                _observe.event("bisection_attributed", fn=self.fn_name, claim=offender)
            sent.reset_episode()   # containment done: the re-run starts clean
            try:
                return self._run(*args)
            except _sentinel.SilentNumericsFault as e2:
                err = e2   # a second corrupt kernel: bisect the rest


def disarmed_policy() -> _sentinel.NumericsPolicy:
    """The policy ``sentinel_overhead_pct`` is measured under, as the
    reference's ``bench.py`` measures it: detection and skipping only, the
    escalation rungs disarmed so an early-training loss swing cannot raise
    out of a timing loop."""
    return _sentinel.NumericsPolicy(spike_zscore=float("inf"), max_rewinds=0, bisect=False,
                                    bisect_after=10 ** 9)


# ---------------------------------------------------------------------------
# the guard on jit: NumericsGuardTransform (thunder_tpu/transforms/numerics_guard.py:69-401)
# ---------------------------------------------------------------------------

@opsymbol(id="sentinel.observe_grads")
def _observe_grads(grads):
    return grads


def observe_grads(grads):
    """Identity marker: tag a tree of gradients for the numerics guard.
    Steps whose gradients do not flow through the optimizer's composites
    (an inline SGD step, a custom update) call ``grads =
    observe_grads(grads)`` before consuming them under ``jit``; the guard
    reads the marker for its grad-health reductions and strips it. Without a
    guard the claim pass drops the marker. Outside a trace it returns
    ``grads``."""
    from thunder_tpu_torch.core.trace import get_tracectx

    if get_tracectx() is None:
        return grads
    from thunder_tpu_torch.torch import on_torch

    return on_torch(_observe_grads)(grads)


def _is_float_tensor(p) -> bool:
    return isinstance(p, TensorProxy) and p.dtype.is_float


def _update_buckets(bsyms) -> list[list[int]]:
    """The optimizer's buckets among ``bsyms`` (indices): the per-parameter
    ``optim.adamw_step``s grouped as the optimizer fusion pass groups them,
    and each ``optim.fused_adamw``/``optim.fused_adamw_slab`` alone."""
    steps: dict = {}
    out = []
    for i, b in enumerate(bsyms):
        sid = b.sym.id
        if sid == "optim.adamw_step" and len(b.args) == 6 and all(
                isinstance(t, TensorProxy) for t in b.args):
            steps.setdefault(adamw_bucket_key(b), []).append(i)
        elif sid in ("optim.fused_adamw", "optim.fused_adamw_slab"):
            out.append([i])
    return sorted(list(steps.values()) + out)


def _bucket_io(bsyms, idx):
    """``(kind, (params, grads, m, v, bc1, bc2), kwargs, outputs)`` of a
    bucket: ``kind`` "step" (per-parameter moments, ``outputs`` (params, ms,
    vs)) or "slab" (``outputs`` (params, (m_slab,), (v_slab,)))."""
    b0 = bsyms[idx[0]]
    if b0.sym.id == "optim.adamw_step":
        group = [bsyms[i] for i in idx]
        args = tuple([b.args[j] for b in group] for j in range(4)) + tuple(b0.args[4:6])
        outs = tuple([b.output[k] for b in group] for k in range(3))
        return "step", args, dict(b0.kwargs), outs
    ps, gs, m, v, bc1, bc2 = b0.args
    if b0.sym.id == "optim.fused_adamw":
        return "step", (list(ps), list(gs), list(m), list(v), bc1, bc2), dict(b0.kwargs), \
            tuple(list(o) for o in b0.output)
    return "slab", (list(ps), list(gs), m, v, bc1, bc2), dict(b0.kwargs), \
        (list(b0.output[0]), [b0.output[1]], [b0.output[2]])


class NumericsGuardTransform(Transform):
    """The reference's ``NumericsGuardTransform`` on the port's ``jit``: a
    trace pass that makes a compiled train step defend itself. One instance
    guards one jitted function; its
    :class:`~thunder_tpu_torch.runtime.sentinel.NumericsSentinel` keeps that
    function's health history.

    - **Pairing**: ``state_argnums`` name the positional arguments that
      carry state and ``state_outputs`` the positions of their new values in
      the step's returned tuple (default ``(0, 1) -> (1, 2)``, the
      ``step(params, opt_state, *batch) -> (loss, params, opt_state)``
      contract); each argument's tree mirrors its output's.
    - **Gradients** come from the optimizer's composites
      (``optim.adamw_step``, ``optim.fused_adamw``, ``optim.fused_adamw_slab``)
      or from :func:`observe_grads` markers.
    - **Injection**: two 0-d float32 poison inputs are appended to the
      trace's signature, fed by ``runtime.faults.should_corrupt
      ("numerics:grads"/"numerics:loss", step=, site=)``: ``g + poison`` at
      each grad's first consumer, ``loss + poison``.
    - **The health word** (``runtime.sentinel.IDX_*``) is appended to the
      outputs; the wrapper fetches it once a step (the step's one host
      sync) and calls :meth:`NumericsSentinel.ingest`.
    - **The skip.** The reference selects ``where(healthy, new, old)`` for
      every state pair; on the card that would keep the old parameters and
      moments alive past the update, and ``donate_in_place`` would then copy
      them. So each optimizer bucket whose outputs are state (no markers)
      takes the port's gated update: its health pass
      (``optim.fused_adamw_health`` / ``optim.fused_adamw_slab_health``,
      one kernel launch a bucket) runs before any update, and the update
      (``optim.fused_adamw_gated`` / ``optim.fused_adamw_slab_gated``) reads
      the word and stores nothing unless it is healthy; its plain version is
      the reference's select. Every other pair (the ``step`` counter, a leaf
      outside a bucket) keeps the select, and the grads and new state
      outside a bucket keep the reference's plain reductions.
    """

    def __init__(self, *, state_argnums=(0, 1), state_outputs=(1, 2),
                 loss_output: int | None = 0, policy=None, sentinel=None, inject: bool = True):
        self.state_argnums = tuple(state_argnums)
        self.state_outputs = tuple(state_outputs)
        self.loss_output = loss_output
        self.sentinel = sentinel or _sentinel.NumericsSentinel(policy=policy)
        self.inject = inject
        self._installed = False
        self._n_extra_inputs = 0
        self._has_pairs = False
        self.gated_buckets = 0   # the last compile's buckets on the gated update

    # -- trace pass ----------------------------------------------------------
    def transform_traces_pre_prologue(self, prologue_trc, computation_trc, epilogue_trc,
                                      **kwargs):
        trc = computation_trc
        in_proxies = getattr(trc, "input_proxies", None)
        in_treedef = getattr(trc, "input_treedef", None)
        check(in_proxies is not None and in_treedef is not None,
              "NumericsGuardTransform needs the traced input structure "
              "(trc.input_proxies/input_treedef): apply it through thunder_tpu_torch.jit")
        pargs, _ = tree_unflatten(in_treedef, list(in_proxies))

        # -- pair old-state inputs with new-state outputs ----------------------
        old_leaves: list = []
        for i in self.state_argnums:
            check(i < len(pargs), lambda: (
                f"NumericsGuardTransform: state_argnums includes {i} but the step takes "
                f"{len(pargs)} positional args"))
            old_leaves.extend(tree_flatten(pargs[i])[0])
        out = trc.output
        check(isinstance(out, (tuple, list)) and len(out) > max(
            (*self.state_outputs, self.loss_output or 0)), lambda: (
            f"NumericsGuardTransform: the step must return a tuple with the state_outputs "
            f"positions {self.state_outputs} (got {type(out).__name__} of length "
            f"{len(out) if isinstance(out, (tuple, list)) else 'n/a'})"))
        new_leaves: list = []
        for i in self.state_outputs:
            new_leaves.extend(tree_flatten(out[i])[0])
        check(len(old_leaves) == len(new_leaves), lambda: (
            f"NumericsGuardTransform: state args flatten to {len(old_leaves)} leaves but state "
            f"outputs to {len(new_leaves)}: state_argnums {self.state_argnums} must mirror "
            f"state_outputs {self.state_outputs}"))
        pairs: list[tuple[TensorProxy, TensorProxy]] = []
        for o, n in zip(old_leaves, new_leaves):
            if not (isinstance(o, TensorProxy) and isinstance(n, TensorProxy)):
                continue   # constants and scalars: nothing to select
            if o.name == n.name:
                continue   # a passthrough leaf: the select is a no-op
            check(tuple(o.shape) == tuple(n.shape) and o.dtype == n.dtype, lambda: (
                f"NumericsGuardTransform: state leaf mismatch: input {o.name} "
                f"{o.dtype}{tuple(o.shape)} against output {n.name} {n.dtype}{tuple(n.shape)}"))
            pairs.append((o, n))
        old_of = {n.name: o for o, n in pairs}

        loss_p = out[self.loss_output] if self.loss_output is not None else None
        if not isinstance(loss_p, TensorProxy):
            loss_p = None

        # -- locate the gradients ----------------------------------------------
        grads: list[TensorProxy] = []
        seen_g: set[Variable] = set()

        def take(g):
            if isinstance(g, TensorProxy) and Variable(g) not in seen_g:
                seen_g.add(Variable(g))
                grads.append(g)

        markers = [i for i, b in enumerate(trc.bound_symbols)
                   if b.sym.id == "sentinel.observe_grads"]
        if markers:
            for i in markers:
                for p in trc.bound_symbols[i].flat_proxy_args():
                    take(p)
            # in place: the trace's scope stack aliases this list
            trc.bound_symbols[:] = [b for i, b in enumerate(trc.bound_symbols)
                                    if i not in set(markers)]
        else:
            for b in trc.bound_symbols:
                if b.sym.id == "optim.adamw_step":
                    take(b.args[1])
                elif b.sym.id in ("optim.fused_adamw", "optim.fused_adamw_slab"):
                    for g in b.args[1]:
                        take(g)

        check(trc.bound_symbols and trc.bound_symbols[-1].sym.id is PrimIDs.PYTHON_RETURN,
              "NumericsGuardTransform: the computation trace has no return")
        trc.bound_symbols.pop()
        dev = next((p.device for p in trc.args if isinstance(p, TensorProxy)), None)

        f32 = dtypes.float32
        poison_g = poison_l = None
        if self.inject:
            with tracectx(trc):
                poison_g = TensorProxy("numerics_poison_grads", shape=(), dtype=f32, device=dev)
                poison_l = TensorProxy("numerics_poison_loss", shape=(), dtype=f32, device=dev)

        # poison the grads at their first consumer: g' = g + poison
        grad_swap: dict[Variable, Proxy] = {}
        if self.inject and grads:
            gvars = {Variable(g) for g in grads}
            insert_at = next((i for i, b in enumerate(trc.bound_symbols)
                              if any(v in gvars for v in consumed_vars(b))),
                             len(trc.bound_symbols))
            scope: list = []
            poisoned = []
            with tracectx(trc):
                trc.push_scope(scope)
                try:
                    for g in grads:
                        if _is_float_tensor(g):
                            gp = ops.add(g, ops.convert_element_type(poison_g, g.dtype))
                            grad_swap[Variable(g)] = gp
                            poisoned.append(gp)
                        else:
                            poisoned.append(g)
                finally:
                    trc.pop_scope()
            tail = [b.from_bsym_swap_proxies(grad_swap, skip_output=True)
                    for b in trc.bound_symbols[insert_at:]]
            trc.bound_symbols[:] = trc.bound_symbols[:insert_at] + scope + tail
            grads = poisoned

        # -- the buckets that take the gated update ----------------------------
        bsyms = trc.bound_symbols
        gated = []
        if not markers:
            for idx in _update_buckets(bsyms):
                kind, args, kw, outs = _bucket_io(bsyms, idx)
                ins = (args[0], args[2], args[3]) if kind == "step" else \
                    (args[0], [args[2]], [args[3]])
                if all(old_of.get(n.name) is not None and old_of[n.name].name == o.name
                       for group_o, group_n in zip(ins, outs)
                       for o, n in zip(group_o, group_n)):
                    gated.append((idx, kind, args, kw, outs))
        members = {i for idx, *_ in gated for i in idx}
        if members:
            out_vars = {Variable(n) for _, _, _, _, outs in gated for group in outs
                        for n in group}
            rest = [b for i, b in enumerate(bsyms) if i not in members]
            if any(v in out_vars for b in rest for v in consumed_vars(b)):
                gated, members = [], set()   # something reads the new state: select
            else:
                bsyms[:] = rest
        self.gated_buckets = len(gated)
        gated_new = {n.name for _, _, _, _, outs in gated for group in outs for n in group}
        gated_grads = {g.name for _, _, args, _, _ in gated for g in args[1]}

        loss_swap: dict[Variable, Proxy] = {}
        select_swap: dict[Variable, Proxy] = {}
        with tracectx(trc):
            def count_nonfinite(t):
                return ops.sum(ops.convert_element_type(ops.logical_not(ops.isfinite(t)), f32))

            zero = ops.full((), 0.0, dtype=f32, device=dev)
            acc = None
            for _, kind, args, kw, _ in gated:
                health = (optim_ops.fused_adamw_health_composite if kind == "step"
                          else optim_ops.fused_adamw_slab_health_composite)(*args, **kw)
                acc = health if acc is None else ops.add(acc, health)
            loss_checked = loss_p
            if loss_p is not None and self.inject:
                loss_checked = ops.add(loss_p, ops.convert_element_type(poison_l, loss_p.dtype))
                loss_swap[Variable(loss_p)] = loss_checked
            nf_grads, normsq, nf_state = zero, zero, zero
            for g in grads:
                if _is_float_tensor(g) and g.name not in gated_grads:
                    nf_grads = ops.add(nf_grads, count_nonfinite(g))
                    gf = ops.convert_element_type(g, f32)
                    normsq = ops.add(normsq, ops.sum(ops.mul(gf, gf)))
            nf_loss = count_nonfinite(loss_checked) if _is_float_tensor(loss_checked) else zero
            for _, n in pairs:
                if _is_float_tensor(n) and n.name not in gated_new:
                    nf_state = ops.add(nf_state, count_nonfinite(n))
            if acc is not None:
                nf_grads = ops.add(ops.convert_element_type(ops.getitem(acc, 0), f32), nf_grads)
                nf_state = ops.add(ops.convert_element_type(ops.getitem(acc, 2), f32), nf_state)
                grad_norm = ops.convert_element_type(ops.sqrt(ops.add(
                    ops.getitem(acc, 1), ops.convert_element_type(normsq, dtypes.float64))), f32)
            else:
                grad_norm = ops.sqrt(normsq)
            loss_f = (ops.convert_element_type(loss_checked, f32)
                      if _is_float_tensor(loss_checked) else zero)
            health_word = ops.stack([nf_grads, nf_loss, nf_state, grad_norm, loss_f], 0)
            for _, kind, args, kw, outs in gated:
                update = (optim_ops.fused_adamw_gated_composite if kind == "step"
                          else optim_ops.fused_adamw_slab_gated_composite)
                new = update(*args, health_word, **kw)
                new = new if kind == "step" else (new[0], (new[1],), (new[2],))
                for group_o, group_n in zip(outs, new):
                    for o, n in zip(group_o, group_n):
                        select_swap[Variable(o)] = n
            ok = optim_ops.healthy_of(health_word)
            for o, n in pairs:
                if n.name not in gated_new:
                    select_swap[Variable(n)] = ops.where(ok, n, o)

            # the output: new state (selected or gated), the poisoned loss and
            # grads where they are returned, the health word appended
            flat_out, out_tdef = tree_flatten(trc.output)
            swapped = []
            for x in flat_out:
                if isinstance(x, Proxy):
                    v = Variable(x)
                    for m in (select_swap, loss_swap, grad_swap):
                        if v in m:
                            x = m[v]
                            break
                swapped.append(x)
            new_output = (tree_unflatten(out_tdef, swapped), health_word)
            prims.python_return(new_output)
        trc.output = new_output
        if self.inject:
            trc.args = list(trc.args) + [poison_g, poison_l]
            self._n_extra_inputs = 2
        self._installed = True
        self._has_pairs = bool(pairs)
        return prologue_trc, trc, epilogue_trc

    # -- jit's runtime hooks -------------------------------------------------
    def wrap_run_fn(self, tfn, entry, inner):
        """The entry's runtime wrapper: feed the poison inputs (0-d float32
        tensors on the inputs' device, made anew a call, so a CUDA graph
        copies their 8 bytes in), peel the health word (the step's one host
        fetch) and drive the sentinel."""
        if not self._installed:
            return inner
        sent = self.sentinel
        n_extra = self._n_extra_inputs
        has_pairs = self._has_pairs
        fn_name = tfn.fn_name
        entry_decisions = _decisions.current_log()

        def guarded(*inps):
            step = sent.steps + 1   # the step this call will become
            if n_extra:
                dev = next((t.device for t in inps if isinstance(t, torch.Tensor)),
                           tfn._default_device())
                pg, pl = (torch.full((), float("nan") if _faults.should_corrupt(
                    domain, step=step, site=fn_name) else 0.0, dtype=torch.float32, device=dev)
                    for domain in ("numerics:grads", "numerics:loss"))
                inps = (*inps, pg, pl)
            core, health = inner(*inps)
            sent._replay_source = (fn_name, entry, inps, entry_decisions)
            try:
                sent.ingest(health.tolist(), has_state_select=has_pairs)
            except _sentinel.SilentNumericsFault as e:
                e.transform = self
                e.entry = entry
                raise
            finally:
                sent._replay_source = None
            return core

        guarded.__wrapped__ = inner
        return guarded
