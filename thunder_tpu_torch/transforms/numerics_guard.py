"""The numerics guard: NaN/spike detection with a skipped step, for the
port's train step.

The counterpart of ``thunder_tpu/transforms/numerics_guard.py``'s
``NumericsGuardTransform``. The reference rewrites a traced step: it fuses
health reductions into the program and selects ``where(healthy, new, old)``
for every state leaf. The port runs eagerly and its optimizer updates the
parameters and moments in place (``csrc/fused_adamw.cu``), so the verdict
must exist on the device before the update writes anything. A guarded step
therefore does four things:

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

from thunder_tpu_torch.observe import registry as _observe
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

    def step(self, params, opt, opt_state, loss_and_grads, *, opt_events=None, inputs=()):
        """One guarded step. ``loss_and_grads()`` computes ``(loss, grads)``
        from the current ``params`` (called again by a bisection probe and a
        re-run); ``opt`` is an :class:`~thunder_tpu_torch.optim.AdamW` whose
        state ``opt_state`` is updated in place; ``opt_events``, a pair of
        CUDA events, are recorded around the gated update; ``inputs`` go
        into replay bundles. Returns the loss (poisoned when
        ``numerics:loss`` fired)."""
        args = (params, opt, opt_state, loss_and_grads, opt_events, inputs)
        try:
            return self._run(*args)
        except _sentinel.SilentNumericsFault as err:
            return self._bisect_and_rerun(err, args)

    def _run(self, params, opt, opt_state, loss_and_grads, opt_events, inputs,
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
            if opt_events:
                opt_events[0].record()
            opt.update(params, grads, opt_state, health=word)
            if opt_events:
                opt_events[1].record()
        self.routed = _faults.claim_calls()
        health = word.tolist()   # the one host fetch of the step
        self.last_health = health
        sent._replay_source = (self.fn_name, inputs, None)
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
