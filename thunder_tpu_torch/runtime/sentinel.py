"""Numerical integrity sentinel: the host side of the NaN/spike defense.

The port's own copy of ``thunder_tpu/runtime/sentinel.py``. The worst
production failure mode is silent — NaN/Inf gradients, loss spikes, a
numerically corrupt kernel returning garbage without an exception —
poisoning the model until someone eyeballs the loss curve. The defense has
two halves:

- **On the device** (``thunder_tpu_torch.transforms.numerics_guard``): every
  guarded train step builds a small f32 *health word* — the non-finite
  counts of the grads, the loss and the new state, the global grad norm,
  the loss — from the optimizer's health pass (``csrc/fused_adamw.cu``),
  and the optimizer's update is gated on it, so a non-finite step is
  *skipped* with bit-identical state and no host round-trip before the
  update. Detection costs one health-word fetch per step.
- **Host-side** (this module): :class:`NumericsSentinel` consumes the health
  word per step and drives the response ladder of :class:`NumericsPolicy`:

  1. *skip-and-count* — a transient non-finite step was already skipped
     on the device; the sentinel counts it (``runtime.nonfinite_steps`` /
     ``runtime.skipped_steps``) and moves on,
  2. *rewind* — a finite loss that spikes against its EWMA (z-score over
     ``spike_zscore``) raises :class:`LossSpike`; restoring the last
     checkpoint and replaying is the trainer's (not ported yet: without one
     the exception reaches the caller, as in the reference),
  3. *bisect* — ``bisect_after`` consecutive non-finite steps raise
     :class:`SilentNumericsFault`; the guard runs :func:`bisect_offender` —
     re-running the step with routed kernels disabled
     (``runtime.quarantine.suppress``) — and feeds the attributed claim id
     into the persisted kernel quarantine, so silent faults reach the same
     quarantine as crashes (``runtime.bisections`` /
     ``runtime.bisection_probes``).

Every anomaly can dump a *replay bundle* (verdict, step inputs) for offline
repro: set ``NumericsPolicy.replay_dir``.

Chaos-test the whole ladder with the ``numerics:*`` fault domains of
``runtime.faults.FaultPlan`` (``numerics:grads``, ``numerics:loss``,
``numerics:kernel:<claim>``).
"""

from __future__ import annotations

import json
import math
import os
import time
from contextlib import contextmanager

from thunder_tpu_torch.observe import registry as _observe


class NumericsAnomaly(RuntimeError):
    """Base for sentinel-detected anomalies (classified retryable)."""


class LossSpike(NumericsAnomaly):
    """Finite loss spiked against its EWMA: rewind to the last committed
    checkpoint and replay in data order."""

    def __init__(self, *, step: int, loss: float, ewma: float, z: float):
        super().__init__(f"loss spike at sentinel step {step}: loss={loss:.6g} "
                         f"vs ewma={ewma:.6g} (z={z:.2f})")
        self.step = step
        self.loss = loss
        self.ewma = ewma
        self.z = z
        self.sentinel = None  # set by the raising NumericsSentinel so the
        # supervisor can notify_rewind() with the replay length


class PersistentNonFinite(NumericsAnomaly):
    """Non-finite steps persisted and bisection could not attribute them to
    a claimed kernel (or was disabled): the corruption is upstream of the
    custom kernels (model divergence, data poisoning, chip fault)."""


class SilentNumericsFault(NumericsAnomaly):
    """Internal control flow: repeated non-finite steps — the numerics guard
    catches this and runs the bisection (it holds the step's arguments
    needed to re-run probes)."""

    def __init__(self, verdict: "Verdict", message: str = ""):
        super().__init__(message or f"persistent non-finite step: {verdict}")
        self.verdict = verdict


class NumericsPolicy:
    """Configuration for the response ladder.

    - ``spike_zscore`` / ``ewma_alpha`` / ``warmup_steps``: a finite loss
      whose z-score against the running EWMA (updated with ``ewma_alpha``)
      exceeds ``spike_zscore`` — after ``warmup_steps`` healthy steps — is a
      spike.
    - ``max_rewinds``: total :class:`LossSpike` raises; past the budget a
      spike is *accepted* (folded into the EWMA) so a deterministic replay
      that re-hits the same spike cannot rewind forever.
    - ``bisect_after`` consecutive non-finite steps trigger bisection;
      ``bisect=False`` raises :class:`PersistentNonFinite` instead.
    - ``replay_dir``: where anomaly replay bundles are dumped (``None`` =
      no dumps); ``dump_inputs=False`` keeps the step inputs out of the
      bundle (they can be model-sized).
    """

    def __init__(self, *, spike_zscore: float = 6.0, ewma_alpha: float = 0.05,
                 warmup_steps: int = 10, max_rewinds: int = 2,
                 bisect_after: int = 3, bisect: bool = True,
                 replay_dir: str | None = None, dump_inputs: bool = True):
        self.spike_zscore = spike_zscore
        self.ewma_alpha = ewma_alpha
        self.warmup_steps = warmup_steps
        self.max_rewinds = max_rewinds
        self.bisect_after = bisect_after
        self.bisect = bisect
        self.replay_dir = replay_dir
        self.dump_inputs = dump_inputs


# process-installed policy: a trainer installs it here so guards built
# without an explicit policy pick up the trainer's
_installed_policy: NumericsPolicy | None = None


def install_policy(policy: NumericsPolicy | None) -> NumericsPolicy | None:
    """Install ``policy`` process-wide; returns the previous one (restore it
    when a supervision scope ends)."""
    global _installed_policy
    prev = _installed_policy
    _installed_policy = policy
    return prev


def installed_policy() -> NumericsPolicy | None:
    return _installed_policy


# health-word layout (the f32 vector the numerics guard builds on the device)
IDX_NONFINITE_GRADS = 0
IDX_NONFINITE_LOSS = 1
IDX_NONFINITE_STATE = 2
IDX_GRAD_NORM = 3
IDX_LOSS = 4
HEALTH_SIZE = 5


class Verdict:
    """One step's parsed health word."""

    __slots__ = ("step", "nonfinite_grads", "nonfinite_loss", "nonfinite_state",
                 "grad_norm", "loss", "healthy", "skipped", "probe")

    def __init__(self, word, *, step: int = 0, probe: bool = False):
        import numpy as np

        w = np.asarray(word, dtype=np.float64).reshape(-1)
        self.step = step
        self.nonfinite_grads = float(w[IDX_NONFINITE_GRADS])
        self.nonfinite_loss = float(w[IDX_NONFINITE_LOSS])
        self.nonfinite_state = float(w[IDX_NONFINITE_STATE])
        self.grad_norm = float(w[IDX_GRAD_NORM])
        self.loss = float(w[IDX_LOSS])
        total = self.nonfinite_grads + self.nonfinite_loss + self.nonfinite_state
        # a NaN count (the reductions themselves corrupted) is unhealthy too
        self.healthy = math.isfinite(total) and total == 0.0
        self.skipped = not self.healthy
        self.probe = probe

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return (f"<Verdict step={self.step} healthy={self.healthy} "
                f"nonfinite=(g={self.nonfinite_grads:.0f} l={self.nonfinite_loss:.0f} "
                f"s={self.nonfinite_state:.0f}) grad_norm={self.grad_norm:.4g} "
                f"loss={self.loss:.6g}>")


class NumericsSentinel:
    """Per-guard host state machine: consumes health words, keeps the loss
    EWMA and skip counters, raises the ladder's anomalies."""

    def __init__(self, policy: NumericsPolicy | None = None):
        self._policy = policy
        self.steps = 0              # health words ingested (non-probe)
        self.healthy_steps = 0
        self.nonfinite_steps = 0
        self.skipped_steps = 0
        self.consecutive_nonfinite = 0
        self.rewind_raises = 0      # LossSpike raises (the trainer rewinds)
        self.spikes_accepted = 0    # spikes past the rewind budget
        self.ewma_mean: float | None = None
        self.ewma_var = 0.0
        self.last_verdict: Verdict | None = None
        self._probing = 0
        self._fold_suppress = 0  # healthy losses to re-judge but NOT re-fold
        # (set via notify_rewind: the rewind's replayed steps were already
        # folded once; folding them again would deflate the EWMA variance)
        self._replay_source = None  # (fn_name, inputs, decisions) set per
        # call by the guard so bundles can include the exact step inputs

    @property
    def policy(self) -> NumericsPolicy:
        if self._policy is not None:
            return self._policy
        return _installed_policy or _DEFAULT_POLICY

    # -- probe mode (bisection) ---------------------------------------------
    @contextmanager
    def probing(self):
        """Bisection probes parse health words (``last_verdict``) without
        counting, EWMA updates, or anomaly raises."""
        self._probing += 1
        try:
            yield
        finally:
            self._probing -= 1

    def reset_episode(self) -> None:
        """Called after a successful containment (e.g. the bisected kernel
        was quarantined) so the re-run doesn't immediately re-escalate."""
        self.consecutive_nonfinite = 0

    def notify_rewind(self, replay_steps: int) -> None:
        """The supervisor restored a checkpoint and is about to replay
        ``replay_steps`` steps this sentinel has already seen. Replayed
        healthy losses are re-*judged* against the frozen pre-spike
        statistics but not re-*folded* — re-folding near-identical values
        shrinks the variance each rewind, making ordinary post-rewind
        wiggles look like spikes. Every replayed ingest (healthy or
        device-skipped) consumes one slot of the window, mirroring
        whether it folded in its first life."""
        self._fold_suppress += max(int(replay_steps), 0)

    # -- ingestion ----------------------------------------------------------
    def ingest(self, health_word, *, has_state_select: bool = True) -> Verdict:
        if self._probing:
            v = Verdict(health_word, step=self.steps, probe=True)
            self.last_verdict = v
            return v
        pol = self.policy
        self.steps += 1
        v = Verdict(health_word, step=self.steps)
        self.last_verdict = v
        if not v.healthy:
            if self._fold_suppress > 0:
                # a replayed SKIPPED step: it never folded in its first life
                # either, but it still occupies one slot of the replay window
                self._fold_suppress -= 1
            self.nonfinite_steps += 1
            self.consecutive_nonfinite += 1
            _observe.inc("runtime.nonfinite_steps")
            if has_state_select:
                self.skipped_steps += 1
                _observe.inc("runtime.skipped_steps")
            _observe.event("sentinel_skip", step=v.step,
                           nonfinite_grads=v.nonfinite_grads,
                           nonfinite_loss=v.nonfinite_loss,
                           nonfinite_state=v.nonfinite_state,
                           consecutive=self.consecutive_nonfinite)
            if self.consecutive_nonfinite == 1:
                self.maybe_dump("skip", v)
            if self.consecutive_nonfinite >= pol.bisect_after:
                self.maybe_dump("persistent_nonfinite", v)
                if pol.bisect:
                    raise SilentNumericsFault(v)
                raise PersistentNonFinite(
                    f"{self.consecutive_nonfinite} consecutive non-finite "
                    f"steps (bisection disabled)")
            return v
        # healthy step
        self.consecutive_nonfinite = 0
        self.healthy_steps += 1
        if math.isfinite(v.grad_norm):
            # an f32 sumsq can overflow to inf on finite-but-huge grads; a
            # non-finite sample would permanently corrupt the histogram sum
            _observe.observe_value("runtime.grad_norm", v.grad_norm)
        if math.isfinite(v.loss):
            self._check_spike_and_fold(v, pol)
        return v

    def _check_spike_and_fold(self, v: Verdict, pol: NumericsPolicy) -> None:
        if self.ewma_mean is None:
            self.ewma_mean = v.loss
            self.ewma_var = 0.0
            _observe.set_gauge("runtime.loss_ewma", self.ewma_mean)
            return
        std = math.sqrt(max(self.ewma_var, 0.0))
        # floor: relative to the mean so a flat early loss curve doesn't make
        # every wiggle an infinite-z spike
        floor = 1e-3 * abs(self.ewma_mean) + 1e-8
        z = (v.loss - self.ewma_mean) / max(std, floor)
        if self.healthy_steps > pol.warmup_steps and z > pol.spike_zscore:
            if self.rewind_raises < pol.max_rewinds:
                self.rewind_raises += 1
                _observe.event("sentinel_spike", step=v.step, loss=v.loss,
                               ewma=self.ewma_mean, z=z)
                self.maybe_dump("spike", v)
                # NOT folded into the EWMA: the replay re-judges this loss
                # against the pre-spike statistics. The exception carries the
                # sentinel so the supervisor can notify_rewind() with the
                # replay length once the restore actually happens.
                err = LossSpike(step=v.step, loss=v.loss, ewma=self.ewma_mean, z=z)
                err.sentinel = self
                raise err
            self.spikes_accepted += 1
            _observe.event("sentinel_spike_accepted", step=v.step, loss=v.loss,
                           z=z, rewinds_spent=self.rewind_raises)
        if self._fold_suppress > 0:
            # a replayed step after a rewind: judged above, already folded
            # in its first life — skip the refold
            self._fold_suppress -= 1
            return
        d = v.loss - self.ewma_mean
        a = pol.ewma_alpha
        self.ewma_mean += a * d
        self.ewma_var = (1.0 - a) * (self.ewma_var + a * d * d)
        _observe.set_gauge("runtime.loss_ewma", self.ewma_mean)

    # -- replay bundles ------------------------------------------------------
    def maybe_dump(self, kind: str, verdict: Verdict) -> str | None:
        pol = self.policy
        if pol.replay_dir is None:
            return None
        try:
            fn_name, inps, decisions = self._replay_source or ("fn", None, None)
            return dump_replay_bundle(
                pol.replay_dir, kind=kind, verdict=verdict, fn_name=fn_name,
                inputs=inps if pol.dump_inputs else None, decisions=decisions)
        except Exception:
            return None  # diagnostics must never take the step down

    # -- reporting -----------------------------------------------------------
    def summary(self) -> str:
        lines = [f"steps={self.steps} healthy={self.healthy_steps} "
                 f"nonfinite={self.nonfinite_steps} skipped={self.skipped_steps}",
                 f"rewind_raises={self.rewind_raises} "
                 f"spikes_accepted={self.spikes_accepted}"]
        if self.ewma_mean is not None:
            lines.append(f"loss ewma={self.ewma_mean:.6g} "
                         f"std={math.sqrt(max(self.ewma_var, 0.0)):.4g}")
        if self.last_verdict is not None:
            lines.append(f"last: {self.last_verdict!r}")
        return "\n".join(lines)


_DEFAULT_POLICY = NumericsPolicy()


# ---------------------------------------------------------------------------
# bisection: attribute persistent non-finite output to one claimed kernel
# ---------------------------------------------------------------------------

def claimed_kernel_ids(calls: dict) -> list[str]:
    """Claim ids of the kernels a step routed — the bisection candidate set:
    the claims with a non-zero count in ``calls``, the kernel guard's
    per-claim call counts over the step (``runtime.faults.claim_calls()``).
    A claim the quarantine sent to its fallback was not entered, so it is
    not a candidate."""
    return sorted(c for c, n in calls.items() if n)


def _memoized_probe(probe):
    last = {"set": None, "healthy": None}

    def _probe(disabled):
        key = frozenset(disabled)
        if key == last["set"]:
            return last["healthy"]  # a probe is a full step — never
            # repeat the identical configuration (e.g. the final confirm
            # after the search already ended on that exact set)
        _observe.inc("runtime.bisection_probes")
        last["set"], last["healthy"] = key, bool(probe(key))
        return last["healthy"]

    return _probe


def attribute_offenders(candidates, probe) -> list[str]:
    """Attribute persistent non-finite output to claimed kernels.

    ``probe(disabled: frozenset[str]) -> bool`` must re-run the step with
    those claim ids disabled (``quarantine.suppress``) on the failing
    inputs, committing nothing, and report
    whether the health word came back healthy. Fast path: binary search for
    the single offender (log2 probes — the overwhelmingly common case).
    When the search fails but disabling EVERY candidate was healthy, the
    fault is provably kernel-borne with multiple simultaneous offenders —
    fall back to a linear leave-one-enabled sweep (each candidate enabled
    alone against the rest disabled; unhealthy means it corrupts by
    itself). Returns ``[]`` when disabling everything still yields
    non-finite output (the corruption is upstream of the custom kernels)."""
    cands = sorted(candidates)
    if not cands:
        return []
    _probe = _memoized_probe(probe)
    if not _probe(cands):
        return []  # all custom kernels off, still corrupt: not kernel-borne
    search = list(cands)
    while len(search) > 1:
        half = search[:len(search) // 2]
        if _probe(half):
            search = half  # disabling this group removed the corruption
        else:
            search = search[len(search) // 2:]
    if _probe(search):
        return [search[0]]
    # multiple simultaneous offenders: x is one iff the step stays corrupt
    # with ONLY x enabled (every other candidate disabled)
    offenders = [x for x in cands if not _probe(set(cands) - {x})]
    if offenders and _probe(offenders):
        return offenders
    return []


def bisect_offender(candidates, probe) -> str | None:
    """Single-offender form of :func:`attribute_offenders` (``None`` for
    upstream corruption or multi-offender attribution)."""
    offs = attribute_offenders(candidates, probe)
    return offs[0] if len(offs) == 1 else None


# ---------------------------------------------------------------------------
# replay bundles
# ---------------------------------------------------------------------------

def _host_array(x):
    import numpy as np

    if hasattr(x, "detach"):   # a tensor: bf16/fp16 leave as float32
        x = x.detach().cpu()
        if x.is_floating_point() and x.dtype.itemsize < 4:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def dump_replay_bundle(directory: str, *, kind: str, verdict: Verdict,
                       fn_name: str = "fn", inputs=None, decisions=None) -> str:
    """Write an offline-repro bundle for an anomaly: ``meta.json`` (verdict,
    the kernels the step routed, time) plus ``inputs.npz`` (the exact step
    inputs, when provided: tensors as numpy, 16-bit floats as float32).
    Returns the bundle directory."""
    import numpy as np

    bundle = os.path.join(
        os.path.abspath(directory),
        f"{fn_name}-step{verdict.step}-{kind}-{int(time.time() * 1e3)}")
    os.makedirs(bundle, exist_ok=True)
    meta: dict = {"kind": kind, "fn": fn_name, "time": time.time(),
                  "verdict": verdict.to_dict()}
    if decisions is not None:
        meta["decisions"] = decisions
    with open(os.path.join(bundle, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    if inputs is not None:
        arrays = {}
        for i, x in enumerate(inputs):
            try:
                arrays[f"arg{i}"] = _host_array(x)
            except Exception:
                continue
        if arrays:
            np.savez(os.path.join(bundle, "inputs.npz"), **arrays)
    # the anomaly's kind as "anomaly": ``kind`` is the event's own name
    # (the reference passes kind=, which collides with it and raises)
    _observe.event("replay_bundle", anomaly=kind, path=bundle)
    return bundle
