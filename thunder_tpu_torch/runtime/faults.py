"""Layered fault injection: named domains, deterministic schedules.

The port's own copy of ``thunder_tpu/runtime/faults.py``: a
:class:`FaultPlan` holds :class:`FaultSpec` entries addressed to
*injection domains*, and the port calls :func:`maybe_fail` at each layer's
hook point:

==========================  ==================================================
domain                      hook point
==========================  ==================================================
``kernel:<claim>``          every kernel router of ``ops/nn.py`` and
                            ``ops/optim.py`` (:func:`kernel_guard`), e.g.
                            ``kernel:cuda.rms_norm``; it fires before the
                            launch, on the card and on the CPU alike (where
                            the plain version stands in for the kernel)
``checkpoint_io``           ``checkpoint.save_checkpoint``, before anything
                            is written
``numerics:grads``          the gradients / loss of a
``numerics:loss``           ``transforms.numerics_guard`` guarded step,
                            poisoned with NaN on the device (the host decides
                            from the schedule; no device read)
``numerics:kernel:<claim>`` NaN-poisons the output of that routed kernel
                            inside :func:`kernel_guard` (``transient=False``
                            keeps it corrupt on every call while the spec
                            lives, which bisection probes rely on)
==========================  ==================================================

The reference's other domains (``compile``, ``dispatch``, ``collective``,
``step``, ``serving:*``) are accepted names with no hook in the port yet.

Schedules are deterministic so chaos tests are reproducible: explicit step
sets (``at_steps``), every-N invocation counting (``every_n``), or seeded
probability (``probability`` + ``seed``). ``transient=True`` (default) makes
a fault fire once per schedule point and then clear — the retry/replay path
sees a healthy system; ``transient=False`` is a permanent fault that fires
on every matching invocation (bounded by ``max_fires``). The kernel guard
passes no step, so a ``kernel:*`` spec is scheduled by ``every_n`` (with
``max_fires``) or fires on its first call.

When no plan is installed every hook costs one module-global ``is None``
check — the production path pays nothing.

Claim ids are ``cuda.<kernel>``, the kernel's name in
``executors.cudaex.KERNELS``; each stands for the reference's
``pallas.<op>`` claim of the same kernel (``cuda.decode_layer`` for
``pallas.decode_layer``).
"""

from __future__ import annotations

import functools
import random
import threading
from contextlib import contextmanager
from typing import Callable

from thunder_tpu_torch.observe import registry as _observe


class InjectedFault(RuntimeError):
    """Raised by :func:`maybe_fail` when a :class:`FaultSpec` fires."""

    def __init__(self, message: str, *, domain: str = "", step: int | None = None,
                 transient: bool = True):
        super().__init__(message)
        self.domain = domain
        self.step = step
        self.transient = transient


# the phase of a KernelExecutionError raised by a routed-off kernel on the card
QUARANTINED = "quarantined"


class KernelExecutionError(RuntimeError):
    """A routed kernel failed. Carries the claim id (``cuda.<kernel>``) so
    the caller can quarantine exactly that kernel and run the step again on
    the next rung down instead of taking the job down.

    ``phase`` is ``"runtime"`` for every failure the port's guard
    attributes (PyTorch runs eagerly: there is no compile phase), and
    :data:`QUARANTINED` when a router was called on the card while the
    quarantine routes its kernel off and no kernel rung lies below it: the
    port never runs a plain version on the card, so that error is fatal
    (``retry.classify``) and nothing replays it.
    """

    def __init__(self, claim_id: str, phase: str = "runtime",
                 cause: BaseException | None = None):
        if phase == QUARANTINED:
            msg = (f"claimed kernel {claim_id!r} is quarantined and no kernel rung lies below "
                   f"it: the port runs no plain version on the card")
        else:
            msg = f"claimed kernel {claim_id!r} failed at {phase} time: {cause!r}"
        super().__init__(msg)
        self.claim_id = claim_id
        self.phase = phase


class KernelLaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error (``cudaex._launch``): the one
    failure of a built kernel that :func:`kernel_guard` attributes to its
    claim. The message names the code ("CUDA error 700")."""


class KernelBuildError(RuntimeError):
    """The kernels could not be built or bound (no CUDA card, no ``nvcc``,
    a source that does not compile). Every kernel shares the one build, so
    no single claim is at fault: it propagates unattributed and is fatal."""


class FaultSpec:
    """One injected fault: a domain plus a deterministic schedule.

    Exactly-one-of ``at_steps`` / ``every_n`` / ``probability`` selects the
    schedule; with none given the spec fires on every matching invocation
    (once total when ``transient``).
    """

    __slots__ = ("domain", "at_steps", "every_n", "probability", "seed",
                 "transient", "max_fires", "exc", "_rng", "_calls", "_fires",
                 "_fired_steps")

    def __init__(self, domain: str, *, at_steps=None, every_n: int | None = None,
                 probability: float | None = None, seed: int = 0,
                 transient: bool = True, max_fires: int | None = None,
                 exc: Callable[[str], BaseException] | None = None):
        self.domain = domain
        self.at_steps = set(at_steps) if at_steps is not None else None
        self.every_n = every_n
        self.probability = probability
        self.seed = seed
        self.transient = transient
        self.max_fires = max_fires
        self.exc = exc
        self._rng = random.Random(seed)
        self._calls = 0
        self._fires = 0
        self._fired_steps: set[int] = set()

    def matches(self, domain: str) -> bool:
        if self.domain.endswith("*"):
            return domain.startswith(self.domain[:-1])
        return domain == self.domain

    def should_fire(self, step: int | None) -> bool:
        """Advance this spec's deterministic schedule by one invocation and
        report whether the fault fires. Not thread-safe on its own — the
        owning :class:`FaultPlan` serializes calls."""
        self._calls += 1
        if self.max_fires is not None and self._fires >= self.max_fires:
            return False
        if self.at_steps is not None:
            if step is None or step not in self.at_steps:
                return False
            if self.transient and step in self._fired_steps:
                return False
            self._fired_steps.add(step)
        elif self.every_n is not None:
            if self._calls % self.every_n != 0:
                return False
        elif self.probability is not None:
            if self._rng.random() >= self.probability:
                return False
        elif self.transient and self._fires > 0:
            # unscheduled transient fault: fires exactly once, ever
            return False
        self._fires += 1
        return True


class FaultPlan:
    """A set of :class:`FaultSpec` entries consulted by every hook point."""

    def __init__(self, specs=()):
        self.specs = list(specs)
        self._lock = threading.Lock()

    def add(self, spec: FaultSpec) -> "FaultPlan":
        self.specs.append(spec)
        return self

    def maybe_fail(self, domain: str, *, step: int | None = None,
                   site: str | None = None) -> None:
        for spec in self.specs:
            if not spec.matches(domain):
                continue
            with self._lock:
                fire = spec.should_fire(step)
            if not fire:
                continue
            _observe.inc("runtime.faults_injected")
            _observe.event("fault_injected", domain=domain, step=step, site=site,
                           transient=spec.transient)
            where = f" at step {step}" if step is not None else ""
            at = f" ({site})" if site else ""
            if spec.exc is not None:
                raise spec.exc(f"injected fault in domain {domain!r}{where}{at}")
            raise InjectedFault(
                f"injected {'transient' if spec.transient else 'permanent'} "
                f"fault in domain {domain!r}{where}{at}",
                domain=domain, step=step, transient=spec.transient)

    def should_corrupt(self, domain: str, *, step: int | None = None,
                       site: str | None = None) -> bool:
        """Silent-data variant of :meth:`maybe_fail` for the ``numerics:*``
        domains: advances the matching specs' schedules and reports whether
        a corruption fires (the caller poisons values instead of raising)."""
        for spec in self.specs:
            if not spec.matches(domain):
                continue
            with self._lock:
                fire = spec.should_fire(step)
            if fire:
                _observe.inc("runtime.faults_injected")
                _observe.event("numeric_fault_injected", domain=domain, step=step,
                               site=site, transient=spec.transient)
                return True
        return False


# ---------------------------------------------------------------------------
# the process-wide active plan (None = zero-cost hooks)
# ---------------------------------------------------------------------------

_active_plan: FaultPlan | None = None


def install(plan: FaultPlan | None) -> None:
    """Install ``plan`` process-wide (``None`` clears it)."""
    global _active_plan
    _active_plan = plan


def clear() -> None:
    install(None)


def active_plan() -> FaultPlan | None:
    return _active_plan


@contextmanager
def active(plan: FaultPlan):
    """Scope a plan to a ``with`` block (restores the previous plan)."""
    global _active_plan
    prev = _active_plan
    _active_plan = plan
    try:
        yield plan
    finally:
        _active_plan = prev


def maybe_fail(domain: str, *, step: int | None = None,
               site: str | None = None) -> None:
    """The hook every instrumented layer calls. One ``is None`` check when
    no plan is installed."""
    if _active_plan is None:
        return
    _active_plan.maybe_fail(domain, step=step, site=site)


def should_corrupt(domain: str, *, step: int | None = None,
                   site: str | None = None) -> bool:
    """Hook for the silent-data (``numerics:*``) domains: True when a value
    corruption should be injected now. One ``is None`` check when no plan is
    installed."""
    if _active_plan is None:
        return False
    return _active_plan.should_corrupt(domain, step=step, site=site)


def poison_tree(tree):
    """NaN-poison every floating tensor leaf of ``tree`` (tensors, and
    tuples, lists and dicts of them): each becomes ``x + nan``, a new
    tensor. Integer and non-tensor leaves pass through untouched."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree + float("nan") if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(poison_tree(t) for t in tree)
    if isinstance(tree, dict):
        return {k: poison_tree(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# kernel guard: fault hook + failure attribution for routed kernels
# ---------------------------------------------------------------------------

# calls each guard has taken, by claim id: the claims a step routed to their
# kernels (the numerics sentinel's bisection candidates)
_claim_calls: dict[str, list] = {}


def claim_calls() -> dict[str, int]:
    """Calls each guarded router has taken since :func:`reset_claim_calls`,
    by claim id (a router the quarantine sends to its fallback is not
    entered, so it is not counted)."""
    return {k: c[0] for k, c in _claim_calls.items() if c[0]}


def reset_claim_calls() -> None:
    for c in _claim_calls.values():
        c[0] = 0


def kernel_guard(claim_id: str, fn: Callable) -> Callable:
    """Wrap a kernel router (``ops/nn.py``, ``ops/optim.py``):

    1. fault hook for the ``kernel:<claim_id>`` injection domain, and
       ``numerics:kernel:<claim_id>`` output poisoning;
    2. failure attribution — a failed launch (:class:`KernelLaunchError`)
       or an injected fault escaping the router is re-raised as
       :class:`KernelExecutionError` carrying ``claim_id``, so the caller
       can quarantine the kernel and take the next rung down;
    3. a per-claim call count (:func:`claim_calls`).

    Every other exception passes through unchanged and never enters the
    quarantine: a refusal (the ``ValueError`` a wrapper raises on inputs its
    kernel does not take, ``cudaex.refusal``) is the caller's error; a build
    failure (:class:`KernelBuildError`), an allocation failure or a shape
    error is no fault of this kernel's code; an error a nested guard
    already attributed keeps its claim.
    """
    domain = f"kernel:{claim_id}"
    numerics_domain = f"numerics:{domain}"
    calls = _claim_calls.setdefault(claim_id, [0])

    @functools.wraps(fn)
    def guarded(*args, **kwargs):
        calls[0] += 1
        try:
            if _active_plan is None:
                return fn(*args, **kwargs)
            maybe_fail(domain, site=claim_id)
            out = fn(*args, **kwargs)
            # silent-data fault: the kernel "succeeds" but returns garbage —
            # the failure mode the numerics sentinel exists to catch
            if should_corrupt(numerics_domain, site=claim_id):
                out = poison_tree(out)
            return out
        except (KernelLaunchError, InjectedFault) as e:
            raise KernelExecutionError(claim_id, phase="runtime", cause=e) from e

    guarded.__wrapped__ = fn
    guarded.claim_id = claim_id
    return guarded
