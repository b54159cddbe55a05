"""thunder_tpu_torch.runtime: the fault-domain runtime, the port's
counterpart of ``thunder_tpu/runtime/``.

- ``faults``: layered fault injection — a :class:`FaultPlan` names
  injection *domains* (``kernel:<claim>``, ``checkpoint_io``,
  ``numerics:*``) with deterministic schedules, and :func:`faults.kernel_guard`
  wraps every kernel router of ``ops/`` with the ``kernel:<claim>`` hook and
  failure attribution (:class:`KernelExecutionError`).
- ``retry``: per-domain retry/backoff policies, a sliding-window
  :class:`RestartBudget`, and the exception classifier (retryable / fatal /
  degradable; a sticky CUDA error is fatal).
- ``quarantine``: the persisted set of broken kernels, which the routers
  and the serving runner read to take the next kernel rung down
  (``decode_layer`` → the sub-blocks → the per-op kernels); a quarantined
  kernel with no kernel rung below it raises a fatal
  :class:`KernelExecutionError` on the card, where no plain version runs.
- ``sentinel``: the numerics response ladder over the health word the
  guarded train step builds (``transforms.numerics_guard``): skip-and-count,
  loss-spike rewind, bisection of a silently corrupt kernel into the
  quarantine.
"""

from __future__ import annotations

from thunder_tpu_torch.runtime import faults, quarantine, retry, sentinel  # noqa: F401
from thunder_tpu_torch.runtime.faults import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    InjectedFault,
    KernelBuildError,
    KernelExecutionError,
    KernelLaunchError,
)
from thunder_tpu_torch.runtime.retry import RestartBudget, RetryPolicy  # noqa: F401
from thunder_tpu_torch.runtime.sentinel import (  # noqa: F401
    LossSpike,
    NumericsAnomaly,
    NumericsPolicy,
    NumericsSentinel,
    PersistentNonFinite,
    SilentNumericsFault,
)
