"""thunder_tpu_torch.transforms: the port's counterparts of
``thunder_tpu/transforms/``. So far the numerics guard: the reference's
:class:`~thunder_tpu_torch.transforms.numerics_guard.NumericsGuardTransform`
(``jit(step, transforms=[...])``) with :func:`observe_grads`, and
:class:`~thunder_tpu_torch.transforms.numerics_guard.NumericsGuard`, its
counterpart for the eager train step."""

from thunder_tpu_torch.transforms.numerics_guard import (  # noqa: F401
    NumericsGuard,
    NumericsGuardTransform,
    observe_grads,
)
