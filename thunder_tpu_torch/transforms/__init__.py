"""thunder_tpu_torch.transforms: the port's counterparts of
``thunder_tpu/transforms/``. So far the numerics guard
(:class:`~thunder_tpu_torch.transforms.numerics_guard.NumericsGuard`), which
wraps the train step where the reference rewrites a trace."""

from thunder_tpu_torch.transforms.numerics_guard import NumericsGuard  # noqa: F401
