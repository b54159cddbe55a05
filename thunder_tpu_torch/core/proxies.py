"""Proxies: the values that flow through the port's traces.

The counterpart of ``thunder_tpu/core/proxies.py``. A proxy stands for a
runtime value while a function is traced: ``TensorProxy`` for a
``torch.Tensor`` (shape, dtype and the device it lives on, so an executor's
checker sees ``cuda`` where the tensor is on the card), ``NumberProxy`` for
a Python number (static: its value is baked into the trace and guarded, the
reference's constant-values caching), ``StringProxy`` for a string.
"""

from __future__ import annotations

from numbers import Number
from typing import Any, Sequence

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.devices import default_device, device_string, to_device


class Variable:
    """Hashable identity wrapper for a proxy: traces compare proxies by name."""

    __slots__ = ("proxy",)

    def __init__(self, proxy: "Proxy"):
        self.proxy = proxy

    def __eq__(self, other):
        return isinstance(other, Variable) and self.proxy.name == other.proxy.name

    def __hash__(self):
        return hash(self.proxy.name)

    def __repr__(self):
        return f"Variable({self.proxy.name})"


def variableify(x):
    return Variable(x) if isinstance(x, Proxy) else x


class Proxy:
    """Base proxy: a named placeholder recorded in a trace."""

    def __init__(self, name: str | None = None, prefix: str | None = None):
        from thunder_tpu_torch.core.trace import get_tracectx

        trc = get_tracectx()
        if name is None:
            check(trc is not None, "cannot create an unnamed proxy outside a trace context")
            name = trc.make_name(prefix=prefix or "p")
        elif trc is not None:
            trc.register_name(name)
        self.name = name

    def type_string(self) -> str:
        return "Any"

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class StringProxy(Proxy):
    def __init__(self, value: str, name: str | None = None):
        super().__init__(name, prefix="s")
        self.value = value

    def type_string(self):
        return "str"


class NumberProxy(Proxy):
    """A Python number captured by the trace. Static: its concrete ``value``
    is known at trace time, and arithmetic on it evaluates eagerly."""

    def __init__(self, value: Number, name: str | None = None, python_type: type | None = None):
        super().__init__(name, prefix="n")
        self.value = value
        self.python_type = python_type or type(value)

    def type_string(self):
        return self.python_type.__name__

    def __repr__(self):
        return f"<NumberProxy {self.name}={self.value}>"

    def __bool__(self):
        return bool(self.value)

    def __int__(self):
        return int(self.value)

    def __float__(self):
        return float(self.value)

    def __index__(self):
        return int(self.value)

    def __hash__(self):
        return hash(self.value)

    def __eq__(self, other):
        return self.value == pyval(other)


def pyval(x):
    """Concrete Python value of a proxy-or-value (numbers, strings)."""
    if isinstance(x, (NumberProxy, StringProxy)):
        return x.value
    return x


class TensorProxy(Proxy):
    """Proxy for a ``torch.Tensor``: static shape, dtype, device."""

    def __init__(self, name: str | None = None, *, shape: Sequence[int], dtype, device=None):
        super().__init__(name, prefix="t")
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtypes.to_dtype(dtype)
        self.device = to_device(device) if device is not None else default_device()

    # -- metadata ---------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def type_string(self) -> str:
        sh = ",".join(str(s) for s in self.shape)
        return f"{device_string(self.device)} {self.dtype.shortname()}[{sh}]"

    def __repr__(self):
        return f"<TensorProxy {self.name}: {self.type_string()}>"

    # -- operator overloads: dispatch to the op namespace -------------------
    @staticmethod
    def _ops():
        from thunder_tpu_torch import ops

        return ops

    def __add__(self, other):
        return self._ops().add(self, other)

    def __radd__(self, other):
        return self._ops().add(other, self)

    def __sub__(self, other):
        return self._ops().sub(self, other)

    def __rsub__(self, other):
        return self._ops().sub(other, self)

    def __mul__(self, other):
        return self._ops().mul(self, other)

    def __rmul__(self, other):
        return self._ops().mul(other, self)

    def __truediv__(self, other):
        return self._ops().true_divide(self, other)

    def __rtruediv__(self, other):
        return self._ops().true_divide(other, self)

    def __matmul__(self, other):
        return self._ops().matmul(self, other)

    def __neg__(self):
        return self._ops().neg(self)

    def __getitem__(self, idx):
        return self._ops().getitem(self, idx)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise RuntimeError("the truth value of a TensorProxy is not defined during tracing; "
                           "use ops.where instead of Python control flow on tensors")

    def __len__(self):
        check(self.ndim > 0, "len() of a 0-d tensor")
        return self.shape[0]

    @property
    def T(self):
        return self._ops().transpose(self, tuple(reversed(range(self.ndim))))

    @property
    def mT(self):
        perm = tuple(range(self.ndim - 2)) + (self.ndim - 1, self.ndim - 2)
        return self._ops().transpose(self, perm)

