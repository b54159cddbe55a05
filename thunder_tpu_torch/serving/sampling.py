"""Token sampling for the serving decode step; the counterpart of
``thunder_tpu/serving/sampling.py``.

- Greedy is the ``temperature == 0`` case: ``argmax`` of the logits
  (``torch.argmax`` returns the first maximum, as the reference's does).
- ``top_k`` and ``top_p`` are threshold masks found by fixed-iteration
  bisection (count and probability-mass predicates), not by sorting the
  vocabulary. Ties at the converged threshold are all admitted.
- Each slot's noise is a counter-based hash of ``(seed, counter,
  vocab_index)`` — the murmur3 finalizer over Weyl-multiplied inputs — so a
  request's stream depends only on its seed and how many tokens it has
  sampled, never on what else shares the batch. The draw is Gumbel-max.

The hash is uint32 arithmetic. torch's ``uint32`` lacks most operations, so
it runs in int64 with every product reduced modulo 2**32; the products are
split into 16-bit halves so that no int64 intermediate overflows. The
uniforms equal the reference's bit for bit.

:func:`sample_tokens` runs eagerly on tensors; under ``jit`` it records
:func:`traced_sample_tokens`, the reference's traced epilogue
(``thunder_tpu/serving/sampling.py:180``) in the port's ops: the same
bisections and Gumbel-max draw, the hash in int64 modulo 2**32 (the port's
dtypes have no uint32; its right shifts are floor divisions by powers of
two, exact on these non-negative values), so the serving decode program
samples in the same program as its logits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from thunder_tpu_torch import ops
from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.ops.nn import traceable

# masked-out vocabulary entries: finite, but below any real logit by enough
# that Gumbel noise can never resurrect one
_MASKED = -1e30

# bisection trip counts (top-k on raw logits, top-p on probabilities)
_TOPK_ITERS = 18
_TOPP_ITERS = 18

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature == 0`` selects greedy decoding (the default). ``top_k ==
    0`` disables top-k filtering; ``top_p == 1.0`` disables nucleus
    filtering. ``seed`` pins the request's stream; ``None`` derives one from
    the process-unique request id (distinct per request, not reproducible
    across runs)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def stream_seed(self, request_id: int) -> int:
        """The uint32 seed of this request's stream."""
        if self.seed is not None:
            return self.seed & _M32
        return (request_id * 0x9E3779B1 + 0x7F4A7C15) & _M32

    def fork(self, branch: int) -> "SamplingParams":
        """The params of best-of-N branch ``branch`` (1-based for clones):
        the same filtering on the seed shifted by ``branch``, so each branch
        draws its own stream and stays reproducible when the parent's seed
        is pinned."""
        seed = None if self.seed is None else (self.seed + branch) & _M32
        return SamplingParams(temperature=self.temperature, top_k=self.top_k,
                              top_p=self.top_p, seed=seed)


GREEDY = SamplingParams()


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) and a uint32
    constant ``c``, with every intermediate below 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _uniform(rng: torch.Tensor, V: int) -> torch.Tensor:
    """Per-slot (0, 1) uniforms over the vocabulary from ``[seed, counter]``
    rows (``rng`` (S, 2) int64 holding uint32 values): the murmur3 finalizer
    over the Weyl-multiplied ``(seed, counter, vocab_index)`` triple, its top
    24 bits scaled to (0, 1). Returns (S, V) float32."""
    rng = rng.long()
    seed, ctr = rng[:, 0], rng[:, 1]
    v = torch.arange(V, device=rng.device, dtype=torch.int64)
    h = _mul32(seed, 0x9E3779B1) ^ _mul32(ctr, 0x85EBCA77)
    h = h[:, None] ^ _mul32(v, 0xC2B2AE3D)[None, :]
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-9


def _gumbel(rng: torch.Tensor, V: int) -> torch.Tensor:
    """Gumbel noise ``-log(-log(u))`` of :func:`_uniform`'s draws. The
    uniforms equal the reference's bit for bit; the noise may differ from it
    in the last bits, because XLA's float32 ``log`` on the CPU is not
    correctly rounded and torch's is."""
    return -torch.log(-torch.log(_uniform(rng, V)))


def _topk_threshold(l32: torch.Tensor, k_col: torch.Tensor) -> torch.Tensor:
    """Largest threshold t with ``count(l >= t) >= k`` per row, by bisection."""
    lo = l32.amin(-1, keepdim=True) - 1.0
    hi = l32.amax(-1, keepdim=True) + 1.0
    for _ in range(_TOPK_ITERS):
        mid = (lo + hi) * 0.5
        cnt = (l32 >= mid).to(torch.float32).sum(-1, keepdim=True)
        keep = cnt >= k_col
        lo = torch.where(keep, mid, lo)
        hi = torch.where(keep, hi, mid)
    return lo


def _topp_threshold(probs: torch.Tensor, p_col: torch.Tensor) -> torch.Tensor:
    """Largest probability threshold t with ``sum(probs[probs >= t]) >=
    top_p`` per row, by bisection on [0, 1]."""
    zero = torch.zeros_like(p_col)
    lo = zero
    hi = zero + (1.0 + 1e-6)
    for _ in range(_TOPP_ITERS):
        mid = (lo + hi) * 0.5
        mass = torch.where(probs >= mid, probs, 0.0).sum(-1, keepdim=True)
        keep = mass >= p_col
        lo = torch.where(keep, mid, lo)
        hi = torch.where(keep, hi, mid)
    return lo


@traceable
def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor, rng: torch.Tensor) -> torch.Tensor:
    """``(S, V)`` logits -> ``(S,)`` int64 token ids.

    ``temps`` (S,) float32; ``top_ks`` (S,) int (0 disables); ``top_ps``
    (S,) float32 (1 disables); ``rng`` (S, 2) int64 ``[stream_seed,
    counter]`` rows. Rows with ``temps == 0`` return the greedy argmax."""
    S, V = logits.shape
    l32 = logits.to(torch.float32)
    greedy = torch.argmax(l32, -1)

    # top-k on the raw logits (the top-k set does not depend on temperature)
    k_col = top_ks.reshape(S, 1).to(torch.float32)
    need_k = (k_col >= 1.0) & (k_col < float(V))
    k_mask = l32 >= _topk_threshold(l32, k_col)
    masked = torch.where(need_k & ~k_mask, _MASKED, l32)

    t_col = temps.reshape(S, 1).clamp(min=1e-3)
    scaled = masked / t_col

    # nucleus mask on the scaled distribution
    p_col = top_ps.reshape(S, 1)
    need_p = p_col < 1.0
    probs = torch.softmax(scaled, -1, dtype=torch.float32)
    p_mask = probs >= _topp_threshold(probs, p_col)
    scaled = torch.where(need_p & ~p_mask, _MASKED, scaled)

    sampled = torch.argmax(scaled + _gumbel(rng, V), -1)
    return torch.where(temps > 0.0, sampled, greedy)


# ---------------------------------------------------------------------------
# the traced epilogue, in the port's ops
# ---------------------------------------------------------------------------

def _mul32_t(a, c: int):
    """:func:`_mul32` in ops: ``(a * c) mod 2**32`` for int64 ``a`` in [0,
    2**32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return ops.bitwise_and(ops.add(ops.mul(a, lo),
                                   ops.mul(ops.bitwise_and(ops.mul(a, hi), 0xFFFF), 1 << 16)),
                           _M32)


def _shr_t(a, k: int):
    return ops.floor_divide(a, 1 << k)


def _gumbel_t(rng, V: int):
    """:func:`_gumbel` in ops (the reference's ``_gumbel``, sampling.py:111)."""
    S = rng.shape[0]
    rng = ops.convert_element_type(rng, dtypes.int64)
    seed = ops.getitem(rng, (slice(None), 0))
    ctr = ops.getitem(rng, (slice(None), 1))
    v = ops.arange(V, dtype=dtypes.int64, device=rng.device)
    h = ops.bitwise_xor(_mul32_t(seed, 0x9E3779B1), _mul32_t(ctr, 0x85EBCA77))
    h = ops.bitwise_xor(ops.reshape(h, (S, 1)), ops.reshape(_mul32_t(v, 0xC2B2AE3D), (1, V)))
    h = ops.bitwise_xor(h, _shr_t(h, 16))
    h = _mul32_t(h, 0x85EBCA6B)
    h = ops.bitwise_xor(h, _shr_t(h, 13))
    h = _mul32_t(h, 0xC2B2AE35)
    h = ops.bitwise_xor(h, _shr_t(h, 16))
    u = ops.add(ops.mul(ops.convert_element_type(_shr_t(h, 8), dtypes.float32),
                        1.0 / (1 << 24)), 1e-9)
    return ops.neg(ops.log(ops.neg(ops.log(u))))


def _topk_threshold_t(l32, k_col):
    lo = ops.sub(ops.amin(l32, -1, keepdim=True), 1.0)
    hi = ops.add(ops.amax(l32, -1, keepdim=True), 1.0)
    for _ in range(_TOPK_ITERS):
        mid = ops.mul(ops.add(lo, hi), 0.5)
        cnt = ops.sum(ops.convert_element_type(ops.ge(l32, mid), dtypes.float32), -1,
                      keepdim=True)
        keep = ops.ge(cnt, k_col)
        lo = ops.where(keep, mid, lo)
        hi = ops.where(keep, hi, mid)
    return lo


def _topp_threshold_t(probs, p_col):
    zero = ops.zeros_like(p_col)
    lo = zero
    hi = ops.add(zero, 1.0 + 1e-6)
    for _ in range(_TOPP_ITERS):
        mid = ops.mul(ops.add(lo, hi), 0.5)
        mass = ops.sum(ops.where(ops.ge(probs, mid), probs, zero), -1, keepdim=True)
        keep = ops.ge(mass, p_col)
        lo = ops.where(keep, mid, lo)
        hi = ops.where(keep, hi, mid)
    return lo


def traced_sample_tokens(logits, temps, top_ks, top_ps, rng):
    """:func:`sample_tokens` in the port's ops, which ``jit`` records for it
    (the reference's ``sample_tokens``): ``(S, V)`` logits -> ``(S,)`` int64
    token ids; rows with ``temps == 0`` take the greedy argmax."""
    S, V = logits.shape
    l32 = ops.convert_element_type(logits, dtypes.float32)
    greedy = ops.argmax(l32, -1)
    k_col = ops.convert_element_type(ops.reshape(top_ks, (S, 1)), dtypes.float32)
    need_k = ops.logical_and(ops.ge(k_col, 1.0), ops.lt(k_col, float(V)))
    k_mask = ops.ge(l32, _topk_threshold_t(l32, k_col))
    masked = ops.where(ops.logical_and(need_k, ops.logical_not(k_mask)), _MASKED, l32)
    t_col = ops.clamp(ops.reshape(temps, (S, 1)), min=1e-3)
    scaled = ops.true_divide(masked, t_col)
    p_col = ops.reshape(top_ps, (S, 1))
    need_p = ops.lt(p_col, 1.0)
    probs = ops.softmax(scaled, -1, dtype=dtypes.float32)
    p_mask = ops.ge(probs, _topp_threshold_t(probs, p_col))
    scaled = ops.where(ops.logical_and(need_p, ops.logical_not(p_mask)), _MASKED, scaled)
    sampled = ops.argmax(ops.add(scaled, _gumbel_t(rng, V)), -1)
    return ops.where(ops.gt(temps, 0.0), sampled, greedy)


def _register_traced() -> None:
    from thunder_tpu_torch.torch import register_torch_op

    register_torch_op(sample_tokens, traced_sample_tokens)


_register_traced()
