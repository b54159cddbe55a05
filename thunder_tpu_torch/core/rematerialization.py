"""Activation checkpointing: the counterpart of
``thunder_tpu/core/rematerialization.py`` ``checkpoint`` (:327).

The reference re-traces a checkpointed region inside the backward, so the
region's intermediates are recomputed there instead of saved, and only its
inputs are kept. Here the same contract is ``torch.utils.checkpoint`` in its
non-reentrant form: the region runs once in the forward with its saved
tensors dropped, and again in the backward to rebuild them. Tensors the
region closes over (the rope tables) are fine.

:func:`recomputing` tells code inside a region which of the two runs it is
in. The reference's fusion passes see the forward region and its recomputed
copy as two traces and fuse them differently; a region that wants the same
kernel calls as the reference's trace reads it (``models/llama._remat_block``).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch.utils.checkpoint

_state = threading.local()


def recomputing() -> bool:
    """True while a checkpointed region is being recomputed in the backward."""
    return getattr(_state, "recomputing", False)


class _Recompute:
    """The context a region's recompute runs in. Every backward through a
    retained graph recomputes the region again in the same context object,
    so it may be entered more than once."""

    def __enter__(self):
        self._before = recomputing()
        _state.recomputing = True

    def __exit__(self, *exc):
        _state.recomputing = self._before


def _contexts():
    return contextlib.nullcontext(), _Recompute()


def checkpoint(fn):
    """``fn`` as a checkpointed region: called with tensors (or trees of
    them) it returns what ``fn`` returns, saves only its inputs for the
    backward, and recomputes ``fn`` there."""

    @functools.wraps(fn)
    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=_contexts)

    return wrapped
