"""Whole-program replay: a cached ``jit`` entry as one CUDA graph.

The counterpart of the reference's whole-program compile
(``thunder_tpu/__init__.py:813-860``), which it calls "the TPU answer to
the reference's CUDA-graphs executor": there one ``jax.jit`` over the
execution trace gives a persistent executable; here one
``torch.cuda.CUDAGraph`` per cached entry, captured once and replayed, takes
the host's per-op launch cost out of a call. ``ThunderTPUFunction._finalize_entry``
decides which entries take it (the ``whole_program_jit`` option; not for
inputs off the card, nor for a trace that reads the device from the host).

An entry's calls:

1. the first runs the generated program per call on a side stream, which
   builds and warms every kernel and library handle (as
   ``models.llama.generate_fused`` does);
2. the second captures the program into a graph on that stream, in the
   jit function's one memory pool (``torch.cuda.graph_pool_handle()``:
   each of a prefill's bucketed chunk shapes adds no pool of its own), and
   replays it;
3. every later call replays it.

Inputs: a tensor input that is the same tensor at the first two calls
(the weights) is read where it lies; a donated input the program writes in
place likewise. Any other tensor input (a step's tokens, made anew each
call) has a buffer of the graph's own, into which each call copies it
before the replay (``CompileStats.whole_program_copied_bytes``). A written
donated input at another address is captured again, never copied (a copy
would leave the caller's tensor unwritten); so is an input read where it
lies, which from then on is copied (``recaptures``).

Outputs: each tensor output is cloned out of the graph's memory, so a later
replay never overwrites a tensor the caller holds; an output that is a
donated input written in place is returned as that input.

A capture records the launches with the arguments their wrappers computed
on the host: every such value is a trace constant (``eps``, ``scale``,
the optimizer's hyperparameters) or follows from the shapes, which the
guard key covers; a host buffer a launch copies from (``fused_adamw``'s
pointer table) is kept as long as the graph (``cudaex.keep_host_buffers``).

Counting: the kernels' launch counters run on the host, so a capture's
launches are taken off the counters after the capture and added back on
every replay (``cudaex.add_counts``): ``cudaex.launch_counts()`` counts
what the card runs. The routers' kernel guard, fault hooks and quarantine
checks act on the first two calls only; the quarantine epoch is in the
guard key, so a quarantined kernel is re-routed by the next call's new
entry. A capture that fails raises: nothing runs per call in its place.
"""

from __future__ import annotations

import weakref

import torch

from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.executors import cudaex

class GraphPool:
    """The memory pool the CUDA graphs of one ``jit`` function share.
    PyTorch frees a private pool with the last graph that uses it, so a
    handle is made anew whenever no graph holds the last one."""

    def __init__(self):
        self.handle = None
        self.graphs = 0

    def acquire(self):
        """The handle a capture passes to ``torch.cuda.graph``."""
        if self.graphs == 0:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


class WholeProgram:
    """The CUDA graph of one cached entry (see the module docstring):
    ``entry.computation_fn`` is the generated program, ``donated`` the
    positions among its tensor inputs of the donated inputs it writes in
    place, ``stats`` the jit function's
    ``CompileStats`` (captures, replays, recaptures and copied bytes are
    counted there) and ``pool`` the function's :class:`GraphPool`."""

    def __init__(self, entry, donated: frozenset[int], stats, pool):
        self.entry = entry
        self.donated = donated
        self.stats = stats
        self.pool = pool
        self.calls = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.warm: list = []                      # the first call's inputs, held weakly
        self.by_ref: set[int] = set()             # inputs the graph reads where they lie
        self.static: list[torch.Tensor] = []      # the graph's inputs
        self.outs: list = []                      # the graph's flat outputs
        self.out_tree = None
        self.out_alias: dict[int, int] = {}       # output -> donated input it is
        self.counts: dict = {}                    # the captured launches
        self.keep: list = []                      # host buffers the graph reads
        self.side: torch.cuda.Stream | None = None   # the warm-up's and captures' stream

    # -- the calls ------------------------------------------------------------
    def __call__(self, *inps):
        self.calls += 1
        if self.calls == 1:
            return self._warm(inps)
        if self.graph is None or self._must_recapture(inps):
            self._capture(inps)
        else:
            self._copy_in(inps)
        return self._replay(inps)

    def _warm(self, inps):
        """The first call: the program per call on the side stream."""
        cur = torch.cuda.current_stream()
        side = self.side = torch.cuda.Stream(device=cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.entry.computation_fn(*inps)
        cur.wait_stream(side)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor) and o.is_cuda:
                o.record_stream(cur)   # allocated on the side stream, used on this one
        self.warm = [weakref.ref(t) for t in inps]
        return out

    def _must_recapture(self, inps) -> bool:
        moved = {i for i in self.by_ref
                 if inps[i] is not self.static[i] and not _same_storage(inps[i], self.static[i])}
        self.by_ref -= moved - self.donated      # copied from now on
        return bool(moved)

    def _copy_in(self, inps) -> None:
        copied = 0
        for i, st in enumerate(self.static):
            t = inps[i]
            if i not in self.by_ref and t is not st:
                st.copy_(t)
                copied += t.numel() * t.element_size()
        self.stats.whole_program_copied_bytes += copied

    def _capture(self, inps) -> None:
        # the old graph keeps the shared pool alive until the new one holds
        # it; its outputs' memory goes back to the pool first
        old, recapture = self.graph, self.graph is not None
        self.graph, self.outs = None, []
        if not recapture:
            self.by_ref = {i for i, t in enumerate(inps)
                           if i in self.donated or self.warm[i]() is t}
        self.static = [t if i in self.by_ref else t.clone(memory_format=torch.preserve_format)
                       for i, t in enumerate(inps)]
        self.stats.whole_program_copied_bytes += sum(
            t.numel() * t.element_size() for i, t in enumerate(inps) if i not in self.by_ref)
        cur = torch.cuda.current_stream()
        side = self.side
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        keep: list = []
        before = cudaex.count_snapshot()
        # torch.cuda.graph's context would also run gc.collect() a capture,
        # seconds in a process holding many traces: begin and end by hand
        torch.cuda.empty_cache()
        try:
            with cudaex.keep_host_buffers(keep), torch.cuda.stream(side):
                graph.capture_begin(pool=self.pool.acquire())
                try:
                    out = self.entry.computation_fn(*self.static)
                finally:
                    graph.capture_end()
            self.pool.graphs += 1
        finally:
            counted = cudaex.count_delta(before)
            cudaex.add_counts(counted, -1)   # the card ran nothing at capture
            if old is not None:
                self.pool.graphs -= 1
                del old
        cur.wait_stream(side)
        self.graph, self.keep, self.counts = graph, keep, counted
        self.outs, self.out_tree = tree_flatten(out)
        self.out_alias = {}
        for j, o in enumerate(self.outs):
            if isinstance(o, torch.Tensor):
                for i in self.donated:
                    if o.data_ptr() == self.static[i].data_ptr():
                        self.out_alias[j] = i
                        break
        self.stats.whole_program_captures += 1
        if recapture:
            self.stats.whole_program_recaptures += 1

    def _replay(self, inps):
        self.graph.replay()
        cudaex.add_counts(self.counts)
        self.stats.whole_program_replays += 1
        flat = []
        for j, o in enumerate(self.outs):
            i = self.out_alias.get(j)
            if i is not None:
                t = inps[i]
                flat.append(t if _same_storage(o, t) else o)
            elif isinstance(o, torch.Tensor):
                flat.append(o.clone())
            else:
                flat.append(o)
        return tree_unflatten(self.out_tree, flat)
