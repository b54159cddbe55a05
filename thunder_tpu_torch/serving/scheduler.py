"""Continuous-batching scheduler over the paged KV cache; the counterpart of
``thunder_tpu/serving/scheduler.py``.

- **Admission**: queued requests join a free decode slot when the page pool
  can cover their first prefill chunk; otherwise the queue back-pressures.
  Admission is priority-ordered (highest first, FIFO among equals), the
  queue is optionally bounded (``max_queue``: overflow sheds the lowest-
  priority queued request or rejects the newcomer with
  :class:`~errors.AdmissionRejected`), and a request whose page demand
  exceeds the whole pool fails at ``submit()`` with
  :class:`~errors.InfeasibleRequest`.
- **Deadlines**: ``submit(deadline_s=)``; every step sheds expired queued
  requests and evicts expired residents with :class:`~errors.DeadlineExceeded`
  (``serving.deadline_misses``); any shedding counts
  ``serving.shed_requests``, and the on-time completion ratio is the
  ``serving.slo_attainment`` gauge.
- **Decode-first with chunked prefill**: every step runs one batched decode
  step over all resident requests, then prefill chunks of the head-of-line
  prefilling request (one chunk when more than half the slots decode, a
  burst otherwise). Chunks are padded to a ladder of page-size multiples.
- **First-token replay**: prefill emits no logits; when a prompt is fully
  resident, the next decode step re-feeds its last token with the K/V write
  sent to the scratch page, and samples the first token on the decode path.
- **Preemption**: when the pool runs dry, the lowest-priority newest
  resident is evicted to the queue head (recompute-on-resume: its generated
  tokens re-prefill as prompt, so its output is unchanged).
- **Stall detection**: ``drain()`` raises :class:`~errors.EngineStallError`
  naming the stuck requests when a step makes no progress.
- **Best-of-N copy-on-write forks**: ``submit(best_of=N)`` prefills once;
  when the primary's prompt is resident, N-1 clones fork its block table
  (full pages shared by refcount, the partial tail page copied) and branch
  on their own streams (``SamplingParams.fork``). A clone that cannot fork
  yet waits on the primary, and spills to the queue if the primary ends
  first.
- **Cross-request prefix cache** (``prefix_cache=True``): admission probes a
  page-granularity token trie (:class:`~prefix_cache.PrefixCache`) with the
  prompt, prefill starts at the first uncached page, and completed requests
  donate their full prompt pages. Cached pages park at refcount 0 and the
  allocator evicts them oldest first under pressure
  (``serving.prefix_hit_rate``, ``serving.cached_pages``).
- **Fault domains** (the counterpart of ``_dispatch_guarded``,
  ``scheduler.py:849``): the decode step runs under the ``step``,
  ``serving:decode`` and ``serving:engine`` fault hooks, a prefill chunk
  under ``serving:prefill``, admission under ``serving:admission``; a
  retryable failure re-runs the dispatch under the engine's
  ``runtime.retry`` policy. A failure that leaves the pools consumed (the
  ``serving:engine`` domain simulates it) escalates as
  :class:`~errors.EngineFault`, and the
  :class:`~supervisor.EngineSupervisor`'s restart (:meth:`ServingEngine.
  rebuild_after_fault`: a fresh pool and a re-prefill of every in-flight
  request) is the engine-level rung.
- **Kernel quarantine** (inside each dispatch, the counterpart of
  ``scheduler.py:1063-1089``): a routed kernel that fails in a decode step
  or a prefill chunk (``runtime.faults.KernelExecutionError``, degradable)
  is quarantined, which moves the quarantine epoch; the engine re-binds the
  decode step (``runner.bind_decode``: a new compile, whose planner takes
  the next kernel rung down) and replays the step. The steps are traced
  programs (``runner.py``), so a ``kernel:cuda.<name>`` fault fires while
  a step runs per call: at its compile's first call and its capture on the
  card, at every call on the CPU; a replayed graph runs no router. It
  emits ``serving.decode_rebinds``, the
  ``serving_decode_rebind`` event, ``serving.quarantine_epoch`` and
  ``serving.decode_layer_fusions``. A fatal error propagates
  (``runtime.retry.classify``): a sticky CUDA error, and a quarantined
  kernel with no kernel rung below it called on the card.
- **Lifecycle tracing**: every request's phases (queued, prefill, decode)
  are spans, and its edges events (``events.EVENT_KINDS``), through
  ``observe.registry``, which feeds the always-on flight ring; each step
  also records the ``schedule`` and ``decode_dispatch`` spans.

Left out of this port so far, each kept in the reference: tensor-parallel
meshes (``mesh=``, ROADMAP A.2 then A.3), the launch census
(``launch_budget_per_layer``, the decode-launch-growth finding: A.4), and
the fleet above one engine (``router.py``, ``health.py``: A.3). The
``serving.decode_pallas_launches`` and ``serving.decode_layer_fusions``
gauges are read from the bound decode program's claims.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from thunder_tpu_torch.data import LengthBucketer
from thunder_tpu_torch.devices import resolve_device
from thunder_tpu_torch.models.llama import to_device
from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.runtime import faults as _faults
from thunder_tpu_torch.runtime import quarantine as _quarantine
from thunder_tpu_torch.runtime import retry as _retry
from thunder_tpu_torch.runtime.faults import KernelExecutionError
from thunder_tpu_torch.serving.errors import (
    AdmissionRejected,
    DeadlineExceeded,
    EngineFault,
    EngineStallError,
    InfeasibleRequest,
    RestartState,
)
from thunder_tpu_torch.serving.kv_cache import OutOfPages, PagedKVCache, PageGeometry
from thunder_tpu_torch.serving.prefix_cache import PrefixCache
from thunder_tpu_torch.serving.runner import PagedLlamaRunner
from thunder_tpu_torch.serving.sampling import GREEDY, SamplingParams

QUEUED, PREFILL, DECODE, DONE, SHED = "queued", "prefill", "decode", "done", "shed"

# process-unique request ids (they seed the sampling stream of a request
# whose SamplingParams carry no seed, and key the flight ring's records)
_REQUEST_IDS = itertools.count()
_ENGINE_IDS = itertools.count()


@dataclass(eq=False)  # identity semantics: requests live in slot lists
class Request:
    """One generation request and its lifecycle state."""

    prompt: np.ndarray                  # original prompt token ids (1-D int32)
    max_new_tokens: int
    request_id: int
    eos_id: int | None = None
    priority: int = 0                   # higher = more important (shed last)
    deadline_at: float | None = None    # absolute perf_counter deadline
    submitted_s: float = 0.0
    state: str = QUEUED
    error: BaseException | None = None  # set when state == SHED
    pages: list = field(default_factory=list)   # allocated page ids, in order
    prefilled: int = 0                  # work-prompt tokens written so far
    length: int = 0                     # context tokens written into the cache
    next_token: int | None = None       # sampled, not yet fed to decode
    generated: list = field(default_factory=list)
    ttft_s: float | None = None
    finished_s: float | None = None
    decode_start_s: float | None = None
    preemptions: int = 0
    restarts: int = 0                   # supervisor crash-recovery re-admits
    admit_seq: int = -1                 # admission order (preemption victim pick)
    pages_version: int = 0              # bumped when ``pages`` changes
    sampling: SamplingParams = GREEDY
    stream_seed: int = 0
    _replay: bool = False               # next decode step re-feeds the last
    #                                     prompt token to sample the first one
    # best-of-N copy-on-write forks
    fork_parent: "Request | None" = None
    fork_pending: list = field(default_factory=list)  # clones awaiting a fork
    fork_group: list = field(default_factory=list)    # primary + clones
    prefix_hit_tokens: int = 0          # prompt tokens served from the trie
    # lifecycle tracing
    submitted_us: float = 0.0           # observe-epoch submit timestamp
    queued_ms: float = 0.0              # total time queued (incl. resumes)
    prefill_chunks: int = 0             # prefill dispatches (incl. re-prefill)
    _phase: str = ""                    # open lifecycle phase span, if any
    _phase_t0_us: float = 0.0

    @property
    def work_prompt(self) -> np.ndarray:
        """What prefill must write: the prompt plus any tokens generated
        before a preemption or an engine restart (recompute-on-resume)."""
        if not self.generated:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def failed(self) -> bool:
        return self.state == SHED

    def output(self) -> np.ndarray:
        return np.asarray(self.generated, np.int32)


class ServingEngine:
    """Continuous-batching serving runtime for a Llama-family model.

    >>> eng = ServingEngine(params, cfg, max_slots=8, page_size=16,
    ...                     max_context=2048)          # on "cuda"
    >>> r = eng.submit([1, 2, 3], max_new_tokens=16)
    >>> eng.drain()
    >>> r.output()

    ``device`` is where the weights, the pools and every step live: "cuda"
    when omitted (an error without a card); tests pass ``device="cpu"``,
    which runs every kernel's plain version. ``params`` are moved there;
    the engine runs every layer they hold.
    ``max_slots`` is the decode batch width; ``num_pages`` sizes the shared
    pool (default: full residency for every slot). ``block_fusion`` is the
    traced steps' planner option (``runner.PagedLlamaRunner``): None (the
    default, as in the reference) lets the decode cost model pick the rung,
    True forces the planned rung (one ``decode_layer`` launch per layer per
    decode step, one ``mlp_subblock`` per layer per prefill chunk), False
    the per-op rung. ``whole_program_jit`` is the steps' replay option (one
    CUDA graph per compiled step on the card). ``prefix_cache=True`` turns
    on the cross-request prefix cache; ``retry_policy`` is the dispatches' retry policy. The
    engine's metrics carry the label ``engine=e<n>``, ``n`` counting the
    process's engines.
    """

    def __init__(self, params, cfg, *, device=None, max_slots: int = 8,
                 page_size: int = 16, num_pages: int | None = None,
                 max_context: int | None = None, prefill_chunk: int | None = None,
                 max_queue: int | None = None, block_fusion: bool | None = None,
                 prefix_cache: bool = False, retry_policy=None, whole_program_jit: bool = True):
        self.engine_id = f"e{next(_ENGINE_IDS)}"
        self.obs = _observe.labeled(engine=self.engine_id)
        self.decode_rebinds = 0        # quarantine-forced re-binds of the decode layer
        self._bound_epoch = None       # the quarantine epoch the decode step is bound at
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        max_context = int(max_context or cfg.max_seq_len)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        # prefill chunk ladder: powers-of-two multiples of the page size, so
        # chunk starts stay page-aligned
        cap = int(prefill_chunk or min(max_context, 512))
        cap = max(page_size, (cap // page_size) * page_size)
        ladder, b = [], page_size
        while b < cap:
            ladder.append(b)
            b *= 2
        ladder.append(cap)
        self.chunker = LengthBucketer(ladder)
        self.max_chunk = ladder[-1]
        # align the context window to the ladder top so a chunk-padded
        # prefill can never outrun the block table
        max_context = -(-max_context // self.max_chunk) * self.max_chunk
        self.max_context = max_context
        pages_per_req = -(-max_context // page_size)
        if num_pages is None:
            num_pages = max_slots * pages_per_req + 1  # + reserved page 0
        self.geom = PageGeometry(
            n_layers=len(self.params["layers"]), kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
            page_size=page_size, num_pages=int(num_pages),
            pages_per_request=pages_per_req)
        # what a supervisor rebuild must reproduce: geometry, dtype, device
        self._restart_state = RestartState(geometry=self.geom, dtype=cfg.dtype,
                                           device=self.device)
        self.cache = PagedKVCache(self.geom, cfg.dtype, self.device)
        self.prefix = PrefixCache(self.cache) if prefix_cache else None
        self.runner = PagedLlamaRunner(cfg, self.geom, block_fusion=block_fusion,
                                       device=self.device, whole_program_jit=whole_program_jit)
        self.max_slots = int(max_slots)
        self.max_queue = max_queue
        self.slots: list[Request | None] = [None] * self.max_slots
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []
        self.shed: list[Request] = []
        self.admitting = True           # stop_admissions() flips this
        self._admits = itertools.count()
        self._step_count = 0
        self._slo_attained = 0          # on-time completions
        self._slo_total = 0             # terminal requests (done + shed)
        self._slo_resets = 0            # reset_slo_window() generation
        # serving is latency-sensitive: quick retries, no long backoff
        self._retry_policy = retry_policy or _retry.RetryPolicy(
            max_attempts=3, base_delay_s=0.05, max_delay_s=1.0)
        # host-side decode-step inputs, rebuilt per step; the block-table row
        # of a slot is rewritten only when its request's pages change
        S = self.max_slots
        self._np_tokens = np.zeros((S, 1), np.int64)
        self._np_bt = np.zeros((S, pages_per_req), np.int32)
        self._np_len = np.ones(S, np.int32)
        self._np_wp = np.zeros(S, np.int64)
        self._bt_slot_version: list = [None] * S
        self._np_temp = np.zeros(S, np.float32)
        self._np_topk = np.zeros(S, np.int64)
        self._np_topp = np.ones(S, np.float32)
        self._np_rng = np.zeros((S, 2), np.int64)

    # -- public API ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, eos_id: int | None = None,
               deadline_s: float | None = None, priority: int = 0,
               sampling: SamplingParams | None = None, best_of: int = 1) -> Request:
        """Enqueue a request. ``deadline_s`` is the budget from now (expiry
        sheds it with ``DeadlineExceeded``); ``priority`` orders admission
        and shedding. ``best_of=N`` runs N branches over one prefill: the
        primary prefills and N-1 clones fork its block table copy-on-write
        once the prompt is resident, each on its own stream
        (``sampling.fork``). Returns the primary; ``request.fork_group`` is
        the whole group. Raises ``InfeasibleRequest`` when the request could
        never run on this engine and ``AdmissionRejected`` when admissions
        are stopped or the bounded queue sheds it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if best_of < 1:
            raise ValueError(f"best_of must be >= 1, got {best_of}")
        sampling = GREEDY if sampling is None else sampling
        total = int(prompt.size) + int(max_new_tokens)
        if total > self.max_context:
            raise InfeasibleRequest(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine context window ({self.max_context})",
                engine_id=self.engine_id)
        # worst-case footprint: the final context or the chunk-PADDED
        # prefill high-water mark, whichever is larger
        worst = max(total, self._padded_prefill_len(total))
        if self.geom.pages_for(worst) > self.cache.pages_total:
            raise InfeasibleRequest(
                f"request needs up to {self.geom.pages_for(worst)} KV pages; the "
                f"pool only has {self.cache.pages_total} — enlarge num_pages",
                engine_id=self.engine_id)
        now = time.perf_counter()

        def new_request(sp: SamplingParams, parent=None) -> Request:
            r = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                        request_id=next(_REQUEST_IDS), eos_id=eos_id,
                        priority=int(priority),
                        deadline_at=None if deadline_s is None else now + float(deadline_s),
                        submitted_s=now, submitted_us=_observe._now_us(),
                        sampling=sp, fork_parent=parent)
            r.stream_seed = sp.stream_seed(r.request_id)
            self.obs.event("serving_submitted", request=r.request_id,
                           prompt_tokens=int(prompt.size), max_new_tokens=int(max_new_tokens),
                           priority=r.priority, deadline_s=deadline_s,
                           best_of=best_of if parent is None else None,
                           fork_of=None if parent is None else parent.request_id)
            self._phase_begin(r, QUEUED)
            return r

        req = new_request(sampling)
        if best_of > 1:
            req.fork_pending = [new_request(sampling.fork(i), parent=req)
                                for i in range(1, best_of)]
            req.fork_group = [req, *req.fork_pending]
        if not self.admitting:
            err = AdmissionRejected(
                f"request {req.request_id} rejected: engine is draining, admissions "
                f"are stopped", request_id=req.request_id, engine_id=self.engine_id)
            self._shed(req, err)
            raise err
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            victim = min(self.queue, key=lambda r: (r.priority, -r.request_id)) \
                if self.queue else None
            if victim is None or victim.priority >= req.priority:
                err = AdmissionRejected(
                    f"request {req.request_id} rejected: admission queue full "
                    f"({self.max_queue}) and every queued request has priority "
                    f">= {req.priority}", request_id=req.request_id,
                    engine_id=self.engine_id)
                self._shed(req, err)
                raise err
            self._shed(victim, AdmissionRejected(
                f"request {victim.request_id} (priority {victim.priority}) shed "
                f"from the full admission queue for higher-priority request "
                f"{req.request_id}", request_id=victim.request_id,
                engine_id=self.engine_id))
        self.queue.append(req)
        self._gauges()
        return req

    def step(self) -> bool:
        """One engine iteration: expire deadlines, fork pending best-of
        clones, admit, one batched decode step, prefill. Returns whether any
        progress was made."""
        self._step_count += 1
        busy = bool(self.queue) or self.active_requests > 0
        t0_us = _observe._now_us()
        worked = self._expire_deadlines()
        # pending forks take slots before fresh admissions (older traffic,
        # and a fork is cheaper than a prefill)
        for r in self.slots:
            if r is not None and r.fork_pending:
                worked = self._materialize_forks(r) or worked
        worked = self._admit() or worked
        if busy:
            # idle polling steps stay out of the flight ring
            self.obs.record_span("schedule", "serving:sched", t0_us,
                                 _observe._now_us() - t0_us, {"step": self._step_count})
        worked = self._decode_step() or worked
        decoding = sum(1 for r in self.slots if r is not None and r.state == DECODE)
        budget = 1 if decoding > self.max_slots // 2 else self.max_slots
        for _ in range(budget):
            if not self._prefill_one():
                break
            worked = True
            self._admit()  # a completed prefill may relieve back-pressure
        if busy or worked:
            self._gauges()
        return worked

    def drain(self, max_steps: int = 1_000_000) -> list[Request]:
        """Run until every submitted request is completed or shed. Returns
        the completed requests in completion order. Raises
        ``EngineStallError`` on a no-progress step or after ``max_steps``."""
        for _ in range(max_steps):
            if self.idle:
                break
            if not self.step():
                raise self._stall_error("no-progress step")
        else:
            if not self.idle:
                raise self._stall_error(f"no completion in {max_steps} steps")
        return self.completed

    def stop_admissions(self) -> None:
        """Graceful-drain entry: every later ``submit()`` raises
        ``AdmissionRejected``; resident and queued requests keep running."""
        self.admitting = False

    def shed_outstanding(self, reason: str) -> list[Request]:
        """Shed every queued and resident request with ``DeadlineExceeded``
        (a drain's wall-clock bound expired). Pages return to the pool; the
        tokens produced so far stay readable on the request."""
        victims = list(self.queue) + [r for r in self.slots if r is not None]
        for req in victims:
            self._shed(req, DeadlineExceeded(f"request {req.request_id} shed: {reason}",
                                             request_id=req.request_id,
                                             engine_id=self.engine_id))
        return victims

    def rebuild_after_fault(self, restart_state: RestartState | None = None) -> list[Request]:
        """Crash recovery (the supervisor's restart rung): drop the consumed
        pools, build fresh ones from the restart state, drop the decode
        binding, and re-queue every in-flight request for recompute-on-resume
        re-prefill — ``_preempt``'s discipline. Tokens generated before the
        fault are kept; the re-prefill recomputes the K/V of prompt and
        generated tokens as prefill rows where they were decode rows, so in
        float32 the later tokens equal a fault-free run's, but at 16-bit
        precision those rows round differently and the later tokens can
        differ from it. ``restart_state`` (the record the fault
        carried) must equal the engine's own; a mismatch is a lifecycle bug
        and raises ``ValueError``."""
        if restart_state is not None and restart_state != self._restart_state:
            raise ValueError(f"restart state mismatch: the fault's recorded pool spec "
                             f"{restart_state.describe()} != this engine's "
                             f"{self._restart_state.describe()}")
        residents = sorted((r for r in self.slots if r is not None),
                           key=lambda r: r.admit_seq, reverse=True)
        for req in residents:
            self.slots[self.slots.index(req)] = None
            self._phase_end(req, reason="engine_restart")
            req.pages = []          # the pool they lived in is gone
            req.pages_version += 1
            req.prefilled = 0
            req.length = 0
            req.next_token = None
            req._replay = False
            req.state = QUEUED
            req.restarts += 1
            self.queue.appendleft(req)  # reverse admit order -> FIFO resume
            self._phase_begin(req, QUEUED)
        rs = self._restart_state
        self.cache.consume_pools()      # free the old device memory first
        self.cache = PagedKVCache(rs.geometry, rs.dtype, rs.device)
        if self.prefix is not None:
            # the trie's pages died with the pools; re-donation refills it
            self.prefix = PrefixCache(self.cache)
        self._bound_epoch = None
        self._np_bt[:] = 0
        self._bt_slot_version = [None] * self.max_slots
        self._gauges()
        return residents

    def assert_quiescent(self) -> None:
        """Leak audit: idle, every page free or parked, block tables
        scratch-only."""
        busy = [r.request_id for r in self.slots if r is not None]
        if busy or self.queue:
            raise AssertionError(f"engine not idle: resident {busy}, queued "
                                 f"{[r.request_id for r in self.queue]}")
        self.cache.assert_quiescent(self._np_bt)

    def reset_slo_window(self) -> None:
        """Restart SLO-attainment accounting (benchmarks: exclude warm-up)."""
        self._slo_attained = 0
        self._slo_total = 0
        self._slo_resets += 1

    @property
    def active_requests(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return not self.queue and not any(s is not None for s in self.slots)

    def describe_state(self) -> dict:
        """Plain-dict engine and cache state — what a postmortem bundle
        embeds: slots, queue, page accounting, block-table liveness, and the
        ``assert_quiescent`` finding (its text when not quiescent)."""
        try:
            self.assert_quiescent()
            quiescence = "quiescent"
        except AssertionError as e:
            quiescence = str(e)
        return {
            "engine_id": self.engine_id,
            "step": self._step_count,
            "admitting": self.admitting,
            "slots": [{"slot": i, "request": r.request_id, "state": r.state,
                       "pages": len(r.pages), "prefilled": r.prefilled,
                       "length": r.length, "generated": len(r.generated),
                       "priority": r.priority, "preemptions": r.preemptions,
                       "restarts": r.restarts}
                      for i, r in enumerate(self.slots) if r is not None],
            "queued": [r.request_id for r in self.queue],
            "completed": len(self.completed),
            "shed": len(self.shed),
            "pages_free": self.cache.pages_free,
            "pages_total": self.cache.pages_total,
            "peak_pages_used": self.cache.peak_pages_used,
            "pools_alive": self.cache.pools_alive(),
            "cached_pages": self.cache.cached_pages,
            "cow_copies": self.cache.cow_copies,
            "prefix_hit_rate": (round(self.prefix.hit_rate(), 4)
                                if self.prefix is not None else None),
            "block_table_rows_live": int((self._np_bt != 0).any(1).sum()),
            "quiescence": quiescence,
            "slo": {"attained": self._slo_attained, "total": self._slo_total},
            "mesh": self._restart_state.describe(),
        }

    # -- lifecycle tracing --------------------------------------------------
    def _phase_begin(self, req: Request, phase: str) -> None:
        req._phase = phase
        req._phase_t0_us = _observe._now_us()

    def _phase_end(self, req: Request, **args) -> None:
        """Close the request's open phase as a span (queued time also
        accumulates on the request)."""
        if not req._phase:
            return
        dur_us = _observe._now_us() - req._phase_t0_us
        if req._phase == QUEUED:
            req.queued_ms += dur_us / 1e3
        self.obs.record_span(req._phase, "serving:request", req._phase_t0_us, dur_us,
                             {"request": req.request_id, **args})
        req._phase = ""

    def _close_request_span(self, req: Request) -> None:
        """The terminal span covering submit to the end, phases nested."""
        self.obs.record_span(
            f"request {req.request_id}", "serving:request", req.submitted_us,
            _observe._now_us() - req.submitted_us,
            {"request": req.request_id, "state": req.state, "tokens": len(req.generated),
             "queued_ms": round(req.queued_ms, 3), "prefill_chunks": req.prefill_chunks,
             "preemptions": req.preemptions, "restarts": req.restarts})

    def _gauges(self) -> None:
        self.obs.set_gauge("serving.queue_depth", len(self.queue))
        self.obs.set_gauge("serving.active_requests", self.active_requests)
        self.obs.set_gauge("serving.kv_pages_free", self.cache.pages_free)
        if self.prefix is not None:
            self.obs.set_gauge("serving.cached_pages", self.cache.cached_pages)
        if self._slo_total:
            self.obs.set_gauge("serving.slo_attainment", self._slo_attained / self._slo_total)

    # -- scheduling internals -----------------------------------------------
    def _stall_error(self, why: str) -> EngineStallError:
        stuck = [(r.request_id, r.state) for r in self.queue]
        stuck += [(r.request_id, r.state) for r in self.slots if r is not None]
        return EngineStallError(
            f"engine stalled ({why}) with {len(stuck)} request(s) outstanding: "
            f"{stuck} — free pages {self.cache.pages_free}/{self.cache.pages_total}",
            stuck=stuck)

    def _expire_deadlines(self) -> bool:
        now = time.perf_counter()
        expired = [r for r in self.queue if r.deadline_at is not None and now > r.deadline_at]
        expired += [r for r in self.slots if r is not None and r.deadline_at is not None
                    and now > r.deadline_at]
        # pending fork clones expire too (they ride a resident primary)
        expired += [c for r in self.slots if r is not None for c in r.fork_pending
                    if c.deadline_at is not None and now > c.deadline_at]
        for req in expired:
            self._shed(req, DeadlineExceeded(
                f"request {req.request_id} missed its deadline "
                f"({req.deadline_at - req.submitted_s:.3f}s) in state {req.state}",
                request_id=req.request_id, deadline_s=req.deadline_at - req.submitted_s,
                engine_id=self.engine_id))
        return bool(expired)

    def _shed(self, req: Request, error: BaseException) -> None:
        """Terminal removal with a typed error: from the queue, a slot, a
        primary's pending forks, or before admission. Pending clones die
        with their primary."""
        if req.state in (DONE, SHED):
            return
        shed_from = req.state
        if req in self.queue:
            self.queue.remove(req)
        elif req in self.slots:
            self._release_slot(req)
        elif req.fork_parent is not None and req in req.fork_parent.fork_pending:
            req.fork_parent.fork_pending.remove(req)
        for clone in list(req.fork_pending):
            kind = DeadlineExceeded if isinstance(error, DeadlineExceeded) else AdmissionRejected
            self._shed(clone, kind(
                f"request {clone.request_id} shed with its fork primary "
                f"{req.request_id} ({type(error).__name__})",
                request_id=clone.request_id, engine_id=self.engine_id))
        req.fork_pending = []
        self._phase_end(req, reason=type(error).__name__)
        req.state = SHED
        req.error = error
        req.finished_s = time.perf_counter()
        self._close_request_span(req)
        self.shed.append(req)
        self._slo_total += 1
        self.obs.inc("serving.shed_requests")
        if isinstance(error, DeadlineExceeded):
            self.obs.inc("serving.deadline_misses")
        self.obs.event("serving_shed", request=req.request_id, priority=req.priority,
                       state=shed_from, reason=type(error).__name__,
                       generated=len(req.generated))
        self._gauges()

    def _release_slot(self, req: Request) -> None:
        """Drop a resident request's page references and zero its
        block-table row."""
        slot = self.slots.index(req)
        self.cache.free(req.pages)
        req.pages = []
        req.pages_version += 1
        self.slots[slot] = None
        self._np_bt[slot] = 0
        self._bt_slot_version[slot] = None

    def _admit(self) -> bool:
        admitted = False
        while self.queue:
            slot = next((i for i, s in enumerate(self.slots) if s is None), None)
            if slot is None:
                break
            req = max(self.queue, key=lambda r: r.priority)
            wp = req.work_prompt
            # prefix probe (sizing pass, nothing retained): prefill starts
            # at the first uncached page
            hit = self.prefix.lookup(wp) if self.prefix is not None else []
            hit_tokens = len(hit) * self.geom.page_size
            first_chunk = self._chunk_size(len(wp) - hit_tokens)
            need_new = (hit_tokens + first_chunk) // self.geom.page_size - len(hit)
            # hit pages parked at refcount 0 are about to be claimed: they
            # are not evictable headroom
            parked_hits = sum(1 for p in hit if self.cache.refcount(p) == 0)
            if self.cache.pages_free + self.cache.cached_pages - parked_hits < need_new:
                break   # page back-pressure: wait for completions or evictions
            try:
                _faults.maybe_fail("serving:admission", step=self._step_count)
            except _faults.InjectedFault as e:
                # contained: the request stays queued and the next step
                # retries it; a deliberate wait counts as progress
                self.obs.event("serving_admission_fault", error=repr(e),
                               request=req.request_id)
                admitted = True
                break
            self.queue.remove(req)
            # claim the probed chain first, so the alloc below cannot evict it
            chain = self.prefix.probe(wp, req.request_id, chain=hit) \
                if self.prefix is not None else []
            req.pages = chain + self.cache.alloc(need_new)
            req.pages_version += 1
            req.prefilled = len(chain) * self.geom.page_size
            req.prefix_hit_tokens = req.prefilled
            req.length = 0
            req.state = PREFILL
            req.admit_seq = next(self._admits)
            self.slots[slot] = req
            self._phase_end(req)            # close "queued"
            self.obs.event("serving_admitted", request=req.request_id, slot=slot,
                           preemptions=req.preemptions, restarts=req.restarts,
                           prefix_hit_tokens=req.prefilled)
            self._phase_begin(req, PREFILL)
            admitted = True
        return admitted

    def _chunk_size(self, remaining: int) -> int:
        return self.max_chunk if remaining >= self.max_chunk \
            else self.chunker.bucket_for(remaining)

    def _padded_prefill_len(self, n: int) -> int:
        """Context length at the end of prefilling ``n`` tokens, including
        the final chunk's ladder padding."""
        full = (n // self.max_chunk) * self.max_chunk
        rem = n - full
        return full + (self.chunker.bucket_for(rem) if rem else 0)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _dispatch_guarded(self, dispatch, domain: str):
        """Run a dispatch under the engine's retry policy. A retryable
        failure that consumed the pools is fatal to in-place retry, and any
        failure that leaves them consumed surfaces as ``EngineFault``, the
        supervisor's restart signal."""
        def classify(exc):
            kind = _retry.classify(exc)
            if kind == _retry.RETRYABLE and not self.cache.pools_alive():
                return _retry.FATAL
            return kind

        try:
            return _retry.call_with_retry(dispatch, domain=domain, policy=self._retry_policy,
                                          classify_fn=classify)
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            raise
        except BaseException as e:
            if not self.cache.pools_alive():
                raise EngineFault(
                    f"{domain} dispatch consumed the page pools; in-place retry is "
                    f"impossible — supervisor restart (pool rebuild + re-prefill) "
                    f"required", domain=domain, restart_state=self._restart_state,
                    engine_id=self.engine_id) from e
            raise

    def _prefill_one(self) -> bool:
        """Advance the head-of-line prefilling request by ONE chunk."""
        req = min((r for r in self.slots if r is not None and r.state == PREFILL),
                  key=lambda r: r.admit_seq, default=None)
        if req is None:
            return False
        g = self.geom
        wp = req.work_prompt
        remaining = len(wp) - req.prefilled
        C = self._chunk_size(remaining)
        pos0 = req.prefilled                        # chunk and page aligned
        need_total = (pos0 + C) // g.page_size
        if len(req.pages) < need_total and \
                not self._grow_pages(req, need_total - len(req.pages)):
            return False                            # preempted or must wait
        real = min(remaining, C)
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :real] = wp[pos0:pos0 + real]
        first_page = pos0 // g.page_size
        page_writes = np.asarray(req.pages[first_page:first_page + C // g.page_size],
                                 np.int64) * g.page_size
        bt = np.zeros((1, g.pages_per_request), np.int32)
        bt[0, :len(req.pages)] = req.pages
        args = (self._tensor(chunk), self._tensor(bt),
                self._tensor(np.asarray([pos0 + C], np.int32)), self._tensor(page_writes))

        def dispatch():
            # the hook fires before any launch, so a retry re-runs the chunk
            # on the same inputs; a replayed chunk rewrites the same K/V rows
            _faults.maybe_fail("serving:prefill", step=self._step_count)
            self._contained(lambda: self.runner.prefill(self.params, *args, self.cache.pools))

        t0 = time.perf_counter()
        t0_us = _observe._now_us()
        self._dispatch_guarded(dispatch, "serving:prefill")
        dur_us = _observe._now_us() - t0_us
        self.obs.observe_value("serving.prefill_ms", (time.perf_counter() - t0) * 1e3)
        self.obs.record_span("prefill_chunk", "serving:request", t0_us, dur_us,
                             {"request": req.request_id, "chunk": C, "pos0": pos0})
        req.prefill_chunks += 1
        self.obs.event("serving_prefill_chunk", request=req.request_id, chunk=C, pos0=pos0,
                       real=real)
        req.prefilled += real
        if req.prefilled == len(wp):                # prompt fully resident
            # the FIRST token comes from the next decode step as a replay of
            # the last prompt token (its K/V row exists; the write goes to
            # the scratch page)
            req.length = len(wp)
            req.next_token = int(wp[-1])
            req._replay = True
            req.state = DECODE
            self._phase_end(req)                    # close "prefill"
            self._phase_begin(req, DECODE)
            if req.decode_start_s is None:
                req.decode_start_s = time.perf_counter()
            if req.fork_pending:
                self._materialize_forks(req)        # the prompt is resident
        return True

    def _grow_pages(self, req: Request, n: int) -> bool:
        """Allocate ``n`` more pages for ``req``, preempting the lowest-
        priority newest other resident while the pool is dry; requeues
        ``req`` itself when nothing else may be evicted."""
        while not self.cache.can_alloc(n):
            victim = min((r for r in self.slots
                          if r is not None and r.state in (DECODE, PREFILL) and r is not req),
                         key=lambda r: (r.priority, -r.admit_seq), default=None)
            if victim is None or victim.priority > req.priority:
                self._preempt(req)
                return False
            self._preempt(victim)
        req.pages.extend(self.cache.alloc(n))
        req.pages_version += 1
        return True

    def _preempt(self, req: Request) -> None:
        """Evict a resident request to the queue head (recompute-on-resume)."""
        self._release_slot(req)
        self._phase_end(req, reason="preempt")
        req.prefilled = 0
        req.length = 0
        req.next_token = None
        req._replay = False
        req.state = QUEUED
        req.preemptions += 1
        self.queue.appendleft(req)
        self._phase_begin(req, QUEUED)
        self.obs.inc("serving.preempted_requests")
        self.obs.event("serving_preempt", request=req.request_id, generated=len(req.generated))

    def _decode_step(self) -> bool:
        """One batched decode step over every resident DECODE request."""
        g = self.geom
        for req in list(self.slots):
            if req is None or req.state != DECODE:
                continue
            # a replay row writes nothing: it needs only its context pages
            need = (-(-req.length // g.page_size) if req._replay
                    else req.length // g.page_size + 1)
            if len(req.pages) < need:
                self._grow_pages(req, need - len(req.pages))
        active = [(i, r) for i, r in enumerate(self.slots)
                  if r is not None and r.state == DECODE]
        if not active:
            return False
        tokens, bt = self._np_tokens, self._np_bt
        lengths, write_pos = self._np_len, self._np_wp
        for i in range(self.max_slots):
            r = self.slots[i]
            if r is None or r.state != DECODE:
                # idle slots attend and write the reserved page 0 only, as
                # greedy rows on the zero key (their token is discarded)
                tokens[i, 0] = 0
                lengths[i] = 1
                write_pos[i] = 0
                self._np_temp[i] = 0.0
                self._np_topk[i] = 0
                self._np_topp[i] = 1.0
                self._np_rng[i] = 0
                if self._bt_slot_version[i] is not None:
                    bt[i] = 0
                    self._bt_slot_version[i] = None
        for i, r in active:
            tokens[i, 0] = r.next_token
            key = (r.request_id, r.pages_version)
            if self._bt_slot_version[i] != key:
                bt[i, :len(r.pages)] = r.pages
                bt[i, len(r.pages):] = 0
                self._bt_slot_version[i] = key
            if r._replay:
                # the fed token's K/V row exists at length - 1 (prefill wrote
                # it, or the fork copied it): the recomputed row goes to the
                # scratch page, so shared pages are never written. Its last
                # row, which no slot reads: the idle slots read row 0, which
                # they all write with one K/V row (token 0 at position 0),
                # and the step's one scatter keeps any one of the values
                # written to a row, so a replay row written there would make
                # the idle rows' logits differ from run to run
                lengths[i] = r.length
                write_pos[i] = g.page_size - 1
            else:
                lengths[i] = r.length + 1
                write_pos[i] = (r.pages[r.length // g.page_size] * g.page_size
                                + r.length % g.page_size)
            sp = r.sampling
            self._np_temp[i] = sp.temperature
            self._np_topk[i] = sp.top_k
            self._np_topp[i] = sp.top_p
            self._np_rng[i, 0] = r.stream_seed
            self._np_rng[i, 1] = len(r.generated)   # counter: tokens sampled so far
        args = (self._tensor(tokens), self._tensor(bt), self._tensor(lengths),
                self._tensor(write_pos))
        sampling = (self._tensor(self._np_temp), self._tensor(self._np_topk),
                    self._tensor(self._np_topp), self._tensor(self._np_rng))

        def run():
            step = (self.params, *args, self.cache.pools, *sampling)
            # a quarantine moved the epoch (here or anywhere in the process):
            # re-bind the decode step, whose new compile takes the rung left
            if self._bound_epoch != _quarantine.epoch():
                self._bind_decode(step)
            return self.runner.decode(*step)

        def dispatch():
            # the hooks fire before any launch, so a retried transient re-runs
            # the step on the same inputs (``step`` is the legacy domain)
            _faults.maybe_fail("step", step=self._step_count)
            _faults.maybe_fail("serving:decode", step=self._step_count)
            try:
                _faults.maybe_fail("serving:engine", step=self._step_count)
            except _faults.InjectedFault:
                # the engine domain simulates a fault that loses the device
                # state mid-step, so the supervisor's restart rung can be
                # exercised deterministically
                self.cache.consume_pools()
                raise
            # replaying the step is safe for a fault that fires before a
            # launch: layer i's K/V row for this position depends only on the
            # step's inputs (the tokens, and the pools' rows before this
            # position, which no layer writes), so a replay rewrites the same
            # values
            return self._contained(run)

        t0_us = _observe._now_us()
        toks, _logits = self._dispatch_guarded(dispatch, "serving:decode")
        toks = toks.cpu().numpy()   # the host sync that bounds the span below
        self.obs.record_span("decode_dispatch", "serving:sched", t0_us,
                             _observe._now_us() - t0_us,
                             {"step": self._step_count, "batch": len(active)})
        for i, r in active:
            if r._replay:
                r._replay = False   # context unchanged; the row existed
            else:
                r.length += 1
            self._on_token(r, int(toks[i]))
        return True

    def _bind_decode(self, step: tuple) -> None:
        ep = _quarantine.epoch()
        if self._bound_epoch is not None:
            # the epoch MOVED under a live binding: a kernel was quarantined
            # and the decode step falls back a rung (the whole-layer kernel
            # to its sub-blocks, or below); a silent fallback would only show
            # as a throughput regression
            self.decode_rebinds += 1
            self.obs.inc("serving.decode_rebinds")
            self.obs.event("serving_decode_rebind", old_epoch=self._bound_epoch, epoch=ep,
                           quarantined=sorted(_quarantine.get_quarantine().ids()))
        self.obs.set_gauge("serving.quarantine_epoch", ep)
        fusions = self.runner.bind_decode(*step)
        launches = self.runner.decode_fusion_shape()[0]
        self.obs.set_gauge("serving.decode_pallas_launches", launches)
        self.obs.set_gauge("serving.decode_layer_fusions", fusions)
        self.obs.event("serving_decode_bind", launches=launches, decode_layer_fusions=fusions)
        self._bound_epoch = ep

    def _contained(self, dispatch):
        """Run a step's dispatch. A routed kernel that fails with a
        degradable error is quarantined and the dispatch replayed on the
        next rung down; a claim that fails twice, or a fatal error (a sticky
        CUDA error leaves the context unusable), propagates."""
        seen: set[str] = set()
        while True:
            try:
                return dispatch()
            except KernelExecutionError as err:
                if _retry.classify(err) != _retry.DEGRADABLE or err.claim_id in seen:
                    raise
                seen.add(err.claim_id)
                _quarantine.get_quarantine().add(err.claim_id, reason=repr(err.__cause__ or err),
                                                 phase=err.phase)
                self.obs.inc("runtime.fallbacks")
                self.obs.event("kernel_fallback", claim=err.claim_id, phase=err.phase)

    def _on_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        req.next_token = tok
        if req.ttft_s is None:
            req.ttft_s = time.perf_counter() - req.submitted_s
            self.obs.observe_value("serving.ttft_ms", req.ttft_s * 1e3)
            self.obs.event("serving_first_token", request=req.request_id,
                           ttft_ms=round(req.ttft_s * 1e3, 3))
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finish(req)

    def _materialize_forks(self, primary: Request) -> bool:
        """Fork pending best-of clones off a resident primary whose prompt
        is fully resident: full prompt pages shared by refcount, a partial
        tail page copied (``serving.cow_copies``). Each clone takes a free
        slot and enters decode as a replay, so its first token samples from
        the prompt's last position on its own stream, as an independently
        submitted request's would. A clone that cannot fork yet (no free
        slot, no page for the tail copy) stays pending; a strictly
        higher-priority queued request takes a free slot first."""
        g = self.geom
        L = len(primary.prompt)
        n_ctx = g.pages_for(L)
        if primary.state != DECODE or len(primary.pages) < n_ctx:
            return False
        top_queued = max((r.priority for r in self.queue), default=None)
        worked = False
        while primary.fork_pending:
            if top_queued is not None and top_queued > primary.fork_pending[0].priority:
                break
            slot = next((i for i, s in enumerate(self.slots) if s is None), None)
            if slot is None:
                break
            clone = primary.fork_pending[0]
            cow_before = self.cache.cow_copies
            try:
                pages = self.cache.fork(primary.pages, L)
            except OutOfPages:
                break       # the tail copy cannot allocate; retry under less load
            primary.fork_pending.pop(0)
            copied = self.cache.cow_copies - cow_before
            if copied:
                self.obs.inc("serving.cow_copies", copied)
            clone.pages = pages
            clone.pages_version += 1
            clone.prefilled = L
            clone.length = L
            clone.next_token = int(clone.prompt[-1])
            clone._replay = True
            clone.state = DECODE
            clone.admit_seq = next(self._admits)
            self.slots[slot] = clone
            self._phase_end(clone)          # close "queued" (fork-pending)
            self.obs.event("serving_fork", request=clone.request_id,
                           parent=primary.request_id, slot=slot,
                           shared_pages=len(pages) - copied, copied=copied)
            self._phase_begin(clone, DECODE)
            if clone.decode_start_s is None:
                clone.decode_start_s = time.perf_counter()
            worked = True
        return worked

    def _finish(self, req: Request) -> None:
        if self.prefix is not None and req.pages:
            # donate before freeing: registration is what parks the pages,
            # K/V kept, when the release below drops their last reference
            self.prefix.donate(req.work_prompt, req.pages)
        for clone in list(req.fork_pending):
            # never-forked clones fall back to the queue (a full prefill,
            # which may now hit the donated prompt), within max_queue
            if self.max_queue is not None and len(self.queue) >= self.max_queue:
                self._shed(clone, AdmissionRejected(
                    f"request {clone.request_id} shed: fork primary {req.request_id} "
                    f"finished before the clone could fork and the admission queue is "
                    f"full ({self.max_queue})", request_id=clone.request_id,
                    engine_id=self.engine_id))
            else:
                self.queue.appendleft(clone)
        req.fork_pending = []
        self._release_slot(req)
        self._phase_end(req)            # close "decode"
        req.state = DONE
        req.finished_s = time.perf_counter()
        self._close_request_span(req)
        if req.decode_start_s is not None:
            self.obs.observe_value("serving.decode_ms",
                                   (req.finished_s - req.decode_start_s) * 1e3)
        self.completed.append(req)
        self._slo_total += 1
        if req.deadline_at is None or req.finished_s <= req.deadline_at:
            self._slo_attained += 1
        else:
            self.obs.inc("serving.deadline_misses")   # completed, but late
        self.obs.event("serving_complete", request=req.request_id,
                       generated=len(req.generated), preemptions=req.preemptions,
                       restarts=req.restarts)
