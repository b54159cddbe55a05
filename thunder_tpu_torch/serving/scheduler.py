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
  requests and evicts expired residents with :class:`~errors.DeadlineExceeded`.
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

- **Kernel quarantine** (the counterpart of ``scheduler.py:1063-1089``): a
  routed kernel that fails in a decode step or a prefill chunk
  (``runtime.faults.KernelExecutionError``, degradable) is quarantined,
  which moves the quarantine epoch; the engine re-binds the decode layer
  to the next kernel rung down (``runner.bind_decode``) and replays the
  step. It emits ``serving.decode_rebinds``, the ``serving_decode_rebind``
  event, ``serving.quarantine_epoch`` and ``serving.decode_layer_fusions``
  through ``observe.labeled(engine=...)``. A fatal error propagates
  (``runtime.retry.classify``): a sticky CUDA error, and a quarantined
  kernel with no kernel rung below it called on the card.

Left out of this port so far, each kept in the reference: best-of-N forks,
the prefix cache, tensor-parallel meshes, the supervisor, the ``serving:*``
fault domains and retry policies, and the other observability emissions.
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
from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.runtime import quarantine as _quarantine
from thunder_tpu_torch.runtime import retry as _retry
from thunder_tpu_torch.runtime.faults import KernelExecutionError
from thunder_tpu_torch.serving.errors import (
    AdmissionRejected,
    DeadlineExceeded,
    EngineStallError,
    InfeasibleRequest,
)
from thunder_tpu_torch.serving.kv_cache import PagedKVCache, PageGeometry
from thunder_tpu_torch.serving.runner import PagedLlamaRunner
from thunder_tpu_torch.serving.sampling import GREEDY, SamplingParams

QUEUED, PREFILL, DECODE, DONE, SHED = "queued", "prefill", "decode", "done", "shed"

# process-unique request ids (they seed the sampling stream of a request
# whose SamplingParams carry no seed)
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
    preemptions: int = 0
    prefill_chunks: int = 0
    admit_seq: int = -1                 # admission order (preemption victim pick)
    pages_version: int = 0              # bumped when ``pages`` changes
    sampling: SamplingParams = GREEDY
    stream_seed: int = 0
    _replay: bool = False               # next decode step re-feeds the last
    #                                     prompt token to sample the first one

    @property
    def work_prompt(self) -> np.ndarray:
        """What prefill must write: the prompt plus any tokens generated
        before a preemption (recompute-on-resume)."""
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
    pool (default: full residency for every slot). ``block_fusion`` picks
    the runner's rung: False (the default) the per-op rung, True the planned
    rung, one ``decode_layer`` launch per layer per decode step and one
    ``mlp_subblock`` per layer per prefill chunk. The port has no cost model
    to choose between them. The engine's metrics carry the label
    ``engine=e<n>``, ``n`` counting the process's engines.
    """

    def __init__(self, params, cfg, *, device=None, max_slots: int = 8,
                 page_size: int = 16, num_pages: int | None = None,
                 max_context: int | None = None, prefill_chunk: int | None = None,
                 max_queue: int | None = None, block_fusion: bool = False):
        self.engine_id = f"e{next(_ENGINE_IDS)}"
        self.obs = _observe.labeled(engine=self.engine_id)
        self.decode_rebinds = 0        # quarantine-forced re-binds of the decode layer
        self._bound_epoch = None       # the quarantine epoch the decode layer is bound at
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
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
        self.cache = PagedKVCache(self.geom, cfg.dtype, self.device)
        self.runner = PagedLlamaRunner(cfg, self.geom, block_fusion=block_fusion)
        self.max_slots = int(max_slots)
        self.max_queue = max_queue
        self.slots: list[Request | None] = [None] * self.max_slots
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []
        self._admits = itertools.count()
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
               sampling: SamplingParams | None = None) -> Request:
        """Enqueue a request. ``deadline_s`` is the budget from now (expiry
        sheds it with ``DeadlineExceeded``); ``priority`` orders admission
        and shedding. Raises ``InfeasibleRequest`` when the request could
        never run on this engine and ``AdmissionRejected`` when the bounded
        queue sheds it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        sampling = GREEDY if sampling is None else sampling
        total = int(prompt.size) + int(max_new_tokens)
        if total > self.max_context:
            raise InfeasibleRequest(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine context window ({self.max_context})")
        # worst-case footprint: the final context or the chunk-PADDED
        # prefill high-water mark, whichever is larger
        worst = max(total, self._padded_prefill_len(total))
        if self.geom.pages_for(worst) > self.cache.pages_total:
            raise InfeasibleRequest(
                f"request needs up to {self.geom.pages_for(worst)} KV pages; the "
                f"pool only has {self.cache.pages_total} — enlarge num_pages")
        now = time.perf_counter()
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      request_id=next(_REQUEST_IDS), eos_id=eos_id,
                      priority=int(priority),
                      deadline_at=None if deadline_s is None else now + float(deadline_s),
                      submitted_s=now, sampling=sampling)
        req.stream_seed = sampling.stream_seed(req.request_id)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            victim = min(self.queue, key=lambda r: (r.priority, -r.request_id)) \
                if self.queue else None
            if victim is None or victim.priority >= req.priority:
                err = AdmissionRejected(
                    f"request {req.request_id} rejected: admission queue full "
                    f"({self.max_queue}) and every queued request has priority "
                    f">= {req.priority}", request_id=req.request_id)
                self._shed(req, err)
                raise err
            self._shed(victim, AdmissionRejected(
                f"request {victim.request_id} (priority {victim.priority}) shed "
                f"from the full admission queue for higher-priority request "
                f"{req.request_id}", request_id=victim.request_id))
        self.queue.append(req)
        return req

    def step(self) -> bool:
        """One engine iteration: expire deadlines, admit, one batched decode
        step, prefill. Returns whether any progress was made."""
        worked = self._expire_deadlines()
        worked = self._admit() or worked
        worked = self._decode_step() or worked
        decoding = sum(1 for r in self.slots if r is not None and r.state == DECODE)
        budget = 1 if decoding > self.max_slots // 2 else self.max_slots
        for _ in range(budget):
            if not self._prefill_one():
                break
            worked = True
            self._admit()  # a completed prefill may relieve back-pressure
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

    def assert_quiescent(self) -> None:
        """Leak audit: idle, every page free, block tables scratch-only."""
        busy = [r.request_id for r in self.slots if r is not None]
        if busy or self.queue:
            raise AssertionError(f"engine not idle: resident {busy}, queued "
                                 f"{[r.request_id for r in self.queue]}")
        self.cache.assert_quiescent(self._np_bt)

    @property
    def idle(self) -> bool:
        return not self.queue and not any(s is not None for s in self.slots)

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
        for req in expired:
            self._shed(req, DeadlineExceeded(
                f"request {req.request_id} missed its deadline "
                f"({req.deadline_at - req.submitted_s:.3f}s) in state {req.state}",
                request_id=req.request_id, deadline_s=req.deadline_at - req.submitted_s))
        return bool(expired)

    def _shed(self, req: Request, error: BaseException) -> None:
        """Terminal removal with a typed error, from the queue or a slot."""
        if req.state in (DONE, SHED):
            return
        if req in self.queue:
            self.queue.remove(req)
        elif req in self.slots:
            self._release_slot(req)
        req.state = SHED
        req.error = error

    def _release_slot(self, req: Request) -> None:
        """Return a resident request's pages and zero its block-table row."""
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
            need = self._chunk_size(len(req.work_prompt)) // self.geom.page_size
            if self.cache.pages_free < need:
                break   # page back-pressure: wait for completions
            self.queue.remove(req)
            req.pages = self.cache.alloc(need)
            req.pages_version += 1
            req.prefilled = 0
            req.length = 0
            req.state = PREFILL
            req.admit_seq = next(self._admits)
            self.slots[slot] = req
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
        page_ids = np.asarray(req.pages[first_page:first_page + C // g.page_size], np.int64)
        bt = np.zeros((1, g.pages_per_request), np.int32)
        bt[0, :len(req.pages)] = req.pages
        args = (self.params, self._tensor(chunk), self._tensor(bt),
                self._tensor(np.asarray([pos0 + C], np.int32)), self._tensor(page_ids),
                self.cache.pools)
        # a replayed chunk rewrites the same K/V rows into the same pages
        self._contained(lambda: self.runner.prefill(*args))
        req.prefill_chunks += 1
        req.prefilled += real
        if req.prefilled == len(wp):                # prompt fully resident
            # the FIRST token comes from the next decode step as a replay of
            # the last prompt token (its K/V row exists; the write goes to
            # the scratch page)
            req.length = len(wp)
            req.next_token = int(wp[-1])
            req._replay = True
            req.state = DECODE
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
        req.prefilled = 0
        req.length = 0
        req.next_token = None
        req._replay = False
        req.state = QUEUED
        req.preemptions += 1
        self.queue.appendleft(req)

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
                lengths[i] = r.length
                write_pos[i] = 0
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
        args = (self.params, self._tensor(tokens), self._tensor(bt), self._tensor(lengths),
                self._tensor(write_pos), self.cache.pools, self._tensor(self._np_temp),
                self._tensor(self._np_topk), self._tensor(self._np_topp),
                self._tensor(self._np_rng))

        def dispatch():
            # a quarantine moved the epoch (here or anywhere in the process):
            # re-bind the decode layer to the rung it now routes to
            if self._bound_epoch != _quarantine.epoch():
                self._bind_decode()
            return self.runner.decode(*args)

        # replaying the step is safe for a fault that fires before a launch:
        # layer i's K/V row for this position depends only on the step's
        # inputs (the tokens, and the pools' rows before this position, which
        # no layer writes), so a replay rewrites the same values
        toks, _logits = self._contained(dispatch)
        toks = toks.cpu().numpy()
        for i, r in active:
            if r._replay:
                r._replay = False   # context unchanged; the row existed
            else:
                r.length += 1
            self._on_token(r, int(toks[i]))
        return True

    def _bind_decode(self) -> None:
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
        fusions = self.runner.bind_decode()
        self.obs.set_gauge("serving.decode_layer_fusions", fusions)
        self.obs.event("serving_decode_bind", decode_layer_fusions=fusions)
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
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._release_slot(req)
            req.state = DONE
            self.completed.append(req)


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_to_device(v, device) for v in params]
    return params.to(device)
