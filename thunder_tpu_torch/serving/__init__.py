"""Serving runtime of the port: continuous batching over a paged KV cache.

- :mod:`~thunder_tpu_torch.serving.kv_cache` — page pool, LIFO free list,
  refcounts, copy-on-write forks, parked prefix-cache pages;
- :mod:`~thunder_tpu_torch.serving.prefix_cache` — the cross-request
  token trie over full prompt pages;
- :mod:`~thunder_tpu_torch.serving.sampling` — greedy/top-k/top-p sampling
  with a counter-hash Gumbel draw (eager, and traced into the decode step),
  and best-of-N stream forks;
- :mod:`~thunder_tpu_torch.serving.runner` — the prefill and decode steps,
  compiled by ``thunder_tpu_torch.jit`` with the page pools donated;
- :mod:`~thunder_tpu_torch.serving.scheduler` — admission, decode-first
  continuous batching with chunked prefill, preemption, deadlines, best-of-N,
  the prefix cache, fault domains and the kernel quarantine;
- :mod:`~thunder_tpu_torch.serving.supervisor` — restart after an engine
  fault under a budget, graceful drain;
- :mod:`~thunder_tpu_torch.serving.events` — the event vocabulary.

>>> from thunder_tpu_torch.serving import ServingEngine
>>> eng = ServingEngine(params, cfg, max_slots=8, page_size=16, max_context=2048)
>>> req = eng.submit(prompt_ids, max_new_tokens=32)
>>> eng.drain(); req.output()
"""

from thunder_tpu_torch.serving.errors import (  # noqa: F401
    AdmissionRejected,
    DeadlineExceeded,
    EngineFault,
    EngineStallError,
    InfeasibleRequest,
    RestartBudgetExceeded,
    RestartState,
    ServingError,
)
from thunder_tpu_torch.serving.events import EVENT_KINDS  # noqa: F401
from thunder_tpu_torch.serving.kv_cache import (  # noqa: F401
    OutOfPages,
    PagedKVCache,
    PageGeometry,
)
from thunder_tpu_torch.serving.prefix_cache import (  # noqa: F401
    PrefixCache,
    content_key,
    page_chunks,
)
from thunder_tpu_torch.serving.runner import PagedLlamaRunner  # noqa: F401
from thunder_tpu_torch.serving.sampling import (  # noqa: F401
    GREEDY,
    SamplingParams,
    sample_tokens,
)
from thunder_tpu_torch.serving.scheduler import Request, ServingEngine  # noqa: F401
from thunder_tpu_torch.serving.supervisor import EngineSupervisor  # noqa: F401
