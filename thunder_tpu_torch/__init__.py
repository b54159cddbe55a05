"""thunder_tpu_torch — the PyTorch/CUDA port of thunder_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout and names, so each module's counterpart
is found at the same path under ``thunder_tpu/``. It imports neither JAX nor
anything of ``thunder_tpu``. Ported: serving at the reference's per-op
and planned rungs, the single-device train step at its per-op and planned
rungs with its input pipeline, checkpoints and gradient clipping, the
reference's headline train bench, the runtime-safety layer, the
single-card serving fleet and the model zoo:

- :mod:`thunder_tpu_torch.serving` — ``ServingEngine`` (continuous batching
  over a paged KV cache), on ``cuda`` unless ``device="cpu"`` is passed;
- :mod:`thunder_tpu_torch.benchmarks.pretrain` — the single-device train
  step (``loss_fn``, its gradients, :class:`thunder_tpu_torch.optim.AdamW`),
  per-op or, with ``block_fusion=True``, planned;
- :mod:`thunder_tpu_torch.benchmarks.bench` — the headline bench's step
  (``fused_loss_fn``, ``remat``, ``AdamW(slab_persistent=True)``) at
  ``llama2-7b-bench`` width;
- :mod:`thunder_tpu_torch.data` — the token file's ``ShardedTokenStream``
  and ``TokenDataset`` (a C++ loader built at first use, with a bit-exact
  Python twin), ``write_token_file``, ``LengthBucketer`` and
  ``default_buckets``; ``pretrain.run(data=...)`` trains from it;
- :mod:`thunder_tpu_torch.checkpoint` — ``save_checkpoint`` (sync or
  asynchronous), ``wait_for_checkpoints`` and ``load_checkpoint``;
- :mod:`thunder_tpu_torch.optim` — ``AdamW``, ``SGD`` and ``clip_grad_norm``;
- :mod:`thunder_tpu_torch.core.rematerialization` — ``checkpoint``;
- :mod:`thunder_tpu_torch.models.llama` — configs, ``init_params``,
  ``params_from_jax``, the training forward and loss;
- the model zoo — :mod:`thunder_tpu_torch.models.mixtral` (top-k routed
  experts), :mod:`~thunder_tpu_torch.models.gpt` (the multi-family GPT),
  :mod:`~thunder_tpu_torch.models.nanogpt`,
  :mod:`~thunder_tpu_torch.models.seq2seq` and
  :mod:`~thunder_tpu_torch.models.resnet`, trained by
  :mod:`thunder_tpu_torch.benchmarks.zoo`;
- :mod:`thunder_tpu_torch.ops.nn` and :mod:`thunder_tpu_torch.ops.optim` —
  the slices' functions, each with its plain version, and their gradients;
- :mod:`thunder_tpu_torch.executors.cudaex` — the hand-written ``sm_90a``
  kernels (``rms_norm``, ``rms_norm_residual``, ``linear_act``,
  ``paged_decode_attention``, ``sdpa_fwd``, ``sdpa_bwd``, ``ce_fwd``,
  ``fused_adamw``, ``fused_adamw_slab`` and their health passes,
  ``mlp_subblock``, ``mlp_subblock_bwd``, ``decode_layer``,
  ``attn_subblock``), built from ``csrc/`` at first use;
  ``refusal(name, ...)`` says why one does not take its arguments;
- :mod:`thunder_tpu_torch.observe` — the metric registry and the flight
  ring;
- :mod:`thunder_tpu_torch.runtime` — fault injection (``FaultPlan``), retry
  policies and ``RestartBudget``, the kernel quarantine the routers of
  ``ops/`` read, and the numerics sentinel;
- :mod:`thunder_tpu_torch.transforms.numerics_guard` — ``NumericsGuard``,
  the guarded train step (``pretrain.run(guard=...)``).
"""

from thunder_tpu_torch.devices import resolve_device  # noqa: F401
