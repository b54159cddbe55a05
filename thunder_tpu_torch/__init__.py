"""thunder_tpu_torch — the PyTorch/CUDA port of thunder_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout and names, so each module's counterpart
is found at the same path under ``thunder_tpu/``. It imports neither JAX nor
anything of ``thunder_tpu``. Ported: serving at the reference's per-op
rung, and the single-device train step at its per-op and planned rungs:

- :mod:`thunder_tpu_torch.serving` — ``ServingEngine`` (continuous batching
  over a paged KV cache), on ``cuda`` unless ``device="cpu"`` is passed;
- :mod:`thunder_tpu_torch.benchmarks.pretrain` — the single-device train
  step (``loss_fn``, its gradients, :class:`thunder_tpu_torch.optim.AdamW`),
  per-op or, with ``block_fusion=True``, planned;
- :mod:`thunder_tpu_torch.models.llama` — configs, ``init_params``,
  ``params_from_jax``, the training forward and loss;
- :mod:`thunder_tpu_torch.ops.nn` and :mod:`thunder_tpu_torch.ops.optim` —
  the slices' functions, each with its plain version, and their gradients;
- :mod:`thunder_tpu_torch.executors.cudaex` — the hand-written ``sm_90a``
  kernels (``rms_norm``, ``rms_norm_residual``, ``linear_act``,
  ``paged_decode_attention``, ``sdpa_fwd``, ``sdpa_bwd``, ``ce_fwd``,
  ``fused_adamw``, ``mlp_subblock``, ``mlp_subblock_bwd``), built from
  ``csrc/`` at first use.
"""

from thunder_tpu_torch.devices import resolve_device  # noqa: F401
