"""Paged model runner: the compiled prefill and decode steps the serving
engine dispatches; the counterpart of ``thunder_tpu/serving/runner.py``.

Two traced programs per engine, compiled by :func:`thunder_tpu_torch.jit`
with the page pools donated (``donate_argnums=(5,)``), so the pool writes
run in place (``executors/passes.donate_in_place``):

- ``decode`` (``serving_decode``, :meth:`PagedLlamaRunner._decode_fn`, the
  reference's :175): ONE batched step over every slot — ``(S, 1)`` tokens,
  each slot's K/V row scattered into the pools (``decode_row_write``, one
  ``prims.scatter`` a pool), ragged paged attention, and sampling as the
  epilogue (``sampling.sample_tokens``). Returns the sampled token ids, the
  logits and the pools. Dispatched through ``bind()``: the step pays no
  guard key.
- ``prefill`` (``serving_prefill``, :meth:`PagedLlamaRunner._prefill_fn`,
  :224): one chunk of one request's prompt — ``(1, C)`` tokens with C a
  multiple of the page size, written page by page (:func:`_write_pages`,
  one ``dynamic_update_slice`` a page) and attending the paged context so
  far. It emits no logits (the first token comes from a decode replay
  step), and the last layer's attention and MLP are dead code.

The traces are the reference's per-op program; the block planner picks the
rung (``block_fusion``: None asks the decode cost model, True forces the
planned rung, False the per-op one). At the per-op rung the ``cuda``
executor claims ``rms_norm`` (layer 0's norm), ``rms_norm_residual`` (every
later norm, the residual add folded in by the epilogue pass),
``linear_act`` (the gate and its silu) and ``paged_decode_attention`` (T ==
1); the other products are ``F.linear``. At the planned rung each decode
layer is ONE ``decode_layer`` (or, while it is quarantined, ``attn_subblock``
and ``mlp_subblock``; while a sub-block is quarantined too, the other one
beside the per-op kernels of the quarantined half), and each prefill
layer's MLP one ``mlp_subblock``. On the card each
program's cached entry replays one CUDA graph (``whole_program_jit``,
``executors/cudagraphex.py``); on the CPU the runner compiles with the
``interpret`` option, so the claims run their routers' plain versions, as
the reference's Pallas claims run in interpret mode there.
"""

from __future__ import annotations

import torch.nn.functional as F

from thunder_tpu_torch.models.llama import _mlp, _project_qkv, _rope_cos_sin, _rope_tables
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.serving.sampling import sample_tokens


def _write_rows(pool, rows, flat_positions):
    """Every slot's K/V row into the page pool ``pool`` (KV, P, ps, hd):
    ``rows`` (S, KV, 1, hd) at ``flat_positions`` (S,) of ``page * ps +
    offset``, in ONE replace-semantics scatter (``tnn.decode_row_write``,
    whose composite the ``nn.attn_subblock`` decomposition shares, so the
    planner's chain matcher sees the sequence this emits). Idle and replay
    slots all target the scratch position 0. Returns the pool."""
    tnn.decode_row_write(pool, rows, flat_positions)
    return pool


def _write_pages_ops(pool, rows, page_positions, ps: int):
    """:func:`_write_pages` in the port's ops (the reference's
    ``_write_pages``, runner.py:85): one ``dynamic_update_slice`` a page at
    its traced flat position."""
    from thunder_tpu_torch import ops
    from thunder_tpu_torch.core import prims

    KV, P, _, hd = pool.shape
    flat = ops.reshape(pool, (KV, P * ps, hd))
    for i in range(rows.shape[1] // ps):
        pos = ops.getitem(page_positions, i)
        flat = prims.dynamic_update_slice(flat, ops.narrow(rows, 1, i * ps, ps), (0, pos, 0))
    return ops.reshape(flat, tuple(pool.shape))


def _write_pages(pool, rows, page_positions, ps: int):
    """A prefill chunk's K/V ``rows`` (KV, C, hd), C a multiple of ``ps``,
    into its pages at ``page_positions`` (C // ps,) flat positions (``page *
    ps``; chunks start page-aligned). Returns the updated pool."""
    from thunder_tpu_torch.torch import on_torch

    return on_torch(_write_pages_ops)(pool, rows, page_positions, ps)


class PagedLlamaRunner:
    """Builds and owns the compiled paged step functions of one engine.
    ``block_fusion`` is the planner's option (None: the cost model picks the
    rung); ``whole_program_jit`` the replay's; ``device`` where the engine's
    tensors live."""

    def __init__(self, cfg, geometry, *, block_fusion=None, device=None,
                 whole_program_jit: bool = True):
        import thunder_tpu_torch as ptt

        self.cfg = cfg
        self.geom = geometry
        self.block_fusion = block_fusion
        opts = {"whole_program_jit": whole_program_jit}
        if block_fusion is not None:
            opts["block_fusion"] = block_fusion
        if device is not None and device.type == "cpu":
            opts["interpret"] = True
        self.decode_jit = ptt.jit(self._decode_fn, device=device, fn_name="serving_decode",
                                  donate_argnums=(5,), **opts)
        self.prefill_jit = ptt.jit(self._prefill_fn, device=device, fn_name="serving_prefill",
                                   donate_argnums=(5,), **opts)
        self._decode_bound = None

    # -- traced bodies --------------------------------------------------------
    def _attn_block(self, h, layer, q, block_tables, lengths, kv):
        """The attention tail of a layer whose K/V rows are already in the
        pools: paged attention, the out-projection onto the residual, and
        the SwiGLU MLP sub-block with its residual add."""
        cfg = self.cfg
        B, T = h.shape[0], h.shape[1]
        attn = tnn.paged_decode_attention(q, kv["k"], kv["v"], block_tables, lengths)
        attn = attn.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)
        h = h + F.linear(attn, layer["wo"])
        return h + _mlp(tnn.rms_norm(h, layer["mlp_norm"], eps=cfg.norm_eps), layer)

    def _decode_fn(self, params, tokens, block_tables, lengths, write_pos, pools, temps,
                   top_ks, top_ps, rng):
        """One continuous-batching decode step for every slot.

        tokens (S, 1) int64; block_tables (S, npg) int32; lengths (S,) int32
        context length INCLUDING this token; write_pos (S,) int64 flat pool
        position of this token's K/V row (the scratch position 0 for replay
        and idle rows). Sampling inputs: temps (S,) float32, top_ks (S,)
        int64, top_ps (S,) float32, rng (S, 2) int64 ``[seed, counter]``
        rows. Returns ``(tokens (S,), logits (S, V), pools)``."""
        cfg = self.cfg
        S = tokens.shape[0]
        h = F.embedding(tokens, params["tok_embedding"])              # (S,1,D)
        cos, sin = _rope_tables(cfg, lengths - 1, h.dtype)            # (S, hd/2)
        cos, sin = cos.reshape(S, 1, 1, -1), sin.reshape(S, 1, 1, -1)
        new_pools = []
        for layer, kv in zip(params["layers"], pools):
            x = tnn.rms_norm(h, layer["attn_norm"], eps=cfg.norm_eps)
            q, k, v = _project_qkv(x, layer, cfg, cos, sin)
            kv = {"k": _write_rows(kv["k"], k, write_pos),
                  "v": _write_rows(kv["v"], v, write_pos)}
            new_pools.append(kv)
            h = self._attn_block(h, layer, q, block_tables, lengths, kv)
        h = tnn.rms_norm(h, params["norm_f"], eps=cfg.norm_eps)
        logits = F.linear(h, params["lm_head"]).squeeze(1)           # (S, V)
        return sample_tokens(logits, temps, top_ks, top_ps, rng), logits, new_pools

    def _prefill_fn(self, params, tokens, block_tables, lengths, page_writes, pools):
        """One prefill chunk of one request: K/V writes only, no logits.

        tokens (1, C) int64 (C from the chunk ladder, a multiple of the page
        size, padded past the prompt tail); block_tables (1, npg) int32;
        lengths (1,) int32 = chunk start + C; page_writes (C // ps,) int64
        flat positions of the chunk's pages. Returns the pools."""
        cfg = self.cfg
        C = tokens.shape[1]
        h = F.embedding(tokens, params["tok_embedding"])              # (1,C,D)
        cos, sin = _rope_cos_sin(cfg, C, h.dtype, pos_offset=lengths[0] - C, device=h.device)
        ps = self.geom.page_size
        new_pools = []
        for layer, kv in zip(params["layers"], pools):
            x = tnn.rms_norm(h, layer["attn_norm"], eps=cfg.norm_eps)
            q, k, v = _project_qkv(x, layer, cfg, cos, sin)
            kv = {"k": _write_pages(kv["k"], k.squeeze(0), page_writes, ps),
                  "v": _write_pages(kv["v"], v.squeeze(0), page_writes, ps)}
            new_pools.append(kv)
            h = self._attn_block(h, layer, q, block_tables, lengths, kv)
        return new_pools

    # -- dispatch -------------------------------------------------------------
    def bind_decode(self, *args) -> int:
        """Compile the decode step for these inputs and bind it (no guard
        key a step). The engine re-binds when the quarantine epoch moves: the
        new compile's planner takes the rung the quarantine leaves. Returns
        how many whole-layer kernels one step runs (the
        ``serving.decode_layer_fusions`` gauge)."""
        self._decode_bound = self.decode_jit.bind(*args, contained=False)
        return self.decode_fusion_shape()[1]

    def decode_fusion_shape(self) -> tuple[int, int]:
        """``(kernel launches, decode_layer launches)`` of one step of the
        bound decode program, read from its execution trace's claims (the
        gauges ``serving.decode_pallas_launches`` and
        ``serving.decode_layer_fusions``)."""
        from thunder_tpu_torch.executors.cudaex_claims import kernel_of

        entry = getattr(self._decode_bound, "entry", None)
        if entry is None:
            return 0, 0
        kernels = [kernel_of(b.sym) for b in entry.traces[-1].bound_symbols]
        kernels = [k for k in kernels if k is not None]
        return len(kernels), kernels.count("decode_layer")

    @staticmethod
    def _adopt(pools, new_pools) -> None:
        """Keep the engine's pool tensors where the program wrote them in
        place; take the program's where it did not."""
        for kv, new in zip(pools, new_pools):
            for name in ("k", "v"):
                if new[name].data_ptr() != kv[name].data_ptr():
                    kv[name] = new[name]

    def decode(self, params, tokens, block_tables, lengths, write_pos, pools, temps, top_ks,
               top_ps, rng):
        """One decode step through the bound program (bound here first if
        the engine has not); returns ``(tokens (S,), logits (S, V))``."""
        args = (params, tokens, block_tables, lengths, write_pos, pools, temps, top_ks, top_ps,
                rng)
        if self._decode_bound is None:
            self.bind_decode(*args)
        toks, logits, new_pools = self._decode_bound(*args)
        self._adopt(pools, new_pools)
        return toks, logits

    def prefill(self, params, tokens, block_tables, lengths, page_writes, pools) -> None:
        """One prefill chunk (its entry looked up by the chunk's shape)."""
        args = (params, tokens, block_tables, lengths, page_writes, pools)
        self._adopt(pools, self.prefill_jit.bind(*args, contained=False)(*args))
