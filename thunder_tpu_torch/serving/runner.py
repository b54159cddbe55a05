"""Paged model runner: the prefill and decode steps the serving engine
dispatches; the counterpart of ``thunder_tpu/serving/runner.py``.

The reference traces and compiles ``_decode_fn`` (:175) and ``_prefill_fn``
(:224); PyTorch runs eagerly, so here they are plain methods that follow
those functions op for op, at one of the reference's two rungs.

The per-op rung (``block_fusion=False``, the reference's engine with
``block_fusion=False`` after its epilogue fusion pass):

- layer 0's ``attn_norm`` is ``rms_norm``; every later norm is
  ``rms_norm_residual`` with the residual add folded in (the post-attention
  ``mlp_norm`` of every layer, the next layer's ``attn_norm``, ``norm_f``);
- the gate projection and its silu are one ``linear_act``;
- T == 1 decode attention is the paged-decode kernel; prefill chunks take
  the plain gather/mask/softmax decomposition;
- the other projections and ``lm_head`` are ``F.linear``, as the reference
  leaves them to XLA.

The planned rung (``block_fusion=True``, what the reference's engine binds
after ``block_fusion_pass`` plans and chains the decode sub-blocks):

- decode: each layer is ONE ``decode_layer`` (norm, QKV, rope, this step's
  K/V rows, paged attention, the out-projection onto the residual, the MLP
  sub-block), then ``rms_norm(norm_f)``;
- prefill: each layer's ``attn_norm`` is ``rms_norm``; QKV, the page writes
  and the plain chunk attention as at the per-op rung; then ONE
  ``mlp_subblock(h, linear(attn, wo), ...)`` takes the residual add,
  ``mlp_norm``, the MLP and the second residual add.

- ``decode``: ONE batched step over every slot — ``(S, 1)`` tokens, each
  slot's K/V row written into the pools, ragged paged attention, and
  sampling as the epilogue. Returns sampled token ids (and the logits).
- ``prefill``: one chunk of one request's prompt — ``(1, C)`` tokens with C
  a multiple of the page size, written page by page, attending the paged
  context so far. It emits no logits: the first token comes from a decode
  replay step. The last layer's attention output and MLP feed nothing and
  are skipped (the reference's compiler removes them as dead code).

The pools are updated in place.
"""

from __future__ import annotations

import torch.nn.functional as F

from thunder_tpu_torch.models.llama import _mlp, _project_qkv, _rope_cos_sin, _rope_tables
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.runtime import quarantine as _quarantine
from thunder_tpu_torch.serving.sampling import sample_tokens


class PagedLlamaRunner:
    """The eager paged step functions for one engine, at the per-op rung or,
    with ``block_fusion=True``, the planned rung. ``decode_layer`` is the
    planned decode step's layer function (``tnn.decode_layer``, one launch
    per layer); any function of its signature may stand in, such as
    ``tnn.decode_layer_subblocks``, the sub-block rung, which
    :meth:`bind_decode` binds while the quarantine routes the whole-layer
    kernel off. None runs the decode step at the per-op rung, which
    :meth:`bind_decode` binds while a sub-block kernel is routed off too;
    a planned prefill chunk takes the per-op rung while ``mlp_subblock`` is
    routed off."""

    decode_layer = staticmethod(tnn.decode_layer)

    def __init__(self, cfg, geometry, block_fusion: bool = False):
        self.cfg = cfg
        self.geom = geometry
        self.block_fusion = bool(block_fusion)

    def bind_decode(self) -> int:
        """Bind the planned decode step's layer function to the quarantine's
        current rung — ``tnn.decode_layer``; while ``cuda.decode_layer`` is
        routed off, ``tnn.decode_layer_subblocks`` (the reference's re-bound
        decode program, ``thunder_tpu/serving/runner.py:260``); while a
        sub-block is routed off too, None: the per-op rung's kernels
        (:meth:`_layers`) — and return how many whole-layer kernels one
        decode step runs (the ``serving.decode_layer_fusions`` gauge)."""
        if not self.block_fusion:
            return 0
        off = _quarantine.is_routed_off
        if not off("cuda.decode_layer"):
            self.decode_layer = tnn.decode_layer
            return self.geom.n_layers
        if off("cuda.attn_subblock") or off("cuda.mlp_subblock"):
            self.decode_layer = None
        else:
            self.decode_layer = tnn.decode_layer_subblocks
        return 0

    def _layers(self, params, h, cos, sin, pools, write_kv, block_tables, lengths,
                final_norm: bool):
        """The decoder stack over hidden states ``h`` (B, T, D). ``write_kv``
        stores a layer's fresh k/v rows into its pools. Returns the final
        normed hidden state, or None when ``final_norm`` is False."""
        cfg = self.cfg
        layers = params["layers"]
        B, T = h.shape[0], h.shape[1]
        x = tnn.rms_norm(h, layers[0]["attn_norm"], eps=cfg.norm_eps)
        for i, (layer, kv) in enumerate(zip(layers, pools)):
            q, k, v = _project_qkv(x, layer, cfg, cos, sin)
            write_kv(kv, k, v)
            if not final_norm and i == len(layers) - 1:
                return None
            attn = tnn.paged_decode_attention(q.contiguous(), kv["k"], kv["v"],
                                              block_tables, lengths)
            attn = attn.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)
            h, x = tnn.rms_norm_residual(h, F.linear(attn, layer["wo"]),
                                         layer["mlp_norm"], eps=cfg.norm_eps)
            nxt = layers[i + 1]["attn_norm"] if i + 1 < len(layers) else params["norm_f"]
            h, x = tnn.rms_norm_residual(h, _mlp(x, layer), nxt, eps=cfg.norm_eps)
        return x

    def _planned_prefill_layers(self, params, h, cos, sin, pools, write_kv, block_tables,
                                lengths) -> None:
        """The decoder stack of a prefill chunk at the planned rung; the last
        layer stops after its K/V writes."""
        cfg = self.cfg
        layers = params["layers"]
        B, T = h.shape[0], h.shape[1]
        for i, (layer, kv) in enumerate(zip(layers, pools)):
            x = tnn.rms_norm(h, layer["attn_norm"], eps=cfg.norm_eps)
            q, k, v = _project_qkv(x, layer, cfg, cos, sin)
            write_kv(kv, k, v)
            if i == len(layers) - 1:
                return
            attn = tnn.paged_decode_attention(q.contiguous(), kv["k"], kv["v"],
                                              block_tables, lengths)
            attn = attn.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)
            h = tnn.mlp_subblock(h, F.linear(attn, layer["wo"]), layer["mlp_norm"],
                                 layer["w_gate"], layer["w_up"], layer["w_down"], act="silu",
                                 eps=cfg.norm_eps)

    def decode(self, params, tokens, block_tables, lengths, write_pos, pools,
               temps, top_ks, top_ps, rng):
        """One continuous-batching decode step for every slot.

        tokens (S, 1); block_tables (S, npg) int32; lengths (S,) int32
        context length INCLUDING this token; write_pos (S,) flat pool
        position of this token's K/V row (the scratch position 0 for replay
        and idle rows). Sampling inputs: temps (S,) float32, top_ks (S,),
        top_ps (S,) float32, rng (S, 2) int64. Returns ``(tokens (S,),
        logits (S, V))``."""
        cfg = self.cfg
        h = params["tok_embedding"][tokens]                             # (S,1,D)
        cos, sin = _rope_tables(cfg, lengths - 1, h.dtype)              # (S, hd/2)
        S = tokens.shape[0]
        cos = cos.reshape(S, 1, 1, -1)
        sin = sin.reshape(S, 1, 1, -1)

        if self.block_fusion and self.decode_layer is not None:
            for layer, kv in zip(params["layers"], pools):
                h = self.decode_layer(h, layer["attn_norm"], layer["wq"], layer["wk"],
                                      layer["wv"], layer["wo"], cos, sin, kv["k"], kv["v"],
                                      block_tables, lengths, write_pos, layer["mlp_norm"],
                                      layer["w_gate"], layer["w_up"], layer["w_down"],
                                      act="silu", eps=cfg.norm_eps)
            x = tnn.rms_norm(h, params["norm_f"], eps=cfg.norm_eps)
        else:
            def write_kv(kv, k, v):
                tnn.decode_row_write(kv["k"], k, write_pos)
                tnn.decode_row_write(kv["v"], v, write_pos)

            x = self._layers(params, h, cos, sin, pools, write_kv, block_tables, lengths,
                             final_norm=True)
        logits = F.linear(x, params["lm_head"]).squeeze(1)               # (S,V)
        return sample_tokens(logits, temps, top_ks, top_ps, rng), logits

    def prefill(self, params, tokens, block_tables, lengths, page_ids, pools) -> None:
        """One prefill chunk of one request — K/V writes only.

        tokens (1, C) (C a multiple of the page size, padded past the prompt
        tail); block_tables (1, npg) int32; lengths (1,) int32 = chunk start
        + C; page_ids (C // ps,) the pages the chunk fills, in order."""
        cfg = self.cfg
        C = tokens.shape[1]
        h = params["tok_embedding"][tokens]                             # (1,C,D)
        pos0 = int(lengths[0]) - C
        cos, sin = _rope_cos_sin(cfg, C, h.dtype, pos_offset=pos0, device=h.device)
        ps = self.geom.page_size

        def write_kv(kv, k, v):
            for pool, rows in ((kv["k"], k), (kv["v"], v)):
                KV, hd = rows.shape[1], rows.shape[3]
                pool.index_copy_(1, page_ids, rows[0].reshape(KV, C // ps, ps, hd))

        if self.block_fusion and not _quarantine.is_routed_off("cuda.mlp_subblock"):
            self._planned_prefill_layers(params, h, cos, sin, pools, write_kv, block_tables,
                                         lengths)
        else:
            self._layers(params, h, cos, sin, pools, write_kv, block_tables, lengths,
                         final_norm=False)
