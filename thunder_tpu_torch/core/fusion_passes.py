"""The trace compiler's fusion passes: trace-to-trace rewrites into claimable
composites, run at the top of ``transform_for_execution`` before the claim
pass (block, horizontal, epilogue, optimizer), and the block planner's entry
before autodiff.

The counterpart of ``thunder_tpu/core/fusion_passes.py``:

- **block fusion** (``block_fusion_pass`` :641, its MLP stage
  ``_mlp_block_pass`` :710, and ``plan_blocks_for_autodiff`` :1429): a
  transformer MLP sub-block chain ``add(residual, x) -> nn.rms_norm ->
  {nn.linear -> act, nn.linear} -> mul -> nn.linear -> add`` becomes one
  ``nn.mlp_subblock``, which the ``cuda`` executor hands to the
  ``mlp_subblock`` kernel and whose VJP rule emits ``nn.mlp_subblock_bwd``.
  The ``block_fusion`` option forces (True), disables (False) or leaves the
  verdict to ``core.cost_model.subblock_cost`` (unset: forward only for a
  grad-free trace, forward and backward before autodiff). The kernel's own
  refusal (``cudaex.refusal`` on meta tensors) takes the place of the
  reference's VMEM gate: a chain the kernel would not take is recorded
  ``unclaimed`` with the refusal's text. A chain whose claim the quarantine
  routes off is not planned, so a recompile takes the per-op rung: the port
  runs no decomposition on the card in a kernel's place. On a serving
  decode trace two more stages run around it: ``_attn_block_pass`` (:1112)
  makes each T == 1 attention chain (``nn.rms_norm`` -> q/k/v projections
  -> rope -> the K/V page writes -> ``nn.paged_decode_attention`` -> the
  out-projection) one ``nn.attn_subblock``, and ``_decode_chain_pass``
  (:1309) chains it with its layer's planned ``nn.mlp_subblock`` into one
  ``nn.decode_layer``, under the decode half of the cost model
  (``attn_subblock_cost``, ``subblock_cost(decode=True)``,
  ``decode_layer_cost``);
- **horizontal fusion** (``horizontal_fusion_pass`` :191): sibling GEMMs
  (``dot_general`` prims, or single-product ``nn.linear``) over one shared
  operand merge into one GEMM over the concatenated other operands, then
  slices (the ``horizontal_fusion`` option, else
  ``cost_model.horizontal_merge_profitable``);
- **epilogue fusion** (``epilogue_fusion_pass`` :1447): ``add(residual, x)``
  then ``nn.rms_norm`` of the sum becomes ``nn.rms_norm_residual``;
  ``nn.linear`` then relu, silu or gelu becomes ``nn.linear_act``; only
  where an executor claims the fused composite;
- **optimizer fusion** (``optimizer_fusion_pass`` :471): the traced AdamW's
  per-parameter ``optim.adamw_step`` chains are bucketed by dtype into
  ``optim.fused_adamw`` calls, one kernel launch a bucket (the
  ``fused_optimizer`` option, else ``cost_model.fused_adamw_profitable``).

Every verdict goes to the decision log (``observe/decisions.py``) with the
cost model's numbers.
"""

from __future__ import annotations

from thunder_tpu_torch.core import cost_model
from thunder_tpu_torch.core.compile_data import get_compile_option
from thunder_tpu_torch.core.patterns import Pattern, rewrite
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx
from thunder_tpu_torch.observe import decisions as _decisions
from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.runtime import quarantine as _quarantine

HORIZONTAL_MARKER = "horizontal fusion"
EPILOGUE_MARKER = "epilogue fusion"
OPTIMIZER_MARKER = "optimizer fusion"
BLOCK_MARKER = "block fusion"

# Every verdict the block planner can record, with its meaning (the
# reference's names; its "vmem-infeasible" has no counterpart: the kernel's
# refusal is recorded as "unclaimed"; "dist-annotated" and
# "mesh-rung-capped" come with the distributed proxies and the serving mesh
# (ROADMAP A.2, A.3)).
BLOCK_DECISION_KINDS = {
    "planned": "chain rewritten into one claimed nn.mlp_subblock kernel (or, on a decode "
               "trace, nn.attn_subblock)",
    "chained": "a planned nn.attn_subblock and its layer's nn.mlp_subblock fused into one "
               "nn.decode_layer launch",
    "chain-blocked": "no adjoining nn.mlp_subblock over the same residual stream, different "
                     "eps, or an updated pool read before the MLP",
    "interior-escapes": "an interior value of the chain is consumed outside "
                        "it (or is a trace output); fusing would hide a "
                        "value someone still reads",
    "cost-rejected": "the estimated per-op chain beats the kernel (the "
                     "saved interior bytes lose to the launch and the "
                     "kernel's fitted rate; before autodiff, with both "
                     "backwards counted)",
    "unclaimed": "no executor claims the fused composite (checker refused, "
                 "the kernel refuses the shapes, or the claim is "
                 "quarantined)",
    "rebuild-mismatch": "the composite retrace produced different output "
                        "metadata than the original chain (kept unfused)",
}


def _rebuild_trace(trc: TraceCtx, replacements: dict, dropped: set, provenance: str) -> TraceCtx:
    new = from_trace(trc)
    out: list[BoundSymbol] = []
    for i, b in enumerate(trc.bound_symbols):
        if i in replacements:
            out.extend(replacements[i])
        elif i not in dropped:
            out.append(b)
    new.bound_symbols = out
    new.set_provenance(provenance)
    return new


# ---------------------------------------------------------------------------
# horizontal GEMM merging
# ---------------------------------------------------------------------------

def _dot_general_facts(bsym: BoundSymbol):
    """(a, b, contract_dims, preferred_element_type) of a mergeable GEMM:
    the ``dot_general`` prim (training traces, whose linears autodiff
    replayed as prims) or a bias-free ``nn.linear`` whose decomposition is
    that one prim (grad-free traces); else None."""
    if bsym.sym.id == "nn.linear":
        if len(bsym.subsymbols) != 1:
            return None
        bsym = bsym.subsymbols[0]
    if bsym.sym.id is not PrimIDs.DOT_GENERAL or len(bsym.args) < 2:
        return None
    a, b = bsym.args[0], bsym.args[1]
    if not (isinstance(a, TensorProxy) and isinstance(b, TensorProxy)):
        return None
    contract = bsym.kwargs.get("contract_dims")
    if contract is None and len(bsym.args) > 2:
        contract = bsym.args[2]
    batch = bsym.kwargs.get("batch_dims", ((), ()))
    if contract is None or tuple(batch[0]) or tuple(batch[1]):
        return None
    pet = bsym.kwargs.get("preferred_element_type")
    return a, b, (tuple(contract[0]), tuple(contract[1])), pet


def _single_free_dim(t: TensorProxy, contracted: tuple[int, ...]) -> int | None:
    free = [d for d in range(t.ndim) if d not in contracted]
    return free[0] if len(free) == 1 else None


def _merge_group(trc: TraceCtx, members: list, shared_pos: int,
                 free_dim: int) -> list[BoundSymbol]:
    """One sibling group's replacement: the varying operands concatenated
    along their free dim, one ``dot_general``, and slices that bind the
    members' own output proxies (their consumers are untouched)."""
    from thunder_tpu_torch import ops
    from thunder_tpu_torch.core import prims

    varying_pos = 1 - shared_pos
    _, _, facts0 = members[0]
    shared = facts0[shared_pos]
    contract, pet = facts0[2], facts0[3]
    varying = [f[varying_pos] for _, _, f in members]
    widths = [int(v.shape[free_dim]) for v in varying]

    tmp = TraceCtx("horizontal_fusion")
    tmp._names = trc._names   # one name registry: no collisions
    tmp._counters = trc._counters
    with tracectx(tmp):
        w_cat = ops.cat(list(varying), free_dim)
        operands = (shared, w_cat) if shared_pos == 0 else (w_cat, shared)
        kwargs = dict(contract_dims=contract)
        if pet is not None:
            kwargs["preferred_element_type"] = pet
        merged = prims.dot_general(*operands, **kwargs)
        # the merged output is [a's free dims..., b's free dim]: the varying
        # free dim is last when operand 1 varies, first when operand 0 does
        slice_axis = merged.ndim - 1 if varying_pos == 1 else 0
        offset = 0
        parts = []
        for w in widths:
            parts.append(ops.narrow(merged, slice_axis, offset, w))
            offset += w
    swap = {}
    for (_, m, _f), part in zip(members, parts):
        old = m.flat_proxy_outs()[0]
        if isinstance(part, Proxy) and part.name != old.name:
            swap[Variable(part)] = old
    out = [b.from_bsym_swap_proxies(swap) for b in tmp.bound_symbols]
    for b in out:
        if b.sym.id is PrimIDs.DOT_GENERAL:
            b.header = (f"{HORIZONTAL_MARKER}: merged {len(members)} sibling "
                        f"dot_generals (widths {'+'.join(map(str, widths))})")
    return out


def horizontal_fusion_pass(trc: TraceCtx) -> TraceCtx:
    """Merge sibling GEMMs over a shared operand (the q/k/v pattern)."""
    enabled = get_compile_option(
        "horizontal_fusion",
        "merge sibling dot_generals sharing an operand (q/k/v, the MLP's gate and up) into "
        "one GEMM over the concatenated operands: True = always, False = never, unset = "
        "cost-model decision", None)
    if enabled is False:
        return trc
    bsyms = trc.bound_symbols

    defined_at: dict[str, int] = {}
    for p in trc.args:
        if isinstance(p, Proxy):
            defined_at[p.name] = -1
    for i, b in enumerate(bsyms):
        for o in b.flat_proxy_outs():
            defined_at.setdefault(o.name, i)

    # candidate groups: the same shared operand at the same position, the
    # same contraction, varying operands with one free dim and one dtype
    groups: dict[tuple, list] = {}
    for i, b in enumerate(bsyms):
        facts = _dot_general_facts(b)
        if facts is None:
            continue
        contract, pet = facts[2], facts[3]
        outs = b.flat_proxy_outs()
        if len(outs) != 1:
            continue
        for shared_pos in (0, 1):
            shared = facts[shared_pos]
            varying = facts[1 - shared_pos]
            free_dim = _single_free_dim(varying, contract[1 - shared_pos])
            if free_dim is None:
                continue
            key = (shared.name, shared_pos, contract, str(pet), varying.dtype.name,
                   varying.ndim, free_dim, outs[0].dtype.name)
            groups.setdefault(key, []).append((i, b, facts))

    merged_ids: set[int] = set()
    replacements: dict[int, list[BoundSymbol]] = {}   # first member's index -> bsyms
    dropped: set[int] = set()
    n_merged = 0
    for key, members in groups.items():
        shared_pos, free_dim = key[1], key[6]
        varying_pos = 1 - shared_pos
        members = [m for m in members if id(m[1]) not in merged_ids]
        if len(members) < 2:
            continue
        members.sort(key=lambda t: t[0])
        first_idx = members[0][0]
        # the merged op lands at the first member: every varying operand must
        # be defined before it
        members = [m for m in members
                   if defined_at.get(m[2][varying_pos].name, m[0]) < first_idx]
        if len(members) < 2:
            continue
        shared = members[0][2][shared_pos]
        sc = key[2][shared_pos]
        m_tokens = 1
        for d in range(shared.ndim):
            if d not in sc:
                m_tokens *= int(shared.shape[d])
        widths = [int(m[2][varying_pos].shape[free_dim]) for m in members]
        group_cost = {"siblings": len(members), "m_tokens": m_tokens, "widths": widths,
                      "shared": shared.name, "saved_reads": m_tokens * (len(members) - 1),
                      "concat_write": sum(widths)}
        if enabled is not True and not cost_model.horizontal_merge_profitable(m_tokens, widths):
            _decisions.record("fusion", "horizontal_merge", None, "rejected",
                              "cost model: concat write outweighs saved shared-operand "
                              "reads (need m_tokens*(k-1) > sum(widths))", cost=group_cost)
            continue
        _decisions.record("fusion", "horizontal_merge", None, "merged",
                          "forced by horizontal_fusion=True" if enabled is True
                          else "cost model: saved reads beat the concat write",
                          cost=group_cost)
        _observe.inc("fusion.horizontal_merges")
        replacements[first_idx] = _merge_group(trc, members, shared_pos, free_dim)
        dropped.update(m[0] for m in members[1:])
        merged_ids.update(id(m[1]) for m in members)
        n_merged += 1

    if not replacements:
        return trc
    return _rebuild_trace(trc, replacements, dropped,
                          f"Horizontal fusion ({n_merged} sibling GEMM groups merged)")


# ---------------------------------------------------------------------------
# claim probes and composite rebuilds
# ---------------------------------------------------------------------------

def _claim_refusal(executors, op_id: str, args, kwargs, *,
                   kernel: bool = False) -> str | None:
    """Why no executor would claim the fused composite (None where one
    would). Each executor's checker is asked. With
    ``kernel`` (the block planner) a claim the quarantine routes off is the
    answer (no executor below it takes the kernel's place), and so is a
    kernel's refusal of the arguments: the claim pass would raise it."""
    reasons = []
    for ex in executors:
        impl = ex.implmap.get(op_id)
        if impl is None or impl.symbol is None:
            continue
        try:
            if impl.checker is not None and not impl.checker(*args, **kwargs):
                continue
            if kernel and _quarantine.is_routed_off(impl.symbol.id):
                return (f"{impl.symbol.id} is quarantined: "
                        f"{_quarantine.quarantine_reason(impl.symbol.id)}")
            if kernel and impl.refusal is not None:
                refused = impl.refusal(*args, **kwargs)
                if refused is not None:
                    reasons.append(refused)
                    continue
            return None
        except Exception:
            continue
    return "; ".join(reasons) or "no executor claims the fused composite (checker refused)"


def _some_executor_claims(executors, op_id: str, args, kwargs) -> bool:
    """Would an executor in the stack claim the fused composite?"""
    return _claim_refusal(executors, op_id, args, kwargs) is None


def _build_composite(trc: TraceCtx, op, args, kwargs, old_outs) -> list[BoundSymbol] | None:
    """Trace ``op(*args, **kwargs)`` into fresh bsyms and rebind its outputs
    to ``old_outs`` (the proxies downstream consumers already reference);
    None where the retrace's output metadata differs from the chain's."""
    tmp = TraceCtx("fusion")
    tmp._names = trc._names
    tmp._counters = trc._counters
    with tracectx(tmp):
        out = op(*args, **kwargs)
    new_flat = [o for o in tree_flatten(out)[0] if isinstance(o, Proxy)]
    if len(new_flat) != len(old_outs):
        return None
    for n, o in zip(new_flat, old_outs):
        if (getattr(n, "dtype", None) != getattr(o, "dtype", None)
                or tuple(getattr(n, "shape", ())) != tuple(getattr(o, "shape", ()))):
            return None
    swap = {Variable(n): o for n, o in zip(new_flat, old_outs) if n.name != o.name}
    return [b.from_bsym_swap_proxies(swap) for b in tmp.bound_symbols]


# ---------------------------------------------------------------------------
# epilogue fusion
# ---------------------------------------------------------------------------

def _rms_residual_pattern(executors):
    def is_residual_add(b, env):
        # a prim in training traces (autodiff's replay), a composite in grad-free ones
        if b.sym.id not in (PrimIDs.ADD, "ops.add") or len(b.args) != 2:
            return False
        r, x = b.args
        if not (isinstance(r, TensorProxy) and isinstance(x, TensorProxy)):
            return False
        if tuple(r.shape) != tuple(x.shape) or r.dtype != x.dtype:
            return False
        env["add_out"] = b.flat_proxy_outs()[0]
        return True

    def is_trailing_rms(b, env):
        if b.sym.id != "nn.rms_norm":
            return False
        a = b.args[0] if b.args else None
        if not isinstance(a, Proxy) or a.name != env["add_out"].name:
            return False
        dim = b.kwargs.get("dim", b.args[3] if len(b.args) > 3 else -1)
        return dim in (-1, a.ndim - 1)

    p = Pattern("rms_norm_residual").step(is_residual_add).step(is_trailing_rms)

    def build(trc, matched, env):
        from thunder_tpu_torch.ops import composites

        add_b, rms_b = matched
        res, x = add_b.args
        h = add_b.flat_proxy_outs()[0]
        normed = rms_b.flat_proxy_outs()[0]
        weight = rms_b.args[1] if len(rms_b.args) > 1 else rms_b.kwargs.get("weight")
        eps = rms_b.kwargs.get("eps", rms_b.args[2] if len(rms_b.args) > 2 else 1e-5)
        cost = {"pattern": "add+rms_norm",
                "bytes_saved_roundtrip": cost_model.tensor_bytes(h) * 2}
        if not _some_executor_claims(executors, "nn.rms_norm_residual", (res, x, weight),
                                     {"eps": eps}):
            _decisions.record("fusion", "nn.rms_norm_residual", None, "rejected",
                              "no executor claims the fused composite "
                              "(checker refused)", cost=cost)
            return None
        repl = _build_composite(trc, composites.rms_norm_residual, (res, x, weight),
                                {"eps": eps}, [h, normed])
        if repl:
            repl[-1].header = f"{EPILOGUE_MARKER}: residual add absorbed into rms_norm"
            _decisions.record("fusion", "nn.rms_norm_residual", None, "rewritten",
                              "residual add absorbed into rms_norm", cost=cost)
            _observe.inc("fusion.epilogue_fusions")
        return repl

    return p, build


_ACT_IDS = {"ops.relu": "relu", "ops.silu": "silu", "ops.gelu": "gelu"}


def _chain_act(b: BoundSymbol) -> str | None:
    """The activation a bound symbol applies (gelu's tanh form named
    ``gelu_tanh``), or None."""
    act = _ACT_IDS.get(b.sym.id)
    if act == "gelu":
        approx = b.kwargs.get("approximate", b.args[1] if len(b.args) > 1 else "none")
        act = "gelu_tanh" if approx == "tanh" else "gelu"
    return act


def _linear_act_pattern(executors):
    def is_linear(b, env):
        if b.sym.id != "nn.linear":
            return False
        env["lin_out"] = b.flat_proxy_outs()[0]
        return True

    def is_act(b, env):
        act = _chain_act(b)
        if act is None:
            return False
        a = b.args[0] if b.args else None
        if not isinstance(a, Proxy) or a.name != env["lin_out"].name:
            return False
        env["act"] = act
        return True

    p = Pattern("linear_act").step(is_linear).step(is_act)

    def build(trc, matched, env):
        from thunder_tpu_torch.ops import composites

        lin_b, act_b = matched
        a, w = lin_b.args[0], lin_b.args[1]
        bias = lin_b.args[2] if len(lin_b.args) > 2 else lin_b.kwargs.get("bias")
        out = act_b.flat_proxy_outs()[0]
        act = env["act"]
        cost = {"pattern": f"linear+{act}",
                "bytes_saved_roundtrip": cost_model.tensor_bytes(out) * 2}
        if not _some_executor_claims(executors, "nn.linear_act", (a, w, bias), {"act": act}):
            _decisions.record("fusion", "nn.linear_act", None, "rejected",
                              "no executor claims the fused composite "
                              "(checker refused)", cost=cost)
            return None
        repl = _build_composite(trc, composites.linear_act, (a, w, bias), {"act": act}, [out])
        if repl:
            repl[-1].header = f"{EPILOGUE_MARKER}: {act} epilogue fused into linear"
            _decisions.record("fusion", "nn.linear_act", None, "rewritten",
                              f"{act} epilogue fused into linear", cost=cost)
            _observe.inc("fusion.epilogue_fusions")
        return repl

    return p, build


def epilogue_fusion_pass(trc: TraceCtx, executors) -> TraceCtx:
    """Rewrite elementwise-epilogue chains into claimable fused composites."""
    if not get_compile_option(
            "epilogue_fusion",
            "rewrite residual+rms_norm and linear+activation chains into fused composites "
            "(nn.rms_norm_residual / nn.linear_act) where an executor in the stack claims "
            "them", True):
        return trc
    ids = {b.sym.id for b in trc.bound_symbols}
    if "nn.rms_norm" in ids:
        p, build = _rms_residual_pattern(executors)
        trc = rewrite(trc, p, build, allow_escaping_intermediates=True)
    if "nn.linear" in ids and not ids.isdisjoint(_ACT_IDS):
        p, build = _linear_act_pattern(executors)
        trc = rewrite(trc, p, build)
    return trc


# ---------------------------------------------------------------------------
# optimizer fusion: the dtype-bucketed multi-tensor AdamW
# ---------------------------------------------------------------------------

def adamw_bucket_key(b: BoundSymbol) -> tuple:
    """The bucket of an ``optim.adamw_step``: its four tensors' dtypes, the
    shared bias corrections and the hyperparameters."""
    p, g, m, v, bc1, bc2 = b.args
    return (p.dtype.name, g.dtype.name, m.dtype.name, v.dtype.name, bc1.name, bc2.name,
            tuple(sorted((k, str(val)) for k, val in b.kwargs.items())))


def optimizer_fusion_pass(trc: TraceCtx, executors) -> TraceCtx:
    """Bucket the per-parameter ``optim.adamw_step`` chains of the traced
    ``AdamW.update`` by dtype into ``optim.fused_adamw`` calls, one kernel
    launch a bucket. The bucket key is the four tensors' dtypes, the shared
    bias corrections and the hyperparameters. A bucket of one stays its
    chain; a bucket whose member output an interleaved op reads before the
    fused call (placed at the last member) stays unfused; else
    ``cost_model.fused_adamw_profitable`` decides (the ``fused_optimizer``
    option forces or disables), and only where an executor claims the
    fused composite."""
    enabled = get_compile_option(
        "fused_optimizer",
        "bucket per-parameter optimizer update chains (optim.adamw_step) by dtype into "
        "multi-tensor optim.fused_adamw calls, one kernel launch a bucket: True = always, "
        "False = never, unset = cost-model decision", None)
    if enabled is False:
        return trc
    bsyms = trc.bound_symbols
    if not any(b.sym.id == "optim.adamw_step" for b in bsyms):
        return trc
    from thunder_tpu_torch.ops import optim as optim_ops

    buckets: dict[tuple, list[tuple[int, BoundSymbol]]] = {}
    for i, b in enumerate(bsyms):
        if b.sym.id != "optim.adamw_step" or len(b.args) != 6:
            continue
        if not all(isinstance(t, TensorProxy) for t in b.args) or len(b.flat_proxy_outs()) != 3:
            continue
        buckets.setdefault(adamw_bucket_key(b), []).append((i, b))

    replacements: dict[int, list[BoundSymbol]] = {}   # last member's index -> bsyms
    dropped: set[int] = set()
    n_fused = 0
    for key, members in sorted(buckets.items(), key=lambda kv: kv[1][0][0]):
        n = len(members)
        total_bytes = sum(
            cost_model.tensor_bytes(m_[1].args[1])              # g read
            + 2 * (cost_model.tensor_bytes(m_[1].args[0])       # p read and written
                   + cost_model.tensor_bytes(m_[1].args[2])     # m
                   + cost_model.tensor_bytes(m_[1].args[3]))    # v
            for m_ in members)
        cost = dict(cost_model.fused_adamw_cost(n, total_bytes), dtypes=key[:4])
        if n < 2:
            _decisions.record("fusion", "optim.fused_adamw", None, "rejected",
                              "singleton dtype bucket: nothing to amortize", cost=cost)
            continue
        member_idx = {m_[0] for m_ in members}
        out_names = {o.name for _, b in members for o in b.flat_proxy_outs()}
        first, last = members[0][0], members[-1][0]
        interleaved = any(
            j not in member_idx
            and any(p_.name in out_names for p_ in bsyms[j].flat_proxy_args())
            for j in range(first, last + 1))
        if interleaved:
            _decisions.record("fusion", "optim.fused_adamw", None, "rejected",
                              "an interleaved bsym consumes a member's output before the "
                              "bucketed call would produce it", cost=cost)
            continue
        if enabled is not True and not cost_model.fused_adamw_profitable(n, total_bytes):
            _decisions.record("fusion", "optim.fused_adamw", None, "rejected",
                              "cost model: bucketing estimate loses to the per-parameter "
                              "chains", cost=cost)
            continue
        ps, gs, ms, vs = ([m_[1].args[j] for m_ in members] for j in range(4))
        bc1, bc2 = members[0][1].args[4], members[0][1].args[5]
        kwargs = dict(members[0][1].kwargs)
        old_outs = [m_[1].flat_proxy_outs()[k] for k in range(3) for m_ in members]
        if not _some_executor_claims(executors, "optim.fused_adamw", (ps, gs, ms, vs, bc1, bc2),
                                     kwargs):
            _decisions.record("fusion", "optim.fused_adamw", None, "rejected",
                              "no executor claims the fused composite "
                              "(checker refused)", cost=cost)
            continue
        repl = _build_composite(trc, optim_ops.fused_adamw_composite,
                                (ps, gs, ms, vs, bc1, bc2), kwargs, old_outs)
        if not repl:
            _decisions.record("fusion", "optim.fused_adamw", None, "rejected",
                              "rebuild metadata mismatch", cost=cost)
            continue
        repl[-1].header = (f"{OPTIMIZER_MARKER}: {n} adamw_step chains bucketed "
                           f"({key[0]} params, {total_bytes >> 20} MiB moved)")
        _decisions.record("fusion", "optim.fused_adamw", None, "bucketed",
                          "forced by fused_optimizer=True" if enabled is True
                          else "cost model: one launch a bucket beats the per-parameter "
                               "chains", cost=cost)
        _observe.inc("fusion.optimizer_buckets")
        replacements[last] = repl
        dropped.update(m_[0] for m_ in members[:-1])
        n_fused += 1

    if not replacements:
        return trc
    return _rebuild_trace(trc, replacements, dropped,
                          f"Optimizer fusion ({n_fused} multi-tensor buckets)")


# ---------------------------------------------------------------------------
# block fusion: a transformer MLP sub-block chain -> one claimed kernel
# ---------------------------------------------------------------------------

_ADD_IDS = (PrimIDs.ADD, "ops.add")
_SUB_IDS = (PrimIDs.SUB, "ops.sub")
_MUL_IDS = (PrimIDs.MUL, "ops.mul")


def _record_block(decision: str, reason: str, cost: dict | None,
                  op: str = "nn.mlp_subblock") -> None:
    assert decision in BLOCK_DECISION_KINDS, decision
    _decisions.record("block", op, None, decision, reason, cost=cost)


def _plain_linear(b: BoundSymbol):
    """(input, weight) of a bias-free single-product ``nn.linear``, else
    None: a kernel that absorbed a linear with more work would drop it."""
    if b.sym.id != "nn.linear" or len(b.subsymbols) != 1:
        return None
    if b.subsymbols[0].sym.id is not PrimIDs.DOT_GENERAL:
        return None
    a, w = b.args[0], b.args[1]
    if len(b.args) > 2 and b.args[2] is not None:
        return None
    if not (isinstance(a, TensorProxy) and isinstance(w, TensorProxy) and w.ndim == 2):
        return None
    return a, w


def mlp_block_verdict(n_tokens: int, d_model: int, d_ff: int, dtype_bytes: int, *,
                      backward: bool, checkpointed: bool = False, decode: bool = False) -> dict:
    """The planner's cost verdict on one MLP sub-block chain of ``n_tokens``
    rows: ``cost_model.subblock_cost`` (with both backwards where
    ``backward``, the verdict taken before autodiff; as part of a decode
    step where ``decode``) and ``planned``. A chain inside a checkpointed
    region is never planned: the pass sees no chain there. The block pass
    and the entry points (``benchmarks.pretrain.run``,
    ``benchmarks.bench.run``, which pass it to ``jit`` as ``block_fusion``)
    read this one verdict."""
    cost = cost_model.subblock_cost(n_tokens, d_model, d_ff, dtype_bytes, backward=backward,
                                    decode=decode)
    cost["planned"] = not checkpointed and cost_model.subblock_profitable(cost)
    return cost


def block_fusion_pass(trc: TraceCtx, executors, backward: bool = False) -> TraceCtx:
    """The block planner, three staged walks: (1) :func:`_attn_block_pass`,
    the T == 1 decode attention chains into ``nn.attn_subblock``; (2) the
    MLP stage: each chain ``add(residual, x) -> nn.rms_norm -> {nn.linear ->
    act, nn.linear} -> mul -> nn.linear -> add`` becomes one
    ``nn.mlp_subblock`` (scored as part of a decode step,
    ``subblock_cost(decode=True)``, where its residual add absorbs a planned
    attention sub-block's output); (3) :func:`_decode_chain_pass`, the pair
    into one ``nn.decode_layer``. The MLP stage runs at two points: before
    autodiff on the differentiated function's trace
    (:func:`plan_blocks_for_autodiff`, ``backward=True``: the VJP rule then
    commits ``nn.mlp_subblock_bwd``, whose claim the chain also needs), and
    in ``transform_for_execution`` for grad-free traces. ``block_fusion=True``
    forces planning past the cost gate, ``False`` disables the pass, unset
    lets ``cost_model.subblock_cost`` decide. Every verdict is recorded
    with one of :data:`BLOCK_DECISION_KINDS`."""
    enabled = get_compile_option(
        "block_fusion",
        "plan transformer MLP sub-block chains into single claimed kernels "
        "(nn.mlp_subblock, and its backward nn.mlp_subblock_bwd in a training trace): "
        "True = always (skips the cost gate), False = never, unset = cost-model decision",
        None)
    if enabled is False or not executors:
        return trc
    tp_shards = get_compile_option(
        "decode_tp_shards",
        "tensor-parallel shard count of the serving mesh this program is compiled over "
        "(>1 caps block fusion at the attention/MLP sub-block rung)", None)
    if tp_shards is not None and int(tp_shards) > 1:
        raise NotImplementedError("decode_tp_shards > 1: tensor-parallel serving meshes are not "
                                  "ported yet (ROADMAP A.3)")
    trc = _attn_block_pass(trc, executors, enabled)
    trc = _mlp_block_pass(trc, executors, enabled, backward)
    return _decode_chain_pass(trc, executors, enabled)


def _mlp_block_pass(trc: TraceCtx, executors, enabled, backward: bool) -> TraceCtx:
    bsyms = trc.bound_symbols
    # the chain needs a composite rms_norm and composite linears (a trace
    # after autodiff holds the linears as prims, already planned before it)
    ids = {b.sym.id for b in bsyms}
    if "nn.rms_norm" not in ids or "nn.linear" not in ids:
        return trc

    producer: dict[str, int] = {}
    consumers: dict[str, list[int]] = {}
    for i, b in enumerate(bsyms):
        for p in b.flat_proxy_args():
            consumers.setdefault(p.name, []).append(i)
        for o in b.flat_proxy_outs():
            producer.setdefault(o.name, i)
    out_names = {o.name for o in tree_flatten(trc.output)[0] if isinstance(o, Proxy)}

    def single_proxy_out(b):
        outs = b.flat_proxy_outs()
        return outs[0] if len(outs) == 1 else None

    replacements: dict[int, list[BoundSymbol]] = {}   # the final add's index -> bsyms
    dropped: set[int] = set()
    used: set[int] = set()
    n_planned = 0
    for ri, rb in enumerate(bsyms):
        if rb.sym.id != "nn.rms_norm" or ri in used:
            continue
        # -- the chain's structure ----------------------------------------
        h = rb.args[0] if rb.args else None
        if not isinstance(h, TensorProxy) or h.name not in producer:
            continue
        dim = rb.kwargs.get("dim", rb.args[3] if len(rb.args) > 3 else -1)
        if dim not in (-1, h.ndim - 1):
            continue
        w_norm = rb.args[1] if len(rb.args) > 1 else rb.kwargs.get("weight")
        if not isinstance(w_norm, TensorProxy):
            continue
        eps = rb.kwargs.get("eps", rb.args[2] if len(rb.args) > 2 else 1e-5)
        ai = producer[h.name]
        ab = bsyms[ai]
        if ab.sym.id not in _ADD_IDS or len(ab.args) != 2:
            continue
        residual, xx = ab.args
        if not (isinstance(residual, TensorProxy) and isinstance(xx, TensorProxy)):
            continue
        if tuple(residual.shape) != tuple(xx.shape) or residual.dtype != xx.dtype:
            continue
        n = single_proxy_out(rb)
        if n is None:
            continue
        # the gate: a plain linear of n, an activation, a mul; the up path:
        # another plain linear of n into the same mul
        lin_consumers = []
        for ci in consumers.get(n.name, ()):
            if ci in used:
                continue
            facts = _plain_linear(bsyms[ci])
            if facts is not None and facts[0].name == n.name:
                lin_consumers.append(ci)
        found = None
        for gi in lin_consumers:
            gout = single_proxy_out(bsyms[gi])
            if gout is None:
                continue
            gcons = consumers.get(gout.name, ())
            if len(gcons) != 1:
                continue
            actb = bsyms[gcons[0]]
            act = _chain_act(actb)
            if act is None or not actb.args \
                    or getattr(actb.args[0], "name", None) != gout.name:
                continue
            aout = single_proxy_out(actb)
            if aout is None:
                continue
            acons = consumers.get(aout.name, ())
            if len(acons) != 1 or bsyms[acons[0]].sym.id not in _MUL_IDS:
                continue
            mi = acons[0]
            mb = bsyms[mi]
            if len(mb.args) != 2 or not all(isinstance(a, TensorProxy) for a in mb.args):
                continue
            other = mb.args[1] if mb.args[0].name == aout.name else mb.args[0]
            ui = next((j for j in lin_consumers
                       if j != gi and single_proxy_out(bsyms[j]) is not None
                       and single_proxy_out(bsyms[j]).name == getattr(other, "name", None)),
                      None)
            if ui is None:
                continue
            mout = single_proxy_out(mb)
            if mout is None:
                continue
            mcons = consumers.get(mout.name, ())
            if len(mcons) != 1:
                continue
            dfacts = _plain_linear(bsyms[mcons[0]])
            if dfacts is None or dfacts[0].name != mout.name:
                continue
            di = mcons[0]
            dout = single_proxy_out(bsyms[di])
            if dout is None:
                continue
            dcons = consumers.get(dout.name, ())
            if len(dcons) != 1:
                continue
            fb = bsyms[dcons[0]]
            if fb.sym.id not in _ADD_IDS or len(fb.args) != 2 \
                    or not all(isinstance(a, TensorProxy) for a in fb.args):
                continue
            if {fb.args[0].name, fb.args[1].name} != {h.name, dout.name}:
                continue
            found = (gi, gcons[0], act, ui, mi, di, dcons[0])
            break
        if found is None:
            continue
        gi, acti, act, ui, mi, di, fi = found
        chain = {ai, ri, gi, acti, ui, mi, di, fi}
        if chain & used:
            continue
        fout = single_proxy_out(bsyms[fi])
        if fout is None:
            continue
        w_gate = _plain_linear(bsyms[gi])[1]
        w_up = _plain_linear(bsyms[ui])[1]
        w_down = _plain_linear(bsyms[di])[1]
        if tuple(w_up.shape) != tuple(w_gate.shape) \
                or tuple(w_down.shape) != (w_gate.shape[1], w_gate.shape[0]):
            continue
        n_tokens = 1
        for d in h.shape[:-1]:
            n_tokens *= int(d)
        # a decode layer: the residual add absorbs a planned attention
        # sub-block's output, and the chain's per-op launches are charged
        decode = any(bsyms[producer[p.name]].sym.id == "nn.attn_subblock"
                     for p in (residual, xx) if p.name in producer)
        cost = dict(mlp_block_verdict(n_tokens, int(w_gate.shape[1]), int(w_gate.shape[0]),
                                      h.dtype.bytes, backward=backward, decode=decode),
                    chain=h.name, act=act, ops=len(chain))
        # -- the verdicts ---------------------------------------------------
        # every interior value is read only inside the chain and is no
        # output of the trace: the kernel does not produce it
        escaped = None
        for p, owners in ((h, {ri, fi}), (n, {gi, ui}),
                          (single_proxy_out(bsyms[gi]), {acti}),
                          (single_proxy_out(bsyms[acti]), {mi}),
                          (single_proxy_out(bsyms[ui]), {mi}),
                          (single_proxy_out(bsyms[mi]), {di}),
                          (single_proxy_out(bsyms[di]), {fi})):
            if p.name in out_names or set(consumers.get(p.name, ())) - owners:
                escaped = p.name
                break
        if escaped is not None:
            _record_block("interior-escapes", f"{escaped} is consumed outside the chain", cost)
            continue
        if enabled is not True and not cost["planned"]:
            _record_block("cost-rejected",
                          "the per-op chain's estimate beats the kernel's"
                          + (" (forward and backward)" if backward else "")
                          + " (need est_saved_us > 0)", cost)
            continue
        comp_args = (residual, xx, w_norm, w_gate, w_up, w_down)
        comp_kwargs = {"act": act, "eps": eps}
        refused = _claim_refusal(executors, "nn.mlp_subblock", comp_args, comp_kwargs,
                                 kernel=True)
        if refused is None and backward:
            refused = _claim_refusal(executors, "nn.mlp_subblock_bwd", (xx,) + comp_args,
                                     comp_kwargs, kernel=True)
        if refused is not None:
            _record_block("unclaimed", refused, cost)
            continue
        from thunder_tpu_torch.ops import composites

        repl = _build_composite(trc, composites.mlp_subblock, comp_args, comp_kwargs, [fout])
        if not repl:
            _record_block("rebuild-mismatch", "composite retrace changed output metadata", cost)
            continue
        repl[-1].header = (f"{BLOCK_MARKER}: {len(chain)}-op MLP sub-block chain planned as "
                           f"one kernel ({cost['saved_boundary_bytes'] >> 10} KiB of interior "
                           f"traffic kept on chip)")
        _record_block("planned",
                      "forced by block_fusion=True" if enabled is True
                      else "cost model: the kernel's estimate beats the per-op chain's", cost)
        _observe.inc("fusion.block_fusions")
        replacements[fi] = repl
        dropped.update(chain - {fi})
        used |= chain
        n_planned += 1

    if not replacements:
        return trc
    return _rebuild_trace(trc, replacements, dropped,
                          f"Block fusion planner ({n_planned} sub-block kernels)")


# ---------------------------------------------------------------------------
# serving decode-layer planning: the attention sub-block walk (stage 1) and
# the attn + mlp -> nn.decode_layer chaining stage (stage 3)
# ---------------------------------------------------------------------------

_PAGED_ID = "nn.paged_decode_attention"


def _single_out(b: BoundSymbol):
    outs = b.flat_proxy_outs()
    return outs[0] if len(outs) == 1 else None


def _dataflow(trc: TraceCtx):
    """(producer index, consumer indices, trace-output names) maps."""
    producer: dict[str, int] = {}
    consumers: dict[str, list[int]] = {}
    for i, b in enumerate(trc.bound_symbols):
        for p in b.flat_proxy_args():
            consumers.setdefault(p.name, []).append(i)
        for o in b.flat_proxy_outs():
            producer.setdefault(o.name, i)
    out_names = {o.name for o in tree_flatten(trc.output)[0] if isinstance(o, Proxy)}
    return producer, consumers, out_names


def _producer_bsym(bsyms, producer, p):
    i = producer.get(getattr(p, "name", None))
    return (i, bsyms[i]) if i is not None else (None, None)


def _match_rope(bsyms, producer, val):
    """Match the GPT-NeoX half rotation ``models.llama._apply_rope`` emits,
    ending at ``val``: ``cat([x1*cos - x2*sin, x2*cos + x1*sin], -1)`` with
    ``x1``/``x2`` the lower/upper half slices of one base tensor, matched
    exactly, operand roles and all (another rotation stays unfused).
    Returns ``(base, cos, sin, matched indices)`` or None."""
    ci, cb = _producer_bsym(bsyms, producer, val)
    if cb is None or cb.sym.id is not PrimIDs.CAT or not cb.args:
        return None
    parts = cb.args[0]
    if not isinstance(parts, (list, tuple)) or len(parts) != 2:
        return None
    dim = cb.args[1] if len(cb.args) > 1 else cb.kwargs.get("dim", -1)
    if dim not in (-1, val.ndim - 1):
        return None
    si, sb = _producer_bsym(bsyms, producer, parts[0])
    ai, ab = _producer_bsym(bsyms, producer, parts[1])
    if sb is None or ab is None or sb.sym.id not in _SUB_IDS or ab.sym.id not in _ADD_IDS:
        return None
    if len(sb.args) != 2 or len(ab.args) != 2:
        return None
    muls = []
    for operand in (*sb.args, *ab.args):
        mi, mb = _producer_bsym(bsyms, producer, operand)
        if mb is None or mb.sym.id not in _MUL_IDS or len(mb.args) != 2 \
                or not all(isinstance(a, TensorProxy) for a in mb.args):
            return None
        muls.append((mi, mb))
    (i1, m1), (i2, m2), (i3, m3), (i4, m4) = muls
    x1, cos = m1.args       # x1*cos - x2*sin
    x2, sin = m2.args
    x2b, cosb = m3.args     # x2*cos + x1*sin
    x1b, sinb = m4.args
    if x1.name != x1b.name or x2.name != x2b.name or cos.name != cosb.name \
            or sin.name != sinb.name or x1.name == x2.name:
        return None
    j1, sl1 = _producer_bsym(bsyms, producer, x1)
    j2, sl2 = _producer_bsym(bsyms, producer, x2)
    if sl1 is None or sl2 is None or sl1.sym.id is not PrimIDs.SLICE \
            or sl2.sym.id is not PrimIDs.SLICE:
        return None
    base = sl1.args[0]
    if not isinstance(base, TensorProxy) or getattr(sl2.args[0], "name", None) != base.name:
        return None
    hd2 = int(x1.shape[-1])
    try:
        if int(sl1.args[1][-1]) != 0 or int(sl2.args[1][-1]) != hd2:
            return None
    except (TypeError, IndexError, ValueError):
        return None
    return base, cos, sin, {ci, si, ai, i1, i2, i3, i4, j1, j2}


def _match_head_proj(bsyms, producer, base):
    """``base = transpose(reshape(nn.linear(x, w)), (0, 2, 1, 3))``, the
    runner's head split. Returns ``(x, w, indices)`` or None."""
    ti, tb = _producer_bsym(bsyms, producer, base)
    if tb is None or tb.sym.id is not PrimIDs.TRANSPOSE:
        return None
    perm = tb.args[1] if len(tb.args) > 1 else tb.kwargs.get("permutation")
    if tuple(perm or ()) != (0, 2, 1, 3):
        return None
    ri, rb = _producer_bsym(bsyms, producer, tb.args[0])
    if rb is None or rb.sym.id is not PrimIDs.RESHAPE:
        return None
    li, lb = _producer_bsym(bsyms, producer, rb.args[0])
    if lb is None:
        return None
    facts = _plain_linear(lb)
    if facts is None:
        return None
    return facts[0], facts[1], {ti, ri, li}


def _match_pool_write(bsyms, producer, pool_out):
    """Match the paged K/V append ``composites.decode_row_write`` emits::

        pool_out = reshape(scatter(reshape(pool_in),
                                   broadcast(reshape(write_pos)),
                                   transpose(squeeze(rows), (1, 0, 2)), 1))

    Returns ``(pool_in, write_pos, rows, indices)`` or None. The index
    build (reshape, broadcast of ``write_pos``) may be shared by every
    layer's writes: it is resolved but left out of the matched set."""
    r2i, r2b = _producer_bsym(bsyms, producer, pool_out)
    if r2b is None or r2b.sym.id is not PrimIDs.RESHAPE:
        return None
    sci, scb = _producer_bsym(bsyms, producer, r2b.args[0])
    if scb is None or scb.sym.id is not PrimIDs.SCATTER or len(scb.args) < 4:
        return None
    flat, idx, src = scb.args[0], scb.args[1], scb.args[2]
    if int(scb.args[3]) != 1:
        return None
    r1i, r1b = _producer_bsym(bsyms, producer, flat)
    if r1b is None or r1b.sym.id is not PrimIDs.RESHAPE \
            or not isinstance(r1b.args[0], TensorProxy):
        return None
    pool_in = r1b.args[0]
    _, bib = _producer_bsym(bsyms, producer, idx)
    if bib is None or bib.sym.id is not PrimIDs.BROADCAST_IN_DIM:
        return None
    _, r3b = _producer_bsym(bsyms, producer, bib.args[0])
    if r3b is None or r3b.sym.id is not PrimIDs.RESHAPE \
            or not isinstance(r3b.args[0], TensorProxy) or r3b.args[0].ndim != 1:
        return None
    write_pos = r3b.args[0]
    tri, trb = _producer_bsym(bsyms, producer, src)
    if trb is None or trb.sym.id is not PrimIDs.TRANSPOSE:
        return None
    perm = trb.args[1] if len(trb.args) > 1 else trb.kwargs.get("permutation")
    if tuple(perm or ()) != (1, 0, 2):
        return None
    sqi, sqb = _producer_bsym(bsyms, producer, trb.args[0])
    if sqb is None or sqb.sym.id is not PrimIDs.SQUEEZE \
            or not isinstance(sqb.args[0], TensorProxy):
        return None
    return pool_in, write_pos, sqb.args[0], {r2i, sci, r1i, tri, sqi}


def _attn_block_pass(trc: TraceCtx, executors, enabled) -> TraceCtx:
    """The attention sub-block walk (stage 1 of :func:`block_fusion_pass`;
    the reference's ``_attn_block_pass``, fusion_passes.py:1112): anchor
    every T == 1 ``nn.paged_decode_attention``, match backwards through the
    rope, the head-split projections and the K/V page writes to the
    ``nn.rms_norm`` head, and forwards through the out-projection; a legal,
    claimable, cost-approved chain becomes ONE ``nn.attn_subblock`` (its
    outputs: the pre-residual projection and the two updated pools)."""
    bsyms = trc.bound_symbols
    ids = {b.sym.id for b in bsyms}
    if _PAGED_ID not in ids or "nn.rms_norm" not in ids:
        return trc
    producer, consumers, out_names = _dataflow(trc)
    replacements: dict[int, list[BoundSymbol]] = {}
    dropped: set[int] = set()
    used: set[int] = set()
    n_planned = 0
    for pi, pb in enumerate(bsyms):
        if pb.sym.id != _PAGED_ID or pi in used or len(pb.args) < 5:
            continue
        q_arg, kp_u, vp_u, bt, ln = pb.args[:5]
        if not all(isinstance(t, TensorProxy) for t in (q_arg, kp_u, vp_u, bt, ln)):
            continue
        if q_arg.ndim != 4 or int(q_arg.shape[2]) != 1:
            continue                      # decode only; prefill stays unfused
        scale = pb.kwargs.get("scale", pb.args[5] if len(pb.args) > 5 else None)
        rope_q = _match_rope(bsyms, producer, q_arg)
        if rope_q is None:
            continue
        q0, cos, sin, rq_idx = rope_q
        pq = _match_head_proj(bsyms, producer, q0)
        if pq is None:
            continue
        x_in, wq, pq_idx = pq
        kw_ = _match_pool_write(bsyms, producer, kp_u)
        vw_ = _match_pool_write(bsyms, producer, vp_u)
        if kw_ is None or vw_ is None:
            continue
        k_pool, wp_k, k_rows, kw_idx = kw_
        v_pool, wp_v, v_rows, vw_idx = vw_
        if wp_k.name != wp_v.name or k_pool.name == v_pool.name:
            continue
        rope_k = _match_rope(bsyms, producer, k_rows)
        if rope_k is None:
            continue
        k0, cos_k, sin_k, rk_idx = rope_k
        if cos_k.name != cos.name or sin_k.name != sin.name:
            continue
        pk = _match_head_proj(bsyms, producer, k0)
        pv = _match_head_proj(bsyms, producer, v_rows)
        if pk is None or pv is None:
            continue
        xk, wk, pk_idx = pk
        xv, wv, pv_idx = pv
        if xk.name != x_in.name or xv.name != x_in.name:
            continue
        ri, rb = _producer_bsym(bsyms, producer, x_in)
        if rb is None or rb.sym.id != "nn.rms_norm":
            continue
        h = rb.args[0] if rb.args else None
        w_norm = rb.args[1] if len(rb.args) > 1 else rb.kwargs.get("weight")
        if not (isinstance(h, TensorProxy) and isinstance(w_norm, TensorProxy)):
            continue
        dim = rb.kwargs.get("dim", rb.args[3] if len(rb.args) > 3 else -1)
        if dim not in (-1, h.ndim - 1):
            continue
        eps = rb.kwargs.get("eps", rb.args[2] if len(rb.args) > 2 else 1e-5)
        # forward: attn -> transpose(0, 2, 1, 3) -> reshape -> linear(., wo)
        aout = _single_out(pb)
        if aout is None:
            continue
        acons = set(consumers.get(aout.name, ()))
        if len(acons) != 1:
            continue
        t2i = next(iter(acons))
        t2b = bsyms[t2i]
        if t2b.sym.id is not PrimIDs.TRANSPOSE:
            continue
        perm = t2b.args[1] if len(t2b.args) > 1 else t2b.kwargs.get("permutation")
        if tuple(perm or ()) != (0, 2, 1, 3):
            continue
        t2o = _single_out(t2b)
        r4cons = set(consumers.get(t2o.name, ())) if t2o is not None else set()
        if len(r4cons) != 1:
            continue
        r4i = next(iter(r4cons))
        r4b = bsyms[r4i]
        if r4b.sym.id is not PrimIDs.RESHAPE:
            continue
        r4o = _single_out(r4b)
        lcons = set(consumers.get(r4o.name, ())) if r4o is not None else set()
        if len(lcons) != 1:
            continue
        li = next(iter(lcons))
        lfacts = _plain_linear(bsyms[li])
        if lfacts is None or lfacts[0].name != r4o.name:
            continue
        wo = lfacts[1]
        proj = _single_out(bsyms[li])
        if proj is None:
            continue
        chain = ({pi, ri, t2i, r4i, li} | rq_idx | pq_idx | kw_idx | vw_idx | rk_idx | pk_idx
                 | pv_idx)
        if chain & used:
            continue
        KV, P, ps, hd = (int(d) for d in kp_u.shape)
        if wq.shape[0] % hd or wk.shape[0] % hd:
            continue
        H = int(wq.shape[0]) // hd
        cost = dict(cost_model.attn_subblock_cost(int(h.shape[0]), int(h.shape[-1]), H, KV, hd,
                                                  ps, int(bt.shape[1]), h.dtype.bytes),
                    chain=h.name, ops=len(chain))
        # exclusivity: the composite's outputs (the projection and the two
        # updated pools) are the only values allowed to escape the chain
        comp_outs = {proj.name, kp_u.name, vp_u.name}
        escaped = next((o.name for bi in sorted(chain) for o in bsyms[bi].flat_proxy_outs()
                        if o.name not in comp_outs
                        and (o.name in out_names or set(consumers.get(o.name, ())) - chain)),
                       None)
        if escaped is not None:
            _record_block("interior-escapes", f"{escaped} is consumed outside the chain", cost,
                          op="nn.attn_subblock")
            continue
        if enabled is not True and not cost_model.subblock_profitable(cost):
            _record_block("cost-rejected",
                          "the per-op chain's estimate, its launches inside a replayed graph "
                          "counted, beats the kernel's (need est_saved_us > 0)", cost,
                          op="nn.attn_subblock")
            continue
        comp_args = (h, w_norm, wq, wk, wv, wo, cos, sin, k_pool, v_pool, bt, ln, wp_k)
        comp_kwargs = {"eps": eps}
        if scale is not None:
            comp_kwargs["scale"] = scale
        refused = _claim_refusal(executors, "nn.attn_subblock", comp_args, comp_kwargs,
                                 kernel=True)
        if refused is not None:
            _record_block("unclaimed", refused, cost, op="nn.attn_subblock")
            continue
        from thunder_tpu_torch.ops import composites

        repl = _build_composite(trc, composites.attn_subblock, comp_args, comp_kwargs,
                                [proj, kp_u, vp_u])
        if not repl:
            _record_block("rebuild-mismatch", "composite retrace changed output metadata", cost,
                          op="nn.attn_subblock")
            continue
        repl[-1].header = (f"{BLOCK_MARKER}: {len(chain)}-op attention sub-block (qkv, rope, "
                           f"page writes, paged attention, out-projection) planned as one "
                           f"kernel")
        _record_block("planned",
                      "forced by block_fusion=True" if enabled is True
                      else "cost model: interior bytes and launches beat the kernel's "
                           "overheads", cost, op="nn.attn_subblock")
        _observe.inc("fusion.block_fusions")
        last = max(chain)
        replacements[last] = repl
        dropped.update(chain - {last})
        used |= chain
        n_planned += 1
    if not replacements:
        return trc
    return _rebuild_trace(trc, replacements, dropped,
                          f"Attention sub-block planner ({n_planned} chains)")


def _decode_chain_pass(trc: TraceCtx, executors, enabled) -> TraceCtx:
    """The chaining stage (stage 3 of :func:`block_fusion_pass`; the
    reference's ``_decode_chain_pass``, fusion_passes.py:1309): a planned
    ``nn.attn_subblock`` whose projection feeds its layer's
    ``nn.mlp_subblock`` as the attention-out summand, over the same residual
    stream, becomes one ``nn.decode_layer``, one launch per layer per
    decoded token. Chaining changes no value the decomposition computes (it
    is the two sub-blocks); besides claimability, the kernel's own refusal
    (``cudaex.refusal``, where the reference checks combined VMEM) decides.
    The cost (``decode_layer_cost``) is recorded."""
    bsyms = trc.bound_symbols
    if not any(b.sym.id == "nn.attn_subblock" for b in bsyms):
        return trc
    producer, consumers, out_names = _dataflow(trc)
    replacements: dict[int, list[BoundSymbol]] = {}
    dropped: set[int] = set()
    n_chained = 0
    for ai, ab in enumerate(bsyms):
        if ab.sym.id != "nn.attn_subblock" or len(ab.args) != 13:
            continue
        outs = ab.flat_proxy_outs()
        if len(outs) != 3:
            continue
        proj, kp, vp = outs
        h = ab.args[0]
        base_cost = {"chain": getattr(h, "name", "?")}
        mb, mi = None, None
        pcons = set(consumers.get(proj.name, ()))
        if proj.name not in out_names and len(pcons) == 1:
            ci = next(iter(pcons))
            cand = bsyms[ci]
            if cand.sym.id == "nn.mlp_subblock" and len(cand.args) >= 6:
                residual, xx = cand.args[0], cand.args[1]
                if getattr(residual, "name", None) == h.name \
                        and getattr(xx, "name", None) == proj.name:
                    mb, mi = cand, ci
        if mb is None:
            _record_block("chain-blocked", "no adjoining nn.mlp_subblock consumes the attention "
                          "output over the same residual stream", base_cost,
                          op="nn.decode_layer")
            continue
        eps_a = ab.kwargs.get("eps", 1e-5)
        if eps_a != mb.kwargs.get("eps", 1e-5):
            _record_block("chain-blocked", "the two sub-blocks normalize with different eps",
                          base_cost, op="nn.decode_layer")
            continue
        # the fused composite lands at the MLP's position: the pools it
        # produces must not be consumed before that
        if any(j < mi for o in (kp, vp) for j in consumers.get(o.name, ())):
            _record_block("chain-blocked", "an updated page pool is consumed before the "
                          "layer's MLP sub-block", base_cost, op="nn.decode_layer")
            continue
        act = mb.kwargs.get("act", "silu")
        scale = ab.kwargs.get("scale")
        KV, P, ps, hd = (int(d) for d in ab.args[8].shape)
        S, D = int(h.shape[0]), int(h.shape[-1])
        H = int(ab.args[2].shape[0]) // hd
        F = int(mb.args[3].shape[0])
        acost = cost_model.attn_subblock_cost(S, D, H, KV, hd, ps, int(ab.args[10].shape[1]),
                                              h.dtype.bytes)
        mcost = cost_model.subblock_cost(S, D, F, h.dtype.bytes, decode=True)
        cost = dict(cost_model.decode_layer_cost(acost, mcost, S, D, ps, h.dtype.bytes),
                    chain=h.name)
        comp_args = tuple(ab.args) + tuple(mb.args[2:6])
        comp_kwargs = {"act": act, "eps": eps_a}
        if scale is not None:
            comp_kwargs["scale"] = scale
        m_out = _single_out(mb)
        if m_out is None:
            continue
        refused = _claim_refusal(executors, "nn.decode_layer", comp_args, comp_kwargs,
                                 kernel=True)
        if refused is not None:
            _record_block("unclaimed", f"{refused}; keeping the two-launch form", cost,
                          op="nn.decode_layer")
            continue
        from thunder_tpu_torch.ops import composites

        repl = _build_composite(trc, composites.decode_layer, comp_args, comp_kwargs,
                                [m_out, kp, vp])
        if not repl:
            _record_block("rebuild-mismatch", "composite retrace changed output metadata", cost,
                          op="nn.decode_layer")
            continue
        repl[-1].header = (f"{BLOCK_MARKER}: attention + MLP sub-blocks chained into one "
                           f"decode-layer launch")
        _record_block("chained",
                      "forced by block_fusion=True" if enabled is True
                      else "one launch per layer: chaining saves a launch and keeps the "
                           "residual stream on chip", cost, op="nn.decode_layer")
        _observe.inc("fusion.decode_layer_chains")
        replacements[mi] = repl
        dropped.add(ai)
        n_chained += 1
    if not replacements:
        return trc
    return _rebuild_trace(trc, replacements, dropped, f"Decode-layer chaining ({n_chained} layers)")


def plan_blocks_for_autodiff(trc: TraceCtx) -> TraceCtx:
    """The planner before autodiff, on the differentiated function's trace
    (``inline_value_and_grad``, ``forward_and_backward_from_trace``): the
    planned composites then meet their VJP rule and stay claimable in both
    directions. It reads the compiling function's executor stack from the
    compile context; outside a compile it does nothing."""
    from thunder_tpu_torch.core.compile_data import get_compile_data

    ctx = get_compile_data()
    executors = getattr(ctx, "executors", None) if ctx is not None else None
    if not executors:
        return trc
    with _observe.span("block_fusion_pre_autodiff"):
        return block_fusion_pass(trc, executors, backward=True)
