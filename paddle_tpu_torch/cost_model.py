"""Cost accounting — counterpart of paddle_tpu/cost_model.py.

`train_flops_per_token` is the one formula the train step's MFU is
priced with (chip_smoke.py), copied from the reference so the port's MFU
and the reference's stay comparable. `serving_memory_ledger` prices a
serving engine's device memory by component, and its host KV tier
beside it (ServingEngine.memory_ledger()). `train_memory_ledger` prices
one planned train step's per-device memory, the planner's HBM gate
(parallel/planner.py).
"""
from __future__ import annotations

__all__ = ["train_flops_per_token", "serving_memory_ledger",
           "train_memory_ledger"]


def train_flops_per_token(n_params: int, num_layers: int,
                          hidden_size: int, seq: int) -> float:
    """6N matmul FLOPs per token (forward + backward) plus the attention
    score/context matmul term."""
    return 6.0 * n_params + 12.0 * num_layers * hidden_size * seq


def _family_dims(cfg, family: str) -> dict:
    """Model dims and every stacked matmul of a serving family as (in,
    out): GPT's qkv/attn_out/mlp_up/mlp_down, Llama's q/k/v/o and
    gate/up/down (quantization/serving.py's leaves)."""
    D = int(cfg.hidden_size)
    L = int(cfg.num_layers)
    V = int(cfg.vocab_size)
    H = int(cfg.num_heads)
    KV = int(getattr(cfg, "num_kv_heads", H) or H)
    F = int(getattr(cfg, "ffn_hidden", 0) or 4 * D)
    hd = D // H
    if family == "gpt":
        mats = [(D, 3 * D), (D, D), (D, F), (F, D)]
    elif family == "llama":
        kvd = KV * hd
        mats = [(D, D), (D, kvd), (D, kvd), (D, D),
                (D, F), (D, F), (F, D)]
    else:
        raise ValueError(f"unknown family {family!r} (gpt|llama)")
    return {"D": D, "L": L, "V": V, "H": H, "KV": KV, "F": F,
            "hd": hd, "mats": mats,
            "layer_params": sum(i * o for i, o in mats),
            "layer_out_features": sum(o for _, o in mats)}


def serving_memory_ledger(cfg, family: str = "gpt", layout: str = "dense",
                          quant: str = "off", num_slots: int = 8,
                          max_len: int = 0, page_size: int = 16,
                          num_pages: int = 0, cache_bytes_per_elem: int = 2,
                          dtype_bytes: int = 4,
                          host_kv_bytes: int = 0) -> dict:
    """Device bytes of a serving-engine configuration by component (the
    reference's formula, one card):

    - weights: the fp payload (every parameter with quant "off"; the
      embeddings alone with "int8", whose block leaves and tied head
      move to the pairs below);
    - weights_quant / weights_quant_scales: the int8 payloads and their
      f32 per-output-channel scales;
    - kv_pool_device: dense, k+v for every slot at max_len; paged, the
      page pool plus the page table (int64 in the port);
    - kv_pool_host: the host tier's bytes (inference/host_kv.py), host
      RAM, so outside `total` and reported as `host_total`;
    - decode_scratch: f32 logits of every slot plus the hidden and
      residual activations."""
    dims = _family_dims(cfg, family)
    if layout not in ("dense", "paged"):
        raise ValueError(f"layout {layout!r} (dense|paged)")
    if quant not in ("off", "int8"):
        raise ValueError(f"quant {quant!r} (off|int8)")
    D, L, V, KV, hd = (dims["D"], dims["L"], dims["V"], dims["KV"],
                       dims["hd"])
    embed_seq = int(getattr(cfg, "max_seq_len", 0) or max_len)
    max_len = int(max_len or embed_seq)
    n_params = dims["layer_params"] * L + (V + embed_seq) * D
    embed_params = (V + embed_seq) * D
    if quant == "int8":
        weights = float(embed_params * dtype_bytes)
        w_quant = float(dims["layer_params"] * L + D * V)
        w_scales = 4.0 * (dims["layer_out_features"] * L + V)
    else:
        weights = float(n_params * dtype_bytes)
        w_quant = w_scales = 0.0
    max_pages = -(-max_len // page_size)
    if layout == "paged":
        n_pages = int(num_pages or num_slots * max_pages + 1)
        kv_pool = (2.0 * L * n_pages * page_size * KV * hd
                   * cache_bytes_per_elem
                   + 8.0 * num_slots * max_pages)       # the page table
    else:
        n_pages = 0
        kv_pool = (2.0 * L * num_slots * max_len * KV * hd
                   * cache_bytes_per_elem)
    scratch = num_slots * (V * 4.0 + 2.0 * D * dtype_bytes)
    components = {"weights": weights, "weights_quant": w_quant,
                  "weights_quant_scales": w_scales,
                  "kv_pool_device": kv_pool,
                  "decode_scratch": scratch}
    total = sum(components.values())
    components["kv_pool_host"] = float(host_kv_bytes)
    return {"components": components, "total": total,
            "host_total": float(host_kv_bytes),
            "config": {"family": family, "layout": layout,
                       "quant": quant, "num_slots": int(num_slots),
                       "max_len": max_len, "page_size": int(page_size),
                       "num_pages": n_pages,
                       "cache_bytes_per_elem": cache_bytes_per_elem,
                       "dtype_bytes": dtype_bytes, "n_params": n_params,
                       "host_kv_bytes": int(host_kv_bytes)}}


def _plan_degrees(plan) -> dict:
    """Normalize a plan argument — parallel.planner.TrainPlan, Plan,
    a {axis: degree} dict, or None (single device) — to the 3D/4D
    degrees the train ledger prices (+ `mb`, the pp microbatch count,
    defaulting to 2·pp when the plan carries none)."""
    if plan is None:
        return {"dp": 1, "fsdp": 1, "tp": 1, "pp": 1, "mb": 1,
                "overlap": False}
    def _mb(pp: int, raw) -> int:
        # a pp>1 plan must microbatch (plan_train never emits mb<2);
        # mb<=1 therefore means "the plan carries no real count"
        # (TrainPlan.microbatches and the Plan dataclass both default
        # to 1) — fall back to the documented 2·pp
        raw = int(raw or 0)
        if pp <= 1:
            return 1
        return raw if raw > 1 else 2 * pp

    if hasattr(plan, "axes"):                      # TrainPlan
        axes = dict(plan.axes)
        deg = {"dp": int(axes.get("dp", 1)),
               "fsdp": int(axes.get("fsdp", 1)),
               "tp": int(axes.get("tp", axes.get("mp", 1))),
               "pp": int(axes.get("pp", 1))}
        deg["mb"] = _mb(deg["pp"], getattr(plan, "microbatches", 0))
        deg["overlap"] = bool(getattr(plan, "overlap", False))
        return deg
    if hasattr(plan, "dp"):                        # priced Plan row
        pp = int(getattr(plan, "pp", 1))
        return {"dp": int(plan.dp), "fsdp": int(plan.fsdp),
                "tp": int(plan.mp), "pp": pp,
                "mb": _mb(pp, getattr(plan, "microbatches", 0)),
                "overlap": bool(getattr(plan, "overlap", False))}
    axes = dict(plan)
    pp = int(axes.get("pp", 1))
    return {"dp": int(axes.get("dp", 1)),
            "fsdp": int(axes.get("fsdp", 1)),
            "tp": int(axes.get("tp", axes.get("mp", 1))),
            "pp": pp,
            "mb": _mb(pp, axes.get("microbatches", 0)),
            "overlap": bool(axes.get("overlap", False))}


def train_memory_ledger(cfg, plan=None, global_batch: int = 8,
                        seq: int = 0) -> dict:
    """Per-chip HBM bytes for ONE planned train step, attributed to
    named components.

    THE one home of the planner's HBM model, the reference's formula
    term for term: parallel/planner._estimate consumes `total` for its
    mem_bytes/fits gate. Components:

    - params / grads / adam_m / adam_v: the f32 master state, each
      4 bytes/elem over this chip's tp×pp×fsdp param shard (the
      planner's `state_bytes = shard_params*16`, split four ways);
    - activations: the remat residual / activation working set —
      _ACT_BUFFERS[policy] residual-sized buffers per local layer
      (L/pp), sharded over tp under sequence parallelism;
    - logits: the f32 logits working set, vocab-parallel over tp and
      divided by the microbatch count (pp runs one microbatch's head
      at a time);
    - overlap_prefetch: plan.overlap's double-buffered ZeRO-3 gather
      holds two gathered layers' worth of bf16 weights in flight
      (zero when overlap is off or fsdp == 1 — the buffer only exists
      when there is a gather to hide).

    `cfg` is a model config or a planner.ModelSpec; `plan` anything
    _plan_degrees takes. `seq` defaults to the spec's sequence length
    (what _estimate prices)."""
    from .parallel.planner import _ACT_BUFFERS, _coerce_spec
    spec = _coerce_spec(cfg)
    deg = _plan_degrees(plan)
    dp, fsdp, tp, pp = deg["dp"], deg["fsdp"], deg["tp"], deg["pp"]
    # the plan's OWN microbatch count when it carries one (enumerate_
    # plans clamps mb to the local batch, possibly down to 1 — the
    # ledger must price the same logits chunk _estimate always did,
    # not _plan_degrees' 2·pp fallback for count-less dict plans)
    raw_mb = int(getattr(plan, "microbatches", 0) or 0) \
        if plan is not None else 0
    mb = raw_mb if raw_mb >= 1 else deg["mb"]
    L, D = spec.num_layers, spec.hidden_size
    V = spec.vocab_size
    S = int(seq or spec.seq_len)
    b_local = max(int(global_batch) // (dp * fsdp), 1)
    tok_local = b_local * S
    abytes = spec.act_bytes_per_elem
    shard_params = spec.total_params / (tp * pp * fsdp)
    state_each = shard_params * 4.0              # f32, one of p/g/m/v
    seq_shard = tp if (spec.sequence_parallel and tp > 1) else 1
    act_bytes = (_ACT_BUFFERS.get(spec.remat_policy, 2.0)
                 * (L / pp) * tok_local * D * abytes / seq_shard)
    logit_bytes = tok_local * V * 4.0 / tp / max(mb, 1)
    prefetch = (2.0 * (spec.block_params / L) * abytes
                if deg.get("overlap") and fsdp > 1 else 0.0)
    components = {
        "params": state_each, "grads": state_each,
        "adam_m": state_each, "adam_v": state_each,
        "activations": act_bytes, "logits": logit_bytes,
        "overlap_prefetch": prefetch,
    }
    # summed in the planner's historical order (state first) so the
    # non-overlap total is bit-identical to the pre-ledger _estimate
    total = state_each * 4.0 + act_bytes + logit_bytes + prefetch
    return {"components": components, "total": total,
            "config": {"plan": dict(deg, mb=mb),
                       "n_devices": dp * fsdp * tp * pp,
                       "global_batch": int(global_batch), "seq": S,
                       "remat": spec.remat_policy,
                       "act_bytes_per_elem": abytes,
                       "n_params": spec.total_params}}
