"""Cost accounting — counterpart of paddle_tpu/cost_model.py.

`train_flops_per_token` is the one formula the train step's MFU is
priced with (chip_smoke.py), copied from the reference so the port's MFU
and the reference's stay comparable. `serving_memory_ledger` prices a
serving engine's device memory by component, and its host KV tier
beside it (ServingEngine.memory_ledger()).
"""
from __future__ import annotations

__all__ = ["train_flops_per_token", "serving_memory_ledger"]


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
