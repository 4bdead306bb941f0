#!/usr/bin/env python3
"""Quick check of tensor-parallel serving and the elastic drill on the
card: chip_smoke.py's phases 5e and 6d without the rest.

    python3 tools/torch_tp_elastic_quick.py

Builds the kernels (nvcc for sm_90a, or the cached libraries), draws
phase 5b's TinyLlama-width host weights (LLAMA_SERVE_LAYERS layers),
runs the single-card int8 engines whose streams 5e is held to
(5b's dense engine and 5c's paged spec engine, through
chip_smoke.run_engine), then phase 5e (the int8 kernel at a tp2 rank's
leaf shapes, the tp2 engines on two ranks) and phase 6d (the elastic
drill through the port's launcher). Prints each part's seconds. A short
call for iterating on those two phases; chip_smoke.py is the full
check. Exits non-zero without a card or when a build or check fails.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_tp_elastic_quick: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm

    t0 = time.perf_counter()
    _build.build(*_build.KERNELS)
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    seconds = {"build": time.perf_counter() - t0}
    lcfg, lparams = cs.llama_host_params()
    per_pass = sum(cs.pass_calls(cs.LLAMA_LEAF_KN, lcfg.num_layers).values())
    draft = sum(cs.pass_calls(cs.LLAMA_LEAF_KN,
                              cs.SPEC["draft_layers"]).values())
    k1c = {}
    with cs.quantize_once():
        for label, kw, prompts_fn in cs.TP_ENGINES:
            t_s = time.perf_counter()
            key = "serving" if label == "tp2" else "spec"
            eng = ServingEngine(lparams, lcfg, family="llama", num_slots=8,
                                max_len=2048, max_top_k=50, seed=0,
                                quant="int8", **kw)
            streams, _, _ = cs.run_engine(
                torch, qm, eng, getattr(cs, prompts_fn)(lcfg.vocab_size),
                key, card, per_pass,
                per_pass + cs.SPEC["gamma"] * draft if eng.spec
                else per_pass, profile=False)
            k1c[key] = {"streams": streams}
            del eng
            torch.cuda.empty_cache()
            seconds[f"single_{key}"] = time.perf_counter() - t_s
        t_s = time.perf_counter()
        cs.tp_serving(torch, qm, dev, card, lcfg, lparams, k1c)
        seconds["llama_tp2_serving"] = time.perf_counter() - t_s
    del lparams
    t_s = time.perf_counter()
    cs.elastic_drill(torch, dev, card)
    seconds["llama_elastic_drill"] = time.perf_counter() - t_s
    seconds["total"] = time.perf_counter() - t0
    print(seconds, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
