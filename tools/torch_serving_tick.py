#!/usr/bin/env python3
"""The int8 serving phase of a checkout's chip_smoke.py, alone, on one card.

    python3 tools/torch_serving_tick.py [--tree DIR] [--label NAME]

Imports chip_smoke.py and paddle_tpu_torch from DIR (default: this
checkout), builds that checkout's int8 kernel, runs its `serving` phase
(the int8 engine at the GPT width: 16 requests, 8 slots, its checks and
its tick profile) and prints one JSON line with the tick and prefill
times, tagged with the label. To compare two commits on one card, unpack
the other into a git-ignored directory and run the two in turn in one
call: parent, change, change, parent, so drift shows beside the
difference. Exits non-zero without a card or when the phase fails.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serving_tick: CUDA is not available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm
    assert os.path.dirname(os.path.abspath(qm.__file__)).startswith(tree)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build("quant_matmul")
    card = cs.card_line()
    _, summary = cs.serving(torch, qm, torch.device("cuda:0"), card)
    keys = ("tick_ms_p50", "tick_ms_p90", "prefill_ms_p50", "tokens_per_s",
            "decode_ticks", "launches")
    print(json.dumps({"tool": "torch_serving_tick",
                      "label": args.label or tree, "card": card,
                      **{k: summary[k] for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
