#!/usr/bin/env python3
"""Quick check of the port's flash-attention kernels on one card.

    python3 tools/torch_flash_bwd_quick.py

Builds csrc/flash_attention.cu alone (nvcc, sm_90a, or the cached
library), prints the -Xptxas -v lines of the backward kernels, fails if
the D = 64 pair spills, then runs chip_smoke.py's phase 2b
(`attention_check`: the kernels against their plain versions, the same
bits twice, and their times beside SDPA's at ATTN_SHAPES). A short call
for iterating on the attention kernels; chip_smoke.py is the full
check. Exits non-zero without a card or when a build or check fails.
"""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_bwd_quick: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build

    _build.build("flash_attention")
    report = _build.build_logs["flash_attention"]["ptxas"]
    for line in cs.ptxas_summary(report):
        if "bwd" in line:
            print(line)
    cs.check_no_spills(report)
    print(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.attention_check(torch, torch.device("cuda:0"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
