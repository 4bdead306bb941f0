"""chip_smoke.py's greedy check (`greedy_check`) on the CPU, at a tiny
GPT width: the plain version passes against itself, a stand-in for the
kernel that sums the split-K partials in its own order passes, and
stand-ins with a fault only on the decode path's split-K fail it: a
split's partial dropped or counted twice (the streams part away from a
tie), and the head's output doubled (the streams stay equal, the decode
logits do not)."""
import importlib.util
import pathlib

import pytest
import torch

from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from paddle_tpu_torch.quantization.serving import quantize_serving_params

SM_COUNT = 132
CFG = GPTConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=128)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _split_k(fault=None):
    """The kernel's arithmetic on the host: where `_plan` splits K, each
    split's f32 partial over its K rows, summed in split order, times the
    scale, rounded once. `fault` breaks only that split-K path."""
    def qmm(x, w_q, scale):
        x2 = x.reshape(-1, x.shape[-1])
        M, K = x2.shape
        plan = qm._plan(M, K, w_q.shape[1], SM_COUNT)
        if plan.splits == 1:
            return qm.quant_matmul_ref(x, w_q, scale)
        rows = plan.chunks_per_split * qm.TILE_K
        parts = [x2[:, k:k + rows].float() @ w_q[k:k + rows].float()
                 for k in range(0, K, rows)]
        if fault == "drop_last_split":
            parts = parts[:-1]
        elif fault == "double_first_split":
            parts = [parts[0]] + parts
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        y = (acc * scale.float()).to(x.dtype)
        if fault == "head_doubled" and w_q.shape[1] == CFG.vocab_size:
            y = y * 2                    # the argmax, ties included, kept
        return y.reshape(*x.shape[:-1], w_q.shape[1])
    return qmm


@pytest.fixture(scope="module")
def setup():
    params = init_gpt_params(CFG, seed=0, device="cpu")
    qp, _ = quantize_serving_params(params, "gpt")
    prompt = torch.randint(0, CFG.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(1))
    return _chip_smoke(), qp, prompt.numpy()


def test_decode_path_splits_k():
    """The stand-ins meet split-K on this path: M = 1 decode steps split
    every leaf's K; the prefill does not."""
    plan = qm._plan(1, CFG.hidden_size, 3 * CFG.hidden_size, SM_COUNT)
    assert plan.splits > 1
    assert qm._plan(64, CFG.hidden_size, 3 * CFG.hidden_size,
                    SM_COUNT).splits == 1


@pytest.mark.parametrize("qmm,why", [
    (qm.quant_matmul_ref, None),
    (_split_k(), None),
    (_split_k("drop_last_split"), "parted"),
    (_split_k("double_first_split"), "parted"),
    (_split_k("head_doubled"), "logits"),
], ids=["plain", "split_k", "drop_last_split", "double_first_split",
        "head_doubled"])
def test_greedy_check(setup, qmm, why):
    cs, qp, prompt = setup
    report = cs.greedy_check(torch, qmm, qm.quant_matmul_ref, qp, prompt,
                             CFG, torch.device("cpu"), max_len=128)
    assert report["replays_reproduce"]
    assert report["ok"] is (why is None), report
    if why is None:
        assert report["decode_logit_err_over_span"] <= 0.05
    elif why == "parted":
        first = report["first_split_step"]
        assert any(s["step"] == first and not s["within_one_step"]
                   for s in report["differing_steps"])
    else:
        assert report["greedy16_equal"]
        assert report["decode_logit_err_over_span"] > 0.05
