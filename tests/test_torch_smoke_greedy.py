"""chip_smoke.py's int8 checks on the CPU.

The greedy check (`greedy_check`), at a tiny GPT width: the plain
version passes against itself, a stand-in for the kernel that sums the
split-K partials in its own order passes, and stand-ins with a fault
only on the decode path's split-K fail it: a split's partial dropped or
counted twice (the streams part away from a tie, and the calls leave
the f64 bound), and the head's output doubled (the streams stay equal,
the decode logits do not). The same on a tiny Llama, through the Llama
family's forward, cache and greedy loop; there a parting wider than one
bf16 step passes when every int8 call is within the f64 bound (a
stand-in that rounds toward zero, a faithful rounding), and fails when a
call before the parting is not (a fault planted in the prefill).

The f64 bound (`f64_oracle`, `f64_verdict`): a correct f32 product
rounded once to bf16 passes, even at a planted near-cancelling column;
a dropped split fails, and so does an error of two bf16 steps on a
column without cancellation."""
import importlib.util
import pathlib

import pytest
import torch

from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from paddle_tpu_torch.models.llama import LlamaConfig, init_llama_params
from paddle_tpu_torch.quantization.serving import quantize_serving_params

SM_COUNT = 132
VOCAB = 512
CFG = GPTConfig(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=128)
LCFG = LlamaConfig(vocab_size=VOCAB, hidden_size=64, num_layers=2,
                   num_heads=4, num_kv_heads=2, max_seq_len=128)


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
        if fault == "head_doubled" and w_q.shape[1] == VOCAB:
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
        # and the faulty split-K outputs lie far outside the f64 bound
        f64 = report["f64_calls"]
        assert not f64["ok"] and f64["kernel_max_bound_share"] > 10
    else:
        assert report["greedy16_equal"]
        assert report["decode_logit_err_over_span"] > 0.05


@pytest.fixture(scope="module")
def llama_setup():
    qp, _ = quantize_serving_params(
        init_llama_params(LCFG, seed=0, device="cpu"), "llama")
    prompt = torch.randint(0, LCFG.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(2))
    return _chip_smoke(), qp, prompt.numpy()


@pytest.mark.parametrize("qmm,ok", [
    (_split_k(), True),
    (_split_k("drop_last_split"), False),
], ids=["split_k", "drop_last_split"])
def test_greedy_check_on_llama(llama_setup, qmm, ok):
    cs, qp, prompt = llama_setup
    report = cs.greedy_check(torch, qmm, qm.quant_matmul_ref, qp, prompt,
                             LCFG, torch.device("cpu"), max_len=128,
                             family="llama")
    assert report["replays_reproduce"]
    assert report["ok"] is ok, report
    assert report["f64_calls"]["ok"] is ok
    # every forward of the kernel's replays: the prefill and 15 steps
    per_pass = 7 * LCFG.num_layers + 1
    forwards = 16 * (1 if report["greedy16_equal"] else 2)
    assert report["f64_calls"]["calls"] == per_pass * forwards
    assert report["f64_parting"]["calls"] == per_pass


def _truncating(fault=False):
    """The f32 sum of exact products times the scale, rounded toward
    zero to bf16: a faithful rounding other than the plain version's, so
    every call lies within the f64 bound. `fault` adds three bf16 steps
    to one element of every prefill call (M > 1)."""
    def qmm(x, w_q, scale):
        acc = x.reshape(-1, x.shape[-1]).float() @ w_q.float()
        bits = ((acc * scale.float()).view(torch.int32) >> 16).to(
            torch.int16)
        if fault and acc.shape[0] > 1:
            bits.view(-1)[0] += 3
        return bits.view(torch.bfloat16).reshape(*x.shape[:-1],
                                                 w_q.shape[1])
    return qmm


@pytest.fixture(scope="module")
def parting_setup():
    """A tiny Llama with block weights and wte at std 0.15 and a prompt
    on which the truncating stand-in's stream parts from the plain one at
    step 11, its two tokens more than one bf16 step apart in the plain
    stream's replay on the stand-in."""
    params = init_llama_params(LCFG, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    params = {k: torch.randn(v.shape, generator=g) * 0.15
              if k.endswith("_w") or k == "wte" else v
              for k, v in params.items()}
    qp, _ = quantize_serving_params(params, "llama")
    prompt = torch.randint(0, LCFG.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(13))
    return _chip_smoke(), qp, prompt.numpy()


@pytest.mark.parametrize("fault", [False, True],
                         ids=["faithful", "fault_before_parting"])
def test_greedy_check_on_llama_parting(parting_setup, fault):
    """A parting that is no one-step tie passes on Llama when every call
    of both replays is within the f64 bound; a fault upstream of it, too
    small for the logit tolerance, fails on the bound."""
    cs, qp, prompt = parting_setup
    report = cs.greedy_check(torch, _truncating(fault), qm.quant_matmul_ref,
                             qp, prompt, LCFG, torch.device("cpu"),
                             max_len=128, family="llama")
    j0 = report["first_split_step"]
    assert j0 >= 1
    assert any(s["step"] == j0 and not s["within_one_step"]
               for s in report["differing_steps"])
    assert report["replays_reproduce"]
    assert report["decode_logit_err_over_span"] <= 0.05
    f64 = report["f64_calls"]
    assert report["ok"] is not fault, report
    assert f64["ok"] is not fault
    if fault:
        assert f64["first_outside"]["forward"] < j0
        assert f64["first_outside"]["forward"] == 0       # the prefill
    else:
        assert f64["kernel_max_bound_share"] <= 1.0


def _bf16_operands(M=6, K=256, N=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g).abs().to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    s = torch.rand(N, generator=g) * 1e-2 + 1e-4
    # column 0 near cancellation: x's two halves are equal and the
    # weight's halves opposite, but for one row of the second half
    h = K // 2
    x[:, h:] = x[:, :h]
    w[h:, 0] = -w[:h, 0]
    w[h, 0] = w[h, 0] + (1 if w[h, 0] < 127 else -1)
    # column 1 without cancellation: every product positive
    w[:, 1] = w[:, 1].abs().clamp_min(1)
    return x, w, s


def _sequential_f32(x, w, s):
    """The f32 sum of K exact products in row order, times the scale,
    rounded once to bf16: a correct kernel's arithmetic, in the order
    that errs most."""
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k in range(x.shape[1]):
        acc = acc + x[:, k:k + 1].float() * w[k].float()
    return (acc * s).to(torch.bfloat16)


def test_f64_bound_passes_a_correct_product():
    cs = _chip_smoke()
    x, w, s = _bf16_operands()
    oracle = cs.f64_oracle(torch, x, w, s)
    y64 = oracle[0]
    # the planted column cancels: its value is far below its |products|
    assert float(y64[:, 0].abs().max()) < 1e-2 * float(
        ((x.double().abs() @ w.double().abs()) * s.double())[:, 0].min())
    for y in (qm.quant_matmul_ref(x, w, s), _sequential_f32(x, w, s)):
        verdict = cs.f64_verdict(torch, y, oracle)
        assert verdict["ok"], verdict
        assert verdict["max_bound_share"] <= 1.0


def test_f64_bound_fails_a_dropped_split():
    cs = _chip_smoke()
    x, w, s = _bf16_operands(seed=1)
    K = x.shape[1]
    dropped = ((x[:, :K - 32].float() @ w[:K - 32].float()) * s).to(
        torch.bfloat16)
    verdict = cs.f64_verdict(torch, dropped, cs.f64_oracle(torch, x, w, s))
    assert not verdict["ok"] and verdict["max_bound_share"] > 10


def test_f64_bound_fails_two_bf16_steps_without_cancellation():
    cs = _chip_smoke()
    x, w, s = _bf16_operands(seed=2)
    y = qm.quant_matmul_ref(x, w, s)
    oracle = cs.f64_oracle(torch, x, w, s)
    assert cs.f64_verdict(torch, y, oracle)["ok"]
    bad = y.clone()
    bits = bad.view(torch.int16)
    bits[:, 1] += 2              # two bf16 steps up (positive values)
    verdict = cs.f64_verdict(torch, bad, oracle)
    assert not verdict["ok"] and verdict["max_ulps"] > 1.4
