"""Remat "dots_flash" under the attention kill switches: the plain
attention forward that PADDLE_TPU_DISABLE_PALLAS, _ATTN and
PADDLE_TPU_ATTN_IMPL=xla run goes through the named op
`paddle_tpu_torch::flash_fwd_plain`, which the policy saves as it saves
the kernel's op, so the backward reruns no attention: one plain forward
a layer a step, not two. The losses are those of the forward the
backward used to rerun, to the bit. The JAX package's "dots_flash"
saves its attention output by name on every route (its
save_only_these_names("flash_out")), and this is the port's form of it.

GPT at tests/test_torch_gpt_train.py's small shape, f32 on the CPU."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.models.facade import make_train_step

SHAPE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64)
L = SHAPE["num_layers"]
SWITCHES = [("PADDLE_TPU_DISABLE_PALLAS", "1"),
            ("PADDLE_TPU_DISABLE_PALLAS_ATTN", "true"),
            ("PADDLE_TPU_ATTN_IMPL", "xla"),
            ("PADDLE_TPU_DISABLE_PALLAS_BWD", "True")]


@pytest.fixture(autouse=True)
def _one_thread_no_switch(monkeypatch):
    for name, _ in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(policy, steps=3):
    """(losses, plain forwards a step) of `steps` train steps from one
    seeded state."""
    cfg = tg.GPTConfig(**SHAPE, dtype=torch.float32, remat=True,
                       remat_policy=policy)
    params = tg.init_gpt_params(cfg, seed=0, device="cpu")
    opt = tg.init_opt_state(params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, SHAPE["vocab_size"], size=(2, 33)))
    step = make_train_step(tg.train_step, cfg=cfg)
    losses, per_step = [], []
    for _ in range(steps):
        before = len(CALLS)
        losses.append(float(step(params, opt, tokens)[0]))
        per_step.append(len(CALLS) - before)
    return losses, per_step


CALLS = []


@pytest.fixture
def counted(monkeypatch):
    """Count the plain forward's runs (the op's CPU body reads
    `mha_fwd_ref` from the module at each call)."""
    plain = fa.mha_fwd_ref

    def counting(*a, **k):
        CALLS.append(1)
        return plain(*a, **k)
    CALLS.clear()
    monkeypatch.setattr(fa, "mha_fwd_ref", counting)
    return plain


@pytest.mark.parametrize("env,value", SWITCHES)
def test_dots_flash_runs_the_plain_forward_once_a_layer(
        monkeypatch, counted, env, value):
    monkeypatch.setenv(env, value)
    losses, per_step = _run("dots_flash")
    assert per_step == [L] * len(per_step)
    # the forward the backward used to rerun: the plain function called
    # outside any op, which the policy cannot name
    monkeypatch.setattr(fa, "_plain_fwd", lambda q, k, v, causal=False,
                        kv_len=None: fa.mha_fwd_ref(q, k, v, causal,
                                                    kv_len))
    before, per_step_before = _run("dots_flash")
    assert losses == before
    want = L if env == "PADDLE_TPU_DISABLE_PALLAS_BWD" else 2 * L
    assert per_step_before == [want] * len(per_step_before)


@pytest.mark.parametrize("env,value", SWITCHES[:3])
def test_other_policies_still_rerun_the_forward(monkeypatch, counted, env,
                                                value):
    """"full" and "dots" recompute the attention forward in the
    backward on the kill-switch route too, as they do through the
    kernel's op."""
    monkeypatch.setenv(env, value)
    for policy in ("full", "dots"):
        _, per_step = _run(policy, steps=1)
        assert per_step == [2 * L]


def test_the_plain_op_is_the_plain_forward():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 8),
                                                    dtype=np.float32))
               for _ in range(3))
    for causal, kv_len in ((True, None), (False, 11)):
        got = torch.ops.paddle_tpu_torch.flash_fwd_plain(q, k, v, causal,
                                                         kv_len)
        want = fa.mha_fwd_ref(q, k, v, causal, kv_len)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
