"""The port's selection surface against the JAX package's: the kill-switch
family and the attention selector (paddle_tpu_torch/kernels/
flash_attention.py against paddle_tpu/kernels/flash_attention.py), the
autotune cache (kernels/autotune.py against the reference's copy), the
forward's tile resolution, and the CE, AdamW and int8 gates. Both sides
run on the CPU backend class, with the same env and the same registry
table monkeypatched into both registries.
"""
import json
import os
import types

import pytest
import torch

from paddle_tpu.kernels import autotune as j_at
from paddle_tpu.kernels import flash_attention as j_fa
from paddle_tpu.kernels import registry as j_reg
from paddle_tpu_torch.kernels import autotune as t_at
from paddle_tpu_torch.kernels import flash_attention as t_fa
from paddle_tpu_torch.kernels import fused_update as t_fu
from paddle_tpu_torch.kernels import quant_matmul as t_qm
from paddle_tpu_torch.kernels import registry as t_reg
from paddle_tpu_torch.models import losses as t_losses

ENVS = ("PADDLE_TPU_DISABLE_PALLAS", "PADDLE_TPU_DISABLE_PALLAS_ATTN",
        "PADDLE_TPU_DISABLE_PALLAS_BWD", "PADDLE_TPU_DISABLE_PALLAS_CE",
        "PADDLE_TPU_DISABLE_PALLAS_UPDATE", "PADDLE_TPU_ATTN_IMPL",
        "PADDLE_TPU_FLASH_BLOCK_Q", "PADDLE_TPU_FLASH_BLOCK_K",
        "PADDLE_TPU_FLASH_BLOCK_BWD_Q", "PADDLE_TPU_FLASH_BLOCK_BWD_K",
        "PADDLE_TPU_AUTOTUNE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No switch, no registry table and an empty in-process autotune
    cache on either side, unless a test sets them."""
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)
    for at in (j_at, t_at):
        monkeypatch.setattr(at, "_CACHE", {})
        monkeypatch.setattr(at, "_loaded", True)
        monkeypatch.setattr(at, "_stats", {k: 0 for k in at._stats})
    _table(monkeypatch, {})


def _table(monkeypatch, table):
    """Serve `table` {(kernel, backend, bucket): impl} from both
    registries' winner(), with the reference's bucket-then-'*' rule."""
    def winner(kernel, backend=None, bucket="*", path=None):
        for b in dict.fromkeys((bucket, "*")):
            if (kernel, backend, b) in table:
                return table[(kernel, backend, b)]
        return None
    monkeypatch.setattr(j_reg, "winner", winner)
    monkeypatch.setattr(t_reg, "winner", winner)


ENV_GRID = [
    {},
    {"PADDLE_TPU_DISABLE_PALLAS": "1"},
    {"PADDLE_TPU_DISABLE_PALLAS": "true"},
    {"PADDLE_TPU_DISABLE_PALLAS": "True"},
    {"PADDLE_TPU_DISABLE_PALLAS": "0"},
    {"PADDLE_TPU_DISABLE_PALLAS": "yes"},
    {"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"},
    {"PADDLE_TPU_DISABLE_PALLAS_ATTN": "TRUE"},
    {"PADDLE_TPU_DISABLE_PALLAS_BWD": "true"},
    {"PADDLE_TPU_DISABLE_PALLAS_BWD": "1",
     "PADDLE_TPU_ATTN_IMPL": "splash"},
    {"PADDLE_TPU_ATTN_IMPL": "xla"},
    {"PADDLE_TPU_ATTN_IMPL": "pallas"},
    {"PADDLE_TPU_ATTN_IMPL": "jax_flash"},
    {"PADDLE_TPU_ATTN_IMPL": "splash"},
    {"PADDLE_TPU_ATTN_IMPL": "bogus"},
    {"PADDLE_TPU_DISABLE_PALLAS_CE": "1"},
]

TABLES = [
    {},
    {("attention", "cpu", "*"): "xla"},
    {("attention", "cpu", "S1024"): "splash",
     ("attention", "cpu", "*"): "xla"},
    {("attention", "tpu", "*"): "xla"},
]


@pytest.mark.parametrize("table", range(len(TABLES)))
@pytest.mark.parametrize("env", range(len(ENV_GRID)))
@pytest.mark.parametrize("use_pallas", [True, False])
def test_gates_and_impl_resolve_as_the_reference(monkeypatch, env, table,
                                                 use_pallas):
    for k, v in ENV_GRID[env].items():
        monkeypatch.setenv(k, v)
    _table(monkeypatch, TABLES[table])
    monkeypatch.setattr(j_fa, "use_pallas", use_pallas)
    monkeypatch.setattr(t_fa, "use_pallas", use_pallas)
    assert t_fa._pallas_enabled() == j_fa._pallas_enabled()
    for seq in (None, 1024, 100):
        got = (t_fa._attn_impl(seq), t_fa._pallas_attn_enabled(seq),
               t_fa._pallas_bwd_enabled(seq))
        want = (j_fa._attn_impl(seq), j_fa._pallas_attn_enabled(seq),
                j_fa._pallas_bwd_enabled(seq))
        assert got == want, (ENV_GRID[env], TABLES[table], seq)


@pytest.mark.parametrize("env", [
    {}, {"PADDLE_TPU_ATTN_IMPL": "splash"},
    {"PADDLE_TPU_ATTN_IMPL": "jax_flash"}, {"PADDLE_TPU_ATTN_IMPL": "xla"},
    {"PADDLE_TPU_ATTN_IMPL": "bogus"},
    {"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"},
    {"PADDLE_TPU_DISABLE_PALLAS_ATTN": "true"},
    {"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1", "PADDLE_TPU_ATTN_IMPL": "pallas"},
    {"PADDLE_TPU_ATTN_IMPL": "splash", "PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"},
])
def test_impl_from_winner_env_is_the_reference(env):
    assert t_fa.impl_from_winner_env(env) == j_fa.impl_from_winner_env(env)


def test_sweep_winner_applies_to_the_cuda_class_only(monkeypatch, tmp_path):
    path = tmp_path / "torch_sweep_winner.json"
    path.write_text(json.dumps({"env": {"PADDLE_TPU_DISABLE_PALLAS_ATTN":
                                        "1"}}))
    monkeypatch.setattr(t_fa, "SWEEP_WINNER_PATH", str(path))
    monkeypatch.setattr(t_fa, "_sweep_winner_impl", None)
    assert t_fa._winner_impl("cpu") is None
    assert t_fa._attn_impl(1024, "cpu") == "pallas"
    assert t_fa._winner_impl("cuda") == "xla"
    assert t_fa._attn_impl(1024, "cuda") == "xla"
    # the env outranks the sweep winner
    monkeypatch.setenv("PADDLE_TPU_ATTN_IMPL", "pallas")
    assert t_fa._attn_impl(1024, "cuda") == "pallas"


def test_missing_or_invalid_sweep_winner_gives_none(monkeypatch, tmp_path):
    monkeypatch.setattr(t_fa, "SWEEP_WINNER_PATH",
                        str(tmp_path / "absent.json"))
    monkeypatch.setattr(t_fa, "_sweep_winner_impl", None)
    assert t_fa._winner_impl("cuda") is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setattr(t_fa, "SWEEP_WINNER_PATH", str(bad))
    monkeypatch.setattr(t_fa, "_sweep_winner_impl", None)
    assert t_fa._winner_impl("cuda") is None
    # the registry comes next, by the device's class and bucket
    _table(monkeypatch, {("attention", "cuda", "S2048"): "xla"})
    assert t_fa._attn_impl(2048, "cuda") == "xla"
    assert t_fa._attn_impl(1024, "cuda") == "pallas"
    assert t_fa._attn_impl(2048, "cpu") == "pallas"


class TestKillSwitchLayering:
    """The reference's TestKillSwitchGates (tests/test_kernels.py:405-457)
    on the port: global > attention-only > backward-only, the CE on the
    global gate only."""

    def test_attn_kill_leaves_ce_enabled(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_DISABLE_PALLAS_ATTN", "1")
        assert not t_fa._pallas_attn_enabled()
        assert not t_fa._pallas_bwd_enabled()
        assert t_fa._pallas_enabled()
        assert t_losses._pallas_ce_enabled()

    def test_global_kill_covers_all(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_DISABLE_PALLAS", "1")
        assert not t_fa._pallas_enabled()
        assert not t_fa._pallas_attn_enabled()
        assert not t_fa._pallas_bwd_enabled()
        assert not t_losses._pallas_ce_enabled()

    def test_env_blocks_outrank_autotune_cache(self, monkeypatch):
        q = torch.zeros(8, 1024, 16, 64, dtype=torch.bfloat16)
        sig = t_fa._flash_sig(q, q, True)
        assert sig == "B8_Sq1024_Sk1024_H16_D64_c1_bfloat16"
        monkeypatch.setattr(t_at, "_CACHE", {f"flash_fwd::{sig}": [64, 64],
                                             f"flash_bwd::{sig}": [64, 64]})
        assert t_fa._tuned_blocks(q, q, True) == (64, 64)
        assert t_fa._tuned_blocks_bwd(q, q, True) == (64, 64)
        monkeypatch.setenv("PADDLE_TPU_FLASH_BLOCK_Q", "128")
        assert t_fa._tuned_blocks(q, q, True) is None
        assert t_fa._fwd_blocks(q, q, True) == (128, 64)
        assert t_fa._tuned_blocks_bwd(q, q, True) == (64, 64)
        monkeypatch.setenv("PADDLE_TPU_FLASH_BLOCK_BWD_K", "64")
        assert t_fa._tuned_blocks_bwd(q, q, True) is None

    @pytest.mark.parametrize("impl", ["pallas", "jax_flash", "splash",
                                      "xla"])
    def test_attn_impl_routes(self, monkeypatch, impl):
        """"jax_flash" and "splash" run the port's own flash path, as the
        reference routes them off TPU-class backends; "xla" runs the
        plain forward and backward instead of the given wrappers."""
        calls = []

        def fwd(*a, **k):
            calls.append("fwd")
            return t_fa.mha_fwd_ref(*a, **k)

        def bwd(*a, **k):
            calls.append("bwd")
            return t_fa.mha_bwd_ref(*a, **k)
        monkeypatch.setenv("PADDLE_TPU_ATTN_IMPL", impl)
        q = torch.randn(1, 8, 2, 16, requires_grad=True)
        t_fa.flash_attention_fn(q, q, q, causal=True, fwd=fwd,
                                bwd=bwd).sum().backward()
        assert calls == ([] if impl == "xla" else ["fwd", "bwd"])

    def test_bwd_kill_keeps_the_kernel_forward(self, monkeypatch):
        calls = []

        def fwd(*a, **k):
            calls.append("fwd")
            return t_fa.mha_fwd_ref(*a, **k)

        def bwd(*a, **k):
            calls.append("bwd")
            return t_fa.mha_bwd_ref(*a, **k)
        monkeypatch.setenv("PADDLE_TPU_DISABLE_PALLAS_BWD", "True")
        q = torch.randn(1, 8, 2, 16, requires_grad=True)
        t_fa.flash_attention_fn(q, q, q, causal=True, fwd=fwd,
                                bwd=bwd).sum().backward()
        assert calls == ["fwd"]


def test_route_is_resolved_once_per_apply(monkeypatch):
    """A switch set between a forward and its backward leaves that
    apply's backward on the route its forward resolved."""
    calls = []

    def bwd(*a, **k):
        calls.append("bwd")
        return t_fa.mha_bwd_ref(*a, **k)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = t_fa.flash_attention_fn(q, q, q, causal=True, bwd=bwd)
    monkeypatch.setenv("PADDLE_TPU_DISABLE_PALLAS", "1")
    out.sum().backward()
    assert calls == ["bwd"]


# --------------------------------------------------------------- autotune
CACHES = [
    {},
    {"flash_fwd::B8_Sq1024_Sk1024_H16_D64_c1_bfloat16": [128, 64]},
    {"flash_fwd::B8_Sq1024_Sk1024_H16_D64_c1_bfloat16": []},
    {"flash_fwd::B4_Sq1024_Sk1024_H16_D64_c1_bfloat16": [64, 64],
     "flash_fwd::B16_Sq1024_Sk1024_H16_D64_c1_bfloat16": [128, 64]},
    {"flash_fwd::B6_Sq1024_Sk1024_H16_D64_c1_bfloat16": [64, 64],
     "flash_fwd::B10_Sq1024_Sk1024_H16_D64_c1_bfloat16": [128, 64],
     "flash_fwd::B8_Sq2048_Sk2048_H16_D64_c1_bfloat16": [512, 512]},
    {"flash_fwd::B8_Sq1024_Sk1024_H16_D64_c1_bfloat16": [],
     "flash_fwd::B4_Sq1024_Sk1024_H16_D64_c1_bfloat16": [64, 64]},
    {"flash_fwd::Bx_Sq1024_Sk1024_H16_D64_c1_bfloat16": [64, 64],
     "flash_fwd::B2_Sq1024_Sk1024_H16_D64_c1_bfloat16": [],
     "flash_bwd::B8_Sq1024_Sk1024_H16_D64_c1_bfloat16": [64, 64],
     "other::B8_x": 3},
]
QUERIES = [("flash_fwd", "B8_Sq1024_Sk1024_H16_D64_c1_bfloat16"),
           ("flash_fwd", "B12_Sq1024_Sk1024_H16_D64_c1_bfloat16"),
           ("flash_fwd", "B2_Sq1024_Sk1024_H16_D64_c1_bfloat16"),
           ("flash_fwd", "B8_Sq2048_Sk2048_H16_D64_c1_bfloat16"),
           ("flash_bwd", "B8_Sq1024_Sk1024_H16_D64_c1_bfloat16"),
           ("flash_bwd", "B1_Sq1024_Sk1024_H16_D64_c1_bfloat16"),
           ("other", "B8_x"), ("flash_fwd", "nobatch"),
           ("flash_fwd", "Bq_Sq1024_Sk1024_H16_D64_c1_bfloat16")]


@pytest.mark.parametrize("cache", range(len(CACHES)))
def test_autotune_reads_give_the_reference_answers(monkeypatch, cache):
    for at in (j_at, t_at):
        monkeypatch.setattr(at, "_CACHE", dict(CACHES[cache]))
    for op, sig in QUERIES:
        assert t_at._read(op, sig) == j_at._read(op, sig), (op, sig)
        assert t_at.cached(op, sig) == j_at.cached(op, sig), (op, sig)
        assert t_at.cached_any_batch(op, sig) == \
            j_at.cached_any_batch(op, sig), (op, sig)


def test_pick_times_skips_failures_and_caches_the_winner(monkeypatch,
                                                         tmp_path):
    for at in (j_at, t_at):
        monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / f"{at.__name__}"
                                                   ".json"))
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "1")

    def runner(cand):
        if cand != (64, 64):
            raise RuntimeError("not built")
    for at in (j_at, t_at):
        assert at.pick("op", "B1_s", [(128, 64), (64, 64)], runner,
                       default=(128, 64)) == (64, 64)
        assert at.pick("op", "B1_s", [(128, 64), (64, 64)], runner) == \
            (64, 64)
    assert t_at.autotune_status()["tuned"] == 1
    assert t_at.autotune_status()["hits"] == 1
    assert json.loads(open(t_at._CACHE_PATH).read()) == \
        {"op::B1_s": [64, 64]}


def test_pick_never_caches_a_failed_pass(monkeypatch, tmp_path):
    monkeypatch.setattr(t_at, "_CACHE_PATH", str(tmp_path / "a.json"))
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "true")

    def runner(cand):
        raise RuntimeError("transient")
    assert t_at.pick("op", "B1_s", [(128, 64), (64, 64)], runner,
                     default=(128, 64)) == (128, 64)
    assert t_at._CACHE == {} and not os.path.exists(t_at._CACHE_PATH)
    # disabled tuning and an opt-out entry return the default untimed
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE")
    assert t_at.pick("op", "B1_s", [(128, 64)], runner) == (128, 64)
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "1")
    t_at._CACHE["op::B1_s"] = []
    assert t_at.pick("op", "B1_s", [(128, 64)], runner,
                     default=(64, 64)) == (64, 64)
    assert t_at.autotune_status()["misses"] == 2


def test_persist_writes_a_whole_file_by_tmp_and_rename(monkeypatch,
                                                       tmp_path):
    path = tmp_path / "sub" / "autotune.json"
    monkeypatch.setattr(t_at, "_CACHE_PATH", str(path))
    monkeypatch.setattr(t_at, "_CACHE", {"flash_fwd::B1_x": [64, 64]})
    seen = []
    real = os.replace

    def replace(src, dst):
        seen.append((src, dst, json.loads(open(src).read())))
        return real(src, dst)
    monkeypatch.setattr(os, "replace", replace)
    t_at._persist()
    assert seen == [(f"{path}.tmp{os.getpid()}", str(path),
                     {"flash_fwd::B1_x": [64, 64]})]
    assert json.loads(path.read_text()) == {"flash_fwd::B1_x": [64, 64]}
    assert sorted(os.listdir(path.parent)) == ["autotune.json"]


def test_clear_cache_and_status(monkeypatch, tmp_path):
    path = tmp_path / "autotune.json"
    path.write_text("{}")
    monkeypatch.setattr(t_at, "_CACHE_PATH", str(path))
    monkeypatch.setattr(t_at, "_CACHE", {"a::B1_x": [1]})
    st = t_at.autotune_status()
    assert st["cached"] == 1 and st["enabled"] is False
    assert st["foreign"] == 0
    t_at.clear_cache()
    assert t_at._CACHE == {} and not path.exists()


def test_cache_path_is_not_the_references(monkeypatch):
    if os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE"):
        pytest.skip("the cache path is set by the environment")
    assert t_at._CACHE_PATH.endswith(os.path.join("paddle_tpu_torch",
                                                  "autotune.json"))
    assert t_at._CACHE_PATH != j_at._CACHE_PATH


# ------------------------------------------------------------------ tiles
def _q(B=8, S=1024, H=16, D=64, dtype=torch.bfloat16):
    return torch.zeros(B, S, H, D, dtype=dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,causal", [((8, 1024, 16, 64), True),
                                          ((4, 2048, 32, 64), True),
                                          ((2, 100, 3, 128), False)])
def test_flash_signature_is_spelled_as_the_reference(shape, causal, dtype):
    import jax.numpy as jnp
    jq = jnp.zeros(shape, getattr(jnp, dtype))
    tq = torch.zeros(shape, dtype=getattr(torch, dtype))
    assert t_fa._flash_sig(tq, tq, causal) == j_fa._flash_sig(jq, jq,
                                                              causal)


def test_candidates_are_the_built_tiles():
    assert t_fa.flash_block_candidates(64, torch.bfloat16) == [(128, 64),
                                                                (64, 64)]
    assert t_fa.flash_block_candidates(16, torch.bfloat16)[0] == (128, 64)
    assert t_fa.flash_block_candidates(128, torch.bfloat16) == [(64, 64)]
    assert t_fa.flash_block_candidates(64, torch.float32) == [(64, 64)]


def test_default_tile_without_env_or_cache():
    assert t_fa._fwd_blocks(_q(), _q(), True) == (128, 64)
    assert t_fa._fwd_blocks(_q(D=128), _q(D=128), True) == (64, 64)
    assert t_fa._bwd_blocks(_q(), _q(), True) == (64, 64)


def test_cache_hit_and_any_batch_hit(monkeypatch):
    sig4 = t_fa._flash_sig(_q(B=4), _q(B=4), True)
    monkeypatch.setattr(t_at, "_CACHE", {f"flash_fwd::{sig4}": [64, 64]})
    assert t_fa._fwd_blocks(_q(B=4), _q(B=4), True) == (64, 64)
    assert t_fa._fwd_blocks(_q(B=8), _q(B=8), True) == (64, 64)
    assert t_fa._fwd_blocks(_q(B=8), _q(B=8), False) == (128, 64)


def test_a_foreign_cache_entry_is_skipped_and_counted(monkeypatch):
    """A TPU cache shared through the env names Pallas blocks: the
    kernels lack them, so the default tile runs."""
    q = _q()
    sig = t_fa._flash_sig(q, q, True)
    monkeypatch.setattr(t_at, "_CACHE", {f"flash_fwd::{sig}": [512, 256],
                                         f"flash_bwd::{sig}": [128, 128]})
    assert t_fa._fwd_blocks(q, q, True) == (128, 64)
    assert t_fa._bwd_blocks(q, q, True) == (64, 64)
    assert t_at.autotune_status()["foreign"] == 2
    monkeypatch.setattr(t_at, "_CACHE", {f"flash_fwd::{sig}": "fast"})
    assert t_fa._fwd_blocks(q, q, True) == (128, 64)
    assert t_at.autotune_status()["foreign"] == 3


@pytest.mark.parametrize("env,want", [
    ({"PADDLE_TPU_FLASH_BLOCK_Q": "64"}, (64, 64)),
    ({"PADDLE_TPU_FLASH_BLOCK_Q": "128"}, (128, 64)),
    ({"PADDLE_TPU_FLASH_BLOCK_K": "64"}, (128, 64)),
    ({"PADDLE_TPU_FLASH_BLOCK_Q": "64", "PADDLE_TPU_FLASH_BLOCK_K": "64"},
     (64, 64)),
])
def test_env_tile_outranks_the_cache(monkeypatch, env, want):
    q = _q()
    sig = t_fa._flash_sig(q, q, True)
    cached = [128, 64] if want == (64, 64) else [64, 64]
    monkeypatch.setattr(t_at, "_CACHE", {f"flash_fwd::{sig}": cached})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert t_fa._fwd_blocks(q, q, True) == want


@pytest.mark.parametrize("env,D,dtype", [
    ({"PADDLE_TPU_FLASH_BLOCK_Q": "256"}, 64, torch.bfloat16),
    ({"PADDLE_TPU_FLASH_BLOCK_K": "128"}, 64, torch.bfloat16),
    ({"PADDLE_TPU_FLASH_BLOCK_Q": "512",
      "PADDLE_TPU_FLASH_BLOCK_K": "512"}, 64, torch.bfloat16),
    ({"PADDLE_TPU_FLASH_BLOCK_Q": "128"}, 128, torch.bfloat16),
    ({"PADDLE_TPU_FLASH_BLOCK_Q": "128"}, 64, torch.float32),
    ({"PADDLE_TPU_FLASH_BLOCK_BWD_Q": "128"}, 64, torch.bfloat16),
])
def test_env_tile_the_kernels_lack_raises(monkeypatch, env, D, dtype):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    q = _q(D=D, dtype=dtype)
    blocks = (t_fa._bwd_blocks if any("BWD" in k for k in env)
              else t_fa._fwd_blocks)
    with pytest.raises(ValueError, match="tile"):
        blocks(q, q, True)


def test_explicit_tile_is_checked():
    q = _q()
    assert t_fa._fwd_blocks(q, q, True, 64, 64) == (64, 64)
    assert t_fa._fwd_blocks(q, q, True, block_q=64) == (64, 64)
    with pytest.raises(ValueError, match="tile"):
        t_fa._fwd_blocks(q, q, True, 256, 64)


def test_tuning_needs_the_card(monkeypatch):
    """A miss with tuning on times nothing off the card: the consult
    site keeps its default."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "1")
    assert t_fa._tuned_blocks(_q(), _q(), True) is None
    assert t_at._CACHE == {}


# ------------------------------------------------- CE, AdamW, int8 gates
_CARD = types.SimpleNamespace(device=torch.device("cuda"))


@pytest.mark.parametrize("env,want", [
    ({}, "pallas"),
    ({"PADDLE_TPU_DISABLE_PALLAS": "1"}, "jax"),
    ({"PADDLE_TPU_DISABLE_PALLAS_CE": "True"}, "jax"),
    ({"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"}, "pallas"),
    ({"PADDLE_TPU_DISABLE_PALLAS_UPDATE": "1"}, "pallas"),
])
def test_ce_route_honours_the_switches(monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert t_losses.ce_route(_CARD) == want
    assert t_losses.ce_route(torch.zeros(2, 8)) == "jax"
    _table(monkeypatch, {("ce", "cuda", "*"): "pallas_fused"})
    assert t_losses.ce_route(_CARD) == ("jax" if want == "jax"
                                        else "pallas_fused")


def test_ce_route_honours_use_pallas(monkeypatch):
    monkeypatch.setattr(t_fa, "use_pallas", False)
    assert t_losses.ce_route(_CARD) == "jax"


@pytest.mark.parametrize("env,want", [
    ({}, True), ({"PADDLE_TPU_DISABLE_PALLAS": "true"}, False),
    ({"PADDLE_TPU_DISABLE_PALLAS_UPDATE": "1"}, False),
    ({"PADDLE_TPU_DISABLE_PALLAS_CE": "1"}, True),
    ({"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"}, True),
])
def test_fused_update_gate_honours_the_switches(monkeypatch, env, want):
    _table(monkeypatch, {("fused_update", "cuda", "*"): "pallas"})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert t_fu.fused_update_enabled("cuda") is want
    assert t_fu.fused_update_enabled("cpu") is False


def test_fused_update_needs_the_registry(monkeypatch):
    assert t_fu.fused_update_enabled("cuda") is False
    _table(monkeypatch, {("fused_update", "cuda", "*"): "pallas"})
    monkeypatch.setattr(t_fa, "use_pallas", False)
    assert t_fu.fused_update_enabled("cuda") is False


@pytest.mark.parametrize("env,want", [
    ({}, "pallas"), ({"PADDLE_TPU_DISABLE_PALLAS": "1"}, "xla"),
    ({"PADDLE_TPU_DISABLE_PALLAS": "True"}, "xla"),
    ({"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"}, "pallas"),
    ({"PADDLE_TPU_QUANT": "int8"}, "pallas"),
])
def test_int8_site_honours_the_global_switch(monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert t_qm.matmul_impl("cuda") == want
    assert t_qm.matmul_impl("cpu") == "xla"
    # the switch leaves quantization alone
    assert t_qm.resolve_quant("int8", "cuda") is True


def test_int8_site_honours_use_pallas(monkeypatch):
    monkeypatch.setattr(t_fa, "use_pallas", False)
    assert t_qm.matmul_impl("cuda") == "xla"
