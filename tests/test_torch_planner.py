"""The port's planner (paddle_tpu_torch/parallel/planner.py) against the
JAX package's (paddle_tpu/parallel/planner.py): on the same ChipSpec
figures and the same model shapes, the same plans, degrees, cost-model
fields (relative 1e-12), errors and constraint names, and the same
spec tables leaf by leaf. The port's own ChipSpec defaults are an H100
SXM's data-sheet figures."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel import planner as rp

from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.parallel import planner as tp
from paddle_tpu_torch.parallel.mesh import P

REF_CHIP = dataclasses.asdict(rp.ChipSpec())

# test_plan3d's GPT, bench.py's headline GPT, the TinyLlama-width Llama
MODELS = {
    "gpt_plan3d": dict(vocab_size=512, hidden_size=128, num_layers=2,
                       num_heads=4, seq_len=64, ffn_hidden=512,
                       sequence_parallel=False),
    "gpt_headline": dict(vocab_size=32768, hidden_size=1024, num_layers=24,
                         num_heads=16, seq_len=1024, ffn_hidden=4096),
    "llama_tiny": dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                       num_heads=32, seq_len=2048, ffn_hidden=5632,
                       sequence_parallel=False),
}


def _specs(name):
    kw = dict(MODELS[name])
    return rp.ModelSpec(**kw), tp.ModelSpec(**kw)


def _chips(**over):
    return rp.ChipSpec(**dict(REF_CHIP, **over)), tp.ChipSpec(
        **dict(REF_CHIP, **over))


def _close(a, b):
    return a == b or (math.isfinite(a) and math.isfinite(b)
                      and abs(a - b) <= 1e-12 * max(abs(a), abs(b)))


def _same_plan(r, t):
    for f in ("dp", "mp", "pp", "fsdp", "microbatches", "overlap", "fits"):
        assert getattr(r, f) == getattr(t, f), (f, r, t)
    assert _close(r.step_s, t.step_s), (r.step_s, t.step_s)
    assert _close(r.mem_bytes, t.mem_bytes), (r.mem_bytes, t.mem_bytes)
    assert r.breakdown.keys() == t.breakdown.keys()
    for k in r.breakdown:
        assert _close(r.breakdown[k], t.breakdown[k]), (k, r, t)
    assert repr(r) == repr(t)


def _same_train_plan(r, t):
    assert r.axes == t.axes and r.mapping == t.mapping
    assert tuple(r.batch_axes) == tuple(t.batch_axes)
    assert r.name == t.name and r.pp == t.pp
    assert r.microbatches == t.microbatches and r.overlap == t.overlap
    _same_plan(r.plan, t.plan)
    assert t.batch_spec(2) == P(*tuple(r.batch_spec(2)))


def _outcome(fn, *a, **kw):
    """("ok", result) or (error type name, message, constraint)."""
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return (type(e).__name__, str(e), getattr(e, "constraint", None))


def test_chip_defaults_are_h100_datasheet_figures():
    c = tp.ChipSpec()
    assert (c.peak_flops, c.hbm_bytes, c.hbm_bw, c.ici_bw) == (
        989e12, 80e9, 3.35e12, 450e9)
    # no TPU figure survives as a default
    for f in ("peak_flops", "hbm_bytes", "hbm_bw", "ici_bw", "dcn_bw"):
        assert getattr(c, f) != REF_CHIP[f], f
    assert [f.name for f in dataclasses.fields(tp.ChipSpec)] == list(
        REF_CHIP)


ENUM = [("gpt_plan3d", 8, 8, {}), ("gpt_headline", 8, 32, {}),
        ("llama_tiny", 8, 32, {}), ("gpt_headline", 16, 32,
                                    {"max_mp": 4}),
        ("llama_tiny", 4, 4, {"microbatches": 2}),
        ("gpt_headline", 8, 32, {"hbm_bytes": 2e9}),
        ("llama_tiny", 8, 32, {"hbm_bytes": 4e9})]


@pytest.mark.parametrize("name,n,batch,kw", ENUM,
                         ids=[f"{c[0]}-{c[1]}dev-b{c[2]}-{i}"
                              for i, c in enumerate(ENUM)])
def test_enumerate_and_plan_parallel_match_the_reference(name, n, batch,
                                                          kw):
    rs, ts = _specs(name)
    kw = dict(kw)
    rc, tc = _chips(**({"hbm_bytes": kw.pop("hbm_bytes")}
                       if "hbm_bytes" in kw else {}))
    r_plans = rp.enumerate_plans(rs, n, batch, rc, **kw)
    t_plans = tp.enumerate_plans(ts, n, batch, tc, **kw)
    assert len(r_plans) == len(t_plans) > 0
    for r, t in zip(r_plans, t_plans):
        _same_plan(r, t)
    _same_plan(rp.plan_parallel(rs, n, batch, rc, **kw),
               tp.plan_parallel(ts, n, batch, tc, **kw))


TRAIN = [
    ("gpt_plan3d", 8, 8, {}),
    ("gpt_plan3d", 8, 8, dict(dp=2, fsdp=2, tp=2)),
    ("gpt_plan3d", 8, 8, dict(dp=4, fsdp=1, tp=2, overlap=True)),
    ("gpt_plan3d", 4, 8, dict(dp=1, fsdp=1, tp=4)),
    ("gpt_headline", 8, 32, {}),
    ("gpt_headline", 8, 32, {"overlap": True}),
    ("llama_tiny", 8, 32, {}),
    ("llama_tiny", 2, 4, dict(dp=1, fsdp=1, tp=2)),
    ("llama_tiny", 2, 4, dict(dp=1, fsdp=2, tp=1)),
    # prime device counts: pp through the gate where layers allow, else
    # the named divisibility
    ("gpt_headline", 3, 32, {}),
    ("gpt_headline", 7, 32, {}),
    ("llama_tiny", 13, 32, {}),
    ("gpt_plan3d", 5, 8, {}),
    # the illegal degrees of tests/test_plan3d.py:98-104
    ("gpt_plan3d", 8, 8, dict(dp=1, fsdp=1, tp=8)),
    ("gpt_plan3d", 8, 8, dict(dp=2, fsdp=2, tp=1)),
    ("gpt_plan3d", 8, 9, dict(dp=4, fsdp=2, tp=1)),
    ("gpt_plan3d", 8, 8, dict(dp=1, fsdp=1, tp=1, pp=8)),
    ("gpt_plan3d", 8, 8, dict(dp=8, fsdp=1, tp=1, microbatches=2)),
    # explicit pp: priced and returned, as the reference does
    ("gpt_headline", 8, 32, dict(dp=2, fsdp=1, tp=2, pp=2)),
    ("gpt_headline", 8, 32, dict(dp=1, fsdp=1, tp=1, pp=8,
                                 microbatches=4)),
    # a pp>1 plan through the HBM gate: nothing fits flat
    ("gpt_headline", 8, 32, {"hbm_bytes": 1.5e9}),
    ("llama_tiny", 8, 32, {"hbm_bytes": 3e9}),
    ("gpt_headline", 8, 32, {"hbm_bytes": 0.5e9}),
]


@pytest.mark.parametrize("name,n,batch,kw", TRAIN,
                         ids=[f"{c[0]}-{c[1]}dev-b{c[2]}-{i}"
                              for i, c in enumerate(TRAIN)])
def test_plan_train_matches_the_reference(name, n, batch, kw):
    rs, ts = _specs(name)
    kw = dict(kw)
    rc, tc = _chips(**({"hbm_bytes": kw.pop("hbm_bytes")}
                       if "hbm_bytes" in kw else {}))
    r = _outcome(rp.plan_train, rs, n, batch, chip=rc, **kw)
    t = _outcome(tp.plan_train, ts, n, batch, chip=tc, **kw)
    assert r[0] == t[0], (r, t)
    if r[0] == "ok":
        _same_train_plan(r[1], t[1])
        assert r[1].specs is None and t[1].specs is None   # bare specs
    else:
        assert r[1:] == t[1:]


def test_hbm_gate_emits_pp():
    rs, ts = _specs("gpt_headline")
    got = [plan.plan_train(s, 8, 32, chip=c)
           for plan, s, c in ((rp, rs, _chips(hbm_bytes=1.5e9)[0]),
                              (tp, ts, _chips(hbm_bytes=1.5e9)[1]))]
    assert got[0].pp > 1 and got[1].pp == got[0].pp


BEST = [(10 ** 6, 8), (10 ** 9, 8), (10 ** 10, 8), (3 * 10 ** 9, 6),
        (10 ** 12, 7), (10 ** 9, 1)]


@pytest.mark.parametrize("count,n", BEST,
                         ids=[f"{c}-{n}" for c, n in BEST])
def test_best_mesh_axes_matches_the_reference(count, n):
    rc, tc = _chips()
    assert rp.best_mesh_axes(count, n, rc) == tp.best_mesh_axes(count, n,
                                                                tc)


FAMILIES = [
    ("gpt", dict(dp=2, fsdp=2, tp=2)), ("gpt", dict(dp=1, fsdp=1, tp=8)),
    ("gpt", dict(dp=1, fsdp=1, tp=2, pp=4)),
    ("llama", dict(dp=1, fsdp=2, tp=4)), ("llama", dict(dp=8, fsdp=1,
                                                        tp=1)),
]


@pytest.mark.parametrize("family,axes", FAMILIES,
                         ids=[f"{f}-" + "_".join(f"{k}{v}" for k, v in
                                                 a.items())
                              for f, a in FAMILIES])
def test_plan_specs_match_the_reference_leaf_by_leaf(family, axes):
    """Configs of each side plan over their own family's PARAM_SPECS
    (found through the config's module); the remapped tables agree leaf
    for leaf, as do the serving tables."""
    if family == "gpt":
        kw = dict(vocab_size=512, hidden_size=128, num_layers=8,
                  num_heads=8, max_seq_len=64)
        rcfg = jgpt.GPTConfig(**kw, dtype=jnp.float32)
        tcfg = tgpt.GPTConfig(**kw, dtype=torch.float32)
        rmod, tmod = jgpt, tgpt
    else:
        kw = dict(vocab_size=512, hidden_size=128, num_layers=8,
                  num_heads=8, num_kv_heads=2, max_seq_len=64)
        rcfg = jllama.LlamaConfig(**kw, dtype=jnp.float32)
        tcfg = tllama.LlamaConfig(**kw, dtype=torch.float32)
        rmod, tmod = jllama, tllama
    rc, tc = _chips()
    r = rp.plan_train(rcfg, 8, 16, chip=rc, **axes)
    t = tp.plan_train(tcfg, 8, 16, chip=tc, **axes)
    _same_train_plan(r, t)
    assert r.specs.keys() == t.specs.keys() == rmod.PARAM_SPECS.keys()
    for leaf, spec in r.specs.items():
        assert t.specs[leaf] == P(*tuple(spec)), leaf
    for leaf, spec in rmod.SERVING_PARAM_SPECS.items():
        assert tmod.SERVING_PARAM_SPECS[leaf] == P(*tuple(spec)), leaf
    # spec_from_config reads the same shape from either family's config
    assert dataclasses.asdict(tp.spec_from_config(tcfg)) == \
        dataclasses.asdict(rp.spec_from_config(rcfg))


def test_remap_and_tp_specs_follow_the_reference():
    from paddle_tpu.parallel import mesh as rmesh
    from paddle_tpu_torch.parallel import mesh as tmesh
    mapping = {"mp": "tp", "fsdp": "fsdp"}
    r = rmesh.remap_specs(jgpt.PARAM_SPECS, mapping)
    t = tmesh.remap_specs(tgpt.PARAM_SPECS, mapping)
    assert all(t[k] == P(*tuple(r[k])) for k in r)
    assert tmesh.tp_specs(tgpt.PARAM_SPECS) == tmesh.remap_specs(
        tgpt.PARAM_SPECS, {"mp": "tp"})
    for spec in (P(("dp", "fsdp"), None), P(("dp", "mp"), "pp"),
                 P("fsdp", ("mp",))):
        got = tmesh.remap_spec_axes(spec, {"dp": "d", "mp": "m"})
        want = rmesh.remap_spec_axes(
            rmesh.P(*spec), {"dp": "d", "mp": "m"})
        assert got == P(*tuple(want)), spec
    # the reference's equality rules
    assert P(("a",)) == P("a") and P("a") != P("a", None)
    assert P(None) != P() and P("a", None) == ("a", None)


def test_memory_ledger_matches_the_reference():
    from paddle_tpu import cost_model as rcm
    from paddle_tpu_torch import cost_model as tcm
    rs, ts = _specs("llama_tiny")
    for plan in (None, {"dp": 2, "fsdp": 2, "tp": 2},
                 {"fsdp": 4, "pp": 2, "microbatches": 4, "overlap": True}):
        r = rcm.train_memory_ledger(rs, plan, global_batch=16)
        t = tcm.train_memory_ledger(ts, plan, global_batch=16)
        assert r["config"] == t["config"]
        assert _close(r["total"], t["total"])
        for k, v in r["components"].items():
            assert _close(v, t["components"][k]), k
    assert np.isfinite(t["total"])
