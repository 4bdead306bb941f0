"""Tensor-parallel serving in the port (inference/serving.py
`ServingEngine(mesh=, tp_axis=)`, parallel/layout.py `ServingLayout`,
kernels/decode_attention.py `cache_pspecs`, quantization/serving.py
`quant_specs`, parallel/planner.py `plan_serving_tp`) against the JAX
package, on the CPU.

In the test process:
- `plan_serving_tp` picks what the JAX function picks on a grid of
  (model, device count, slots, max_len);
- `cache_pspecs` and the int8 tree's specs equal the reference's
  (quantize_serving_params' qspecs).

One world of 2 gloo ranks, started once for the module, each rank an
engine on a tp2 mesh over the FULL numpy params (the ranks import this
module without jax), while the test process runs the JAX package's
unsharded engines on the same params and requests:
- every stream (greedy and temperature/top-k sampled rows in one batch)
  equals the JAX engine's, for GPT and Llama, dense, paged (chunked
  prefill, prefix sharing, copy-on-write), spec decode, paged spec and
  K = 4; the int8 Llama engine and an MQA Llama (1 KV head) greedy;
- both ranks' streams are identical, with one host pull a dispatch
  (counted on the tensor methods that pull) and one an admission, and
  each forward pass issues two all-reduces a layer plus the embedding's
  and the logits' collective;
- every parameter and cache shard has the shape its spec gives; GPT's
  qkv shard holds its heads' q, k and v; an int8 scale splits with a
  column-parallel weight and stays whole beside a row-parallel one; the
  MQA cache stays whole on each rank;
- a mesh without a tp axis is refused; a K >= 2 engine on the host
  route two ranks sharing a card take raises naming it; the facade's
  engine cache tells a tp engine from the single-device one;
- the fleet over tp engines (inference/autoscale.py, router.py): the
  preempt guard under `replica_preempt@4:1` degrades tp2 -> tp1 through
  the planner and `rebuild_on_mesh` keeps the survivor's live streams
  equal to the JAX unsharded engine's, with one pull a dispatch after
  it, while the rank that left retires its engine; a direct rebuild
  onto tp1, dense and paged with chunked prefill, moves every decoding
  stream and evicts only the mid-prefill one; a router over two tp2
  replicas survives `replica_preempt@3:0` by live migration, both ranks'
  streams identical and equal to the JAX engine's.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import planner as tplanner

V, MAXLEN, PS = 64, 64, 8
GPT_SHAPE = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=2,
                 ffn_hidden=64, max_seq_len=128)
LLAMA_SHAPE = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=4,
                   num_kv_heads=2, max_seq_len=128)
MQA_SHAPE = dict(LLAMA_SHAPE, num_kv_heads=1)
MIX = [(0.9, 5), (0.0, 0), (1.1, 0), (0.7, 3), (1.0, 0)]
GREEDY = [(0.0, 0)] * 5
SPEC = dict(spec_decode="spec", gamma=2, draft_layers=1)
PAGED = dict(kv_layout="paged", page_size=PS, prefill_chunk=PS)
# name -> (family, shape, engine knobs, quant, request mix)
CASES = {
    "gpt-dense": ("gpt", GPT_SHAPE, {}, "off", MIX),
    "gpt-paged": ("gpt", GPT_SHAPE, PAGED, "off", MIX),
    "gpt-spec": ("gpt", GPT_SHAPE, SPEC, "off", MIX),
    "gpt-paged_spec": ("gpt", GPT_SHAPE, dict(PAGED, **SPEC), "off", MIX),
    "gpt-k4": ("gpt", GPT_SHAPE, dict(multi_tick=4), "off", MIX),
    "llama-dense": ("llama", LLAMA_SHAPE, {}, "off", MIX),
    "llama-paged": ("llama", LLAMA_SHAPE, PAGED, "off", MIX),
    "llama-spec": ("llama", LLAMA_SHAPE, SPEC, "off", MIX),
    "llama-paged_spec": ("llama", LLAMA_SHAPE, dict(PAGED, **SPEC), "off",
                         MIX),
    "llama-k4": ("llama", LLAMA_SHAPE, dict(multi_tick=4), "off", MIX),
    "llama-int8": ("llama", LLAMA_SHAPE, {}, "int8", GREEDY),
    "gpt-int8_paged": ("gpt", GPT_SHAPE, PAGED, "int8", GREEDY),
    "llama-mqa": ("llama", MQA_SHAPE, {}, "off", GREEDY),
}
LENS = [5, 9, 14, 6, 11]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    rng = np.random.RandomState(42)
    base = [rng.randint(0, V, n).astype(np.int32) for n in LENS]
    # a shared 8-token prefix on two prompts: the paged pool shares and
    # copies its page
    base[3] = np.concatenate([base[1][:8], base[3]])
    return base


def _numpy_params(family, shape):
    """Matmul weights and tables at std 0.3, scales near 1 (a tiny model
    at the default init repeats one token), from the port's own init's
    leaf shapes."""
    from paddle_tpu_torch.models import gpt, llama
    if family == "gpt":
        cfg = gpt.GPTConfig(**shape, dtype=torch.float32)
        shapes = {k: v.shape for k, v in
                  gpt.init_gpt_params(cfg, 0, "cpu").items()}
    else:
        cfg = llama.LlamaConfig(**shape, dtype=torch.float32, remat=False)
        shapes = {k: v.shape for k, v in
                  llama.init_llama_params(cfg, 0, "cpu").items()}
    rng = np.random.RandomState(0)
    out = {}
    for k, shp in sorted(shapes.items()):
        if k.endswith("_w") or k in ("wte", "wpe"):
            out[k] = rng.randn(*shp).astype(np.float32) * 0.3
        elif k.endswith("_b") or k.endswith("bias"):
            out[k] = rng.randn(*shp).astype(np.float32) * 0.02
        else:
            out[k] = (1.0 + 0.1 * rng.randn(*shp)).astype(np.float32)
    return out


def _tcfg(family, shape):
    from paddle_tpu_torch.models import gpt, llama
    if family == "gpt":
        return gpt.GPTConfig(**shape, dtype=torch.float32)
    return llama.LlamaConfig(**shape, dtype=torch.float32, remat=False)


# the tensor methods that bring a tensor's values to the host: on the
# card each is a device-to-host pull (the engine's device tensors are
# CPU tensors here, and stand for the card's; `.numpy()` is left out,
# since on the card it only reads a tensor `.cpu()` already pulled)
_PULL_METHODS = ("cpu", "item", "tolist", "__int__", "__float__",
                 "__bool__", "__index__")


class _CountPulls:
    """Counts every call of a _PULL_METHODS method on a tensor while
    entered; `n` the count so far."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        self._saved = {m: getattr(torch.Tensor, m) for m in _PULL_METHODS}

        def counted(f):
            def call(t, *a, **kw):
                self.n += 1
                return f(t, *a, **kw)
            return call
        for m, f in self._saved.items():
            setattr(torch.Tensor, m, counted(f))
        return self

    def __exit__(self, *exc):
        for m, f in self._saved.items():
            setattr(torch.Tensor, m, f)


def _drive(eng, mix, n_layers):
    """The requests served to the end -> (streams, the host pulls of
    each decode dispatch, all host pulls, the forward passes' depths,
    the collectives the layout issued). The engine's forward is wrapped
    to record each pass's depth (a spec draft runs draft_layers) and its
    decode step to count the pulls inside it."""
    import dataclasses
    base = eng.family
    passes, per_dispatch = [], []

    def fwd(*a, layers=None, **kw):
        passes.append(n_layers if layers is None else int(layers))
        return base.forward_cached(*a, layers=layers, **kw)
    eng.family = dataclasses.replace(base, forward_cached=fwd)
    decode = eng._decode

    def counted_decode(events):
        before = pulls.n
        decode(events)
        per_dispatch.append(pulls.n - before)
    eng._decode = counted_decode
    reqs = [eng.submit(p, 10, temperature=t, top_k=k)
            for p, (t, k) in zip(_prompts(), mix)]
    c0 = eng._layout.collectives
    with _CountPulls() as pulls:
        while eng.has_work():
            eng.step()
    return ([list(map(int, r.tokens)) for r in reqs], per_dispatch,
            pulls.n, passes, eng._layout.collectives - c0)


# ------------------------------------------------------------ rank side
def _rank_case(mesh, name):
    from paddle_tpu_torch.inference import ServingEngine
    family, shape, kw, quant, mix = CASES[name]
    params = _numpy_params(family, shape)
    eng = ServingEngine(params, _tcfg(family, shape), family=family,
                        num_slots=3, max_len=MAXLEN, max_top_k=8, seed=3,
                        quant=quant, mesh=mesh, device="cpu", **kw)
    streams, per_dispatch, pulls, passes, collectives = _drive(
        eng, mix, shape["num_layers"])
    full = eng._full_shapes
    return {"streams": streams, "pulls_by_dispatch": per_dispatch,
            "pulls": pulls, "passes": passes,
            "ticks": eng.counters["decode_ticks"],
            "collectives": collectives,
            "param_shapes": {k: tuple(v.shape)
                             for k, v in eng._params.items()},
            "param_want": {k: pin.local_shape(full[k])
                           for k, pin in eng._param_pins.items()},
            "param_specs": {k: tuple(pin.spec)
                            for k, pin in eng._param_pins.items()},
            "cache_shapes": {k: tuple(v.shape)
                             for k, v in eng._cache.items()},
            "cache_specs": {k: tuple(pin.spec)
                            for k, pin in eng._cache_pins.items()},
            "qkv": (eng._params["qkv_w"].numpy()
                    if "qkv_w" in eng._params else None),
            "full_qkv": params.get("qkv_w")}


def _rank_refusals(mesh):
    import torch.distributed as dist
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import LlamaModel
    from paddle_tpu_torch.models.convert import params_from_jax
    from paddle_tpu_torch.parallel.mesh import build_mesh
    out = {}
    params = _numpy_params("llama", LLAMA_SHAPE)
    cfg = _tcfg("llama", LLAMA_SHAPE)
    dp = build_mesh({"dp": dist.get_world_size()}, device_type="cpu")
    try:
        ServingEngine(params, cfg, family="llama", mesh=dp, device="cpu")
        out["no_tp"] = None
    except ValueError as e:
        out["no_tp"] = str(e)
    from paddle_tpu_torch.parallel import collective
    keep = collective.collective_route
    collective.collective_route = \
        lambda group=None, device=None: "gloo_cuda_via_all_reduce"
    try:
        ServingEngine(params, cfg, family="llama", mesh=mesh, device="cpu",
                      multi_tick=2)
        out["k2_host_route"] = None
    except NotImplementedError as e:
        out["k2_host_route"] = str(e)
    finally:
        collective.collective_route = keep
    # the facade's engine cache: a tp engine is its own, same streams
    model = LlamaModel(cfg, device="cpu",
                       params=params_from_jax(params, "cpu"))
    prompts = _prompts()[:2]
    plain = model.generate(prompts, 4, num_slots=2, max_len=MAXLEN)
    eng_plain = model._engine
    tp = model.generate(prompts, 4, num_slots=2, max_len=MAXLEN, mesh=mesh)
    eng_tp = model._engine
    model.generate(prompts, 4, num_slots=2, max_len=MAXLEN, mesh=mesh)
    out["facade"] = {"distinct": eng_tp is not eng_plain,
                     "tp": eng_tp.tp, "reused": model._engine is eng_tp,
                     "same": all(np.array_equal(a, b)
                                 for a, b in zip(plain, tp))}
    model.generate(prompts, 4, num_slots=2, max_len=MAXLEN)
    out["facade"]["back"] = model._engine.mesh is None
    return out


# the fleet on the tp world (tests/test_autoscale.py TestPreemptGuard
# and the tp case of TestLiveMigration, at tp2 -> tp1): name ->
# (prompt lengths, prompt seed, engine knobs)
FLEET_NEW = 16
FLEET = {"guard": ([5, 9], 19, {}),
         "dense": ([5, 9, 13], 20, {}),
         "paged": ([5, 9, 13], 20, dict(kv_layout="paged", page_size=8,
                                        prefill_chunk=4)),
         "router": ([5, 9, 7, 6], 11, {})}


def _fleet_prompts(name):
    lens, seed, _ = FLEET[name]
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).astype(np.int32) for n in lens]


def _fleet_engine(mesh, name, **kw):
    from paddle_tpu_torch.inference import ServingEngine
    return ServingEngine(_numpy_params("gpt", GPT_SHAPE),
                         _tcfg("gpt", GPT_SHAPE), family="gpt",
                         max_len=32, mesh=mesh, device="cpu",
                         **FLEET[name][2], **kw)


def _rank_fleet(mesh):
    """The preempt guard's drill, the direct rebuilds and the tp router
    on this rank."""
    from paddle_tpu_torch.inference import EnginePreemptGuard, create_router
    from paddle_tpu_torch.parallel.mesh import build_mesh
    from paddle_tpu_torch.testing import faults
    out = {}
    eng = _fleet_engine(mesh, "guard", num_slots=3)
    reqs = [eng.submit(p, FLEET_NEW) for p in _fleet_prompts("guard")]
    guard = EnginePreemptGuard(eng, lease_timeout_s=5.0)
    faults.install("replica_preempt@4:1", once_dir=None)
    new_tp, pulls, post, polls = 0, None, 0, 0
    try:
        while eng.has_work():
            eng.step()
            if pulls is not None:
                post += 1
            tp = guard.poll()
            polls += 1
            if tp:
                new_tp = tp
                pulls = [0]
                pull = eng._pull

                def counted(value, stall_s=0.0, pull=pull, n=pulls):
                    n[0] += 1
                    return pull(value, stall_s)
                eng._pull = counted
    finally:
        faults.uninstall()
    out["guard"] = {"new_tp": new_tp, "tp": eng.tp, "polls": polls,
                    "pulls": pulls[0] if pulls else None,
                    "post_ticks": post, "has_work": eng.has_work(),
                    "retired": eng._retired,
                    "cache_heads": (None if eng._cache is None
                                    else tuple(eng._cache["k"].shape)),
                    "streams": [list(map(int, r.tokens)) for r in reqs],
                    "reasons": [r.finish_reason for r in reqs]}
    for name in ("dense", "paged"):
        eng = _fleet_engine(mesh, name, num_slots=3)
        reqs = [eng.submit(p, FLEET_NEW) for p in _fleet_prompts(name)]
        for _ in range(6):
            eng.step()
        n = eng.rebuild_on_mesh(build_mesh({"tp": 1}, devices=[0],
                                           device_type="cpu"))
        while eng.has_work():
            eng.step()
        out[name] = {"moved": n, "tp": eng.tp, "has_work": eng.has_work(),
                     "retired": eng._retired,
                     "streams": [list(map(int, r.tokens)) for r in reqs],
                     "reasons": [r.finish_reason for r in reqs]}
    router = create_router(_numpy_params("gpt", GPT_SHAPE),
                           _tcfg("gpt", GPT_SHAPE), replicas=2,
                           family="gpt", meshes=[mesh, mesh], num_slots=4,
                           max_len=32, concurrent=True, device="cpu")
    mig0 = router._m_mig.value
    faults.install("replica_preempt@3:0", once_dir=None)
    try:
        reqs = [router.submit(p, 14) for p in _fleet_prompts("router")]
        router.drain()
    finally:
        faults.uninstall()
    out["router"] = {"migrations": router._m_mig.value - mig0,
                     "requeues": [r.requeues for r in reqs],
                     "live": len(router.live()),
                     "streams": [list(map(int, r.tokens)) for r in reqs],
                     "reasons": [r.finish_reason for r in reqs]}
    return out


def _rank_main(rank, world, workdir):
    torch.set_num_threads(1)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import init_parallel_env
    from paddle_tpu_torch.parallel.mesh import build_mesh
    init_parallel_env(backend="gloo", timeout_s=120,
                      init_method=f"file://{workdir}/store")
    mesh = build_mesh({"tp": world}, device_type="cpu")
    out = {}
    try:
        for name in CASES:
            out[name] = _rank_case(mesh, name)
        out["refusals"] = _rank_refusals(mesh)
        out["fleet"] = _rank_fleet(mesh)
    except BaseException as e:                  # recorded for the test
        out["error"] = repr(e)
    finally:
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()


# ----------------------------------------------------------- test side
def _jax_streams(name):
    import jax.numpy as jnp
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.models import llama as jl
    family, shape, kw, quant, mix = CASES[name]
    params = _numpy_params(family, shape)
    if family == "gpt":
        jc = jgpt.GPTConfig(**shape, sequence_parallel=False, remat=False,
                            dtype=jnp.float32)
    else:
        jc = jl.LlamaConfig(**shape, dtype=jnp.float32, remat=False)
    eng = JaxEngine(params, jc, family=family, num_slots=3, max_len=MAXLEN,
                    max_top_k=8, seed=3, quant=quant, **kw)
    reqs = [eng.submit(p, 10, temperature=t, top_k=k)
            for p, (t, k) in zip(_prompts(), mix)]
    eng.drain()
    return [list(map(int, np.asarray(r.tokens))) for r in reqs]


def _jax_fleet_streams():
    """The JAX unsharded engine's greedy streams of every fleet case."""
    import jax.numpy as jnp
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    from paddle_tpu.models import gpt as jgpt
    jc = jgpt.GPTConfig(**GPT_SHAPE, sequence_parallel=False, remat=False,
                        dtype=jnp.float32)
    eng = JaxEngine(_numpy_params("gpt", GPT_SHAPE), jc, family="gpt",
                    num_slots=4, max_len=32)
    return {name: [list(map(int, t)) for t in eng.generate(
        _fleet_prompts(name), 14 if name == "router" else FLEET_NEW)]
        for name in FLEET}


@pytest.fixture(scope="module")
def world():
    """The 2-rank world's results beside the JAX engines' streams (run
    while the ranks work)."""
    import multiprocessing as mp
    workdir = tempfile.mkdtemp(prefix="torch_tp_serving_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, workdir))
             for r in range(2)]
    for p in procs:
        p.start()
    jax_out = {name: _jax_streams(name) for name in CASES}
    jax_out["fleet"] = _jax_fleet_streams()
    for p in procs:
        p.join(300)
        if p.is_alive():
            p.kill()
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    for r in ranks:
        assert "error" not in r, r["error"]
    return {"ranks": ranks, "jax": jax_out}


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_streams_equal_jax_unsharded(world, name):
    want = world["jax"][name]
    for r in world["ranks"]:
        assert r[name]["streams"] == want, name


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_streams_identical_one_pull_a_dispatch(world, name):
    a, b = (r[name] for r in world["ranks"])
    assert a["streams"] == b["streams"]
    for r in (a, b):
        assert r["ticks"] == a["ticks"] > 0
        # exactly one host pull inside each decode dispatch, and one for
        # each request's admission (its first token), nowhere else
        assert r["pulls_by_dispatch"] == [1] * r["ticks"]
        assert r["pulls"] == r["ticks"] + len(LENS)
        # each forward pass: two all-reduces a layer it runs (a spec
        # draft runs draft_layers), the embedding's all-reduce and the
        # logits' gather
        assert r["passes"] == a["passes"]
        assert r["collectives"] == sum(2 * n + 2 for n in r["passes"])


@pytest.mark.parametrize("name", ["gpt-dense", "llama-dense", "llama-int8",
                                  "gpt-int8_paged", "llama-mqa"])
def test_each_shard_has_the_shape_its_spec_gives(world, name):
    for r in world["ranks"]:
        res = r[name]
        assert res["param_shapes"] == res["param_want"]
        for k, shp in res["cache_shapes"].items():
            if k != "pt":
                assert shp[3] in (1, 2), (k, shp)


def test_specs_split_column_row_and_vocab(world):
    specs = world["ranks"][0]["llama-dense"]["param_specs"]
    assert specs["q_w"] == (None, None, "tp")
    assert specs["k_w"] == (None, None, "tp")
    assert specs["o_w"] == (None, "tp", None)
    assert specs["down_w"] == (None, "tp", None)
    assert specs["wte"] == ("tp", None)
    assert specs["norm_f"] == (None,)
    shapes = world["ranks"][0]["llama-dense"]["param_shapes"]
    assert shapes["q_w"] == (2, 32, 16) and shapes["o_w"] == (2, 16, 32)
    assert shapes["wte"] == (32, 32)
    cache = world["ranks"][0]["llama-dense"]["cache_shapes"]
    assert cache["k"] == (2, 3, MAXLEN, 1, 8)       # KV 2 over tp 2
    paged = world["ranks"][0]["llama-paged"]
    assert paged["cache_specs"]["pt"] == ()
    assert paged["cache_shapes"]["k"][3] == 1
    assert paged["cache_shapes"]["pt"][0] == 3       # the table whole


def test_int8_scales_split_with_column_weights_only(world):
    specs = world["ranks"][0]["llama-int8"]["param_specs"]
    shapes = world["ranks"][0]["llama-int8"]["param_shapes"]
    assert specs["q_w_q"] == (None, None, "tp")
    assert specs["q_w_scale"] == (None, "tp")
    assert specs["o_w_q"] == (None, "tp", None)
    assert specs["o_w_scale"] == (None, None)
    assert specs["head_q"] == (None, "tp")
    assert specs["head_scale"] == ("tp",)
    assert shapes["q_w_scale"] == (2, 16) and shapes["o_w_scale"] == (2, 32)
    assert shapes["head_q"] == (32, 32)


def test_gpt_qkv_shard_holds_its_heads(world):
    """GPT's fused qkv is stored head-grouped: rank r's 3D/tp columns
    are its heads' q, k and v columns of the full leaf."""
    for rank, r in enumerate(world["ranks"]):
        res = r["gpt-dense"]
        full, got = res["full_qkv"], res["qkv"]
        D = full.shape[1]
        per = D // 2
        cols = np.concatenate([np.arange(part * D + rank * per,
                                         part * D + (rank + 1) * per)
                               for part in range(3)])
        np.testing.assert_array_equal(got, full[..., cols])


def test_mqa_keeps_the_cache_and_kv_weights_whole(world):
    for r in world["ranks"]:
        res = r["llama-mqa"]
        assert res["cache_shapes"]["k"] == (2, 3, MAXLEN, 1, 8)
        assert "tp" not in res["param_specs"]["k_w"]
        assert res["param_shapes"]["k_w"] == (2, 32, 8)
        assert res["param_shapes"]["q_w"] == (2, 32, 16)


def test_mesh_without_tp_axis_is_refused(world):
    msg = world["ranks"][0]["refusals"]["no_tp"]
    assert msg is not None and "has no 'tp' axis" in msg


def test_multi_tick_on_the_host_route_raises_naming_it(world):
    msg = world["ranks"][0]["refusals"]["k2_host_route"]
    assert msg is not None and "gloo_cuda_via_all_reduce" in msg


def test_facade_engine_cache_key_differs_by_mesh(world):
    for r in world["ranks"]:
        f = r["refusals"]["facade"]
        assert f == {"distinct": True, "tp": 2, "reused": True,
                     "same": True, "back": True}


# ------------------------------------------------ in the test process
GRID_MODELS = {
    "gpt_small": dict(vocab_size=32768, hidden_size=1024, num_layers=24,
                      num_heads=16, seq_len=1024, ffn_hidden=4096),
    "llama_tiny": dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                       num_heads=32, seq_len=2048, ffn_hidden=5632),
    "gpt_6p7b": dict(vocab_size=50304, hidden_size=4096, num_layers=32,
                     num_heads=32, seq_len=2048, ffn_hidden=16384),
    "big_70b": dict(vocab_size=32000, hidden_size=8192, num_layers=80,
                    num_heads=64, seq_len=4096, ffn_hidden=28672),
}


@pytest.mark.parametrize("model", list(GRID_MODELS))
def test_plan_serving_tp_picks_equal_jax(model):
    import dataclasses
    from paddle_tpu.parallel import planner as rp
    chip = dataclasses.asdict(rp.ChipSpec())
    rs = rp.ModelSpec(**GRID_MODELS[model])
    ts = tplanner.ModelSpec(**GRID_MODELS[model])
    rc, tc = rp.ChipSpec(**chip), tplanner.ChipSpec(**chip)
    picks = set()
    for n in (1, 2, 4, 8):
        for slots in (1, 8, 64):
            for max_len in (None, 512, 8192):
                want = rp.plan_serving_tp(rs, n, slots, max_len, chip=rc)
                got = tplanner.plan_serving_tp(ts, n, slots, max_len,
                                               chip=tc)
                assert got == want, (n, slots, max_len)
                picks.add(got["tp"])
    if model == "big_70b":
        assert picks - {1}          # a model past one chip forces tp > 1


def test_plan_serving_tp_on_the_port_chip():
    """The port's own ChipSpec (an H100): TinyLlama fits one card, so 1
    device picks tp 1 and 2 devices pick by the model's latency terms."""
    ts = tplanner.spec_from_config(_tcfg("llama", dict(
        vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32,
        num_kv_heads=4, max_seq_len=2048)))
    assert tplanner.plan_serving_tp(ts, 1, 8, 2048) == {"tp": 1}
    assert tplanner.plan_serving_tp(ts, 2, 8, 2048)["tp"] in (1, 2)


@pytest.mark.parametrize("paged", [False, True])
def test_cache_pspecs_equal_the_reference(paged):
    from paddle_tpu.kernels.decode_attention import cache_pspecs as ref
    from paddle_tpu_torch.kernels.decode_attention import cache_pspecs
    want = ref(paged, "tp")
    got = cache_pspecs(paged, "tp")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_quant_specs_equal_the_reference_qspecs(family):
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.models import llama as jl
    from paddle_tpu.quantization.serving import (
        quantize_serving_params as jquant)
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.quantization.serving import (
        quant_specs, quantize_serving_params)
    shape = GPT_SHAPE if family == "gpt" else LLAMA_SHAPE
    params = _numpy_params(family, shape)
    jspecs = (jgpt if family == "gpt" else jl).SERVING_PARAM_SPECS
    tspecs = (tgpt if family == "gpt" else tl).SERVING_PARAM_SPECS
    _, want, _ = jquant(params, family, specs=jspecs)
    qparams, _ = quantize_serving_params(params, family)
    got = quant_specs(tspecs, qparams)
    for k in qparams:
        assert tuple(got.get(k, ())) == tuple(want.get(k, ())), k


# ------------------------------------------------- the fleet over tp engines
def test_preempt_guard_degrades_tp2_to_tp1_streams_survive(world):
    """tests/test_autoscale.py TestPreemptGuard's acceptance drill at tp2
    -> tp1: the guard rebuilds through the planner on the rank that
    stays, its streams equal the JAX unsharded engine's, one pull a
    dispatch after the rebuild; the rank that left retires."""
    want = world["jax"]["fleet"]["guard"]
    stay, left = (r["fleet"]["guard"] for r in world["ranks"])
    assert stay["new_tp"] == left["new_tp"] == 1
    assert stay["tp"] == 1 and not stay["retired"]
    assert stay["pulls"] == stay["post_ticks"] > 0
    assert stay["cache_heads"][3] == GPT_SHAPE["num_heads"]
    assert stay["streams"] == want
    assert stay["reasons"] == ["length"] * len(want)
    assert left["retired"] and not left["has_work"]
    assert left["cache_heads"] is None
    assert set(left["reasons"]) == {"migrated"}
    # up to the rebuild both ranks served the same tokens
    for a, b in zip(left["streams"], stay["streams"]):
        assert b[:len(a)] == a


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_rebuild_on_mesh_moves_decoding_streams(world, layout):
    """TestPreemptGuard.test_rebuild_on_mesh_direct at tp2 -> tp1: every
    decoding stream moves in place and equals the JAX engine's; only a
    request still mid-prefill ends "evicted"."""
    want = world["jax"]["fleet"][layout]
    stay, left = (r["fleet"][layout] for r in world["ranks"])
    assert stay["moved"] >= 2 and left["moved"] == 0
    assert left["retired"] and not left["has_work"]
    survived = 0
    for got, w, why in zip(stay["streams"], want, stay["reasons"]):
        if why == "evicted":
            continue
        assert why == "length" and got == w
        survived += 1
    assert survived == stay["moved"]


def test_router_over_tp_replicas_survives_replica_preempt(world):
    """A router over two tp2 replicas on both ranks: replica 0's
    preemption at tick 3 migrates its live streams into replica 1's
    shards on each rank, and every stream equals the JAX engine's."""
    want = world["jax"]["fleet"]["router"]
    a, b = (r["fleet"]["router"] for r in world["ranks"])
    assert a["streams"] == b["streams"] == want
    for r in (a, b):
        assert r["migrations"] > 0 and r["live"] == 1
        assert r["requeues"] == [0] * len(want)
        assert r["reasons"] == ["length"] * len(want)
