"""Auto-parallel planner: cost-model search over hybrid degrees — the
port's counterpart of paddle_tpu/parallel/planner.py (`NoFeasiblePlanError`
:32, `ChipSpec` :44, `ModelSpec` / `spec_from_config` :57-122,
`_ACT_BUFFERS`, `Plan`, `_ring_factor`, `_estimate`, `_factorizations`,
`enumerate_plans`, `_diagnose_empty`, `plan_parallel` :125-390,
`TrainPlan` :393-437, `_resolve_param_specs`, `_pick_microbatches`,
`_pp_manual_constraints`, `plan_train` :440-646, `_divisors_desc`,
`degrade_plan`, `plan_serving_tp` :648-810, `best_mesh_axes` :812).

Given a transformer spec, a device count and a chip profile, it
enumerates every legal (dp, mp, pp, fsdp) factorization, prices each
with an analytical compute + collective + pipeline-bubble + HBM model,
prunes the ones that do not fit memory, and returns the ranking; the
arithmetic is the reference's, term for term, so the same `ChipSpec`
figures give the same plans, costs and errors. The absolute times are
nominal (a fixed MFU guess, linear collective models); what the search
relies on is the ORDERING: TP pays activation all-reduces every layer,
DP one gradient reduction, FSDP parameter all-gathers, PP its bubble.

`plan_train` prices and returns pp>1 plans exactly as the reference
does, and models/facade.py runs them through the pipelined step
(parallel/pipeline_train.py); a trainer moves between plans through
`_ShardedTrainStep.rebuild` and a checkpoint restored onto the new
plan (parallel/resilience.py `ResilientTrainer.rebuild_plan`).
`degrade_plan` (:651-757) is the elastic controller's replan onto the
surviving devices (parallel/elastic.py), and `plan_serving_tp`
(:759-810) the tensor-parallel degree of a serving engine
(inference/serving.py `mesh=`). The `train.plan.*` monitor gauges and
the pipelined step's `train.bubble_fraction` gauge wait for A7's
monitor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

__all__ = ["ChipSpec", "ModelSpec", "Plan", "TrainPlan",
           "NoFeasiblePlanError", "enumerate_plans", "plan_parallel",
           "plan_train", "spec_from_config", "spec_from_gpt_config",
           "degrade_plan", "plan_serving_tp", "best_mesh_axes"]


class NoFeasiblePlanError(ValueError):
    """No plan fits the offered device count. `constraint` names the
    violated constraint (divisibility or HBM), so a caller can report a
    diagnosis instead of hanging on a collective that can never
    complete."""

    def __init__(self, msg: str, constraint: str = ""):
        super().__init__(msg)
        self.constraint = constraint or msg


@dataclass(frozen=True)
class ChipSpec:
    """Per-device hardware profile, the reference's fields. The
    defaults are one NVIDIA H100 SXM's data-sheet figures: 989 TFLOP/s
    dense bf16, 80 GB of HBM3 at 3.35 TB/s, and NVLink 4 at 900 GB/s
    per GPU, 450 GB/s each way, as the all-reduce link rate;
    `dcn_bw`, between hosts, is one 400 Gb/s NDR InfiniBand port. `mfu`
    and `coll_latency` are the reference's nominal model constants, not
    measurements of any part. Override for other parts — only ratios
    matter for the ranking."""
    peak_flops: float = 989e12        # bf16 dense tensor-core peak
    hbm_bytes: float = 80e9
    hbm_bw: float = 3.35e12           # bytes/s HBM3 stream
    ici_bw: float = 450e9             # bytes/s NVLink 4, one direction
    dcn_bw: float = 50e9              # bytes/s across hosts (unused yet)
    mfu: float = 0.35                 # nominal achievable fraction
    coll_latency: float = 2e-6        # fixed cost per collective launch


@dataclass(frozen=True)
class ModelSpec:
    """Transformer shape the cost model prices."""
    num_layers: int
    hidden_size: int
    num_heads: int
    ffn_hidden: int
    vocab_size: int
    seq_len: int
    param_bytes_per_elem: int = 4     # f32 master params
    act_bytes_per_elem: int = 2       # bf16 activations
    remat_policy: str = "full"
    sequence_parallel: bool = True

    @property
    def block_params(self) -> int:
        d, f = self.hidden_size, self.ffn_hidden
        return self.num_layers * (4 * d * d + 2 * d * f)

    @property
    def embed_params(self) -> int:
        return (self.vocab_size + self.seq_len) * self.hidden_size

    @property
    def total_params(self) -> int:
        return self.block_params + self.embed_params


def spec_from_config(cfg) -> ModelSpec:
    """Build a ModelSpec from a single-tower model config
    (models.gpt.GPTConfig, models.bert.BertConfig, models.vit.ViTConfig):
    the transformer fields are duck-typed; ViT-style configs derive the
    sequence length from the patch grid. Composite dual-tower configs
    (ErnieViLConfig) don't fit one transformer spec — plan a tower
    explicitly (spec_from_config(cfg.text) / (cfg.vision))."""
    if hasattr(cfg, "text") and hasattr(cfg, "vision"):
        raise ValueError(
            f"{type(cfg).__name__} is a dual-tower composite; plan one "
            "tower at a time: spec_from_config(cfg.text) or "
            "spec_from_config(cfg.vision)")
    seq = getattr(cfg, "max_seq_len", None)
    if seq is None and hasattr(cfg, "num_patches"):
        seq = cfg.num_patches + 1                          # + [CLS]
    elif seq is None and hasattr(cfg, "image_size") and hasattr(
            cfg, "patch_size"):
        seq = (cfg.image_size // cfg.patch_size) ** 2 + 1
    if seq is None:
        raise ValueError(
            f"{type(cfg).__name__} has neither max_seq_len nor an "
            "image/patch geometry to derive a sequence length from")
    return ModelSpec(
        num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
        num_heads=cfg.num_heads, ffn_hidden=cfg.ffn_hidden,
        vocab_size=getattr(cfg, "vocab_size", 0), seq_len=seq,
        remat_policy=(getattr(cfg, "remat_policy", "full")
                      if getattr(cfg, "remat", False) else "none"),
        sequence_parallel=getattr(cfg, "sequence_parallel", False))


# historical name (round-5 introduced the planner GPT-first)
spec_from_gpt_config = spec_from_config


# How many residual-sized buffers per layer survive the forward, by remat
# policy (drives the activation-memory estimate; calibrated against the
# ablation notes in BASELINE.md: no-remat ~33 GB vs full-remat ~11 GB
# temp on the 350M sweep shapes).
_ACT_BUFFERS = {"full": 2.0, "dots": 9.0, "dots_flash": 10.0,
                "offload_dots": 3.0, "all_but_mlp": 14.0, "none": 20.0}


@dataclass
class Plan:
    dp: int = 1
    mp: int = 1
    pp: int = 1
    fsdp: int = 1
    microbatches: int = 1
    # latency-hiding collectives: priced as a deeper fsdp discount in
    # _estimate, as the reference prices them; the port's step records
    # the knob and changes nothing for it. Off by default.
    overlap: bool = False
    step_s: float = float("inf")
    mem_bytes: float = 0.0
    fits: bool = True
    breakdown: Dict[str, float] = field(default_factory=dict)

    @property
    def n_devices(self) -> int:
        return self.dp * self.mp * self.pp * self.fsdp

    def mesh_axes(self) -> Dict[str, int]:
        axes = {}
        if self.dp > 1 or (self.mp == self.pp == self.fsdp == 1):
            axes["dp"] = self.dp
        if self.fsdp > 1:
            axes["fsdp"] = self.fsdp
        if self.pp > 1:
            axes["pp"] = self.pp
        if self.mp > 1:
            axes["mp"] = self.mp
        return axes

    def __repr__(self):
        keys = f"dp{self.dp}_mp{self.mp}_pp{self.pp}_fsdp{self.fsdp}"
        if self.pp > 1:
            keys += f"_mb{self.microbatches}"
        ms = self.step_s * 1e3
        gb = self.mem_bytes / 1e9
        return (f"Plan({keys}, est {ms:.{3 if ms < 1 else 1}f} ms, "
                f"mem {gb:.{2 if gb < 1 else 1}f} GB"
                + ("" if self.fits else ", OOM") + ")")


def _ring_factor(n: int) -> float:
    """Per-chip all-reduce volume multiplier: ring moves 2(n-1)/n of the
    buffer through each chip."""
    return 2.0 * (n - 1) / n if n > 1 else 0.0


# Fraction of the ZeRO-3 gather/scatter volume still EXPOSED on the
# critical path when plan.overlap double-buffers the per-layer gather
# (layer i+1's all-gather issues under layer i's compute; the transpose
# reduce-scatter overlaps the backward the same way). One layer's
# gather — the un-prefetchable first one — plus scheduling slack.
FSDP_OVERLAP_EXPOSED = 0.4


def _estimate(plan: Plan, spec: ModelSpec, global_batch: int,
              chip: ChipSpec) -> Plan:
    """Fill in step_s / mem_bytes / fits for one assignment."""
    dp, mp, pp, fsdp = plan.dp, plan.mp, plan.pp, plan.fsdp
    L, D, S = spec.num_layers, spec.hidden_size, spec.seq_len
    V, F = spec.vocab_size, spec.ffn_hidden
    tokens = global_batch * S
    b_local = max(global_batch // (dp * fsdp), 1)   # batch shards dp×fsdp
    tok_local = b_local * S
    abytes = spec.act_bytes_per_elem

    # ---- compute: fwd 2*P_used*tokens + attention, bwd 2x fwd --------
    matmul_flops = 2 * (spec.block_params + 2 * V * D) * tokens
    attn_flops = 4 * tokens * S * D * L            # QK^T + PV, non-causal
    remat_extra = {"full": 1.0 / 3.0, "dots": 0.15, "dots_flash": 0.1,
                   "offload_dots": 0.2, "all_but_mlp": 0.12,
                   "none": 0.0}.get(spec.remat_policy, 1.0 / 3.0)
    flops = (matmul_flops + attn_flops) * 3.0 * (1.0 + remat_extra / 3.0)
    compute_s = flops / plan.n_devices / (chip.peak_flops * chip.mfu)
    # pipeline bubble: (pp-1) idle slots per m microbatch slots
    if pp > 1:
        compute_s *= 1.0 + (pp - 1) / max(plan.microbatches, 1)

    # ---- communication (per chip, bytes / ici_bw) --------------------
    # TP: 2 activation all-reduces fwd + 2 bwd per layer (or the
    # reduce-scatter/all-gather pair under SP — same moved volume)
    tp_bytes = (_ring_factor(mp) * 4 * L * tok_local * D * abytes
                if mp > 1 else 0.0)
    # DP: one gradient all-reduce of this chip's param shard (f32)
    shard_params = spec.total_params / (mp * pp * fsdp)
    dp_bytes = _ring_factor(dp) * shard_params * 4
    # FSDP/ZeRO-3: all-gather params in fwd and again in bwd, reduce-
    # scatter grads — ~3 all-gather-sized moves of the fsdp shard
    fsdp_bytes = (3.0 * (fsdp - 1) / fsdp
                  * (spec.total_params / (mp * pp)) * abytes
                  if fsdp > 1 else 0.0)
    # PP: boundary activations each way per microbatch
    pp_bytes = (2 * plan.microbatches
                * (tok_local / max(plan.microbatches, 1)) * D * abytes
                * (pp - 1) / pp if pp > 1 else 0.0)
    # overlap discounts: DP grad reduction overlaps the backward well;
    # TP all-reduces sit on the critical path. Collective LAUNCHES also
    # carry a fixed latency — TP pays 4 per layer on the critical path,
    # DP's gradient reduction fuses into a handful, FSDP buckets too —
    # which is what prices TP out for small models where byte volumes
    # alone would call it free.
    tp_ops = 4 * L if mp > 1 else 0
    dp_ops = 2 if dp > 1 else 0
    fsdp_ops = 3 if fsdp > 1 else 0
    pp_ops = 2 * plan.microbatches if pp > 1 else 0
    # latency-hiding collectives (plan.overlap): the double-buffered
    # ZeRO-3 gather issues layer i+1's all-gather while layer i
    # computes, so only the un-hideable fraction of the fsdp volume
    # stays on the critical path (FSDP_OVERLAP_EXPOSED of the default
    # 0.6 exposure). TP all-reduces stay at 1.0: nothing here hides
    # them.
    fsdp_disc = (0.6 * FSDP_OVERLAP_EXPOSED if plan.overlap else 0.6)
    comm_s = ((tp_bytes * 1.0 + dp_bytes * 0.3 + fsdp_bytes * fsdp_disc
               + pp_bytes * 0.5) / chip.ici_bw
              + (tp_ops + dp_ops + fsdp_ops + pp_ops)
              * chip.coll_latency)

    # ---- memory ------------------------------------------------------
    # ONE home for the per-chip HBM model: cost_model.train_memory_
    # ledger attributes the same bytes to named components (params /
    # grads / adam m+v, remat activation working set, logits chunk,
    # overlap prefetch); _estimate consumes the ledger's total.
    from ..cost_model import train_memory_ledger
    led = train_memory_ledger(spec, plan, global_batch)
    comp = led["components"]
    mem = led["total"]
    plan.step_s = compute_s + comm_s
    plan.mem_bytes = mem
    plan.fits = mem <= 0.9 * chip.hbm_bytes
    plan.breakdown = {
        "compute_s": compute_s, "tp_s": tp_bytes / chip.ici_bw,
        "dp_s": dp_bytes * 0.3 / chip.ici_bw,
        "fsdp_s": fsdp_bytes * fsdp_disc / chip.ici_bw,
        "pp_s": pp_bytes * 0.5 / chip.ici_bw,
        "state_gb": (comp["params"] + comp["grads"] + comp["adam_m"]
                     + comp["adam_v"]) / 1e9,
        "act_gb": comp["activations"] / 1e9,
    }
    return plan


def _factorizations(n: int) -> List[tuple]:
    out = []
    for dp in (d for d in range(1, n + 1) if n % d == 0):
        rem = n // dp
        for mp in (d for d in range(1, rem + 1) if rem % d == 0):
            rem2 = rem // mp
            for pp in (d for d in range(1, rem2 + 1) if rem2 % d == 0):
                out.append((dp, mp, pp, rem2 // pp))
    return out


def _coerce_spec(model) -> ModelSpec:
    """ONE home for the ModelSpec-or-model-config dispatch
    (plan_parallel, enumerate_plans and cost_model.train_memory_ledger
    all take either)."""
    return model if isinstance(model, ModelSpec) \
        else spec_from_config(model)


def enumerate_plans(spec, n_devices: int, global_batch: int,
                    chip: Optional[ChipSpec] = None,
                    microbatches: Optional[int] = None,
                    max_mp: Optional[int] = None) -> List[Plan]:
    """All legal assignments, priced, sorted best-first (OOM plans sink
    to the bottom, still priced so the caller can see why). `spec` is a
    ModelSpec or a GPTConfig."""
    spec = _coerce_spec(spec)
    chip = chip or ChipSpec()
    plans = []
    for dp, mp, pp, fsdp in _factorizations(n_devices):
        # legality: mp divides heads and ffn; pp divides layers;
        # dp*fsdp divides the global batch
        if spec.num_heads % mp or spec.ffn_hidden % mp:
            continue
        if max_mp and mp > max_mp:
            continue
        if spec.num_layers % pp:
            continue
        if global_batch % (dp * fsdp):
            continue
        mb = microbatches or (4 * pp if pp > 1 else 1)
        mb = min(mb, max(global_batch // (dp * fsdp), 1))
        plans.append(_estimate(
            Plan(dp=dp, mp=mp, pp=pp, fsdp=fsdp, microbatches=mb),
            spec, global_batch, chip))
    plans.sort(key=lambda p: (not p.fits, p.step_s))
    return plans


def _diagnose_empty(spec: ModelSpec, n_devices: int, global_batch: int,
                    max_mp: Optional[int],
                    max_pp: Optional[int] = None) -> str:
    """Why enumerate_plans returned nothing: re-walk every factorization
    and name the constraint(s) that pruned it, so the caller's error
    says WHICH divisibility failed instead of a generic 'no legal
    assignment' (the _factorizations edge cases — prime device counts,
    a global batch no dp×fsdp split divides, single-device — all land
    here with an actionable message). `max_pp` restricts the walk the
    same way the caller restricted its search (plan_train excludes
    pp>1), so the diagnosis prices exactly the space that came up
    empty — a pp=8 escape hatch the caller forbids must not mask the
    real batch/heads blocker."""
    facts = [f for f in _factorizations(n_devices)
             if max_pp is None or f[2] <= max_pp]
    if not facts:
        return f"n_devices={n_devices} has no factorization (must be >= 1)"
    reasons = []
    mp_legal = [mp for _, mp, _, _ in facts
                if spec.num_heads % mp == 0 and spec.ffn_hidden % mp == 0
                and not (max_mp and mp > max_mp)]
    if not mp_legal:
        reasons.append(
            f"num_heads={spec.num_heads}/ffn_hidden={spec.ffn_hidden} "
            f"admit no mp degree dividing n_devices={n_devices}"
            + (f" under max_mp={max_mp}" if max_mp else ""))
    pp_legal = [pp for _, _, pp, _ in facts if spec.num_layers % pp == 0]
    if not pp_legal:
        reasons.append(
            f"num_layers={spec.num_layers} admits no pp degree dividing "
            f"n_devices={n_devices}")
    # the batch constraint interacts with the others: only dp×fsdp
    # splits that survive the mp/pp pruning count
    dpxfsdp = sorted({dp * fsdp for dp, mp, pp, fsdp in facts
                      if spec.num_heads % mp == 0
                      and spec.ffn_hidden % mp == 0
                      and not (max_mp and mp > max_mp)
                      and spec.num_layers % pp == 0})
    if dpxfsdp and not any(global_batch % d == 0 for d in dpxfsdp):
        reasons.append(
            f"global_batch={global_batch} is not divisible by any legal "
            f"dp*fsdp split of {n_devices} devices "
            f"(candidates: {dpxfsdp})")
    return "; ".join(reasons) or "every assignment was pruned"


def plan_parallel(cfg_or_spec, n_devices: int, global_batch: int,
                  chip: Optional[ChipSpec] = None, **kw) -> Plan:
    """The best assignment for a GPTConfig or ModelSpec (the reference
    parallel_tuner's `tune()` surface collapsed to a function). When no
    assignment is legal the error names the failing divisibility
    constraint (heads/ffn vs mp, layers vs pp, global batch vs
    dp×fsdp)."""
    spec = _coerce_spec(cfg_or_spec)
    plans = enumerate_plans(spec, n_devices, global_batch, chip, **kw)
    if not plans:
        raise ValueError(
            f"no legal (dp, mp, pp, fsdp) assignment for {n_devices} "
            f"devices: "
            + _diagnose_empty(spec, n_devices, global_batch,
                              kw.get("max_mp")))
    return plans[0]


# ------------------------------------------------------- executable plans
@dataclass
class TrainPlan:
    """An EXECUTABLE 3D/4D assignment: what models.facade.make_train_step
    (mesh=, plan=) consumes. `axes` materializes through
    parallel.mesh.build_mesh; `specs` is the family's module-level
    PARAM_SPECS table remapped onto those axes (parallel.mesh.remap_specs
    — the TP split lands on `tp`, ZeRO-3 on `fsdp`; 'pp' drops to the
    per-rank layer loop in the 3D formulation, and survives as the
    stage-chunk axis of a pp>1 plan, cutting every stacked leaf's layer
    axis over the pipeline stages: parallel/pipeline_train.py);
    `batch_axes` names the axes the global batch
    shards over (dp×fsdp). `plan` keeps the priced cost-model row the
    choice came from."""
    axes: Dict[str, int]
    mapping: Dict[str, str]
    batch_axes: tuple
    plan: Plan
    specs: Optional[Dict] = None
    # latency-hiding collectives knob (mirrors Plan.overlap): the
    # facade reads it as the default for make_train_step(overlap=None)
    overlap: bool = False

    @property
    def name(self) -> str:
        return "_".join(f"{a}{n}" for a, n in self.axes.items())

    @property
    def pp(self) -> int:
        return int(self.axes.get("pp", 1))

    @property
    def microbatches(self) -> int:
        return int(getattr(self.plan, "microbatches", 1) or 1)

    def build_mesh(self, devices=None, device_type: str = "cuda"):
        """The plan's DeviceMesh (parallel.mesh.build_mesh): on the card
        unless the caller passes device_type="cpu"."""
        from .mesh import build_mesh
        return build_mesh(self.axes, devices=devices,
                          device_type=device_type)

    def batch_spec(self, ndim: int = 2):
        """Spec of a batch leaf: leading dim over dp×fsdp, the rest
        replicated."""
        from .mesh import P
        return P(tuple(self.batch_axes), *([None] * (ndim - 1)))

    def __repr__(self):
        return f"TrainPlan({self.name}, {self.plan!r})"


def _resolve_param_specs(cfg) -> Optional[Dict]:
    """The module-level PARAM_SPECS table of the config's model family
    (GPTConfig -> models.gpt.PARAM_SPECS, LlamaConfig -> models.llama's,
    ...): the family declares its sharding next to its init/forward, so
    the planner never hardcodes a layout. None for bare ModelSpecs and
    configs whose module declares no table — pass param_specs= then."""
    if isinstance(cfg, ModelSpec):
        return None
    import sys
    mod = sys.modules.get(type(cfg).__module__)
    return getattr(mod, "PARAM_SPECS", None)


def _pick_microbatches(b_local: int, pp: int) -> Optional[int]:
    """The microbatch count a pp>1 plan runs: the largest divisor of the
    per-(dp×fsdp)-shard batch not exceeding 4·pp (deeper pipelines want
    more microbatches to amortize the (pp-1)/m bubble; past ~4·pp the
    returns flatten while the per-microbatch tensors shrink below
    efficient tile sizes). None when the shard admits no split (a
    1-row shard cannot microbatch)."""
    for m in range(min(int(b_local), 4 * pp), 1, -1):
        if b_local % m == 0:
            return m
    return None


def _pp_manual_constraints(spec: ModelSpec, dp: int, fsdp: int, tp: int,
                           pp: int, global_batch: int,
                           microbatches: Optional[int] = None
                           ) -> tuple:
    """(problems, microbatches) for a pp>1 assignment. The reference's
    pipelined step partitions every axis by hand and cannot
    shape-degrade per leaf, so these divisibilities are plan-level
    legality, each named (kept so the port prices and refuses the same
    pp>1 plans)."""
    problems = []
    if spec.num_layers % pp:
        problems.append(f"pp={pp} does not divide num_layers="
                        f"{spec.num_layers} (stage chunking needs equal "
                        "layer chunks per stage)")
    if tp > 1 and spec.vocab_size and spec.vocab_size % tp:
        problems.append(f"tp={tp} does not divide vocab_size="
                        f"{spec.vocab_size} (the pp step's manual "
                        "vocab-parallel embedding/head)")
    if fsdp > 1 and spec.hidden_size % fsdp:
        problems.append(f"fsdp={fsdp} does not divide hidden_size="
                        f"{spec.hidden_size} (the pp step's manual "
                        "ZeRO-3 weight gather)")
    b_local = global_batch // max(dp * fsdp, 1) \
        if global_batch % max(dp * fsdp, 1) == 0 else 0
    mb = microbatches or (_pick_microbatches(b_local, pp) if b_local
                          else None)
    if not mb or mb < 2 or (b_local and b_local % mb):
        problems.append(
            f"microbatches={microbatches or mb} does not split the "
            f"per-shard batch global_batch/(dp*fsdp)="
            f"{b_local or '<indivisible>'} into >=2 equal microbatches "
            f"(pp={pp} needs a 1F1B schedule)")
        mb = mb or 0
    return problems, int(mb or 0)


def plan_train(cfg_or_spec, n_devices: int, global_batch: int,
               chip: Optional[ChipSpec] = None, dp: Optional[int] = None,
               fsdp: Optional[int] = None, tp: Optional[int] = None,
               pp: Optional[int] = None,
               microbatches: Optional[int] = None,
               tp_axis: str = "tp", param_specs: Optional[Dict] = None,
               overlap: bool = False, **kw) -> TrainPlan:
    """The executable dp×fsdp×tp(×pp) assignment for a model config:
    search the cost model, then emit the {axes -> PartitionSpec tree}
    contract: mesh axes for build_mesh, the family PARAM_SPECS remapped
    onto them, and the dp×fsdp batch spec. Pass explicit degrees
    (dp/fsdp/tp, optionally pp + microbatches) to skip the search;
    illegal explicit degrees raise naming the violated constraint, same
    as plan_parallel.

    Pipeline parallelism: the search prefers pp=1 (the 3D step loops
    over the stacked layer axis on each rank — no bubble, no boundary
    traffic) and emits pp>1 ONLY through the
    HBM gate: when no dp×fsdp×tp assignment fits per-chip memory even
    at fsdp=max, stage-chunking the layer stack over a 'pp' mesh axis
    is the remaining lever (it divides per-stage weights AND
    activations, and microbatching divides the logit working set).
    A pp>1 plan carries the extra manual-step legality constraints
    (_pp_manual_constraints) and a microbatch count with
    (pp-1)/microbatches priced as its bubble.

    The reference also publishes the chosen degrees as `train.plan.*`
    monitor gauges; those wait for the port of its monitor (ROADMAP
    A7)."""
    spec = _coerce_spec(cfg_or_spec)
    chip = chip or ChipSpec()
    if any(d is not None for d in (dp, fsdp, tp, pp)):
        dp, fsdp, tp, pp = (int(d or 1) for d in (dp, fsdp, tp, pp))
        problems = []
        if dp * fsdp * tp * pp != n_devices:
            wanted = (f"dp*fsdp*tp = {dp}*{fsdp}*{tp}" if pp == 1 else
                      f"dp*fsdp*tp*pp = {dp}*{fsdp}*{tp}*{pp}")
            problems.append(f"{wanted} = {dp * fsdp * tp * pp} != "
                            f"n_devices={n_devices}")
        if spec.num_heads % tp or spec.ffn_hidden % tp:
            problems.append(f"tp={tp} does not divide num_heads="
                            f"{spec.num_heads}/ffn_hidden="
                            f"{spec.ffn_hidden}")
        if global_batch % (dp * fsdp):
            problems.append(f"global_batch={global_batch} is not "
                            f"divisible by dp*fsdp={dp * fsdp}")
        mb = 1
        if pp > 1:
            pp_problems, mb = _pp_manual_constraints(
                spec, dp, fsdp, tp, pp, global_batch, microbatches)
            problems.extend(pp_problems)
        elif microbatches and microbatches > 1:
            problems.append(f"microbatches={microbatches} needs pp>1 "
                            "(the 3D step has no pipeline to fill)")
        if problems:
            # NoFeasiblePlanError IS a ValueError (historical callers
            # keep matching); `constraint` names the violation
            raise NoFeasiblePlanError(
                f"illegal {'4D' if pp > 1 else '3D'} plan: "
                + "; ".join(problems),
                constraint="; ".join(problems))
        best = _estimate(Plan(dp=dp, mp=tp, pp=pp, fsdp=fsdp,
                              microbatches=mb, overlap=overlap),
                         spec, global_batch, chip)
    else:
        plans = enumerate_plans(spec, n_devices, global_batch, chip, **kw)
        pp1 = [p for p in plans if p.pp == 1]
        best = next((p for p in pp1 if p.fits), None)
        if best is None:
            # HBM gate: nothing fits flat, even at fsdp=max — the priced
            # enumeration may emit pp>1 (stage chunks divide per-chip
            # layer weights AND activations; microbatches divide the
            # logit working set). Only manual-step-legal candidates
            # qualify; the microbatch count is re-picked per candidate
            # so the priced bubble is the one the step will run.
            for cand in (p for p in plans if p.pp > 1 and p.fits):
                probs, mb = _pp_manual_constraints(
                    spec, cand.dp, cand.fsdp, cand.mp, cand.pp,
                    global_batch)
                if probs:
                    continue
                priced = _estimate(
                    Plan(dp=cand.dp, mp=cand.mp, pp=cand.pp,
                         fsdp=cand.fsdp, microbatches=mb),
                    spec, global_batch, chip)
                # re-CHECK fits with the REAL microbatch count: the
                # enumeration priced this candidate at ~4·pp
                # microbatches, and a smaller legal mb grows the logit
                # working set — an OOM re-estimate must not win over a
                # deeper candidate whose mb is viable
                if priced.fits:
                    best = priced
                    break
        if best is None and pp1:
            best = pp1[0]            # least-bad OOM 3D plan, still priced
        if best is None:
            raise ValueError(
                f"no legal (dp, fsdp, tp[, pp]) assignment for "
                f"{n_devices} devices: "
                + _diagnose_empty(spec, n_devices, global_batch,
                                  kw.get("max_mp")))
    if overlap and not best.overlap:
        # the search priced candidates without overlap (the knob never
        # changes WHICH plan wins — it scales one phase); re-price the
        # winner so step_s/breakdown reflect the hidden fsdp volume
        best = _estimate(
            Plan(dp=best.dp, mp=best.mp, pp=best.pp, fsdp=best.fsdp,
                 microbatches=best.microbatches, overlap=True),
            spec, global_batch, chip)
    axes = {"dp": best.dp, "fsdp": best.fsdp, tp_axis: best.mp}
    mapping = {"dp": "dp", "fsdp": "fsdp", "mp": tp_axis}
    if best.pp > 1:
        # the stacked layer axis SURVIVES as the stage-chunk axis: the
        # remapped specs shard it over 'pp' and the mesh carries all
        # four axes (degree-1 included)
        axes["pp"] = best.pp
        mapping["pp"] = "pp"
    if param_specs is None:
        param_specs = _resolve_param_specs(cfg_or_spec)
    specs = None
    if param_specs is not None:
        from .mesh import remap_specs
        specs = remap_specs(param_specs, mapping)
    return TrainPlan(axes=axes, mapping=mapping,
                     batch_axes=("dp", "fsdp"), plan=best, specs=specs,
                     overlap=bool(overlap))


def _divisors_desc(n: int) -> List[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def degrade_plan(cfg_or_spec, old: TrainPlan, n_surviving: int,
                 global_batch: int, chip: Optional[ChipSpec] = None,
                 tp_axis: str = "tp",
                 param_specs: Optional[Dict] = None) -> TrainPlan:
    """Degrade `old` onto at most `n_surviving` devices after device
    loss (parallel/elastic.py). Preference order: **dp gives way first,
    then fsdp, and tp AND pp are held**: re-slicing the TP split would
    change the per-layer collective pattern and the head partitioning,
    and re-chunking the pipeline stages would re-slice every stacked
    leaf's stage windows and change the 1F1B schedule, while shrinking
    dp/fsdp only re-shards the batch and the ZeRO-3 windows, which the
    checkpoint manifest re-slices for free. Candidates rank
    largest-surviving-world first, so the degrade strands as few
    devices as possible; when no held candidate is legal (tp·pp itself
    exceeds the survivors) the full search runs on every world size
    down from `n_surviving`, collapsing pipeline stages only when the
    survivors cannot form the old stage grid.

    Raises NoFeasiblePlanError naming the violated constraint when
    nothing fits: divisibility (the pp stage-grid constraint included)
    through the `_diagnose_empty` walk, HBM with the per-device state
    bytes spelled out."""
    spec = _coerce_spec(cfg_or_spec)
    chip = chip or ChipSpec()
    if n_surviving < 1:
        raise NoFeasiblePlanError(
            f"no surviving devices (n_surviving={n_surviving})",
            constraint=f"n_surviving={n_surviving} < 1")
    dp0 = old.axes.get("dp", 1)
    fsdp0 = old.axes.get("fsdp", 1)
    tp0 = old.axes.get(tp_axis, 1)
    pp0 = old.axes.get("pp", 1)
    oom = []                      # legal-but-OOM candidates, for the error
    # the tp·pp-held lattice: every (dp' | dp, fsdp' | fsdp) shrink keeps
    # the batch divisibility `old` satisfied; rank by total desc, then
    # prefer the larger fsdp' (shrink dp before fsdp)
    cands = sorted(((dp, fsdp) for dp in _divisors_desc(dp0)
                    for fsdp in _divisors_desc(fsdp0)
                    if dp * fsdp * tp0 * pp0 <= n_surviving),
                   key=lambda c: (-(c[0] * c[1] * tp0 * pp0), -c[1],
                                  -c[0]))
    for dp, fsdp in cands:
        mb = 1
        if pp0 > 1:
            probs, mb = _pp_manual_constraints(spec, dp, fsdp, tp0, pp0,
                                               global_batch)
            if probs:
                continue          # this shrink cannot microbatch
        priced = _estimate(Plan(dp=dp, mp=tp0, pp=pp0, fsdp=fsdp,
                                microbatches=mb), spec, global_batch,
                           chip)
        if priced.fits:
            return plan_train(cfg_or_spec, dp * fsdp * tp0 * pp0,
                              global_batch, chip=chip, dp=dp, fsdp=fsdp,
                              tp=tp0, pp=pp0,
                              microbatches=mb if pp0 > 1 else None,
                              tp_axis=tp_axis, param_specs=param_specs,
                              overlap=getattr(old, "overlap", False))
        oom.append(priced)
    # tp/pp cannot be held (or every held candidate is OOM): the full
    # search, largest world first; pp=1 plans preferred, pp>1 only
    # through the HBM gate's legality, as plan_train's search applies it
    for n in range(n_surviving, 0, -1):
        plans = enumerate_plans(spec, n, global_batch, chip)
        oom.extend(p for p in plans if p.pp == 1 and not p.fits)
        best = next((p for p in plans if p.pp == 1 and p.fits), None)
        mb = None
        if best is None:
            for p in (q for q in plans if q.pp > 1 and q.fits):
                probs, cand_mb = _pp_manual_constraints(
                    spec, p.dp, p.fsdp, p.mp, p.pp, global_batch)
                if probs:
                    continue
                priced = _estimate(Plan(dp=p.dp, mp=p.mp, pp=p.pp,
                                        fsdp=p.fsdp,
                                        microbatches=cand_mb),
                                   spec, global_batch, chip)
                # fits must hold at the real microbatch count
                if priced.fits:
                    best, mb = priced, cand_mb
                    break
        if best is not None:
            return plan_train(cfg_or_spec, n, global_batch, chip=chip,
                              dp=best.dp, fsdp=best.fsdp, tp=best.mp,
                              pp=best.pp, microbatches=mb,
                              tp_axis=tp_axis, param_specs=param_specs,
                              overlap=getattr(old, "overlap", False))
    if oom:
        best = min(oom, key=lambda p: p.mem_bytes)
        raise NoFeasiblePlanError(
            f"no degraded plan fits {n_surviving} surviving devices: "
            f"best candidate {best!r} needs {best.mem_bytes / 1e9:.2f} "
            f"GB/chip > 0.9*hbm_bytes = {0.9 * chip.hbm_bytes / 1e9:.2f}"
            f" GB even at max sharding",
            constraint=f"hbm: {best.mem_bytes / 1e9:.2f} GB/chip > "
                       f"{0.9 * chip.hbm_bytes / 1e9:.2f} GB")
    reason = _diagnose_empty(spec, n_surviving, global_batch, None)
    raise NoFeasiblePlanError(
        f"no legal degraded (dp, fsdp, tp, pp) assignment for "
        f"{n_surviving} surviving devices: {reason}", constraint=reason)


def plan_serving_tp(cfg_or_spec, n_devices: int, num_slots: int = 8,
                    max_len: Optional[int] = None,
                    chip: Optional[ChipSpec] = None,
                    cache_bytes_per_elem: int = 2) -> Dict[str, int]:
    """The tensor-parallel degree of a serving decode tick
    (inference/serving.py `mesh=`). The tick is weight-bandwidth bound:
    every decode step streams every weight byte once, plus the live KV
    pool, so tp divides the bytes each device streams while paying two
    activation all-reduces a layer, whose tiny [slots, D] payloads make
    the fixed collective launch latency the real price. Memory is a hard
    gate: weights + the KV pool must fit a device, so a model bigger
    than one device forces tp > 1. Only degrees dividing both
    `n_devices` and num_heads are considered (head-sharded attention).
    Returns mesh axes for parallel.mesh.build_mesh, e.g. {'tp': 2}."""
    spec = _coerce_spec(cfg_or_spec)
    chip = chip or ChipSpec()
    S = max_len or spec.seq_len
    # per-tick streamed bytes: the weights in the serving compute dtype
    # and the worst-case live KV pool (the dense-equivalent envelope),
    # from cost_model.serving_memory_ledger; decode scratch rides in the
    # 10% headroom of the 0.9 factor
    from ..cost_model import serving_memory_ledger
    led = serving_memory_ledger(
        spec, layout="dense", quant="off", num_slots=num_slots,
        max_len=S, cache_bytes_per_elem=cache_bytes_per_elem,
        dtype_bytes=spec.act_bytes_per_elem)
    w_bytes = led["components"]["weights"]
    kv_bytes = led["components"]["kv_pool_device"]
    degrees = [d for d in range(1, n_devices + 1)
               if n_devices % d == 0 and spec.num_heads % d == 0]
    best, best_t, best_fits = None, float("inf"), False
    for tp in degrees:
        shard = (w_bytes + kv_bytes) / tp
        fits = shard <= 0.9 * chip.hbm_bytes
        ar_bytes = (_ring_factor(tp) * 2 * spec.num_layers * num_slots
                    * spec.hidden_size * spec.act_bytes_per_elem)
        t = (shard / chip.hbm_bw + ar_bytes / chip.ici_bw
             + (2 * spec.num_layers * chip.coll_latency
                if tp > 1 else 0.0))
        # a non-fitting degree only wins over another non-fitting one
        if best is None or (not fits, t) < (not best_fits, best_t):
            best, best_t, best_fits = tp, t, fits
    return {"tp": best}      # tp=1 always qualifies, so best is set


def best_mesh_axes(param_count: int, n_devices: int,
                   chip: Optional[ChipSpec] = None) -> Dict[str, int]:
    """Generic-model auto mode (the reference's Engine): with no layer
    structure to reason about, the only sound choice is dp vs fsdp — shard the
    parameter state across fsdp only when the optimizer state would not
    fit replicated (fsdp costs all-gathers every step; dp's gradient
    reduction overlaps the backward).

    `param_count` is the parameter ELEMENT count: optimizer state is
    priced as f32 master + grad + adam m/v (16 bytes/elem) regardless of
    the model's storage dtype. fsdp only takes degrees that divide
    n_devices — a non-divisor would silently strand devices."""
    chip = chip or ChipSpec()
    state = param_count * 16
    if state <= 0.5 * chip.hbm_bytes or n_devices == 1:
        return {"dp": n_devices}
    divisors = [d for d in range(2, n_devices + 1) if n_devices % d == 0]
    fsdp = next((d for d in divisors
                 if state / d <= 0.5 * chip.hbm_bytes),
                divisors[-1] if divisors else 1)
    axes = {}
    if n_devices // fsdp > 1:
        axes["dp"] = n_devices // fsdp
    axes["fsdp"] = fsdp
    return axes
