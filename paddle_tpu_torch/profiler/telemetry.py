"""Batched step metrics: in-step scalars on the device, one host pull every
K steps.

Counterpart of paddle_tpu/profiler/telemetry.py (`global_norm` :56,
`nonfinite_count` :69, `grad_norm_from_moments` :81, `_host_pull` :123,
`TelemetryWriter` :132, `TelemetryPipeline` :187, `instrument_train_step`
:384). The JSONL schema is the reference's, field for field, so
tools/telemetry_report.py reads either package's stream:

  {"kind": "run",     "t", "pid", "every", "fields", ...meta}
  {"kind": "step",    "step", <field>: float, ...}   # one per step
  {"kind": "flush",   "t", "step", "n"}              # one per pull
  {"kind": "monitor", "t", "pid", "stats": {...}}    # one per pull
  {"kind": "event",   "name", "t", "dur_s"}          # optional spans

The step writes its scalars (loss, the gradient and parameter global
norms, the non-finite count, lr, tokens) into a `(every, n_fields)` f32
accumulator with an int32 write cursor, both on the step's device;
every `every` steps the host pulls the block in ONE device-to-host
transfer (the `_host_pull` seam, which tests count) and hands it to a
background JSONL writer thread. Between flushes the pipeline adds no
host synchronization to a step: the scalars are reductions queued on
the device; the row lands at the device cursor (`remainder`, then
`index_copy_`), never at a host index; and the constant fields (lr,
tokens) come from a row template made on the device once, not a
host-to-device copy a step.

Where the port differs from the reference, because its step updates the
params and moments in place:
- the gradient norm's moment identity needs the sum of the second
  moments BEFORE the step; `instrument_train_step` takes it
  (`moment_sums`) before running the inner step;
- the norms of a sharded step are sums over each rank's shards, every
  leaf weighted by 1/(ranks holding the same block) and summed over the
  mesh, so a leaf replicated over 'dp' or kept whole under 'tp' counts
  once; the reference's norms are GSPMD reductions over the global
  arrays. The values match the unsharded step's within f32 rounding.
"""
from __future__ import annotations

import json
import math
import os
import queue
import threading
import time
from typing import Optional, Sequence

import torch

from . import monitor

DEFAULT_FIELDS = ("loss", "grad_norm", "param_norm", "nonfinite", "lr")
# the MFU field set: + tokens trained a step, so a flush can turn its
# wall time into the train.mfu gauge against the cost model's
# FLOPs a token
MFU_FIELDS = DEFAULT_FIELDS + ("tokens",)


# ------------------------------------------------------------ tree helpers
def _leaves(tree, path=()):
    """(path, tensor) for every floating tensor leaf of a nested
    dict/list/tuple."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point() \
            and tree.numel():
        yield path, tree


def _weighted(parts, weights):
    """sum(part_i × weight_i) as a 0-d f32 tensor (weights host floats)."""
    if not parts:
        return None
    return torch.stack([p.to(torch.float32) * w
                        for p, w in zip(parts, weights)]).sum()


class _Reducer:
    """How a step's trees are cut over the ambient mesh: each leaf's
    weight is 1/(ranks holding the same block) (1.0 without a mesh or
    pins), and `sum` adds a vector of per-rank partial sums over every
    mesh axis, so that each block counts once."""

    def __init__(self, pins=None):
        from ..parallel.mesh import get_mesh
        self.mesh = get_mesh() if pins is not None else None
        self._pins = pins

    def weight(self, tree_index: int, path) -> float:
        if self.mesh is None:
            return 1.0
        from ..parallel.mesh import _entry_axes, axis_names, axis_size, \
            leaf_path_name
        pin = self._pins[tree_index]
        pin = pin.get(leaf_path_name(path)) if tree_index == 0 \
            else _pin_at(pin, path)
        world = math.prod(axis_size(self.mesh, a)
                          for a in axis_names(self.mesh))
        split = math.prod(axis_size(self.mesh, a)
                          for e in (() if pin is None else pin.spec)
                          for a in _entry_axes(e))
        return split / world

    def sum(self, vec: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return vec
        from ..parallel.collective import all_reduce
        from ..parallel.mesh import axis_group, axis_names
        for axis in axis_names(self.mesh):
            vec = all_reduce(vec, axis_group(self.mesh, axis))
        return vec


def _pin_at(pins, path):
    for k in path:
        if not isinstance(pins, dict) or k not in pins:
            return None
        pins = pins[k]
    return pins


# ------------------------------------------------------------ the scalars
def _sumsq(tree, reducer=None, tree_index=0):
    """The (mesh-weighted) sum of squares over a tree's floating leaves,
    0-d f32, or None for a tree without one: each leaf's norm (one
    reduction pass over it, no temporary), squared. One reduction a
    leaf, not one multi-tensor launch: over the 1.03 G-element Llama
    tree torch's multi-tensor norms took ~1.25x as long (PERF.md)."""
    items = list(_leaves(tree))
    if not items:
        return None
    w = [1.0 if reducer is None else reducer.weight(tree_index, p)
         for p, _ in items]
    return _weighted([torch.square(torch.linalg.vector_norm(t))
                      for _, t in items], w)


def global_norm(tree):
    """sqrt(sum of squares) over every floating leaf: the gradient or
    parameter global norm, a 0-d f32 tensor on the leaves' device."""
    sq = _sumsq(tree)
    return torch.zeros(()) if sq is None else torch.sqrt(sq)


def _count_nonfinite(t: torch.Tensor) -> torch.Tensor:
    """The number of inf and nan elements of `t` (0-d). An f32 is
    non-finite exactly when its 8 exponent bits are all set: two integer
    passes make the mask, where `isfinite` is a composite of four
    kernels with f32-sized temporaries; the mask is counted in int32 (any
    leaf under 2^31 elements), which reads a bool tensor faster than an
    int64 count does. Over the 1.03 G Llama parameters `numel -
    isfinite(t).sum()` took 13.5 ms, the exponent mask counted by
    `count_nonzero` 10.5 (PERF.md)."""
    if t.dtype == torch.float32:
        mask = (t.view(torch.int32) & 0x7F800000) == 0x7F800000
    else:
        mask = torch.isfinite(t).logical_not_()
    return mask.sum(dtype=torch.int32 if t.numel() < 2 ** 31
                    else torch.int64)


def _nonfinite(tree, reducer=None, tree_index=0):
    items = list(_leaves(tree))
    if not items:
        return None
    counts = [_count_nonfinite(t) for _, t in items]
    w = [1.0 if reducer is None else reducer.weight(tree_index, p)
         for p, _ in items]
    return _weighted(counts, w)


def nonfinite_count(tree):
    """Number of non-finite elements across every floating leaf (0-d)."""
    n = _nonfinite(tree)
    return torch.zeros((), dtype=torch.int64) if n is None \
        else n.round().to(torch.int64)


class MomentSums(dict):
    """`moment_sums`' result: {"v": this rank's weighted sum of the second
    moments} or {"m": copies of the first-moment leaves}, or empty."""


def moment_sums(opt_state, reducer=None) -> MomentSums:
    """What the gradient norm's recovery needs of the moments BEFORE a
    step that updates them in place: the sum of the second moments where
    the state carries "v" (a sum a leaf); else a copy
    of the first-moment leaves (the elementwise fallback, a second copy
    of m); else nothing."""
    if not isinstance(opt_state, dict):
        return MomentSums()
    if "v" in opt_state:
        items = list(_leaves(opt_state["v"], ("v",)))
        w = [1.0 if reducer is None else reducer.weight(1, p)
             for p, _ in items]
        return MomentSums(v=_weighted([torch.sum(t) for _, t in items], w))
    if "m" in opt_state:
        return MomentSums(m=[t.detach().clone()
                             for _, t in _leaves(opt_state["m"])])
    return MomentSums()


def grad_norm_from_moments(opt_old, opt_new, beta1=0.9, beta2=0.95,
                           reducer=None):
    """The gradient global norm recovered from an Adam-family moment
    update (the reference :81). `opt_old` is the pre-step state's
    `moment_sums` (or a pre-step opt tree the step has not updated in
    place). With second moments: new_v = b2·v + (1 − b2)·g², and the norm
    needs only sums, so sum(g²) = (sum(new_v) − b2·sum(old_v)) / (1 − b2).
    With only "m": the elementwise g = (new_m − b1·m)/(1 − b1). No
    moments: nan."""
    if not isinstance(opt_old, MomentSums):
        opt_old = moment_sums(opt_old, reducer)
    if not isinstance(opt_new, dict):
        return torch.tensor(float("nan"))
    if "v" in opt_old and "v" in opt_new:
        s_new = moment_sums({"v": opt_new["v"]}, reducer)["v"]
        if reducer is not None:
            s_new, s_old = reducer.sum(torch.stack(
                [s_new, opt_old["v"].to(s_new.device)]))
        else:
            s_old = opt_old["v"]
        sq = (s_new - beta2 * s_old) / (1.0 - beta2)
        return torch.sqrt(torch.clamp(sq, min=0.0))
    if "m" in opt_old and "m" in opt_new:
        items = list(_leaves(opt_new["m"], ("m",)))
        parts = [torch.sum(torch.square((ln.float() - beta1 * lo.float())
                                        / (1.0 - beta1)))
                 for lo, (_, ln) in zip(opt_old["m"], items)]
        w = [1.0 if reducer is None else reducer.weight(1, p)
             for p, _ in items]
        total = _weighted(parts, w)
        if reducer is not None:
            total = reducer.sum(total.reshape(1)).reshape(())
        return torch.sqrt(total)
    return torch.tensor(float("nan"))


# ------------------------------------------------------- host pull seam
def _host_pull(x):
    """THE device-to-host transfer of the pipeline: the accumulator and
    its cursor packed into one f64 tensor (f32 values and an int32 cursor
    are exact in f64) and copied once. One seam, so the flush-cadence
    tests count every pull the pipeline makes."""
    buf, n = x["buf"], x["n"]
    packed = torch.cat([buf.reshape(-1).to(torch.float64),
                        n.reshape(1).to(torch.float64)])
    host = packed.cpu().numpy()
    return {"buf": host[:-1].astype("float32").reshape(tuple(buf.shape)),
            "n": int(host[-1])}


# ------------------------------------------------------- background writer
class TelemetryWriter:
    """Append-only JSONL writer draining a queue on a daemon thread, so a
    flush enqueues host arrays and returns without touching json.dumps or
    the filesystem."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="paddle-telemetry-writer", daemon=True)
        self._thread.start()

    def put(self, records) -> None:
        self._q.put(list(records))

    def _run(self) -> None:
        while True:
            recs = self._q.get()
            try:
                if recs is None:
                    return
                try:
                    with open(self.path, "a") as f:
                        for r in recs:
                            f.write(json.dumps(r) + "\n")
                except (OSError, TypeError, ValueError) as e:
                    # a full disk or an unserializable record must not kill
                    # the drain thread (flush() and close() would hang),
                    # and the loss is visible: counted, reported once
                    n = monitor.counter("telemetry_write_errors").add()
                    if n == 1:
                        import sys
                        print(f"[telemetry] dropping records: {e}",
                              file=sys.stderr, flush=True)
            finally:
                self._q.task_done()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every enqueued record is on disk."""
        deadline = None if timeout is None else time.time() + timeout
        while self._q.unfinished_tasks != 0:
            if deadline is not None and time.time() > deadline:
                raise TimeoutError("telemetry writer did not drain")
            time.sleep(0.005)

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=10)


def _device_count() -> int:
    """The devices a run's recorded (global) tokens were trained on: the
    ranks of the process group, one card a rank, or 1 without one. The
    reference counts `jax.device_count()`, every device its one process
    drives; a torch process drives one card, so a single process on a
    machine of several cards counts one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# ------------------------------------------------------------- the pipeline
class TelemetryPipeline:
    """The field layout, the device accumulator and the flush cadence.

        tele = TelemetryPipeline(path, every=8)
        state = tele.device_init(device=dev)
        for i in range(n):
            loss, grads = ...
            tele.device_record(state, loss=loss,
                               grad_norm=global_norm(grads))
            state = tele.tick(i, state)    # ONE pull every `every` steps
        tele.close(state)

    With `flops_per_token` (cost_model.train_flops_per_token) and a
    'tokens' field, every flush after the first (which holds the warm-up)
    sets the `train.mfu` and `train.tokens_per_s` gauges from the
    window's recorded tokens and the wall time since the previous flush,
    against `peak_flops` (default: ChipSpec().peak_flops × the run's
    devices, `_device_count`)."""

    def __init__(self, path: str, every: int = 8,
                 fields: Sequence[str] = DEFAULT_FIELDS,
                 meta: Optional[dict] = None,
                 flops_per_token: Optional[float] = None,
                 peak_flops: Optional[float] = None):
        if every < 1:
            raise ValueError("every must be >= 1")
        self.path = path
        self.every = int(every)
        self.fields = tuple(fields)
        if flops_per_token and "tokens" not in self.fields:
            raise ValueError(
                "flops_per_token= needs a 'tokens' field "
                "(fields=telemetry.MFU_FIELDS)")
        self._flops_per_token = flops_per_token
        self._peak_flops = peak_flops
        self._prev_flush_t: Optional[float] = None
        self._rows = {}        # (device, constants, dynamic fields) -> row
        self._writer = TelemetryWriter(path)
        self._pulls = 0
        self._floor = 0        # lowest cursor value this process wrote
        header = {"kind": "run", "t": time.time(), "pid": os.getpid(),
                  "every": self.every, "fields": list(self.fields)}
        if meta:
            header.update(meta)
        self._writer.put([header])

    # ------------------------------------------------------------- device
    def device_init(self, start: int = 0, device=None):
        """A fresh accumulator on `device` (None: this rank's card, which
        raises without CUDA; pass "cpu" on the CPU): {"buf": (every,
        n_fields) f32 nan, "n": int32 cursor}. `start` seeds the cursor,
        so a resumed trainer's records continue from its restored step."""
        from ..device import resolve_device
        dev = resolve_device(device)
        self._floor = int(start)
        return {"buf": torch.full((self.every, len(self.fields)),
                                  float("nan"), dtype=torch.float32,
                                  device=dev),
                "n": torch.full((), int(start), dtype=torch.int32,
                                device=dev)}

    def _row(self, device, const, dyn):
        """The row template (nan, the constant fields set) and the index
        of the fields a step writes, made on the device once a key."""
        key = (str(device), const, dyn)
        got = self._rows.get(key)
        if got is None:
            row = [float("nan")] * len(self.fields)
            for i, v in const:
                row[i] = v
            got = self._rows[key] = (
                torch.tensor(row, dtype=torch.float32, device=device),
                torch.tensor(dyn, dtype=torch.int64, device=device))
        return got

    def device_record(self, tstate, **scalars):
        """Write one row at the device cursor and advance it, in place;
        returns `tstate`. A tensor scalar is read on the device; a host
        number is a constant of the row template. Unknown field names
        raise; missing fields record nan."""
        unknown = set(scalars) - set(self.fields)
        if unknown:
            raise ValueError(f"unknown telemetry fields {sorted(unknown)}; "
                             f"declared fields are {self.fields}")
        buf, n = tstate["buf"], tstate["n"]
        const, dyn, vals = [], [], []
        for i, f in enumerate(self.fields):
            if f not in scalars:
                continue
            v = scalars[f]
            if isinstance(v, torch.Tensor):
                dyn.append(i)
                vals.append(v.detach().reshape(()).to(buf.device,
                                                      torch.float32))
            else:
                const.append((i, float(v)))
        template, idx = self._row(buf.device, tuple(const), tuple(dyn))
        row = template.clone().index_copy_(0, idx, torch.stack(vals)) \
            if vals else template
        buf.index_copy_(0, torch.remainder(n, self.every).reshape(1)
                        .to(torch.int64), row.reshape(1, -1))
        n.add_(1)
        return tstate

    # --------------------------------------------------------------- host
    def due(self, step: int) -> bool:
        """True when the host loop (0-based step just run) is at a flush
        boundary."""
        return (int(step) + 1) % self.every == 0

    def flush(self, tstate) -> None:
        """Pull the accumulator to the host (ONE transfer) and hand the
        block to the background writer."""
        host = _host_pull(tstate)
        self._pulls += 1
        self._enqueue(host)

    def _enqueue(self, host, count: Optional[int] = None) -> None:
        buf = host["buf"]
        n = int(host["n"])
        now = time.time()
        # rows [first, n) are valid by construction of the cursor; the
        # floor keeps a resume-seeded cursor (start % every != 0) from
        # emitting the nan slots below it as phantom records
        first = max(self._floor,
                    n - (self.every if count is None else count))
        records = []
        for step in range(first, n):
            row = buf[step % self.every]
            rec = {"kind": "step", "step": step}
            for f, v in zip(self.fields, row):
                rec[f] = None if math.isnan(float(v)) else float(v)
            records.append(rec)
        records.append({"kind": "flush", "t": now, "step": n - 1,
                        "n": len(records)})
        # achieved MFU from the second flush on (the first window holds
        # the warm-up); the gauges are set before the snapshot below, so
        # this flush's monitor record carries them
        if (self._flops_per_token and "tokens" in self.fields
                and self._prev_flush_t is not None
                and now > self._prev_flush_t):
            tok_i = self.fields.index("tokens")
            window_tokens = float(sum(
                0.0 if math.isnan(float(buf[s % self.every][tok_i]))
                else float(buf[s % self.every][tok_i])
                for s in range(first, n)))
            if window_tokens > 0:
                peak = self._peak_flops
                if not peak:
                    # the recorded tokens are the global batch's, so the
                    # peak is every device's of the run
                    from ..parallel.planner import ChipSpec
                    peak = self._peak_flops = (ChipSpec().peak_flops
                                               * _device_count())
                tps = window_tokens / (now - self._prev_flush_t)
                monitor.gauge("train.tokens_per_s").set(round(tps, 1))
                monitor.gauge("train.mfu").set(
                    round(self._flops_per_token * tps / peak, 6))
        self._prev_flush_t = now
        # live memory gauges ride the same flush (host-side allocator
        # reads, no device pull)
        from .mem_audit import publish_hbm_gauges
        publish_hbm_gauges()
        records.append({"kind": "monitor", "t": now, "pid": os.getpid(),
                        "stats": monitor.snapshot()})
        self._writer.put(records)

    def tick(self, step: int, tstate):
        """Per-step host hook: flush when due, else nothing. Returns the
        state (its rows are overwritten in place on the next cycle)."""
        if self.due(step):
            self.flush(tstate)
        return tstate

    def flush_tail(self, tstate) -> None:
        """Pull the accumulator (one transfer) and write the rows recorded
        since the last flush boundary, as `close` does; the resilient
        trainer calls it before it restarts the cursor at a rollback."""
        host = _host_pull(tstate)
        self._pulls += 1
        tail = int(host["n"]) % self.every
        if tail:
            self._enqueue(host, count=tail)

    def event(self, name: str, t: Optional[float] = None,
              dur_s: float = 0.0) -> None:
        """Append a host-side event line (launcher phases, checkpoint
        saves, ...) to the same stream."""
        self._writer.put([{"kind": "event", "name": name,
                           "t": time.time() if t is None else t,
                           "dur_s": dur_s}])

    @property
    def pulls(self) -> int:
        """Device-to-host transfers so far."""
        return self._pulls

    def close(self, final_state=None) -> None:
        """Flush a trailing partial window (if a state is given) and stop
        the writer once its queue drains."""
        if final_state is not None:
            self.flush_tail(final_state)
        self._writer.flush(timeout=30)
        self._writer.close()


# --------------------------------------------------- facade-style wrapper
def _batch_tokens(batch, shapes=None) -> float:
    """Tokens a step trains: [B, S+1] next-token batches train B·S; the
    full batch's shape where a sharded step gives one (`shapes`)."""
    toks = shapes if shapes is not None else batch
    toks = toks["tokens"] if isinstance(toks, dict) else toks
    shape = tuple(toks) if isinstance(toks, tuple) \
        else tuple(getattr(toks, "shape", ()))
    return float(shape[0] * (shape[1] - 1)) if len(shape) >= 2 \
        else float("nan")


def _step_scalars(pipeline, box, params, opt_state, run):
    """Run `run()` -> (loss, new_params, new_opt, ...) between the reads
    the DEFAULT/MFU fields need of the in-place state: the moment sums
    before, the norms and count after. `box["step"]` is the sharded step
    (its pins weight the leaves) or absent. Returns (out, scalars)."""
    step = box.get("step")
    pins = getattr(step, "in_pins", None)
    red = _Reducer(pins) if pins is not None else None
    want = set(pipeline.fields)
    old = moment_sums(opt_state, red) if "grad_norm" in want else None
    out = run()
    loss, new_params, new_opt = out[:3]
    scalars = {"loss": loss}
    if "grad_norm" in want:
        scalars["grad_norm"] = grad_norm_from_moments(
            old, new_opt, box["beta1"], box["beta2"], red)
    parts = []
    if "param_norm" in want:
        parts.append(_sumsq(new_params, red))
    if "nonfinite" in want:
        parts.append(_nonfinite(new_params, red))
    parts = [p if p is not None else torch.zeros((), device=loss.device)
             for p in parts]
    if parts:
        vec = torch.stack(parts)
        if red is not None:
            vec = red.sum(vec)
        vals = list(vec)
        if "param_norm" in want:
            scalars["param_norm"] = torch.sqrt(vals.pop(0))
        if "nonfinite" in want:
            scalars["nonfinite"] = vals.pop(0).round()
    return out, scalars


def instrument_train_step(step_fn, pipeline: TelemetryPipeline, cfg=None,
                          lr=None, beta1: float = 0.9, beta2: float = 0.95,
                          mesh=None, plan=None, **step_kw):
    """Wrap a facade-contract step (`step_fn(params, opt_state, batch,
    ...) -> (loss, params, opt_state)`) with device telemetry (reference
    :384). Returns `fn(params, opt_state, batch, tstate) -> (loss,
    params, opt_state, tstate)`, the step models.facade.make_train_step
    builds (with `mesh` and `plan` the planner-driven sharded one, whose
    first call takes full trees as always). Recorded: loss; the gradient
    global norm from the Adam second moments (`grad_norm_from_moments`,
    their sum taken before the in-place update); the parameter global
    norm and non-finite count after it; lr; the tokens of the full batch.
    Under a mesh the norms and count are the whole model's (each block
    counted once), as the unsharded step's. `lr` is forwarded to the
    step like make_train_step's keywords and recorded; `beta1`/`beta2`
    describe the optimizer the step uses, they do not configure it. The
    telemetry only reads the state: a run with it equals one without it
    to the bit."""
    from ..models.facade import make_train_step, plan_step_cell
    if lr is not None:
        step_kw["lr"] = lr
    cell = plan_step_cell(step_fn, cfg=cfg, mesh=mesh, plan=plan, **step_kw)
    box = {"beta1": beta1, "beta2": beta2}

    def instrumented(params, opt_state, batch, tstate):
        out, scalars = _step_scalars(
            pipeline, box, params, opt_state,
            lambda: cell.fn(params, opt_state, batch))
        if lr is not None and "lr" in pipeline.fields:
            scalars["lr"] = float(lr)
        if "tokens" in pipeline.fields:
            step = box.get("step")
            glob = getattr(step, "_global", None)
            scalars["tokens"] = _batch_tokens(
                batch, glob[2] if glob is not None else None)
        pipeline.device_record(tstate, **{k: v for k, v in scalars.items()
                                          if k in pipeline.fields})
        return out[0], out[1], out[2], tstate

    instrumented._plan_cell = cell
    step = make_train_step(instrumented, cfg=cfg, mesh=mesh, plan=plan)
    if step is not instrumented:
        box["step"] = step
    return step
