"""Fused AdamW update, one kernel launch over a table of every parameter
leaf.

Counterpart of paddle_tpu/kernels/pallas_update.py: `_leaf_update`
(:74, the Pallas kernel over one leaf), `fused_apply_adamw` (:102, the
drop-in for models.gpt.apply_adamw running every leaf through it) and
`fused_update_enabled` (:126, the consult; here at the end of the file,
kill switches included).

- `leaf_update_ref(p, g, m, v, hp)` is the plain version: the update of
  one leaf evaluated op by op in f32, in `_update_kernel`'s order
  (pallas_update.py:51-59), returning new (p', m', v') with p' in p's
  dtype. `hp` is the f32 [7] vector [lr, b1, b2, eps, wd, bc1, bc2];
  the scalars derived from it (1 - b1, 1 - b2, 1 - lr * wd) are formed
  in f32, as the Pallas kernel forms them.
- `leaves_update(ps, gs, ms, vs, hp)` updates every leaf's p, m and v IN
  PLACE. On CUDA tensors it checks every operand once, then launches the
  hand-written kernel of csrc/fused_update.cu through the custom op
  `paddle_tpu_torch::leaves_update`: the leaves are grouped by their (p
  dtype, g dtype) pair, and each group goes as tables of up to
  TABLE_LEAVES leaves, one launch a table (`_plan_tables`); it raises on
  anything the kernel does not take. On CPU tensors it runs the plain
  version leaf by leaf. `launches["leaf_update"]` counts kernel launches,
  `launches["leaf_update_leaves"]` the leaves they updated.
- `leaf_update(p, g, m, v, hp)`, the counterpart of `_leaf_update`, is
  `leaves_update` over a table of one.
- `fused_apply_adamw` is the in-place drop-in for models.gpt.
  apply_adamw: one `leaves_update` over the whole tree (one launch for
  the f32 Llama tree). It forms `hp` on the leaves' device from
  opt_state["step"] with tensor ops, so a step never waits on the card.
- `fused_update_enabled(device)`: the leaves are on the card and the
  port's registry names "pallas" for "fused_update" (no entry: the plain
  per-leaf update stays the default and the parity oracle); a kill
  switch (the global one, PADDLE_TPU_DISABLE_PALLAS_UPDATE) turns it
  off.

The kernel rounds every operation on its own (no fused multiply-add),
so on the same hp it reproduces `leaf_update_ref` exactly wherever the
device's division and square root are correctly rounded, as the card's
are without --use_fast_math.
"""
import ctypes
import itertools
import os
from typing import List

import torch

from . import registry

__all__ = ["leaf_update_ref", "leaf_update", "leaves_update",
           "fused_apply_adamw", "fused_update_enabled", "launches"]

launches = {"leaf_update": 0, "leaf_update_leaves": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# a launch's table of leaves (the kernel parameter stays within 4 KB)
# and the elements of a chunk, a block's unit of work: csrc/
# fused_update.cu's TABLE_LEAVES and CHUNK
TABLE_LEAVES = 80
CHUNK = 4096


def leaf_update_ref(p, g, m, v, hp):
    """AdamW on one leaf, plain: -> (p' in p.dtype, m' f32, v' f32)."""
    lr, b1, b2, eps, wd, bc1, bc2 = hp.float().unbind(0)
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * (gf * gf)
    den = torch.sqrt(v_new / bc2) + eps
    p_new = p.float() * (1 - lr * wd) - lr * (m_new / bc1) / den
    return p_new.to(p.dtype), m_new, v_new


def _plan_tables(sizes):
    """The launches of one (p, g) dtype group of leaves with `sizes`
    elements each, in order: [{"leaves": [index into sizes], "chunk0":
    [each leaf's first chunk], "chunks": the launch's chunks}], at most
    TABLE_LEAVES leaves a launch, each leaf's CHUNK-element chunks
    numbered after the previous leaf's (the table the kernel searches)."""
    tables = []
    for lo in range(0, len(sizes), TABLE_LEAVES):
        leaves = list(range(lo, min(lo + TABLE_LEAVES, len(sizes))))
        chunk0, chunks = [], 0
        for i in leaves:
            if sizes[i] <= 0:
                raise ValueError(f"leaves_update: leaf {i} has {sizes[i]} "
                                 "elements")
            chunk0.append(chunks)
            chunks += -(-sizes[i] // CHUNK)
        if chunks >= 2 ** 31:
            raise ValueError(f"leaves_update: {chunks} chunks in one launch")
        tables.append({"leaves": leaves, "chunk0": chunk0, "chunks": chunks})
    return tables


def _library():
    from . import _build
    lib = _build.load("fused_update")
    if not getattr(lib, "_checked", False):
        got = (lib.leaves_update_capacity(), lib.leaves_update_chunk())
        if got != (TABLE_LEAVES, CHUNK):
            raise RuntimeError(f"csrc/fused_update.cu has (table, chunk) "
                               f"{got}, fused_update.py "
                               f"{(TABLE_LEAVES, CHUNK)}")
        for suffix in itertools.product(_SUFFIX.values(), repeat=2):
            fn = getattr(lib, "leaves_update_%s_%s" % suffix)
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_longlong),
                           ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._checked = True
    return lib


@torch.library.custom_op("paddle_tpu_torch::leaves_update",
                         mutates_args=("ps", "ms", "vs"), device_types="cuda")
def _leaves_update_op(ps: List[torch.Tensor], gs: List[torch.Tensor],
                      ms: List[torch.Tensor], vs: List[torch.Tensor],
                      hp: torch.Tensor) -> None:
    lib = _library()
    groups = {}
    for i, (p, g) in enumerate(zip(ps, gs)):
        groups.setdefault((p.dtype, g.dtype), []).append(i)
    with torch.cuda.device(hp.device):
        stream = torch.cuda.current_stream(hp.device).cuda_stream
        for (p_dtype, g_dtype), group in groups.items():
            fn = getattr(lib, f"leaves_update_{_SUFFIX[p_dtype]}_"
                              f"{_SUFFIX[g_dtype]}")
            leaves = [(ps[i], gs[i], ms[i], vs[i]) for i in group]
            sizes = [ops[0].numel() for ops in leaves]
            vec = [int(all(t.data_ptr() % 16 == 0 for t in ops))
                   for ops in leaves]
            for tab in _plan_tables(sizes):
                k = len(tab["leaves"])
                ptrs = (ctypes.c_void_p * (4 * k))(*[
                    t.data_ptr() for i in tab["leaves"] for t in leaves[i]])
                err = fn(ptrs,
                         (ctypes.c_longlong * k)(*[sizes[i]
                                                   for i in tab["leaves"]]),
                         (ctypes.c_int * k)(*[vec[i] for i in tab["leaves"]]),
                         (ctypes.c_int * k)(*tab["chunk0"]), k,
                         tab["chunks"], hp.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(
                        f"leaves_update kernel launch failed: CUDA error "
                        f"{err} at {k} leaves, {tab['chunks']} chunks")
                launches["leaf_update"] += 1
                launches["leaf_update_leaves"] += k


def _check_operands(ps, gs, ms, vs, hp):
    if hp.dtype != torch.float32 or hp.shape != (7,):
        raise ValueError(f"leaves_update: hp {hp.dtype} {tuple(hp.shape)} "
                         "(want float32 (7,))")
    if not (len(ps) == len(gs) == len(ms) == len(vs)):
        raise ValueError(f"leaves_update: {len(ps)} p, {len(gs)} g, "
                         f"{len(ms)} m, {len(vs)} v")
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        for name, t, dtypes in (("p", p, _SUFFIX), ("g", g, _SUFFIX),
                                ("m", m, (torch.float32,)),
                                ("v", v, (torch.float32,))):
            if t.dtype not in dtypes:
                raise TypeError(f"leaves_update: leaf {i} {name} dtype "
                                f"{t.dtype} "
                                f"({'|'.join(str(d) for d in dtypes)})")
            if t.device != hp.device:
                raise ValueError(f"leaves_update: leaf {i} {name} on "
                                 f"{t.device}, hp on {hp.device}")
            if not t.is_contiguous():
                raise ValueError(f"leaves_update: leaf {i} {name} is not "
                                 "contiguous")
        if g.shape != p.shape or m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"leaves_update: leaf {i} shapes p "
                             f"{tuple(p.shape)}, g {tuple(g.shape)}, m "
                             f"{tuple(m.shape)}, v {tuple(v.shape)}")
        if p.numel() == 0:
            raise ValueError(f"leaves_update: leaf {i} has 0 elements")


def leaves_update(ps, gs, ms, vs, hp):
    """AdamW on every leaf (ps[i], gs[i], ms[i], vs[i]), IN PLACE on p, m
    and v; returns (ps, ms, vs). CPU tensors take the plain version leaf
    by leaf; CUDA tensors launch the kernel, once for each (p dtype, g
    dtype) group of up to TABLE_LEAVES leaves, or raise."""
    ps, gs, ms, vs = list(ps), list(gs), list(ms), list(vs)
    if not ps:
        return ps, ms, vs
    device = ps[0].device
    if device.type == "cpu":
        for p, g, m, v in zip(ps, gs, ms, vs):
            for t, new in zip((p, m, v), leaf_update_ref(p, g, m, v, hp)):
                t.copy_(new)
        return ps, ms, vs
    if device.type != "cuda":
        raise ValueError(f"leaves_update: unsupported device {device}")
    _check_operands(ps, gs, ms, vs, hp)
    torch.ops.paddle_tpu_torch.leaves_update(ps, gs, ms, vs, hp)
    return ps, ms, vs


def leaf_update(p, g, m, v, hp):
    """AdamW on one leaf, IN PLACE on p, m and v; returns (p, m, v): the
    kernel over a table of one on CUDA tensors, the plain version on CPU
    tensors."""
    leaves_update([p], [g], [m], [v], hp)
    return p, m, v


@torch.no_grad()
def fused_apply_adamw(grads, params, opt_state, lr, beta1=0.9, beta2=0.95,
                      eps=1e-8, weight_decay=0.1):
    """models.gpt.apply_adamw with every leaf through one `leaves_update`
    (one kernel launch for a tree of one dtype pair), IN PLACE; returns
    (params, opt_state)."""
    step = opt_state["step"].add_(1.0)
    one = torch.ones_like(step)
    hp = torch.stack([one * lr, one * beta1, one * beta2, one * eps,
                      one * weight_decay, 1.0 - beta1 ** step,
                      1.0 - beta2 ** step])
    keys = list(params)
    leaves_update([params[k] for k in keys], [grads[k] for k in keys],
                  [opt_state["m"][k] for k in keys],
                  [opt_state["v"][k] for k in keys], hp)
    return params, opt_state


def fused_update_enabled(device) -> bool:
    """The gpt.apply_adamw consult (reference pallas_update.py:127-140):
    leaves on the card, no kill switch (the global one, or
    PADDLE_TPU_DISABLE_PALLAS_UPDATE), and the registry's "fused_update"
    winner naming "pallas"."""
    from .flash_attention import _pallas_enabled
    if not _pallas_enabled() or os.environ.get(
            "PADDLE_TPU_DISABLE_PALLAS_UPDATE", "") in ("1", "true", "True"):
        return False
    return (torch.device(device).type == "cuda"
            and registry.winner("fused_update", backend="cuda") == "pallas")
