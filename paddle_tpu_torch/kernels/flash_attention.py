"""Flash attention: plain versions, the Hopper kernels' wrappers, and the
autograd function the GPT train step calls.

Counterpart of paddle_tpu/kernels/flash_attention.py (the plain half:
`_dense_attention_lse`, `_blockwise_attention_lse`, `_flash_bwd`, and the
`_flash_mha` custom_vjp at :295-328, entered through `flash_attention_fn`
:465) and of paddle_tpu/kernels/pallas_attention.py (`mha_fwd` :85,
`mha_bwd` :254). Layout as the reference: q, k, v, out [B, S, H, D],
lse [B, H, Sq] f32; the causal mask is top-left aligned (q_pos >=
kv_pos) and `kv_len` masks the key suffix.

- `mha_fwd` / `mha_bwd` on CUDA tensors launch the hand-written kernels
  of csrc/flash_attention.cu (the ports of the Pallas `_fwd_kernel`,
  `_bwd_dq_kernel` and `_bwd_dkv_kernel`) after checking their operands,
  and raise on anything the kernels do not take; on CPU tensors they run
  `mha_fwd_ref` / `mha_bwd_ref`, the plain versions (the reference's
  blockwise forward and jax-level backward). They never fall back.
- Each kernel launch goes through a `torch.library.custom_op`
  (`paddle_tpu_torch::flash_fwd`, `::flash_bwd_dq`, `::flash_bwd_dkv`),
  so a selective-checkpoint policy sees it as one op (and recomputes it
  under remat "dots", as JAX reruns the pallas_call), and the profiler
  shows it by name.
- `launches[name]` counts kernel launches, forward recomputes included;
  it moves only where a kernel is launched.
- `delta = rowsum(do * out)` stays a torch op, as the reference computes
  it outside its kernels (pallas_attention.py:281).

Selection (the reference's :118-148, :306-311, :331-467), resolved once
per `FlashMHA.apply` and kept for that apply's backward:
- the kill-switch family, layered global > attention-only >
  backward-only: `use_pallas` and env PADDLE_TPU_DISABLE_PALLAS
  (`_pallas_enabled`, which the CE, AdamW and int8 routes read too),
  PADDLE_TPU_DISABLE_PALLAS_ATTN or impl "xla" (`_pallas_attn_enabled`),
  PADDLE_TPU_DISABLE_PALLAS_BWD (`_pallas_bwd_enabled`); each accepts
  "1", "true" and "True";
- the impl selector `_attn_impl(seq)`: env PADDLE_TPU_ATTN_IMPL > the
  sweep winner (perf/torch_sweep_winner.json, "cuda" class only) > the
  registry's "attention" winner > "pallas".
On CUDA tensors "pallas" launches the kernels; "xla" or an attention
kill runs the plain versions (the reference's blockwise path); a
backward-only kill runs the kernel forward and the plain backward;
"jax_flash" and "splash" name upstream TPU kernels, which the reference
routes to its own flash path off TPU-class backends, and so does the
port: they launch the kernels. No library attention is called. On CPU
tensors every route runs the plain versions.

Tiles: the bf16 forward takes (block_q, block_k) in
`flash_block_candidates` (64 or 128 q rows a block up to D = 64, 64
kv rows), chosen by an explicit argument > env
PADDLE_TPU_FLASH_BLOCK_{Q,K} > the autotune cache (kernels/autotune.py,
`_tuned_blocks`, timed on dummies when PADDLE_TPU_AUTOTUNE is on) > the
default (128, 64). An env pair the kernels lack raises ValueError; a
cached pair they lack (a TPU file shared through the env) is skipped
for the default and counted as `foreign`. The backward pair has one
tile, (64, 64), under the same rules (PADDLE_TPU_FLASH_BLOCK_BWD_{Q,K},
op "flash_bwd").
"""
import ctypes
import json
import math
import os
from typing import Optional, Tuple

import torch

__all__ = ["mha_fwd", "mha_bwd", "mha_fwd_ref", "mha_bwd_ref",
           "flash_attention_fn", "FlashMHA", "launches", "use_pallas",
           "impl_from_winner_env", "flash_block_candidates"]

_BLOCK_KV = 512

launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


# ------------------------------------------------------------ plain half
def _dense_attention_lse(q, k, v, causal, kv_len=None):
    """O(S^2) dense softmax attention in f32. [B,S,H,D] -> (out, lse)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qt = q.transpose(1, 2).float() * scale
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    s = qt @ kt.transpose(-1, -2)
    if kv_len is not None and kv_len < Skv:
        s = s.masked_fill(torch.arange(Skv, device=q.device) >= kv_len,
                          -math.inf)
    if causal:
        keep = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    out = (p / l[..., None]) @ vt
    return out.transpose(1, 2).to(q.dtype), m + torch.log(l)


def _blockwise_attention_lse(q, k, v, causal, kv_len=None):
    """Online-softmax attention over kv blocks of 512. [B,S,H,D] ->
    (out, lse [B,H,Sq] f32). Operands keep their dtype; products
    accumulate in f32 (bf16 values are exact in f32), p is rounded to
    v's dtype before p.v, as the reference's scan does."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    blk = min(_BLOCK_KV, Skv)
    if Skv % blk != 0:
        return _dense_attention_lse(q, k, v, causal, kv_len)
    qf = q.transpose(1, 2).float()
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), -math.inf, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, D), device=q.device)
    for j in range(Skv // blk):
        kblk = kt[:, :, j * blk:(j + 1) * blk]
        vblk = vt[:, :, j * blk:(j + 1) * blk]
        scores = (qf @ kblk.float().transpose(-1, -2)) * scale
        kv_pos = j * blk + torch.arange(blk, device=q.device)
        if kv_len is not None and kv_len < Skv:
            scores = scores.masked_fill(kv_pos >= kv_len, -math.inf)
        if causal:
            scores = scores.masked_fill(q_pos[:, None] < kv_pos[None, :],
                                        -math.inf)
        m_new = torch.maximum(m, scores.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(scores - m_safe[..., None])
        p = torch.where(torch.isneginf(scores), 0.0, p)
        corr = torch.exp(torch.where(torch.isneginf(m), 0.0, m) - m_safe)
        corr = torch.where(torch.isneginf(m), 0.0, corr)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.to(v.dtype).float() @ vblk.float()
        m = m_new
    l_safe = torch.clamp(l, min=1e-37)
    out = acc / l_safe[..., None]
    lse = torch.where(torch.isneginf(m), -math.inf, m + torch.log(l_safe))
    return out.transpose(1, 2).to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, do, causal, kv_len=None):
    """Flash-attention backward, p rebuilt per kv block from lse:
    delta = rowsum(do*out); ds = p*(do.v^T - delta)*scale, rounded to the
    input dtype before its two products; dq = sum_j ds_j k_j,
    dk_j = ds_j^T q, dv_j = p_j^T do."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qf = q.transpose(1, 2).float()
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    dof = do.transpose(1, 2).float()
    delta = (dof * out.transpose(1, 2).float()).sum(-1)        # B,H,Sq
    blk = min(_BLOCK_KV, Skv)
    if Skv % blk != 0:
        blk = Skv
    q_pos = torch.arange(Sq, device=q.device)
    dq = torch.zeros((B, H, Sq, D), device=q.device)
    dks, dvs = [], []
    for j in range(Skv // blk):
        kf = kt[:, :, j * blk:(j + 1) * blk].float()
        vf = vt[:, :, j * blk:(j + 1) * blk].float()
        s = (qf @ kf.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., None])
        kv_pos = j * blk + torch.arange(blk, device=q.device)
        if kv_len is not None and kv_len < Skv:
            p = p.masked_fill(kv_pos >= kv_len, 0.0)
        if causal:
            p = p.masked_fill(q_pos[:, None] < kv_pos[None, :], 0.0)
        dvs.append(p.to(do.dtype).float().transpose(-1, -2) @ dof)
        dp = dof @ vf.transpose(-1, -2)
        ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
        dq = dq + ds @ kf
        dks.append(ds.transpose(-1, -2) @ qf)
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def mha_fwd_ref(q, k, v, causal=False, kv_len=None):
    """The plain forward: [B,S,H,D] -> (out [B,S,H,D], lse [B,H,Sq])."""
    return _blockwise_attention_lse(q, k, v, causal, kv_len)


def mha_bwd_ref(q, k, v, out, lse, do, causal=False, kv_len=None):
    """The plain backward -> (dq, dk, dv) in the input dtypes."""
    return _flash_bwd(q, k, v, out, lse, do, causal, kv_len)


# ------------------------------------------------------------- selection
_ON = ("1", "true", "True")

# False turns every hand kernel off, as env PADDLE_TPU_DISABLE_PALLAS does
use_pallas = True


def _pallas_enabled() -> bool:
    """The global gate: env PADDLE_TPU_DISABLE_PALLAS, then `use_pallas`.
    The CE, AdamW and int8 routes read it too."""
    if os.environ.get("PADDLE_TPU_DISABLE_PALLAS", "") in _ON:
        return False
    return use_pallas


def _pallas_attn_enabled(seq: Optional[int] = None, device=None) -> bool:
    """Attention-only gate layered on the global one: env
    PADDLE_TPU_DISABLE_PALLAS_ATTN or impl "xla" turn the attention
    kernels off and leave the CE kernels alone."""
    if os.environ.get("PADDLE_TPU_DISABLE_PALLAS_ATTN", "") in _ON:
        return False
    if _attn_impl(seq, device) == "xla":
        return False
    return _pallas_enabled()


def _pallas_bwd_enabled(seq: Optional[int] = None, device=None) -> bool:
    """Backward-only gate layered on the attention one."""
    if os.environ.get("PADDLE_TPU_DISABLE_PALLAS_BWD", "") in _ON:
        return False
    return _pallas_attn_enabled(seq, device)


SWEEP_WINNER_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "perf", "torch_sweep_winner.json")
_sweep_winner_impl = None     # memoized SWEEP_WINNER_PATH read


def impl_from_winner_env(env: dict) -> str:
    """The sweep-spec env -> impl translation: the sweep spells "xla" as
    the PADDLE_TPU_DISABLE_PALLAS_ATTN kill switch. "" when the env names
    no recognizable impl."""
    impl = env.get("PADDLE_TPU_ATTN_IMPL", "")
    if not impl and env.get("PADDLE_TPU_DISABLE_PALLAS_ATTN") == "1":
        impl = "xla"
    return impl if impl in ("pallas", "jax_flash", "splash", "xla") \
        else ""


def _winner_impl(device=None):
    """The attention impl a measured sweep on the card adopted
    (perf/torch_sweep_winner.json, {"env": {...}}; none is committed).
    Consulted for the "cuda" backend class only, so the CPU suite keeps
    the documented "pallas" route. Memoized for the process; an absent
    or invalid file gives None."""
    global _sweep_winner_impl
    from . import registry
    if registry.backend_class(device) != "cuda":
        return None
    if _sweep_winner_impl is None:
        env = {}
        try:
            with open(SWEEP_WINNER_PATH) as f:
                env = json.load(f).get("env", {})
        except (OSError, ValueError):
            pass
        _sweep_winner_impl = impl_from_winner_env(env)
    return _sweep_winner_impl or None


def _registry_impl(seq: Optional[int] = None, device=None):
    """The registry's "attention" winner for the backend class of
    `device`: the exact shape bucket first, then the wildcard row."""
    from . import registry
    cls = registry.backend_class(device)
    bucket = registry.seq_bucket(seq) if seq else "*"
    return registry.winner("attention", backend=cls, bucket=bucket)


def _attn_impl(seq: Optional[int] = None, device=None) -> str:
    """The attention impl (PADDLE_TPU_ATTN_IMPL): env > sweep winner >
    registry > "pallas". `device` names the backend class (default: the
    card when one is present); `seq` picks the registry's bucket."""
    return (os.environ.get("PADDLE_TPU_ATTN_IMPL")
            or _winner_impl(device) or _registry_impl(seq, device)
            or "pallas")


def _route(q) -> Tuple[bool, bool]:
    """(forward, backward) through the given wrappers for one apply: the
    attention and backward gates at q's sequence and device. A gate that
    is off runs the plain version instead."""
    seq, dev = q.shape[1], q.device
    return _pallas_attn_enabled(seq, dev), _pallas_bwd_enabled(seq, dev)


# ----------------------------------------------------------------- tiles
BWD_BLOCKS = ((64, 64),)


def flash_block_candidates(head_dim: int, dtype) -> list:
    """(block_q, block_k) pairs the forward kernels are built with, the
    default first: the bf16 tensor-core forward takes 128 or 64 q rows a
    block up to D = 64 and 64 above, with 64 kv rows; the f32 forward
    64 x 64."""
    if dtype == torch.bfloat16 and head_dim <= 64:
        return [(128, 64), (64, 64)]
    return [(64, 64)]


def _flash_sig(q, k, causal) -> str:
    """The autotune key, spelled as the reference spells it."""
    B, Sq, H, D = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    return f"B{B}_Sq{Sq}_Sk{k.shape[1]}_H{H}_D{D}_c{int(causal)}_{dtype}"


def _env_blocks_set(*names) -> bool:
    """Explicit PADDLE_TPU_FLASH_BLOCK_* env overrides outrank the
    autotune cache."""
    return any(os.environ.get(n) for n in names)


def _tuned_blocks_bwd(q, k, causal):
    """Backward tiles from the cache, batch-agnostic; None = env or
    default."""
    if _env_blocks_set("PADDLE_TPU_FLASH_BLOCK_BWD_Q",
                       "PADDLE_TPU_FLASH_BLOCK_BWD_K"):
        return None
    from .autotune import cached_any_batch
    return cached_any_batch("flash_bwd", _flash_sig(q, k, causal))


def _tuned_blocks(q, k, causal):
    """Forward tiles through the autotune cache: a hit applies always; on
    a miss with tuning on and q on the card, each candidate is timed on
    zero dummies of q's and k's shapes (eagerly, without grad, outside
    any dispatch mode, so a checkpoint around the caller neither sees
    nor saves the timing launches) and the pick is cached before the
    signature's first launch. None = env or default."""
    from . import autotune
    if _env_blocks_set("PADDLE_TPU_FLASH_BLOCK_Q",
                       "PADDLE_TPU_FLASH_BLOCK_K"):
        return None
    sig = _flash_sig(q, k, causal)
    hit = autotune.cached_any_batch("flash_fwd", sig)
    if hit is not None:
        return hit
    if not autotune.enabled() or not _on_card("mha_fwd", q):
        return None
    from torch.utils._python_dispatch import _disable_current_modes
    cands = flash_block_candidates(q.shape[3], q.dtype)
    with torch.no_grad(), _disable_current_modes():
        q_c = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
        k_c = torch.zeros(k.shape, dtype=k.dtype, device=k.device)

        def runner(cand):
            _launch_fwd(q_c, k_c, k_c, causal, k.shape[1], cand,
                        count=False)
            torch.cuda.synchronize(q.device)
        return autotune.pick("flash_fwd", sig, cands, runner,
                             default=cands[0])


def _checked_pair(what, pair, cands):
    if pair not in cands:
        raise ValueError(f"flash attention: {what} names tile {pair}; the "
                         f"kernels are built for {list(cands)} here")
    return pair


def _env_pair(qname, kname, default):
    bq, bk = os.environ.get(qname), os.environ.get(kname)
    return (int(bq) if bq else default[0], int(bk) if bk else default[1])


def _pick_blocks(q, k, causal, block_q, block_k, cands, env, tuned):
    """argument > env > cache > default; an argument or env pair the
    kernels lack raises, a cached one is skipped and counted."""
    default = cands[0]
    if block_q is not None or block_k is not None:
        return _checked_pair("the call", (block_q or default[0],
                                          block_k or default[1]), cands)
    if _env_blocks_set(*env):
        return _checked_pair(f"env {'/'.join(env)}",
                             _env_pair(*env, default), cands)
    hit = tuned(q, k, causal)
    if hit is None:
        return default
    if hit not in cands:
        from . import autotune
        autotune.note_foreign()
        return default
    return hit


def _fwd_blocks(q, k, causal, block_q=None, block_k=None):
    """The forward's (block_q, block_k) for these operands."""
    return _pick_blocks(q, k, causal, block_q, block_k,
                        flash_block_candidates(q.shape[3], q.dtype),
                        ("PADDLE_TPU_FLASH_BLOCK_Q",
                         "PADDLE_TPU_FLASH_BLOCK_K"), _tuned_blocks)


def _bwd_blocks(q, k, causal):
    """The backward pair's one tile, under the forward's env and cache
    rules."""
    return _pick_blocks(q, k, causal, None, None, BWD_BLOCKS,
                        ("PADDLE_TPU_FLASH_BLOCK_BWD_Q",
                         "PADDLE_TPU_FLASH_BLOCK_BWD_K"), _tuned_blocks_bwd)


# ----------------------------------------------------------- kernel half
def _clamp_kv_len(kv_len, Skv: int) -> int:
    klen = Skv if kv_len is None else min(int(kv_len), Skv)
    if klen < 1:
        raise ValueError(f"flash attention: kv_len {kv_len} leaves no key")
    return klen


def _rows_on_16_bytes(t) -> bool:
    """The bf16 tensor-core kernels copy rows in 16-byte cp.async pieces:
    a bf16 operand starts on 16 bytes and its (batch, seq, head) strides
    are multiples of 8 elements. f32 operands take the CUDA-core kernels,
    which read element by element."""
    return t.dtype != torch.bfloat16 or (
        t.data_ptr() % 16 == 0 and not any(s % 8 for s in t.stride()[:3]))


def _check_operands(name, q, k, v, *q_like):
    """dtype, device and layout of every operand; v like k, `q_like`
    (out, do) like q. The kernels read [B, S, H, D] through strides."""
    dev, dtype = q.device, q.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} (bfloat16|float32)")
    for t in (q, k, v) + q_like:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: operands on {t.device}/{t.dtype}, "
                             f"q on {dev}/{dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name}: operands must be [B, S, H, D] with "
                             f"a unit last stride, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    D = q.shape[3]
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"{name}: head dim {D} (a multiple of 16 up to "
                         "128)")
    # All three bf16 kernels copy q, k, v (and do) rows by 16-byte
    # cp.async, so the rule is each kernel's own.
    for t in (q, k, v) + q_like:
        if not _rows_on_16_bytes(t):
            raise ValueError(
                f"{name}: bf16 operands must start on a 16-byte "
                f"boundary with (batch, seq, head) strides that are "
                f"multiples of 8, got data_ptr() % 16 = "
                f"{t.data_ptr() % 16}, strides {t.stride()}")
    if (k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]
            or v.shape != k.shape
            or any(t.shape != q.shape for t in q_like)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out/do "
                         f"{[tuple(t.shape) for t in q_like]}")


def _strides(*tensors):
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _call(kernel: str, dtype, ptrs, dims, strides, device, count=True):
    """Launch `kernel` on the current stream. `dims` ends with the tile
    (block_q, block_k); `count` is False only for the autotune's timing
    passes, which are no launches of the caller's path."""
    global tuning_launches
    from . import _build
    fn = getattr(_build.load("flash_attention"),
                 f"{kernel}_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *dims, strides, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} "
                           f"at (B, H, Sq, Skv, D, kv_len, causal, block_q, "
                           f"block_k) = {dims}")
    if count:
        launches[kernel] += 1
    else:
        tuning_launches += 1


# forward launches of the autotune's timing passes (not in `launches`)
tuning_launches = 0


def _launch_fwd(q, k, v, causal, kv_len, blocks, count=True):
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _call("flash_fwd", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None,
           out.data_ptr(), lse.data_ptr(), None),
          (B, H, Sq, Skv, D, kv_len, int(causal), *blocks),
          _strides(q, k, v), q.device, count)
    return out, lse


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, kv_len: int, block_q: int, block_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_fwd(q, k, v, causal, kv_len, (block_q, block_k))


@_flash_fwd_op.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, causal, kv_len, block_q, block_k):
    # the plain version: the same op on both devices, so that a
    # checkpoint policy names it (remat "dots_flash" saves it) and the
    # CPU tests see what it saves
    return mha_fwd_ref(q, k, v, causal, kv_len)


@torch.library.custom_op("paddle_tpu_torch::flash_fwd_plain",
                         mutates_args=())
def _flash_fwd_plain_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, kv_len: Optional[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    # the plain forward that the kill switches and impl "xla" run, as one
    # named op on every device, so that remat "dots_flash" saves it as it
    # saves the kernel's op and its backward reruns no attention
    return mha_fwd_ref(q, k, v, causal, kv_len)


def _plain_fwd(q, k, v, causal=False, kv_len=None):
    """mha_fwd_ref through the `paddle_tpu_torch::flash_fwd_plain` op."""
    return torch.ops.paddle_tpu_torch.flash_fwd_plain(q, k, v, bool(causal),
                                                      kv_len)


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dq", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, causal: bool, kv_len: int,
                     block_q: int, block_k: int) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    _call("flash_bwd_dq", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), None, None),
          (B, H, Sq, Skv, D, kv_len, int(causal), block_q, block_k),
          _strides(q, k, v, do), q.device)
    return dq


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dkv", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool, kv_len: int,
                      block_q: int, block_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dk = torch.empty((B, Skv, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Skv, H, D), dtype=v.dtype, device=v.device)
    _call("flash_bwd_dkv", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), None, dk.data_ptr(),
           dv.data_ptr()),
          (B, H, Sq, Skv, D, kv_len, int(causal), block_q, block_k),
          _strides(q, k, v, do), q.device)
    return dk, dv


def _on_card(name, q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def mha_fwd(q, k, v, causal=False, kv_len=None, block_q=None, block_k=None):
    """[B,S,H,D] -> (out [B,S,H,D], lse [B,H,Sq] f32) through the
    `paddle_tpu_torch::flash_fwd` op. CPU tensors take its CPU kernel,
    the plain version; CUDA tensors launch the kernel with the tile of
    `_fwd_blocks` or raise."""
    klen = _clamp_kv_len(kv_len, k.shape[1])
    if not _on_card("mha_fwd", q):
        return torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, bool(causal),
                                                    klen, 0, 0)
    _check_operands("mha_fwd", q, k, v)
    bq, bk = _fwd_blocks(q, k, causal, block_q, block_k)
    return torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, bool(causal), klen,
                                                bq, bk)


def mha_bwd(q, k, v, out, lse, do, causal=False, kv_len=None):
    """Flash-attention backward: q/k/v/out/do [B,S,H,D], lse [B,H,Sq]
    from mha_fwd -> (dq, dk, dv) in the input dtypes. CPU tensors take
    the plain version; CUDA tensors launch the dq and dk/dv kernels or
    raise."""
    if not _on_card("mha_bwd", q):
        return mha_bwd_ref(q, k, v, out, lse, do, causal, kv_len)
    _check_operands("mha_bwd", q, k, v, out, do)
    B, Sq, H, _ = q.shape
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"mha_bwd: lse {tuple(lse.shape)} {lse.dtype}, "
                         f"want {(B, H, Sq)} float32")
    klen = _clamp_kv_len(kv_len, k.shape[1])
    bq, bk = _bwd_blocks(q, k, causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    dq = torch.ops.paddle_tpu_torch.flash_bwd_dq(
        q, k, v, do, lse, delta, bool(causal), klen, bq, bk)
    dk, dv = torch.ops.paddle_tpu_torch.flash_bwd_dkv(
        q, k, v, do, lse, delta, bool(causal), klen, bq, bk)
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """Attention whose forward is `fwd` (mha_fwd: the kernel) and whose
    backward is `bwd` (mha_bwd: the two backward kernels), saving
    (q, k, v, out, lse) and no [S, S] tensor, as the reference's
    `_flash_mha` custom_vjp does. The route is resolved once per apply
    (`_route`) and kept for its backward: a gate that is off swaps in
    the plain forward (mha_fwd_ref, through its named op
    `paddle_tpu_torch::flash_fwd_plain`) or mha_bwd_ref."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len, fwd, bwd):
        use_fwd, use_bwd = _route(q)
        out, lse = (fwd if use_fwd else _plain_fwd)(q, k, v, causal=causal,
                                                    kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kv_len = causal, kv_len
        ctx.bwd = bwd if use_bwd else mha_bwd_ref
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or not _rows_on_16_bytes(do):
            # e.g. the expanded cotangent of out.sum(), or a view off 16
            # bytes: the kernels read [B, S, H, D] with a unit last
            # stride and, in bf16, rows on 16 bytes. A fresh copy meets
            # both (contiguous() would keep a contiguous misaligned view)
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, do, causal=ctx.causal,
                             kv_len=ctx.kv_len)
        return dq, dk, dv, None, None, None, None


def flash_attention_fn(q, k, v, causal=False, kv_len: Optional[int] = None,
                       fwd=mha_fwd, bwd=mha_bwd):
    """[B,S,H,D] attention with the memory-efficient backward, the entry
    the GPT and Llama train steps call (the reference's
    `flash_attention_fn` :465 over `_dispatch_mha` :441). `fwd` and `bwd`
    default to the kernel wrappers; a caller that wants the same path
    without the kernels passes mha_fwd_ref and mha_bwd_ref. Every impl
    lands here: "jax_flash" and "splash" name upstream TPU kernels, which
    the reference takes on TPU-class backends only and otherwise routes
    to its own flash path, as the port does on CUDA; "xla" and the kill
    switches are read by FlashMHA's gates."""
    return FlashMHA.apply(q, k, v, bool(causal), kv_len, fwd, bwd)
