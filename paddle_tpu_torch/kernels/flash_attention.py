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

The port has no attention selector: on CUDA attention always launches
the kernels, on the CPU it always runs the plain versions.
"""
import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = ["mha_fwd", "mha_bwd", "mha_fwd_ref", "mha_bwd_ref",
           "flash_attention_fn", "FlashMHA", "launches"]

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


def _call(kernel: str, dtype, ptrs, dims, strides, device):
    from . import _build
    fn = getattr(_build.load("flash_attention"),
                 f"{kernel}_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *dims, strides, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} "
                           f"at (B, H, Sq, Skv, D, kv_len, causal) = {dims}")
    launches[kernel] += 1


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, kv_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _call("flash_fwd", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None,
           out.data_ptr(), lse.data_ptr(), None),
          (B, H, Sq, Skv, D, kv_len, int(causal)), _strides(q, k, v),
          q.device)
    return out, lse


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dq", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, causal: bool, kv_len: int
                     ) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    _call("flash_bwd_dq", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), None, None),
          (B, H, Sq, Skv, D, kv_len, int(causal)), _strides(q, k, v, do),
          q.device)
    return dq


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dkv", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool, kv_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dk = torch.empty((B, Skv, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Skv, H, D), dtype=v.dtype, device=v.device)
    _call("flash_bwd_dkv", q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), None, dk.data_ptr(),
           dv.data_ptr()),
          (B, H, Sq, Skv, D, kv_len, int(causal)), _strides(q, k, v, do),
          q.device)
    return dk, dv


def _on_card(name, q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def mha_fwd(q, k, v, causal=False, kv_len=None):
    """[B,S,H,D] -> (out [B,S,H,D], lse [B,H,Sq] f32). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if not _on_card("mha_fwd", q):
        return mha_fwd_ref(q, k, v, causal, kv_len)
    _check_operands("mha_fwd", q, k, v)
    return torch.ops.paddle_tpu_torch.flash_fwd(
        q, k, v, bool(causal), _clamp_kv_len(kv_len, k.shape[1]))


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
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    dq = torch.ops.paddle_tpu_torch.flash_bwd_dq(
        q, k, v, do, lse, delta, bool(causal), klen)
    dk, dv = torch.ops.paddle_tpu_torch.flash_bwd_dkv(
        q, k, v, do, lse, delta, bool(causal), klen)
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """Attention whose forward is `fwd` (mha_fwd: the kernel) and whose
    backward is `bwd` (mha_bwd: the two backward kernels), saving
    (q, k, v, out, lse) and no [S, S] tensor, as the reference's
    `_flash_mha` custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len, fwd, bwd):
        out, lse = fwd(q, k, v, causal=causal, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kv_len, ctx.bwd = causal, kv_len, bwd
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
    """[B,S,H,D] attention with the memory-efficient backward. `fwd` and
    `bwd` default to the kernel wrappers; a caller that wants the same
    path without the kernels passes mha_fwd_ref and mha_bwd_ref."""
    return FlashMHA.apply(q, k, v, bool(causal), kv_len, fwd, bwd)
