"""The checkpoint policies of the GPT train step's remat.

Counterparts of the JAX policies paddle_tpu/models/gpt.py:474-494 names,
as `context_fn`s of non-reentrant `torch.utils.checkpoint`:

- "dots" (dots_with_no_batch_dims_saveable): the matmul outputs
  (aten.mm / aten.addmm) are saved, everything else is recomputed, the
  flash forward's `paddle_tpu_torch::flash_fwd` op included;
- "dots_flash" (dots + save_only_these_names("flash_out")): the flash
  forward's op is saved too, so the backward reruns no attention;
- "offload_dots" (offload_dot_with_no_batch_dims("device",
  "pinned_host")): what "dots" saves goes to pinned host memory and
  comes back for the recompute, which reruns everything else.

Selective checkpointing caches its MUST_SAVE outputs on the device, so
"offload_dots" is a pair of dispatch modes of its own: `_OffloadSave`
copies each matmul output to a pinned host buffer on a side stream
(non-blocking, after an event on the producer's stream), and
`_OffloadLoad` answers the recompute's matmuls with those copies,
uploaded, in op order. Non-reentrant checkpoint stops its recompute
after the last tensor the backward needs (before the block's down
projection), so the replay takes a prefix of the copies and hands the
rest back to the pool unread. The host buffers come from `HOST_POOL`,
which keeps them across steps (sized by the first step): a buffer goes
back with an event on the stream that last read it, and the next copy
into it waits for that event. On CPU tensors "host" is the same
device: the copy is a plain clone.
"""
from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy,
                                   create_selective_checkpoint_contexts)

from ..kernels import flash_attention  # noqa: F401  (registers the op)

__all__ = ["POLICIES", "HOST_POOL"]

_MATMULS = frozenset({torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default})
_FLASH_FWD = torch.ops.paddle_tpu_torch.flash_fwd.default


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_flash_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op in _MATMULS or op == _FLASH_FWD
            else CheckpointPolicy.PREFER_RECOMPUTE)


class _HostPool:
    """Pinned host buffers by (shape, dtype), each free buffer with the
    event after which it may be written again (None: at once)."""

    def __init__(self):
        self._free = collections.defaultdict(list)
        self.pinned_bytes = 0          # every buffer the pool has made

    def take(self, like):
        key = (tuple(like.shape), like.dtype)
        if self._free[key]:
            return self._free[key].pop()
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        self.pinned_bytes += buf.numel() * buf.element_size()
        return buf, None

    def give(self, buf, event):
        self._free[(tuple(buf.shape), buf.dtype)].append((buf, event))

    def clear(self):
        self._free.clear()
        self.pinned_bytes = 0


HOST_POOL = _HostPool()
_SIDE_STREAMS: dict = {}


def _side_stream(device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _OffloadSave(TorchDispatchMode):
    """Forward of a checkpointed block: each matmul runs, and its output
    is copied to the host into `store`, as (host copy, event after the
    copy or None)."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _MATMULS:
            if out.device.type != "cuda":
                self.store.append((out.clone(), None))
                return out
            buf, free = HOST_POOL.take(out)
            cur = torch.cuda.current_stream(out.device)
            side = _side_stream(out.device)
            if free is not None:
                side.wait_event(free)        # its last upload is done
            side.wait_stream(cur)            # ... and so is the producer
            with torch.cuda.stream(side):
                buf.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            out.record_stream(side)
            self.store.append((buf, done))
        return out


class _OffloadLoad(TorchDispatchMode):
    """Recompute of a checkpointed block: each matmul returns the next
    stored copy, uploaded, instead of running; every buffer goes back to
    the pool at the end, taken or not."""

    def __init__(self, store):
        super().__init__()
        self.store = store
        self.taken = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _MATMULS:
            return func(*args, **(kwargs or {}))
        buf, done = self.store[self.taken]
        self.taken += 1
        if done is None:
            return buf
        dev = args[0].device
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(done)
        out = buf.to(dev, non_blocking=True)
        read = torch.cuda.Event()
        read.record(cur)
        HOST_POOL.give(buf, read)
        self.store[self.taken - 1] = (None, None)
        return out

    def __exit__(self, *exc):
        for buf, done in self.store[self.taken:]:
            if done is not None:
                HOST_POOL.give(buf, done)
        self.store.clear()
        return super().__exit__(*exc)


def _offload_contexts():
    store: list = []
    return _OffloadSave(store), _OffloadLoad(store)


# the checkpoint `context_fn` of each block-level policy but "full",
# which recomputes the whole block
POLICIES = {
    "dots": lambda: create_selective_checkpoint_contexts(_dots_policy),
    "dots_flash": lambda: create_selective_checkpoint_contexts(
        _dots_flash_policy),
    "offload_dots": _offload_contexts,
}
