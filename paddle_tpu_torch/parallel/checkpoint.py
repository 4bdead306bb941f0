"""Sharded checkpoints that load under another plan — the port's
counterpart of paddle_tpu/parallel/checkpoint.py (`_flatten` /
`_unflatten` :107-142, the spec JSON :145-168, `_CRC32Writer` /
`_write_shard` :200-224, `update_latest` / `read_latest` :226-245,
`HostSnapshot` :281, `save_sharded` :312-444, `verify_checkpoint` /
`is_intact` :505-528, `_read_block` :532, `load_sharded` :591, the
root resolution and orphan recovery :668-761, `Converter` :764,
`CheckpointManager` :778, `save_train_state` / `load_train_state`
:996-1009).

The on-disk format is the reference's, so a checkpoint written by
either package loads in the other: a directory of `.npy` shard files
and a `manifest.json` {"format": 2, "leaves": {key: entry}}, keys the
tree paths joined by "/" (list items as "#i"); an array entry records
its global `shape`, `dtype`, partition `spec` (JSON of the P) and
`shards` [{file, window, bytes, crc32}], each window the shard's global
[start, stop) per dim; a scalar entry its `value` and `dtype` (ints
kept exact past 2**53). A `LATEST` file beside the snapshot names it.
Loading reads, for every block the target layout asks for, the saved
windows that overlap it, so a snapshot saved under one plan loads under
any other (the manifest is the reshape contract).

Tensors here are plain local tensors, so a sharded leaf says how it is
cut through `shardings`: a tree beside the state whose leaves are
parallel.mesh `Sharding`s (a sharded step's `in_pins`); a leaf without
one is a full value.

Many ranks, one host: the reference commits one manifest from one
process holding every device. Here each rank is a process, and the
single-host contract is kept across them:
- every rank writes only the replica-0 copy of each of its windows
  (the lowest rank holding it: every mesh axis its spec does not name
  at coordinate 0), to a file named after the leaf and its rank
  (`<leaf>.p0.s<rank>.npy`), so every distinct window is written once;
- the ranks meet on a gloo group made for the purpose (`coord_group`,
  created in the calling thread the first time, by every rank), never
  on the group the step's collectives use: rank 0 names the staging
  directory, every rank's part of the manifest is gathered to rank 0,
  which writes the manifest listing every rank's shards, renames the
  staging directory into place, moves `LATEST`, runs the manager's
  keep-K pruning, and only then releases the others. No rank's save
  returns before the commit, and a rank that fails fails every rank's
  save, with nothing committed.

A full-depth TinyLlama-width train state is 12.4 GB of f32, so the
async save's snapshot goes through pinned host buffers the manager
keeps and reuses; the copies are queued on the current stream and the
writer thread waits on their event, so the step path pays the copies'
device time, not a host sync.

Training state is f32 and int64. numpy has no bfloat16 without
ml_dtypes, so a bfloat16 leaf is refused by name rather than written in
a form the reference would cast by value.

The reference's monitor counters and gauges, `RecordEvent` spans and
flight-recorder dumps wait for ROADMAP A7; each call site keeps a
one-line comment naming what waits.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .mesh import (P, Sharding, _entry_axes, axis_index, axis_names,
                   get_mesh, mesh_device, sharding_for)

__all__ = ["CheckpointCorruptError", "AsyncSaveError", "HostSnapshot",
           "save_sharded", "verify_checkpoint", "is_intact",
           "load_sharded", "update_latest", "read_latest", "Converter",
           "CheckpointManager", "save_train_state", "load_train_state",
           "audit_forget", "coord_group"]

_MANIFEST = "manifest.json"
_LATEST = "LATEST"


class _Unset:
    """Sentinel so `load_sharded(mesh=None)` can mean "full tensors"
    even while a mesh is ambient."""

    def __repr__(self):
        return "<unset>"


_UNSET = _Unset()


class CheckpointCorruptError(ValueError):
    """A checkpoint directory failed integrity verification (missing or
    truncated shard file, checksum mismatch, unparseable manifest)."""


class AsyncSaveError(RuntimeError):
    """A background checkpoint write (CheckpointManager.save_async)
    failed; raised at the next wait()/save_async()/save() barrier so the
    failure cannot pass silently. The original exception is chained."""


# Committed checkpoint paths this process wrote; a test fixture can
# verify every entry's checksums at teardown.
_AUDIT: List[str] = []


def audit_forget(path: str) -> None:
    """Exempt `path` from the write audit (the fault injectors of
    paddle_tpu_torch.testing.faults call this)."""
    path = os.path.abspath(path)
    _AUDIT[:] = [p for p in _AUDIT if p != path]


# Fault-injection seam (paddle_tpu_torch.testing.faults): called after
# each shard file is durably written, with this rank's running count.
# Production code never sets it.
_SHARD_WRITE_HOOK = None


# ------------------------------------------------------------- tree <-> flat
def _flatten(tree, prefix=""):
    """Nested dict/list/tuple of leaves -> {path: leaf}. A P (a tuple
    subclass) is a leaf, so spec overrides are never flattened away."""
    out = {}
    if isinstance(tree, P):
        out[prefix[:-1]] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and all(
                k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)


def _spec_to_json(spec) -> list:
    if spec is None:
        return []
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append(list(e))
        else:
            out.append(e)
    return out


def _spec_from_json(entries) -> P:
    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])


# ---------------------------------------------------------------- durability
def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_durable(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _atomic_write(path: str, text: str) -> None:
    """Write `path` through a tmp file and a rename, so readers never see
    a torn file (the LATEST pointer)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    _write_durable(tmp, text.encode())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


class _CRC32Writer:
    """File-object wrapper accumulating the CRC32 and byte count as
    np.save streams through it: one copy of a shard live, never two."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.nbytes = 0

    def write(self, data):
        n = self._f.write(data)
        self.crc = zlib.crc32(data, self.crc) & 0xFFFFFFFF
        self.nbytes += len(data)
        return n


# shard files are written and checked this many at a time (zlib's CRC
# and file I/O release the GIL)
_IO_WORKERS = max(1, min(8, os.cpu_count() or 1))
_CHUNK = 64 << 20


def _parallel(fn, items) -> list:
    """[fn(x) for x in items] on up to _IO_WORKERS threads, in order; the
    first failure (in order) is raised once every call has ended."""
    items = list(items)
    if len(items) <= 1 or _IO_WORKERS == 1:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(_IO_WORKERS, len(items))) as ex:
        return list(ex.map(fn, items))


def _write_shard(path: str, arr: np.ndarray) -> _CRC32Writer:
    """np.save's bytes: the .npy header, then the array's buffer in
    64 MiB slices straight from memory (np.save through a file-like
    object would copy every chunk first)."""
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        w = _CRC32Writer(f)
        header = np.lib.format.header_data_from_array_1_0(arr)
        try:
            np.lib.format.write_array_header_1_0(w, header)
        except ValueError:
            np.lib.format.write_array_header_2_0(w, header)
        data = memoryview(arr.reshape(-1)).cast("B")
        for i in range(0, len(data), _CHUNK):
            w.write(data[i:i + _CHUNK])
        f.flush()
        os.fsync(f.fileno())
    return w


def update_latest(path: str) -> None:
    """Atomically point the `LATEST` file beside `path` at it."""
    parent = os.path.dirname(os.path.abspath(path))
    _atomic_write(os.path.join(parent, _LATEST),
                  os.path.basename(path) + "\n")


def read_latest(parent: str) -> Optional[str]:
    """The checkpoint path the `LATEST` pointer under `parent` names
    (None when absent or dangling)."""
    try:
        with open(os.path.join(parent, _LATEST)) as f:
            name = f.read().strip()
    except OSError:
        return None
    if not name:
        return None
    cand = os.path.join(parent, name)
    return cand if os.path.isdir(cand) else None


# ------------------------------------------------------------------- ranks
_COORD: Dict[str, Any] = {"world": None, "group": None}


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def coord_group():
    """The gloo group the ranks of a save meet on, over the whole world,
    made the first time it is asked for (a collective: every rank must
    ask, in the same thread role) and again after the default group is
    replaced. None in a world of one. It carries only the save's own
    small messages, so a writer thread never shares the group of the
    step's collectives."""
    import torch.distributed as dist
    if _world()[1] == 1:
        return None
    world = dist.group.WORLD
    if _COORD["world"] is not world:
        _COORD["group"] = dist.new_group(backend="gloo")
        _COORD["world"] = world
    return _COORD["group"]


# ------------------------------------------------------- leaves and windows
_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.int64: "int64",
              torch.int32: "int32", torch.int16: "int16",
              torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _np_dtype(key: str, dtype: torch.dtype) -> str:
    if dtype not in _NP_DTYPES:
        raise TypeError(
            f"checkpoint leaf {key!r} is {dtype}: the on-disk format is "
            f"numpy's, which has no "
            f"{'bfloat16 without ml_dtypes' if dtype == torch.bfloat16 else str(dtype)}"
            f" (training state is f32 and int64; cast it first)")
    return _NP_DTYPES[dtype]


def _is_scalar(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dim() == 0
    return np.isscalar(leaf) or (isinstance(leaf, np.ndarray)
                                 and leaf.ndim == 0)


def _writer_of(sharding: Sharding) -> bool:
    """Whether this rank writes its window of a leaf pinned by
    `sharding`: replica 0, the lowest rank holding the window, is the
    one at coordinate 0 of every mesh axis the spec does not name."""
    used = {a for e in sharding.spec for a in _entry_axes(e)}
    return all(axis_index(sharding.mesh, a) == 0
               for a in axis_names(sharding.mesh) if a not in used)


def _window(sharding: Optional[Sharding], local_shape) -> Tuple[list, list]:
    """(global shape, this rank's global window) of a local block."""
    if sharding is None:
        shape = [int(s) for s in local_shape]
        return shape, [[0, s] for s in shape]
    idx = sharding.local_index()
    shape, window = [], []
    for d, s in enumerate(local_shape):
        i, n = idx[d] if d < len(idx) else (0, 1)
        shape.append(int(s) * n)
        window.append([i * int(s), (i + 1) * int(s)])
    return shape, window


class _HostLeaf:
    """One array leaf as the manifest records it: global shape, dtype,
    spec, and the (shard index, window, host array) of each shard this
    rank writes (the array may be a thunk making it, so the synchronous
    save pulls a shard only when a writer takes it)."""

    __slots__ = ("shape", "dtype", "spec", "shards")

    def __init__(self, shape, dtype, spec, shards):
        self.shape = shape
        self.dtype = dtype
        self.spec = spec
        self.shards = shards


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").contiguous().numpy()


def _leaf_shards(key, leaf, sharding, rank, world):
    """The replica-0 shards of `leaf` this rank writes, as a _HostLeaf
    whose arrays are pulled to the host when written (the synchronous
    save keeps a shard a writer thread live on the host)."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
        np.asarray(leaf))
    dtype = _np_dtype(key, t.dtype)
    shape, window = _window(sharding, t.shape)
    spec = _spec_to_json(sharding.spec) if sharding is not None else []
    mine = (_writer_of(sharding) if sharding is not None else rank == 0)
    shards = [(rank, window, lambda: _to_numpy(t))] if mine else []
    return _HostLeaf(shape, dtype, spec, shards)


class _PendingScalar:
    """A 0-d device tensor copied into a pinned host buffer; read once
    the snapshot's copies have landed."""

    __slots__ = ("buf",)

    def __init__(self, buf):
        self.buf = buf


class HostSnapshot:
    """A state tree held in host buffers (flat {key: scalar | _HostLeaf})
    that later steps cannot change: save_sharded accepts one in place of
    the live tree. Each shard this rank writes is copied into a host
    buffer at construction: on the card, a pinned buffer (from `pool`,
    {(key, shape, dtype): buffer}, reused across saves) filled by a copy
    queued on the current stream, with an event the writer waits on
    (`wait`), so later in-place updates, queued after it, cannot reach
    it; on the CPU, a copy. `shardings` as save_sharded's."""

    def __init__(self, state, shardings=None, pool=None):
        rank, world = _world()
        flat_sh = _flatten(shardings) if shardings is not None else {}
        self.flat: Dict[str, Any] = {}
        self._event = None
        # bytes of host buffers this snapshot had to allocate (0 when the
        # pool had them all)
        self.alloc_bytes = 0
        pool = {} if pool is None else pool
        on_card = False
        for key, leaf in _flatten(state).items():
            if _is_scalar(leaf):
                if not isinstance(leaf, torch.Tensor):
                    self.flat[key] = np.asarray(leaf)
                elif leaf.is_cuda:
                    _np_dtype(key, leaf.dtype)
                    buf = self._buffer(pool, (key, (), leaf.dtype), leaf,
                                       True)
                    buf.copy_(leaf, non_blocking=True)
                    self.flat[key] = _PendingScalar(buf)
                    on_card = True
                else:
                    self.flat[key] = np.asarray(
                        leaf.item(), dtype=_np_dtype(key, leaf.dtype))
                continue
            t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
                np.asarray(leaf))
            sharding = flat_sh.get(key)
            dtype = _np_dtype(key, t.dtype)
            shape, window = _window(sharding, t.shape)
            spec = _spec_to_json(sharding.spec) if sharding is not None \
                else []
            mine = (_writer_of(sharding) if sharding is not None
                    else rank == 0)
            shards = []
            if mine:
                pk = (key, tuple(t.shape), t.dtype)
                buf = self._buffer(pool, pk, t, t.is_cuda)
                buf.copy_(t.detach(), non_blocking=t.is_cuda)
                on_card = on_card or t.is_cuda
                shards.append((rank, window, buf))
            self.flat[key] = _HostLeaf(shape, dtype, spec, shards)
        if on_card:
            self._event = torch.cuda.Event()
            self._event.record()

    def _buffer(self, pool, key, like, pinned):
        buf = pool.get(key)
        if buf is None:
            buf = torch.empty(tuple(like.shape), dtype=like.dtype,
                              pin_memory=bool(pinned))
            pool[key] = buf
            self.alloc_bytes += buf.numel() * buf.element_size()
        return buf

    def wait(self) -> None:
        """Block until the snapshot's copies have landed (a no-op for a
        CPU snapshot or once waited)."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None

    @property
    def nbytes(self) -> int:
        total = 0
        for leaf in self.flat.values():
            if isinstance(leaf, _HostLeaf):
                total += sum(b.numel() * b.element_size()
                             for _si, _w, b in leaf.shards)
            elif isinstance(leaf, _PendingScalar):
                total += leaf.buf.element_size()
            else:
                total += leaf.nbytes
        return total


# ------------------------------------------------------------------- save
def save_sharded(state, path: str, update_pointer: bool = True,
                 shardings=None, on_commit=None) -> str:
    """Write `state` (nested dict/list of tensors, numpy arrays and
    scalars, or a HostSnapshot) as a sharded checkpoint directory,
    crash-safely: staged in `<path>.tmp-<nonce>`, every shard's CRC32
    and byte size in the manifest, files and directories fsynced, the
    manifest written last, then one atomic rename onto `path` (a
    re-save swaps the previous directory out through `<path>.old-
    <nonce>`), then `LATEST` (with `update_pointer`). `shardings` gives
    the Sharding of each local-shard leaf (a tree beside `state`).
    Across ranks every rank must call it; see the module docstring.
    `on_commit` runs on the committing rank after the commit and before
    any rank returns (the manager's pruning). The reference's multi-host
    branch (`process_index=`, each host's manifest listing only its own
    shards) has no counterpart: ranks here share one commit. Returns
    `path`."""
    # waits for A7: the `checkpoint.save` span and the checkpoint_save /
    # checkpoint_save_ms monitor stats
    return _save_sharded_impl(state, path, update_pointer, shardings,
                              on_commit)


def _flat_state(state, shardings, rank, world):
    """{key: scalar ndarray | _HostLeaf} of `state` for this rank."""
    if isinstance(state, HostSnapshot):
        state.wait()
        out = {}
        for key, leaf in state.flat.items():
            if isinstance(leaf, _PendingScalar):
                out[key] = leaf.buf.numpy().copy()
            elif isinstance(leaf, _HostLeaf):
                out[key] = _HostLeaf(leaf.shape, leaf.dtype, leaf.spec, [
                    (si, w, b.numpy()) for si, w, b in leaf.shards])
            else:
                out[key] = leaf
        return out
    flat_sh = _flatten(shardings) if shardings is not None else {}
    out = {}
    for key, leaf in _flatten(state).items():
        if _is_scalar(leaf):
            if isinstance(leaf, torch.Tensor):
                out[key] = np.asarray(leaf.item(),
                                      dtype=_np_dtype(key, leaf.dtype))
            else:
                out[key] = np.asarray(leaf)
        else:
            out[key] = _leaf_shards(key, leaf, flat_sh.get(key), rank,
                                    world)
    return out


def _write_leaves(flat, stage) -> Dict[str, Any]:
    """Write this rank's shards into `stage` (_IO_WORKERS files at a
    time); returns its manifest part {key: entry}."""
    leaves: Dict[str, Any] = {}
    tasks = []
    for key, leaf in flat.items():
        safe = key.replace("/", "%")
        if not isinstance(leaf, _HostLeaf):
            leaves[key] = {
                "kind": "scalar",
                # .item(): json ints are exact, so an int64 counter
                # survives past 2**53
                "value": leaf.item(),
                "dtype": str(leaf.dtype),
            }
            continue
        entry = {"kind": "array", "shape": leaf.shape, "dtype": leaf.dtype,
                 "spec": leaf.spec, "shards": []}
        for si, window, data in leaf.shards:
            rec = {"file": f"{safe}.p0.s{si}.npy", "window": window}
            entry["shards"].append(rec)
            tasks.append((rec, data))
        leaves[key] = entry
    lock = threading.Lock()
    written = [0]

    def write(task):
        rec, data = task
        w = _write_shard(os.path.join(stage, rec["file"]),
                         data() if callable(data) else data)
        rec["bytes"], rec["crc32"] = w.nbytes, w.crc
        with lock:
            written[0] += 1
            n = written[0]
        if _SHARD_WRITE_HOOK is not None:
            _SHARD_WRITE_HOOK(n)
    _parallel(write, tasks)
    return leaves


def _merge_parts(parts) -> Dict[str, Any]:
    """One manifest from every rank's part: each leaf's entry with the
    shards of every rank, in rank order."""
    manifest: Dict[str, Any] = {"format": 2, "leaves": {}}
    for part in parts:
        for key, entry in part.items():
            have = manifest["leaves"].get(key)
            if have is None:
                manifest["leaves"][key] = dict(entry)
                if entry["kind"] == "array":
                    manifest["leaves"][key]["shards"] = list(
                        entry["shards"])
            elif entry["kind"] == "array":
                have["shards"].extend(entry["shards"])
    return manifest


def _commit(stage, path, manifest, update_pointer, on_commit) -> None:
    """Manifest last, then the atomic rename and the pointer."""
    _write_durable(os.path.join(stage, _MANIFEST),
                   json.dumps(manifest, indent=1).encode())
    _fsync_dir(stage)
    if os.path.isdir(path):
        # the previous directory (perhaps under another sharding, with
        # files this save would not overwrite) is swapped out whole
        old = f"{path}.old-{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.replace(path, old)
        os.replace(stage, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(stage, path)
    _fsync_dir(os.path.dirname(path))
    if update_pointer:
        update_latest(path)
    _AUDIT.append(path)
    if len(_AUDIT) > 256:               # bounded: a long run is not a leak
        del _AUDIT[:-128]
    if on_commit is not None:
        on_commit()


def _save_sharded_impl(state, path, update_pointer, shardings, on_commit):
    path = os.path.abspath(path)
    rank, world = _world()
    flat = _flat_state(state, shardings, rank, world)
    if world == 1:
        stage = f"{path}.tmp-{os.getpid()}"
        if os.path.isdir(stage):
            shutil.rmtree(stage)
        os.makedirs(stage)
        part = _write_leaves(flat, stage)
        _fsync_dir(stage)
        _commit(stage, path, _merge_parts([part]), update_pointer,
                on_commit)
        return path
    return _save_ranks(flat, path, rank, world, update_pointer, on_commit)


def _save_ranks(flat, path, rank, world, update_pointer, on_commit):
    """The save across ranks: rank 0 names and makes the staging
    directory, every rank writes its shards and sends its part, rank 0
    commits (or not, when any rank failed), and every rank learns the
    outcome before it returns."""
    import torch.distributed as dist
    group = coord_group()
    box = [None, None]
    if rank == 0:
        stage = f"{path}.tmp-{os.getpid()}"
        try:
            if os.path.isdir(stage):
                shutil.rmtree(stage)
            os.makedirs(stage)
            box = [stage, None]
        except OSError as e:
            box = [stage, repr(e)]
    dist.broadcast_object_list(box, src=0, group=group)
    stage, err = box
    if err is not None:
        raise OSError(f"checkpoint staging failed on rank 0: {err}")
    own: Optional[BaseException] = None
    try:
        part = _write_leaves(flat, stage)
        _fsync_dir(stage)
        msg = (part, None)
    except BaseException as e:          # every rank learns of it below
        own = e
        msg = (None, f"rank {rank}: {e!r}")
    parts = [None] * world if rank == 0 else None
    dist.gather_object(msg, parts, dst=0, group=group)
    status = [None]
    if rank == 0:
        errs = [m[1] for m in parts if m[1] is not None]
        if errs:
            status = ["; ".join(errs)]
        else:
            try:
                _commit(stage, path, _merge_parts([m[0] for m in parts]),
                        update_pointer, on_commit)
            except BaseException as e:
                own = own or e
                status = [f"rank 0 commit: {e!r}"]
    dist.broadcast_object_list(status, src=0, group=group)
    if own is not None:
        raise own
    if status[0] is not None:
        raise RuntimeError(f"checkpoint {path!r} not committed: "
                           f"{status[0]}")
    return path


# ------------------------------------------------------------------- verify
def _load_manifest(path: str) -> Dict[str, Any]:
    mpath = os.path.join(path, _MANIFEST)
    try:
        with open(mpath) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"{path!r} has no {_MANIFEST} — not a committed checkpoint "
            f"(a crash before the atomic rename leaves only *.tmp-* "
            f"staging dirs)") from e
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"{path!r}: unparseable {_MANIFEST}: {e}") from e


def _check_shard_meta(path, sh, nbytes, crc):
    if "crc32" not in sh:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: shard {sh['file']!r} has no recorded "
            f"checksum — written by an unchecksummed path?")
    if nbytes != sh.get("bytes"):
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: shard {sh['file']!r} is "
            f"{nbytes} bytes, manifest says {sh.get('bytes')} — "
            f"truncated write")
    if crc != sh["crc32"]:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: shard {sh['file']!r} checksum mismatch "
            f"(crc32 {crc:#010x} != recorded {sh['crc32']:#010x}) — "
            f"bit rot or torn write")


def _missing_shard(path, sh):
    return CheckpointCorruptError(
        f"checkpoint {path!r} is missing data: shard file "
        f"{sh['file']!r} is listed in the manifest but absent on disk "
        f"— partial or corrupted checkpoint directory")


def _verify_shard_stream(path: str, sh: Dict[str, Any],
                         blocksize: int = 1 << 24) -> None:
    """CRC a shard file in O(blocksize) memory."""
    try:
        f = open(os.path.join(path, sh["file"]), "rb")
    except FileNotFoundError as e:
        raise _missing_shard(path, sh) from e
    crc, nbytes = 0, 0
    with f:
        while True:
            block = f.read(blocksize)
            if not block:
                break
            crc = zlib.crc32(block, crc) & 0xFFFFFFFF
            nbytes += len(block)
    _check_shard_meta(path, sh, nbytes, crc)


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Full integrity pass: the manifest parses and every shard file
    matches its recorded byte size and CRC32. Raises
    CheckpointCorruptError on the first violation; returns the
    manifest."""
    # waits for A7: the `checkpoint.verify` span and counter
    manifest = _load_manifest(path)
    _parallel(lambda sh: _verify_shard_stream(path, sh),
              [sh for entry in manifest["leaves"].values()
               if entry["kind"] == "array" for sh in entry["shards"]])
    return manifest


def is_intact(path: str) -> bool:
    """True when `path` is a committed checkpoint that passes full
    verification."""
    try:
        verify_checkpoint(path)
        return True
    except CheckpointCorruptError:
        return False


# ------------------------------------------------------------------- load
def _read_block(path, entry, want, verified: Optional[set] = None):
    """The numpy block for the global window `want` (a tuple of slices),
    assembled from the saved windows overlapping it. With `verified` a
    set, each shard file is CRC-checked once per load before use."""
    shape = entry["shape"]
    dtype = np.dtype(entry["dtype"])
    starts = [0 if s.start is None else s.start for s in want]
    stops = [shape[d] if s.stop is None else s.stop
             for d, s in enumerate(want)]
    block = np.empty([b - a for a, b in zip(starts, stops)], dtype)
    filled = 0
    for sh in entry["shards"]:
        win = sh["window"]
        inter = [(max(a, w0), min(b, w1))
                 for (a, b), (w0, w1) in zip(zip(starts, stops), win)]
        if any(a >= b for a, b in inter):
            continue
        if verified is not None and "crc32" in sh \
                and sh["file"] not in verified:
            _verify_shard_stream(path, sh)
            verified.add(sh["file"])
        try:
            data = np.load(os.path.join(path, sh["file"]), mmap_mode="r")
        except FileNotFoundError as e:
            raise CheckpointCorruptError(
                f"checkpoint is missing data: shard file "
                f"{sh['file']!r} is listed in the manifest but absent "
                f"on disk — partial or corrupted checkpoint "
                f"directory") from e
        src = tuple(slice(a - w0, b - w0)
                    for (a, b), (w0, w1) in zip(inter, win))
        dst = tuple(slice(a - s, b - s) for (a, b), s in zip(inter, starts))
        block[dst] = data[src]
        filled += int(np.prod([b - a for a, b in inter]))
    total = int(np.prod(block.shape))
    if filled < total:
        raise CheckpointCorruptError(
            f"checkpoint is missing data for window {want} "
            f"({filled}/{total} elements found) — was it written by a "
            "multi-host run whose other hosts' files are absent?")
    return block


def _check_template(manifest, template, path):
    have = set(manifest["leaves"])
    want = set(_flatten(template))
    missing = sorted(want - have)
    extra = sorted(have - want)
    if missing or extra:
        raise ValueError(
            f"checkpoint {path!r} does not match the expected state tree: "
            f"missing leaves {missing or '[]'}, unexpected leaves "
            f"{extra or '[]'}")


def _local_window(sharding: Sharding, shape) -> tuple:
    """This rank's block of a global `shape` under `sharding`, as
    slices."""
    out = []
    idx = sharding.local_index()
    for d, s in enumerate(shape):
        i, n = idx[d] if d < len(idx) else (0, 1)
        step = s // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def load_sharded(path: str, mesh=_UNSET, specs=None, template=None,
                 verify: bool = True, device=None):
    """Load a sharded checkpoint onto `mesh`.

    `mesh` defaults to the ambient one; `mesh=None` (explicit) gives
    full tensors even while a mesh is ambient. On a mesh, each leaf
    comes back as this rank's block under its spec — `specs` (a tree
    of P, per key) overrides the recorded ones: pass the target plan's
    to load onto another layout — shape-aware as parallel.mesh's
    sharding_for, on the mesh's device. `device` places the mesh=None
    tensors (default: this rank's card; pass "cpu" for the CPU).
    Scalars come back as 0-d tensors of their recorded dtype on the
    same device. `template` (a state-shaped tree) asserts the
    checkpoint holds exactly its leaves, naming missing and extra keys.
    With `verify`, every shard file read is checked against its CRC32
    first.

    If `path` is not a committed checkpoint but a CheckpointManager
    root (a `LATEST` pointer), the pointed snapshot is loaded, falling
    back to the newest intact one; a bare path whose commit rename was
    interrupted recovers its complete sibling `<path>.{tmp,old}-*`."""
    # waits for A7: the `checkpoint.load` span and counter
    return _load_sharded_impl(path, mesh, specs, template, verify, device)


def _load_sharded_impl(path, mesh, specs, template, verify, device):
    if mesh is _UNSET:
        mesh = get_mesh()
    if not os.path.exists(os.path.join(path, _MANIFEST)):
        resolved = _resolve_root(path)
        if resolved is None:
            resolved = next((c for c in _sibling_orphans(path)
                             if is_intact(c)), None)
        if resolved is not None:
            path = resolved
            verify = False       # is_intact just ran the full CRC pass
    manifest = _load_manifest(path)
    if template is not None:
        _check_template(manifest, template, path)
    if mesh is not None:
        dev = mesh_device(mesh)
    else:
        from ..device import resolve_device
        dev = resolve_device(device)
    flat_specs = _flatten(specs) if isinstance(specs, dict) else {}
    verified: Optional[set] = set() if verify else None

    def load(item):
        key, entry = item
        if entry["kind"] == "scalar":
            return key, torch.as_tensor(
                np.asarray(entry["value"], np.dtype(entry["dtype"])),
                device=dev)
        shape = tuple(entry["shape"])
        if mesh is None:
            want = tuple(slice(None) for _ in shape)
        else:
            spec = flat_specs.get(key)
            if spec is None:
                spec = _spec_from_json(entry["spec"])
            want = _local_window(sharding_for(spec, mesh, shape=shape),
                                 shape)
        block = _read_block(path, entry, want, verified)
        return key, torch.from_numpy(block).to(dev)
    # the leaves are read _IO_WORKERS at a time
    return _unflatten(dict(_parallel(load, manifest["leaves"].items())))


def _snapshot_steps(root: str, prefix: str = "ckpt") -> List[Tuple[int, str]]:
    """Committed `<prefix>-<step>` snapshot dirs under `root`,
    step-sorted ascending."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        if not name.startswith(prefix + "-") or ".tmp-" in name \
                or ".old-" in name:
            continue
        try:
            step = int(name[len(prefix) + 1:])
        except ValueError:
            continue
        full = os.path.join(root, name)
        if os.path.isfile(os.path.join(full, _MANIFEST)):
            out.append((step, full))
    out.sort()
    return out


def _resolve_root(root: str, prefix: str = "ckpt") -> Optional[str]:
    """The newest intact snapshot under a manager root: the LATEST
    pointer first, then step-descending fallback."""
    for cand in _root_candidates(root, prefix):
        if is_intact(cand):
            return cand
    return None


def _root_candidates(root: str, prefix: str = "ckpt") -> List[str]:
    cands: List[str] = []
    pointed = read_latest(root)
    if pointed is not None:
        cands.append(pointed)
    # a crash between a re-save's two renames leaves a step only in
    # `<prefix>-<step>.{tmp,old}-<nonce>` dirs; complete ones join the
    # step order (committed dirs win ties), torn ones fail verification
    merged = [(step, 1, full)
              for step, full in _snapshot_steps(root, prefix)]
    merged += [(step, 0, full)
               for step, full in _orphan_snapshots(root, prefix)]
    for _step, _kind, full in sorted(merged, reverse=True):
        if full not in cands:
            cands.append(full)
    return cands


def _sibling_orphans(path: str) -> List[str]:
    """Manifest-bearing `<path>.{tmp,old}-*` dirs beside a bare path,
    the interrupted new copy (.tmp-) before the previous one (.old-)."""
    parent, base = os.path.split(os.path.abspath(path))
    out = []
    try:
        names = os.listdir(parent)
    except OSError:
        return []
    for name in names:
        for rank, mark in enumerate((".tmp-", ".old-")):
            if name.startswith(base + mark):
                full = os.path.join(parent, name)
                if os.path.isfile(os.path.join(full, _MANIFEST)):
                    out.append((rank, full))
    return [full for _rank, full in sorted(out)]


def _orphan_snapshots(root: str, prefix: str) -> List[Tuple[int, str]]:
    """Manifest-bearing `<prefix>-<step>.{tmp,old}-*` dirs, step-sorted
    ascending."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        for mark in (".tmp-", ".old-"):
            head, sep, _ = name.partition(mark)
            if sep and head.startswith(prefix + "-"):
                try:
                    step = int(head[len(prefix) + 1:])
                except ValueError:
                    continue
                full = os.path.join(root, name)
                if os.path.isfile(os.path.join(full, _MANIFEST)):
                    out.append((step, full))
    out.sort()
    return out


class Converter:
    """The reference-shaped facade (auto_parallel's converter): convert
    a checkpoint saved under one layout to another. The conversion is
    the load: the manifest records global windows, and load_sharded
    re-slices onto the target mesh and specs."""

    def __init__(self, path: str):
        self.path = path

    def convert(self, mesh, specs=None):
        return load_sharded(self.path, mesh=mesh, specs=specs)


# ------------------------------------------------------------------ manager
class CheckpointManager:
    """Rolling snapshot store: `root/<prefix>-<step>` directories, a
    `LATEST` pointer, keep-last-K retention (`max_to_keep` <= 0 keeps
    all), and a restore that falls back past snapshots failing their
    checksums. In a world of several ranks every rank makes the
    manager (it makes the save's gloo group, `coord_group`, here, in the
    calling thread) and calls save/save_async/wait/restore alike."""

    def __init__(self, root: str, max_to_keep: int = 3,
                 prefix: str = "ckpt", async_retry_backoff_s: float = 0.5):
        self.root = os.path.abspath(root)
        self.max_to_keep = int(max_to_keep)
        self.prefix = prefix
        # one retry after this backoff before a writer failure surfaces
        self.async_retry_backoff_s = float(async_retry_backoff_s)
        os.makedirs(self.root, exist_ok=True)
        coord_group()
        # at most ONE write in flight; a failed writer's exception waits
        # in _async_err for the next barrier
        self._async_lock = threading.Lock()
        self._async_thread: Optional[threading.Thread] = None
        self._async_err: Optional[BaseException] = None
        # serializes keep-K pruning against a fallback restore's reads
        self._retain_lock = threading.RLock()
        # the async snapshots' host buffers, reused across saves
        self._pool: Dict[Any, torch.Tensor] = {}
        # the last async save: its snapshot's bytes and the seconds its
        # writer took to commit (None until one committed)
        self.last_snapshot_bytes = 0
        self.last_write_s: Optional[float] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"{self.prefix}-{int(step)}")

    def save(self, state, step: int, shardings=None) -> str:
        """Atomically snapshot `state` as step `step`, advance LATEST and
        prune beyond `max_to_keep`. Waits out an in-flight async save
        first."""
        self.wait()
        return save_sharded(state, self._path(step), shardings=shardings,
                            on_commit=self._gc)

    # ------------------------------------------------------------ async
    def save_async(self, state, step: int, shardings=None) -> str:
        """Snapshot `state` as step `step` without blocking the step path
        on the disk: the HostSnapshot is taken here (later in-place
        steps cannot change it), and the staged, checksummed, fsynced,
        atomically renamed commit runs on a background writer thread.
        Returns the target path at once; wait() is the barrier (save()
        and restore() take it). At most one save is in flight: a second
        save_async waits out the first, surfacing its failure here. A
        writer failure retries once after `async_retry_backoff_s` (the
        staging is rewritten from the snapshot); a second failure
        surfaces as AsyncSaveError at the next barrier."""
        import time as _time
        self.wait()
        # waits for A7: the `checkpoint.snapshot` span, the
        # checkpoint_async_save counter, checkpoint_async_pending gauge
        snap = HostSnapshot(state, shardings=shardings, pool=self._pool)
        self.last_snapshot_bytes = snap.nbytes
        self.last_write_s = None
        path = self._path(step)

        def work():
            t0 = _time.perf_counter()
            try:
                try:
                    save_sharded(snap, path, on_commit=self._gc)
                except BaseException:
                    # waits for A7: the checkpoint_async_retry counter and
                    # its flight-recorder dump
                    _time.sleep(self.async_retry_backoff_s)
                    save_sharded(snap, path, on_commit=self._gc)
                self.last_write_s = _time.perf_counter() - t0
            except BaseException as e:     # surfaced at the next barrier
                # waits for A7: the checkpoint_async_fail flight dump
                self._async_err = e

        with self._async_lock:
            t = threading.Thread(target=work, name="paddle-ckpt-async",
                                 daemon=True)
            self._async_thread = t
            t.start()
        return path

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the in-flight async save (if any) has committed.
        Raises AsyncSaveError if that writer failed (once: the error is
        consumed), TimeoutError when `timeout` expires first."""
        with self._async_lock:
            t, self._async_thread = self._async_thread, None
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                with self._async_lock:
                    self._async_thread = t
                raise TimeoutError(
                    f"async checkpoint write still running after "
                    f"{timeout}s")
        if self._async_err is not None:
            err, self._async_err = self._async_err, None
            raise AsyncSaveError(
                f"background checkpoint save failed: {err!r}") from err

    @property
    def async_pending(self) -> bool:
        """True while a background save is still writing."""
        t = self._async_thread
        return t is not None and t.is_alive()

    def steps(self) -> List[int]:
        return [s for s, _ in _snapshot_steps(self.root, self.prefix)]

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def latest_path(self) -> Optional[str]:
        """Newest intact snapshot path (LATEST-pointed first), or None."""
        return _resolve_root(self.root, self.prefix)

    def restore(self, mesh=_UNSET, specs=None, template=None, device=None):
        """Load the newest intact snapshot: `(state, step)`, or `(None,
        None)` when none exists. Snapshots failing verification are
        skipped newest-first. An in-flight async save is waited out
        first; a failed writer is absorbed here (restore's contract is
        the newest intact snapshot). `mesh`, `specs`, `template` and
        `device` as load_sharded's."""
        try:
            self.wait()
        except AsyncSaveError:
            pass      # waits for A7: the checkpoint_fallback_restore counter
        with self._retain_lock:
            for cand in self._candidates():
                try:
                    verify_checkpoint(cand)
                    state = load_sharded(cand, mesh=mesh, specs=specs,
                                         template=template, verify=False,
                                         device=device)
                except CheckpointCorruptError:
                    # waits for A7: the checkpoint_fallback_restore counter
                    continue
                # waits for A7: the checkpoint_restore counter
                return state, self._step_of(cand)
        return None, None

    def _candidates(self) -> List[str]:
        return _root_candidates(self.root, self.prefix)

    def _step_of(self, path: str) -> Optional[int]:
        name = os.path.basename(path)
        # "ckpt-7" and the recovered orphans "ckpt-7.tmp-1" /
        # "ckpt-7.old-1" all parse to 7
        digits = name[len(self.prefix) + 1:].split(".", 1)[0]
        try:
            return int(digits)
        except ValueError:
            return None

    def _gc(self) -> None:
        # under the retain lock: a fallback restore mid-read on an old
        # snapshot never has it deleted underneath
        with self._retain_lock:
            if self.max_to_keep > 0:
                snaps = _snapshot_steps(self.root, self.prefix)
                for _step, full in snaps[:-self.max_to_keep]:
                    shutil.rmtree(full, ignore_errors=True)
                    audit_forget(full)
            # crashed saves leave *.tmp-* / *.old-* orphans
            for name in os.listdir(self.root):
                if ".tmp-" in name or ".old-" in name:
                    shutil.rmtree(os.path.join(self.root, name),
                                  ignore_errors=True)


# --------------------------------------------------- train-state convenience
def save_train_state(path: str, params, opt_state=None, step=None,
                     extra=None, shardings=None):
    """Save {"params", "opt_state", "step", "extra"} (those given).
    `shardings` as save_sharded's, over the same keys."""
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if step is not None:
        state["step"] = step
    if extra is not None:
        state["extra"] = extra
    save_sharded(state, path, shardings=shardings)


def load_train_state(path: str, mesh=_UNSET, specs=None, device=None):
    return load_sharded(path, mesh=mesh, specs=specs, device=device)
