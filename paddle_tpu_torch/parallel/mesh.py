"""Device mesh and partition specs — the port's counterpart of
paddle_tpu/parallel/mesh.py (`build_mesh` :34, `set_global_mesh` /
`get_mesh` / `use_mesh` :72-93, `leaf_path_name` :95, `_clean_spec` /
`sharding_for` :112-153, `remap_spec_axes` / `remap_specs` / `tp_specs`
:155-202, `shard_value` :204, `constraint` :214).

The reference names mesh axes on one `jax.sharding.Mesh` and lets GSPMD
insert the collectives. Here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the process
group, one rank a device, with a process group per named axis
(`axis_group`); a `P` spec over those names says how a tensor's dims
split over them, and `Sharding` turns it into this rank's slice of the
full tensor and the per-mesh-dim placements DTensor would give it. The
tensors themselves stay plain local tensors: the collectives that
GSPMD would insert are written out by the callers
(parallel/collective.py, models/{gpt,llama}.py under a ShardLayout).

A dim split over several axes (a tuple entry, as P(("dp", "fsdp"))) is
split row-major in the entry's order, as JAX splits it: chunk index
i_dp * n_fsdp + i_fsdp.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["P", "Sharding", "build_mesh", "set_global_mesh", "get_mesh",
           "use_mesh", "leaf_path_name", "sharding_for", "remap_spec_axes",
           "remap_specs", "tp_specs", "shard_value", "constraint",
           "axis_names", "axis_size", "axis_index", "axis_group",
           "mesh_device"]


class P(tuple):
    """A PartitionSpec: one entry a tensor dim, each None (replicated),
    an axis name, or a tuple of axis names. Compares as the reference's
    PartitionSpec does: a one-name tuple entry equals the bare name,
    trailing Nones are kept (P("a") != P("a", None)), and a P equals the
    plain tuple of its entries."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else e
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


# ------------------------------------------------------------------ mesh
def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis `name` (1 when the mesh has no such axis)."""
    names = axis_names(mesh)
    return int(mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along mesh axis `name` (0 when absent)."""
    names = axis_names(mesh)
    if name not in names:
        return 0
    return int(mesh.get_coordinate()[names.index(name)])


def axis_group(mesh, name: str):
    """The process group of this rank's line along `name`, or None when
    the axis is absent or has one rank (nothing to communicate)."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def mesh_device(mesh) -> torch.device:
    """Where this rank's tensors live: its card (device.resolve_device)
    on a CUDA mesh, the CPU otherwise."""
    if mesh.device_type == "cuda":
        from ..device import resolve_device
        return resolve_device(None)
    return torch.device(mesh.device_type)


def build_mesh(axes: Dict[str, int], devices=None, device_type: str = "cuda"):
    """A DeviceMesh from {'dp': 2, 'tp': 4, ...} over the ranks
    `devices` (default: every rank of the world, which
    `init_parallel_env` joins first if need be), reshaped row-major in
    axis order as the reference reshapes jax.devices(); -1 on one axis
    means infer. Extra ranks beyond the axes' product are left out, as
    the reference leaves out extra devices. The default device type is
    the card; tests pass device_type="cpu" over gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        from .env import init_parallel_env
        init_parallel_env(backend="gloo" if device_type == "cpu" else None)
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    shape = dict(axes)
    known, infer_key = 1, None
    for k, v in shape.items():
        if v in (-1, None):
            if infer_key is not None:
                raise ValueError("only one mesh axis may be -1")
            infer_key = k
        else:
            known *= v
    if infer_key is not None:
        shape[infer_key] = len(ranks) // known
    total = int(np.prod(list(shape.values())))
    if total > len(ranks):
        raise ValueError(f"mesh {shape} needs {total} ranks, have "
                         f"{len(ranks)}")
    grid = torch.tensor(ranks[:total], dtype=torch.int64).reshape(
        tuple(shape.values()))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(shape))


_state = threading.local()


def _mesh_stack() -> List:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def set_global_mesh(mesh):
    _mesh_stack().clear()
    _mesh_stack().append(mesh)


def get_mesh():
    stack = _mesh_stack()
    return stack[-1] if stack else None


class use_mesh:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _mesh_stack().append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _mesh_stack().pop()
        return False


def leaf_path_name(path) -> str:
    """The last dict key on a tree path (a tuple of keys, as
    ("m", "qkv_w") for a moment leaf): the one name-keyed lookup rule by
    which a step's pins and the plan's spec table agree leaf for leaf."""
    for entry in reversed(tuple(path)):
        if isinstance(entry, str):
            return entry
    return ""


# ----------------------------------------------------------------- specs
def _clean_spec(spec, mesh, shape: Optional[Sequence[int]] = None) -> P:
    """Adapt `spec` to `mesh`: drop axes the mesh doesn't have (per
    entry, so a spec naming both known and unknown axes keeps the known
    ones), and — with `shape` — degrade any entry whose mesh size does
    not divide the dim to replicated, leaf by leaf, as the reference
    does (a GQA leaf with 2 KV heads on a tp=4 mesh stays replicated)."""
    names = axis_names(mesh)
    cleaned = []
    for entry in spec:
        keep = tuple(a for a in _entry_axes(entry) if a in names)
        cleaned.append(None if not keep else
                       (keep if isinstance(entry, (tuple, list)) else keep[0]))
    if shape is not None:
        for i, entry in enumerate(cleaned):
            if entry is None or i >= len(shape):
                continue
            n = int(np.prod([axis_size(mesh, a) for a in _entry_axes(entry)]))
            if n == 0 or shape[i] % n != 0:
                cleaned[i] = None
    return P(*cleaned)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A cleaned spec on a mesh: the port's NamedSharding. `local_shape`
    and `local_index` give this rank's block of a full tensor;
    `placements` the per-mesh-dim DTensor placements (Shard(dim) or
    Replicate(); a dim split over several axes is Shard(dim) on each, in
    mesh order)."""
    mesh: object
    spec: P

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in axis_names(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if name in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def local_index(self) -> Tuple[Tuple[int, int], ...]:
        """(chunk index, chunk count) per spec entry for this rank."""
        out = []
        for e in self.spec:
            idx, n = 0, 1
            for a in _entry_axes(e):
                size = axis_size(self.mesh, a)
                idx, n = idx * size + axis_index(self.mesh, a), n * size
            out.append((idx, n))
        return tuple(out)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        shape = list(shape)
        for d, (_, n) in enumerate(self.local_index()):
            shape[d] //= n
        return tuple(shape)

    def shard(self, value) -> torch.Tensor:
        """This rank's block of the full `value` (a tensor or numpy
        array; a zero-stride view costs only the block), as a new
        contiguous tensor on the mesh's device."""
        full = torch.as_tensor(np.ascontiguousarray(value)
                               if isinstance(value, np.ndarray) else value)
        t = full
        for d, (i, n) in enumerate(self.local_index()):
            if n > 1:
                t = t.narrow(d, i * (t.shape[d] // n), t.shape[d] // n)
        out = t.to(mesh_device(self.mesh)).contiguous()
        if out.untyped_storage().data_ptr() == \
                full.untyped_storage().data_ptr():
            out = out.clone()
        return out


def sharding_for(spec, mesh=None, shape: Optional[Sequence[int]] = None
                 ) -> Optional[Sharding]:
    """`spec` adapted to `mesh` (default: the ambient one), shape-aware
    when `shape` is given; None without a mesh."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return None
    return Sharding(mesh, _clean_spec(spec, mesh, shape))


def remap_spec_axes(spec, mapping: Dict[str, str]) -> P:
    """Rename mesh axes inside a spec: entries map through `mapping`;
    axes absent from the mapping drop to None (replicated). Tuple
    entries keep only their mapped members."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            keep = tuple(mapping[a] for a in entry if a in mapping)
            out.append(keep if len(keep) > 1
                       else (keep[0] if keep else None))
        else:
            out.append(mapping.get(entry))
    return P(*out)


def remap_specs(param_specs: Dict[str, P], mapping: Dict[str, str]
                ) -> Dict[str, P]:
    """A whole PARAM_SPECS table onto another mesh's axis names: the 3D
    planner lands the family tables, declared over ('dp', 'fsdp', 'pp',
    'mp'), on a dp×fsdp×tp mesh with {'fsdp': 'fsdp', 'mp': 'tp'}; 'pp'
    drops, as the 3D step loops over the stacked layer axis on each
    rank. Shape-aware degrade stays in sharding_for, per leaf."""
    return {k: remap_spec_axes(s, mapping) for k, s in param_specs.items()}


def tp_specs(param_specs: Dict[str, P], src: str = "mp", axis: str = "tp"
             ) -> Dict[str, P]:
    """The serving tensor-parallel table of a training PARAM_SPECS: the
    TP split on `src` survives on `axis`, every other axis drops."""
    return remap_specs(param_specs, {src: axis})


def shard_value(value, spec, mesh=None):
    """This rank's shard of the full `value` (tensor or numpy array)
    under `spec` on `mesh` (shape-aware); `value` itself without a
    mesh."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return value
    return sharding_for(spec, mesh, shape=tuple(value.shape)).shard(value)


def constraint(value, spec, mesh=None):
    """The reference's with_sharding_constraint, an identity here: a
    local tensor carries no layout for a compiler to adopt. The sharded
    step's layouts live in its pins, and the models write their
    collectives out (parallel/layout.py)."""
    return value
