"""paddle_tpu_torch.parallel — the port's distributed stack, the
counterpart of paddle_tpu/parallel/ for the planner-driven dp×fsdp×tp
train step: the process-group bootstrap (env), the DeviceMesh and its
partition specs (mesh), the step's collectives (collective), the cost
model's plan search (planner), and the layout the sharded step hands
its model (layout, the port's own).

One process drives one rank and one device; launch N ranks with
`torchrun --nproc_per_node=N`. The pipelined pp>1 step, sharded
checkpoints, elastic training, tensor-parallel serving, MoE and context
parallelism are later ROADMAP A6 items.
"""
from .env import (  # noqa: F401
    init_parallel_env, get_rank, get_world_size, is_initialized,
    ParallelEnv, device_count, local_device_count)
from .mesh import (  # noqa: F401
    P, Sharding, build_mesh, set_global_mesh, get_mesh, use_mesh,
    sharding_for, shard_value, constraint, remap_spec_axes, remap_specs,
    tp_specs, leaf_path_name)
from .collective import (  # noqa: F401
    collective_route, all_gather, reduce_scatter, all_reduce, psum, pmean,
    gather_from, copy_to, reduce_from, reduce_scatter_to)
from .planner import (  # noqa: F401
    ChipSpec, ModelSpec, Plan, TrainPlan, NoFeasiblePlanError,
    enumerate_plans, plan_parallel, plan_train, spec_from_config,
    best_mesh_axes)
from .layout import ShardLayout, current_layout, use_layout  # noqa: F401
