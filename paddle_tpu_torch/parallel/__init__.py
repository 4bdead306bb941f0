"""paddle_tpu_torch.parallel — the port's distributed stack, the
counterpart of paddle_tpu/parallel/ for the planner-driven train step:
the process-group bootstrap (env), the DeviceMesh and its partition
specs (mesh), the step's collectives and stage handoffs (collective),
the cost model's plan search (planner), the layout the sharded step
hands its model (layout, the port's own), and for pp>1 plans the 1F1B
schedule (pipeline) and the pipelined step (pipeline_train).

One process drives one rank and one device; launch N ranks with
`torchrun --nproc_per_node=N`. Sharded checkpoints, elastic training,
tensor-parallel serving, MoE and context parallelism are later ROADMAP
A6 items.
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
    gather_from, copy_to, reduce_from, reduce_scatter_to, exchange)
from .planner import (  # noqa: F401
    ChipSpec, ModelSpec, Plan, TrainPlan, NoFeasiblePlanError,
    enumerate_plans, plan_parallel, plan_train, spec_from_config,
    best_mesh_axes)
from .layout import ShardLayout, current_layout, use_layout  # noqa: F401
from .pipeline import (  # noqa: F401
    bubble_fraction, naive_bubble_fraction, one_f_one_b, timeline,
    schedule_stats)
from .pipeline_train import make_pp_step_fn  # noqa: F401
