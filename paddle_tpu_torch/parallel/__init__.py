"""paddle_tpu_torch.parallel — the port's distributed stack, the
counterpart of paddle_tpu/parallel/ for the planner-driven train step:
the process-group bootstrap (env), the DeviceMesh and its partition
specs (mesh), the step's collectives and stage handoffs (collective),
the cost model's plan search (planner), the layout the sharded step
hands its model (layout, the port's own), for pp>1 plans the 1F1B
schedule (pipeline) and the pipelined step (pipeline_train), sharded
checkpoints that load under another plan (checkpoint), the
resilient step with skip, rollback and watchdog (resilience), and the
elastic controller that replans onto the surviving ranks (elastic).

One process drives one rank and one device; launch N ranks with
`python -m paddle_tpu_torch.distributed.launch --nproc_per_node N` (or
`torchrun --nproc_per_node=N`). MoE and context parallelism are a later
ROADMAP A6 item.
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
    best_mesh_axes, degrade_plan, plan_serving_tp)
from .layout import ShardLayout, current_layout, use_layout  # noqa: F401
from .pipeline import (  # noqa: F401
    bubble_fraction, naive_bubble_fraction, one_f_one_b, timeline,
    schedule_stats)
from .pipeline_train import make_pp_step_fn  # noqa: F401
from .checkpoint import (  # noqa: F401
    save_sharded, load_sharded, save_train_state, load_train_state,
    verify_checkpoint, CheckpointManager, CheckpointCorruptError,
    AsyncSaveError, HostSnapshot, Converter)
from .resilience import (  # noqa: F401
    ResilienceConfig, ResilientTrainer, StepHungError, make_resilient_step,
    plan_state_specs, pull_with_watchdog, run_resilient, WatchdogPuller)
from .elastic import (  # noqa: F401
    DeviceLeases, DeviceLossError, ElasticConfig, ElasticDeparture,
    ElasticTrainer, request_degraded_restart, run_elastic)
