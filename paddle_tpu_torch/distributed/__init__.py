"""paddle_tpu_torch.distributed — the reference's launch-side modules
(paddle_tpu/distributed/). Ported so far: `launch.heartbeat`, the
worker's liveness lease and the elastic exit code. The launcher itself
(`launch/main.py`, the controller that watches the lease and restarts
a worker that exits with ELASTIC_EXIT_CODE) is not ported; under
torchrun a worker's exit code and the lease file are the contract.
"""
