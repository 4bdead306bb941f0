"""paddle_tpu_torch.distributed.launch — the worker side of the
reference's launch contract (paddle_tpu/distributed/launch/): the
heartbeat lease and ELASTIC_EXIT_CODE. The launcher's controller is not
ported."""
