"""paddle_tpu_torch.distributed — the reference's launch-side modules
(paddle_tpu/distributed/): `launch`, the rank launcher with its elastic
restart (`python -m paddle_tpu_torch.distributed.launch`), and
`launch.heartbeat`, the worker's liveness lease, the elastic exit code
and the degraded-world handshake.
"""
