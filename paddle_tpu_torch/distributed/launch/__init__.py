"""python -m paddle_tpu_torch.distributed.launch — the port's counterpart
of paddle_tpu/distributed/launch/: the rank launcher with its elastic
restart (main.py), the boot shim (_boot.py), and the worker side of the
contract, the heartbeat lease and ELASTIC_EXIT_CODE (heartbeat.py)."""


def launch(argv=None):
    """The launcher's entry (main.launch), imported on use: a worker that
    reads only the heartbeat never loads the controller."""
    from .main import launch as _launch
    return _launch(argv)
