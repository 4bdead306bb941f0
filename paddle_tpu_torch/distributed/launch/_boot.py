"""Worker bootstrap of the launcher (distributed/launch/main.py): bind
the worker's life to its launcher's, start the liveness heartbeat when
the launcher exported its contract (PADDLE_HEARTBEAT_FILE), then run the
entry script as __main__."""
import os
import runpy
import signal
import sys


def bind_to_launcher() -> None:
    """On Linux, have the kernel SIGKILL this worker when the launcher
    that started it ends (PR_SET_PDEATHSIG), so no worker outlives a
    launcher that was killed before it could stop them. A worker whose
    launcher ended before the binding exits at once."""
    launcher = int(os.environ.get("PADDLE_LAUNCHER_PID") or 0)
    if not launcher or not sys.platform.startswith("linux"):
        return
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL),
                                                0, 0, 0)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.getppid() != launcher:
        os._exit(1)


if __name__ == "__main__":
    from paddle_tpu_torch.distributed.launch import heartbeat

    bind_to_launcher()
    heartbeat.start_from_env()
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
