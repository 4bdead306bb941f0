"""Worker bootstrap of the launcher (distributed/launch/main.py): start
the liveness heartbeat when the launcher exported its contract
(PADDLE_HEARTBEAT_FILE), then run the entry script as __main__."""
import runpy
import sys

if __name__ == "__main__":
    from paddle_tpu_torch.distributed.launch import heartbeat

    heartbeat.start_from_env()
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
