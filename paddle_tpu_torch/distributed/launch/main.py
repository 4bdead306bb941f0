"""Launcher CLI — the port's counterpart of
paddle_tpu/distributed/launch/main.py (`_parse_args`, `_worker_env`,
`_Worker`, `_spawn`, `_terminate`, `_wait`, `launch` :312-360's elastic
restart with the degraded world spec).

The reference runs one process a host (JAX drives every local chip from
it). The port runs one process a device on one host, as torchrun does,
so `--nproc_per_node` is the world's rank count and a degraded restart
relaunches as many ranks as the world spec's `n_devices` (jobs across
hosts are torchrun's). The launcher:

- exports the PADDLE_* environment parallel/env.py reads
  (PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_MASTER) with
  torchrun's names beside them (RANK, WORLD_SIZE, MASTER_ADDR,
  MASTER_PORT, LOCAL_RANK: the rank's card, device.resolve_device);
- `--devices cpu`: gloo ranks on the host (no card is visible to them,
  PADDLE_LAUNCH_DEVICES=cpu tells the script to pass device "cpu");
  `--devices gpu`: one rank a card over NCCL, or, with more ranks than
  cards, ranks sharing the cards round-robin over gloo (NCCL refuses two
  ranks on one card; parallel/collective.py routes their collectives
  through the host, "gloo_cuda_via_all_reduce");
- `--max_restart K` restarts the pod up to K times when a worker exits
  non-zero (every other worker is stopped first);
- `--hang_timeout S`: each worker beats a lease file through the boot
  shim and a worker whose lease goes stale counts as failed;
- the elastic protocol: a worker exiting ELASTIC_EXIT_CODE (101) asks
  for a restart, budgeted apart by `--max_elastic_restart`; when it left
  a world spec (heartbeat.write_world_spec), the restarted pod runs the
  spec's `n_devices` ranks and every worker gets the spec in
  $PADDLE_TPU_ELASTIC_WORLD (heartbeat.degraded_world);
- a worker exiting with a departure code (parallel/elastic.py: 102, a
  survivor the degraded plan leaves out; 103, a rank declared lost) has
  left the world cleanly: the others run on;
- `--min_procs M`: after the crash restarts are spent, relaunch one rank
  fewer, down to M;
- no worker outlives the launcher: SIGTERM stops the pod as Ctrl-C
  does, and on Linux the boot shim has the kernel kill a worker whose
  launcher ended (PR_SET_PDEATHSIG), a SIGKILL of the launcher included.

The controller's monitor counters, spans and flight-recorder dumps wait
for ROADMAP A7.

Usage:
  python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
      --devices cpu train.py --my-args ...
  python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
      --devices gpu --max_elastic_restart 2 train.py
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

from .heartbeat import (ELASTIC_EXIT_CODE, ENV_WORLD, ENV_WORLD_FILE,
                        read_world_spec)

__all__ = ["launch", "main", "HUNG", "DEPARTURE_CODES"]

# parallel/elastic.py's LEFT_OUT_EXIT and DECLARED_LOST_EXIT (not imported:
# the launcher never imports torch's distributed stack)
DEPARTURE_CODES = (102, 103)

# _wait's verdict for "a worker stopped beating": distinct from any exit
# code
HUNG = -257
# seconds between a worker's beats under --hang_timeout, and before a
# scaled-down relaunch
HEARTBEAT_INTERVAL_S = 1.0
SCALE_GRACE_S = 3.0


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="rank launcher with elastic restart")
    p.add_argument("--master", default=os.environ.get("PADDLE_MASTER"),
                   help="rendezvous host:port (default: a free port on "
                        "127.0.0.1, chosen again at each spawn)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="ranks on this node, one a device")
    p.add_argument("--devices", default="gpu", choices=("cpu", "gpu"),
                   help="cpu: gloo ranks on the host; gpu: a rank a card "
                        "(ranks beyond the cards share them over gloo)")
    p.add_argument("--max_restart", type=int, default=0,
                   help="restart the pod up to K times on worker failure")
    p.add_argument("--hang_timeout", type=float, default=0.0,
                   help="a worker whose heartbeat file is older than this "
                        "many seconds has failed (0: no watch)")
    p.add_argument("--max_elastic_restart", type=int, default=16,
                   help="restarts granted to workers that exit with the "
                        f"elastic code ({ELASTIC_EXIT_CODE}), budgeted "
                        "apart from --max_restart")
    p.add_argument("--min_procs", type=int, default=0,
                   help="after restarts are spent, relaunch one rank "
                        "fewer down to this count (0: off)")
    p.add_argument("--log_dir", default=None,
                   help="per-worker logs, lease and world-spec files here")
    p.add_argument("training_script", help="entry script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _run_dir(args) -> str:
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        return args.log_dir
    d = getattr(args, "_tmp_dir", None)
    if d is None:
        import tempfile
        d = args._tmp_dir = tempfile.mkdtemp(prefix="paddle_launch_")
    return d


def _worker_env(args, local_rank: int, master: str) -> dict:
    """The PADDLE_* environment (and torchrun's names) of one rank."""
    nprocs = args.nproc_per_node
    rank = local_rank
    env = dict(os.environ)
    host, port = master.rsplit(":", 1)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_MASTER": master,
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_LAUNCH_DEVICES": args.devices,
        "RANK": str(rank),
        "WORLD_SIZE": str(nprocs),
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
        # the boot shim binds the worker's life to this process
        "PADDLE_LAUNCHER_PID": str(os.getpid()),
    })
    if args.devices == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
        env["PADDLE_DIST_BACKEND"] = "gloo"
        env["LOCAL_RANK"] = str(local_rank)
    else:
        cards = args._cards
        if cards < 1:
            raise RuntimeError("--devices gpu: no CUDA card is visible "
                               "(pass --devices cpu for host ranks)")
        env["LOCAL_RANK"] = str(local_rank % cards)
        env["PADDLE_DIST_BACKEND"] = ("nccl" if args.nproc_per_node <= cards
                                      else "gloo")
    # the degraded-world handshake (heartbeat.py): a worker writes the
    # world it wants here before an elastic exit; launch() reads it back
    env.setdefault(ENV_WORLD_FILE,
                   os.path.join(_run_dir(args), "elastic_world.json"))
    granted = getattr(args, "_elastic_world", None)
    if granted:
        env[ENV_WORLD] = granted
    # waits for A7: the flight recorder's dump directory
    return env


class _Worker:
    """One spawned rank and the liveness state the watch tracks."""

    def __init__(self, proc: subprocess.Popen, hb_path: Optional[str]):
        self.proc = proc
        self.hb_path = hb_path
        self.started = time.time()

    def stale_for(self) -> float:
        """Seconds since the last beat (the spawn counts as the first)."""
        last = self.started
        if self.hb_path:
            try:
                last = max(last, os.stat(self.hb_path).st_mtime)
            except OSError:
                pass
        return time.time() - last


def _spawn(args) -> List[_Worker]:
    master = args.master or f"127.0.0.1:{_free_port()}"
    workers = []
    for lr in range(args.nproc_per_node):
        out = None
        if args.log_dir:
            out = open(os.path.join(_run_dir(args), f"worker.{lr}.log"),
                       "ab")
        try:
            workers.append(_popen(args, lr, out, master))
        finally:
            if out is not None:
                out.close()          # the child inherited the fd
    return workers


def _popen(args, lr: int, out, master: str) -> _Worker:
    env = _worker_env(args, lr, master)
    hb_path = None
    if args.hang_timeout > 0:
        hb_path = os.path.join(_run_dir(args), f"hb.{lr}")
        try:                         # a fresh lease a (re)spawn
            os.remove(hb_path)
        except OSError:
            pass
        env["PADDLE_HEARTBEAT_FILE"] = hb_path
        env["PADDLE_HEARTBEAT_INTERVAL"] = str(HEARTBEAT_INTERVAL_S)
    # the boot shim starts the heartbeat before the script runs
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch._boot",
           args.training_script, *args.training_script_args]
    proc = subprocess.Popen(cmd, env=env, stdout=out,
                            stderr=subprocess.STDOUT if out else None)
    return _Worker(proc, hb_path)


def _terminate(workers: List[_Worker]) -> None:
    """SIGTERM, then SIGKILL for a worker that ignores it (one wedged in
    a collective can)."""
    for w in workers:
        if w.proc.poll() is None:
            w.proc.send_signal(signal.SIGTERM)
    for w in workers:
        try:
            w.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            w.proc.kill()
            w.proc.wait()


def _wait(workers: List[_Worker], hang_timeout: float = 0.0
          ) -> Optional[int]:
    """Wait for every worker. The first failure (a non-zero exit that is
    not a departure code, or with `hang_timeout` a stale beat: HUNG)
    stops the rest and is returned; 0 when every worker exited 0 or
    departed; None on a KeyboardInterrupt."""
    workers = list(workers)
    try:
        while workers:
            for w in list(workers):
                rc = w.proc.poll()
                if rc is None:
                    if hang_timeout > 0 and w.stale_for() > hang_timeout:
                        print(f"[launch] worker pid={w.proc.pid} hung (no "
                              f"heartbeat for {w.stale_for():.1f}s); "
                              f"stopping the pod", file=sys.stderr,
                              flush=True)
                        _terminate(workers)
                        return HUNG
                    continue
                workers.remove(w)
                if rc in DEPARTURE_CODES:
                    print(f"[launch] worker pid={w.proc.pid} left the "
                          f"world (rc={rc})", file=sys.stderr, flush=True)
                    continue
                if rc != 0:
                    _terminate(workers)
                    return rc
            time.sleep(0.1)
        return 0
    except KeyboardInterrupt:
        _terminate(workers)
        return None


def launch(argv: Optional[List[str]] = None) -> int:
    """The launcher's entry: returns the job's exit code."""
    args = _parse_args(argv)
    args._cards = _card_count() if args.devices == "gpu" else 0
    attempt = 0
    elastic = 0
    while True:
        if attempt:
            print(f"[launch] pod restart {attempt}/{args.max_restart} "
                  f"(crash budget)", file=sys.stderr, flush=True)
        # waits for A7: the launch.spawn / launch.wait spans
        rc = _wait(_spawn(args), args.hang_timeout)
        if rc == 0:
            return 0
        if rc is None:
            return 130
        if rc == ELASTIC_EXIT_CODE and elastic < args.max_elastic_restart:
            # the worker asked for this restart (ELASTIC_EXIT_CODE=101);
            # budgeted apart from the crash restarts
            elastic += 1
            wpath = os.environ.get(ENV_WORLD_FILE) or os.path.join(
                _run_dir(args), "elastic_world.json")
            spec = read_world_spec(wpath)
            if spec is not None:
                args._elastic_world = json.dumps(spec)
                try:            # consumed: one spec an elastic exit
                    os.remove(wpath)
                except OSError:
                    pass
                if spec.get("n_devices"):
                    args.nproc_per_node = int(spec["n_devices"])
                print(f"[launch] elastic restart carries a DEGRADED world "
                      f"spec: {spec}", file=sys.stderr, flush=True)
            print(f"[launch] worker requested elastic restart "
                  f"({elastic}/{args.max_elastic_restart}, "
                  f"rc={ELASTIC_EXIT_CODE}); relaunching "
                  f"{args.nproc_per_node} rank(s)", file=sys.stderr,
                  flush=True)
            continue
        if attempt >= args.max_restart:
            if args.min_procs > 0 and \
                    args.nproc_per_node - 1 >= args.min_procs:
                args.nproc_per_node -= 1
                attempt = 0
                print(f"[launch] restarts exhausted (rc={rc}); scaling "
                      f"down to {args.nproc_per_node} ranks after "
                      f"{SCALE_GRACE_S}s grace", file=sys.stderr,
                      flush=True)
                time.sleep(SCALE_GRACE_S)
                continue
            print(f"[launch] workers failed (rc={rc}); restarts exhausted",
                  file=sys.stderr, flush=True)
            return 1 if rc == HUNG else rc
        attempt += 1


def _stop(signum, frame):
    """SIGTERM stops the pod as Ctrl-C does: `_wait` terminates every
    worker before the launcher exits."""
    raise KeyboardInterrupt


def main():
    signal.signal(signal.SIGTERM, _stop)
    sys.exit(launch())


if __name__ == "__main__":
    main()
