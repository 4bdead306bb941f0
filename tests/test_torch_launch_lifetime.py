"""No worker outlives the port's launcher (distributed/launch/main.py,
_boot.py), on the CPU: the launcher over 2 host ranks of a script that
sleeps, then the launcher killed (SIGKILL: the boot shim's
PR_SET_PDEATHSIG ends the workers) or stopped (SIGTERM: the launcher
stops its pod as on Ctrl-C). Either way every worker has ended within a
few seconds.

The same binding keeps `chip_smoke.py`'s spawned ranks and its launcher
from outliving the script (`bind_to_script`, `stop_descendants`)."""
import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLEEPER = """
import os, time
with open(os.path.join(os.environ["LIFETIME_DIR"],
                       "w%s.pid" % os.environ["RANK"]), "w") as f:
    f.write(str(os.getpid()))
time.sleep(600)
"""

pytestmark = pytest.mark.skipif(not sys.platform.startswith("linux"),
                                reason="PR_SET_PDEATHSIG is Linux's")


def _ended(pid):
    """True when the process is gone or a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _wait_for(pred, timeout):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.1)
    return False


@pytest.mark.parametrize("sig", [signal.SIGKILL, signal.SIGTERM],
                         ids=["sigkill", "sigterm"])
def test_workers_end_with_their_launcher(tmp_path, sig):
    script = tmp_path / "sleeper.py"
    script.write_text(SLEEPER)
    env = dict(os.environ, PYTHONPATH=REPO, LIFETIME_DIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    env.pop("PADDLE_TPU_FAULTS", None)
    launcher = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--devices", "cpu", str(script)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        pid_files = [tmp_path / f"w{r}.pid" for r in (0, 1)]
        assert _wait_for(lambda: all(p.exists() and p.read_text()
                                     for p in pid_files), 120)
        workers = [int(p.read_text()) for p in pid_files]
        assert not any(_ended(w) for w in workers)
        launcher.send_signal(sig)
        launcher.wait(timeout=60)
        assert _wait_for(lambda: all(_ended(w) for w in workers), 30), \
            f"workers {workers} outlived the launcher"
        if sig == signal.SIGTERM:       # stopped its pod, as on Ctrl-C
            assert launcher.returncode == 130
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()


STOPPER = """
import importlib.util, json, subprocess, sys, time
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sleep = "import time; time.sleep(600)"
child = subprocess.Popen([sys.executable, "-c",
                          "import subprocess, sys, time; subprocess.Popen("
                          "[sys.executable, '-c', %r]); time.sleep(600)"
                          % sleep])
kept = subprocess.Popen([sys.executable, "-c", sleep + "  # keep-me"])
t0 = time.time()
while len(cs.descendants()) < 3 and time.time() - t0 < 30:
    time.sleep(0.1)
below = cs.descendants()
stopped = cs.stop_descendants(keep=("keep-me",))
print(json.dumps({"below": below, "stopped": list(stopped),
                  "child": child.pid, "kept": kept.pid,
                  "kept_alive": kept.poll() is None}))
kept.kill()
"""


def test_smoke_stops_what_it_started(tmp_path):
    """chip_smoke.stop_descendants, in a process of its own, ends every
    process below it (a child and the child's child) but those it is
    told to keep."""
    script = tmp_path / "stopper.py"
    script.write_text(STOPPER)
    out = subprocess.run([sys.executable, str(script),
                          os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["below"]) == 3 and got["kept"] in got["below"]
    assert got["child"] in got["stopped"] and got["kept"] not in got["stopped"]
    assert len(got["stopped"]) == 2 and got["kept_alive"]
    assert all(_ended(p) for p in got["stopped"])
