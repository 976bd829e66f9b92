"""Real multi-process bring-up: jax.distributed over a local TCP cluster.

Two subprocesses x 4 virtual CPU devices form one 8-device global mesh —
the exact `jax.distributed.initialize` path a multi-host GPU cluster uses
(SURVEY.md §2.4 last row).  The worker pins that the psum genuinely
crosses the process boundary (each process contributes a distinct power of
ten), that a sample-sharded render over the cross-process mesh matches the
local reference, and that a DP gradient step all-reduces across both.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_cluster(tmp_path):
    out = tmp_path / "mp.json"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "run_multiprocess.py"),
         "--port", "9923", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=580)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(out.read_text())
    assert rec["num_processes"] == 2
    assert rec["global_devices"] == 8
    assert rec["cross_process_psum"] == 44.0
    assert rec["ok"]
