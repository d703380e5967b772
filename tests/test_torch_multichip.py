"""PyTorch port: scripts/torch_multichip.py (ace_tpu's dryrun_multichip
phases 2-5) rehearsed on the CPU at ring degree 2^10 on a 2 x 2 gloo
world (tests/test_torch_driver.py rehearses chip_smoke.py's phase 9).
The script holds every rank bit-exact against the single-device port
itself and exits non-zero otherwise. The script runs on one intra-op
thread (tests/torch_port_util.one_thread says why)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multichip_script_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_multichip.py"),
         "--device", "cpu", "--degree", "1024", "--digits", "2",
         "--slots", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res["phases"]) == ["2", "3", "4", "5"]
    for k, p in res["phases"].items():
        assert p["switches"] > 0 and p["collectives"] > 0, (k, p)
        assert p["staged_bytes"] == 0, (k, p)
    assert out.stdout.count("4 ranks == single-device") == 4
