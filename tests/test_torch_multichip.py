"""PyTorch port: scripts/torch_multichip.py (ace_tpu's dryrun_multichip
phases 2-5 on a digit x slot world, phase 1 and a bootstrap on a dp x
limb world) rehearsed on the CPU at ring degree 2^10 on 2 x 2 gloo
worlds (tests/test_torch_driver.py rehearses chip_smoke.py's phases 9
and 9d).
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


def test_multichip_limb_world_on_cpu():
    """--dp 2 --limb 2: phase 1 (the dry run's dp x limb step, a different
    message on each dp row) and phase 4L (the bootstrap through
    FheContext(mesh=...)) on a 2 x 2 gloo world at degree 2^10, every
    rank's gathered residues equal to the single-device port's; each
    rank holds half of every key."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_multichip.py"),
         "--device", "cpu", "--degree", "1024", "--dp", "2", "--limb", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "phases" not in res  # no digit x slot world was asked for
    world = res["limb_world"]
    assert (world["dp"], world["limb"]) == (2, 2)
    assert sorted(world["phases"]) == ["1", "4L"]
    for k, p in world["phases"].items():
        assert p["switches"] == 0 and p["collectives"] > 0, (k, p)
        assert p["staged_bytes"] == 0, (k, p)
    assert "each dp row == the single-device step" in out.stdout
    assert "4 ranks == single-device" in out.stdout
