"""chip_smoke.py off the card: it must refuse the CPU, fail outside the
repository, and rehearse every phase on the CPU without printing a
device result."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def _run(args, cwd, timeout=300, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(**env),
                          capture_output=True, text=True, timeout=timeout)


def test_smoke_refuses_the_cpu(tmp_path):
    r = _run([SMOKE, "--workdir", str(tmp_path / "w")], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_smoke_alone_fails(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(SMOKE, lone / "chip_smoke.py")
    r = _run(["chip_smoke.py"], str(lone), PYTHONPATH="")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("cards", [1, 4])
def test_smoke_cpu_rehearsal(tmp_path, cards):
    t0 = time.perf_counter()
    r = _run([SMOKE, "--cpu-rehearsal", "--cards", str(cards),
              "--workdir", str(tmp_path / "w")], REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert time.perf_counter() - t0 < 60
    lines = r.stdout.splitlines()
    # six phases on one card; five multi-device commands and the dist run
    assert sum(l.startswith("phase ") and ": passed" in l for l in lines) == 6
    last = json.loads(lines[-1])
    # never mistakable for the device line the chip run prints
    assert "ok" not in last and "device" not in last
    assert last == {"cpu_rehearsal": "passed", "device_run": False}
