"""chip_smoke.py's contract, on the CPU: the BO1 phase of a rehearsal
passes end to end through the CLI, and without a GPU (or without the rest
of the repository) the script fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_rehearsal_bo1_phase_passes_on_cpu(tmp_path, capsys):
    chip_smoke = _smoke()
    assert chip_smoke.main(["--rehearse", "--phases", "4",
                            "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert any("[4] run-bo1 --engine fused" in ln for ln in out)
    assert any("[4] run-pair --engine device" in ln for ln in out)
    last = json.loads(out[-1])
    # a rehearsal reports the platform it really ran on
    assert last == {"ok": True, "device": {"platform": "cpu",
                                           "kind": "cpu", "count": 8}}


def test_phase0_refuses_a_cpu_device(tmp_path, capsys):
    chip_smoke = _smoke()
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.main(["--phases", "1", "--out-dir", str(tmp_path)])
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
