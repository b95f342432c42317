"""chip_smoke.py's contract where there is no card: it fails without
printing a result, and --chips selects which phases run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script, "--out", str(tmp_path / "out")],
        cwd=os.path.dirname(script), env=env, capture_output=True, text=True,
        timeout=300)


def test_fails_without_gpu(tmp_path):
    r = _run(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_fails_without_the_repo(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    r = _run(str(alone / "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("chips,phases", [
    (1, ["device:1", "train", "resume", "eval", "serve", "parity",
         "families", "gpu-tests"]),
    (4, ["prepare-four", "child", "device:4", "four"]),
])
def test_chips_selects_phases(chips, phases, monkeypatch, tmp_path, capsys):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    ran = []

    def rec(name, ret=None):
        def f(*args, **kwargs):
            ran.append(name)
            return ret
        return f

    def device(count):
        ran.append(f"device:{count}")
        return {"platform": "gpu", "kind": "stub", "count": count}

    monkeypatch.setattr(chip_smoke, "phase_device", device)
    for fn, name, ret in (
            ("phase_train", "train", "cfg"), ("phase_resume", "resume", "ck"),
            ("phase_eval", "eval", "ev"), ("phase_serve", "serve", None),
            ("phase_parity", "parity", None),
            ("phase_families", "families", None),
            ("phase_gpu_tests", "gpu-tests", None),
            ("prepare_four", "prepare-four", None),
            ("run_four", "four", None)):
        monkeypatch.setattr(chip_smoke, fn, rec(name, ret))
    monkeypatch.setattr(chip_smoke.subprocess, "run", rec("child"))
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "stub, 1 W")
    chip_smoke.main(["--chips", str(chips), "--out", str(tmp_path)])
    assert ran == phases
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "stub, 1 W"
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "stub",
                               "count": chips}}
    if chips == 1:
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
