"""bench.py suite mode: the driver's plain invocation emits one JSON line
per configuration (subprocess-isolated) plus the headline last."""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import bench  # noqa: E402


def test_suite_enabled_logic(monkeypatch):
    for k in list(os.environ):
        if k.startswith("NERF_JAX_BENCH_"):
            monkeypatch.delenv(k)
    assert bench._suite_enabled()
    monkeypatch.setenv("NERF_JAX_BENCH_MODEL", "siren")
    assert not bench._suite_enabled()           # explicit knob -> single
    monkeypatch.setenv("NERF_JAX_BENCH_SUITE", "1")
    assert bench._suite_enabled()               # forced on
    monkeypatch.setenv("NERF_JAX_BENCH_SUITE", "0")
    assert not bench._suite_enabled()           # forced off
    monkeypatch.delenv("NERF_JAX_BENCH_MODEL")
    monkeypatch.delenv("NERF_JAX_BENCH_SUITE")
    # suite-only configuration must not opt OUT of the suite
    monkeypatch.setenv("NERF_JAX_BENCH_SUITE_ROWS", "render_nerf")
    assert bench._suite_enabled()


@pytest.mark.slow
def test_suite_emits_config_rows(monkeypatch, capsys):
    """_run_suite executes each row in a subprocess and prints one JSON
    object per row with a 'config' field; failures/timeouts become error
    rows instead of stalling."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(bench, "_SUITE", [
        ("tiny_render",
         {"NERF_JAX_BENCH_MODE": "render", "NERF_JAX_BENCH_HW": "32",
          "NERF_JAX_BENCH_SAMPLES": "4", "NERF_JAX_BENCH_FINE": "0",
          "NERF_JAX_BENCH_ITERS": "1", "NERF_JAX_BENCH_CHUNK": "1024"},
         560),
        ("broken",
         {"NERF_JAX_BENCH_MODE": "render", "NERF_JAX_BENCH_HW": "not_an_int"},
         120),
    ])
    headline = {"metric": "rays_per_sec_per_chip", "value": 1.0,
                "config": "train_nerf"}
    bench._run_suite(headline)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    rows = [json.loads(ln) for ln in lines]
    by_name = {r["config"]: r for r in rows
               if not r.get("headline") and "config" in r}
    assert set(by_name) == {"tiny_render", "broken"}
    assert by_name["tiny_render"]["metric"] == "render_rays_per_sec"
    assert by_name["tiny_render"]["value"] > 0
    assert "error" in by_name["broken"]
    # the headline is re-emitted after EVERY row (watchdog-proof record),
    # plus once after the all-rows summary line
    reemits = [r for r in rows if r.get("headline")]
    assert len(reemits) == 3
    assert json.loads(lines[-1]).get("headline")
    # ONE compact summary line carries every row's key numbers so a
    # truncated log tail can't drop family rows from the round record
    summaries = [r for r in rows if "rows" in r]
    assert len(summaries) == 1
    summ = summaries[0]["rows"]
    assert set(summ) == {"tiny_render", "broken"}
    assert summ["tiny_render"]["value"] > 0
    assert "error" in summ["broken"]
