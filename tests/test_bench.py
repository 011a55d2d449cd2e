"""bench.py on the CPU: the trace-to-stage reduction on a recorded H100 trace,
and the refusal to measure without a GPU."""

import gzip
import json
import os
import sys
from types import SimpleNamespace

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

TRACE = os.path.join(ROOT, "tests", "data", "trace_128ch_1024hz_h100.json.gz")


def _profile(planes):
    """A ProfileData look-alike: planes -> lines -> events with stats."""
    return SimpleNamespace(planes=[
        SimpleNamespace(name=p["name"], lines=[
            SimpleNamespace(name=ln["name"], events=[
                SimpleNamespace(name=n, start_ns=t, duration_ns=d, stats=list(st.items()))
                for n, t, d, st in ln["events"]])
            for ln in p["lines"]])
        for p in planes])


def test_stage_times_on_recorded_h100_trace(tmp_path, monkeypatch):
    with gzip.open(TRACE, "rt") as f:
        planes = json.load(f)["planes"]
    host = {"name": "/host:CPU", "lines": [{"name": "python", "events": [
        ["griffin_lim host span", 0, 10**9, {"name": "x/griffin_lim/y"}]]}]}
    monkeypatch.setattr(jax.profiler.ProfileData, "from_file",
                        staticmethod(lambda path: _profile(planes + [host])))
    (tmp_path / "a.xplane.pb").write_bytes(b"")
    st = bench.stage_times(str(tmp_path))
    # the per-stage device times PERF.md reports for this trace
    assert st["griffin_lim"] == pytest.approx(0.023773995)
    assert st["filter_chain"] == pytest.approx(0.006690596)
    assert st["ola_lowpass_int16"] == pytest.approx(0.005130173)
    assert st["context_lda_dequant_smooth"] == pytest.approx(0.001847983)
    assert st["framing"] == pytest.approx(0.000903854)
    assert st["other"] == pytest.approx(0.006121198)
    assert st["total"] == pytest.approx(sum(st[s] for s in bench.STAGES) + st["other"])
    assert st["total"] == pytest.approx(0.044467799)
    assert st["span"] == pytest.approx(0.046073478)


def test_bench_fails_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main(["--minutes", "0.01"])
    assert "{" not in capsys.readouterr().out
