"""Every cell of BENCHMARK.json resolves to its files, the file keeps to its
format, and a tiny CPU run of each cell's path prints a well-formed last
line, which the control in the program's place would fail."""
import contextlib
import io
import json
import re
from pathlib import Path

import pytest

from servebench import check, harness
from servebench import run as bench_run

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keeps_to_its_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + CELLS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) \
        <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    conf = next(x for x in SPEC["configs"] if x["name"] == entry["config"])
    assert (ROOT / conf["file"]).is_file()
    assert conf["file"].startswith(SPEC["paths"][0] + "/")
    for key in conf["reduced"]:
        assert key in c.config["reduced"]
    assert (ROOT / "servebench" / "traffic"
            / f"{entry['traffic']}.json").is_file()
    for m in c.end_to_end + c.per_layer:
        assert (ROOT / "servebench" / "metrics"
                / f"{m['name']}.py").is_file(), m["name"]
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cpu_run_prints_a_well_formed_last_line_and_fails_the_control(
        cell):
    c = harness.load_cell(cell, size="smoke")
    run, checks, desc = bench_run.measure(c, 2 ** 31 + 12345, 1e9, False,
                                          "cpu", rounds=c.traffic["window_rounds"])
    out = bench_run.result(run, checks, desc, False)
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        bench_run.print_result(out)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0, line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for v in line["metrics"].values():
        assert v["value"] > 0 and UNIT.match(v["unit"])
    assert err.getvalue().splitlines()[-1].startswith("check ")
    # the control in the program's place, on the same requests, served
    # tokens and prefill dispatches, judged by the harness's comparison:
    # the reference on fp8 operands fails a number the sound run passes
    numbers = check.read_numbers(run, "cpu", control=True)
    assert check.judge(run, "cpu", numbers=numbers)["ok"] is True
    ctl = check.judge(run, "cpu", control=True, numbers=numbers)
    assert ctl["ok"] is False, ctl["checks"]
