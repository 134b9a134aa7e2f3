"""BENCHMARK.json and the files it names: the contract's shape, names and
units, and every part of every cell found by its name."""

import json
import re

import pytest

from harness.spec import BENCH_DIR, ROOT, Cell, read_json

BENCH = read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_exactly_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_texts(part):
    names = [e["name"] for e in BENCH[part]]
    assert len(names) == len(set(names))
    for e in BENCH[part]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_end_to_end_has_setup_at_its_bound():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"latency_ms_p50", "latency_ms_p95", "images_per_s",
                        "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in \
        e2e["setup_s"]


def test_run_time_budget_fits_with_24_cells():
    total = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_load_by_name(cell):
    c = Cell(cell)
    assert c.workload["name"] == cell
    model, driver, entry = c.model(), c.driver(), c.entry()
    assert hasattr(model, "flops") and hasattr(model, "reference")
    assert hasattr(driver, "Driver") and hasattr(entry, "Session")
    assert c.config["precision"][c.mix["entry"]] in ("float32", "tf32")
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = Cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads_and_its_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(Cell(CELLS[0]).metric(metric).read)
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in Cell(cell).end_to_end}


def test_metric_families_share_one_reader_and_no_file_is_a_copy():
    c = Cell(CELLS[0])
    assert c.metric("k1_roofline_pct.click").__file__ == c.metric(
        "k1_roofline_pct.bulk").__file__
    bodies = [p.read_bytes() for p in (BENCH_DIR / "metrics").glob("*.py")]
    assert len(bodies) == len(set(bodies))


def test_layers_are_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_file_matches_its_entry(cfg):
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    data = read_json(ROOT / entry["file"])
    assert data["name"] == cfg
    assert data["reduced"] == entry["reduced"]
    assert entry["file"].startswith("benchmark/")
    assert any(w["config"] == cfg for w in BENCH["workloads"])


def test_every_file_name_is_made_of_name_characters():
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts or ".pytest_cache" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
