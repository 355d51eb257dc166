"""BENCHMARK.json against its rules: allowed characters, each per-layer
metric moving an end-to-end metric that each of its cells reports, and
every file a cell or metric names present, each configuration's family
among them."""
import re

import pytest

from perfbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = bench.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _names():
    yield from (c["name"] for c in MAN["configs"])
    for w in MAN["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        yield m["name"]
    for c in MAN["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (bench.HERE / "metrics" / f"{metric['name']}.py").is_file()
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    for cell in metric.get("workloads", CELLS):
        reported = {m["name"] for m in bench.metrics_of(cell, False, MAN)}
        assert metric["moves"] in reported, (metric["name"], cell)


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist_and_report_enough(cell):
    assert (bench.HERE / "configs" / f"{cell['config']}.json").is_file()
    assert (bench.HERE / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (bench.HERE / "limits" / f"{cell['name']}.json").is_file()
    assert cell["chips"] in (1, 4)
    e2e = {m["name"] for m in bench.metrics_of(cell["name"], False, MAN)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.metrics_of(cell["name"], True, MAN)


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_names_a_family_that_gives_the_interface(cfg):
    """Every configuration names a family whose file exists and that gives
    what every family gives and what each run kind of its cells calls."""
    c = bench.config(cfg["name"])
    assert (bench.HERE / "families" / f"{c['family']}.py").is_file()
    fam = bench.family(c["family"])
    need = set(bench.FAMILY)
    for w in MAN["workloads"]:
        if w["config"] == cfg["name"]:
            need |= set(bench.kind(bench.traffic(w["traffic"])["kind"]).FAMILY)
    assert not [n for n in sorted(need) if not callable(getattr(fam, n, None))]
