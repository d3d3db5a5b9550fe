"""The manifest keeps to the benchmark's rules, and every part it names
is a file the harness finds by that name."""
import os
import re

import pytest

from perfbench import harness, roofline
from perfbench.drivers import gemm_pass

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_exactly_the_allowed_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for e in bench[kind]:
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        if "better" in e:
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_every_layer_metric_cell_reports_what_it_moves(bench):
    work = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for w in m.get("workloads", work):
            assert w in work
            assert harness.metric_applies(moved, w), (m["name"], w)


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if harness.metric_applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.metric_applies(m, w["name"])
                   for m in bench["per_layer"])


def test_parts_are_found_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        assert harness.driver(cell.traffic["driver"]).run
        assert cell.limits["checks"]
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        data = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert data["reduced"] == c["reduced"]
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


@pytest.mark.parametrize("config,tera,grouped", [
    ("qwen2-1.5b", 12.64, 0.0), ("granite-moe-3b-a800m", 7.21, 0.69)])
def test_frozen_pass_operations(config, tera, grouped):
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         config + ".json"))
    products = gemm_pass.resolve(cfg, 4096)
    ops = roofline.pass_ops(products)
    assert round(ops / 1e12, 2) == tera
    g = sum(p["count"] * roofline.product_ops(p) for p in products
            if "groups" in p)
    assert round(g / ops, 2) == grouped


def test_training_counts_match_the_launches_a_step():
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "qwen2-1.5b.json"))
    prods = roofline.train_gemm_products(cfg, 6144)
    # 28 layers x 3 products x 4 runs, the head 3: phase 15 (a)'s 339
    assert sum(p["count"] for p in prods) == 339
    assert prods[-1]["n"] == 152064


def test_run_seconds_fit_the_full_check(bench):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
