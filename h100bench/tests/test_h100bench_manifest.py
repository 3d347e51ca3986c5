"""BENCHMARK.json against the contract's shape, and the harness finding
every file it names by name."""

from __future__ import annotations

import re

from h100bench.core import manifest

from .conftest import ROOT

UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_names(bench: dict) -> list[str]:
    """Every name, config, traffic, reduced key and unit that breaks the
    manifest's character rules, as messages (empty when none does)."""
    problems = []

    def name(value, where):
        if not isinstance(value, str) or not manifest.NAME.fullmatch(value):
            problems.append(f"{where}: bad name {value!r}")

    for cfg in bench.get("configs", []):
        name(cfg.get("name"), "configs")
        for key in cfg.get("reduced", []):
            name(key, f"configs {cfg.get('name')} reduced")
    for cell in bench.get("workloads", []):
        for key in ("name", "config", "traffic"):
            name(cell.get(key), f"workloads {key}")
    for group in ("end_to_end", "per_layer"):
        for metric in bench.get(group, []):
            name(metric.get("name"), group)
            unit = metric.get("unit")
            if not isinstance(unit, str) or not UNIT.fullmatch(unit):
                problems.append(f"{group} {metric.get('name')}: bad unit {unit!r}")
    return problems


TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_names_and_units_use_only_the_allowed_characters(bench):
    assert check_names(bench) == []


def test_a_bad_name_or_unit_is_caught(bench):
    bad = dict(bench, end_to_end=[dict(bench["end_to_end"][0],
                                       name="steps per s", unit="µs")])
    assert len(check_names(bad)) == 2


def test_the_manifest_has_exactly_the_contract_keys(bench):
    assert set(bench) == TOP
    for cfg in bench["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for group in ("end_to_end", "per_layer"):
        for metric in bench[group]:
            required = ({"name", "unit", "better", "bound", "source"}
                        if group == "end_to_end" else
                        {"name", "unit", "better", "source", "layer", "moves"})
            assert required <= set(metric) <= required | {"workloads"}


def test_every_moves_is_reported_in_each_of_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [c["name"] for c in bench["workloads"]]
    for metric in bench["per_layer"]:
        for cell in metric.get("workloads", cells):
            assert manifest.reports(e2e[metric["moves"]], cell), (metric, cell)


def test_the_harness_finds_every_file_by_name(bench):
    for cell in bench["workloads"]:
        resolved = manifest.resolve(bench, ROOT, cell["name"])
        assert resolved.traffic["job"]["size"] > 0
        assert manifest.driver(resolved.config["driver"]).run
        for metric in resolved.end_to_end + resolved.per_layer:
            assert callable(manifest.reader(metric["name"]))


def test_each_configuration_file_names_what_it_cut(bench):
    for cfg in bench["configs"]:
        data = manifest.load(ROOT / cfg["file"])
        assert data["name"] == cfg["name"]
        assert set(cfg["reduced"]) <= set(data["published"])
        for key in cfg["reduced"]:
            assert data[key] != data["published"][key]


def test_an_unknown_cell_or_driver_is_refused(bench):
    import pytest

    with pytest.raises(manifest.ManifestError):
        manifest.resolve(bench, ROOT, "no.such.cell")
    with pytest.raises(manifest.ManifestError):
        manifest.driver("../run")
