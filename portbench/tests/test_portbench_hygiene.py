"""What the benchmark runs stands apart: nothing under ``portbench/`` imports
JAX or the JAX package (top-level module names compared whole:
``repro_torch`` begins with ``repro``), and the reference imports nothing of
the program.  Every name ``BENCHMARK.json`` gives has its file."""
import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FILES = sorted(HERE.rglob("*.py"))
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imported(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "repro"), name


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name in _imported(path):
        assert name.split(".")[0] in ("torch", "numpy", "hashlib", "typing", "portbench",
                                      "__future__", "math"), name
        assert not name.startswith(("portbench.drivers", "portbench.harness")), name


def test_every_name_has_its_file():
    for c in MAN["workloads"]:
        for sub, name in (("configs", c["config"]), ("traffic", c["traffic"]),
                          ("limits", c["name"])):
            assert (HERE / sub / f"{name}.json").is_file(), (sub, name)
        mix = json.loads((HERE / "traffic" / f"{c['traffic']}.json").read_text())
        assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert harness.reader_path(m["name"]).is_file(), m["name"]
    for c in MAN["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_names_units_and_moves_keep_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    cells = {c["name"] for c in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and all(m["bound"] <= 0.25 for m in e2e.values())
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells)), m["name"]
    for c in MAN["workloads"]:
        assert name.match(c["name"]) and c["chips"] in (1, 4) and len(c["why"]) <= 200
