"""The port stands alone and is whole.

No module of ``repro_torch`` (``roofline.py`` and ``launch/dryrun.py``
among them), no example under ``examples/torch/`` and not ``chip_smoke.py``
imports ``jax`` or the JAX package ``repro``; and every public top-level
name of every ``src/repro/**.py`` module is defined by the port's mirror of
it, save the TPU-only names of :data:`NOT_PORTED`, each with its reason.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples" / "torch").glob("*.py")) + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "repro")
JAX_MODULES = sorted((ROOT / "src" / "repro").rglob("*.py"))

# module (relative to src/repro) -> {name: why the port has no such name};
# "*" stands for the whole module
NOT_PORTED = {
    "kernels/_compat.py": {"*": "shims over jax.experimental.pallas versions: the port "
                                "has no Pallas"},
    "kernels/ops.py": {
        "conv_slab_plan": "a TPU VMEM row-band schedule: K2/K4 gather from global "
                          "memory, so any image size runs",
        "conv_whole_image_fits": "the VMEM test of that schedule",
        "IMPLICIT_VMEM_BUDGET": "the VMEM budget of that schedule",
    },
    "kernels/pasm_matmul.py": {"SlabPlan": "the VMEM slab schedule's plan"},
    "roofline.py": {
        "parse_collective_bytes": "parses XLA's HLO text; the port's counterpart is "
                                  "roofline.collective_stats over launch/mesh.py's counters",
        "hlo_bytes_by_op": "parses HLO; the port's is StepCounter.op_bytes_by_kind",
        "hlo_biggest_tensors": "parses HLO; the port's is StepCounter.biggest_tensors",
        "PEAK_FLOPS": "TPU v5e rate; the port's rates are roofline.HW's H100 fields",
        "HBM_BW": "TPU v5e rate; see roofline.HW",
        "LINK_BW": "TPU v5e ICI rate; see roofline.HW",
        "N_LINKS": "TPU v5e ICI links; see roofline.HW",
    },
    "models/ssm_lm.py": {"trunc": "an init-law helper over jax.random: the port draws "
                                  "the same law through Initializer"},
    "models/transformer.py": {"trunc_embed": "an init-law helper over jax.random: the "
                                             "port draws the same law through Initializer"},
    "nn/moe.py": {"Constrain": "the type of JAX's with_sharding_constraint hook: the "
                               "port's layouts are explicit (ShardCtx), with no hook"},
}


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert len(PORT_FILES) > 10


def _public_names(path: Path, *, imported: bool = False) -> set:
    """Top-level functions, classes and assigned names not starting with
    ``_`` (and, with ``imported``, the names the module imports)."""
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("path", JAX_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT / "src" / "repro")))
def test_the_port_mirrors_every_public_name(path):
    rel = str(path.relative_to(ROOT / "src" / "repro"))
    skip = NOT_PORTED.get(rel, {})
    mirror = ROOT / "src" / "repro_torch" / rel
    if "*" in skip:
        assert not mirror.exists(), f"{rel} is ported now: take it off NOT_PORTED"
        return
    assert mirror.exists(), f"src/repro/{rel} has no mirror in src/repro_torch"
    missing = _public_names(path) - _public_names(mirror, imported=True) - set(skip)
    assert not missing, f"src/repro_torch/{rel} lacks {sorted(missing)}"
    stale = set(skip) & _public_names(mirror, imported=True)
    assert not stale, f"src/repro_torch/{rel} defines {sorted(stale)}: take it off NOT_PORTED"


def test_the_tooling_is_ported():
    for rel in ("roofline.py", "launch/dryrun.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES
    assert {p.name for p in (ROOT / "examples" / "torch").glob("*.py")} >= {
        "quickstart.py", "paper_conv.py", "train_lm.py", "serve_pasm.py"}
