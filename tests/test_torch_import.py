"""pccl_tpu_torch stands alone: it imports neither jax nor the JAX package
(pccl_tpu), and importing the package itself loads nothing heavy."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pccl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / "pccl_tpu_torch").rglob("*.py"))


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "pccl_tpu", "optax", "flax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
                "import_module" and node.args and isinstance(node.args[0], ast.Constant):
            if _forbidden(str(node.args[0].value)):
                bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def _imports(path: Path) -> set:
    """Every module a file imports, anywhere in it, relative imports
    resolved: `from X import n` counts as X and as X.n."""
    package = path.relative_to(REPO).with_suffix("").parts[:-1]
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else ()
            mod = ".".join(base + ((node.module,) if node.module else ()))
            out |= {mod} | {f"{mod}.{a.name}" for a in node.names}
    return out


def _under(mod: str, prefixes) -> bool:
    return any(mod == p or mod.startswith(p + ".") for p in prefixes)


def test_layers_import_one_way():
    """models/ and ops/ import none of the modules built on them (the train
    step, DiLoCo, the pipeline, the hierarchical reduce), and
    parallel/mesh.py, the process groups under the models, imports nothing
    of models/."""
    above = [f"pccl_tpu_torch.parallel.{m}"
             for m in ("train", "diloco", "pipeline", "hierarchical")]
    bad = []
    for path in PORT_FILES:
        rel = path.relative_to(REPO).as_posix()
        if rel.startswith(("pccl_tpu_torch/models/", "pccl_tpu_torch/ops/")):
            bad += [(rel, m) for m in sorted(_imports(path)) if _under(m, above)]
        if rel == "pccl_tpu_torch/parallel/mesh.py":
            bad += [(rel, m) for m in sorted(_imports(path))
                    if _under(m, ["pccl_tpu_torch.models"])]
    assert not bad, bad


def test_every_module_imports_without_jax():
    """All modules import in a fresh interpreter where jax and pccl_tpu
    cannot be imported at all."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'pccl_tpu', 'optax', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "import pccl_tpu_torch\n"
        "assert 'torch' not in sys.modules, 'the package import loaded torch'\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke test exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
