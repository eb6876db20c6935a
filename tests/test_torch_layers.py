"""The port's import direction, read from its sources' AST: the engine sits
on top of ``eqlb`` (only the package's ``__init__`` and the equilibrators
import it), and the layers below ``eqlb`` (``fem``, ``ops``, ``elements``,
``mesh``, ``utils``) import nothing from it, at module level or inside a
function.  ``utils.perftest`` (the performance harness, which drives the
equilibrators) and ``utils.io`` (whose ``flux_cell_values`` evaluates an
equilibrated flux) are tooling above ``eqlb`` and are exempt."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "dolfinx_eqlb_tpu_torch"
_TOOLS_ABOVE_EQLB = {"utils/perftest.py", "utils/io.py"}


def _imports(path: Path) -> list[str]:
    """Every module ``path`` imports, anywhere in it, as an absolute
    dotted name within the package (relative imports resolved)."""
    parts = path.relative_to(PKG.parent).with_suffix("").parts
    package = parts[:-1]
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = list(package[:len(package) - node.level + 1]
                        if node.level else [])
            mod = ".".join(base + ([node.module] if node.module else []))
            out.append(mod)
            # ``from . import engine`` names a module in its alias
            out += [f"{mod}.{alias.name}" for alias in node.names]
    return out


def _modules(layer: str) -> list[Path]:
    return sorted((PKG / layer).glob("*.py"))


@pytest.mark.parametrize("path", _modules("eqlb"), ids=lambda p: p.name)
def test_only_the_top_of_eqlb_imports_the_engine(path):
    if path.name in ("__init__.py", "equilibrators.py", "engine.py"):
        return
    engine = "dolfinx_eqlb_tpu_torch.eqlb.engine"
    assert not [m for m in _imports(path) if m == engine], path.name


@pytest.mark.parametrize("layer", ["fem", "ops", "elements", "mesh",
                                   "utils"])
def test_lower_layers_import_nothing_from_eqlb(layer):
    eqlb = "dolfinx_eqlb_tpu_torch.eqlb"
    found = {f"{layer}/{p.name}": m for p in _modules(layer)
             for m in _imports(p)
             if f"{layer}/{p.name}" not in _TOOLS_ABOVE_EQLB
             and (m == eqlb or m.startswith(eqlb + "."))}
    assert not found
