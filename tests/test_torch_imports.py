"""The port stands alone: no module of librdkafka_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib or the JAX package (librdkafka_tpu)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "librdkafka_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "librdkafka_tpu")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_has_modules():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imports(tree) if _banned(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_banned_rule_keeps_the_port_name():
    assert _banned("librdkafka_tpu.ops") and _banned("jax.numpy")
    assert not _banned("librdkafka_tpu_torch.ops")


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_lookup_of_reference_modules(path):
    """No module looks the JAX package up by name either (a copied
    ``sys.modules.get("librdkafka_tpu...")`` would reach the reference's
    caches)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and _banned(n.value.split()[0] if n.value.split() else "")]
    assert not names, f"{path.name} names {names}"
