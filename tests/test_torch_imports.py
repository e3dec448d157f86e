"""The port stands alone: no module of librdkafka_tpu_torch, and neither
chip_smoke.py nor flood_tail.py, imports jax, jaxlib, cffi or the JAX
package (librdkafka_tpu); the C and C++ sources of its C ABI and examples
do not name them."""
import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "librdkafka_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "flood_tail.py"]
BANNED = ("jax", "jaxlib", "librdkafka_tpu", "cffi")
C_FILES = sorted(p for d in ("capi", "examples")
                 for p in (ROOT / "librdkafka_tpu_torch" / d).glob("*")
                 if p.suffix in (".c", ".cpp", ".hpp"))
C_BANNED = re.compile(r"librdkafka_tpu(?!_torch)|\bjax\b|\bcffi\b")


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


def test_c_sources_found():
    names = {p.name for p in C_FILES}
    assert {"tkafka.c", "tkafka.hpp", "gpu_smoke.c", "capi_client.c",
            "cpp_client.cpp"} <= names


@pytest.mark.parametrize("path", C_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in C_FILES])
def test_c_sources_name_no_reference(path):
    """The shim, the C++ wrapper and the C examples name neither the JAX
    package nor jax nor cffi (the port's library embeds neither)."""
    bad = C_BANNED.findall(path.read_text())
    assert not bad, f"{path.name} names {bad}"
