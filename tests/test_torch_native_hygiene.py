"""Rules of the port's native host layer that hold by construction: its
C++ sources include nothing but the system's headers and the port's own,
and no port file reaches into the JAX package's directory for a file (a
source, a library, a path) in its code.  Docstrings and comments may cite
the JAX package's files they were copied from, and ``chip_smoke.py``'s
report cites each TPU kernel by ``file:line``."""

import ast
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tse1m_tpu_torch")
NATIVE = os.path.join(PKG, "native")
_INCLUDE = re.compile(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', re.M)


def _walk(suffixes):
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(suffixes):
                yield os.path.join(root, f)


def test_native_sources_include_only_the_system_and_the_port():
    sources = sorted(_walk((".cc", ".h")))
    names = {os.path.basename(p) for p in sources}
    assert {"decode.cc", "encode.cc", "pg_decode.cc", "columns.h"} <= names
    for path in sources:
        for kind, header in _INCLUDE.findall(open(path).read()):
            if kind == '"':
                # A quoted include names a header beside the source.
                assert "/" not in header, (path, header)
                assert os.path.isfile(os.path.join(os.path.dirname(path),
                                                   header)), (path, header)
            else:
                assert "tse1m" not in header, (path, header)


def _code_strings(path):
    """String literals of a Python file that are not docstrings."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


_CITATION = re.compile(r"^[\w/]+\.py:\d+$")


def _names_jax_dir(text: str) -> bool:
    if _CITATION.match(text):
        return False
    return re.search(r"(^|[^\w])tse1m_tpu([/\\]|$)", text) is not None


def test_no_port_file_names_a_path_in_the_jax_package():
    assert _names_jax_dir("tse1m_tpu/native/decode.cc")
    assert _names_jax_dir("tse1m_tpu")  # a path component alone
    assert not _names_jax_dir("build/tse1m_tpu_torch/native")
    assert not _names_jax_dir("tse1m_tpu_torch")
    assert not _names_jax_dir("tse1m_tpu/cluster/kernels/rans.py:80")
    bad = []
    for path in sorted(_walk((".py",))) + [os.path.join(REPO,
                                                        "chip_smoke.py")]:
        bad += [(path, s) for s in _code_strings(path) if _names_jax_dir(s)]
    assert bad == []
    # In C++ code (comments aside) no string names the JAX package either.
    for path in sorted(_walk((".cc", ".h"))):
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", open(path).read(), flags=re.S)
        assert not _names_jax_dir(" ".join(re.findall(r'"([^"]*)"', code))), \
            path


def test_native_libraries_build_from_the_port_only():
    from tse1m_tpu_torch import native

    for src, _, _, deps in native._LIBS.values():
        for f in (src, *deps):
            assert os.path.isfile(os.path.join(NATIVE, f))
    assert native._DIR == NATIVE
    assert os.path.commonpath([native.BUILD_DIR, PKG]) != PKG
