"""Decoder-semantics fingerprint of the port.

A measured artifact (a results file, a fuzzing tally) is stamped with this
hash so that a later reader can tell whether the sources that decide the
decoder's results changed since it was made: ``ldpc-torch-testbench --soak``
stamps its tally with it.

The hash covers a NORMALIZED form of the port's ``ops/``, ``models/`` and
``spec/`` Python sources — the AST with docstrings stripped — plus the raw
bytes of the base-graph tables (``spec/base_graphs.npz``) and of the CUDA
sources (``csrc/*.cu``, ``csrc/*.cuh``), so comment, docstring and
formatting edits of the Python sources do not move it.  Anything that
changes executable structure (constants, defaults, control flow) does.
"""
from __future__ import annotations

import ast
import glob
import hashlib
import os


def _serialize(value, out) -> None:
    """Interpreter-version-stable AST serialization.

    ``ast.dump`` output changes across Python minors (3.12 added
    ``type_params=[]`` to every FunctionDef/ClassDef dump), which would
    spuriously flag every stamp stale under a different interpreter.  This
    serializer emits node type names plus ``iter_fields``, SKIPPING fields that are None or an empty list — new
    Python versions introduce new fields with exactly those defaults, so
    sources that don't use a new construct hash identically everywhere.
    Code that does use a version-specific construct differs legitimately.
    """
    if isinstance(value, ast.AST):
        out.append(type(value).__name__)
        out.append("(")
        for name, field in ast.iter_fields(value):
            if field is None or (isinstance(field, list) and not field):
                continue
            out.append(name)
            out.append("=")
            _serialize(field, out)
            out.append(",")
        out.append(")")
    elif isinstance(value, list):
        out.append("[")
        for item in value:
            _serialize(item, out)
            out.append(",")
        out.append("]")
    else:  # constants: repr distinguishes 1 / 1.0 / True / '1' / b'1'
        out.append(f"{type(value).__name__}:{value!r}")


def _normalized(path: str) -> bytes:
    """Comment/docstring/formatting/interpreter-invariant dump of one
    Python source."""
    with open(path, "r") as fid:
        tree = ast.parse(fid.read())
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                node.body = body[1:] or [ast.Pass()]
    out = []
    _serialize(tree, out)
    return "".join(out).encode()


def semantics_fingerprint(root: str | None = None) -> str:
    """SHA-256 (16 hex chars) over the decoder-semantics-relevant sources
    of the package at ``root`` (default: this package)."""
    if root is None:
        root = os.path.join(os.path.dirname(__file__), "..")
    files = sorted(
        glob.glob(os.path.join(root, "ops", "*.py"))
        + glob.glob(os.path.join(root, "models", "*.py"))
        + glob.glob(os.path.join(root, "spec", "*.py"))
    )
    h = hashlib.sha256()
    for f in files:
        h.update(os.path.relpath(f, root).encode())
        h.update(_normalized(f))
    # the base-graph shift tables and the kernels are semantics too (raw bytes)
    raw = [os.path.join(root, "spec", "base_graphs.npz")] + sorted(
        glob.glob(os.path.join(root, "csrc", "*.cu"))
        + glob.glob(os.path.join(root, "csrc", "*.cuh"))
    )
    for f in raw:
        h.update(os.path.relpath(f, root).encode())
        with open(f, "rb") as fid:
            h.update(fid.read())
    return h.hexdigest()[:16]
