"""The port's profiling helpers and its semantics fingerprint."""
import json
import os
import shutil

import torch

import ldpc_3gpp_tpu_torch
from ldpc_3gpp_tpu_torch.utils import fingerprint, profiling

torch.set_num_threads(1)

PKG = os.path.dirname(ldpc_3gpp_tpu_torch.__file__)


def test_slope_time_is_positive_on_the_cpu():
    x = torch.randn(160, 160)
    per_call = profiling.slope_time(lambda t: t @ t @ t, x, reps=3)
    assert 0.0 < per_call < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "t" / "trace.json"
    with profiling.trace(str(path)) as p:
        assert p == str(path)
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _copy_package(tmp_path):
    root = tmp_path / "pkg"
    for sub in ("ops", "models", "spec", "csrc"):
        shutil.copytree(os.path.join(PKG, sub), root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_fingerprint_ignores_comments_and_follows_code(tmp_path):
    here = fingerprint.semantics_fingerprint()
    assert len(here) == 16 and int(here, 16) >= 0
    root = _copy_package(tmp_path)
    assert fingerprint.semantics_fingerprint(str(root)) == here
    src = root / "ops" / "decoder.py"
    text = src.read_text()
    src.write_text(text.replace('"""Flooding', '"""Edited docstring.  Flooding', 1)
                   + "\n# a comment\n")
    assert fingerprint.semantics_fingerprint(str(root)) == here
    src.write_text(text.replace("_PHI_MAX = 38.0", "_PHI_MAX = 37.0"))
    assert fingerprint.semantics_fingerprint(str(root)) != here
    src.write_text(text)
    cu = root / "csrc" / "ldpc_bp.cuh"
    cu.write_text(cu.read_text() + "\n")
    assert fingerprint.semantics_fingerprint(str(root)) != here
