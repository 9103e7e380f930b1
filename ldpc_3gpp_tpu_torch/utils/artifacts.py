"""Where the port's measured artifacts go, and what they say of the device.

The JAX package's goldens live under ``golden/`` and are stamped with its
own fingerprint (``tests/test_goldens_stamped.py``); the port never writes
there.  Its tools write under ``results/torch/golden/`` by default
(git-ignored), and the artifacts measured on the card are committed under
``golden_torch/`` with the JAX goldens' file names and keys.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
from fractions import Fraction

import torch

#: the port's default artifact directory
DEFAULT_DIR = os.path.join("results", "torch", "golden")
#: the JAX package's stamped artifacts, the one directory the port never writes
JAX_GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "golden")


def check_out_path(path: str) -> str:
    """``path``, or ValueError where it lies under the repository's
    ``golden/`` (the JAX package's stamped artifacts), links resolved."""
    real, guard = os.path.realpath(path), os.path.realpath(JAX_GOLDEN_DIR)
    if os.path.commonpath([real, guard]) == guard:
        raise ValueError(
            f"{path}: refusing to write under {JAX_GOLDEN_DIR}, which holds the JAX "
            f"package's artifacts; write under {DEFAULT_DIR} or golden_torch/")
    return path


def card_label(device) -> str:
    """The device a measurement ran on, for an artifact's description: the
    card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or the host CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "the host CPU (plain PyTorch versions, no GPU)"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(index)], check=True, capture_output=True, text=True)
    return out.stdout.strip()


def dump(out_dir: str, name: str, obj) -> str:
    """Write ``obj`` as ``out_dir/name`` (JSON, indent 1); returns the path."""
    path = check_out_path(os.path.join(out_dir, name))
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    print(f"wrote {path}", flush=True)
    return path


def infer_counts(bler: float, unit: int, target: int, cap: int):
    """(blocks, errors) of a point whose artifact stores its BLER alone: the
    smallest sample consistent with it and with the sweep that made it:
    blocks a multiple of ``unit`` (one call) for which bler x blocks is an
    integer, and either at least ``target`` errors or at least ``cap`` blocks
    (the sweep stops on either).  A smaller sample than the true one gives a
    wider two-sample bound, never a narrower one."""
    f = Fraction(bler).limit_denominator(10 ** 9)
    n0 = math.lcm(f.denominator, unit)
    blocks = n0
    while f * blocks < target and blocks < cap:
        blocks += n0
    if abs(f * blocks - bler * blocks) > 1e-6:
        raise ValueError(f"BLER {bler!r} is no ratio of a sample of {unit}-block calls")
    return blocks, int(f * blocks)
