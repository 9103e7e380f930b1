"""The port's normal-approximation bound (``ldpc_3gpp_tpu_torch/tools/na_bound.py``)
equals the JAX package's ``tools/na_bound.py`` (numpy only, so exactly) on
every (A, G, target) of ``golden/SNR_vs_A_surface.json``, and its ``main``
run on that surface reproduces ``golden/na_bound.json`` byte for byte."""
import json
import os
import sys

import pytest

from ldpc_3gpp_tpu_torch.tools import na_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.na_bound import biawgn_c_v, na_required_esn0_db, qinv  # noqa: E402

GOLDEN = os.path.join(ROOT, "golden")
RATES = {"0.2": 1 / 5, "0.333333": 1 / 3, "0.5": 1 / 2, "0.666667": 2 / 3}


def _surface_A():
    with open(os.path.join(GOLDEN, "SNR_vs_A_surface.json")) as f:
        return json.load(f)["A"]


def test_capacity_dispersion_and_qinv_equal_the_jax_tool():
    for db in (-10.0, -4.5, -1.0, 0.0, 0.5, 3.0, 8.0):
        gamma = 10 ** (db / 10)
        assert na_bound.biawgn_c_v(gamma) == biawgn_c_v(gamma)
    for eps in (1e-1, 1e-2, 1e-3, 0.5):
        assert na_bound.qinv(eps) == qinv(eps)


@pytest.mark.parametrize("rate_key", list(RATES))
def test_required_esn0_equals_the_jax_tool_on_every_surface_point(rate_key):
    for A in _surface_A():
        G = int(round(A / RATES[rate_key] / 2) * 2)
        for eps in (1e-1, 1e-2):
            assert na_bound.na_required_esn0_db(A, G, eps) == na_required_esn0_db(A, G, eps)


def test_main_reproduces_the_golden_na_bound_file(tmp_path):
    out = tmp_path / "na_bound.json"
    na_bound.main(["--surface", os.path.join(GOLDEN, "SNR_vs_A_surface.json"),
                   "--out", str(out)])
    with open(os.path.join(GOLDEN, "na_bound.json"), "rb") as f:
        assert out.read_bytes() == f.read()


def test_main_refuses_golden():
    with pytest.raises(ValueError, match="golden"):
        na_bound.main(["--surface", os.path.join(GOLDEN, "SNR_vs_A_surface.json"),
                       "--out", os.path.join(GOLDEN, "na_bound.json")])
