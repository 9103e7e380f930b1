"""The port's output-path rule (``ldpc_3gpp_tpu_torch/utils/artifacts.py``):
only the repository's own ``golden/`` is refused, and every golden-pipeline
tool writes at its default output, ``results/torch/golden/`` under the
working directory."""
import json
import os
import shutil

import pytest
import torch

from ldpc_3gpp_tpu_torch.tools import demod_compare, na_bound, plot_snr_vs_a_surface
from ldpc_3gpp_tpu_torch.tools import density_evolution as de
from ldpc_3gpp_tpu_torch.tools import regen_goldens as rg
from ldpc_3gpp_tpu_torch.tools import regen_plots
from ldpc_3gpp_tpu_torch.utils.artifacts import DEFAULT_DIR, JAX_GOLDEN_DIR, check_out_path

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "golden_torch")


def test_the_guarded_directory_is_the_repositorys_golden():
    assert os.path.realpath(JAX_GOLDEN_DIR) == os.path.realpath(os.path.join(ROOT, "golden"))
    assert os.path.exists(os.path.join(JAX_GOLDEN_DIR, "de_thresholds.json"))


@pytest.mark.parametrize("path", [
    DEFAULT_DIR,
    os.path.join(DEFAULT_DIR, "na_bound.json"),
    os.path.join(DEFAULT_DIR, "plots"),
    "golden_torch",
    os.path.join(ROOT, "golden_torch", "de_thresholds.json"),
    os.path.join(ROOT, "golden_other", "x.json"),
    os.path.join(ROOT, "chiprun_out", "golden", "x.json"),
])
def test_check_out_path_lets_other_directories_named_golden_pass(path):
    assert check_out_path(path) == path


@pytest.mark.parametrize("path", [
    os.path.join(ROOT, "golden"),
    os.path.join(ROOT, "golden", "x.json"),
    os.path.join(ROOT, "golden", "sub", "plots"),
    os.path.join(ROOT, "golden_torch", "..", "golden", "x.json"),
])
def test_check_out_path_refuses_the_repositorys_golden(path):
    with pytest.raises(ValueError, match="golden"):
        check_out_path(path)


def test_check_out_path_refuses_a_link_into_golden(tmp_path):
    link = tmp_path / "elsewhere"
    os.symlink(JAX_GOLDEN_DIR, link)
    with pytest.raises(ValueError, match="golden"):
        check_out_path(str(link / "x.json"))
    with pytest.raises(ValueError, match="golden"):
        check_out_path(str(link))


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """The working directory a temporary one, with the committed port
    artifacts at the default output directory."""
    monkeypatch.chdir(tmp_path)
    shutil.copytree(PORT, DEFAULT_DIR)
    return tmp_path


def test_na_bound_writes_at_its_defaults(in_tmp):
    os.remove(os.path.join(DEFAULT_DIR, "na_bound.json"))
    na_bound.main([])
    with open(os.path.join(DEFAULT_DIR, "na_bound.json")) as f:
        assert json.load(f) == json.load(open(os.path.join(PORT, "na_bound.json")))


def test_plot_tools_write_at_their_defaults(in_tmp):
    pytest.importorskip("matplotlib")
    plots = regen_plots.main([])
    assert os.path.realpath(plots) == os.path.realpath(os.path.join(DEFAULT_DIR, "plots"))
    assert "snr_vs_a.png" in os.listdir(plots)
    out = plot_snr_vs_a_surface.main([])
    assert os.path.exists(out) and out.startswith(DEFAULT_DIR)


def test_density_evolution_writes_at_its_default(in_tmp):
    os.remove(os.path.join(DEFAULT_DIR, "de_thresholds.json"))
    de.main(["--configs", "reg36", "--samples", "2000", "--max-iters", "60",
             "--iters-per-block", "10", "--tol-db", "0.25", "--device", "cpu"])
    assert os.path.exists(os.path.join(DEFAULT_DIR, "de_thresholds.json"))


def test_demod_compare_takes_its_default_output(in_tmp, monkeypatch):
    seen = []
    monkeypatch.setattr(demod_compare, "run", lambda out, device: seen.append(out))
    demod_compare.main(["--device", "cpu"])
    assert seen == [os.path.join(DEFAULT_DIR, "demod_methods_64QAM.json")]


def test_regen_goldens_runs_a_stage_and_restamps_at_its_defaults(in_tmp):
    from test_torch_regen_goldens import FILES, TINY

    os.remove(os.path.join(DEFAULT_DIR, FILES["snrvsa"]))
    rg.run_stage("snrvsa", device="cpu", results_dir=str(in_tmp / "results"),
                 **TINY["snrvsa"])
    assert os.path.exists(os.path.join(DEFAULT_DIR, FILES["snrvsa"]))
    assert rg.main(["--restamp"]) == []
