"""The port's plot tools (``regen_plots``, ``plot_snr_vs_a_surface``) render
the committed ``golden_torch/`` artifacts into a temporary directory, and
refuse to write under ``golden/``."""
import os
import shutil

import pytest

from ldpc_3gpp_tpu_torch.tools import plot_snr_vs_a_surface, regen_plots

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "golden_torch")

pytest.importorskip("matplotlib")


def _png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_regen_plots_renders_every_figure_of_golden_torch(tmp_path):
    art = shutil.copytree(PORT, tmp_path / "art")
    plots = regen_plots.main(["--dir", str(art)])
    names = sorted(os.listdir(plots))
    assert names == ["base_graph_1.png", "base_graph_2.png", "bler_curves.png",
                     "harq_ir.png", "snr_vs_a.png"]
    assert all(_png(os.path.join(plots, n)) for n in names)
    assert not os.path.exists(os.path.join(PORT, "plots"))


def test_plot_snr_vs_a_surface_renders_the_port_surface(tmp_path):
    out = tmp_path / "surface.png"
    assert plot_snr_vs_a_surface.main(
        ["--golden", os.path.join(PORT, "SNR_vs_A_surface.json"), "--out", str(out)]) == str(out)
    assert _png(out)


def test_plot_tools_refuse_golden(tmp_path):
    with pytest.raises(ValueError, match="golden"):
        regen_plots.main(["--dir", os.path.join(ROOT, "golden")])
    with pytest.raises(ValueError, match="golden"):
        plot_snr_vs_a_surface.main(["--golden", os.path.join(PORT, "SNR_vs_A_surface.json"),
                                    "--out", os.path.join(ROOT, "golden", "plots", "x.png")])
