"""The port's plots: every helper writes a PNG, the overlay refuses mixed
file kinds, and ``live_plot=True`` re-renders its PNG in both sweep drivers
(on the CPU, into a temporary directory)."""
import pytest
import torch

from ldpc_3gpp_tpu_torch.parallel.sweep import SweepPoint, bler_vs_snr, snr_vs_a
from ldpc_3gpp_tpu_torch.utils import plotting

torch.set_num_threads(1)

SMALL = dict(rate=[0.5], bg=[2], algorithm="min-sum", iterations=4,
             target_block_errors=10, target_bler=0.3, esn0_start=2.0,
             batch_per_device=64, device="cpu", verbose=False)


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_curve_plots(tmp_path):
    curves = {(2, 0.5, 100): [SweepPoint(1.0, 100, 50, 900, 400),
                              SweepPoint(2.0, 100, 5, 60, 300),
                              SweepPoint(3.0, 100, 0, 0, 200)]}
    assert _is_png(plotting.plot_bler_curves(curves, str(tmp_path / "a" / "b.png")))
    assert _is_png(plotting.plot_snr_vs_a(
        {1 / 3: [(1000, -1.0), (2000, -1.3)]}, str(tmp_path / "s.png")))


@pytest.mark.parametrize("bg", [1, 2])
def test_base_graph_plot(tmp_path, bg):
    assert _is_png(plotting.plot_base_graph(bg, 3, str(tmp_path / f"bg{bg}.png")))


def test_results_files_overlay(tmp_path):
    a = tmp_path / "SNR_vs_A_1.txt"
    a.write_text("1000\t-1.0\n2000\t-1.3\n")
    b = tmp_path / "BLER_vs_SNR_1.txt"
    b.write_text("0.0\t0.5\n")
    out = plotting.plot_results_files([str(a)], str(tmp_path / "o.png"), vlines=["-1.5"])
    assert _is_png(out)
    with pytest.raises(ValueError, match="mixed"):
        plotting.plot_results_files([str(a), str(b)], str(tmp_path / "x.png"))
    with pytest.raises(ValueError, match="infer"):
        plotting.plot_results_files([str(tmp_path / "other.txt")], str(tmp_path / "y.png"))


def test_live_plot_in_both_drivers(tmp_path):
    bler_vs_snr(A=[100], results_dir=str(tmp_path / "b"), live_plot=True, **SMALL)
    assert _is_png(tmp_path / "b" / "BLER_vs_SNR_live.png")
    kw = dict(SMALL, bg=2, rate=(0.5,), esn0_delta=0.5)
    snr_vs_a(A=(100,), results_dir=str(tmp_path / "s"), live_plot=True, **kw)
    assert _is_png(tmp_path / "s" / "SNR_vs_A_live.png")
