"""The port's console commands on the CPU: the sweeps write what the
drivers write (plus their plots), the testbench holds the port against the
C++ oracle, ``--soak`` keeps its tally where ``--tally`` says, and the
overlay plot is written."""
import json
import os

import pytest
import torch

from ldpc_3gpp_tpu_torch import cli
from ldpc_3gpp_tpu_torch.parallel.sweep import bler_vs_snr, snr_vs_a

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_ARGS = ["--A", "100", "--rate", "0.5", "--algorithm", "min-sum",
              "--iterations", "4", "--target-block-errors", "20",
              "--target-bler", "0.3", "--esn0-start", "2.0",
              "--batch-per-device", "64", "--device", "cpu"]
SWEEP_KW = dict(A=[100], rate=[0.5], bg=[2], algorithm="min-sum", iterations=4,
                target_block_errors=20, target_bler=0.3, esn0_start=2.0,
                batch_per_device=64, steps_per_call=2, device="cpu",
                backend="auto", schedule="flooding", N_L=1, I_LBRM=0,
                TBS_LBRM=None, CBGTI=())
NAME = "BLER_vs_SNR_100_0.5_2_QPSK_4_20_2_0.txt"


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_bler_sweep_main_writes_the_drivers_file_and_plots(tmp_path):
    cli_dir, drv_dir = tmp_path / "cli", tmp_path / "driver"
    cli.bler_sweep_main(SWEEP_ARGS + ["--results-dir", str(cli_dir), "--live-plot"])
    bler_vs_snr(results_dir=str(drv_dir), verbose=False, **SWEEP_KW)
    got = _read(cli_dir / NAME)
    assert got and got == _read(drv_dir / NAME)
    for png in ("BLER_vs_SNR.png", "BLER_vs_SNR_live.png"):
        assert _read(cli_dir / png).startswith(b"\x89PNG"), png


def test_snr_vs_a_main_writes_the_drivers_file(tmp_path):
    args = ["--A", "100", "--rate", "0.5", "--bg", "2", "--algorithm",
            "min-sum", "--iterations", "4", "--target-block-errors", "10",
            "--target-bler", "0.3", "--esn0-start", "2.0", "--esn0-delta",
            "0.5", "--batch-per-device", "64", "--device", "cpu", "--no-plot"]
    cli.snr_vs_a_main(args + ["--results-dir", str(tmp_path / "cli")])
    snr_vs_a(A=(100,), rate=(0.5,), bg=2, algorithm="min-sum", iterations=4,
             target_block_errors=10, target_bler=0.3, esn0_start=2.0,
             esn0_delta=0.5, batch_per_device=64, steps_per_call=2,
             device="cpu", results_dir=str(tmp_path / "driver"), verbose=False)
    name = "SNR_vs_A_0.3_0.5_2_QPSK_4_10_0.txt"
    got = _read(tmp_path / "cli" / name)
    assert got == _read(tmp_path / "driver" / name)
    assert not (tmp_path / "cli" / "SNR_vs_A.png").exists()


def test_testbench_encode_and_decode_against_the_oracle(capsys):
    cli.testbench_main(["--device", "cpu", "--trials", "3"])
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and "configs bit-exact vs native oracle" in out
    cli.testbench_main(["--device", "cpu", "--trials", "2", "--decode",
                        "--max-a", "3000", "--seed", "1"])
    out = capsys.readouterr().out
    assert out.count("ok decode") == 2 and "2/2 configs bit-exact" in out


def test_soak_writes_its_tally_where_asked_and_nothing_under_golden(tmp_path):
    golden = os.path.join(ROOT, "golden")
    before = {n: os.stat(os.path.join(golden, n)).st_mtime_ns for n in os.listdir(golden)}
    tally = tmp_path / "t" / "tally.json"
    cli.testbench_main(["--soak", "--trials", "1", "--device", "cpu",
                        "--max-a", "2000", "--tally", str(tally)])
    after = {n: os.stat(os.path.join(golden, n)).st_mtime_ns for n in os.listdir(golden)}
    assert after == before
    with open(tally) as f:
        entries = json.load(f)["entries"]
    assert len(entries) == 1 and entries[0]["seed_range"] == [0, 1]
    assert entries[0]["device"] == "cpu" and len(entries[0]["semantics"]) == 16
    # the next soak continues above the recorded seeds
    cli.testbench_main(["--soak", "--trials", "1", "--device", "cpu",
                        "--max-a", "2000", "--tally", str(tally)])
    with open(tally) as f:
        assert json.load(f)["entries"][1]["seed_range"] == [2, 3]


def test_plot_results_main_writes_its_png(tmp_path):
    f = tmp_path / "BLER_vs_SNR_x.txt"
    f.write_text("0.000000\t5.000000e-01\n# capped 1/3 errors\n1.000000\t1.000000e-01\n")
    out = tmp_path / "o" / "overlay.png"
    cli.plot_results_main([str(f), "--out", str(out), "--vline", "0.5:threshold"])
    assert _read(out).startswith(b"\x89PNG")


def test_the_bench_command_exists_and_refuses_unknown_flags():
    """``ldpc-torch-bench`` exists (``cli.bench_main``, the console command
    in pyproject.toml), and it, like the testbench, refuses an unknown flag."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml")) as f:
        assert 'ldpc-torch-bench = "ldpc_3gpp_tpu_torch.cli:bench_main"' in f.read()
    for main in (cli.bench_main, cli.testbench_main):
        with pytest.raises(SystemExit):
            main(["--unknown-flag"])
