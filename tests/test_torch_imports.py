"""The port stands alone: it imports ``torch`` and numpy, never ``jax`` and
nothing of the JAX package, and its entry points do not fall back to the CPU."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import ldpc_3gpp_tpu_torch
from ldpc_3gpp_tpu_torch import api, bench, cli, entry
from ldpc_3gpp_tpu_torch.models import chain as t_chain
from ldpc_3gpp_tpu_torch.models import decoder as t_dec
from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.tools import (
    bulk_montecarlo, demod_compare, density_evolution, exp_alpha, exp_alpha_schedule,
    exp_batch_collapse, exp_bench_scan, exp_bf16, exp_fused_share, exp_kernel_tiles,
    exp_rng_floor, lifting_sweep, pod_campaign, profile_sim, profile_stages, regen_goldens,
    roofline,
)
from ldpc_3gpp_tpu_torch.utils.rng import make_generator
from test_torch_distributed import group_of_one

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(ldpc_3gpp_tpu_torch.__file__)

EXPECTED_MODULES = {
    "convert", "kernels_build",
    "spec.tables", "spec.params",
    "ops.crc", "ops.encoder", "ops.rate_match", "ops.modulation", "ops.channel",
    "ops.decoder", "ops.decoder_fast", "ops.decoder_layered", "ops.decoder_cuda",
    "models.encoder", "models.decoder", "models.chain",
    "utils.rng", "utils.device", "utils.golden", "utils.plotting",
    "utils.profiling", "utils.fingerprint", "api", "cli",
    "parallel.montecarlo", "parallel.sweep", "tools.op_rates", "tools.small_z",
    "tools.flooding_shapes", "parallel.launcher", "entry", "tools.bulk_montecarlo",
    "tools.pod_campaign", "tools.lifting_sweep", "tools.na_bound",
    "tools.density_evolution", "tools.demod_compare", "tools.regen_goldens",
    "tools.regen_plots", "tools.plot_snr_vs_a_surface", "utils.artifacts",
    "bench", "tools.roofline", "tools.profile_stages", "tools.profile_sim",
    "tools.exp_bench_scan", "tools.exp_batch_collapse", "tools.exp_fused_share",
    "tools.exp_rng_floor", "tools.exp_alpha", "tools.exp_alpha_schedule", "tools.exp_bf16",
    "tools.exp_kernel_tiles",
}


def _module_names():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], "ldpc_3gpp_tpu_torch.")
    )


def test_every_module_imports_without_jax_or_the_jax_package():
    names = _module_names()
    short = {n.split(".", 1)[1] for n in names}
    assert EXPECTED_MODULES <= short, EXPECTED_MODULES - short
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'ldpc_3gpp_tpu' or m.startswith('ldpc_3gpp_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert 'torch' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, timeout=300,
        capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _python_sources():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py", "time_kernels.py")]
    for base, _, names in os.walk(PKG):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return files


def test_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import\s+(jax|ldpc_3gpp_tpu)(\s|\.|$)|from\s+(jax|ldpc_3gpp_tpu)(\s|\.))",
        re.M,
    )
    files = _python_sources()
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_spec_data_and_kernel_source_ship_with_the_package():
    assert os.path.exists(os.path.join(PKG, "spec", "base_graphs.npz"))
    for name in ("ldpc_layered.cu", "ldpc_flooding.cu", "ldpc_bp.cuh", "op_rates.cu"):
        assert os.path.exists(os.path.join(PKG, "csrc", name)), name


def test_entry_points_do_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cfg = t_chain.ChainConfig(
        params=p, iterations=4, algorithm="min-sum", schedule="layered")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_chain.simulate_batch(cfg, make_generator(0, "cpu"), 1.0, 4)
    with pytest.raises(RuntimeError, match="CUDA"):  # the default decoder too
        t_chain.simulate_batch(
            t_chain.ChainConfig(params=p), make_generator(0, "cpu"), 1.0, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_generator(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_dec.init_harq_state(p, (2,))
    r = t_chain.simulate_batch(cfg, make_generator(0, "cpu"), 1.0, 4, device="cpu")
    assert r.tb_ok.device.type == "cpu"
    # the API classes and the console commands
    kw = dict(BG=2, A=100, G=300, Q_m=2)
    for make in (lambda: api.NRLDPCEncoder(**kw), lambda: api.NRLDPCDecoder(**kw),
                 lambda: api.NRModulator("QPSK"), lambda: api.NRDemodulator("QPSK"),
                 lambda: api.AWGNChannel(1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert api.NRLDPCEncoder(**kw, device="cpu").device.type == "cpu"
    sweep = ["--A", "100", "--rate", "0.5", "--no-plot", "--results-dir"]
    for main, argv in (
        (cli.bler_sweep_main, sweep),
        (cli.snr_vs_a_main, ["--bg", "2"] + sweep),
        (cli.testbench_main, ["--trials", "1"]),
        (cli.testbench_main, ["--trials", "1", "--decode"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + ([str(tmp_path)] if argv[-1] == "--results-dir" else []))
    # the flagship entry, MonteCarlo in a process group, the campaign tools
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    with group_of_one(tmp_path):
        with pytest.raises(RuntimeError, match="CUDA"):
            MonteCarlo(cfg, batch_per_device=8)
    out = ["--out", str(tmp_path / "tool.json")]
    for main, argv in (
        (bulk_montecarlo.main, ["--blocks", "8", "--batch-per-device", "8"]),
        (pod_campaign.main, ["--only", "bg2_a100_r12_qpsk", "--scale", "1e-6"]),
        (lifting_sweep.main, ["--quick", "--batch", "2"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + out)
    assert not (tmp_path / "tool.json").exists()
    # the golden pipeline's tools (na_bound and the two plot tools touch no device)
    for main, argv in (
        (density_evolution.main, ["--configs", "reg36", "--samples", "100"] + out),
        (demod_compare.main, out),
        (regen_goldens.main, ["config1", "--out-dir", str(tmp_path / "golden_out")]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not (tmp_path / "tool.json").exists()
    assert not (tmp_path / "golden_out").exists()
    # the benchmark, the measurement and the experiment tools
    for main, argv in (
        (bench.main, []), (bench.main, ["--sweep"]), (cli.bench_main, []),
        (roofline.main, []), (profile_stages.main, []), (profile_sim.main, []),
        (exp_bench_scan.main, []), (exp_batch_collapse.main, ["stages"]),
        (exp_fused_share.main, []), (exp_rng_floor.main, []),
        (exp_alpha.main, []), (exp_alpha_schedule.main, []), (exp_bf16.main, []),
        (exp_kernel_tiles.main, []),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure_throughput(cfg, 1.0, batch=4, steps=1, trials=1, reps=1)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        timeout=300, capture_output=True, text=True,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
