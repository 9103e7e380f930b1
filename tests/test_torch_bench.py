"""The port's benchmark module (``ldpc_3gpp_tpu_torch/bench.py``) on the CPU.

Its constants, flagship configuration and sweep rows equal the JAX
package's field by field (``ldpc_3gpp_tpu.bench`` is imported, nothing of it
is compiled); ``measure_throughput`` counts exactly what ``MonteCarlo``
counts on the same seed; the headline line has the JAX line's keys; the
scalar baseline decodes through the port's C++ oracle; and the port's doc
guard (``tools/regen_goldens.py::doc_consistency``) passes on the repository
and catches a drift."""
import dataclasses

import pytest
import torch

from ldpc_3gpp_tpu import bench as jax_bench
from ldpc_3gpp_tpu_torch import bench
from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.tools import regen_goldens
from ldpc_3gpp_tpu_torch.utils.rng import make_generator

torch.set_num_threads(1)

# The keys of the JAX headline line (ldpc_3gpp_tpu/bench.py:193-224)
JAX_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_measured_scalar_cpu", "detail"}
JAX_DETAIL_KEYS = {"scalar_cpu_codewords_per_sec", "config", "esn0_db",
                   "transport_blocks_per_sec", "mean_iterations_per_tb", "block_errors",
                   "blocks", "backend", "et_economics"}

SMALL = ChainConfig(params=LDPCParams(BG=2, A=100, G=300, Q_m=2), iterations=4,
                    algorithm="min-sum", schedule="layered")


def assert_config_equal(mine, theirs):
    """Every field of the JAX ChainConfig and of its LDPCParams equal; the
    port's own knob ``codewords_per_block`` at its automatic 0."""
    for f in dataclasses.fields(theirs):
        if f.name == "params":
            for g in dataclasses.fields(theirs.params):
                assert getattr(mine.params, g.name) == getattr(theirs.params, g.name), g.name
        else:
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.codewords_per_block == 0


def test_constants_and_the_flagship_equal_the_jax_package():
    assert bench.FLAGSHIP == jax_bench.FLAGSHIP
    assert bench.MATLAB_CODEWORDS_PER_SEC_EST == jax_bench.MATLAB_CODEWORDS_PER_SEC_EST
    assert_config_equal(bench._flagship_config(), jax_bench._flagship_config())
    for kw in (dict(iterations=4), dict(schedule="flooding", algorithm="sum-product")):
        assert_config_equal(bench._flagship_config(**kw), jax_bench._flagship_config(**kw))


def test_sweep_rows_equal_the_jax_package():
    mine, theirs = bench.sweep_rows(), jax_bench.sweep_rows()
    assert [r["name"] for r in mine] == [r["name"] for r in theirs]
    assert len(mine) == 16
    for m, t in zip(mine, theirs):
        assert set(m) == set(t)
        for key in ("name", "esn0", "batch", "steps"):
            assert m[key] == t[key], (m["name"], key)
        assert_config_equal(m["cfg"], t["cfg"])


def test_measure_throughput_counts_what_montecarlo_counts():
    """A warm-up call, then one trial of one call, on the seed-0 stream:
    the same blocks, errors and iterations as MonteCarlo's own calls."""
    tb_per_sec, mean_it, errors, blocks = bench.measure_throughput(
        SMALL, 1.0, batch=4, steps=2, trials=1, reps=1, device="cpu")
    mc = MonteCarlo(SMALL, batch_per_device=4, steps_per_call=2, device="cpu")
    generator = make_generator(0, "cpu")
    mc.run(generator, 1.0)
    c = mc.run_pipelined(generator, 1.0, calls=1)
    assert (blocks, errors) == (c["blocks"], c["block_errors"]) == (8, c["block_errors"])
    assert mean_it == c["iterations"] / c["blocks"]
    assert tb_per_sec > 0
    d = bench.measure_throughput_detail(SMALL, 1.0, batch=4, steps=2, trials=2, reps=3,
                                        device="cpu")
    assert d["blocks"] == 2 * 3 * 8 and len(d["trials_tb_per_sec"]) == 2
    assert d["tb_per_sec"] == max(d["trials_tb_per_sec"])
    assert d["launches"] == {"ldpc_layered": 0, "ldpc_flooding": 0}  # plain versions


def test_measure_throughput_reports_the_rounded_batch():
    with pytest.warns(UserWarning, match="rounded up"):
        d = bench.measure_throughput_detail(SMALL, 4.0, batch=96, steps=1, trials=1, reps=1,
                                            device="cpu")
    assert d["batch"] == 128 and d["blocks"] == 128


def test_headline_line_has_the_jax_keys(capsys):
    line = bench._headline(device="cpu", batch=2, steps=1, trials=1, reps=1,
                           scalar_seconds=0.01)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed.startswith('{"metric"')
    assert set(line) == JAX_LINE_KEYS
    assert JAX_DETAIL_KEYS <= set(line["detail"])
    d = line["detail"]
    assert d["backend"].startswith("the host CPU") and d["blocks"] == 2
    assert d["cut"] == {"batch": 2, "steps": 1, "trials": 1, "reps": 1, "scalar_seconds": 0.01}
    assert set(d["scalar_cpu_codewords_per_sec"]) == {"min-sum", "sum-product"}
    assert line["metric"] == "decoded_info_mbps_per_chip" and line["unit"] == "Mbit/s"
    assert d["et_economics"] == "golden_torch/bench_sweep.json"


def test_measure_scalar_cpu_runs_both_algorithms_through_the_port_oracle():
    rates = bench.measure_scalar_cpu(200, 600, 2, 1.0, 12, min_seconds=0.02)
    assert set(rates) == {"min-sum", "sum-product"}
    assert all(r > 0 for r in rates.values())


def test_run_sweep_rows_carry_the_jax_golden_keys(capsys):
    (row,) = bench.run_sweep(trials=1, reps=1, device="cpu", steps=1,
                             names=["bg2_z72_packed_layered"])
    assert set(row) == set(bench.ROW_KEYS) | {"seen"}
    assert (row["A"], row["Z"], row["BG"], row["blocks"]) == (600, 72, 2, 512)
    assert row["seen"]["codewords_per_block"] == 1  # the rule packs no Z=72 launch
    assert '"name": "bg2_z72_packed_layered"' in capsys.readouterr().out


def test_doc_consistency_passes_on_the_repository():
    problems = regen_goldens.doc_consistency()
    assert not problems, "\n".join(problems)


def test_doc_consistency_catches_drift(tmp_path):
    """A stale "<batch>x<steps>" on a line about the headline is flagged,
    a 'historical' one is not, a doc that never states the protocol is."""
    proto = f"{bench.HEADLINE_BATCH}x{bench.HEADLINE_STEPS}"
    stale = f"{bench.HEADLINE_BATCH}x{bench.HEADLINE_STEPS + 1}"
    (tmp_path / "README.md").write_text(
        f"# x\nthe JAX headline {stale}\n## The PyTorch/CUDA port (`x`)\n"
        f"the headline runs {stale} calls\nthe headline {proto}\n")
    (tmp_path / "PERF.md").write_text(f"the headline was {stale} (historical)\n")
    skill = tmp_path / ".claude" / "skills" / "verify"
    skill.mkdir(parents=True)
    (skill / "SKILL.md").write_text(f"## The PyTorch/CUDA port\nthe headline is {proto}\n")
    problems = regen_goldens.doc_consistency(root=str(tmp_path))
    assert len(problems) == 2, problems
    assert any(p.startswith("README.md:4:") for p in problems)  # not line 2: before the port
    assert any(p.startswith("PERF.md: never states") for p in problems)


def test_regeneration_refuses_stale_docs(tmp_path, monkeypatch):
    monkeypatch.setattr(regen_goldens, "doc_consistency", lambda: ["PERF.md:1: stale"])
    with pytest.raises(SystemExit, match="doc/protocol drift"):
        regen_goldens.main(["config1", "--device", "cpu", "--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
