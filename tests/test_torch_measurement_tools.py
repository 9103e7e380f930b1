"""The port's measurement tools on the CPU (``ldpc_3gpp_tpu_torch/tools/``:
``roofline``, ``profile_stages``, ``profile_sim``, ``exp_bench_scan``,
``exp_batch_collapse``, ``exp_fused_share``, ``exp_rng_floor``).

The roofline's work per sweep equals the JAX tool's ``op_counts`` arithmetic
less the per-row scalings the port shares over a row's lanes; ``kernel_bound``
counts a hand-made result's bytes and operations as counted by hand; and each
tool's ``main`` runs with ``--device cpu`` at a tiny size and prints the JAX
tool's row names (or, where the port's row differs, names it in
``jax_name``).  The JAX side is imported for ``op_counts`` only: nothing of
it is compiled."""
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.tools import (
    exp_batch_collapse, exp_bench_scan, exp_fused_share, exp_rng_floor, profile_sim,
    profile_stages, roofline,
)
from ldpc_3gpp_tpu_torch.utils.profiling import loop_times, slope_time, time_ms

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX tools' row names
JAX_ROOFLINE_ROWS = ("BG1 Z=384 layered NMS 12it (bench)", "BG1 Z=384 flooding NMS 12it",
                     "BG2 Z=208 layered NMS 8it")  # tools/roofline.py:139-147
JAX_STAGES = ("crc_attach", "encode_rolls", "modulate", "awgn+demod", "split_rate_matched",
              "decode_pallas_12", "decode_fast_12")  # tools/profile_stages.py:66-86
JAX_SIM_ROWS = ("simulate_batch esn0=1", "simulate_batch esn0=6", "bernoulli info bits",
                "normal noise", "decode ET esn0=1", "decode ET esn0=6")  # profile_sim.py:45-99
JAX_COLLAPSE = {"full": ("full",), "stages": ("kernel", "tbdec", "front")}  # :64-182
JAX_FUSED = ("floor", "a-only", "a+enc+mod", "full-12it", "nodec", "dec-1it", "front",
             "front+split", "front-nonoise")  # tools/exp_fused_share.py:129-139
JAX_RNG = ("floor", "key-ops", "bern-1call", "bern-bits", "bern-3calls",
           "noise-only")  # tools/exp_rng_floor.py:80-87


def _jax_roofline():
    tools = os.path.join(ROOT, "tools")
    sys.path.insert(0, tools)  # its checkout shim, tools/_path.py
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tool_roofline", os.path.join(tools, "roofline.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(tools)
    return module


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


@pytest.mark.parametrize("row", roofline.ROWS, ids=[r[0] for r in roofline.ROWS])
def test_work_per_sweep_is_the_jax_op_count_less_the_row_scalings(row):
    name, fields, _, _, schedule = row
    arith, _, _ = _jax_roofline().op_counts(JParams(**fields), schedule)
    p = LDPCParams(**fields)
    Z = p.Z_c
    amortised = 2 * p.num_rows * Z + (2 * p.num_cols * Z if schedule == "flooding" else 0)
    assert roofline.update_ops_per_sweep(p) == arith - amortised
    assert roofline.update_ops_per_sweep(p, "sum-product") == (
        len(p.edges[0]) * Z * (2 * 65 + 13))


def test_the_rows_are_the_jax_tools():
    assert tuple(r[0] for r in roofline.ROWS) == JAX_ROOFLINE_ROWS
    assert roofline.BATCH == 512
    assert [r[2:] for r in roofline.ROWS] == [(12, 1.0, "layered"), (12, 1.0, "flooding"),
                                              (8, 0.75, "layered")]


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_kernel_bound_counts_a_hand_made_result(schedule):
    """Two codewords, budget 5: one passed at sweep 2, one never passed."""
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    Z, E, nc = p.Z_c, len(p.edges[0]), p.num_cols
    res = SimpleNamespace(iterations=torch.tensor([2, 5], dtype=torch.int32),
                          parity_ok=torch.tensor([True, False]))
    b = roofline.kernel_bound(p, res, 5, nc - 2, p.num_sys_cols, schedule=schedule,
                              shape=dict(layout=1))
    nbytes = 2 * ((nc - 2) * Z * 4 + p.num_sys_cols * Z + 8)
    if schedule == "layered":
        updates, syndromes = 3 + 5, 0 + 1  # it + 1 sweeps after passing at it
    else:
        updates, syndromes = 2 + 5, 3 + 6  # it sweeps, it + 1 syndrome passes
    ops = E * Z * (12 * updates + syndromes)
    assert (b["bytes"], b["operations"]) == (nbytes, ops)
    assert b["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert b["operations_ms"] == pytest.approx(ops / 67e12 * 1e3)
    assert b["bound_ms"] == max(b["bytes_ms"], b["operations_ms"])
    assert b["bound_by"] == ("bytes" if b["bytes_ms"] >= b["operations_ms"] else "operations")
    assert b["mean_sweeps"] == updates / 2


def test_roofline_main_on_the_cpu(capsys):
    rows = roofline.main(["--device", "cpu", "--batch", "2", "--reps", "1"])
    lines = _lines(capsys)
    assert "peaks" in lines[0]
    assert [r["name"] for r in lines[1:]] == list(JAX_ROOFLINE_ROWS)
    for r in rows:
        assert r["share_of_bound"] is None and r["measured_rate_ms"] is None  # no device time
        assert r["bound_ms"] > 0 and r["bound_by"] == "operations"
        assert r["operations_per_codeword"] == pytest.approx(
            r["update_operations_per_sweep_per_codeword"] * r["mean_sweeps"], rel=0.2)
        assert r["launches"] == {"ldpc_layered": 0, "ldpc_flooding": 0}
    assert rows[2]["codewords"] == 4  # BG2 A=3842: two code blocks per transport block


@pytest.fixture
def short_slope(monkeypatch):
    """The tools' slope at 1 and 2 calls, once: a CPU run checks the rows,
    not the times."""
    def fast(f, x, **kw):
        return slope_time(f, x, k_lo=1, k_hi=2, reps=1)

    for module in (profile_stages, profile_sim):
        monkeypatch.setattr(module, "slope_time", fast)


def test_profile_stages_main_on_the_cpu(short_slope, capsys):
    profile_stages.main(["--device", "cpu", "--batch", "2"])
    lines = _lines(capsys)
    names = [r.get("jax_name", r["name"]) for r in lines]
    assert names == [*JAX_STAGES[:2], "encode_mxu", *JAX_STAGES[2:]]
    assert all(r["timed_by"] == "host clock" for r in lines)


def test_profile_sim_main_on_the_cpu(short_slope, capsys):
    profile_sim.main(["--device", "cpu", "--batch", "2"])
    lines = _lines(capsys)
    assert [r.get("jax_name", r["name"]) for r in lines] == list(JAX_SIM_ROWS)
    assert all(r["device_busy_ms"] == "not measured (CPU)" for r in lines)


def test_exp_bench_scan_main_on_the_cpu(capsys):
    rows = exp_bench_scan.main(["2:1", "96:1", "--trials", "1", "--reps", "1",
                                "--device", "cpu"])
    assert [r["pair"] for r in rows] == ["2:1", "96:1"]
    assert [r["batch_simulated"] for r in rows] == [2, 128]  # MonteCarlo's rounding
    assert [r["blocks"] for r in rows] == [2, 128]
    assert exp_bench_scan.PAIRS == ((128, 1024), (256, 512), (384, 256), (512, 256), (1024, 2))
    assert len(_lines(capsys)) == 2


@pytest.mark.parametrize("phase", ["full", "stages"])
def test_exp_batch_collapse_main_on_the_cpu(phase, capsys):
    rows = exp_batch_collapse.main([phase, "2", "--steps", "1", "--reps", "1",
                                    "--device", "cpu"])
    assert tuple(r["name"] for r in rows) == JAX_COLLAPSE[phase]
    assert all(r["batch"] == r["batch_simulated"] == 2 for r in rows)
    assert len(_lines(capsys)) == len(rows)
    assert exp_batch_collapse.BATCHES == (64, 96, 128, 160, 192)


def test_exp_fused_share_main_on_the_cpu(capsys):
    out = exp_fused_share.main(["2", "--steps", "1", "--device", "cpu"])
    lines = _lines(capsys)
    assert tuple(r["name"] for r in lines[:-1]) == JAX_FUSED
    assert tuple(out["programs"]) == JAX_FUSED
    assert "decode_share_of_step" in lines[-1]


def test_fused_share_nodec_keeps_the_crc_gates():
    """The hard decision in place of the decode, at BG2 A=3842 (two code
    blocks, fillers): all-zero blocks of confident LLRs pass; a flipped
    payload bit fails its block (both CRCs); a flipped code-block CRC bit
    fails its block by the code-block gate alone; a flipped parity bit does
    not matter."""
    p = LDPCParams(BG=2, A=3842, G=11526, Q_m=2)
    assert p.C == 2 and p.K_prime < p.K
    d = torch.full((4, p.C, p.N), 10.0)
    assert int(exp_fused_share.hard_decision_errors(p, d)) == 0
    payload = p.K_prime - p.cb_crc_len - 2 * p.Z_c  # first CB CRC bit, in d's columns
    d[1, 0, 0] = -10.0
    d[2, 1, payload] = -10.0
    d[3, 0, p.N - 1] = -10.0
    assert int(exp_fused_share.hard_decision_errors(p, d)) == 2


def test_exp_rng_floor_main_on_the_cpu(capsys):
    rows = exp_rng_floor.main(["--batch", "2", "--steps", "1", "--device", "cpu"])
    assert tuple(r["jax_name"] for r in rows) == JAX_RNG
    assert [r["name"] for r in rows] == ["floor", "generator-state", "info-bits-int8",
                                         "raw-bits-uint8", "info-bits-3-sizes", "noise-complex"]
    assert len(_lines(capsys)) == 6


def test_profiling_helpers_on_the_cpu():
    calls = []

    def step(tag):
        def run():
            calls.append(tag)
            return torch.ones(3)
        return run

    got = loop_times({"a": step("a"), "b": step("b")}, steps=2, calls=3, reps=2,
                     device="cpu")
    assert set(got) == {"a", "b"} and all(t > 0 for t in got.values())
    # a warm-up call of each, then the two in turns, a repetition at a time
    assert calls == ["a"] * 2 + ["b"] * 2 + (["a"] * 6 + ["b"] * 6) * 2
    n = len(calls)
    assert time_ms(lambda: calls.append(1), reps=4, warmup=1, device="cpu") >= 0
    assert len(calls) == n + 5
