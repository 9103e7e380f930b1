"""The port's experiment tools on the CPU (``ldpc_3gpp_tpu_torch/tools/``:
``exp_alpha``, ``exp_alpha_schedule``, ``exp_bf16``, ``exp_kernel_tiles``).

Each tool's ``main`` runs with ``--device cpu`` at a few codewords (its
sizes cut through the module constants the tool reads) and prints the
JAX tool's row names (or, where the port's row differs, names it in
``jax_name``) and values; the shapes that do not fit a block at Z=384 print
``fits: false``; ``exp_kernel_tiles`` names the rules' launch as
``decoder_cuda.launch_shape`` does; the gate's sigma is the JAX tool's and
its blocks come from ``simulate_batch``.  One JAX anchor: the same LLRs
through the port's alpha and ``alpha_schedule`` rows and through the JAX
package's XLA layered decoder (``ops/decoder_layered.py``, one compile),
iterations per codeword and block errors at tolerance 0."""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import decoder_layered as j_layered
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch.models.chain import ChainConfig, simulate_batch
from ldpc_3gpp_tpu_torch.ops import decoder_cuda
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.tools import exp_alpha, exp_alpha_schedule, exp_bf16, exp_kernel_tiles
from ldpc_3gpp_tpu_torch.utils.rng import make_generator

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--reps", "1"]
ONE = CPU + ["--batch", "1"]
Z20 = dict(BG=2, A=100, G=300, Q_m=2)

# The JAX tools' rows
JAX_ALPHAS = (0.70, 0.75, 0.8125, 0.875, 0.9375, 1.0)  # tools/exp_alpha.py:53
JAX_CANDIDATES = [(a0, n0) for n0 in (1, 2, 3)
                  for a0 in (0.55, 0.6, 0.65, 0.7, 0.75)]  # exp_alpha_schedule.py:85-87
JAX_BF16 = [(s, d) for s in ("layered", "flooding")
            for d in ("float32", "bfloat16")]  # tools/exp_bf16.py:55-56
JAX_TILE_SCHEDULES = ("layered", "flooding")  # tools/exp_kernel_tiles.py:27


@pytest.fixture
def short_slope(monkeypatch):
    """Time each row by the slope between 2 and 3 chained decodes."""
    monkeypatch.setattr(exp_alpha, "CALLS", 3)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_alpha_main_on_the_cpu(capsys, short_slope):
    rows = exp_alpha.main(ONE)
    lines = _lines(capsys)
    assert exp_alpha.ALPHAS == JAX_ALPHAS
    assert [r["name"] for r in lines] == [f"alpha={a:6.4f}" for a in JAX_ALPHAS]
    assert [r["alpha"] for r in lines] == list(JAX_ALPHAS)
    for line, row in zip(lines, rows):
        assert "result" not in line and line["device"].startswith("the host CPU")
        assert line["esn0_db"] == 1.0 and line["codewords"] == 1
        assert line["block_errors"] == 0 and 1 <= line["mean_iterations"] <= 12
        assert line["mean_iterations"] == float(row["result"].iterations[0])
    assert (exp_alpha.BATCH, exp_alpha.ESN0_DB, exp_alpha.DECODE_KW) == (
        2048, 1.0, dict(iterations=12, algorithm="min-sum", schedule="layered"))


def test_cw_llrs_are_the_jax_tools_codewords():
    """Info bits from numpy's default_rng(0), fillers 0, the whole codeword
    encoded (its first K bits the info bits), float32 LLRs of its length."""
    p = LDPCParams(**Z20)
    cw, llr = exp_alpha.cw_llrs(p, 3, 1.0, 7, "cpu")
    c = np.random.default_rng(0).integers(0, 2, size=(3, p.K)).astype(np.uint8)
    c[:, p.K_prime:] = 0
    assert np.array_equal(cw[:, :p.K].numpy(), c.astype(np.int8))
    assert cw.shape == llr.shape == (3, p.num_cols * p.Z_c) and llr.dtype == torch.float32
    again = exp_alpha.cw_llrs(p, 3, 1.0, 7, "cpu")[1]
    assert torch.equal(llr, again)


def test_alpha_schedule_main_on_the_cpu(capsys, monkeypatch, short_slope):
    """One candidate, the gate cut to one block per point."""
    monkeypatch.setattr(exp_alpha_schedule, "CANDIDATES", ((0.65, 2),))
    monkeypatch.setattr(exp_alpha_schedule, "MAX_GATE_BLOCKS", 1)
    out = exp_alpha_schedule.main(ONE)
    lines = _lines(capsys)
    assert [r["name"] for r in lines[:2]] == ["baseline", "sched=(0.65, 2)"]
    assert lines[0]["alpha_schedule"] is None and lines[1]["alpha_schedule"] == [0.65, 2]
    gates = lines[2:]
    assert gates[0]["name"] == "GATE baseline"
    assert [g["name"] for g in gates[1:]] in ([], ["GATE sched=(0.65, 2)"])
    assert len(out["gates"]) == len(gates)
    for g in gates:
        assert [(q["esn0_db"], q["blocks"]) for q in g["points"]] == [(-0.75, 1), (-0.5, 1)]


def test_the_grid_and_the_gate_points_are_the_jax_tools():
    assert list(exp_alpha_schedule.CANDIDATES) == JAX_CANDIDATES
    assert (exp_alpha_schedule.GATED, exp_alpha_schedule.MAX_GATE_BLOCKS,
            exp_alpha_schedule.SCREEN_ESN0_DB) == (3, 1 << 18, 1.0)
    with open(os.path.join(ROOT, "golden", "bench_path_bler.json")) as f:
        golden = json.load(f)["QPSK_R13"]
    for esn0_db, errors, blocks, _ in exp_alpha_schedule.GATE_POINTS:
        i = golden["esn0_db"].index(esn0_db)
        assert (golden["block_errors"][i], golden["blocks"][i]) == (errors, blocks)
        assert errors / blocks == golden["bler"][i]  # the JAX tool's literal rates
    assert [pt[3] for pt in exp_alpha_schedule.GATE_POINTS] == [11, 13]  # the JAX keys


@pytest.mark.parametrize("g_bler,blocks,g_blocks", [
    (0.26318359375, 2048, 2048), (0.0006018350290697674, 100352, 264192), (0.5, 3, 7)])
def test_gate_sigma_is_the_jax_formula(g_bler, blocks, g_blocks):
    jax_sig = float(np.sqrt(g_bler * (1 - g_bler) / blocks
                            + g_bler * (1 - g_bler) / g_blocks))  # exp_alpha_schedule.py:113-114
    assert exp_alpha_schedule.gate_sigma(g_bler, blocks, g_blocks) == pytest.approx(
        jax_sig, rel=1e-15)


def test_the_gate_takes_the_baseline_and_the_three_fastest_that_beat_it():
    rows = [dict(name="baseline", us_per_codeword=1.0)] + [
        dict(name=f"c{i}", us_per_codeword=t) for i, t in enumerate((1.5, 0.9, 0.7, 1.0, 0.8, 0.95))]
    assert [r["name"] for r in exp_alpha_schedule.to_gate(rows)] == ["baseline", "c2", "c4", "c1"]
    assert [r["name"] for r in exp_alpha_schedule.to_gate(rows[:2])] == ["baseline"]


def test_the_gate_runs_simulate_batch_at_a_tiny_batch():
    """``need`` = min(max(int(60 / 0.5), 4), 10) = 10 blocks: three steps of
    4 on one generator, the same blocks as those steps made directly."""
    cfg = ChainConfig(params=LDPCParams(**Z20), iterations=12, algorithm="min-sum",
                      schedule="layered", alpha_schedule=(0.65, 2))
    point = exp_alpha_schedule.gate_point(cfg, 0.5, 50, 100, 5, 4, "cpu", max_blocks=10)
    g = make_generator(5, "cpu")
    errors = sum(int(simulate_batch(cfg, g, 0.5, 4, device="cpu").block_errors)
                 for _ in range(3))
    assert (point["blocks"], point["block_errors"]) == (12, errors)
    sigma = math.sqrt(0.25 / 12 + 0.25 / 100)
    assert point["sigma"] == pytest.approx(sigma)
    assert point["z"] == pytest.approx((errors / 12 - 0.5) / sigma)
    row = exp_alpha_schedule.gate_row(
        cfg, dict(name="baseline", alpha_schedule=None, us_per_codeword=1.0), 4, "cpu",
        points=((0.5, 50, 100, 5),), max_blocks=4)
    assert row["name"] == "GATE baseline" and row["points"][0]["blocks"] == 4


def test_bf16_main_on_the_cpu(capsys, short_slope):
    exp_bf16.main(ONE)
    lines = _lines(capsys)
    want = [f"{s} {d} P={P}" for s, d in JAX_BF16[:2] for P in (1, 2, 4)] + [
        f"{s} {d} threads={T}" for s, d in JAX_BF16[2:] for T in (512, 1024)]
    assert [r["name"] for r in lines] == want
    assert [r["jax_name"] for r in lines] == [
        f"{s} {d}" for s, d in JAX_BF16[:2] for _ in range(3)] + [
        f"{s} {d}" for s, d in JAX_BF16[2:] for _ in range(2)]
    for r in lines:
        fits = not (r["schedule"] == "layered" and not r["name"].endswith("P=1"))
        assert r["fits"] == fits
        if fits:
            assert r["block_errors"] == 0 and r["parity_failures"] == 0
            assert r["launch"]["threads"] == (384 if r["schedule"] == "layered"
                                              else int(r["name"].rsplit("=", 1)[1]))
        else:  # the JAX tool's FAILED rows: P codewords of Z=384 exceed a block
            assert "does not fit one block at Z=384" in r["error"] and "mean_iterations" not in r


def test_bf16_catches_only_the_shapes_that_do_not_fit(monkeypatch):
    """A ValueError of the decode itself propagates."""
    p = LDPCParams(**Z20)
    cw, llr = exp_alpha.cw_llrs(p, 2, 1.0, 7, "cpu")

    def fails(*args, **kw):
        raise ValueError("kernel limits exceeded")

    monkeypatch.setattr(decoder_cuda, "decode", fails)
    with pytest.raises(ValueError, match="kernel limits"):
        exp_bf16.bf16_rows(p, llr, cw, reps=1)


def test_kernel_tiles_main_on_the_cpu(capsys, monkeypatch):
    """Both cases cut to a few codewords (config #1's at 6 dB, where its
    LLRs converge in a few sweeps), with one alternative each beside the
    rules' launch at those sizes."""
    (f, _, f_kw, _, _), (c, _, c_kw, _, _) = exp_kernel_tiles.CASES
    monkeypatch.setattr(exp_kernel_tiles, "CASES", (
        (f, 1, f_kw, (1, 2), ()), (c, 64, c_kw, (4,), (256,))))
    monkeypatch.setattr(exp_kernel_tiles, "CONFIG1_ESN0_DB", 6.0)
    rows = exp_kernel_tiles.main(CPU)
    lines = _lines(capsys)
    assert [r["name"] for r in lines] == [
        "flagship layered P=1", "flagship layered P=2", "flagship flooding threads=1024",
        "config #1 layered P=1", "config #1 layered P=4",
        "config #1 flooding threads=1024", "config #1 flooding threads=256"]
    assert [r["codewords"] for r in lines] == [1] * 3 + [64] * 4
    assert {r["jax_name"] for r in lines} == {f"{s} Bt" for s in JAX_TILE_SCHEDULES} | {None}
    assert lines[1]["fits"] is False and "does not fit" in lines[1]["error"]
    fitting = [r for r in rows if r["fits"]]
    assert all(r["equal_to_the_rule"] for r in fitting)
    assert [r["rule_choice"] for r in fitting] == [True, True, True, False, True, False]
    params = {"flagship": exp_alpha.flagship_params(),
              "config #1": LDPCParams(**exp_kernel_tiles.CONFIG1_FIELDS)}
    for r in fitting:
        rule = decoder_cuda.launch_shape(params[r["case"]], r["codewords"], r["schedule"], 0, 132)
        assert (r["launch"] == rule) == r["rule_choice"]
    assert fitting[0]["mean_sweeps"] == 12  # 2 N(0,1) + 1 at Z=384: no codeword converges


def test_kernel_tiles_cases():
    (f, fn, f_kw, f_ps, f_threads), (c, cn, c_kw, c_ps, c_threads) = exp_kernel_tiles.CASES
    assert (f, fn, f_kw, f_ps, f_threads) == (
        "flagship", 512, dict(algorithm="min-sum", iterations=12), (1, 2, 4, 8), (512, 1024))
    assert (c, cn, c_ps, c_threads) == ("config #1", 2048, (1, 2, 4, 8, 16),
                                        (64, 128, 256, 512, 1024))
    assert c_kw == dict(channel_format="d", output_format="sys", algorithm="min-sum",
                        iterations=50)
    assert exp_kernel_tiles.CONFIG1_FIELDS == dict(BG=2, A=100, G=200, Q_m=2)
    assert exp_kernel_tiles.CONFIG1_ESN0_DB == 2.0


def test_kernel_tiles_names_the_rules_launch():
    """At config #1's code and its 2,048 codewords (LLRs that converge at
    once, so the plain decodes are quick): layered P in 1..16 all fit and
    the rule picks the warp form, P=16 at 512 threads; flooding 128
    threads, layout 1 -- both as ``launch_shape`` says."""
    p = LDPCParams(**exp_kernel_tiles.CONFIG1_FIELDS)
    for P in exp_kernel_tiles.CASES[1][3]:
        assert decoder_cuda.resolve_codewords_per_block(p, 2048, "layered", P) == P
    _, llr = exp_alpha.cw_llrs(p, 2048, 6.0, 7, "cpu")
    rows = exp_kernel_tiles.case_rows("config #1", p, llr, dict(algorithm="min-sum", iterations=12),
                                      (), (), reps=1)
    assert [r["name"] for r in rows] == ["config #1 layered P=16",
                                         "config #1 flooding threads=128"]
    assert all(r["fits"] and r["equal_to_the_rule"] for r in rows)
    rules = [r for r in rows if r["rule_choice"]]
    assert [r["name"] for r in rules] == ["config #1 layered P=16",
                                          "config #1 flooding threads=128"]
    for r in rules:
        assert r["launch"] == decoder_cuda.launch_shape(p, 2048, r["schedule"], 0, 132)
    # the warp form: sixteen warps of one codeword, one block per SM
    assert rules[0]["launch"] == dict(codewords_per_block=16, threads=512, layout=1)
    assert rules[1]["launch"] == dict(codewords_per_block=1, threads=128, layout=1)
    flagship = exp_alpha.flagship_params()
    assert decoder_cuda.launch_shape(flagship, 512, "flooding", 0, 132) == dict(
        codewords_per_block=1, threads=1024, layout=3)


def test_alpha_rows_equal_the_jax_layered_decoder(short_slope):
    """The anchor: numpy-seeded 'cw' LLRs at BG2 Z=20, -4 dB (iterations
    from 4 to the budget, block errors) through ``alpha_rows`` at 0.75 and
    the schedule screen at (0.65, 2), and through the JAX package's XLA
    layered decoder; per-codeword iterations and block errors equal.  One
    JAX compile: alpha0, n0 and alpha are traced arguments, and alpha 0.75
    is the schedule (0.75, 0), whose alpha0 applies on no sweep."""
    p = LDPCParams(**Z20)
    cw, llr = exp_alpha.cw_llrs(p, 32, -4.0, 7, "cpu")
    (alpha,) = exp_alpha.alpha_rows(p, llr, cw, alphas=(0.75,), reps=1)
    _, sched = exp_alpha_schedule.screen(p, llr, cw, ((0.65, 2),), reps=1)
    pj = JParams(**Z20)
    j_decode = jax.jit(lambda x, a0, n0, a: j_layered.decode(
        pj, x, iterations=12, algorithm="min-sum", alpha=a, alpha_schedule=(a0, n0)))
    cw_np = cw.numpy()
    for row, (a0, n0, a) in ((alpha, (0.75, 0, 0.75)), (sched, (0.65, 2, 0.8125))):
        rj = j_decode(jnp.asarray(llr.numpy()), a0, n0, a)
        assert np.array_equal(row["result"].iterations.numpy(), np.asarray(rj.iterations))
        jax_errors = int((np.asarray(rj.bits).astype(np.int8) != cw_np).any(axis=-1).sum())
        assert row["block_errors"] == jax_errors
        assert 0 < jax_errors < 32
        assert row["mean_iterations"] == float(np.asarray(rj.iterations).mean())
