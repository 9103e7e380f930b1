"""The port's benchmark (``BENCHMARK.json``, ``benchmark_torch/``) on the CPU.

Each cell runs at the CPU cut and prints every metric that ``BENCHMARK.json``
names, with its unit; each cell's configuration equals ``chip_smoke.py``'s
field for field; the benchmark's copy of the work count behind the decode
kernel's bound equals ``tools/roofline.py::kernel_bound`` on the same decode
results; the trace reader measures and names a synthetic window; the default
device raises without a card; the sample check fails on one flipped bit and
on a control that runs the timed path at another rule; the end-to-end metric
is all the trials' TBs over all their seconds; a run in a process that has
loaded JAX comes out incorrect; and the benchmark imports nothing of JAX, of the JAX package, nor the port's
modules that a later change may edit (``bench.py``, ``tools/roofline.py``,
``tools/profile_sim.py``)."""
import ast
import contextlib
import dataclasses
import glob
import json
import os
import re
import sys
import types
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

from benchmark_torch import bound, cells, checks, run, trace  # noqa: E402
from ldpc_3gpp_tpu_torch.models.chain import ChainConfig  # noqa: E402
from ldpc_3gpp_tpu_torch.ops import decoder_cuda  # noqa: E402
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams  # noqa: E402
from ldpc_3gpp_tpu_torch.tools import roofline  # noqa: E402

torch.set_num_threads(1)

CELLS = ("flagship_headline", "reference_sweep_b256", "reference_bulk_b16384",
         "snr_vs_a_a8000_b8192", "config1_bg2_a100_b524288")
CONFIG1_CELL = "config1_bg2_a100_b524288"
# the cells run in process at the CPU cut: the A=8000 cell's plain decoder at
# Z=384 and 50 sum-product sweeps (about 65 s a TB) reaches no kernel there;
# its structure is held by test_the_snr_vs_a_cell_launches_the_cluster_form,
# its path on the card by chip_smoke.py's benchmark phase
CPU_RUN_CELLS = CELLS[:3] + (CONFIG1_CELL,)


def config1_sweep_config():
    """Config #1 as chip_smoke.py's P5 sweep runs it: ``bler_vs_snr`` at 50
    iterations (``config1_config`` fixes the packed variant's 12)."""
    return dataclasses.replace(chip_smoke.config1_config(), iterations=50)


CHIP_SMOKE_CONFIGS = {"flagship_headline": chip_smoke.flagship_config,
                      "reference_sweep_b256": chip_smoke.p2_config,
                      "reference_bulk_b16384": chip_smoke.p2_config,
                      "snr_vs_a_a8000_b8192": chip_smoke.snr_vs_a_config,
                      CONFIG1_CELL: config1_sweep_config}


@contextlib.contextmanager
def port_alone():
    """The modules of JAX and of the JAX package that other test files load
    in this process out of ``sys.modules`` for the block, then back: a cell
    run here sees the modules that its own process would."""
    hidden = {m: sys.modules.pop(m) for m in list(sys.modules)
              if m.split(".")[0] in checks.JAX_MODULES}
    try:
        yield
    finally:
        sys.modules.update(hidden)


@pytest.fixture(scope="module")
def cell_runs():
    """Each of ``CPU_RUN_CELLS`` once at the CPU cut: (printed lines,
    returned record)."""
    out = {}
    for name in CPU_RUN_CELLS:
        lines = []
        with port_alone():
            record = run.run_cell(name, seed=0, device="cpu", out=lines.append)
        out[name] = (lines, record)
    return out


def test_benchmark_json_has_the_four_cells():
    bench = cells.load()
    assert cells.names() == list(CELLS)
    assert bench["paths"] == ["benchmark_torch/"]
    for w in bench["workloads"]:
        assert w["chips"] == 1
        conf = bench["configs"][w["config"]]
        assert conf["reduced"] == [] and 0 < len(conf["source"]) <= 200
        assert w["traffic"]["trials"] >= 5
    (e2e,) = bench["end_to_end_metrics"]
    assert e2e["name"] == "decoded_info_mbit_per_s" and e2e["better"] == "higher"
    assert isinstance(e2e["bound_pct"], (int, float)) and e2e["bound_pct"] > 0


@pytest.mark.parametrize("name", CPU_RUN_CELLS)
def test_each_cell_prints_every_metric_with_its_unit(cell_runs, name):
    lines, record = cell_runs[name]
    units = cells.metric_units()
    assert len(units) == 8
    for metric, unit in units.items():
        (line,) = [ln for ln in lines if ln.startswith(f"{metric}: ")]
        assert line.endswith(f" {unit}"), line
        assert metric in record and record["units"][metric] == unit
    # the device metrics are not measured on the CPU, and say so
    assert "device_idle_share: not measured (CPU) fraction" in lines
    assert record["decoded_info_mbit_per_s"] > 0 and record["mean_iterations_per_tb"] > 0
    assert lines[0] == "card: the host CPU (plain PyTorch versions, no GPU)"
    assert record["cut"] == run.CPU_CUT  # the output names the cut
    assert json.loads(lines[-1]) == record
    assert lines[-2] in ("correct: true", "correct: false")
    (checks_line,) = [ln for ln in lines if ln.startswith("checks: ")]
    checked = json.loads(checks_line[len("checks: "):])
    sample = checked["sample"]
    assert sample["ok"] and sample["tolerance"] == 0
    cfg = cells.chain_config(cells.cell(name)["configuration"])
    want = {"plain", "c++ oracle"} if cfg.schedule == "flooding" else {"plain"}
    assert checks.oracle_decodes_rule(cfg) == (cfg.schedule == "flooding")
    assert set(sample["max_abs_err"]) == want
    assert checked["imports"] == dict(forbidden=list(checks.JAX_MODULES), loaded=[], ok=True)


def test_the_bulk_cell_is_the_sweep_cell_at_campaign_traffic():
    """``reference_bulk_b16384``: the configuration and the correctness
    references of ``reference_sweep_b256``; as many codewords per step as
    the flagship, fetched after several calls; its sample the size of a
    timed step; its control a lower-precision stand-in; its bound at least
    twice the spread of its recorded runs."""
    bench = cells.load()
    bulk, sweep = cells.cell("reference_bulk_b16384"), cells.cell("reference_sweep_b256")
    assert bulk["command"] == bench["command"].replace("{cell}", bulk["name"])
    for key in ("config", "configuration", "chips"):
        assert bulk[key] == sweep[key], key
    for key in ("block_errors", "mean_iterations_per_tb"):
        assert bulk["correctness"][key] == sweep["correctness"][key], key
    traffic = bulk["traffic"]
    for c in (bulk, cells.cell("flagship_headline")):
        assert cells.chain_config(c["configuration"]).params.C * c["traffic"]["batch_per_step"] \
            == 32_768, c["name"]
    assert traffic["calls_per_fetch"] > 1 and traffic["esn0_db"] == sweep["traffic"]["esn0_db"]
    assert traffic["sample_tbs"] == traffic["batch_per_step"]
    assert traffic["oracle_tbs"] == sweep["traffic"]["oracle_tbs"]
    assert set(bulk["control"]["chain"]) <= set(run.HARNESS_FIELDS)
    runs = bulk["runs_mbit_per_s"]
    assert len(runs) >= 4 and min(runs) > 0
    assert bulk["bound_pct"] >= 200 * (max(runs) / min(runs) - 1)


def test_the_snr_vs_a_cell_launches_the_cluster_form():
    """``snr_vs_a_a8000_b8192``: BG1 A=8000 derives Z=384, one code block
    and 424 fillers, so its flooding decode runs in a cluster of 3 blocks
    (``flooding_layout``) at the timed step's launch and at the sample's,
    which decodes a whole step on the path and compares its first 256 TBs;
    its Es/N0 is the point of snr_vs_a's grid (from -2.0 dB in 0.1 dB
    steps) nearest the JAX golden's required Es/N0 at A=8000; its bound at
    least twice the spread of its recorded runs, within the metric's."""
    spec = cells.cell("snr_vs_a_a8000_b8192")
    cfg = cells.chain_config(spec["configuration"])
    p = cfg.params
    assert (p.Z_c, p.C, p.num_filler) == (384, 1, 424)
    assert decoder_cuda.flooding_layout(p) == 3
    traffic = spec["traffic"]
    for n in (traffic["batch_per_step"], traffic["sample_path_tbs"]):
        shape = decoder_cuda.launch_shape(p, n * p.C, cfg.schedule, cfg.codewords_per_block)
        assert (shape["codewords_per_block"], shape["layout"]) == (1, 3)
    assert traffic["sample_path_tbs"] == traffic["batch_per_step"] == 8192
    assert (traffic["sample_tbs"], traffic["oracle_tbs"]) == (256, 16)
    assert traffic["steps_per_call"] == 2 and traffic["calls_per_fetch"] == 2
    assert (cfg.algorithm, cfg.schedule, cfg.iterations) == ("sum-product", "flooding", 50)
    with open(os.path.join(ROOT, "golden", "SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json")) as f:
        golden = json.load(f)
    required = golden["required_esn0_db"][golden["A"].index(p.A)]
    grid = -2.0 + 0.1 * np.arange(40)
    assert traffic["esn0_db"] == pytest.approx(grid[np.argmin(abs(grid - required))])
    assert set(spec["control"]["chain"]) <= set(run.HARNESS_FIELDS)
    # the other cells' samples decode what they compare, as before
    for name in CELLS[:3]:
        assert "sample_path_tbs" not in cells.cell(name)["traffic"], name
    reference = spec["correctness"]["block_errors"]
    assert "golden" not in reference and reference["blocks"] > 0
    assert "benchmark_torch.oracle --cell snr_vs_a_a8000_b8192" in reference["measured"]
    runs = spec["runs_mbit_per_s"]
    assert len(runs) >= 4 and min(runs) > 0
    assert spec["bound_pct"] >= 200 * (max(runs) / min(runs) - 1)
    (e2e,) = cells.load()["end_to_end_metrics"]
    assert spec["bound_pct"] <= e2e["bound_pct"] and spec["bound_from"]


def test_the_config1_cell_derives_config1s_code():
    """``config1_bg2_a100_b524288``: BG2 A=100 G=200 derives Z=20, one code
    block and 84 fillers, decoded by flooding normalized min-sum at 50
    iterations, the configuration of ``bler_vs_snr`` at config #1 (its JAX
    golden's point at 2.0 dB); its references the C++ oracle's, held as
    values; its bound at least twice the spread of its recorded runs, within
    the metric's."""
    spec = cells.cell(CONFIG1_CELL)
    cfg = cells.chain_config(spec["configuration"])
    p = cfg.params
    assert (p.Z_c, p.C, p.num_filler) == (20, 1, 84)
    derived = spec["configuration"]["derived"]
    assert (derived["Z"], derived["C"], derived["fillers"]) == (20, 1, 84)
    assert (cfg.algorithm, cfg.schedule, cfg.iterations, cfg.alpha) == (
        "min-sum", "flooding", 50, 0.8125)
    assert cfg.early_termination and cfg.message_dtype == "float32"
    from ldpc_3gpp_tpu_torch.parallel.sweep import _make_config

    assert cfg == _make_config(p.A, 1 / 2, p.BG, "QPSK", (0,), 50, "min-sum")
    with open(os.path.join(ROOT, "golden", chip_smoke.CONFIG1_GOLDEN)) as f:
        golden = json.load(f)
    assert spec["traffic"]["esn0_db"] in golden["esn0_db"]
    reference = spec["correctness"]["block_errors"]
    assert "golden" not in reference and reference["blocks"] > 0
    assert f"benchmark_torch.oracle --cell {CONFIG1_CELL}" in reference["measured"]
    runs = spec["runs_mbit_per_s"]
    assert len(runs) >= 4 and min(runs) > 0
    assert spec["bound_pct"] >= 200 * (max(runs) / min(runs) - 1)
    (e2e,) = cells.load()["end_to_end_metrics"]
    assert spec["bound_pct"] <= e2e["bound_pct"] and spec["bound_from"]


def test_the_config1_cell_launches_one_codeword_per_flooding_block():
    """At the cell's batch (and its sample's path, a whole step) the
    automatic rule gives the one-codeword flooding kernel on an H100's 132
    SMs: one 128-thread block per codeword (layout 1, eight per SM),
    unpacked, never the cluster form; the sample
    compares 1,024 TBs and the oracle 64."""
    spec = cells.cell(CONFIG1_CELL)
    cfg = cells.chain_config(spec["configuration"])
    p = cfg.params
    traffic = spec["traffic"]
    assert traffic["sample_path_tbs"] == traffic["batch_per_step"] == 524_288
    assert (traffic["sample_tbs"], traffic["oracle_tbs"]) == (1024, 64)
    assert decoder_cuda.KERNEL_NAMES[cfg.schedule] == "ldpc_flooding"
    assert decoder_cuda.flooding_layout(p) == decoder_cuda.LAYOUT_ON_CHIP == 1
    for n in (traffic["batch_per_step"], traffic["sample_path_tbs"]):
        shape = decoder_cuda.launch_shape(p, n * p.C, cfg.schedule, cfg.codewords_per_block,
                                          132)
        assert shape == dict(codewords_per_block=1, threads=128, layout=1), shape
    # the elements of the step's largest tensors stay under 2**31
    assert traffic["batch_per_step"] * p.num_cols * p.Z_c < 2 ** 31
    assert set(spec["control"]["chain"]) <= set(run.HARNESS_FIELDS)


def test_the_oracle_compares_flooding_min_sum_at_config1(monkeypatch):
    """The sample's C++ oracle comparison at config #1's code: it runs for
    flooding normalized min-sum (and offset-min-sum) at the configuration's
    alpha and beta, agrees with the plain decoder bit for bit, and fails on
    one flipped bit; it is skipped where the oracle has no such rule
    (layered, bfloat16 messages, an alpha schedule)."""
    cfg = config1_sweep_config()
    assert checks.oracle_decodes_rule(cfg)
    for field, value in (("schedule", "layered"), ("message_dtype", "bfloat16"),
                         ("alpha_schedule", (0.65, 2))):
        assert not checks.oracle_decodes_rule(dataclasses.replace(cfg, **{field: value}))
    monkeypatch.setattr(checks, "_last_plain", [])
    cpu = torch.device("cpu")
    d = checks.first_step_llrs(cfg, 0, 6, 2.0, 6, cpu)
    for rule in (cfg, dataclasses.replace(cfg, algorithm="offset-min-sum", beta=0.5),
                 dataclasses.replace(cfg, alpha=0.75)):
        core = checks.oracle_decodes(rule, d)
        assert set(core) == {"plain", "c++ oracle"}
        rec = checks.compare_sample(core, "plain", checks.CORE_FIELDS)
        assert rec["ok"] and rec["tbs"] == 6, rec
    iterations = core["plain"][2]
    assert 0 < iterations.min() and iterations.max() <= cfg.iterations
    rec = checks.compare_sample(_flip(core, "plain", (2, 0, 11)), "plain", checks.CORE_FIELDS)
    assert not rec["ok"] and rec["max_abs_err"]["c++ oracle"]["bits"] == 1
    assert rec["tbs_differing"]["c++ oracle"] == 1
    rec = checks.sample_check(cfg, cfg, 0, 6, 2.0, 4, 3, cpu, n_path=6)
    assert rec["ok"] and rec["oracle_tbs"] == 3
    assert rec["tbs_differing"] == {"plain": 0, "c++ oracle": 0}


@pytest.mark.parametrize("name", ["reference_sweep_b256", CONFIG1_CELL])
def test_the_oracle_reuses_the_plain_tb_decode(monkeypatch, name):
    """``checks.plain_core_decode``: the oracle's plain side is the first
    TBs of the plain TB decode just made on the same LLRs (one code block or
    two), equal to a decode of its own; other LLRs (a sign of zero
    flipped), another rule or no plain TB decode decode afresh."""
    from ldpc_3gpp_tpu_torch.ops import decoder_fast

    cfg = cells.chain_config(cells.cell(name)["configuration"])
    cfg = dataclasses.replace(cfg, iterations=min(cfg.iterations, 8))
    cpu = torch.device("cpu")
    d = checks.first_step_llrs(cfg, 0, 6, cells.cell(name)["traffic"]["esn0_db"], 5, cpu)
    monkeypatch.setattr(checks, "_last_plain", [])
    fresh = checks.oracle_decodes(cfg, d[:3])
    checks.plain_tb_decode(cfg, d)
    plain_decodes = []
    plain = decoder_fast.decode
    monkeypatch.setattr(decoder_fast, "decode",
                        lambda *a, **k: plain_decodes.append(1) or plain(*a, **k))
    kept = checks.oracle_decodes(cfg, d[:3])
    assert plain_decodes == []
    for a, b in zip(kept["plain"] + kept["c++ oracle"], fresh["plain"] + fresh["c++ oracle"]):
        assert np.array_equal(a, b)
    cw = checks.codeword_llrs(cfg.params, d[:3])
    zero = (cw == 0).nonzero()[0].tolist()
    cw[tuple(zero)] = -0.0
    checks.plain_core_decode(cfg, cw)
    assert plain_decodes == [1]
    checks.plain_core_decode(dataclasses.replace(cfg, alpha=0.75), cw)
    assert plain_decodes == [1, 1]
    checks._last_plain.clear()
    checks.oracle_decodes(cfg, d[:3])
    assert plain_decodes == [1, 1, 1]


def test_a_reference_held_as_values_gates_as_its_file_does():
    """``block_errors`` as blocks and block errors in the cell (the C++
    oracle's measurement) goes through ``block_error_gate`` as the same
    numbers read from a golden file do."""
    file_form = cells.cell("reference_sweep_b256")["correctness"]["block_errors"]
    blocks, errors, _ = checks.golden_point(file_form)
    value_form = dict(blocks=blocks, block_errors=errors, rule=file_form["rule"],
                      measured="python3 -m benchmark_torch.oracle ...")
    assert checks.golden_point(value_form) == (blocks, errors, None)
    for run_blocks, run_errors in ((24_576, 107), (448_000, 1_489), (100_000, 5_000)):
        by_file = checks.block_error_gate(file_form, run_blocks, run_errors)
        by_value = checks.block_error_gate(value_form, run_blocks, run_errors)
        assert by_file.pop("golden") == file_form["golden"]
        assert by_value.pop("golden") == value_form["measured"]
        assert by_file == by_value
    assert not by_value["ok"]  # five times the rate is outside the bound


def test_the_sample_path_decodes_more_tbs_than_it_compares(monkeypatch):
    """``n_path``: the timed path's side decodes the first ``n_path`` TBs in
    one call, the plain side the first ``n`` of the same LLRs, and only those
    ``n`` are compared."""
    cfg = cells.chain_config(cells.cell("reference_sweep_b256")["configuration"])
    seen = []

    def tb_decode(cfg, d, backend=None):
        seen.append((backend, d.clone()))
        ok = np.ones((d.shape[0], 1), dtype=bool)
        bits = np.zeros((d.shape[0], 1), dtype=np.int8)
        if backend is None:
            bits[-1] = 1  # differs only past the compared TBs
        return bits, ok[:, 0], ok, np.zeros_like(ok, int)

    monkeypatch.setattr(checks, "tb_decode", tb_decode)
    monkeypatch.setattr(checks, "_last_plain", [])
    monkeypatch.setattr(checks, "oracle_decodes", lambda cfg, d: {
        "plain": (d.numpy(),), "c++ oracle": (d.numpy(),)})
    cpu = torch.device("cpu")
    rec = checks.sample_check(cfg, cfg, 0, 4, 1.0, 2, 1, cpu, n_path=4)
    (path_backend, path_d), (plain_backend, plain_d) = seen
    assert (path_backend, plain_backend) == (None, "fast")
    assert path_d.shape[0] == 4 and torch.equal(plain_d, path_d[:2])
    assert torch.equal(path_d, checks.first_step_llrs(cfg, 0, 4, 1.0, 4, cpu))
    assert rec["ok"] and rec["tbs"] == 2 and rec["path_tbs"] == 4
    assert rec["oracle_tbs"] == 1 and "c++ oracle" in rec["max_abs_err"]
    with pytest.raises(ValueError):
        checks.sample_check(cfg, cfg, 0, 4, 1.0, 2, 1, cpu, n_path=5)
    # no oracle TBs: no comparison with the oracle
    monkeypatch.setattr(checks, "oracle_decodes", None)
    rec = checks.sample_check(cfg, cfg, 0, 4, 1.0, 2, 0, cpu, n_path=4)
    assert rec["ok"] and "oracle_tbs" not in rec and set(rec["max_abs_err"]) == {"plain"}


def test_the_plain_decode_is_kept_for_the_last_llrs(monkeypatch):
    """``checks.plain_tb_decode``: the plain decoder runs again only where
    the configuration or the LLRs differ from the last call's."""
    cfg = cells.chain_config(cells.cell("reference_sweep_b256")["configuration"])
    other = dataclasses.replace(cfg, iterations=cfg.iterations + 1)
    calls = []

    def tb_decode(cfg, d, backend=None):
        calls.append((cfg, backend))
        return (d.sum().item(),)

    monkeypatch.setattr(checks, "tb_decode", tb_decode)
    monkeypatch.setattr(checks, "_last_plain", [])
    cpu = torch.device("cpu")
    d = checks.first_step_llrs(cfg, 0, 3, 1.0, 2, cpu)
    first = checks.plain_tb_decode(cfg, d)
    assert checks.plain_tb_decode(cfg, d.clone()) is first
    assert calls == [(cfg, "fast")]
    d2 = d.clone()
    d2[1, 0, 5] += 1
    for c, x in ((cfg, d2), (other, d2), (other, d2[:1]), (cfg, d)):
        checks.plain_tb_decode(c, x)
    assert calls == [(cfg, "fast"), (cfg, "fast"), (other, "fast"), (other, "fast"),
                     (cfg, "fast")]
    checks.plain_tb_decode(cfg, d2)
    d2[0, 0, 0] += 1  # changed in place after the call: decoded again, not kept results
    checks.plain_tb_decode(cfg, d2)
    assert len(calls) == 7


@pytest.mark.parametrize("name", CELLS)
def test_each_configuration_equals_chip_smoke(name):
    mine = cells.chain_config(cells.cell(name)["configuration"])
    theirs = CHIP_SMOKE_CONFIGS[name]()
    for f in dataclasses.fields(theirs):
        if f.name == "params":
            for g in dataclasses.fields(theirs.params):
                assert getattr(mine.params, g.name) == getattr(theirs.params, g.name), g.name
        else:
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("schedule,algorithm", [("layered", "min-sum"),
                                                ("flooding", "sum-product")])
@pytest.mark.parametrize("early_termination", [True, False])
def test_the_work_count_equals_kernel_bound(schedule, algorithm, early_termination):
    """On decodes whose iterations mix early passes and the budget."""
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    budget = 6
    d, _ = roofline.noisy_d_tilde(p, "QPSK", 2.0, 24, 3, torch.device("cpu"))
    res = decoder_cuda.decode(p, d, iterations=budget, algorithm=algorithm, schedule=schedule,
                              early_termination=early_termination, channel_format="d",
                              output_format="sys")
    used = res.iterations.reshape(-1).numpy()
    if early_termination:
        assert 0 < (used < budget).sum() < used.size  # a mix
    hist = np.bincount(used, minlength=budget + 1)
    in_cols, out_cols = p.num_cols - 2, p.num_sys_cols
    mine = bound.decode_bound(p, hist, budget, schedule=schedule, algorithm=algorithm,
                              early_termination=early_termination, in_cols=in_cols,
                              out_cols=out_cols)
    theirs = roofline.kernel_bound(p, res, budget, in_cols, out_cols, schedule=schedule,
                                   algorithm=algorithm, early_termination=early_termination)
    for k in ("bound_ms", "bound_by", "bytes", "operations"):
        assert mine[k] == theirs[k], k


def _event(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_the_trace_reader_measures_and_names_a_window(tmp_path):
    """Window 0-100 µs: device busy 10-30 (an encoder kernel) and 50-80 (the
    decode kernel, with a copy overlapping it), idle 0-10, 30-50, 80-100;
    the host in roll > launch over 30-50, in a fetch over 80-100."""
    events = [
        _event("user_annotation", trace.WINDOW, 0, 100),
        _event("cpu_op", "aten::roll", 25, 30),
        _event("cuda_runtime", "cudaLaunchKernel", 35, 10),
        _event("cpu_op", "aten::copy_", 78, 20),
        _event("kernel", "void elementwise_kernel<int>(...)", 10, 20, tid=7),
        _event("kernel", "void ldpc_layered_kernel<0>(...)", 50, 30, tid=7),
        _event("gpu_memcpy", "Memcpy DtoH", 70, 5, tid=7),
        _event("cpu_op", "aten::other_thread", 0, 100, tid=2),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    seen = trace.read(str(path), steps=2)
    assert seen["device_idle_share"] == pytest.approx(0.5)
    assert seen["device_kernels_per_step"] == 1.0
    assert seen["decode_kernel_ms_per_step"] == pytest.approx(0.015)
    b = seen["breakdown"]
    assert b["device_ops"][0]["name"].startswith("void ldpc_layered_kernel")
    assert b["kernels_per_step_by_name"] == {"void elementwise_kernel<int>(...)": 0.5,
                                             "void ldpc_layered_kernel<0>(...)": 0.5}
    gaps = b["longest_idle_gaps"]
    assert [g["ms"] for g in gaps] == pytest.approx([0.02, 0.02, 0.01])
    named = {(g["host_outer"], g["host_inner"]) for g in gaps}
    assert named == {("aten::roll", "cudaLaunchKernel"), ("aten::copy_", "aten::copy_"),
                     ("python", "python")}
    by_op = {r["host_inner"]: r["share_of_idle"] for r in b["idle_by_host_op"]}
    assert by_op == pytest.approx({"cudaLaunchKernel": 0.4, "aten::copy_": 0.4, "python": 0.2})


def test_a_cpu_trace_has_no_device_metrics(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _event("user_annotation", trace.WINDOW, 0, 100), _event("cpu_op", "aten::add", 1, 5)]}))
    seen = trace.read(str(path), steps=1)
    assert seen == dict(device_idle_share=None, device_kernels_per_step=None,
                        decode_kernel_ms_per_step=None, breakdown=None)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs the cell")


def test_the_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--cell", "flagship_headline"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.run_cell("reference_sweep_b256")


def _flip(results, name, index):
    bits = results[name][0].copy()
    bits[index] ^= 1
    return dict(results, **{name: (bits,) + results[name][1:]})


def test_the_sample_check_fails_when_one_bit_is_flipped():
    cfg = ChainConfig(params=LDPCParams(BG=2, A=100, G=300, Q_m=2), iterations=8)
    assert (cfg.algorithm, cfg.schedule) == ("sum-product", "flooding")
    d, _ = roofline.noisy_d_tilde(cfg.params, "QPSK", 1.0, 3, 5, torch.device("cpu"))
    tb = {"path": checks.tb_decode(cfg, d), "plain": checks.tb_decode(cfg, d, backend="fast")}
    assert checks.compare_sample(tb, "path", checks.TB_FIELDS)["ok"]
    rec = checks.compare_sample(_flip(tb, "path", (1, 7)), "path", checks.TB_FIELDS)
    assert not rec["ok"]
    assert rec["max_abs_err"]["plain"]["bits"] == 1 and rec["tbs_differing"]["plain"] == 1
    core = checks.oracle_decodes(cfg, d)
    assert set(core) == {"plain", "c++ oracle"}
    assert checks.compare_sample(core, "plain", checks.CORE_FIELDS)["ok"]
    rec = checks.compare_sample(_flip(core, "plain", (1, 0, 7)), "plain", checks.CORE_FIELDS)
    assert not rec["ok"] and rec["max_abs_err"]["c++ oracle"]["bits"] == 1


@pytest.mark.parametrize("name", CPU_RUN_CELLS)
def test_the_metric_is_all_the_trials_tbs_over_all_their_seconds(cell_runs, name):
    lines, record = cell_runs[name]
    (detail,) = [json.loads(ln[len("detail: "):]) for ln in lines if ln.startswith("detail: ")]
    A = cells.cell(name)["configuration"]["params"]["A"]
    seconds = detail["trials_s"]
    want = detail["tbs_per_trial"] * len(seconds) * A / sum(seconds) / 1e6
    assert record["decoded_info_mbit_per_s"] == pytest.approx(want, rel=1e-12)
    assert detail["decoded_info_mbit_per_s_median"] > 0
    for host in detail["trials_host"]:
        assert set(host) == set(run.host_sample()) | {"probe_ms"}
        assert 0 <= host["thread_cpu_s"] <= host["process_cpu_s"] + 0.05 and host["probe_ms"] > 0
    assert [h["wall_s"] for h in detail["trials_host"]] == seconds


def test_a_control_that_changes_the_results_comes_out_incorrect():
    """The timed path at another rule (min-sum for the cell's sum-product):
    the checks still hold the declared configuration, and fail."""
    lines = []
    with port_alone():
        record = run.run_cell("reference_sweep_b256", seed=0, device="cpu", out=lines.append,
                              cut=dict(batch_per_step=3, sample_tbs=3),
                              chain=run.parse_chain(["algorithm=min-sum"]))
    assert record["control"] == {"algorithm": "min-sum"}
    assert not record["correct"] and lines[-2] == "correct: false"
    (checks_line,) = [ln for ln in lines if ln.startswith("checks: ")]
    sample = json.loads(checks_line[len("checks: "):])["sample"]
    assert not sample["ok"] and sample["tbs_differing"]["plain"] >= 1
    assert sample["max_abs_err"]["c++ oracle"] == {"bits": 0, "parity_ok": 0, "iterations": 0}
    assert run.parse_chain(["message_dtype=bfloat16", "alpha_schedule=[0.65, 2]"]) == {
        "message_dtype": "bfloat16", "alpha_schedule": (0.65, 2)}


def test_a_run_in_a_process_that_loaded_jax_comes_out_incorrect(monkeypatch):
    """A module named ``jax`` in ``sys.modules`` when the checks run: the
    sample holds, ``correct`` is false and the import check names it."""
    lines = []
    with port_alone(), monkeypatch.context() as patched:
        patched.setitem(sys.modules, "jax", types.ModuleType("jax"))
        record = run.run_cell("reference_sweep_b256", seed=0, device="cpu", out=lines.append)
    assert not record["correct"] and lines[-2] == "correct: false"
    (checks_line,) = [ln for ln in lines if ln.startswith("checks: ")]
    checked = json.loads(checks_line[len("checks: "):])
    assert checked["imports"]["loaded"] == ["jax"] and not checked["imports"]["ok"]
    assert checked["sample"]["ok"]


@pytest.mark.parametrize("module", ["jax", "jaxlib.xla_extension", "flax.linen",
                                    "ldpc_3gpp_tpu", "ldpc_3gpp_tpu.ops.decoder_pallas"])
def test_the_import_check_names_each_jax_module(module):
    top = module.split(".")[0]
    assert checks.import_check({"torch": None, module: None}) == dict(
        forbidden=list(checks.JAX_MODULES), loaded=[top], ok=False)
    assert checks.import_check({"torch": None, "ldpc_3gpp_tpu_torch.ops": None,
                                "jaxtyping": None})["ok"]


def test_the_llr_stand_in_rounds_what_the_decode_receives():
    """``run.rounded_llrs``: while open, the chain's LLRs come out rounded to
    the dtype named; after it, the chain's own function is back."""
    from ldpc_3gpp_tpu_torch.models import chain as chain_module

    plain = chain_module.split_rate_matched_symbols
    cfg = cells.chain_config(cells.cell("reference_bulk_b16384")["configuration"])
    p = cfg.params
    generator = torch.Generator().manual_seed(0)
    rx = torch.randn((2, p.G // p.Q_m), dtype=torch.complex64, generator=generator)
    args = (p, rx, cfg.modulation, 0.8, cfg.demod_method)
    d = plain(*args)
    with run.rounded_llrs("bfloat16"):
        rounded = chain_module.split_rate_matched_symbols(*args)
    assert chain_module.split_rate_matched_symbols is plain
    assert rounded.dtype == d.dtype and torch.equal(rounded, d.to(torch.bfloat16).to(d.dtype))
    assert not torch.equal(rounded, d)
    with run.rounded_llrs(None):
        assert chain_module.split_rate_matched_symbols is plain
    for bad in ("int8", "no_such_dtype"):
        with pytest.raises(ValueError):
            with run.rounded_llrs(bad):
                pass
    assert chain_module.split_rate_matched_symbols is plain


def test_the_sample_check_rounds_the_paths_llrs_for_the_stand_in(monkeypatch):
    """``llr_dtype``: the timed path's side of the sample decodes the rounded
    LLRs, the plain side and the C++ oracle the LLRs as drawn."""
    cfg = cells.chain_config(cells.cell("reference_bulk_b16384")["configuration"])
    seen = []

    def tb_decode(cfg, d, backend=None):
        seen.append((backend, d.clone()))
        ok = np.ones((d.shape[0], 1), dtype=bool)
        return np.zeros((d.shape[0], 1), dtype=np.int8), ok[:, 0], ok, np.zeros_like(ok, int)

    monkeypatch.setattr(checks, "tb_decode", tb_decode)
    monkeypatch.setattr(checks, "_last_plain", [])
    monkeypatch.setattr(checks, "oracle_decodes", lambda cfg, d: {
        "plain": (d.numpy(),), "c++ oracle": (d.numpy(),)})
    cpu = torch.device("cpu")
    d = checks.first_step_llrs(cfg, 0, 3, 1.0, 2, cpu)
    checks.sample_check(cfg, cfg, 0, 3, 1.0, 2, 1, cpu, "float8_e4m3fn")
    (path_backend, path_d), (plain_backend, plain_d) = seen
    assert (path_backend, plain_backend) == (None, "fast")
    assert torch.equal(path_d, checks.round_llrs(d, "float8_e4m3fn"))
    assert torch.equal(plain_d, d) and not torch.equal(path_d, d)


def test_the_summary_reads_each_run_and_the_spread(cell_runs, tmp_path):
    from benchmark_torch import summarize

    paths = []
    for i, name in enumerate(CPU_RUN_CELLS * 2):
        path = tmp_path / f"run{i}.log"
        path.write_text("\n".join(cell_runs[name][0]) + "\n")
        paths.append(str(path))
    rows = summarize.summarize(paths)
    assert [r["cell"] for r in rows] == list(CPU_RUN_CELLS * 2) + list(CPU_RUN_CELLS)
    for row in rows[-len(CPU_RUN_CELLS):]:
        assert row["runs"] == 2 and row["spread_pct"] == 0 and row["twice_spread_pct"] == 0
        # each run twice: two distinct trials' points, each twice, lie on a line
        assert abs(row["trial_seconds_vs_probe_correlation"]) == pytest.approx(1.0)


@pytest.mark.parametrize("name,want", [
    ("flagship_headline", {("ldpc_layered", 1, 0): 33}),  # 8 steps x (1 + 2 + 1) calls + 1
    ("reference_sweep_b256", {("ldpc_flooding", 1, 1): 86}),  # 1 + 2 x 40 + 4 calls + 1
    ("reference_bulk_b16384", {("ldpc_flooding", 1, 1): 33}),
    ("snr_vs_a_a8000_b8192", {("ldpc_flooding", 1, 3): 9}),  # 2 steps x (1 + 2 + 1) calls + 1
    (CONFIG1_CELL, {("ldpc_flooding", 1, 1): 5}),  # 1 step x (1 + 2 + 1) calls + 1
])
def test_the_smoke_run_expects_each_cells_launches(name, want):
    """``chip_smoke.benchmark_launches`` at the smoke cut: one decode launch
    per step of the warm-up, the trials and the profiled window and one for
    the sample, all of the timed step's shape (layered: P=1 in the scratch
    layout; flooding: one block per codeword, or at BG1 Z=384 a cluster of
    3)."""
    spec = cells.cell(name)
    assert chip_smoke.benchmark_launches(spec, chip_smoke.benchmark_cut(spec["traffic"]),
                                         132) == want


def test_the_kernel_diff_names_the_launches_that_differ(tmp_path):
    """``summarize --kernels``: the kernels whose launches per step differ
    between two runs' profiled windows, one missing from a window as 0."""
    from benchmark_torch import summarize

    paths = []
    for i, table in enumerate(({"fill": 1.0, "roll": 151.0, "xor": 114.0},
                               {"fill": 0.0625, "roll": 151.0, "cat": 2.0})):
        path = tmp_path / f"run{i}.log"
        path.write_text("correct: true\nbreakdown: "
                        + json.dumps({"kernels_per_step_by_name": table}) + "\n{}\n")
        paths.append(str(path))
    rows = summarize.kernel_diff(*paths)
    assert rows[:-1] == [dict(name="cat", a=0.0, b=2.0), dict(name="fill", a=1.0, b=0.0625),
                         dict(name="xor", a=114.0, b=0.0)]
    assert (rows[-1]["name"], rows[-1]["a"], rows[-1]["b"]) == ("total", 266.0, 153.0625)
    assert summarize.main(["--kernels"] + paths) == 0


def test_the_smoke_cut_is_made_from_each_cells_traffic():
    for name in CELLS:
        assert cells.cell(name)["control"]["chain"]  # what the smoke run's control changes
        traffic = cells.cell(name)["traffic"]
        cut = chip_smoke.benchmark_cut(traffic)
        assert set(cut) <= set(traffic) and cut["trials"] == 2
        assert cut["fetches_per_trial"] <= traffic["fetches_per_trial"]
        assert all(k not in cut for k in ("sample_tbs", "sample_path_tbs", "oracle_tbs",
                                          "batch_per_step"))


FORBIDDEN_MODULES = ("ldpc_3gpp_tpu_torch.bench", "ldpc_3gpp_tpu_torch.tools.roofline",
                     "ldpc_3gpp_tpu_torch.tools.profile_sim")


def _imports(path):
    """Every module an import statement of ``path`` names, with ``from X
    import y`` also as ``X.y``."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_the_benchmark_imports_nothing_it_must_not():
    files = sorted(glob.glob(os.path.join(ROOT, "benchmark_torch", "*.py")))
    assert len(files) >= 6
    jax_package = re.compile(r"\bldpc_3gpp_tpu\b(?!_torch)")
    for path in files:
        text = open(path).read()
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
        assert not jax_package.search(text), path
        for module in _imports(path):
            assert not (module == "jax" or module.startswith("jax.")), (path, module)
            assert not any(module == m or module.startswith(m + ".")
                           for m in FORBIDDEN_MODULES), (path, module)


def test_the_sync_reader_names_the_ports_innermost_frame():
    """``syncs.site``: the innermost frame under ``ldpc_3gpp_tpu_torch/``,
    named relative to the package; the innermost of all where none is the
    port's.  ``syncs.tally`` counts each site once, in the order seen."""
    import traceback

    from benchmark_torch import syncs

    def frame(path, lineno, name):
        return traceback.FrameSummary(path, lineno, name, line=f"line {lineno}")

    outer = frame(os.path.join(ROOT, "benchmark_torch", "syncs.py"), 90, "measure")
    chain = frame(os.path.join(ROOT, "ldpc_3gpp_tpu_torch", "models", "chain.py"), 201,
                  "simulate_given")
    inner = frame("/usr/lib/python3/torch/_tensor.py", 5, "__torch_function__")
    assert syncs.site([outer, chain, inner]) == dict(
        where="models/chain.py:201", function="simulate_given", line="line 201")
    assert syncs.site([outer, inner])["where"] == "/usr/lib/python3/torch/_tensor.py:5"
    found = [syncs.site([outer, chain])] * 2 + [syncs.site([outer])]
    assert [(s["where"], s["calls"]) for s in syncs.tally(found)] == [
        ("models/chain.py:201", 2), (os.path.join(ROOT, "benchmark_torch", "syncs.py") + ":90", 1)]


def test_the_sync_reader_collects_each_synchronising_warning(monkeypatch):
    """Inside ``syncs.sync_sites`` a warning of a synchronising call is
    collected with the line that made it, every time; another warning
    passes on (the card's debug mode itself is stood in for here)."""
    from benchmark_torch import syncs

    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def synchronising_call():
        warnings.warn("called a synchronizing CUDA operation")
        return sys._getframe().f_lineno - 1

    with pytest.warns(UserWarning, match="something else"):
        with syncs.sync_sites() as found:
            lines = [synchronising_call() for _ in range(2)]
            warnings.warn("something else")
    assert modes == ["warn", "default"]
    assert [s["where"] for s in found] == [f"{os.path.abspath(__file__)}:{lines[0]}"] * 2
    assert found[0]["function"] == "synchronising_call"
