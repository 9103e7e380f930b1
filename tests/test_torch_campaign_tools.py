"""The port's campaign tools (``ldpc_3gpp_tpu_torch/tools/``: bulk Monte-Carlo,
the campaign matrix, the lifting sweep) against the JAX package's
``tools/*.py``: their pure-Python parts equal (the JAX tools are imported by
path; their module level imports no JAX), their JSON fields equal the
goldens', and each writes where it is told and never under ``golden/``."""
import dataclasses
import importlib.util
import json
import os
import sys

import pytest
import torch

from ldpc_3gpp_tpu_torch.parallel import launcher
from ldpc_3gpp_tpu_torch.parallel import montecarlo as t_mc
from ldpc_3gpp_tpu_torch.spec.tables import ALL_LIFTING_SIZES
from ldpc_3gpp_tpu_torch.tools import bulk_montecarlo, lifting_sweep, pod_campaign

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "golden")


def _jax_tool(name):
    """``tools/<name>.py`` of the JAX package, imported by path."""
    tools = os.path.join(ROOT, "tools")
    sys.path.insert(0, tools)  # its checkout shim, tools/_path.py
    try:
        spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                      os.path.join(tools, name + ".py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(tools)
    return module


def _params_fields(p):
    if p is None:
        return None
    return dict(dataclasses.asdict(p), Z_c=p.Z_c, C=p.C, K=p.K, K_prime=p.K_prime,
                N=p.N, N_cb=p.N_cb, i_LS=p.i_LS)


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def _golden_listing():
    return {n: os.path.getmtime(os.path.join(GOLDEN, n)) for n in sorted(os.listdir(GOLDEN))}


def test_campaign_matrix_auto_batch_and_params_equal_the_jax_tool():
    jax_tool = _jax_tool("pod_campaign")
    assert [dataclasses.astuple(e) for e in pod_campaign.MATRIX] == [
        dataclasses.astuple(e) for e in jax_tool.MATRIX]
    assert [f.name for f in dataclasses.fields(pod_campaign.Entry)] == [
        f.name for f in dataclasses.fields(jax_tool.Entry)]
    for A in range(1, 30_001):
        assert pod_campaign.auto_batch(A) == jax_tool.auto_batch(A), A
    for mine, theirs in zip(pod_campaign.MATRIX, jax_tool.MATRIX):
        assert _params_fields(pod_campaign.build_params(mine)) == _params_fields(
            jax_tool.build_params(theirs)), mine.name


@pytest.mark.parametrize("bg", [1, 2])
def test_params_for_z_equals_the_jax_tool(bg):
    jax_tool = _jax_tool("lifting_sweep")
    found = 0
    for Z in ALL_LIFTING_SIZES:
        for qm in (4, 6):
            for rate in (1 / 2, 1 / 3):
                mine = lifting_sweep.params_for_z(bg, Z, qm, rate)
                assert _params_fields(mine) == _params_fields(
                    jax_tool.params_for_z(bg, Z, qm, rate)), (bg, Z, qm, rate)
                found += mine is not None
    assert found > 100


def test_lifting_sweep_configs_are_the_goldens():
    """The tool's configurations, in its order, are those of
    golden/lifting_sweep.json, which the JAX tool wrote."""
    golden = _golden("lifting_sweep.json")
    got = []
    for bg, Z, mod, rate, p in lifting_sweep.sweep_configs():
        if p is None:
            got.append({"bg": bg, "Z": Z, "status": "unsupported"})
        else:
            got.append({"bg": bg, "Z": Z, "i_LS": p.i_LS, "A": p.A, "G": p.G,
                        "modulation": mod, "rate": round(rate, 4)})
    keys = ("bg", "Z", "status", "i_LS", "A", "G", "modulation", "rate")
    want = [{k: r[k] for k in keys if k in r and (k != "status" or r[k] == "unsupported")}
            for r in golden["results"]]
    assert got == want
    assert sum(p is not None for *_, p in lifting_sweep.sweep_configs()) == golden["configs_run"]


def test_bulk_montecarlo_writes_the_jax_fields(tmp_path):
    before = _golden_listing()
    out = tmp_path / "bulk.json"
    result = bulk_montecarlo.main([
        "--device", "cpu", "--blocks", "300", "--A", "100", "--rate", "0.5", "--bg", "2",
        "--modulation", "QPSK", "--esn0", "2.0", "--iterations", "4",
        "--batch-per-device", "64", "--steps-per-call", "2", "--rv-sequence", "0", "2",
        "--cbgti-seq", "[[], []]", "--out", str(out)])
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(result))
    golden = _golden("bulk_cbgti_montecarlo.json")
    assert set(written) == set(golden)
    assert set(written["config"]) == set(golden["config"])
    assert written["config"]["devices"] == 1 and written["config"]["rv_sequence"] == [0, 2]
    assert written["blocks"] >= 300 and written["blocks"] % 128 == 0
    assert 0 <= written["block_errors"] <= written["blocks"]
    assert written["bler"] == written["block_errors"] / written["blocks"]
    assert not bulk_montecarlo.DEFAULT_OUT.startswith("golden")
    assert _golden_listing() == before


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", None)])
@pytest.mark.parametrize("tool", [bulk_montecarlo, pod_campaign],
                         ids=["bulk_montecarlo", "pod_campaign"])
def test_cpu_runs_sum_their_counters_under_gloo(tool, device, backend, monkeypatch):
    """Under a launcher, a run on the CPU asks for gloo (NCCL takes CUDA
    tensors only); a run on the card leaves the choice to
    ``init_distributed`` (NCCL)."""
    asked = []
    monkeypatch.setattr(launcher, "init_distributed",
                        lambda **kw: asked.append(kw) or False)
    monkeypatch.setattr(tool, "_run", lambda args: {"device": args.device})
    assert tool.main(["--device", device]) == {"device": device}
    assert asked == [{"backend": backend}]


def test_pod_campaign_writes_then_resumes_by_skipping(tmp_path, monkeypatch, capsys):
    before = _golden_listing()
    out = tmp_path / "campaign.json"
    argv = ["--scale", "1e-6", "--device", "cpu", "--batch-per-device", "64",
            "--steps-per-call", "1", "--iterations", "6", "--out", str(out)]
    pod_campaign.main(["--only", "bg2_a100_r12_qpsk", *argv])
    with open(out) as f:
        first = json.load(f)
    entry = first["configs"]["bg2_a100_r12_qpsk"]
    assert set(entry) == set(_golden("pod_campaign.json")["configs"]["bg2_a100_r12_qpsk"])
    assert entry["blocks"] >= 300 and first["devices"] == 1
    assert first["grand_total"]["transport_blocks"] == entry["blocks"]

    # a second run without --only over a matrix of that entry skips it and
    # simulates nothing
    (only,) = [e for e in pod_campaign.MATRIX if e.name == "bg2_a100_r12_qpsk"]
    monkeypatch.setattr(pod_campaign, "MATRIX", (only,))

    def refuse(*args, **kwargs):
        raise AssertionError("a completed entry was simulated again")

    monkeypatch.setattr(t_mc, "MonteCarlo", refuse)
    capsys.readouterr()
    pod_campaign.main(argv)
    assert "[bg2_a100_r12_qpsk] already complete, skipping" in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f) == first
    assert not pod_campaign.DEFAULT_OUT.startswith("golden")
    assert _golden_listing() == before


def test_lifting_sweep_writes_its_json(tmp_path, monkeypatch):
    monkeypatch.setattr(lifting_sweep, "ALL_LIFTING_SIZES", (2, 3, 4, 5, 6, 7, 8))
    out = tmp_path / "lifting.json"
    summary = lifting_sweep.main(["--quick", "--batch", "2", "--device", "cpu",
                                  "--out", str(out)])
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(summary))
    assert set(written) == set(_golden("lifting_sweep.json"))
    assert [(r["bg"], r["Z"]) for r in written["results"]] == [
        (bg, Z) for bg in (1, 2) for Z in (2, 5, 8)]
    assert written["high_snr_failures"] == 0
    assert written["configs_run"] == sum(r["status"] == "ok" for r in written["results"])
    assert not lifting_sweep.DEFAULT_OUT.startswith("golden")
