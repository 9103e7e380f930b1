"""The port's golden pipeline (``ldpc_3gpp_tpu_torch/tools/regen_goldens.py``
and ``demod_compare.py``) on the CPU: every stage's protocol equals the JAX
stage's (written out below with the JAX lines), every stage run tiny writes
an artifact with its JAX golden's keys and the port's ``semantics`` stamp,
nothing is written under ``golden/``, the surface resumes by its stamp, and
``--restamp`` rewrites only the stamps."""
import json
import os

import pytest
import torch

from ldpc_3gpp_tpu_torch.tools import demod_compare
from ldpc_3gpp_tpu_torch.tools import regen_goldens as rg
from ldpc_3gpp_tpu_torch.utils.fingerprint import semantics_fingerprint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "golden")

# The JAX stages' protocols (tools/regen_goldens.py and tools/demod_compare.py
# of the JAX package; its backend 'pallas' is the port's 'auto').
JAX_PROTOCOLS = {
    # :64-71
    "HEADLINE": dict(A=3842, rate=1 / 3, bg=2, modulation="QPSK", iterations=8,
                     target_block_errors=100, target_bler=1e-3, esn0_start=0.0,
                     esn0_delta=0.25, seed=0, algorithm="sum-product", backend="auto",
                     schedule="flooding", batch_per_device=512, steps_per_call=2),
    # :91-96, :111-120
    "SPVSMS": dict(A=3842, rate=1 / 3, bg=2, modulation="QPSK", iterations=8,
                   target_block_errors=100, target_bler=1e-3, esn0_start=0.0,
                   esn0_delta=0.25, seed=0, batch_per_device=512, steps_per_call=2,
                   backend="auto",
                   curves=(("SP-flooding", "sum-product", "flooding"),
                           ("NMS-flooding", "min-sum", "flooding"),
                           ("NMS-layered-pallas", "min-sum", "layered"))),
    # :127-133 (backend 'fast' there; the port's one deliberate difference,
    # backend 'auto', is held in test_protocols_equal_the_jax_stages)
    "CONFIG1": dict(A=100, rate=1 / 2, bg=2, modulation="QPSK", iterations=50,
                    target_block_errors=100, target_bler=1e-3, esn0_start=0.0,
                    esn0_delta=0.5, seed=0, algorithm="min-sum", backend="fast",
                    schedule="flooding", batch_per_device=1024, steps_per_call=2),
    # :163-169 and :177-190
    "CONFIG2": dict(
        waterfall=dict(A=8448, rate=1 / 3, bg=1, modulation="QPSK", iterations=12,
                       target_block_errors=100, target_bler=1e-3, esn0_start=-0.5,
                       esn0_delta=0.25, seed=0, algorithm="min-sum", backend="auto",
                       schedule="layered", batch_per_device=2048, steps_per_call=1),
        harq=dict(A=2000, rate=0.8, bg=1, modulation="QPSK", iterations=12,
                  algorithm="min-sum", backend="auto", schedule="layered",
                  batch_per_device=1024, steps_per_call=2, seed=0, max_blocks=2_000_000,
                  curves=(("harq_single_shot_rv0", (0,),
                           (0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0, 5.5), 100),
                          ("harq_harq_ir_rv0231", (0, 2, 3, 1), (0.0,), 20)))),
    # :210-222
    "BENCHCFG": dict(
        common=dict(iterations=12, target_block_errors=150, target_bler=1e-3, seed=0,
                    algorithm="min-sum", backend="auto", schedule="layered",
                    batch_per_device=1024, steps_per_call=2),
        QPSK_R13=dict(A=8424, rate=1 / 3, bg=1, modulation="QPSK", esn0_start=-1.25,
                      esn0_delta=0.25),
        QAM64_R12=dict(A=8424, rate=1 / 2, bg=1, modulation="64QAM", esn0_start=10.0,
                       esn0_delta=0.25)),
    # :261 (A), :292-294 (starts), :296-298, :306-308, :313, :319-323
    "SURFACE": dict(A=(1000, 2000, 3000, 4000, 5000, 6000, 7000, 8000), bg=1,
                    modulation="QPSK", iterations=50, algorithms=("sum-product", "min-sum"),
                    backend="auto", schedule="flooding",
                    rates=(("0.2", 1 / 5, -6.0), ("0.333333", 1 / 3, -3.5),
                           ("0.5", 1 / 2, -1.5), ("0.666667", 2 / 3, 0.5)),
                    targets=(1e-1, 1e-2), target_block_errors=100, esn0_delta=0.1,
                    seed=0, batch_per_device=1024, steps_per_call=2, max_blocks=2_000_000),
    # :357-358 over snr_vs_a's defaults (ldpc_3gpp_tpu/parallel/sweep.py)
    "SNRVSA": dict(A=(1000, 2000, 3000, 4000, 5000, 6000, 7000, 8000), rate=1 / 3, bg=1,
                   modulation="QPSK", iterations=50, target_block_errors=100,
                   target_bler=1e-2, esn0_start=-2.0, esn0_delta=0.1, seed=0,
                   algorithm="sum-product", backend="auto", schedule="flooding",
                   batch_per_device=512, steps_per_call=2),
    # :379-383 over the JAX bulk tool's defaults (tools/bulk_montecarlo.py:24-55)
    "BULK": dict(blocks=20_000_000, A=1000, rate=1 / 2, bg=1, modulation="256QAM",
                 esn0=15.75, iterations=12, algorithm="min-sum", schedule="layered",
                 batch_per_device=512, steps_per_call=128),
    # :397-404
    "BULKSP": dict(blocks=2_000_000, A=2048, rate=1 / 3, bg=1, modulation="QPSK", esn0=0.4,
                   iterations=8, algorithm="sum-product", schedule="flooding",
                   batch_per_device=256, steps_per_call=32),
    # :419-427
    "BULKLBRM": dict(blocks=2_000_000, A=4000, rate=1 / 3, bg=1, modulation="QPSK",
                     esn0=-0.3, iterations=12, algorithm="min-sum", schedule="layered",
                     N_L=2, I_LBRM=1, TBS_LBRM=6000, batch_per_device=256,
                     steps_per_call=32),
    # :446-455
    "BULKCBGTI": dict(blocks=2_000_000, A=7650, rate=1 / 3, bg=2, modulation="QPSK",
                      esn0=-0.5, iterations=8, algorithm="min-sum", schedule="layered",
                      rv_sequence=(0, 2), cbgti_seq=((), (0,)), batch_per_device=256,
                      steps_per_call=32),
    # :473 calls run_sweep() at its defaults (ldpc_3gpp_tpu/bench.py:311:
    # trials 3, reps 2; every row at its own steps)
    "BENCH_SWEEP": dict(trials=3, reps=2, steps=None),
}
# The port's deliberate differences from the JAX stages: config #1 runs the
# flooding kernel, bit-exact to the plain 'fast' decoder the JAX stage runs
DIFFERENCES = {"CONFIG1": {"backend": "auto"}}
# tools/demod_compare.py:36-42
JAX_DEMOD = dict(A=4008, rate=1 / 2, bg=1, modulation="64QAM", iterations=12,
                 target_block_errors=100, target_bler=1e-3, esn0_start=8.0, esn0_delta=0.25,
                 seed=0, algorithm="min-sum", backend="auto", schedule="layered",
                 batch_per_device=1024, steps_per_call=2)

# Tiny overrides per stage: BG2 A=100, 2 block errors per point, batch 64.
SMALL = dict(A=100, rate=1 / 2, bg=2, target_block_errors=2, batch_per_device=64,
             steps_per_call=1, esn0_delta=1.0, target_bler=0.05)
TINY = {
    "headline": dict(SMALL, iterations=2, esn0_start=4.0),
    "spvsms": dict(SMALL, iterations=2, esn0_start=5.0, esn0_delta=2.0, target_bler=0.3),
    "config1": dict(SMALL, iterations=10, esn0_start=2.0),
    "config2": dict(
        waterfall=dict(SMALL, esn0_start=3.0),
        harq=dict(A=100, rate=1 / 2, bg=2, batch_per_device=64, steps_per_call=1,
                  max_blocks=128, curves=(("harq_single_shot_rv0", (0,), (4.0,), 2),
                                          ("harq_harq_ir_rv0231", (0, 2, 3, 1), (0.0,), 1)))),
    "benchcfg": dict(
        common=dict(target_block_errors=2, batch_per_device=64, steps_per_call=1,
                    target_bler=0.05),
        QPSK_R13=dict(A=100, rate=1 / 2, bg=2, esn0_start=3.0, esn0_delta=1.0),
        QAM64_R12=dict(A=100, bg=2, esn0_start=12.0, esn0_delta=1.0)),
    "surface": dict(A=(100,), bg=2, iterations=3, rates=(("0.5", 1 / 2, 6.0),),
                    target_block_errors=2, esn0_delta=2.0, batch_per_device=64,
                    steps_per_call=1, max_blocks=192),
    "snrvsa": dict(A=(100,), bg=2, rate=1 / 2, iterations=2, target_block_errors=2,
                   target_bler=0.3, esn0_start=5.0, esn0_delta=2.0, batch_per_device=64,
                   steps_per_call=1),
    "bench_sweep": dict(trials=1, reps=1, steps=1, names=("bg2_z72_packed_layered",)),
}
FILES = {
    "headline": "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json",
    "spvsms": "BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json",
    "config1": "BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json",
    "config2": "config2_and_harq.json",
    "benchcfg": "bench_path_bler.json",
    "surface": "SNR_vs_A_surface.json",
    "snrvsa": "SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json",
    "bench_sweep": "bench_sweep.json",
}


def _load(path):
    with open(path) as f:
        return json.load(f)


def assert_keys_of_the_jax_golden(mine, name):
    """``mine`` has the keys of golden/``name`` but ``semantics`` (which the
    port stamps everywhere), and each dict value those of the golden's
    (a surface cut to some curves: a subset of them)."""
    theirs = _load(os.path.join(GOLDEN, name))
    assert set(mine) - {"semantics"} == set(theirs) - {"semantics"}, name
    assert mine["semantics"] == semantics_fingerprint()
    for key, value in mine.items():
        if isinstance(value, dict):
            if key in ("curves", "delta_ms_minus_sp_db"):
                assert set(value) <= set(theirs[key]), key
                for sub in value.values():
                    if isinstance(sub, dict):
                        assert set(sub) == set(next(iter(theirs[key].values()))), key
            else:
                assert set(value) == set(theirs[key]), key


def test_protocols_equal_the_jax_stages():
    for name, protocol in JAX_PROTOCOLS.items():
        assert getattr(rg, name) == {**protocol, **DIFFERENCES.get(name, {})}, name
    assert JAX_PROTOCOLS["CONFIG1"]["backend"] == "fast"
    assert demod_compare.PROTOCOL == JAX_DEMOD
    assert demod_compare.METHODS == ("exact", "maxlog")
    assert set(rg.STAGES) == {"headline", "spvsms", "config1", "config2", "benchcfg",
                              "surface", "snrvsa", "bulk", "bulksp", "bulklbrm",
                              "bulkcbgti", "bench_sweep"}


@pytest.mark.parametrize("stage", list(TINY))
def test_stage_writes_the_jax_goldens_keys(stage, tmp_path):
    out, results = tmp_path / "out", tmp_path / "results"
    rec = rg.run_stage(stage, str(out), "cpu", str(results), **TINY[stage])
    art = _load(out / FILES[stage])
    assert_keys_of_the_jax_golden(art, FILES[stage])
    assert "the host CPU" in art["description"] and "TPU" not in art["description"]
    assert "CUT from the full protocol" in art["description"]
    assert rec["stage"] == stage and rec["seconds"] > 0
    assert rec["launches"] == {"ldpc_layered": 0, "ldpc_flooding": 0}  # plain versions
    if stage == "snrvsa":
        assert rec["blocks"] is None  # counted from launches on the card only
        assert (out / "SNR_vs_A_0.3_0.5_2_QPSK_2_2_0.txt").exists()
    else:
        assert rec["blocks"] > 0
    if stage == "headline":
        assert len(rec["points"]) == len(art["esn0_db"])
        assert (out / "BLER_vs_SNR_100_0.5_2_QPSK_2_2_4_0.txt").exists()
    if stage == "bench_sweep":  # each row has the keys of the JAX golden's rows
        (theirs,) = {tuple(r) for r in _load(os.path.join(GOLDEN, FILES[stage]))["rows"]}
        assert [tuple(r) for r in art["rows"]] == [theirs]
        assert art["rows"][0]["name"] == "bg2_z72_packed_layered"


def test_demod_compare_writes_the_jax_goldens_keys(tmp_path):
    path = tmp_path / "demod_methods_64QAM.json"
    demod_compare.run(str(path), "cpu", str(tmp_path / "results"), A=100, bg=2,
                      target_block_errors=2, batch_per_device=64, steps_per_call=1,
                      esn0_start=12.0, esn0_delta=1.0, target_bler=0.05)
    assert_keys_of_the_jax_golden(_load(path), "demod_methods_64QAM.json")


def test_nothing_is_written_under_golden(tmp_path):
    listing = sorted(os.listdir(GOLDEN))
    for argv in (["--out-dir", GOLDEN, "config1", "--device", "cpu"],
                 ["--out-dir", os.path.join(GOLDEN, "sub"), "--restamp"]):
        with pytest.raises(ValueError, match="golden"):
            rg.main(argv)
    for stage in rg.STAGES:
        with pytest.raises(ValueError, match="golden"):
            rg.run_stage(stage, GOLDEN, "cpu", str(tmp_path))
        with pytest.raises(ValueError, match="golden"):  # the stage itself, too
            rg.STAGES[stage](out_dir=GOLDEN, device="cpu", results_dir=str(tmp_path),
                             **TINY.get(stage, {}))
    with pytest.raises(ValueError, match="golden"):
        demod_compare.main(["--out", os.path.join(GOLDEN, "demod.json"), "--device", "cpu"])
    assert sorted(os.listdir(GOLDEN)) == listing


def _surface_file(out, stamp, curves):
    out.mkdir(exist_ok=True)
    with open(out / FILES["surface"], "w") as f:
        json.dump({"description": "earlier run", "A": [100], "semantics": stamp,
                   "curves": curves}, f)


SENTINEL = {"required_esn0_db_at_0.1": [-9.0], "required_esn0_db_at_0.01": [-8.0]}


def test_surface_resume_keys_on_the_stamp(tmp_path):
    tiny = dict(TINY["surface"], algorithms=("min-sum",))
    out = tmp_path / "out"
    # an entry whose stamp matches is skipped: nothing is simulated
    _surface_file(out, semantics_fingerprint(), {"min-sum/0.5": SENTINEL})
    rec = rg.run_stage("surface", str(out), "cpu", str(tmp_path), **tiny)
    assert rec["blocks"] == 0
    assert _load(out / FILES["surface"])["curves"] == {"min-sum/0.5": SENTINEL}
    # a stale stamp drops the entries, which are measured again
    _surface_file(out, "stale", {"min-sum/0.5": SENTINEL, "min-sum/0.2": SENTINEL})
    rec = rg.run_stage("surface", str(out), "cpu", str(tmp_path), **tiny)
    art = _load(out / FILES["surface"])
    assert rec["blocks"] > 0 and list(art["curves"]) == ["min-sum/0.5"]
    assert art["curves"]["min-sum/0.5"] != SENTINEL
    assert art["semantics"] == semantics_fingerprint()
    # --force-resume keeps them
    _surface_file(out, "stale", {"min-sum/0.5": SENTINEL})
    rec = rg.run_stage("surface", str(out), "cpu", str(tmp_path), force_resume=True, **tiny)
    assert rec["blocks"] == 0
    assert _load(out / FILES["surface"])["curves"] == {"min-sum/0.5": SENTINEL}


def test_restamp_rewrites_only_the_stamps(tmp_path):
    stamped = {"description": "d", "semantics": "stale", "A": [1, 2], "x": {"y": 0.5}}
    current = {"description": "e", "semantics": semantics_fingerprint(), "z": 1}
    unstamped = {"description": "f", "bler": [0.1]}
    for name, obj in (("a.json", stamped), ("b.json", current), ("c.json", unstamped)):
        with open(tmp_path / name, "w") as f:
            json.dump(obj, f)
    before = {n: (tmp_path / n).read_bytes() for n in ("b.json", "c.json")}
    assert rg.main(["--restamp", "--out-dir", str(tmp_path)]) == []
    assert _load(tmp_path / "a.json") == dict(stamped, semantics=semantics_fingerprint())
    assert list(_load(tmp_path / "a.json")) == list(stamped)
    for n, raw in before.items():
        assert (tmp_path / n).read_bytes() == raw
