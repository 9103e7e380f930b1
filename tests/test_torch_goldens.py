"""The port's measured artifacts (``golden_torch/``, measured on an NVIDIA
card by ``ldpc_3gpp_tpu_torch/tools/``) against the JAX package's
(``golden/``), by pure JSON arithmetic: BLER points at a shared Es/N0 inside
the two-sample 5-sigma bound of ``chip_smoke.py::two_sample_gate``, required
Es/N0 within ``chip_smoke.py``'s 0.15 dB, density-evolution thresholds within
0.05 dB; each artifact stamped and naming its card; and the cross-anchors of
``tests/test_de_thresholds.py`` and ``tests/test_na_anchor.py`` written anew
on the port's own artifacts.  Parametrised over the files present; a
measurement missing from ``golden_torch/`` must be listed in ROADMAP.md."""
import json
import math
import os
import re
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import DEMOD_JAX_TODAY, SNR_VS_A_TOLERANCE_DB, two_sample_gate  # noqa: E402

from ldpc_3gpp_tpu_torch.tools.na_bound import na_required_esn0_db  # noqa: E402
from ldpc_3gpp_tpu_torch.utils.artifacts import infer_counts  # noqa: E402

GOLDEN = os.path.join(ROOT, "golden")
PORT = os.path.join(ROOT, "golden_torch")
DE_TOLERANCE_DB = 0.05

# every artifact the port's golden pipeline makes
EXPECTED = (
    "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json",
    "BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json",
    "BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json",
    "config2_and_harq.json", "bench_path_bler.json", "SNR_vs_A_surface.json",
    "SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json", "bulk_montecarlo.json",
    "bulk_sp_montecarlo.json", "bulk_lbrm_montecarlo.json",
    "bulk_cbgti_montecarlo.json", "de_thresholds.json", "demod_methods_64QAM.json",
    "na_bound.json", "bench_sweep.json",
)
# the JAX gate on a bench_sweep row's mean iterations per transport block
# (tests/test_tpu_kernel.py:323-328)
BENCH_ITERATION_TOLERANCE = 0.15
PRESENT = sorted(n for n in os.listdir(PORT) if n.endswith(".json")) if os.path.isdir(PORT) else []

# Curves whose artifacts store the BLER alone: (file, curve) -> (blocks per
# call, error target, most blocks per point) of the protocol that made them
# (ldpc_3gpp_tpu_torch/tools/regen_goldens.py SPVSMS and CONFIG2, the same as
# the JAX stages')
INFERRED = {
    ("BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json", "SP-flooding"): (1024, 100, 1_000_000),
    ("BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json", "NMS-flooding"): (1024, 100, 1_000_000),
    ("BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json", "NMS-layered-pallas"): (1024, 100, 1_000_000),
    ("config2_and_harq.json", "harq_single_shot_rv0"): (2048, 100, 2_000_000),
    ("config2_and_harq.json", "harq_harq_ir_rv0231"): (2048, 20, 2_000_000),
}
# curves with counts: file -> [curve key, or None for the top level]
COUNTED = {
    "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json": [None],
    "BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json": [None],
    "config2_and_harq.json": ["BG1_A8448_layered_NMS_12it"],
    "bench_path_bler.json": ["QPSK_R13", "QAM64_R12"],
    "demod_methods_64QAM.json": ["exact", "maxlog"],
}


def _load(root, name):
    with open(os.path.join(root, name)) as f:
        return json.load(f)


def _curves(name, art):
    """{curve: [(esn0_db, blocks, errors)]} of a BLER artifact."""
    out = {}
    if name.startswith("bulk_"):
        return {None: [(art["config"]["esn0_db"], art["blocks"], art["block_errors"])]}
    for key in COUNTED.get(name, []):
        c = art if key is None else art[key]
        errors = c.get("block_errors") or [round(b * n) for b, n in zip(c["bler"], c["blocks"])]
        out[key] = list(zip(c["esn0_db"], c["blocks"], errors))
    for (file, key), protocol in INFERRED.items():
        if file == name:
            c = art[key]
            out[key] = [(e, *infer_counts(b, *protocol)) for e, b in zip(c["esn0_db"], c["bler"])]
    return out


BLER_FILES = [n for n in PRESENT if n in COUNTED or n.startswith("bulk_")
              or any(f == n for f, _ in INFERRED)]


def test_every_expected_artifact_is_present_or_listed_in_the_roadmap():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    missing = [n for n in EXPECTED if n not in PRESENT and n not in roadmap]
    assert not missing, f"not in golden_torch/ and not listed in ROADMAP.md: {missing}"
    assert set(PRESENT) <= set(EXPECTED)


def test_inferred_counts_reproduce_stored_ones():
    """The inference on curves that do store their counts gives them back
    (or a smaller sample, never a larger one)."""
    head = _load(GOLDEN, "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json")
    for bler, blocks, errors in zip(head["bler"], head["blocks"], head["block_errors"]):
        got = infer_counts(bler, 1024, 100, 1_000_000)
        assert got[0] <= blocks and got[1] / got[0] == pytest.approx(errors / blocks)
    assert infer_counts(0.004353841145833333, 1024, 100, 1_000_000) == (24576, 107)
    # a point stopped by the 1,000,000-block cap with 93 errors
    assert infer_counts(9.295835465711361e-05, 1024, 100, 1_000_000) == (1000448, 93)


@pytest.mark.parametrize("name", PRESENT)
def test_artifact_is_stamped_and_names_its_nvidia_card(name):
    art = _load(PORT, name)
    assert re.fullmatch(r"[0-9a-f]{16}", art.get("semantics", "")), name
    desc = art["description"]
    assert "TPU" not in desc, name
    if name != "na_bound.json":
        assert re.search(r"NVIDIA [^,;]+, [\d.]+ W", desc), desc
    else:  # a function of the surface measured on the card it names
        assert re.search(r"surface was measured on NVIDIA [^,;]+, [\d.]+ W", desc), desc
    if "CUT" in desc:  # measured at a cut: ROADMAP.md must say so
        with open(os.path.join(ROOT, "ROADMAP.md")) as f:
            assert re.search(rf"{re.escape(name)}[^\n]*\bcut\b", f.read()), name


# golden/demod_methods_64QAM.json predates the JAX package's reversed layered
# row order (see chip_smoke.DEMOD_JAX_TODAY): its layered waterfall is not the
# JAX package's of today, which is the reference for that file instead
STALE = {"demod_methods_64QAM.json": {
    method: [(esn0, *DEMOD_JAX_TODAY[m, esn0]) for m, esn0 in DEMOD_JAX_TODAY if m == method]
    for method in ("exact", "maxlog")}}


def test_the_stale_demod_golden_is_outside_the_bound_of_the_jax_package_today():
    """Why STALE holds: at 10.5 and 10.75 dB both methods of the JAX golden
    lie far outside the two-sample bound of the JAX package's own
    re-measurement."""
    theirs = _curves("demod_methods_64QAM.json", _load(GOLDEN, "demod_methods_64QAM.json"))
    for method, points in STALE["demod_methods_64QAM.json"].items():
        golden = {e: (n, k) for e, n, k in theirs[method]}
        today = {e: (n, k) for e, n, k in points}
        for esn0 in (10.5, 10.75):
            with pytest.raises(AssertionError, match="outside"):
                two_sample_gate(method, esn0, *today[esn0], *golden[esn0])


@pytest.mark.slow  # about an hour of the JAX package's chain on the CPU
def test_jax_package_today_on_the_demod_link():
    """Re-measures chip_smoke.DEMOD_JAX_TODAY with the JAX package (its
    'fast' layered decoder, deterministic on the CPU): runs i = 0, 1, ... of
    256 blocks from jax.random.PRNGKey(1) (run i > 0 from fold_in(key, i)),
    as many as each point's block count."""
    import jax
    from jax.sharding import Mesh

    from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu.parallel.sweep import _make_config

    one_device = Mesh(np.array(jax.devices()[:1]), ("dp",))  # 256 blocks per run
    for method in ("exact", "maxlog"):
        cfg = _make_config(4008, 0.5, 1, "64QAM", (0,), 12, "min-sum", backend="fast",
                           schedule="layered", demod_method=method)
        mc = MonteCarlo(cfg, batch_per_device=256, steps_per_call=1, mesh=one_device)
        key = jax.random.PRNGKey(1)
        for (m, esn0), (want_blocks, _) in DEMOD_JAX_TODAY.items():
            if m != method:
                continue
            blocks = errors = 0
            for i in range(want_blocks // 256):
                c = mc.run(key if i == 0 else jax.random.fold_in(key, i), esn0)
                blocks, errors = blocks + c["blocks"], errors + c["block_errors"]
            assert (blocks, errors) == DEMOD_JAX_TODAY[method, esn0]


@pytest.mark.parametrize("name", BLER_FILES)
def test_bler_points_inside_the_two_sample_bound_of_the_jax_golden(name):
    mine = _curves(name, _load(PORT, name))
    theirs = STALE.get(name) or _curves(name, _load(GOLDEN, name))
    shared = {}
    for key, points in mine.items():
        golden = {round(e, 6): (n, k) for e, n, k in theirs[key]}
        shared[key] = 0
        for esn0, blocks, errors in points:
            if round(esn0, 6) in golden:
                g_blocks, g_errors = golden[round(esn0, 6)]
                two_sample_gate(f"{name}/{key}", esn0, blocks, errors, g_blocks, g_errors)
                shared[key] += 1
    assert mine and all(shared.values()), (name, shared)  # every curve compared


def _required(root, name):
    art = _load(root, name)
    if "curves" in art:
        return {(k, t): v for k, c in art["curves"].items() for t, v in c.items()}
    return {("sum-product/0.333333", "required_esn0_db_at_0.01"): art["required_esn0_db"]}


@pytest.mark.parametrize("name", [n for n in PRESENT if n.startswith("SNR_vs_A_")])
def test_required_esn0_within_the_snr_vs_a_tolerance(name):
    mine, theirs = _required(PORT, name), _required(GOLDEN, name)
    assert _load(PORT, name)["A"] == _load(GOLDEN, name)["A"]
    assert set(mine) <= set(theirs) and mine
    for key, values in mine.items():
        for got, want in zip(values, theirs[key], strict=True):
            assert abs(got - want) <= SNR_VS_A_TOLERANCE_DB, (key, values, theirs[key])


def _de_esn0(row):
    if "threshold_sigma" in row:
        return -20.0 * math.log10(row["threshold_sigma"])
    return row["threshold_esn0_db"]


@pytest.mark.parametrize("name", [n for n in PRESENT if n == "de_thresholds.json"])
def test_de_thresholds_within_tolerance_of_the_jax_golden(name):
    mine, theirs = _load(PORT, name), _load(GOLDEN, name)
    assert set(mine["rows"]) == set(theirs["rows"])
    for name, row in mine["rows"].items():
        assert abs(_de_esn0(row) - _de_esn0(theirs["rows"][name])) <= DE_TOLERANCE_DB, name
    assert mine["backend"] == "cuda"


# The cross-anchors of tests/test_de_thresholds.py and tests/test_na_anchor.py
# on the port's artifacts: name -> the files they need.
ANCHORS = {
    "reg36_published": ["de_thresholds.json"],
    "snr_vs_a_converges_to_bg1": ["de_thresholds.json",
                                  "SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json"],
    "surface_corners": ["de_thresholds.json", "SNR_vs_A_surface.json"],
    "headline_above_bg2": ["de_thresholds.json",
                           "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json"],
    "na_bound_recomputes": ["na_bound.json", "SNR_vs_A_surface.json"],
    "na_gaps_in_envelope": ["na_bound.json"],
}


def _converging_gaps(req, thr):
    gaps = np.asarray(req, float) - thr
    assert (gaps > 0).all(), (req, thr)
    assert gaps[-1] < 0.8 and gaps[-1] < 0.6 * gaps[0], (req, thr)


@pytest.mark.parametrize("anchor", [a for a, files in ANCHORS.items()
                                    if set(files) <= set(PRESENT)])
def test_cross_anchor(anchor):
    if anchor == "reg36_published":
        row = _load(PORT, "de_thresholds.json")["rows"]["reg36"]
        assert row["published_sigma"] == 0.8809
        assert abs(row["delta_db"]) <= DE_TOLERANCE_DB, row
        return
    if anchor.startswith("na_"):
        art = _load(PORT, "na_bound.json")
        if anchor == "na_bound_recomputes":
            surface = _load(PORT, "SNR_vs_A_surface.json")
            for r_key, rate, t_key, eps, idx in (("0.333333", 1 / 3, "0.01", 1e-2, 0),
                                                 ("0.5", 1 / 2, "0.1", 1e-1, 3),
                                                 ("0.666667", 2 / 3, "0.01", 1e-2, 7)):
                A = art["A"][idx]
                fresh = na_required_esn0_db(A, int(round(A / rate / 2) * 2), eps)
                assert abs(fresh - art["bound_esn0_db"][f"{r_key}/{t_key}"][idx]) < 1e-3
            meas = surface["curves"]["sum-product/0.333333"]["required_esn0_db_at_0.01"]
            for m, b, g in zip(meas, art["bound_esn0_db"]["0.333333/0.01"],
                               art["gap_db"]["sum-product/0.333333/0.01"]):
                np.testing.assert_allclose(m - b, g, atol=1e-3)
            return
        for key, gaps in art["gap_db"].items():
            lo, hi = (0.2, 1.4) if key.startswith("sum-product") else (0.4, 2.2)
            vals = [g for g in gaps if g is not None]
            assert vals and min(vals) > lo and max(vals) < hi, (key, vals)
        for r_key in ("0.2", "0.333333", "0.5", "0.666667"):
            for t_key in ("0.1", "0.01"):
                sp = art["gap_db"][f"sum-product/{r_key}/{t_key}"]
                ms = art["gap_db"][f"min-sum/{r_key}/{t_key}"]
                assert all(m - s > -0.05 for s, m in zip(sp, ms)), (r_key, t_key)
        return
    rows = _load(PORT, "de_thresholds.json")["rows"]
    if anchor == "snr_vs_a_converges_to_bg1":
        g = _load(PORT, "SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json")
        _converging_gaps(g["required_esn0_db"], rows["bg1_r13"]["threshold_esn0_db"])
    elif anchor == "surface_corners":
        curves = _load(PORT, "SNR_vs_A_surface.json")["curves"]
        for curve, row in (("sum-product/0.666667", "bg1_r23"), ("sum-product/0.2", "bg1_r15"),
                           ("min-sum/0.333333", "bg1_r13_nms")):
            _converging_gaps(curves[curve]["required_esn0_db_at_0.01"],
                             rows[row]["threshold_esn0_db"])
        penalty = rows["bg1_r13_nms"]["threshold_esn0_db"] - rows["bg1_r13"]["threshold_esn0_db"]
        assert 0.2 < penalty < 1.5, penalty
    else:
        g = _load(PORT, "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json")
        esn0, bler = np.asarray(g["esn0_db"], float), np.asarray(g["bler"], float)
        mask = bler > 0
        crossing = float(np.interp(np.log10(1e-2), np.log10(bler[mask])[::-1],
                                   esn0[mask][::-1]))
        gap = crossing - rows["bg2_headline"]["threshold_esn0_db"]
        assert 0 < gap < 3.2, (crossing, gap)


def test_bench_sweep_rows_against_the_jax_golden():
    """The same rows; each row's mean iterations per transport block within
    15 % of the JAX row's, its BLER inside the two-sample bound (counts from
    the rounded BLER and the blocks of each side).  TB/s are not compared:
    the port's are the card's, the JAX golden's a TPU's."""
    mine, theirs = (_load(root, "bench_sweep.json")["rows"] for root in (PORT, GOLDEN))
    assert [r["name"] for r in mine] == [r["name"] for r in theirs]
    for m, t in zip(mine, theirs):
        assert set(m) == set(t), m["name"]
        for key in ("esn0_db", "iterations_budget", "algorithm", "schedule", "A", "Z", "BG"):
            assert m[key] == t[key], (m["name"], key)
        want = t["mean_iterations_per_tb"]
        assert abs(m["mean_iterations_per_tb"] - want) <= BENCH_ITERATION_TOLERANCE * want, m
        two_sample_gate(f"bench_sweep/{m['name']}", m["esn0_db"], m["blocks"],
                        round(m["bler"] * m["blocks"]), t["blocks"],
                        round(t["bler"] * t["blocks"]))
