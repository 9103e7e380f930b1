"""The sweeps' host logic against the JAX package's, exactly.

``MonteCarlo`` is replaced in both ``sweep`` modules by one scripted stand-in
that answers every call from the same deterministic model of the link, so the
two packages must make the same calls in the same order and write the same
bytes: found-start skipping of all-error batches, the first success, windows
sized from the observed error rate at low BLER, capped points, resume and
repair of torn and capped files.
"""
import dataclasses
import os

import numpy as np
import pytest

from ldpc_3gpp_tpu.parallel import sweep as j_sweep
from ldpc_3gpp_tpu_torch.parallel import sweep as t_sweep


class ScriptedMonteCarlo:
    """Counters from a fixed waterfall: BLER 1 below ``-1.4 dB``, then falling
    by a decade every 0.8 dB; errors drawn from a numpy stream seeded by A, so
    equal call sequences give equal counters."""

    log = None  # the class-level call log of the run in progress

    def __init__(self, cfg, batch_per_device=128, steps_per_call=1, device=None):
        self.cfg = cfg
        self.blocks_per_run = batch_per_device * steps_per_call
        self.rng = np.random.default_rng(cfg.params.A)

    def _draw(self, esn0_db, calls):
        p = min(1.0, 10.0 ** (-(esn0_db + 1.4 - self.cfg.params.A / 8000.0) / 0.8))
        blocks = self.blocks_per_run * calls
        errors = int(self.rng.binomial(blocks, p))
        return {"blocks": blocks, "block_errors": errors,
                "bit_errors": errors * 7, "iterations": blocks * 3,
                "iteration_hist": np.zeros(self.cfg.iterations + 1, np.int64)}

    def run(self, _stream, esn0_db):
        type(self).log.append(("run", round(esn0_db, 6), 1))
        return self._draw(esn0_db, 1)

    def run_pipelined(self, _stream, esn0_db, calls):
        type(self).log.append(("run_pipelined", round(esn0_db, 6), calls))
        return self._draw(esn0_db, calls)


def _both(monkeypatch, tmp_path, function, prepare=None, **kw):
    """Run ``function`` of both packages against the stand-in; returns
    {package: (result, call log, {file name: bytes})}."""
    out = {}
    for name, module, extra in (("jax", j_sweep, {}), ("torch", t_sweep, {"device": "cpu"})):
        monkeypatch.setattr(module, "MonteCarlo", ScriptedMonteCarlo)
        ScriptedMonteCarlo.log = []
        results_dir = tmp_path / name
        results_dir.mkdir(exist_ok=True)
        if prepare:
            prepare(results_dir)
        result = getattr(module, function)(
            results_dir=str(results_dir), verbose=False, **extra, **kw)
        files = {f: (results_dir / f).read_bytes() for f in sorted(os.listdir(results_dir))}
        out[name] = (result, list(ScriptedMonteCarlo.log), files)
    return out


def _points(curves):
    return {k: [dataclasses.asdict(p) for p in v] for k, v in curves.items()}


BLER_KW = dict(A=[1000, 4000], rate=[1 / 3], bg=[1], iterations=5,
               target_block_errors=30, target_bler=2e-3, esn0_start=-2.0,
               esn0_delta=0.25, batch_per_device=256, seed=3)


@pytest.mark.parametrize("case", ["plain", "capped", "steps_per_call"])
def test_bler_vs_snr_is_byte_identical(monkeypatch, tmp_path, case):
    kw = dict(BLER_KW)
    if case == "capped":
        kw["max_blocks_per_point"] = 4096
    if case == "steps_per_call":
        kw.update(steps_per_call=2, batch_per_device=96)
    out = _both(monkeypatch, tmp_path, "bler_vs_snr", **kw)
    (rj, lj, fj), (rt, lt, ft) = out["jax"], out["torch"]
    assert lj == lt and len(lj) > 10
    assert fj == ft and len(fj) == 2
    assert _points(rj) == _points(rt)
    assert "BLER_vs_SNR_1000_0.333333_1_QPSK_5_30_-2_3.txt" in ft
    kinds = {k for k, _, _ in lt}
    assert kinds == {"run", "run_pipelined"}
    first = next(iter(rt.values()))
    assert first[0].bler == 1.0 and first[0].blocks == (96 * 2 if case == "steps_per_call" else 256)
    assert any(w > 1 for k, _, w in lt if k == "run_pipelined")  # low-BLER windows
    capped = [p.capped for pts in rt.values() for p in pts]
    text = b"".join(ft.values())
    if case == "capped":
        assert any(capped) and t_sweep.CAPPED_PREFIX.encode() in text
    else:
        assert not any(capped) and b"#" not in text
    for line in text.decode().splitlines():
        if not line.startswith("#"):
            esn0, bler = line.split("\t")
            assert f"{float(esn0):f}" == esn0 and f"{float(bler):e}" == bler


@pytest.mark.parametrize("case", ["plain", "capped"])
def test_snr_vs_a_is_byte_identical(monkeypatch, tmp_path, case):
    kw = dict(A=[1000, 2000, 6000], rate=[1 / 3, 1 / 2], bg=1, iterations=5,
              target_block_errors=30, target_bler=1e-2, esn0_start=-2.0,
              esn0_delta=0.1, batch_per_device=256, seed=1)
    if case == "capped":
        kw["max_blocks_per_point"] = 1024
    out = _both(monkeypatch, tmp_path, "snr_vs_a", **kw)
    (rj, lj, fj), (rt, lt, ft) = out["jax"], out["torch"]
    assert lj == lt and fj == ft and rj == rt
    assert sorted(ft) == ["SNR_vs_A_0.01_0.333333_1_QPSK_5_30_1.txt",
                          "SNR_vs_A_0.01_0.5_1_QPSK_5_30_1.txt"]
    curve = rt[1 / 3]
    assert [a for a, _ in curve] == [1000, 2000, 6000]
    required = [req for _, req in curve]
    assert all(-2.0 < r < 1.0 for r in required) and len(set(required)) == 3
    rows = [ln for ln in ft["SNR_vs_A_0.01_0.333333_1_QPSK_5_30_1.txt"].decode().splitlines()
            if not ln.startswith("#")]
    assert rows == [f"{a}\t{req:f}" for a, req in curve]
    assert (b"# capped" in b"".join(ft.values())) == (case == "capped")


def test_resume_repairs_and_continues_identically(monkeypatch, tmp_path):
    """A file with finished points, a capped point and a torn last line:
    both packages rewrite it to the same bytes, skip what is done, re-simulate
    the capped point and append the same rows."""
    name = "BLER_vs_SNR_1000_0.333333_1_QPSK_5_30_-2_3.txt"
    seeded = ("-1.250000\t7.000000e-01\n-1.000000\t4.000000e-01\n"
              "# capped 3/30 errors in 4096 blocks\n-0.75")

    def prepare(results_dir):
        (results_dir / name).write_text(seeded)

    kw = dict(BLER_KW, A=[1000], resume=True)
    out = _both(monkeypatch, tmp_path, "bler_vs_snr", prepare=prepare, **kw)
    (rj, lj, fj), (rt, lt, ft) = out["jax"], out["torch"]
    assert lj == lt and fj == ft and _points(rj) == _points(rt)
    text = ft[name].decode()
    assert text.startswith("-1.250000\t7.000000e-01\n") and "# capped" not in text
    assert text.count("-1.000000\t") == 1  # the capped point, measured anew
    simulated = {e for _, e, _ in lt}
    assert -1.25 not in simulated and -1.0 in simulated and -0.75 in simulated

    a_name = "SNR_vs_A_0.01_0.333333_1_QPSK_5_30_1.txt"

    def prepare_a(results_dir):
        (results_dir / a_name).write_text("1000\t-0.900000\n2000\t-1.1")

    out = _both(monkeypatch, tmp_path, "snr_vs_a", prepare=prepare_a,
                A=[1000, 2000], rate=[1 / 3], bg=1, iterations=5,
                target_block_errors=30, seed=1, resume=True)
    (rj, lj, fj), (rt, lt, ft) = out["jax"], out["torch"]
    assert lj == lt and fj == ft and rj == rt
    assert rt[1 / 3][0] == (1000, -0.9)
    assert ft[a_name].decode().startswith("1000\t-0.900000\n2000\t")


SCAN_FILES = {
    "clean": "0.000000\t1.0e-01\n0.500000\t1.0e-02\n",
    "torn_no_newline": "0.000000\t1.0e-01\n0.500000\t1.0e",
    "torn_one_field": "0.000000\t1.0e-01\n0.5000\n",
    "blank_tail": "0.000000\t1.0e-01\n\n",
    "capped_last": "0.000000\t1.0e-01\n0.500000\t1.0e-03\n# capped 2/30 errors in 99 blocks\n",
    "capped_interior": "0.000000\t1.0e-01\n# capped 1/3 errors in 9 blocks\n0.500000\t1.0e-02\n",
    "comment_kept": "# made by hand\n0.000000\t1.0e-01\n",
    "malformed_interior": "0.000000\t1.0e-01\nnonsense\n0.500000\t1.0e-02\n",
    "unparsable_interior": "0.000000\tx\n0.500000\t1.0e-02\n",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(SCAN_FILES))
def test_scan_resume_file_matches(tmp_path, name):
    parse = lambda p: (round(float(p[0]), 6), float(p[1]))
    results = []
    for tag, module in (("jax", j_sweep), ("torch", t_sweep)):
        path = tmp_path / f"{tag}.txt"
        path.write_text(SCAN_FILES[name])
        try:
            done = module._scan_resume_file(str(path), parse)
        except ValueError as e:
            done = ("ValueError", str(e).replace(str(path), "FILE"))
        results.append((done, path.read_bytes()))
    assert results[0] == results[1]
    if "interior" in name and "capped" not in name:
        assert results[1][0][0] == "ValueError"
    if name.startswith("torn"):
        assert results[1][1] == b"0.000000\t1.0e-01\n"


def test_constants_config_and_live_plot(tmp_path):
    assert t_sweep.CAPPED_PREFIX == j_sweep.CAPPED_PREFIX
    cj = j_sweep._make_config(1000, 1 / 3, 1, "16QAM", (0, 2), 7, "min-sum",
                              N_L=2, schedule="layered")
    ct = t_sweep._make_config(1000, 1 / 3, 1, "16QAM", (0, 2), 7, "min-sum",
                              N_L=2, schedule="layered")
    assert (ct.params.G, ct.params.Q_m, ct.params.N_L) == (cj.params.G, 4, 2)
    for field in ("modulation", "rv_sequence", "iterations", "algorithm", "schedule"):
        assert getattr(ct, field) == getattr(cj, field)
    pj, pt = j_sweep.SweepPoint(1.0, 0, 0, 0, 0), t_sweep.SweepPoint(1.0, 0, 0, 0, 0)
    assert pj.bler == pt.bler == 0.0 and dataclasses.asdict(pj) == dataclasses.asdict(pt)
    # live_plot=True re-renders the driver's live PNG, as the JAX drivers do
    small = dict(rate=(0.5,), algorithm="min-sum", iterations=4,
                 target_block_errors=10, target_bler=0.3, esn0_start=2.0,
                 batch_per_device=64, device="cpu", verbose=False, live_plot=True)
    t_sweep.bler_vs_snr(A=(100,), bg=(2,), results_dir=str(tmp_path), **small)
    t_sweep.snr_vs_a(A=(100,), bg=2, esn0_delta=0.5, results_dir=str(tmp_path), **small)
    for png in ("BLER_vs_SNR_live.png", "SNR_vs_A_live.png"):
        with open(os.path.join(tmp_path, png), "rb") as f:
            assert f.read(4) == b"\x89PNG", png
