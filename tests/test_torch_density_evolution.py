"""The port's density evolution (``ldpc_3gpp_tpu_torch/tools/density_evolution.py``)
against the JAX package's ``tools/density_evolution.py``: the ensemble tables
equal (numpy, exact), one iteration on fixed inputs equal to a numpy
computation that follows the JAX tool's per-row and per-column loops and its
gather orders (sum-product within 1e-5 relative to the terms each message
sums: library ``log``/``tanh``; min-sum exact), and the (3,6)-regular ensemble converges below its published
threshold sigma* = 0.8809 and fails above it, as the JAX tool's ``converges``
decides at the same two points."""
import os
import sys

import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu_torch.tools import density_evolution as de

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tools.density_evolution as jde  # noqa: E402

NAMES = ("reg36", "bg1_r13", "bg1_r13_nms", "bg1_r23", "bg1_r15", "bg2_headline")
CAP = np.float32(de.CAP)


@pytest.mark.parametrize("name", NAMES)
def test_ensemble_tables_equal_the_jax_tool(name):
    mine, p = de._make_ensemble(name)
    theirs, jp = jde._make_ensemble(name)
    if p is not None:
        np.testing.assert_array_equal(de.tx_counts_d(p), jde.tx_counts_d(jp))
        assert de.column_classes(p) == jde.column_classes(jp)
    assert mine.classes == theirs.classes
    for field in ("rows", "cols", "row_inv", "col_inv"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(theirs, field))
    for field in ("row_edges", "col_edges"):
        for a, b in zip(getattr(mine, field), getattr(theirs, field), strict=True):
            np.testing.assert_array_equal(a, b)
    assert (mine.info_cols, mine.name, mine.algorithm, mine.alpha, mine.n_rows,
            mine.n_cols) == (theirs.info_cols, theirs.name, theirs.algorithm,
                             theirs.alpha, theirs.n_rows, theirs.n_cols)
    assert de.REG36_PUBLISHED_SIGMA == jde.REG36_PUBLISHED_SIGMA == 0.8809
    assert de.CAP == jde.CAP
    for db in (-4.0, 0.0, 2.5):
        assert de.sigma_from_esn0(db) == jde.sigma_from_esn0(db)


def _np_phi(x):
    x = np.clip(x, np.float32(1e-12), CAP)
    return -np.log(np.tanh(np.float32(0.5) * x))


def _np_sum(arrays):
    """Left-to-right float32 sum from zero."""
    acc = np.zeros_like(arrays[0])
    for a in arrays:
        acc = acc + a
    return acc


def _np_iterate(ens, v, off_v, off_u, ch, chmask):
    """One iteration as the JAX tool's ``one_iter`` (tools/density_evolution.py
    :200-256) computes it, with the draws given, in float32 numpy."""
    S = v.shape[1]

    def roll(x, off):
        return np.take_along_axis(x, (np.arange(S)[None, :] + off[:, None]) % S, 1)

    v = np.clip(roll(v, off_v), -CAP, CAP)
    neg = (v < 0).astype(np.float32)
    chunks = []
    for idx in ens.row_edges:
        nsum = _np_sum([neg[i] for i in idx])
        out_sgn = np.float32(1) - np.float32(2) * ((nsum - neg[idx]) % np.float32(2))
        if ens.algorithm == "sum-product":
            mag = _np_phi(np.abs(v[idx]))
            msum = _np_sum(list(mag))
            chunks.append(out_sgn * np.minimum(_np_phi(msum - mag), CAP))
        else:
            a = np.abs(v[idx])
            big = np.full((1, S), 1e30, np.float32)
            pre = np.concatenate([big, np.minimum.accumulate(a, axis=0)[:-1]])
            suf = np.concatenate([np.minimum.accumulate(a[::-1], axis=0)[:-1][::-1], big])
            chunks.append(np.float32(ens.alpha) * out_sgn
                          * np.minimum(np.minimum(pre, suf), CAP))
    u = roll(np.concatenate(chunks)[ens.row_inv], off_u)
    chunks, scale = [], []
    err_w = err_n = np.float32(0)
    for c, idx in enumerate(ens.col_edges):
        usum = _np_sum([u[i] for i in idx])
        chunks.append(ch[c][None, :] + usum - u[idx])
        scale.append(np.repeat((np.abs(ch[c]) + np.abs(u[idx]).sum(0))[None, :],
                               len(idx), 0))
        if c in ens.info_cols:
            app = ch[c] + usum
            err_w += np.sum((app < 0).astype(np.float32) * chmask[c])
            err_n += np.sum(chmask[c].astype(np.float32))
    vnew = np.concatenate(chunks)[ens.col_inv]
    return (np.clip(vnew, -CAP, CAP), err_w / max(err_n, np.float32(1)),
            np.concatenate(scale)[ens.col_inv])


@pytest.mark.parametrize("name", ["reg36", "bg2_headline", "bg1_r13_nms", "bg1_r15"])
def test_one_iteration_equals_numpy(name):
    ens, _ = de._make_ensemble(name)
    E, S = len(ens.rows), 64
    rng = np.random.default_rng(5)
    m = de.m_of(0.5)
    v = (m + np.sqrt(2 * m) * rng.standard_normal((E, S))).astype(np.float32)
    ch = (m + np.sqrt(2 * m) * rng.standard_normal((ens.n_cols, S))).astype(np.float32)
    chmask = rng.random((ens.n_cols, S)) > 0.1
    off_v, off_u = rng.integers(0, S, (2, E))
    got_v, got_pe = de.iterate(
        de.tables(ens, "cpu"), torch.from_numpy(v), torch.from_numpy(off_v),
        torch.from_numpy(off_u), torch.from_numpy(ch), torch.from_numpy(chmask),
        ens.algorithm, ens.alpha)
    want_v, want_pe, scale = _np_iterate(ens, v, off_v, off_u, ch, chmask)
    assert got_v.dtype == torch.float32
    if ens.algorithm == "sum-product":
        # 1e-5 relative to the magnitude of the terms each message sums (the
        # variable update cancels them: a small message keeps their error)
        err = np.abs(got_v.numpy() - want_v)
        assert (err <= 1e-5 * scale).all(), (err / scale).max()
        assert (err > 0).any()  # the transcendentals differ; the test would see it
    else:
        np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert float(got_pe) == float(want_pe)


def test_channel_classes_equal_numpy():
    """Fillers at +CAP and out of the mask, the punctured columns at 0, k
    transmissions ~ N(k m, 2 k m), each sample in the class its u falls in."""
    ens, p = de._make_ensemble("bg2_headline")
    assert any(kind == ("known",) for cl in ens.classes for _, kind in cl)
    S = 256
    rng = np.random.default_rng(1)
    u = rng.random((ens.n_cols, S)).astype(np.float32)
    n = rng.standard_normal((ens.n_cols, S)).astype(np.float32)
    m = de.m_of(-1.0)
    val, mask = de.channel(de.tables(ens, "cpu"), m, torch.from_numpy(u),
                           torch.from_numpy(n))
    want = np.zeros_like(u)
    want_mask = np.ones(u.shape, bool)
    for c, cl in enumerate(ens.classes):
        acc = 0.0
        for frac, kind in cl:
            sel = (u[c] >= np.float32(acc)) & (u[c] < np.float32(acc + frac))
            acc += frac
            if kind == ("known",):
                want[c][sel] = CAP
                want_mask[c][sel] = False
            elif kind[1] > 0:
                k = np.float32(kind[1])
                want[c][sel] = (k * np.float32(m) + np.sqrt(np.float32(2) * k * np.float32(m))
                                * n[c])[sel]
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_allclose(val.numpy(), want, rtol=1e-6, atol=0)
    assert not mask.numpy().all()


def _esn0_of_sigma(sigma):
    return -20.0 * np.log10(sigma)


def test_reg36_converges_below_the_published_threshold_and_fails_above():
    """At S = 4,000 on the CPU: sigma 0.84 converges and 0.93 does not (the
    published threshold is 0.8809); the error estimate pools 6 columns x S
    samples, so p_target 1e-4 is resolvable."""
    ens = de.reg36_ensemble()
    evolver = de.Evolver(ens, 4000, "cpu")
    good = de.converges(evolver, de.m_of(_esn0_of_sigma(0.84)), 100, 1e-4, 0, 10)
    bad = de.converges(evolver, de.m_of(_esn0_of_sigma(0.93)), 100, 1e-4, 0, 10)
    assert good[0] and good[2] <= 1e-4, good
    assert not bad[0] and bad[2] > 1e-2, bad


def test_jax_tool_decides_the_same_at_the_two_points():
    ens = jde.reg36_ensemble()
    fns = jde._build_evolve(ens, 4000, 10)
    verdicts = [jde.converges(ens, de.m_of(_esn0_of_sigma(s)), 4000, 100, 1e-4, 0,
                              fns, 10)[0] for s in (0.84, 0.93)]
    assert verdicts == [True, False]


def test_main_refuses_golden_and_runs_only_where_asked(tmp_path):
    with pytest.raises(ValueError, match="golden"):
        de.main(["--configs", "reg36", "--device", "cpu", "--out",
                 os.path.join(ROOT, "golden", "de_thresholds.json")])
    out = tmp_path / "de.json"
    art = de.main(["--configs", "reg36", "--samples", "2000", "--max-iters", "60",
                   "--iters-per-block", "10", "--tol-db", "0.25", "--device", "cpu",
                   "--out", str(out)])
    assert set(art) == set(jde_golden_keys())
    row = art["rows"]["reg36"]
    assert set(row) == {"description", "threshold_sigma", "published_sigma",
                        "delta_db", "resolution_db"}
    assert abs(row["delta_db"]) < 1.0 and row["resolution_db"] <= 0.25
    assert "the host CPU" in art["description"] and art["backend"] == "cpu"


def jde_golden_keys():
    import json

    with open(os.path.join(ROOT, "golden", "de_thresholds.json")) as f:
        return json.load(f).keys()
