"""The port's ``MonteCarlo`` (one process, one device) on the CPU: its
counters equal the summed ``simulate_batch`` steps on a generator with the
same seed, the batch rounding and its warning equal the JAX class's, nothing
falls back to the CPU unasked, and a small real sweep gives a waterfall."""
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.models import chain as j_chain
from ldpc_3gpp_tpu.parallel import montecarlo as j_mc
from ldpc_3gpp_tpu.spec.params import LDPCParams as JParams
from ldpc_3gpp_tpu_torch.models import chain as t_chain
from ldpc_3gpp_tpu_torch.parallel import montecarlo as t_mc
from ldpc_3gpp_tpu_torch.parallel import sweep as t_sweep
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams as TParams
from ldpc_3gpp_tpu_torch.utils.rng import make_generator

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = dict(BG=2, A=100, G=200, Q_m=2)


def _cfg(**kw):
    base = dict(params=TParams(**FIELDS), iterations=6, algorithm="min-sum")
    return t_chain.ChainConfig(**{**base, **kw})


def _summed_steps(cfg, seed, esn0_db, batch, steps):
    g = make_generator(seed, "cpu")
    total = dict(blocks=0, block_errors=0, bit_errors=0, iterations=0,
                 iteration_hist=np.zeros(cfg.iterations + 1, np.int64))
    for _ in range(steps):
        r = t_chain.simulate_batch(cfg, g, esn0_db, batch, device="cpu")
        for k in ("blocks", "block_errors", "bit_errors", "iterations"):
            total[k] += int(getattr(r, k))
        total["iteration_hist"] += r.iteration_hist.numpy()
    return total


def _assert_counters_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "iteration_hist":
            assert got[k].dtype == np.int64
            np.testing.assert_array_equal(got[k], v)
        else:
            assert type(got[k]) is int and got[k] == v, k


@pytest.mark.parametrize("kw", [dict(), dict(schedule="layered", rv_sequence=(0, 2))],
                         ids=["flooding", "layered_harq"])
def test_run_equals_the_summed_steps(kw):
    cfg = _cfg(**kw)
    mc = t_mc.MonteCarlo(cfg, batch_per_device=24, steps_per_call=3, device="cpu")
    assert mc.blocks_per_run == 72
    esn0_db = -1.0 if kw else 1.5
    got = mc.run(make_generator(5, "cpu"), esn0_db)
    want = _summed_steps(cfg, 5, esn0_db, 24, 3)
    _assert_counters_equal(got, want)
    assert 0 < got["block_errors"] < got["blocks"] == 72
    # every block's first decode is counted, a retransmission only if needed
    assert 72 <= got["iteration_hist"].sum() <= 72 * len(cfg.rv_sequence)


def test_run_pipelined_equals_that_many_runs():
    cfg = _cfg()
    mc = t_mc.MonteCarlo(cfg, batch_per_device=16, steps_per_call=2, device="cpu")
    window = mc.run_pipelined(make_generator(9, "cpu"), 2.0, 3)
    g = make_generator(9, "cpu")
    runs = [mc.run(g, 2.0) for _ in range(3)]
    want = {k: sum(r[k] for r in runs) for k in runs[0]}
    _assert_counters_equal(window, want)
    assert window["blocks"] == 3 * 32
    _assert_counters_equal(window, _summed_steps(cfg, 9, 2.0, 16, 6))


@pytest.mark.parametrize("batch", [64, 96, 128, 200, 256])
def test_batch_rounding_matches_jax(batch):
    jcfg = j_chain.ChainConfig(params=JParams(**FIELDS), iterations=6, algorithm="min-sum")
    seen = []
    for make in (lambda: j_mc.MonteCarlo(jcfg, batch_per_device=batch, steps_per_call=2),
                 lambda: t_mc.MonteCarlo(_cfg(), batch_per_device=batch,
                                         steps_per_call=2, device="cpu")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mc = make()
        seen.append((mc.batch_per_device, [w.category for w in caught],
                     [str(w.message).split(" (")[0] for w in caught]))
    jax_mc, torch_mc = seen
    assert jax_mc == torch_mc
    rounded = batch > 64 and batch % 128 != 0
    assert len(torch_mc[1]) == int(rounded)
    assert mc.blocks_per_run == torch_mc[0] * 2 == j_chain._efficient_batch(batch) * 2


def test_efficient_batch_matches_jax():
    for b in range(1, 1025):
        assert t_chain._efficient_batch(b) == j_chain._efficient_batch(b), b


def test_no_fallback_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mc.MonteCarlo(_cfg(), batch_per_device=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sweep.bler_vs_snr(A=[100], rate=[1 / 2], batch_per_device=8, verbose=False,
                            results_dir=os.devnull + ".d")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sweep.snr_vs_a(A=[1000], batch_per_device=8, verbose=False,
                         results_dir=os.devnull + ".d")
    assert t_mc.MonteCarlo(_cfg(), batch_per_device=8, device="cpu").device.type == "cpu"


SWEEP_KW = dict(A=[100], rate=[1 / 2], bg=[2], modulation="QPSK", algorithm="min-sum",
                device="cpu", verbose=False)


def test_small_sweep_gives_a_monotone_waterfall(tmp_path):
    """The quick drive of the sweep surface: BG2 A=100 R=1/2, min-sum, 10
    iterations, 20 block errors per point, down to BLER 3e-2."""
    out = t_sweep.bler_vs_snr(iterations=10, target_block_errors=20, target_bler=3e-2,
                              batch_per_device=64, results_dir=str(tmp_path), **SWEEP_KW)
    (key, pts), = out.items()
    assert key == (2, 1 / 2, 100)
    blers = [p.bler for p in pts]
    assert blers[0] > 0.9 and blers[-1] <= 3e-2 and 6 <= len(pts) <= 12
    # monotone but for sampling noise: 20 errors per point is +-22 % (1 sigma)
    assert all(b <= 1.5 * a for a, b in zip(blers, blers[1:]))
    assert all(p.block_errors >= 20 and not p.capped for p in pts[1:])
    text = (tmp_path / "BLER_vs_SNR_100_0.5_2_QPSK_10_20_0_0.txt").read_text()
    assert text == "".join(f"{p.esn0_db:f}\t{p.bler:e}\n" for p in pts if p.bler < 1)
    again = t_sweep.bler_vs_snr(iterations=10, target_block_errors=20, target_bler=3e-2,
                                batch_per_device=64, results_dir=str(tmp_path), **SWEEP_KW)
    assert [p.block_errors for p in again[key]] == [p.block_errors for p in pts]


@pytest.mark.slow
def test_sweep_matches_the_golden_curve(tmp_path):
    """BASELINE config #1 (flooding min-sum, 50 iterations, 100 block errors
    per point) down to BLER 5e-2 against the measured golden: each point
    inside the two-sample 5-sigma bound.  Slow tier: tens of thousands of
    blocks at 50 iterations through the plain decoder."""
    with open(os.path.join(ROOT, "golden", "BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json")) as f:
        golden = json.load(f)
    out = t_sweep.bler_vs_snr(iterations=50, target_block_errors=100, target_bler=5e-2,
                              batch_per_device=1024, results_dir=str(tmp_path), **SWEEP_KW)
    (_, pts), = out.items()
    assert len(pts) >= 7
    for p in pts:
        i = golden["esn0_db"].index(p.esn0_db)
        n2, e2 = golden["blocks"][i], round(golden["bler"][i] * golden["blocks"][i])
        pooled = (p.block_errors + e2) / (p.blocks + n2)
        bound = 5 * math.sqrt(pooled * (1 - pooled) * (1 / p.blocks + 1 / n2)) + 1 / p.blocks + 1 / n2
        assert abs(p.bler - e2 / n2) <= bound, (p, e2 / n2, bound)
