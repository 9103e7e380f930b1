"""``ldpc_3gpp_tpu_torch.entry``, the counterpart of ``__graft_entry__.py``:
the flagship step on the CPU, the multi-rank dryrun with every assertion of
its five configurations (two gloo ranks, spawned), a dryrun whose ranks
outlive its timeout fails, and nothing runs on the CPU unasked."""
import pytest
import torch

from ldpc_3gpp_tpu_torch import entry as t_entry
from ldpc_3gpp_tpu_torch.utils import rng
from ldpc_3gpp_tpu_torch.utils.rng import make_generator

torch.set_num_threads(1)


def test_entry_fn_runs_the_flagship_batch_on_the_cpu(monkeypatch):
    # entry() makes its example generator on the card; stand in for it so
    # that the test gets ``fn`` on a machine without one
    monkeypatch.setattr(rng, "make_generator",
                        lambda seed, device="cuda", rank=None: ("generator", seed, device))
    fn, example_args = t_entry.entry()
    assert example_args == (("generator", 0, "cuda"), 2.0)
    out = fn(make_generator(0, "cpu"), 2.0)
    assert len(out) == 4 and all(isinstance(t, torch.Tensor) for t in out)
    blocks, block_errors, bit_errors, iterations = (int(t) for t in out)
    assert blocks == 8
    assert 0 <= block_errors <= 8 and 0 <= bit_errors <= 8 * 8448
    assert 8 <= iterations <= 8 * 12


def test_entry_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_entry.entry()


def test_dryrun_multichip_two_ranks():
    """Every assertion of the five configurations on two gloo ranks; the
    counters are the same on both ranks, the kernel configuration ('auto',
    layered) equals the plain decoder's on the same seed, and on the CPU
    no kernel is launched."""
    records = t_entry.dryrun_multichip(2, device="cpu")
    assert len(records) == 2
    counters = records[0]["counters"]
    assert records[1]["counters"] == counters
    assert list(counters) == ["bg2_a100", "multi_cb_harq", "nl_lbrm", "kernel",
                              "per_stage_cbgti"]
    assert counters["bg2_a100"]["blocks"] == counters["kernel"]["blocks"] == 8
    assert counters["multi_cb_harq"]["blocks"] == counters["per_stage_cbgti"]["blocks"] == 4
    assert all(n == 0 for r in records for n in r["launches"].values())


def test_dryrun_multichip_kills_ranks_past_its_timeout():
    with pytest.raises(TimeoutError):
        t_entry.dryrun_multichip(2, device="cpu", timeout_s=0.5)
