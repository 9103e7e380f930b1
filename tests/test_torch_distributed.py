"""The port's ``MonteCarlo`` over several ranks of a ``torch.distributed``
process group, on the CPU (gloo): the invariants of the JAX package's
``tests/test_sharding.py`` held by the port against itself.

Ranks are separate processes started through
``python -m ldpc_3gpp_tpu_torch.parallel.launcher`` (a free local port each
time: pytest-xdist runs several workers) and joined under a timeout, so a
hung rank fails the test instead of blocking the run.  Every rank must print
the same all-reduced counters, equal to the sum of single-process runs seeded
``rank_seed(seed, r)``; a group of one must change nothing.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
from ldpc_3gpp_tpu_torch.parallel import launcher
from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.utils.rng import make_generator, rank_seed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds the test waits for its ranks before it kills them
RANKS_TIMEOUT_S = 180
BATCH = 8

# BG2 A=100 G=300 QPSK, 4 iterations, min-sum: the JAX package's dryrun
# configuration, a few blocks per rank
MC_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from ldpc_3gpp_tpu_torch.parallel.launcher import init_distributed, is_primary
assert init_distributed(timeout_s=120)
from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
from ldpc_3gpp_tpu_torch.utils.rng import make_generator
seeds, esn0, batch = json.loads(sys.argv[1]), float(sys.argv[2]), int(sys.argv[3])
cfg = ChainConfig(params=LDPCParams(BG=2, A=100, G=300, Q_m=2), modulation="QPSK",
                  iterations=4, algorithm="min-sum")
mc = MonteCarlo(cfg, batch_per_device=batch, device="cpu")
runs = {}
for s in seeds:
    c = mc.run(make_generator(s, "cpu"), esn0)
    runs[s] = dict(c, iteration_hist=c["iteration_hist"].tolist())
print("RESULT " + json.dumps(dict(rank=dist.get_rank(), primary=is_primary(),
                                  world=mc.world_size, blocks_per_run=mc.blocks_per_run,
                                  runs=runs)), flush=True)
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n, argv, timeout=RANKS_TIMEOUT_S):
    """Start ``n`` ranks of ``argv`` (a worker command) through the launcher
    and return each rank's stdout; kills every rank and fails if one hangs
    past ``timeout`` or exits non-zero."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ldpc_3gpp_tpu_torch.parallel.launcher",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(rank), "--", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for rank in range(n)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank hung past {timeout} s")
    assert all(p.returncode == 0 for p in procs), outs
    return outs


def result_of(out, tag="RESULT"):
    line = next(ln for ln in out.splitlines() if ln.startswith(tag + " "))
    return json.loads(line[len(tag) + 1:])


def cfg():
    return ChainConfig(params=LDPCParams(BG=2, A=100, G=300, Q_m=2), modulation="QPSK",
                       iterations=4, algorithm="min-sum")


def single_process(seed, rank, esn0_db, batch=BATCH):
    """One process, no group, the stream of rank ``rank``."""
    mc = MonteCarlo(cfg(), batch_per_device=batch, device="cpu")
    assert not dist.is_initialized() and mc.world_size == 1
    c = mc.run(make_generator(seed, "cpu", rank=rank), esn0_db)
    return dict(c, iteration_hist=c["iteration_hist"].tolist())


def summed(runs):
    return {k: (np.sum([r[k] for r in runs], axis=0).tolist() if k == "iteration_hist"
                else sum(r[k] for r in runs)) for k in runs[0]}


def launch_mc(tmp_path, n, seeds, esn0_db):
    worker = tmp_path / "mc_worker.py"
    worker.write_text(MC_WORKER)
    outs = run_ranks(n, [sys.executable, str(worker), json.dumps(seeds), str(esn0_db),
                         str(BATCH)])
    return [result_of(o) for o in outs]


def test_two_ranks_via_the_launcher_sum_the_single_process_runs(tmp_path):
    """The port's ``test_psum_matches_manual_aggregation`` and
    ``test_two_process_distributed_counters``: both ranks print identical
    counters, the sum of the runs seeded ``rank_seed(seed, 0)`` and
    ``rank_seed(seed, 1)``."""
    res = launch_mc(tmp_path, 2, [7], 2.0)
    assert [r["rank"] for r in res] == [0, 1]
    assert [r["primary"] for r in res] == [True, False]
    assert res[0]["runs"] == res[1]["runs"]
    assert res[0]["world"] == 2 and res[0]["blocks_per_run"] == 2 * BATCH
    got = res[0]["runs"]["7"]
    want = summed([single_process(7, r, 2.0) for r in (0, 1)])
    assert got == want
    assert got["blocks"] == 2 * BATCH and 0 < got["block_errors"] < got["blocks"]


def test_three_ranks_count_every_block_once_from_streams_that_differ(tmp_path):
    """Three ranks: blocks == 3 * batch, the histogram's mass is one decode
    per block (C=1, rv (0,)), its weighted sum is ``iterations``; the ranks'
    streams differ (the counters are not three equal shares) and the totals
    are the sums of the single-process runs."""
    seeds = [0, 1, 2]
    res = launch_mc(tmp_path, 3, seeds, 2.0)
    assert all(r["runs"] == res[0]["runs"] for r in res)
    assert [r["primary"] for r in res] == [True, False, False]
    shares_differ = 0
    for s in seeds:
        c = res[0]["runs"][str(s)]
        hist = np.asarray(c["iteration_hist"])
        assert c["blocks"] == 3 * BATCH == res[0]["blocks_per_run"]
        assert hist.sum() == c["blocks"] * 1 * 1
        assert (hist * np.arange(hist.size)).sum() == c["iterations"]
        singles = [single_process(s, r, 2.0) for r in range(3)]
        assert c == summed(singles)
        shares_differ += any(x != singles[0] for x in singles[1:])
        assert 0 < c["block_errors"] < c["blocks"]
    assert shares_differ == len(seeds)
    # identical streams would make every total a multiple of 3
    assert any(res[0]["runs"][str(s)]["bit_errors"] % 3 for s in seeds)


@contextlib.contextmanager
def group_of_one(tmp_path):
    """A gloo process group of one rank in this process, destroyed on exit
    (a live default group would make every later MonteCarlo of this worker
    all-reduce)."""
    assert launcher.init_distributed(
        coordinator_address=f"file://{tmp_path / 'store'}", num_processes=1,
        process_id=0, backend="gloo", timeout_s=60)
    try:
        yield
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def counters_of(mc, seed, calls=2):
    c = mc.run_pipelined(make_generator(seed, "cpu"), 1.0, calls)
    return dict(c, iteration_hist=c["iteration_hist"].tolist())


def test_world_size_one_changes_nothing(tmp_path):
    """A group of one gives the counters of no group, bit for bit, from the
    same seed: rank 0 keeps the seed, and the all-reduce adds nothing.  A
    ``MonteCarlo`` follows the default group and keeps no hold on it: once
    the group is destroyed the same object runs without one."""
    mc = MonteCarlo(cfg(), batch_per_device=BATCH, steps_per_call=2, device="cpu")
    want = counters_of(mc, 11)
    with group_of_one(tmp_path):
        assert dist.is_initialized() and mc.world_size == 1
        assert mc.blocks_per_run == 2 * BATCH
        assert launcher.is_primary() and launcher.in_group()
        got = counters_of(mc, 11)
    assert got == want and got["blocks"] == 2 * 2 * BATCH
    assert not launcher.in_group() and counters_of(mc, 11) == want


def test_rank_seed():
    """Rank 0 keeps the seed; other ranks take a fixed 64-bit mix that does
    not collide with the next seeds' rank 0 (as seed + rank would)."""
    assert rank_seed(5, 0) == 5 and rank_seed(2**40 + 3, 0) == 2**40 + 3
    # the mix is fixed: a change would move every multi-rank stream
    assert rank_seed(0, 1) == 0x08B4FDA8C892B50E
    seeds = {rank_seed(s, r) for s in range(64) for r in range(8)}
    assert len(seeds) == 64 * 8
    assert all(0 <= x < 2**64 for x in seeds)
    with pytest.raises(ValueError):
        rank_seed(0, -1)
    # without a group make_generator draws the seed's own stream; an
    # explicit rank draws that rank's
    a = torch.rand(4, generator=make_generator(9, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=make_generator(9, "cpu", rank=0)))
    g = torch.Generator().manual_seed(rank_seed(9, 2))
    assert torch.equal(torch.rand(4, generator=make_generator(9, "cpu", rank=2)),
                       torch.rand(4, generator=g))


@pytest.mark.parametrize("world_size", [None, "1"])
def test_init_distributed_is_a_no_op_for_one_process(monkeypatch, world_size):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    if world_size is not None:
        monkeypatch.setenv("WORLD_SIZE", world_size)
    assert launcher.init_distributed() is False
    assert not dist.is_initialized()
    assert launcher.is_primary()
    assert MonteCarlo(cfg(), batch_per_device=4, device="cpu").world_size == 1


def test_init_distributed_does_not_change_backend_quietly(tmp_path):
    """A backend that cannot start raises; the launcher never falls back to
    another (here: NCCL on a machine without it)."""
    if dist.is_nccl_available() and torch.cuda.is_available():
        pytest.skip("NCCL can start here")
    with pytest.raises((RuntimeError, ValueError)):
        launcher.init_distributed(
            coordinator_address=f"file://{tmp_path / 'store'}", num_processes=1,
            process_id=0, backend="nccl", timeout_s=30)
    assert not dist.is_initialized()


@pytest.mark.parametrize("local_rank", [None, "0"], ids=["local_rank_unset", "local_rank_set"])
def test_launcher_exports_the_variables_and_execs_the_command(local_rank):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT
    if local_rank is not None:
        env["LOCAL_RANK"] = local_rank
    code = ("import json, os; print(json.dumps({k: os.environ.get(k) for k in "
            "('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK')}))")
    out = subprocess.run(
        [sys.executable, "-m", "ldpc_3gpp_tpu_torch.parallel.launcher",
         "--coordinator", "10.1.2.3:29512", "--num-processes", "4", "--process-id", "2",
         "--", sys.executable, "-c", code],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == {
        "MASTER_ADDR": "10.1.2.3", "MASTER_PORT": "29512", "WORLD_SIZE": "4",
        "RANK": "2", "LOCAL_RANK": local_rank or "2"}


@pytest.mark.parametrize("argv", [
    ["--coordinator", "h:1", "--num-processes", "2", "--process-id", "0"],
    ["--coordinator", "h:1", "--num-processes", "2", "--process-id", "0", "--"],
    ["--coordinator", "no-port", "--num-processes", "2", "--process-id", "0", "--", "true"],
], ids=["no_command", "empty_command", "bad_coordinator"])
def test_launcher_refuses_a_bad_command_line(argv, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(argv)
    assert e.value.code == 2
    assert "error" in capsys.readouterr().err
