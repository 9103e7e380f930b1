"""The sweeps under several ranks (gloo, on the CPU): every rank gets
the same points, only rank 0 opens and writes the results file, the resume
decision is rank 0's and every rank follows it, and one process writes what
it wrote before (a group of one changes no byte).

Each rank is given its own results directory, so that a file written by a
rank other than 0, or a resume decision taken from a rank's own disk, shows:
rank 1's directory must stay absent, and rank 1 must skip the points that
only rank 0's file records.
"""
import dataclasses
import json
import sys

from ldpc_3gpp_tpu_torch.parallel import sweep as t_sweep
from test_torch_distributed import group_of_one, result_of, run_ranks

SWEEP_KW = dict(A=[100], rate=[1 / 2], bg=[2], modulation="QPSK", iterations=4,
                algorithm="min-sum", target_block_errors=4, target_bler=0.1,
                esn0_start=0.0, esn0_delta=1.0, batch_per_device=16, device="cpu")
SNR_VS_A_KW = dict(A=[100, 200], rate=[1 / 2], bg=2, modulation="QPSK", iterations=4,
                   algorithm="min-sum", target_block_errors=4, target_bler=0.1,
                   esn0_start=1.0, esn0_delta=0.5, batch_per_device=16, device="cpu")
BLER_FILE = "BLER_vs_SNR_100_0.5_2_QPSK_4_4_0_0.txt"

WORKER = r"""
import dataclasses, json, os, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from ldpc_3gpp_tpu_torch.parallel.launcher import init_distributed
assert init_distributed(timeout_s=120)
from ldpc_3gpp_tpu_torch.parallel.sweep import bler_vs_snr, snr_vs_a
root, resume, kw, kw_a = sys.argv[1], sys.argv[2] == "1", json.loads(sys.argv[3]), json.loads(sys.argv[4])
results_dir = os.path.join(root, f"rank{dist.get_rank()}")
curves = bler_vs_snr(results_dir=results_dir, resume=resume, **kw)
points = [dataclasses.asdict(p) for pts in curves.values() for p in pts]
out = dict(points=points)
if kw_a:
    out["snr_vs_a"] = {str(r): c for r, c in snr_vs_a(results_dir=results_dir, **kw_a).items()}
print("RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def run_sweep_ranks(tmp_path, resume=False, with_snr_vs_a=False):
    worker = tmp_path / "sweep_worker.py"
    worker.write_text(WORKER)
    outs = run_ranks(2, [sys.executable, str(worker), str(tmp_path / "out"),
                         "1" if resume else "0", json.dumps(SWEEP_KW),
                         json.dumps(SNR_VS_A_KW if with_snr_vs_a else {})])
    return outs, [result_of(o) for o in outs]


def lines_of(points):
    return "".join(f"{p['esn0_db']:f}\t{p['block_errors'] / max(p['blocks'], 1):e}\n"
                   for p in points if p["block_errors"] < p["blocks"])


def test_two_ranks_take_the_same_points_and_rank_0_writes(tmp_path):
    outs, (r0, r1) = run_sweep_ranks(tmp_path, with_snr_vs_a=True)
    assert r0 == r1
    pts = r0["points"]
    assert len(pts) >= 2 and pts[-1]["block_errors"] / pts[-1]["blocks"] <= 0.1
    assert all(p["blocks"] % 32 == 0 for p in pts)  # 2 ranks x 16 per call
    assert (tmp_path / "out" / "rank0" / BLER_FILE).read_text() == lines_of(pts)
    assert not (tmp_path / "out" / "rank1").exists()
    # snr_vs_a: the same curve on both ranks, one file, from rank 0
    (curve,) = r0["snr_vs_a"].values()
    assert [a for a, _ in curve] == [100, 200]
    text = (tmp_path / "out" / "rank0" / "SNR_vs_A_0.1_0.5_2_QPSK_4_4_0.txt").read_text()
    assert text == "".join(f"{a}\t{e:f}\n" for a, e in curve)
    # only rank 0 prints
    assert "Es/N0=" in outs[0] and "Es/N0=" not in outs[1]


def test_two_ranks_resume_from_rank_0s_file(tmp_path):
    """Rank 0's partial file (two points and a torn last line) is repaired
    and its points skipped on both ranks; rank 1, whose directory holds no
    file, skips the same points, or its all-reduces would pair with other
    points than rank 0's."""
    d = tmp_path / "out" / "rank0"
    d.mkdir(parents=True)
    kept = "0.000000\t9.000000e-01\n1.000000\t8.000000e-01\n"
    (d / BLER_FILE).write_text(kept + "2.0000")
    outs, (r0, r1) = run_sweep_ranks(tmp_path, resume=True)
    assert r0 == r1
    esn0s = [p["esn0_db"] for p in r0["points"]]
    assert esn0s[0] == 2.0 and 0.0 not in esn0s and 1.0 not in esn0s
    assert (d / BLER_FILE).read_text() == kept + lines_of(r0["points"])
    assert "resume: skipping +0.00 dB" in outs[0] and "resume" not in outs[1]
    assert not (tmp_path / "out" / "rank1").exists()


def test_one_process_writes_what_it_wrote_before(tmp_path):
    """No group and a group of one write the same bytes and return the same
    points (the results-file format itself is held against the JAX package
    by tests/test_torch_sweep.py)."""
    solo = t_sweep.bler_vs_snr(results_dir=str(tmp_path / "solo"), verbose=False, **SWEEP_KW)
    with group_of_one(tmp_path):
        grouped = t_sweep.bler_vs_snr(results_dir=str(tmp_path / "group"), verbose=False,
                                      **SWEEP_KW)
    as_dicts = lambda c: {k: [dataclasses.asdict(p) for p in v] for k, v in c.items()}
    assert as_dicts(solo) == as_dicts(grouped)
    text = (tmp_path / "solo" / BLER_FILE).read_text()
    assert text == (tmp_path / "group" / BLER_FILE).read_text()
    (pts,) = as_dicts(solo).values()
    assert text == lines_of(pts) and len(pts) >= 2
