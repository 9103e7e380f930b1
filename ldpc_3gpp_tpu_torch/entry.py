"""Entry points, the counterpart of the repository's ``__graft_entry__.py``.

- ``entry()``: one full TS38.212 link-chain Monte-Carlo batch on the flagship
  configuration (encode -> modulate -> AWGN -> LLR demod -> BP decode ->
  counters) for BG1 A=8448 rate-1/3 QPSK, min-sum, 12 iterations, batch 8.
- ``dryrun_multichip(n)``: ``MonteCarlo`` over ``n`` ranks of a gloo process
  group (spawned processes, a ``file://`` rendezvous in a temporary
  directory) on small shapes, five configurations, with the counters checked
  to be the same on every rank.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List

#: seconds ``dryrun_multichip`` waits for its ranks before it kills them
DRYRUN_TIMEOUT_S = 600.0


def entry():
    """``(fn, example_args)``: ``fn(generator, esn0_db)`` runs
    ``simulate_batch`` at the flagship on the generator's device and returns
    (blocks, block_errors, bit_errors, iterations) as tensors;
    ``example_args`` is ``(make_generator(0, "cuda"), 2.0)`` (raises where
    there is no GPU)."""
    from .models.chain import ChainConfig, simulate_batch
    from .spec.params import LDPCParams
    from .utils.rng import make_generator

    # Flagship: BG1 long-block config (BASELINE.json config #2), min-sum.
    A, rate, qm = 8448, 1 / 3, 2
    G = round(A / rate / qm) * qm
    params = LDPCParams(BG=1, A=A, G=G, Q_m=qm)
    cfg = ChainConfig(
        params=params,
        modulation="QPSK",
        rv_sequence=(0,),
        iterations=12,
        algorithm="min-sum",
    )

    def fn(generator, esn0_db):
        r = simulate_batch(cfg, generator, esn0_db, 8, device=generator.device)
        return r.blocks, r.block_errors, r.bit_errors, r.iterations

    example_args = (make_generator(0, "cuda"), 2.0)
    return fn, example_args


def _counters(c) -> Dict:
    return {k: (v.tolist() if k == "iteration_hist" else v) for k, v in c.items()}


def _dryrun_configs(n_devices: int, device) -> Dict[str, Dict]:
    """The five configurations of ``__graft_entry__.dryrun_multichip`` on the
    current process group, with its assertions; returns their counters."""
    from .models.chain import ChainConfig
    from .parallel.montecarlo import MonteCarlo
    from .spec.params import LDPCParams
    from .utils.rng import make_generator

    out = {}
    params = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cfg = ChainConfig(params=params, modulation="QPSK", iterations=4, algorithm="min-sum")
    mc = MonteCarlo(cfg, batch_per_device=4, device=device)
    counters = mc.run(make_generator(0, device), 3.0)
    assert counters["blocks"] == 4 * n_devices, counters
    out["bg2_a100"] = counters

    # C=3 code blocks + a 2-stage HARQ rv sequence: per-CB iteration arrays,
    # the iteration histogram under stop-on-success accounting and the HARQ
    # buffers carried between rv stages, all summed over the ranks.
    params_mc = LDPCParams(BG=2, A=7650, G=22950, Q_m=2)
    assert params_mc.C == 3
    cfg_mc = ChainConfig(params=params_mc, modulation="QPSK", rv_sequence=(0, 2),
                         iterations=3, algorithm="min-sum")
    c2 = MonteCarlo(cfg_mc, batch_per_device=2, device=device).run(
        make_generator(1, device), 6.0)
    blocks = 2 * n_devices
    assert c2["blocks"] == blocks, c2
    # every (block, CB) decodes once at rv 0; blocks that fail rv 0 decode
    # their CBs again at rv 2: never more than 2x, never less than 1x
    mass = int(c2["iteration_hist"].sum())
    assert blocks * params_mc.C <= mass <= 2 * blocks * params_mc.C, c2
    assert c2["iterations"] <= 2 * blocks * params_mc.C * cfg_mc.iterations
    out["multi_cb_harq"] = c2

    # N_L=2 with LBRM limiting the soft buffer (N_cb < N): the buffer-limited
    # rate matching on every rank.
    params_lb = LDPCParams(BG=2, A=320, G=1920, Q_m=2, N_L=2, I_LBRM=1, TBS_LBRM=480)
    assert params_lb.N_cb < params_lb.N
    cfg_lb = ChainConfig(params=params_lb, modulation="QPSK", iterations=3,
                         algorithm="min-sum")
    c3 = MonteCarlo(cfg_lb, batch_per_device=2, device=device).run(
        make_generator(2, device), 6.0)
    assert c3["blocks"] == 2 * n_devices, c3
    out["nl_lbrm"] = c3

    # The kernel itself on every rank: backend 'auto' with the layered
    # schedule launches the layered kernel on a GPU (its plain version on the
    # CPU); its counters must equal the plain decoder's ('fast') on the same
    # seed and device, bit for bit.
    ck = {}
    for backend in ("auto", "fast"):
        cfg_k = ChainConfig(params=params, modulation="QPSK", iterations=4,
                            algorithm="min-sum", backend=backend, schedule="layered")
        ck[backend] = MonteCarlo(cfg_k, batch_per_device=4, device=device).run(
            make_generator(0, device), 3.0)
    assert ck["auto"]["blocks"] == 4 * n_devices, ck
    assert _counters(ck["auto"]) == _counters(ck["fast"]), ck
    out["kernel"] = ck["auto"]

    # Per-stage CBGTI HARQ: the retransmission excludes code block 0, so E_r
    # redistributes over the scheduled blocks and the excluded CB rides the
    # latched b_hat / HARQ buffer (NRLDPC.m:471-482, NRLDPCDecoder.m:286-318).
    cfg_cb = ChainConfig(params=params_mc, modulation="QPSK", rv_sequence=(0, 2),
                         cbgti_sequence=((), (0,)), iterations=3, algorithm="min-sum")
    cc = MonteCarlo(cfg_cb, batch_per_device=2, device=device).run(
        make_generator(3, device), 6.0)
    assert cc["blocks"] == 2 * n_devices, cc
    out["per_stage_cbgti"] = cc
    return out


def _dryrun_rank(rank: int, n_devices: int, device: str, tmp: str) -> None:
    """One rank of ``dryrun_multichip``: joins the gloo group, runs the five
    configurations and writes their counters and its kernel launches to
    ``tmp/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    from .ops import decoder_cuda
    from .parallel.launcher import init_distributed

    torch.set_num_threads(1)
    init_distributed(coordinator_address="file://" + os.path.join(tmp, "store"),
                     num_processes=n_devices, process_id=rank, backend="gloo")
    try:
        decoder_cuda.reset_launches()
        counters = _dryrun_configs(n_devices, device)
        if device != "cpu":
            torch.cuda.synchronize()
        rec = {"counters": {k: _counters(c) for k, c in counters.items()},
               "launches": dict(decoder_cuda.LAUNCHES)}
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> List[Dict]:
    """Run the five configurations on ``n_devices`` ranks (spawned processes,
    gloo) and check that every rank returns the same counters.

    The ranks share the current GPU (gloo, since NCCL refuses two ranks on
    one device); ``device="cpu"`` runs them on the host, and without a GPU
    nothing else does (raises).  Returns each rank's record:
    ``{"counters": {config: counters}, "launches": {kernel: count}}``.
    Raises if a rank fails, or kills them all and raises after
    ``timeout_s`` seconds.
    """
    import torch.multiprocessing as mp

    from .utils.device import resolve_device

    device = resolve_device(device).type
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_dryrun_rank, args=(n_devices, device, tmp),
                                 nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"dryrun_multichip({n_devices}): ranks still running after "
                        f"{timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        records = []
        for rank in range(n_devices):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                records.append(json.load(f))
    counters = [r["counters"] for r in records]
    if any(c != counters[0] for c in counters):
        raise AssertionError(f"ranks returned different counters: {counters}")
    for name, c in counters[0].items():
        print(f"dryrun_multichip({n_devices}) {name}: {c}")
    return records
