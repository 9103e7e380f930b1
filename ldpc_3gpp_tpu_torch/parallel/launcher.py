"""Multi-process launch support.

The reference's multi-machine story is "start N MATLAB processes by hand with
different seeds and merge the text files" (plot_BLER_vs_SNR.m:23-27).  Here
every process (rank) simulates its own sub-batch on its own GPU, with its own
stream (``utils.rng.rank_seed``), and ``MonteCarlo`` sums the counters over a
``torch.distributed`` process group before its one host fetch, so every rank
sees the same totals and takes the same host decisions.

One node with eight GPUs, through torch's own launcher:

    torchrun --nproc-per-node=8 my_sweep.py

or one command per process, through this module (on several nodes, one
command per process with the address of process 0's host):

    python -m ldpc_3gpp_tpu_torch.parallel.launcher --coordinator HOST0:29500 \\
        --num-processes 8 --process-id $RANK -- python my_sweep.py

The launcher exports torch's own variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and, unless it is set, ``LOCAL_RANK``) and execs the
command, so the worker's ``init_distributed()`` (no arguments) works the same
under both:

    from ldpc_3gpp_tpu_torch.parallel.launcher import init_distributed
    init_distributed()
    ...run sweeps as usual...

Only rank 0 writes results files (``is_primary()``); the counters are
all-reduced, so every rank sees identical totals.
"""
from __future__ import annotations

import datetime
import os
from typing import Callable, Optional

#: seconds a collective may wait before the group raises: a rank that hangs
#: or dies then fails the others instead of blocking them for ever
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Initialise the default ``torch.distributed`` process group; returns
    whether this call made it (the caller then destroys it at its end).

    Arguments default to torch's variables (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), which both ``torchrun`` and the CLI below
    export.  Without an explicit ``num_processes`` a world size of 1 or
    none is a single process and nothing is initialised, as in the JAX
    package; an explicit ``num_processes=1`` makes a group of one.  A
    default group that exists already is left as it is.
    ``coordinator_address`` is ``host:port`` or an ``init_method`` URL
    (``tcp://...``, ``file://...``).

    The backend is ``nccl`` where CUDA is available and ``gloo`` on the CPU,
    unless ``backend`` names one; a backend that fails to start raises (no
    other backend is tried).  With CUDA the process's device becomes
    ``LOCAL_RANK % device_count`` (``LOCAL_RANK`` defaults to the rank).
    Every collective of the group times out after ``timeout_s`` seconds.
    """
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        if num_processes <= 1:
            return False
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def in_group() -> bool:
    """Whether the default process group is initialised: the group that
    ``MonteCarlo`` sums over, that ``make_generator`` folds the rank of and
    that ``decided_on_primary`` broadcasts over."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default group, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if in_group() else 1


def is_primary() -> bool:
    """True without a process group, else whether this is rank 0."""
    import torch.distributed as dist

    return not in_group() or dist.get_rank() == 0


def decided_on_primary(decide: Callable[[], object]) -> object:
    """``decide()`` run on rank 0 only and its result (or the exception it
    raised) broadcast to every rank of the default group, so that no rank
    takes a host-state decision alone.  Without a group of more than one
    rank, just ``decide()``."""
    import torch.distributed as dist

    if world_size() == 1:
        return decide()
    box = [None]
    if dist.get_rank() == 0:
        try:
            box[0] = (True, decide())
        except Exception as e:  # re-raised on every rank below
            box[0] = (False, e)
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if not ok:
        raise value
    return value


def main(argv: Optional[list] = None) -> None:
    """CLI: export torch's cluster variables and exec the worker command."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.parallel.launcher",
        description="Launch one worker of a multi-process simulation: "
        "exports MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK "
        "(read by init_distributed()) and execs COMMAND.",
    )
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0's rendezvous store")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="worker command (prefix with -- )")
    args = ap.parse_args(argv)

    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no worker command given (append: -- python my_sweep.py)")
    host, sep, port = args.coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        ap.error(f"--coordinator must be host:port, got {args.coordinator!r}")

    os.environ["MASTER_ADDR"] = host
    os.environ["MASTER_PORT"] = port
    os.environ["WORLD_SIZE"] = str(args.num_processes)
    os.environ["RANK"] = str(args.process_id)
    os.environ.setdefault("LOCAL_RANK", str(args.process_id))
    os.execvp(cmd[0], cmd)


if __name__ == "__main__":
    main()
