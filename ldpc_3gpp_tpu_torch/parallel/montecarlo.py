"""Data-parallel Monte-Carlo engine.

The counterpart of the JAX package's ``parallel/montecarlo.py``.  The
reference's parallelism story is "run N MATLAB instances with different seeds
and merge text files by hand" (plot_BLER_vs_SNR.m:23-27).  Here every rank of
a ``torch.distributed`` process group (one process per GPU, the counterpart
of a device of the JAX mesh) simulates its own sub-batch from its own stream
(``utils.rng.make_generator`` folds the rank into the seed), and the
counters are summed over the group: ``run`` simulates ``batch_per_device *
world_size * steps_per_call`` transport blocks and returns the same host-side
integer counters on every rank.

The counters are summed on the device in int64, all-reduced (SUM) over the
group and fetched once per ``run`` (once per window for ``run_pipelined``):
one host synchronisation per call, however many steps it spans.  Without a
process group (or with a group of one) the all-reduce changes nothing and
the counters are those of one process.  Ranks start through ``torchrun`` or
``parallel/launcher.py``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.chain import ChainConfig, _efficient_batch, simulate_batch
from ..utils.device import resolve_device
from .launcher import in_group, world_size


@dataclasses.dataclass
class MonteCarlo:
    """Monte-Carlo runner for one link configuration.

    ``run(generator, esn0_db)`` simulates ``blocks_per_run`` transport blocks
    over the process group, each rank's with bits and noise drawn from its
    ``generator`` (a ``torch.Generator`` on ``device``; see
    ``utils.rng.make_generator``, which seeds each rank's stream apart), and
    returns the counters summed over the group.
    """

    cfg: ChainConfig
    #: requested blocks per rank and step.  NOTE: values > 64 that are not multiples
    #: of 128 are rounded UP to the next multiple of 128 at construction, as
    #: in the JAX package, so that both simulate the same number of blocks per
    #: call — read ``batch_per_device`` after construction (or
    #: ``blocks_per_run``) for the effective value; a UserWarning is emitted
    #: when rounding changes the number.
    batch_per_device: int = 128
    steps_per_call: int = 1  # simulation steps per call; each draws fresh blocks/noise
    #: runs on a CUDA device (the rank's own after ``init_distributed``)
    #: unless the caller asks for the CPU.  Several ranks may share one GPU
    #: only under gloo: NCCL refuses two ranks on one device.
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        eff = _efficient_batch(self.batch_per_device)
        if eff != self.batch_per_device:
            warnings.warn(
                f"MonteCarlo: batch_per_device {self.batch_per_device} -> "
                f"{eff} (rounded up to a multiple of 128, as the JAX package "
                "does; counters report actual blocks simulated — size "
                "expectations from .blocks_per_run)",
                UserWarning,
                stacklevel=3,
            )
            self.batch_per_device = eff

    @property
    def world_size(self) -> int:
        """Ranks the counters are summed over: the default group's (the JAX
        class's ``mesh``), 1 without one."""
        return world_size()

    @property
    def blocks_per_run(self) -> int:
        return self.batch_per_device * self.world_size * self.steps_per_call

    def _accumulate(self, generator: torch.Generator, esn0_db: float, calls: int):
        """Counters of ``calls * steps_per_call`` steps, summed on the device:
        an int64 tensor [blocks, block_errors, bit_errors, iterations,
        iteration_hist...].  Does not synchronise."""
        acc = torch.zeros(
            (4 + self.cfg.iterations + 1,), dtype=torch.int64, device=self.device
        )
        for _ in range(calls * self.steps_per_call):
            r = simulate_batch(
                self.cfg, generator, esn0_db, self.batch_per_device, device=self.device
            )
            acc += torch.cat([
                torch.stack([r.blocks, r.block_errors, r.bit_errors, r.iterations]),
                r.iteration_hist,
            ])
        return acc

    def _fetch(self, acc: torch.Tensor) -> Dict[str, Union[int, np.ndarray]]:
        """Sum ``acc`` over the group (in int64: ``bit_errors`` overflows
        int32 at BLER ~ 1 within one large call) and copy it to the host."""
        if in_group():
            dist.all_reduce(acc, op=dist.ReduceOp.SUM)
        host = acc.cpu().numpy()  # the call's one host synchronisation
        return {
            "blocks": int(host[0]),
            "block_errors": int(host[1]),
            "bit_errors": int(host[2]),
            "iterations": int(host[3]),
            "iteration_hist": host[4:].astype(np.int64),
        }

    def run(self, generator: torch.Generator, esn0_db: float
            ) -> Dict[str, Union[int, np.ndarray]]:
        """Counters of one call summed over the group; all values are Python
        ints except 'iteration_hist', which is an (iterations+1,) int64
        ndarray.  Every rank must call it: it all-reduces."""
        return self._fetch(self._accumulate(generator, esn0_db, 1))

    def run_pipelined(self, generator: torch.Generator, esn0_db: float, calls: int
                      ) -> Dict[str, Union[int, np.ndarray]]:
        """``calls`` calls summed into ONE host fetch: the device is given
        the whole window before the host waits for any of it.  Same value
        types as ``run``; equal to the sum of ``calls`` ``run``s on the same
        generator."""
        return self._fetch(self._accumulate(generator, esn0_db, calls))
