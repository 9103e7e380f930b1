"""Monte-Carlo engine for one link configuration on one device.

The counterpart of the JAX package's ``parallel/montecarlo.py`` for one
process and one device: ``run`` simulates ``batch_per_device *
steps_per_call`` transport blocks and returns host-side integer counters.
The counters are summed on the device in int64 and fetched once per ``run``
(once per window for ``run_pipelined``): one host synchronisation per call,
however many steps it spans.

The multi-device half of the JAX class (the mesh, ``shard_map``, ``psum`` and
the per-device key fold) is still to port with ``torch.distributed``
(ROADMAP.md queue A.6).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Union

import numpy as np
import torch

from ..models.chain import ChainConfig, _efficient_batch, simulate_batch
from ..utils.device import resolve_device


@dataclasses.dataclass
class MonteCarlo:
    """Monte-Carlo runner for one link configuration.

    ``run(generator, esn0_db)`` simulates ``blocks_per_run`` transport blocks
    with bits and noise drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; see ``utils.rng.make_generator``).
    """

    cfg: ChainConfig
    #: requested blocks per step.  NOTE: values > 64 that are not multiples
    #: of 128 are rounded UP to the next multiple of 128 at construction, as
    #: in the JAX package, so that both simulate the same number of blocks per
    #: call — read ``batch_per_device`` after construction (or
    #: ``blocks_per_run``) for the effective value; a UserWarning is emitted
    #: when rounding changes the number.
    batch_per_device: int = 128
    steps_per_call: int = 1  # simulation steps per call; each draws fresh blocks/noise
    #: runs on a CUDA device unless the caller asks for the CPU
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
    def blocks_per_run(self) -> int:
        return self.batch_per_device * self.steps_per_call

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

    @staticmethod
    def _fetch(acc: torch.Tensor) -> Dict[str, Union[int, np.ndarray]]:
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
        """Counters of one call; all values are Python ints except
        'iteration_hist', which is an (iterations+1,) int64 ndarray."""
        return self._fetch(self._accumulate(generator, esn0_db, 1))

    def run_pipelined(self, generator: torch.Generator, esn0_db: float, calls: int
                      ) -> Dict[str, Union[int, np.ndarray]]:
        """``calls`` calls summed into ONE host fetch: the device is given
        the whole window before the host waits for any of it.  Same value
        types as ``run``; equal to the sum of ``calls`` ``run``s on the same
        generator."""
        return self._fetch(self._accumulate(generator, esn0_db, calls))
