"""State carried across from the JAX package.

The system has no weights.  Its state is the code parameters and the HARQ
buffers; these helpers move both between the two packages as plain Python /
numpy values, so a HARQ process can start in one package and continue in the
other.  The decoder has no parameters of its own, in either schedule and with
any check rule or message type.  A ``ChainConfig`` needs no helper: apart
from ``params`` its fields are plain values with the same names and defaults
in both packages (``algorithm``, ``schedule``, ``message_dtype``,
``alpha_schedule`` included), so it carries across field by field
(tests/test_torch_chain_default.py).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from .models.decoder import HARQState
from .spec.params import LDPCParams
from .utils.device import resolve_device

PARAM_FIELDS = (
    "BG", "A", "G", "Q_m", "N_L", "rv_id", "I_LBRM", "TBS_LBRM", "CBGTI",
)


def params_from_fields(fields: Mapping) -> LDPCParams:
    """``LDPCParams`` from its nine constructor fields as plain values.

    Missing fields take the constructor's defaults; unknown names raise.
    """
    unknown = set(fields) - set(PARAM_FIELDS)
    if unknown:
        raise ValueError(f"unknown LDPCParams fields: {sorted(unknown)}")
    kw = {}
    for name, value in fields.items():
        if name == "CBGTI":
            kw[name] = tuple(int(i) for i in value)
        elif name == "TBS_LBRM":
            kw[name] = None if value is None else int(value)
        else:
            kw[name] = int(value)
    return LDPCParams(**kw)


def params_to_fields(params) -> dict:
    """The nine constructor fields of an ``LDPCParams`` (of either package)."""
    return {name: getattr(params, name) for name in PARAM_FIELDS}


def harq_state_from_numpy(d_buf, b_buf, cb_ok, device="cuda") -> HARQState:
    """HARQ buffers from numpy arrays: d_buf (..., C, N_cb) float32,
    b_buf (..., B) int8, cb_ok (..., C) bool."""
    dev = resolve_device(device)
    # torch.tensor copies: the state never aliases the caller's arrays
    return HARQState(
        d_buf=torch.tensor(np.asarray(d_buf), dtype=torch.float32, device=dev),
        b_buf=torch.tensor(np.asarray(b_buf), dtype=torch.int8, device=dev),
        cb_ok=torch.tensor(np.asarray(cb_ok), dtype=torch.bool, device=dev),
    )


def harq_state_to_numpy(state: HARQState) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of ``harq_state_from_numpy``: (d_buf, b_buf, cb_ok) arrays."""
    return tuple(t.detach().cpu().numpy() for t in state)
