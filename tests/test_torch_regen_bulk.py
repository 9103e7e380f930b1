"""The bulk stages of the port's golden pipeline (``regen_goldens`` ``bulk``,
``bulksp``, ``bulklbrm``, ``bulkcbgti``) run tiny on the CPU: each runs the
port's bulk tool in a subprocess, as the JAX stages run theirs, and writes an
artifact with its JAX golden's keys, the port's stamp and the device named."""
import json
import os

import pytest
import torch

from ldpc_3gpp_tpu_torch.tools import regen_goldens as rg
from ldpc_3gpp_tpu_torch.utils.fingerprint import semantics_fingerprint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {"bulk": "bulk_montecarlo.json", "bulksp": "bulk_sp_montecarlo.json",
         "bulklbrm": "bulk_lbrm_montecarlo.json", "bulkcbgti": "bulk_cbgti_montecarlo.json"}
TINY = dict(blocks=16, batch_per_device=16, steps_per_call=1)


@pytest.mark.parametrize("stage", list(FILES))
def test_bulk_stage_writes_the_jax_goldens_keys(stage, tmp_path):
    # CBGTI needs two code blocks: BG2 A=4000 has C=2 (the protocol's 7650 has 3)
    kw = dict(TINY, A=4000) if stage == "bulkcbgti" else TINY
    rec = rg.run_stage(stage, str(tmp_path), "cpu", str(tmp_path), **kw)
    with open(tmp_path / FILES[stage]) as f:
        art = json.load(f)
    with open(os.path.join(ROOT, "golden", FILES[stage])) as f:
        golden = json.load(f)
    assert set(art) == set(golden)
    assert set(art["config"]) >= set(golden["config"])
    protocol = getattr(rg, stage.upper())
    for key in ("A", "modulation", "iterations", "algorithm", "schedule"):
        assert art["config"][key] == kw.get(key, protocol[key]), key
    assert art["config"]["esn0_db"] == protocol["esn0"]
    assert art["semantics"] == semantics_fingerprint()
    assert art["blocks"] == rec["blocks"] == 16
    assert "the host CPU" in art["description"] and "CUT" in art["description"]
    assert rec["launches"] == {"ldpc_layered": 0, "ldpc_flooding": 0}
