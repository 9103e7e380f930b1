"""The port's own copy of the spec tables and every numpy plan function equal
the JAX package's originals.  Tolerance: exact (integers and table data)."""
import functools
import os

import numpy as np
import pytest
import torch

from ldpc_3gpp_tpu.ops import crc as j_crc
from ldpc_3gpp_tpu.ops import decoder_fast as j_fast
from ldpc_3gpp_tpu.ops import encoder as j_enc
from ldpc_3gpp_tpu.ops import modulation as j_mod
from ldpc_3gpp_tpu.ops import rate_match as j_rm
from ldpc_3gpp_tpu.spec import params as j_params
from ldpc_3gpp_tpu.spec import tables as j_tables
from ldpc_3gpp_tpu_torch.ops import crc as t_crc
from ldpc_3gpp_tpu_torch.ops import decoder_fast as t_fast
from ldpc_3gpp_tpu_torch.ops import encoder as t_enc
from ldpc_3gpp_tpu_torch.ops import modulation as t_mod
from ldpc_3gpp_tpu_torch.ops import rate_match as t_rm
from ldpc_3gpp_tpu_torch.spec import params as t_params
from ldpc_3gpp_tpu_torch.spec import tables as t_tables

torch.set_num_threads(1)

# (BG, A, G, Q_m, rv_id, I_LBRM, TBS_LBRM, CBGTI)
PARAM_GRID = [
    (1, 44, 132, 1, 0, 0, None, ()),
    (2, 100, 300, 2, 0, 0, None, ()),
    (2, 100, 300, 2, 2, 0, None, ()),
    (2, 400, 1200, 2, 3, 0, None, ()),
    (2, 3842, 11526, 2, 1, 0, None, ()),
    (1, 8424, 25272, 2, 0, 0, None, ()),
    (1, 8424, 16848, 6, 2, 0, None, ()),
    (1, 20004, 60012, 4, 0, 0, None, ()),
    (1, 20004, 60012, 2, 1, 1, 12000, ()),
    (1, 20004, 60000, 8, 3, 0, None, (1,)),
    (2, 7650, 22950, 2, 2, 1, 6000, (0, 2)),
    (1, 4000, 6000, 2, 2, 1, 4000, ()),
    (2, 100, 4000, 2, 0, 0, None, ()),
]

DERIVED = [
    name for name, attr in vars(j_params.LDPCParams).items()
    if isinstance(attr, functools.cached_property)
]


def _pair(fields):
    BG, A, G, Q_m, rv, lbrm, tbs, cbgti = fields
    kw = dict(BG=BG, A=A, G=G, Q_m=Q_m, rv_id=rv, I_LBRM=lbrm,
              TBS_LBRM=tbs, CBGTI=cbgti)
    return j_params.LDPCParams(**kw), t_params.LDPCParams(**kw)


def _same(x, y):
    """Equality over nested tuples/lists of ints and numpy arrays."""
    if isinstance(x, (tuple, list)):
        assert isinstance(y, (tuple, list)) and len(x) == len(y)
        for xi, yi in zip(x, y):
            _same(xi, yi)
    elif isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    else:
        assert x == y


def test_base_graphs_npz_is_a_byte_copy():
    with open(j_tables._DATA, "rb") as f, open(t_tables._DATA, "rb") as g:
        assert f.read() == g.read()
    assert os.path.dirname(j_tables._DATA) != os.path.dirname(t_tables._DATA)


def test_tables_equal():
    assert j_tables.LIFTING_SETS == t_tables.LIFTING_SETS
    assert j_tables.ALL_LIFTING_SIZES == t_tables.ALL_LIFTING_SIZES
    assert j_tables.CRC_POLYNOMIALS == t_tables.CRC_POLYNOMIALS
    assert j_tables.BG_DIMS == t_tables.BG_DIMS
    for bg in (1, 2):
        for i_ls in range(8):
            _same(j_tables.base_graph(bg, i_ls), t_tables.base_graph(bg, i_ls))


@pytest.mark.parametrize("fields", PARAM_GRID, ids=str)
def test_params_derived_fields_equal(fields):
    assert len(DERIVED) >= 25
    pj, pt = _pair(fields)
    for name in DERIVED:
        _same(getattr(pj, name), getattr(pt, name))
    _same(pj.with_tx(rv_id=1).k_0, pt.with_tx(rv_id=1).k_0)
    assert hash(pt) == hash(_pair(fields)[1])


def test_invalid_params_raise_like_the_original():
    for kw in (dict(BG=3), dict(Q_m=3), dict(A=100, G=301, Q_m=2),
               dict(BG=1, A=20004, G=60012, Q_m=4, CBGTI=(0, 1, 2))):
        with pytest.raises(j_tables.UnsupportedParameters):
            j_params.LDPCParams(**kw)
        with pytest.raises(t_tables.UnsupportedParameters):
            t_params.LDPCParams(**kw)


@pytest.mark.parametrize("crc,length", [
    ("CRC24A", 8424), ("CRC24B", 300), ("CRC16", 100)])
@pytest.mark.parametrize("shifted", [True, False])
def test_remainder_table_equal(crc, length, shifted):
    _same(j_crc._remainder_table(crc, length, shifted),
          t_crc._remainder_table(crc, length, shifted))


@pytest.mark.parametrize("fields", PARAM_GRID, ids=str)
def test_graph_plans_equal(fields):
    pj, pt = _pair(fields)
    _same(j_enc._encode_plan(pj), t_enc._encode_plan(pt))
    _same(j_fast._row_plan(pj), t_fast._row_plan(pt))


@pytest.mark.parametrize("fields", PARAM_GRID, ids=str)
def test_rate_match_plans_equal(fields):
    pj, pt = _pair(fields)
    _same(j_rm._cycle_geometry(pj), t_rm._cycle_geometry(pt))
    for E in sorted({e for e in pj.E_r if e} | {7, 3 * pj.N_cb + 5}):
        _same(j_rm.selection_indices(pj, E), t_rm.selection_indices(pt, E))


@pytest.mark.parametrize("modulation", j_mod.MODULATIONS)
def test_constellation_equal(modulation):
    _same(j_mod.constellation(modulation), t_mod.constellation(modulation))
    assert j_mod.Q_M == t_mod.Q_M
