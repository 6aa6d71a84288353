"""The recorded JAX references of the port's parity tests (tests/jax_refs.py).

* Every case jax_refs.py defines has a record under tests/data/jax_refs/,
  no record lacks its case, and each record's manifest (jax and jaxlib
  versions, the SHA-256 of blackhole_tpu/'s files, XLA_FLAGS and x64)
  matches this process: no JAX compile.
* A record whose manifest differs fails load() with a message that says
  how to rewrite the records.
* Marked slow (pytest -m slow tests/test_jax_refs.py): each case rebuilt
  live under the suite's configuration against its record, integer
  and string arrays (result codes, step counts, orders, tier names) equal and floats within
  their tolerance in jax_refs.py, a tenth of the tightest any test
  applies to them.
"""

import json

import numpy as np
import pytest

import jax_refs

CASES = sorted(jax_refs.CASES)


def test_every_case_has_a_record_and_every_record_a_case():
    records = sorted(p.stem for p in jax_refs.DATA.glob("*.npz"))
    assert records == CASES


@pytest.mark.parametrize("case", CASES)
def test_every_float_array_has_a_tolerance(case):
    _, arrays = jax_refs.read(case)
    for k, a in arrays.items():
        if a.dtype.kind == "f":
            rtol, atol = jax_refs.tolerance(case, k)
            assert 0.0 <= rtol < 1e-2 and 0.0 <= atol < 1e-2, k


@pytest.mark.parametrize("case", CASES)
def test_record_manifest_matches_this_process(case):
    recorded, arrays = jax_refs.read(case)
    assert recorded == jax_refs.manifest(case)
    assert arrays


def test_a_changed_manifest_fails_with_how_to_rewrite(tmp_path, monkeypatch):
    case = CASES[0]
    recorded, arrays = jax_refs.read(case)
    stale = dict(recorded, jax="0.0.0")
    monkeypatch.setattr(jax_refs, "DATA", tmp_path)
    np.savez_compressed(jax_refs.path(case),
                        manifest=np.array(json.dumps(stale)), **arrays)
    with pytest.raises(AssertionError, match="python tests/jax_refs.py"):
        jax_refs.load(case)


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES)
def test_record_rebuilds_live(case):
    _, want = jax_refs.read(case)
    got = jax_refs.CASES[case]()
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind in "iubU":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            rtol, atol = jax_refs.tolerance(case, k)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)
