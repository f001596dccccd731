"""Fuzz our NumPy extd2 reference against the compiled reference kernel."""

import subprocess

import numpy as np
import pytest

from pansvr_tpu.ops import ksw2_ref

from . import ksw2_oracle
from .ksw2_oracle import run_extd2


@pytest.fixture(scope="module", autouse=True)
def _oracle_built():
    """The oracle compiles the reference kernel's source; skip (like the
    fixtures in conftest.py) where that source is not present."""
    try:
        ksw2_oracle.get_lib()
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("reference ksw2 source not available to build the "
                    "oracle (tools/build_reference.sh)")


PANSVR_ALN = dict(match=2, mismatch=-12, q=16, e=1, q2=32, e2=0, w=200, zdrop=400)
PANSVR_SV = dict(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1, w=132, zdrop=132)


def _mutate(rng, seq, n_sub, gaps):
    s = list(seq)
    for _ in range(n_sub):
        i = rng.integers(0, len(s))
        s[i] = (s[i] + rng.integers(1, 4)) % 4
    for glen in gaps:
        i = int(rng.integers(1, max(2, len(s) - abs(glen) - 1)))
        if glen > 0:
            for _ in range(glen):
                s.insert(i, int(rng.integers(0, 4)))
        else:
            del s[i : i - glen]
    return np.array(s, dtype=np.uint8)


def _check_case(query, target, params):
    ez_ref, cigar_ref = run_extd2(query, target, **params)
    ez = ksw2_ref.extd2(query, target, **params)
    assert ez.zdropped == ez_ref.zdropped, "zdropped mismatch"
    assert ez.max == ez_ref.max, f"max {ez.max} != {ez_ref.max}"
    if not ez_ref.zdropped:
        assert ez.score == ez_ref.score, f"score {ez.score} != {ez_ref.score}"
    assert ez.mqe == ez_ref.mqe
    assert (ez.max_q, ez.max_t) == (ez_ref.max_q, ez_ref.max_t)
    assert ez.cigar == cigar_ref, f"cigar {ez.cigar} != {cigar_ref}"


@pytest.mark.parametrize("params", [PANSVR_ALN, PANSVR_SV], ids=["aln", "sv"])
def test_identical_sequences(params):
    rng = np.random.default_rng(0)
    for n in [1, 5, 20, 150, 500]:
        s = rng.integers(0, 4, size=n).astype(np.uint8)
        _check_case(s, s.copy(), params)


@pytest.mark.parametrize("params", [PANSVR_ALN, PANSVR_SV], ids=["aln", "sv"])
def test_substitutions(params):
    rng = np.random.default_rng(1)
    for trial in range(30):
        n = int(rng.integers(10, 300))
        t = rng.integers(0, 4, size=n).astype(np.uint8)
        q = _mutate(rng, t, n_sub=int(rng.integers(0, 1 + n // 10)), gaps=[])
        _check_case(q, t, params)


@pytest.mark.parametrize("params", [PANSVR_ALN, PANSVR_SV], ids=["aln", "sv"])
def test_indels(params):
    rng = np.random.default_rng(2)
    for trial in range(40):
        n = int(rng.integers(30, 300))
        t = rng.integers(0, 4, size=n).astype(np.uint8)
        gaps = [int(rng.integers(-30, 31)) for _ in range(int(rng.integers(1, 3)))]
        gaps = [g for g in gaps if g != 0]
        q = _mutate(rng, t, n_sub=int(rng.integers(0, 5)), gaps=gaps)
        if len(q) == 0:
            continue
        _check_case(q, t, params)


@pytest.mark.parametrize("params", [PANSVR_ALN, PANSVR_SV], ids=["aln", "sv"])
def test_random_unrelated(params):
    # unrelated sequences exercise zdrop and band-edge paths
    rng = np.random.default_rng(3)
    for trial in range(20):
        q = rng.integers(0, 4, size=int(rng.integers(5, 200))).astype(np.uint8)
        t = rng.integers(0, 4, size=int(rng.integers(5, 200))).astype(np.uint8)
        _check_case(q, t, params)


def test_asymmetric_lengths():
    rng = np.random.default_rng(4)
    for qlen, tlen in [(10, 190), (190, 10), (1, 50), (50, 1), (149, 179)]:
        t = rng.integers(0, 4, size=tlen).astype(np.uint8)
        q = rng.integers(0, 4, size=qlen).astype(np.uint8)
        _check_case(q, t, PANSVR_ALN)


def test_long_deletion_dual_gap():
    # a 100 bp deletion must choose the second gap channel (cost 32 not 116)
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, size=300).astype(np.uint8)
    q = np.concatenate([t[:100], t[200:]])
    _check_case(q, t, PANSVR_ALN)
    ez = ksw2_ref.extd2(q, t, **PANSVR_ALN)
    assert ("D", 100) in ez.cigar
    assert ez.score == 200 * 2 - 32
