"""Device (JAX) extd2 vs the NumPy reference implementation.

Two tracebacks are covered: the host `traceback` over the returned
direction matrix, and the engine's device `traceback_batch` + the
`ops_to_cigar` decode, at every engine DP class and the long-target
contig case."""

import numpy as np
import pytest

from pansvr_tpu.ops import ksw2_ref
from pansvr_tpu.ops.extd2_jax import (
    Extd2Params,
    extd2_batch,
    ops_to_cigar,
    traceback,
    traceback_batch,
)

ALN = Extd2Params()  # panSVR realignment profile
SV = Extd2Params(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1, w=132, zdrop=132)


def _pad_batch(pairs, Q, T):
    B = len(pairs)
    qc = np.zeros((B, Q), np.int32)
    tc = np.zeros((B, T), np.int32)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (q, t) in enumerate(pairs):
        qc[i, : len(q)] = q
        tc[i, : len(t)] = t
        ql[i] = len(q)
        tl[i] = len(t)
    return qc, ql, tc, tl


def _run_and_compare(pairs, params, Q=160, T=192):
    qc, ql, tc, tl = _pad_batch(pairs, Q, T)
    res = extd2_batch(qc, ql, tc, tl, params=params)
    for i, (q, t) in enumerate(pairs):
        ref = ksw2_ref.extd2(
            q, t, match=params.match, mismatch=params.mismatch,
            q=params.q, e=params.e, q2=params.q2, e2=params.e2,
            w=params.w, zdrop=params.zdrop,
        )
        assert bool(res.zdropped[i]) == ref.zdropped, f"case {i} zdropped"
        assert int(res.max[i]) == ref.max, f"case {i} max"
        if not ref.zdropped:
            assert int(res.score[i]) == ref.score, f"case {i} score"
        assert int(res.mqe[i]) == ref.mqe, f"case {i} mqe"
        assert (int(res.max_q[i]), int(res.max_t[i])) == (ref.max_q, ref.max_t)
        # traceback from the same endpoint the reference uses
        if not ref.zdropped:
            cig = traceback(res.dmat[i], res.st_arr[i], res.en_arr[i],
                            len(t) - 1, len(q) - 1)
        elif ref.max_t >= 0 and ref.max_q >= 0:
            cig = traceback(res.dmat[i], res.st_arr[i], res.en_arr[i],
                            ref.max_t, ref.max_q)
        else:
            cig = []
        assert cig == ref.cigar, f"case {i} cigar {cig} != {ref.cigar}"


@pytest.mark.parametrize("params", [ALN, SV], ids=["aln", "sv"])
def test_batch_mixed_cases(params):
    rng = np.random.default_rng(10)
    pairs = []
    # identical
    s = rng.integers(0, 4, 120).astype(np.uint8)
    pairs.append((s, s.copy()))
    # substitutions
    t = rng.integers(0, 4, 150).astype(np.uint8)
    q = t.copy()
    q[[10, 50, 90]] = (q[[10, 50, 90]] + 1) % 4
    pairs.append((q, t))
    # deletion
    t = rng.integers(0, 4, 180).astype(np.uint8)
    pairs.append((np.concatenate([t[:60], t[100:]]), t))
    # insertion
    t2 = rng.integers(0, 4, 120).astype(np.uint8)
    ins = rng.integers(0, 4, 25).astype(np.uint8)
    pairs.append((np.concatenate([t2[:40], ins, t2[40:]]), t2))
    # unrelated (zdrop territory)
    pairs.append((
        rng.integers(0, 4, 100).astype(np.uint8),
        rng.integers(0, 4, 150).astype(np.uint8),
    ))
    # tiny
    pairs.append((np.array([1], np.uint8), np.array([1, 2, 3], np.uint8)))
    # asymmetric
    pairs.append((rng.integers(0, 4, 10).astype(np.uint8),
                  rng.integers(0, 4, 180).astype(np.uint8)))
    pairs.append((rng.integers(0, 4, 155).astype(np.uint8),
                  rng.integers(0, 4, 12).astype(np.uint8)))
    _run_and_compare(pairs, params)


def test_fuzz_vs_numpy_ref():
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(24):
        n = int(rng.integers(20, 150))
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = list(t)
        for _ in range(int(rng.integers(0, 6))):
            i = int(rng.integers(0, len(q)))
            q[i] = (q[i] + int(rng.integers(1, 4))) % 4
        for _ in range(int(rng.integers(0, 3))):
            g = int(rng.integers(-20, 21))
            i = int(rng.integers(1, max(2, len(q) - abs(g) - 1)))
            if g > 0:
                q[i:i] = [int(rng.integers(0, 4)) for _ in range(g)]
            elif g < 0:
                del q[i : i - g]
        if not q:
            continue
        pairs.append((np.array(q, np.uint8), t))
    _run_and_compare(pairs, ALN)


def _run_device_traceback(pairs, params, Q, T):
    """extd2_batch + traceback_batch (the engine's DP program) vs the
    oracle, end point chosen exactly as engine._dp_scan_body does."""
    qc, ql, tc, tl = _pad_batch(pairs, Q, T)
    res = extd2_batch(qc, ql, tc, tl, params=params)
    zdr = np.asarray(res.zdropped)
    mxt, mxq = np.asarray(res.max_t), np.asarray(res.max_q)
    i0 = np.where(~zdr, tl - 1, np.where(mxt >= 0, mxt, -1)).astype(np.int32)
    j0 = np.where(~zdr, ql - 1, np.where(mxq >= 0, mxq, -1)).astype(np.int32)
    ops, i_f, j_f = (np.asarray(x) for x in traceback_batch(
        res.dmat, res.st_arr, res.en_arr, i0, j0, K=Q + T))
    for i, (q, t) in enumerate(pairs):
        ref = ksw2_ref.extd2(
            q, t, match=params.match, mismatch=params.mismatch,
            q=params.q, e=params.e, q2=params.q2, e2=params.e2,
            w=params.w, zdrop=params.zdrop,
        )
        assert bool(zdr[i]) == ref.zdropped, f"case {i} zdropped"
        assert int(res.max[i]) == ref.max, f"case {i} max"
        if not ref.zdropped:
            assert int(res.score[i]) == ref.score, f"case {i} score"
        assert int(res.mqe[i]) == ref.mqe, f"case {i} mqe"
        assert (int(mxq[i]), int(mxt[i])) == (ref.max_q, ref.max_t), \
            f"case {i} max endpoint"
        cig = ops_to_cigar(ops[i], int(i_f[i]), int(j_f[i])) \
            if i0[i] >= 0 else []
        assert cig == ref.cigar, f"case {i} cigar {cig} != {ref.cigar}"


def _mixed_pairs(rng):
    pairs = []
    s = rng.integers(0, 4, 120).astype(np.uint8)
    pairs.append((s, s.copy()))
    t = rng.integers(0, 4, 150).astype(np.uint8)
    q = t.copy()
    q[[10, 50, 90]] = (q[[10, 50, 90]] + 1) % 4
    pairs.append((q, t))
    t = rng.integers(0, 4, 180).astype(np.uint8)
    pairs.append((np.concatenate([t[:60], t[100:]]), t))
    t2 = rng.integers(0, 4, 120).astype(np.uint8)
    ins = rng.integers(0, 4, 25).astype(np.uint8)
    pairs.append((np.concatenate([t2[:40], ins, t2[40:]]), t2))
    pairs.append((rng.integers(0, 4, 100).astype(np.uint8),
                  rng.integers(0, 4, 150).astype(np.uint8)))
    pairs.append((np.array([1], np.uint8), np.array([1, 2, 3], np.uint8)))
    pairs.append((rng.integers(0, 4, 10).astype(np.uint8),
                  rng.integers(0, 4, 180).astype(np.uint8)))
    pairs.append((rng.integers(0, 4, 155).astype(np.uint8),
                  rng.integers(0, 4, 12).astype(np.uint8)))
    return pairs


def _edited_pairs(rng, n, len_lo, len_hi, qmax, n_sub, max_gap, n_gap,
                  min_q=1):
    """Targets of random length; queries = the target (cut to qmax) with
    up to n_sub substitutions and n_gap indels of up to max_gap bases."""
    pairs = []
    for _ in range(n):
        t = rng.integers(0, 4, int(rng.integers(len_lo, len_hi))
                         ).astype(np.uint8)
        q = list(t[:qmax])
        for _ in range(int(rng.integers(0, n_sub))):
            i = int(rng.integers(0, len(q)))
            q[i] = (q[i] + int(rng.integers(1, 4))) % 4
        for _ in range(int(rng.integers(0, n_gap))):
            g = int(rng.integers(-max_gap, max_gap + 1))
            i = int(rng.integers(1, max(2, len(q) - abs(g) - 1)))
            if g > 0:
                q[i:i] = [int(rng.integers(0, 4)) for _ in range(g)]
            elif g < 0:
                del q[i : i - g]
        q = np.array(q[:qmax], np.uint8)
        if len(q) < min_q:
            q = np.array([0, 1], np.uint8)
        pairs.append((q, t))
    return pairs


# (case sets, scoring profile, Q, T): mixed edge cases under both
# profiles, fuzz at the full 160-read class, the long-target contig case
# (T >> band), and the engine's (96, 128) and (48, 64) classes
DEVICE_CASES = {
    "mixed-aln": (lambda: _mixed_pairs(np.random.default_rng(10)),
                  ALN, 176, 256),
    "mixed-sv": (lambda: _mixed_pairs(np.random.default_rng(10)),
                 SV, 176, 256),
    "fuzz": (lambda: _edited_pairs(np.random.default_rng(11), 24, 20, 150,
                                   150, 6, 20, 3), ALN, 176, 256),
    "long-targets-sv": (lambda: _edited_pairs(
        np.random.default_rng(12), 8, 500, 900, 900, 10, 40, 3),
        SV, 960, 912),
    "class-96x128": (lambda: _edited_pairs(np.random.default_rng(13), 24, 8,
                                           128, 96, 5, 15, 3),
                     ALN, 96, 128),
    "class-48x64": (lambda: _edited_pairs(np.random.default_rng(17), 24, 4,
                                          64, 48, 4, 8, 2, min_q=2),
                    ALN, 48, 64),
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_device_traceback_vs_oracle(case):
    make, params, Q, T = DEVICE_CASES[case]
    _run_device_traceback(make(), params, Q, T)
