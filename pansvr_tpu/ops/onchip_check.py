"""Device DP parity gate: the compiled scan DP vs the scalar ksw2 oracle.

The engine's DP is ops/extd2_jax (extd2_batch: one lax.scan step per
anti-diagonal; traceback_batch), dispatched through align.engine's
_device_dp for the realigner and assembly.sv_call.ContigDpBatcher for
fc_sv. This gate compiles exactly those programs on whatever backend jax
resolves (the GPU on the card, the CPU in tests) and compares every lane
with ops/ksw2_ref.extd2, the oracle pinned to the reference SSE kernel
(src/kswlib/ksw2_extd2_sse.c):

  - the realigner profile (ALN) at every engine DP class, at the
    engine's chunk widths: (48, 64) x 2048, (96, 128) x 512 and
    (176, 256) x 128 lanes;
  - the contig profile (SV) at the contig class (576, 704) x 256;
  - with more than one visible device, the sharded program
    (align.engine._sharded_dp) against the single-device one.

Distinct fuzz problems are tiled across the chunk, so every lane is
checked against the oracle answer of its source problem.

The tolerance is zero. The whole DP is int32 scores and uint8 direction
bits: there is no floating-point arithmetic and no matrix product, so
TF32 and summation order do not apply, and any difference is a bug.

tests/test_onchip.py runs this gate where a GPU is visible; chip_smoke.py
runs it on the card, and bench.py runs the quick variant first.
"""

from __future__ import annotations

import time

import numpy as np

from . import ksw2_ref
from .extd2_jax import Extd2Params, ops_to_cigar

ALN = Extd2Params()
SV = Extd2Params(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1,
                 w=132, zdrop=132)

# (profile name, Q, T, chunk lanes, distinct problems)
ENGINE_CLASSES = (
    ("aln", 48, 64, 2048, 128),
    ("aln", 96, 128, 512, 96),
    ("aln", 176, 256, 128, 64),
)
CONTIG_CLASS = ("sv", 576, 704, 256, 32)


def _mutate(rng, t, n_sub, max_gap, n_gap):
    q = list(t)
    for _ in range(n_sub):
        i = int(rng.integers(0, len(q)))
        q[i] = (q[i] + int(rng.integers(1, 4))) % 4
    for _ in range(n_gap):
        g = int(rng.integers(-max_gap, max_gap + 1))
        i = int(rng.integers(1, max(2, len(q) - abs(g) - 1)))
        if g > 0:
            q[i:i] = [int(rng.integers(0, 4)) for _ in range(g)]
        elif g < 0:
            del q[i : i - g]
    return np.array(q, np.uint8)


def class_pairs(rng, Q: int, T: int, n: int) -> list:
    """n problems that fit (Q, T): edge cases first (identical,
    one-base query, unrelated, asymmetric), then targets of random
    length with substitutions and indels."""
    pairs = []
    s = rng.integers(0, 4, min(Q, T)).astype(np.uint8)
    pairs.append((s, s.copy()))
    pairs.append((np.array([1], np.uint8), np.array([1, 2, 3], np.uint8)))
    pairs.append((rng.integers(0, 4, Q).astype(np.uint8),
                  rng.integers(0, 4, T).astype(np.uint8)))
    pairs.append((rng.integers(0, 4, max(2, Q // 10)).astype(np.uint8),
                  rng.integers(0, 4, T).astype(np.uint8)))
    pairs.append((rng.integers(0, 4, Q).astype(np.uint8),
                  rng.integers(0, 4, max(2, T // 16)).astype(np.uint8)))
    while len(pairs) < n:
        t = rng.integers(0, 4, int(rng.integers(4, T + 1))).astype(np.uint8)
        q = _mutate(rng, t[: min(len(t), Q)], int(rng.integers(0, 6)),
                    max(1, Q // 8), int(rng.integers(0, 3)))[:Q]
        if len(q):
            pairs.append((q, t))
    return pairs[:n]


def oracle(pairs, params: Extd2Params) -> list:
    return [ksw2_ref.extd2(q, t, match=params.match,
                           mismatch=params.mismatch, q=params.q, e=params.e,
                           q2=params.q2, e2=params.e2, w=params.w,
                           zdrop=params.zdrop) for q, t in pairs]


def _pad(pairs, Q, T, B):
    """Tile `pairs` over B lanes -> (qc, ql, tc, tl, source index)."""
    src = np.arange(B) % len(pairs)
    qc = np.zeros((B, Q), np.int32)
    tc = np.zeros((B, T), np.int32)
    ql = np.ones(B, np.int32)
    tl = np.ones(B, np.int32)
    for b, k in enumerate(src):
        q, t = pairs[k]
        qc[b, : len(q)] = q
        tc[b, : len(t)] = t
        ql[b] = len(q)
        tl[b] = len(t)
    return qc, ql, tc, tl, src


def compare(got: dict, ref, tag: str) -> str | None:
    """First field where a device result differs from the oracle's."""
    if got["zdropped"] != ref.zdropped:
        return f"{tag} zdropped {got['zdropped']} != {ref.zdropped}"
    if got["max"] != ref.max:
        return f"{tag} max {got['max']} != {ref.max}"
    if not ref.zdropped and got["score"] != ref.score:
        return f"{tag} score {got['score']} != {ref.score}"
    if got["mqe"] != ref.mqe:
        return f"{tag} mqe {got['mqe']} != {ref.mqe}"
    if (got["max_q"], got["max_t"]) != (ref.max_q, ref.max_t):
        return f"{tag} max endpoint"
    if got["cigar"] != ref.cigar:
        return f"{tag} cigar {got['cigar']} != {ref.cigar}"
    return None


def engine_dp(qc, ql, tc, tl, params: Extd2Params) -> list[dict]:
    """One chunk through the engine's fused DP program (_device_dp,
    then the host unpack the engine uses) -> per-lane result dicts."""
    from ..align.engine import _device_dp, _dp_unpack

    buf = np.asarray(_device_dp(qc, ql, tc, tl, params=params,
                                K=qc.shape[1] + tc.shape[1]))
    ops, packed = _dp_unpack(buf, qc.shape[0])
    return _lanes(ops, packed)


def _lanes(ops, packed) -> list[dict]:
    score, mqe, mx, mxq, mxt, zdr, i_f, j_f = packed
    return [dict(score=int(score[b]), mqe=int(mqe[b]), max=int(mx[b]),
                 max_q=int(mxq[b]), max_t=int(mxt[b]),
                 zdropped=bool(zdr[b]),
                 cigar=ops_to_cigar(ops[b], int(i_f[b]), int(j_f[b])))
            for b in range(ops.shape[0])]


def contig_dp(pairs_tiled) -> list[dict]:
    """Problems through fc_sv's device batcher (ContigDpBatcher)."""
    from ..assembly.sv_call import ContigDpBatcher

    cb = ContigDpBatcher(device=True)
    for q, t in pairs_tiled:
        cb.request(q, t)
    cb.run()
    return [dict(score=ez.score, mqe=ez.mqe, max=ez.max, max_q=ez.max_q,
                 max_t=ez.max_t, zdropped=ez.zdropped, cigar=ez.cigar)
            for ez in cb.results]


def check_class(rng, profile: str, Q: int, T: int, B: int,
                n_distinct: int) -> dict:
    """Compile + run one DP class at B lanes; compare every lane with
    the oracle. Returns a summary row; raises AssertionError on any
    mismatch (after counting them all)."""
    params = ALN if profile == "aln" else SV
    pairs = class_pairs(rng, Q, T, n_distinct)
    refs = oracle(pairs, params)
    qc, ql, tc, tl, src = _pad(pairs, Q, T, B)
    t0 = time.perf_counter()
    if profile == "sv":
        got = contig_dp([pairs[k] for k in src])
    else:
        got = engine_dp(qc, ql, tc, tl, params)
    first_s = time.perf_counter() - t0
    bad = [m for m in (compare(g, refs[k], f"{profile} {Q}x{T} lane {b}")
                       for b, (g, k) in enumerate(zip(got, src))) if m]
    row = dict(profile=profile, Q=Q, T=T, lanes=B, distinct=len(pairs),
               mismatches=len(bad), first_call_s=first_s)
    if bad:
        raise AssertionError(f"{len(bad)} mismatching lanes: {bad[:3]}")
    return row


def check_sharded_dp(pairs, params: Extd2Params, Q: int = 176,
                     T: int = 256, lanes_per_device: int = 16) -> int:
    """_sharded_dp over all visible devices vs the single-device scan
    body (bit parity) and vs the oracle. Returns lanes checked, 0 when
    only one device is visible."""
    import jax
    from jax.sharding import Mesh

    from ..align.engine import _dp_scan_body, _sharded_dp

    devs = jax.devices()
    if len(devs) < 2:
        return 0
    B = len(devs) * lanes_per_device
    qc, ql, tc, tl, src = _pad(pairs, Q, T, B)
    mesh = Mesh(np.array(devs), ("data",))
    fn = _sharded_dp(mesh, params, Q + T)
    ops_s, packed_s = (np.asarray(x) for x in fn(qc, ql, tc, tl))
    ops_1, packed_1 = (np.asarray(x) for x in jax.jit(
        _dp_scan_body, static_argnums=(4, 5))(qc, ql, tc, tl, params,
                                              Q + T))
    if not (np.array_equal(packed_s, packed_1)
            and np.array_equal(ops_s, ops_1)):
        raise AssertionError("sharded DP differs from the single-device "
                             "program")
    refs = oracle(pairs, params)
    bad = [m for m in (compare(g, refs[k], f"sharded lane {b}")
                       for b, (g, k) in enumerate(
                           zip(_lanes(ops_s, packed_s), src))) if m]
    if bad:
        raise AssertionError(f"{len(bad)} sharded lanes differ from the "
                             f"oracle: {bad[:3]}")
    return B


def run_onchip_parity(quick: bool = False, seed: int = 10) -> dict:
    """The whole gate. quick: the smallest engine class only. Returns
    {"classes": [summary rows], "sharded_dp": lanes or 0}."""
    rng = np.random.default_rng(seed)
    classes = ENGINE_CLASSES[:1] if quick else ENGINE_CLASSES + (
        CONTIG_CLASS,)
    rows = [check_class(rng, *c) for c in classes]
    out = {"classes": rows, "sharded_dp": 0}
    if not quick:
        out["sharded_dp"] = check_sharded_dp(
            class_pairs(rng, 176, 256, 24), ALN)
    return out
