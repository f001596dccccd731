"""Device-resident (HBM) form of the RdBG index.

Flat int32 arrays uploaded once and shared by all seeding batches. The
unitig and reference sequences are packed 16 bases per uint32 word
(MSB-first) so MEM extension can compare 16 bases per XOR+clz step —
the TPU analog of the reference's 64-bit bit-parallel compare
(deBGA_index.cpp:116-128).

int64 is avoided throughout (TPU int32 lanes; x64 disabled): k-mer keys
are handled as (first-level bucket, low-bits residue) pairs which each
fit 32 bits for k=22 / search_k=20 / first_level >= 12.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import jax
import jax.numpy as jnp
import numpy as np

from .builder import RdBGIndex


def pack_u32(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> uint32 words, 16 bases/word, MSB-first (int32 view)."""
    n = len(codes)
    n_words = (n + 15) // 16
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:n] = codes & 3
    mat = padded.reshape(n_words, 16)
    shifts = np.uint32(2) * (np.uint32(15) - np.arange(16, dtype=np.uint32))
    return (mat << shifts).sum(axis=1, dtype=np.uint32).view(np.int32)


_ARRAY_FIELDS = (
    "hash_g", "kmer_g", "off_g", "uni_seqf", "uni_posp", "uni_pos",
    "uni_words", "ref_words",
    "ent_uid", "ent_off_l", "ent_off_r",
    "ent_pos_n", "uni_words_pad", "ent_run", "ent_pack",
    "ent_bucket", "ent_res",
)
_STATIC_FIELDS = (
    "k", "search_k", "first_level_bases", "uni_len", "ref_len",
    "n_kmer", "n_uni", "max_bucket_bits",
)

PAD_WORDS = 128  # zero words padded on BOTH sides of uni_words_pad;
                 # must exceed the largest extension step count (NE = 99
                 # for the 1600 read class) so ext="rows" window bases
                 # stay non-negative


@dataclass(frozen=True)
class DeviceIndex:
    """Pytree: arrays are leaves, scalar metadata is static aux data (so
    jitted consumers can use the ints in shapes/static expressions)."""
    k: int
    search_k: int
    first_level_bases: int
    hash_g: jnp.ndarray     # (4^FL + 1,) int32 bucket starts
    kmer_g: jnp.ndarray     # (n_kmer,) int32 low-bit residues
    off_g: jnp.ndarray      # (n_kmer,) int32 k-mer offsets in unitig space
    uni_seqf: jnp.ndarray   # (n_uni + 1,) int32
    uni_posp: jnp.ndarray   # (n_uni + 1,) int32
    uni_pos: jnp.ndarray    # (n_occ,) int32 0-based occurrence starts
    uni_words: jnp.ndarray  # packed unitig sequence, 16 bases/int32 word
    uni_len: int
    ref_words: jnp.ndarray  # packed reference (N->2), 16 bases/int32 word
    ref_len: int
    n_kmer: int
    n_uni: int
    # per-entry precomputed lookups (replace searchsorted/posp chains)
    ent_uid: jnp.ndarray
    ent_off_l: jnp.ndarray   # off - uni_seqf[uid]
    ent_off_r: jnp.ndarray   # uni_seqf[uid+1] - off - search_k
    ent_pos_n: jnp.ndarray   # occurrence count of the entry's unitig
    ent_run: jnp.ndarray     # equal-key run length starting at the entry
                             # (valid at run starts, i.e. at lower bounds)
    # packed per-entry record, (n_kmer, 4) int32 rows so one 16-byte row
    # gather replaces 5 separate table gathers (fewer, wider gathers):
    #   [0] off_g  [1] ent_uid  [2] ent_off_l
    #   [3] min(ent_off_r, 2047) | min(ent_pos_n, 2^21-1) << 11
    # the off_r clamp is lossless (its only use is
    # max_right = min(off_r, read_len - o - sk) with read_len <= 1600);
    # the pos_n clamp is far above the 8000 abort threshold
    ent_pack: jnp.ndarray
    # per-entry (first-level bucket, search-k residue) sort keys for the
    # sort-merge-join probe (seed_reads_flat probe="sortjoin"): the
    # whole entry table rides in ONE lax.sort against the batch's query
    # keys instead of per-lane dependent-gather bisects. Padded slots
    # hold INT32_MAX so they sort after every real key.
    ent_bucket: jnp.ndarray
    ent_res: jnp.ndarray
    uni_words_pad: jnp.ndarray  # uni_words with PAD_WORDS zero words both ends
    max_bucket_bits: int = 24   # ceil(log2(largest first-level bucket))


jax.tree_util.register_pytree_node(
    DeviceIndex,
    lambda d: (
        tuple(getattr(d, f) for f in _ARRAY_FIELDS),
        tuple(getattr(d, f) for f in _STATIC_FIELDS),
    ),
    lambda aux, children: DeviceIndex(
        **dict(zip(_ARRAY_FIELDS, children)), **dict(zip(_STATIC_FIELDS, aux))
    ),
)


def _pad_pow2(a: np.ndarray, fill, min_size: int = 256) -> np.ndarray:
    """Pad a 1-D array to the next power-of-two size bucket. Quantized
    shapes let every anchor reference of similar size share the same
    compiled device programs — otherwise each world recompiles the
    whole front."""
    n = len(a)
    target = max(min_size, 1 << max(n - 1, 0).bit_length())
    if target == n:
        return a
    out = np.full(target, fill, a.dtype)
    out[:n] = a
    return out


def to_device(idx: RdBGIndex) -> DeviceIndex:
    packed_ref = np.where(idx.ref_codes >= 4, np.uint8(2), idx.ref_codes)
    packed_uni = np.where(idx.uni_codes >= 4, np.uint8(2), idx.uni_codes)
    bucket_sizes = np.diff(idx.hash_g)
    max_bucket = int(bucket_sizes.max()) if len(bucket_sizes) else 1
    mbb = max(int(np.ceil(np.log2(max(max_bucket, 2)))) + 1, 4)
    mbb = (mbb + 3) // 4 * 4      # quantize (part of the jit cache key)
    ent_uid = (np.searchsorted(idx.uni_seqf, idx.off_g, side="right") - 1)
    ent_uid = np.clip(ent_uid, 0, max(idx.n_unitigs - 1, 0))
    ent_off_l = idx.off_g - idx.uni_seqf[ent_uid]
    ent_off_r = idx.uni_seqf[ent_uid + 1] - idx.off_g - idx.search_k
    ent_pos_n = idx.uni_posp[ent_uid + 1] - idx.uni_posp[ent_uid]
    # equal-key run lengths within each first-level bucket: the flat
    # front reads count = ent_run[lower_bound] instead of running a
    # second (upper-bound) bisect
    n_k = len(idx.kmer_g)
    if n_k:
        keys = idx.kmer_g.view(np.int32) >> np.int32(
            2 * (idx.k - idx.search_k))
        bucket_of = np.repeat(
            np.arange(len(idx.hash_g) - 1, dtype=np.int64),
            np.diff(idx.hash_g).astype(np.int64))
        new_run = np.ones(n_k, bool)
        new_run[1:] = (keys[1:] != keys[:-1]) | \
            (bucket_of[1:] != bucket_of[:-1])
        run_id = np.cumsum(new_run) - 1
        starts = np.nonzero(new_run)[0]
        run_len = np.diff(np.append(starts, n_k))
        ent_run = run_len[run_id].astype(np.int32)
        ent_bucket = bucket_of.astype(np.int32)
        ent_res = keys.astype(np.int32)
    else:
        ent_run = np.zeros(0, np.int32)
        ent_bucket = np.zeros(0, np.int32)
        ent_res = np.zeros(0, np.int32)
    off_r_c = np.minimum(ent_off_r, 2047).astype(np.int32)
    pos_n_c = np.minimum(ent_pos_n, (1 << 21) - 1).astype(np.int32)
    ent_pack = np.stack([
        _pad_pow2(idx.off_g.astype(np.int32), 0),
        _pad_pow2(ent_uid.astype(np.int32), 0),
        _pad_pow2(ent_off_l.astype(np.int32), 0),
        _pad_pow2((off_r_c | (pos_n_c << 11)).astype(np.int32), 0),
    ], axis=1)
    uni_words32 = _pad_pow2(pack_u32(packed_uni), 0)
    uni_words_pad = np.concatenate([
        np.zeros(PAD_WORDS, np.int32), uni_words32,
        np.zeros(PAD_WORDS, np.int32),
    ])
    # entry-table pads: kmer_g/uni_seqf pad with INT32_MAX (sorts after
    # every real key/offset), uni_posp repeats its last value (pad
    # unitigs get occurrence count 0), the rest pad with 0 — padded
    # slots are only ever read through clipped indices of masked lanes
    i32max = np.int32(0x7FFFFFFF)
    posp = idx.uni_posp.astype(np.int32)
    posp_last = posp[-1] if len(posp) else np.int32(0)
    return DeviceIndex(
        ent_uid=jnp.asarray(_pad_pow2(ent_uid.astype(np.int32), 0)),
        ent_off_l=jnp.asarray(_pad_pow2(ent_off_l.astype(np.int32), 0)),
        ent_off_r=jnp.asarray(_pad_pow2(ent_off_r.astype(np.int32), 0)),
        ent_pos_n=jnp.asarray(_pad_pow2(ent_pos_n.astype(np.int32), 0)),
        ent_run=jnp.asarray(_pad_pow2(ent_run, 0)),
        ent_bucket=jnp.asarray(_pad_pow2(ent_bucket, i32max)),
        ent_res=jnp.asarray(_pad_pow2(ent_res, i32max)),
        ent_pack=jnp.asarray(ent_pack),
        uni_words_pad=jnp.asarray(uni_words_pad),
        max_bucket_bits=mbb,
        k=idx.k,
        search_k=idx.search_k,
        first_level_bases=idx.first_level_bases,
        hash_g=jnp.asarray(idx.hash_g.astype(np.int32)),
        kmer_g=jnp.asarray(_pad_pow2(idx.kmer_g.view(np.int32), i32max)),
        off_g=jnp.asarray(_pad_pow2(idx.off_g.astype(np.int32), 0)),
        uni_seqf=jnp.asarray(_pad_pow2(idx.uni_seqf.astype(np.int32),
                                       i32max)),
        uni_posp=jnp.asarray(_pad_pow2(posp, posp_last)),
        uni_pos=jnp.asarray(_pad_pow2(idx.uni_pos.astype(np.int32), 0)),
        uni_words=jnp.asarray(uni_words32),
        uni_len=int(len(uni_words32)) * 16,
        ref_words=jnp.asarray(_pad_pow2(pack_u32(packed_ref), 0)),
        # the scalar metadata is static aux data (part of the jit cache
        # key), so it is quantized to the padded sizes; every device use
        # is a clip bound, for which the padded size is equivalent
        ref_len=int(len(_pad_pow2(pack_u32(packed_ref), 0))) * 16,
        n_kmer=int(len(_pad_pow2(idx.kmer_g.view(np.int32), i32max))),
        n_uni=int(len(_pad_pow2(posp, posp_last))) - 1,
    )
