"""The fused Phase B scan, ``kernels.scan_chunk`` (K4 fused with the
unpack, hashing and count-table lookup before it), on the CPU, where the
wrapper takes its plain version: equal bit for bit to the JAX package's
``_scan_ref_fused`` chunk by chunk; the host's coder masks through a numpy
emulation of the kernel's bit-plane hashing (its words, funnel shifts and
bit reversal) equal to ``kmer_hashes_masked``; and the wrapper's checks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palace_tpu.ops.count_table import table_shape
from palace_tpu.ops.kmer import perm_to_key
from palace_tpu.search import eref as jeref
from palace_tpu_torch.io.fasta import write_fasta
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.kmer import (
    coder_masks,
    kmer_hashes_masked,
    make_choose_coder,
    pack_codes_mask,
    seq_to_codes,
)
from palace_tpu_torch.ops.window import bucket_len, window_thresholds
from palace_tpu_torch.search import index

#: a base each coder reads as 0 (coder0: C/G, coder1: G/T, coder2: C/T)
ZERO_BASE = "CGT"
U32 = 0xFFFFFFFF


def _zero_slot_kmer(perm, slot):
    """A valid k-mer whose forward hash in ``slot`` is 0, so its canonical
    hash there is 0: at each offset z a base that coder perm[z, slot]
    reads as 0."""
    return "".join(ZERO_BASE[int(c)] for c in perm[:, slot])


def _world(tmp_path, k, rng):
    """A phagedb of several length buckets: N runs, IUPAC and lower-case
    bases, references shorter than k and of k + 1, k-mers built from the
    coder permutation so that a slot's canonical hash is 0, and a
    reference whose slice's tail holds the next one's bytes."""
    perm = make_choose_coder(k, seed=1)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def bases(n):
        return bytes(lut[rng.integers(0, 4, n)]).decode()

    zeros = "".join(_zero_slot_kmer(perm, s) + bases(7) for s in range(3)) * 4
    seqs = [
        bases(900) + zeros + bases(1500),
        bases(300) + "N" * 40 + bases(700) + "RYKM" * 10 + bases(2000).lower(),
        bases(k - 3),
        bases(k + 1),
        bases(4100),
        bases(5000) + "n" * 700 + bases(300),
        bases(9000),
        bases(4096),
        bases(2000),
    ]
    db = tmp_path / "db.fa"
    write_fasta(db, [(f"r{i}", s) for i, s in enumerate(seqs)])
    idx = index.build_index(db, k=k, save=False)
    np.testing.assert_array_equal(idx.perm, perm)
    return idx, zeros


def _table(k, rng):
    """Counts 0-3, mostly 3, and 3 in slot 0, so that reading slot 0 would
    hit."""
    t = rng.choice(np.arange(4, dtype=np.uint8), size=1 << k, p=[0.05, 0.05, 0.1, 0.8])
    t[0] = 3
    return t


def _chunks(idx):
    """Every reference, short ones included, by length bucket, two pad rows
    a chunk: (target, (rows, 3) int64 offsets)."""
    by_bucket = {}
    for r, L in enumerate(idx.lengths):
        by_bucket.setdefault(bucket_len(int(L)), []).append(r)
    out = []
    for target, refs in sorted(by_bucket.items()):
        offs = np.zeros((len(refs) + 2, 3), np.int64)
        offs[:len(refs)] = np.stack([idx.code_offsets[refs], idx.mask_offsets[refs],
                                     idx.lengths[refs]], axis=1)
        out.append((target, offs))
    return out


def _buffers(idx):
    """The packed phagedb padded by the largest slice, as DeviceDB and the
    JAX package pad it."""
    slack = max(bucket_len(int(L)) for L in idx.lengths)
    return np.pad(idx.packed, (0, slack // 4)), np.pad(idx.maskbits, (0, slack // 8))


SETTINGS = [  # (window, hit_ratio, perfect_hit_ratio)
    (50, 0.5, 0.2),
    (1, 1.0, 1.0),   # a flag is one position's trio: slot-0 reads would show
    (1, 1.0, 0.0),   # ... and its single
]


@pytest.mark.parametrize("k", [20, 7])
def test_scan_chunk_equals_jax_chunk_by_chunk(tmp_path, k):
    rng = np.random.default_rng(k)
    idx, zeros = _world(tmp_path, k, rng)
    table = _table(k, rng)
    jtable = jnp.asarray(table.reshape(table_shape(k)))
    packed, mask = _buffers(idx)
    jpacked, jmask = jnp.asarray(packed), jnp.asarray(mask)
    tp, tm, tt = (torch.from_numpy(a) for a in (packed, mask, table))
    chunks = _chunks(idx)
    assert len(chunks) >= 3
    # the first bucket's refs 0 and 1: ref 0's slice runs into ref 1's bytes
    assert idx.code_offsets[0] + chunks[0][0] // 4 > idx.code_offsets[1]
    assert any((offs[:, 2] < k).any() for _, offs in chunks)  # shorter than k
    checked = set()
    for target, offs in chunks:
        for n, (window, r1, r2) in enumerate(SETTINGS):
            if n and target != chunks[0][0]:
                continue  # the window-1 settings on the first bucket only
            one_min, three_min = window_thresholds(window, r1, r2)
            got = kernels.scan_chunk(tp, tm, torch.from_numpy(offs), tt, idx.perm, k, target,
                                     window, one_min, three_min, 3)
            want = jeref._scan_ref_fused(
                jtable, jpacked, jmask, jnp.asarray(offs[:, 0], jnp.int32),
                jnp.asarray(offs[:, 1], jnp.int32), jnp.asarray(offs[:, 2], jnp.int32),
                target=target, perm_key=perm_to_key(idx.perm), k=k, window=window,
                one_min=one_min, three_min=three_min, least_depth=3)
            assert got.dtype == torch.uint8 and got.shape == (offs.shape[0], target // 8)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            flags = np.unpackbits(got.numpy(), axis=1, bitorder="little")
            assert 0 < flags[:-2].mean() < 1
            assert not flags[-2:].any() or one_min <= 0  # pad rows: all misses
            checked.add(n)
    assert checked == {0, 1, 2}


@pytest.mark.parametrize("k", [20, 7])
def test_zero_hash_slot_misses_though_its_kmer_is_valid(tmp_path, k):
    """Where ref 0 holds a k-mer whose slot-s hash is 0, the slot reads no
    count though slot 0 of the table holds 3: the position is no trio."""
    rng = np.random.default_rng(k + 1)
    idx, zeros = _world(tmp_path, k, rng)
    table = torch.full((1 << k,), 3, dtype=torch.uint8)
    packed, mask = (torch.from_numpy(a) for a in _buffers(idx))
    target, offs = _chunks(idx)[0]
    offs = torch.from_numpy(offs)
    counts, hashes = kernels.scan_counts_plain(packed, mask, offs, table, idx.perm, k, target)
    seq = "".join("ACGTN"[c] for c in idx.ref_codes(0))
    for s in range(3):
        j = seq.index(_zero_slot_kmer(idx.perm, s))
        assert hashes[0, j, s] == 0 and counts[0, j, s] == 0 and hashes[0, j].count_nonzero() == 2
    trio = kernels.scan_chunk(packed, mask, offs, table, idx.perm, k, target, 1, 1, 1, 3)
    flags = np.unpackbits(trio.numpy(), axis=1, bitorder="little")[0]
    np.testing.assert_array_equal(flags, (hashes[0] != 0).all(dim=1).numpy())


def _brev32(x):
    return int(f"{x:032b}"[::-1], 2)


def _even_bits(x):
    return sum(((x >> (2 * t)) & 1) << t for t in range(32))


def _planes(packed, mask, code_off, mask_off, length, n_words):
    """The kernel's step 1a for one row from position 0: words of 32
    positions of lo, hi and invalid (the mask bit, or at or past
    ``length``), read a byte at a time as the kernel reads them."""
    lo, hi, inv = [], [], []
    for w in range(n_words):
        p, code, iv = 32 * w, 0, U32
        if p < length:
            nb = min(32, length - p)
            for b in range((nb + 3) // 4):
                code |= int(packed[code_off + p // 4 + b]) << (8 * b)
            m = 0
            for b in range((nb + 7) // 8):
                m |= int(mask[mask_off + p // 8 + b]) << (8 * b)
            iv = (m | (0 if nb == 32 else U32 << nb)) & U32
        lo.append(_even_bits(code))
        hi.append(_even_bits(code >> 1))
        inv.append(iv)
    return lo, hi, inv


def _bitplane_hashes(packed, mask, code_off, mask_off, length, k, masks):
    """The kernel's step 1b over every position of one row: (length, 3)
    hashes, 0 where a k-mer has an invalid base or does not fit."""
    f, r = (masks[d].astype(np.int64).tolist() for d in (0, 1))
    n_kmers = length - k + 1
    out = np.zeros((max(length, 0), 3), np.int64)
    if n_kmers <= 0:
        return out
    lo_p, hi_p, inv_p = _planes(packed, mask, code_off, mask_off, length,
                                (n_kmers + k - 2) // 32 + 2)
    kmask = U32 if k == 32 else (1 << k) - 1

    def funnel(plane, w, s):
        return ((plane[w + 1] << 32 | plane[w]) >> s) & U32

    for pos in range(n_kmers):
        w, s = pos >> 5, pos & 31
        if funnel(inv_p, w, s) & kmask:
            continue
        lo, hi = funnel(lo_p, w, s), funnel(hi_p, w, s)
        c = (~(lo ^ hi) & U32, ~hi & U32, ~lo & U32)
        comp = (c[0], hi, lo)
        for i in range(3):
            x = f[i][0] & c[0] | f[i][1] & c[1] | f[i][2] & c[2]
            rc = r[i][0] & comp[0] | r[i][1] & comp[1] | r[i][2] & comp[2]
            out[pos, i] = min(_brev32(x) >> (32 - k), rc)
    return out


def _edge_sequences(perm, rng):
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    k = perm.shape[0]
    return [
        bytes(lut[rng.integers(0, 4, 300)]).decode(),
        "".join(rng.choice(list("ACGTNRYacgtn"), size=400, p=[.2, .2, .2, .2] + [.025] * 8)),
        "A" * 90, "T" * 90, "C" * 70 + "G" * 70, "ACGT" * 30,
        "".join(_zero_slot_kmer(perm, s) for s in range(3)) + "GATTACA",
        "N" + bytes(lut[rng.integers(0, 4, k)]).decode() + "N",
        bytes(lut[rng.integers(0, 4, k - 1)]).decode(),
    ]


@pytest.mark.parametrize("k", [20, 31, 32])
def test_coder_masks_through_bit_planes_equal_kmer_hashes(k):
    """The 18 host masks, put through the kernel's bit-plane formula, give
    ``kmer_hashes_masked``'s hashes: random and edge sequences packed as
    the phagedb packs them, after two bytes of another reference."""
    rng = np.random.default_rng(k)
    perm = make_choose_coder(k, seed=3)
    masks = coder_masks(perm, k)
    assert masks.shape == (2, 3, 3) and masks.dtype == np.uint32
    assert (masks[0].sum(axis=1) == (1 << k) - 1).all()  # each z picks one coder a slot
    for seq in _edge_sequences(perm, rng):
        codes = seq_to_codes(seq)
        pad = np.pad(codes, (0, 8 + (-codes.shape[0]) % 8), constant_values=4)
        # two bytes of another reference before it, as in a packed phagedb
        packed, mask = pack_codes_mask(np.concatenate([np.zeros(8, np.uint8), pad])[None])
        got = _bitplane_hashes(packed[0], mask[0], 2, 1, codes.shape[0], k, masks)
        want = kmer_hashes_masked(torch.from_numpy(codes)[None], perm, k)[0].numpy()
        np.testing.assert_array_equal(got[:want.shape[0]], want)
        assert not got[want.shape[0]:].any()
    # the zero-slot k-mer's slot hashes to 0 while it is valid
    zero = seq_to_codes(_zero_slot_kmer(perm, 1))[None]
    assert kmer_hashes_masked(torch.from_numpy(zero), perm, k)[0, 0, 1] == 0


def test_scan_chunk_checks_its_inputs(tmp_path):
    rng = np.random.default_rng(3)
    k = 12
    idx, _ = _world(tmp_path, k, rng)
    packed, mask = (torch.from_numpy(a) for a in _buffers(idx))
    table = torch.zeros(1 << k, dtype=torch.uint8)
    target, offs = _chunks(idx)[0]
    offs = torch.from_numpy(offs)
    args = (idx.perm, k, target, 50, 45, 40)
    assert kernels.scan_chunk(packed, mask, offs, table, *args).shape == (offs.shape[0],
                                                                         target // 8)
    past = offs.clone()
    past[0, 0] = packed.numel() - target // 4 + 1
    negative = offs.clone()
    negative[1, 2] = -1
    for bad in ((packed, mask, past, table), (packed, mask, negative, table),
                (packed, mask, offs.int(), table), (packed, mask, offs[:, :2], table),
                (packed, mask[:int(offs[:, 1].max()) + target // 8 - 1], offs, table),
                (packed, mask, offs, table[:-1]), (packed.int(), mask, offs, table)):
        with pytest.raises(ValueError):
            kernels.scan_chunk(*bad, *args)
    for bad_args in ((idx.perm, 33, target, 50, 45, 40), (idx.perm[:-1], k, target, 50, 45, 40),
                     (idx.perm, k, target + 4, 50, 45, 40),
                     (idx.perm, k, target, kernels.GOOD_WINDOWS_MAX_WINDOW + 1, 45, 40)):
        with pytest.raises(ValueError):
            kernels.scan_chunk(packed, mask, offs, table, *bad_args)
    assert kernels.LAUNCHES["scan_chunk"] == 0
