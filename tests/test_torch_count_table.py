"""The port's flat count table against the JAX package's ``CountTable``:
after the same batches the tables are equal byte for byte, slot 0
included; saturation, a k-mer seen more than 255 times in a batch,
slot 0 on lookup, and ``add_packed`` against ``add_kmers``.  Phase A's
kernel, ``kernels.count_codes``: its plain version against the packed
route on the CPU, its input checks, Phase A on the CPU still through
``add_packed``, and (``cuda``) the kernel against its plain version on the
card, byte for byte."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palace_tpu.ops.count_table import CountTable as JCountTable
from palace_tpu.ops.kmer import kmer_hashes as jkmer_hashes
from palace_tpu_torch.config import KmerParams
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.count_table import CountTable
from palace_tpu_torch.ops.kmer import (kmer_hashes, kmer_hashes_masked, make_choose_coder,
                                       pack_codes_mask)
from palace_tpu_torch.search import eref, index


def _flat(jtable):
    return np.asarray(jtable.table).reshape(-1)


@pytest.mark.parametrize("k", [16, 18])
def test_table_equals_jax_after_the_same_batches(k):
    rng = np.random.default_rng(k)
    perm = make_choose_coder(k, seed=2)
    jt = JCountTable.create(k, 3)
    t = CountTable.create(k, 3, device="cpu")
    for b in range(4):
        codes = rng.integers(0, 5 if b % 2 else 4, size=(32, 48)).astype(np.uint8)
        codes[: 8 * b, :] = codes[0]  # repeated rows: multiplicities above the cap
        h, v = jkmer_hashes(jnp.asarray(codes), perm, k)
        jt = jt.add_kmers(h, v)
        assert t.add_kmers(*kmer_hashes(torch.from_numpy(codes), perm, k)) is t
        np.testing.assert_array_equal(t.table.numpy(), _flat(jt))
    assert t.table.shape == (1 << k,) and t.table.dtype == torch.uint8
    assert t.table[0] == 3 and (t.table == 1).any() and (t.table == 3).sum() > 1


def test_saturation_and_lookup():
    t = CountTable.create(12, 3, device="cpu")
    t.add_kmers(torch.tensor([[5, 5, 9], [5, 7, 9]]))
    assert t.lookup(torch.tensor([5, 7, 9, 11, 0])).tolist() == [3, 1, 2, 0, 0]
    t.add_kmers(torch.tensor([[5, 7, 7, 7, 7]]))
    assert t.lookup(torch.tensor([5, 7])).tolist() == [3, 3]
    jt = JCountTable.create(12, 3).add_kmers(jnp.asarray(np.array([[5, 5, 9], [5, 7, 9]],
                                                                  np.uint32)))
    jt = jt.add_kmers(jnp.asarray(np.array([[5, 7, 7, 7, 7]], np.uint32)))
    np.testing.assert_array_equal(t.table.numpy(), _flat(jt))


def test_hot_kmer_seen_600_times_stays_saturated():
    t = CountTable.create(12, 3, device="cpu")
    hot = torch.full((1, 600), 123, dtype=torch.int64)
    for _ in range(2):
        t.add_kmers(hot)
        assert int(t.lookup(torch.tensor([123]))[0]) == 3
    jt = JCountTable.create(12, 3).add_kmers(jnp.asarray(np.full((1, 600), 123, np.uint32)))
    np.testing.assert_array_equal(t.table.numpy(), _flat(jt.add_kmers(
        jnp.asarray(np.full((1, 600), 123, np.uint32)))))


def test_slot_zero_counts_but_always_misses():
    t = CountTable.create(12, 3, device="cpu")
    t.add_kmers(torch.zeros((1, 50), dtype=torch.int64))
    assert int(t.table[0]) == 3
    assert int(t.lookup(torch.tensor([0]))[0]) == 0
    jt = JCountTable.create(12, 3).add_kmers(jnp.asarray(np.zeros((1, 50), np.uint32)))
    np.testing.assert_array_equal(t.table.numpy(), _flat(jt))


@pytest.mark.parametrize("k", [8, 16])
def test_add_packed_equals_add_kmers(k):
    rng = np.random.default_rng(3)
    perm = make_choose_coder(k, seed=3)
    codes = rng.integers(0, 5, size=(16, 40)).astype(np.uint8)
    ref = CountTable.create(18, device="cpu").add_kmers(
        *kmer_hashes(torch.from_numpy(codes), perm, k))
    packed, mask = pack_codes_mask(codes)
    fused = CountTable.create(18, device="cpu").add_packed(packed, mask, perm, k)
    assert torch.equal(ref.table, fused.table)
    jt = JCountTable.create(18).add_packed(packed, mask, perm, k)
    np.testing.assert_array_equal(fused.table.numpy(), _flat(jt))


def _reads(rng, genome, n, L, n_bases, invalid):
    """(n, L) uint8 codes: reads of ``n_bases`` drawn from ``genome`` (a
    code array), a share ``invalid`` of them set to code 4, pad 4 after."""
    starts = rng.integers(0, genome.size - n_bases + 1, n)
    codes = np.full((n, L), 4, np.uint8)
    codes[:, :n_bases] = genome[starts[:, None] + np.arange(n_bases)]
    codes[:, :n_bases][rng.random((n, n_bases)) < invalid] = 4
    return codes


def _case(name, card):
    """A Phase A batch: ``(codes (B, L) uint8, k, prefilled)``, at the
    cell's size on the card (k = 32, rows of 160) and at a CPU size
    otherwise."""
    rng = np.random.default_rng(sum(map(ord, name)))
    k, L = (32, 160) if card else (16, 48)
    B = 4096 if card else 64
    genome = rng.integers(0, 4, 40_000 if card else 2_000).astype(np.uint8)
    prefilled = False
    if name == "random_with_code_4":
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[rng.random((B, L)) < 0.03] = 4
    elif name == "rows_shorter_than_k":
        codes = np.full((B, L), 4, np.uint8)
        for i, n in enumerate(rng.integers(0, k + 4, B)):
            codes[i, :n] = rng.integers(0, 4, n)
    elif name == "all_pad":
        codes = np.full((B + 7, L), 4, np.uint8)
    elif name == "one_row":
        codes = _reads(rng, genome, 1, L, L - 10, 0.0)
    elif name == "full_batch":
        B = 32768 if card else 512
        codes = _reads(rng, genome, B, L, L - 10, 0.002)
    elif name == "near_cap":
        codes, prefilled = _reads(rng, genome, B, L, L - 10, 0.002), True
    elif name == "hash_600_times":
        codes = np.repeat(_reads(rng, genome, 1, k + 8, k, 0.0), 600, axis=0)
    elif name == "short_batch_pad_rows":  # padded with rows of code 4, as Phase A stages it
        codes = np.concatenate([_reads(rng, genome, B // 3, L, L - 10, 0.01),
                                np.full((B - B // 3, L), 4, np.uint8)])
    elif name == "reverse_complements":  # each read beside its other strand, as two mate files
        fwd = _reads(rng, genome, B // 2, L, L - 10, 0.0)
        rc = fwd.copy()
        rc[:, :L - 10] = 3 - fwd[:, L - 11::-1]
        codes = np.concatenate([fwd, rc])
    elif name == "small_k":
        codes, k = _reads(rng, genome, B, L, L, 0.01), 12
    else:
        raise KeyError(name)
    return codes, k, prefilled


CASES = ["random_with_code_4", "rows_shorter_than_k", "all_pad", "one_row", "full_batch",
         "near_cap", "hash_600_times", "short_batch_pad_rows", "reverse_complements", "small_k"]


def _empty_or_prefilled(k, prefilled, device):
    """A table of 2^k slots, zero or counts 0..3 drawn from a seed."""
    if not prefilled:
        return torch.zeros(1 << k, dtype=torch.uint8, device=device)
    g = torch.Generator(device=device).manual_seed(k)
    return torch.randint(0, 4, (1 << k,), generator=g, dtype=torch.uint8, device=device)


@pytest.mark.parametrize("case", CASES)
def test_count_codes_on_the_cpu_equals_plain_and_the_packed_route(case):
    """On the CPU ``count_codes`` is its plain version, and both equal the
    route Phase A takes there: the batch packed on the host and counted by
    ``add_packed``; slot 0 included."""
    codes, k, prefilled = _case(case, card=False)
    perm = make_choose_coder(k, seed=5)
    start = _empty_or_prefilled(k, prefilled, "cpu")
    packed = CountTable(start.clone(), k).add_packed(*pack_codes_mask(codes), perm, k)
    plain = kernels.count_codes_plain(start.clone(), torch.from_numpy(codes), perm, k, 3)
    before = dict(kernels.LAUNCHES)
    got = CountTable(start.clone(), k).add_codes(torch.from_numpy(codes), perm, k)
    assert kernels.LAUNCHES == before
    assert torch.equal(plain, packed.table) and torch.equal(got.table, packed.table)
    assert not torch.equal(got.table, start) and int(got.table.max()) <= 3


@pytest.mark.parametrize("bad", ["codes_dtype", "codes_rank", "k_above_32", "k_below_2",
                                 "perm_shape", "table_size", "table_dtype", "cap", "counters"])
def test_count_codes_refuses_what_the_kernel_does_not_take(bad):
    k = 12
    args = dict(table=torch.zeros(1 << k, dtype=torch.uint8),
                codes=torch.zeros((4, 40), dtype=torch.uint8), perm=make_choose_coder(k, 5),
                k=k, cap=3, counters=None)
    args.update({
        "codes_dtype": dict(codes=torch.zeros((4, 40), dtype=torch.int32)),
        "codes_rank": dict(codes=torch.zeros(160, dtype=torch.uint8)),
        "k_above_32": dict(k=33, perm=make_choose_coder(33, 5)),
        "k_below_2": dict(k=1, perm=make_choose_coder(1, 5),
                          table=torch.zeros(2, dtype=torch.uint8)),
        "perm_shape": dict(perm=make_choose_coder(k + 1, 5)),
        "table_size": dict(table=torch.zeros(1 << (k + 1), dtype=torch.uint8)),
        "table_dtype": dict(table=torch.zeros(1 << k, dtype=torch.int32)),
        "cap": dict(cap=256),
        "counters": dict(counters=torch.zeros(2, dtype=torch.int32)),
    }[bad])
    with pytest.raises(ValueError, match="count_codes"):
        kernels.count_codes(**args)


def test_count_reads_into_table_on_the_cpu_goes_through_add_packed(tmp_path, monkeypatch):
    """Phase A on the CPU keeps its route, a batch packed on the host and
    counted by ``CountTable.add_packed`` (the benchmark's Phase A faults
    are planted there), and never ``count_codes``; its table equals one
    ``count_codes`` call on all the reads."""
    rng = np.random.default_rng(4)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    reads = [genome[i:i + 100] for i in range(0, 2900, 7)] + ["ACGTN" * 20]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(reads)))
    db = tmp_path / "db.fasta"
    db.write_text(f">g\n{genome}\n")
    k = 16
    idx = index.build_index(db, k=k, save=False)
    calls = []
    real = CountTable.add_packed

    def counted(self, packed, mask, perm, kmer_k):
        calls.append(packed.shape[0])
        return real(self, packed, mask, perm, kmer_k)

    def refused(*args, **kwargs):
        raise AssertionError("count_codes on the CPU route")

    monkeypatch.setattr(CountTable, "add_packed", counted)
    monkeypatch.setattr(kernels, "count_codes", refused)
    monkeypatch.setattr(eref, "READ_BATCH", 128)
    table = eref.count_reads_into_table([fq], idx, KmerParams(k=k), device="cpu")
    assert calls == [128] * 4  # 416 reads in batches of 128, the last padded
    monkeypatch.undo()
    codes = np.concatenate(list(eref.read_code_batches(fq, 4096, 160, 100, k)))
    codes = np.pad(codes, ((0, 4 * 128 - codes.shape[0]), (0, 0)), constant_values=4)
    want = kernels.count_codes_plain(torch.zeros(1 << k, dtype=torch.uint8),
                                     torch.from_numpy(codes), idx.perm, k, 3)
    assert torch.equal(table.table, want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run pytest -m cuda tests/test_torch_count_table.py "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_card_count_codes_equals_plain(cuda, case):
    """The kernel against its plain version on the card, the whole table
    byte for byte, slot 0 included: one launch, and every nonzero hash
    either updated by a CAS or skipped at cap."""
    codes, k, prefilled = _case(case, card=True)
    perm = make_choose_coder(k, seed=5)
    codes = torch.from_numpy(codes).to(cuda)
    want = kernels.count_codes_plain(_empty_or_prefilled(k, prefilled, cuda), codes, perm, k, 3)
    got = _empty_or_prefilled(k, prefilled, cuda)
    counters = torch.zeros(2, dtype=torch.int64, device=cuda)
    before = kernels.LAUNCHES["count_codes"]
    kernels.count_codes(got, codes, perm, k, 3, counters)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["count_codes"] == before + 1
    assert torch.equal(got, want)
    nonzero = int((kmer_hashes_masked(codes, perm, k) != 0).sum())
    assert int(counters.sum()) == nonzero
    del got, want
    torch.cuda.empty_cache()
