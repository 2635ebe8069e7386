"""The port's eref stage against the JAX package's on the CPU: the same
worlds give byte-identical ``ref_names.txt``; the index cache is shared
both ways; the read batches are equal; the CLI writes the same file;
the entry points refuse to run without a card unless asked for the CPU;
and (``cuda``) Phase A's kernel route on the card gives the CPU's table
and report."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from palace_tpu.config import KmerParams as JKmerParams
from palace_tpu.io.fasta import reverse_complement, write_fasta
from palace_tpu.ops.count_table import CountTable as JCountTable
from palace_tpu.ops.kmer import kmer_hashes as jkmer_hashes
from palace_tpu.ops.kmer import make_choose_coder, seq_to_codes
from palace_tpu.search import eref as jeref
from palace_tpu.search import index as jindex
from palace_tpu.search import refs as jrefs
from palace_tpu_torch import cli
from palace_tpu_torch.config import KmerParams
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.count_table import CountTable
from palace_tpu_torch.ops.kmer import kmer_hashes
from palace_tpu_torch.search import eref, index, refs
from palace_tpu_torch.utils.timers import GLOBAL_METRICS
from _torch_jax_native import jax_native_dir  # noqa: F401  (JAX's native build, private)


def _make_reads(seq, read_len, step):
    return [seq[i : i + read_len] for i in range(0, len(seq) - read_len + 1, step)]


def _write_fastq(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


@pytest.fixture
def mini_world(tmp_path):
    """tests/test_kmer_search.py::test_end_to_end_mini_search's world:
    reads tiled three times from ref B of three random 3 kb refs."""
    rng = np.random.default_rng(5)
    refs_ = {name: "".join(rng.choice(list("ACGT"), size=3000))
             for name in ("phageA", "phageB", "phageC")}
    db = tmp_path / "phagedb.fasta"
    write_fasta(db, list(refs_.items()))
    reads = []
    for off in (0, 3, 7):
        reads += _make_reads(refs_["phageB"][off:], 100, 10)
    fq1, fq2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    _write_fastq(fq1, reads)
    _write_fastq(fq2, [reverse_complement(r) for r in reads])
    return db, fq1, fq2


def test_mini_search_ref_names_byte_identical(mini_world, tmp_path):
    db, fq1, fq2 = mini_world
    k = 16
    jidx = jindex.build_index(db, k=k, coder_seed=1, save=False)
    jeref.run_search(fq1, fq2, jidx, JKmerParams(k=k, window=100), tmp_path / "jax.txt")
    tidx = index.build_index(db, k=k, coder_seed=1, save=False)
    hits = eref.run_search(fq1, fq2, tidx, KmerParams(k=k, window=100), tmp_path / "port.txt",
                           device="cpu")
    want = (tmp_path / "jax.txt").read_bytes()
    assert [h.ref_index for h in hits] == [2] and hits[0].ratio > 0.75
    assert (tmp_path / "port.txt").read_bytes() == want

    # ref_names.txt → phage_refs.fasta, as the JAX package writes it
    for pkg, name in ((jrefs, "jax"), (refs, "port")):
        pkg.extract_reference_sequences(db, tmp_path / "port.txt", tmp_path / f"{name}.fa",
                                        tmp_path / f"{name}.pct")
    assert (tmp_path / "port.fa").read_bytes() == (tmp_path / "jax.fa").read_bytes()
    assert (tmp_path / "port.pct").read_bytes() == (tmp_path / "jax.pct").read_bytes()
    assert refs.parse_ref_names_file(tmp_path / "port.txt") == \
        jrefs.parse_ref_names_file(tmp_path / "jax.txt")


@pytest.mark.parametrize("chunk_pos", [4096, 3 * 4096])
def test_mixed_lengths_chunked_scan_byte_identical(tmp_path, monkeypatch, chunk_pos):
    """tests/test_kmer_search.py::test_batched_scan_mixed_lengths_vs_per_ref_oracle's
    world, with CHUNK_POS shrunk in both packages: to 4096 as that test
    does (one ref a chunk), and to 3·4096 (chunks with pad rows); several
    buckets, multi-chunk buckets and a ref shorter than k."""
    rng = np.random.default_rng(5)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    k = 16
    lengths = [300, 900, 900, 2100, 2100, 2100, 5000, 5000, 12000, 40]
    seqs = [bytes(lut[rng.integers(0, 4, L)]).decode() for L in lengths]
    db = tmp_path / "db.fa"
    write_fasta(db, [(f"r{i}", s) for i, s in enumerate(seqs)])
    reads = [seqs[ri][off:off + 100] for ri in (1, 3, 8)
             for off in range(0, len(seqs[ri]) - 100, 20)]
    codes = np.full((len(reads), 104), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = seq_to_codes(r)
    monkeypatch.setattr(jeref, "CHUNK_POS", chunk_pos)
    monkeypatch.setattr(eref, "CHUNK_POS", chunk_pos)
    chunks = eref.plan_chunks(index.build_index(db, k=k, save=False))
    assert any(len(c) < rows for _, c, rows in chunks) == (chunk_pos > 4096)

    jidx = jindex.build_index(db, k=k, save=False)
    h, v = jkmer_hashes(jnp.asarray(codes), jidx.perm, k)
    jtable = JCountTable.create(k, 3).add_kmers(h, v)
    jeref.write_ref_names(tmp_path / "jax.txt",
                          jeref.search_references(jtable, jidx, JKmerParams(k=k, window=64)))

    tidx = index.build_index(db, k=k, save=False)
    table = CountTable.create(k, 3, device="cpu")
    table.add_kmers(*kmer_hashes(torch.from_numpy(codes), tidx.perm, k))
    hits = eref.search_references(table, tidx, KmerParams(k=k, window=64))
    eref.write_ref_names(tmp_path / "port.txt", hits)
    assert len(hits) >= 2
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_cache_loads_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(3)
    seqs = [("a", "".join(rng.choice(list("ACGTN"), size=1003))),
            ("b", "".join(rng.choice(list("acgt"), size=77))), ("c", "ACG")]
    db = tmp_path / "db.fa"
    write_fasta(db, seqs)
    built = (jindex if writer == "jax" else index).build_index(db, k=20, coder_seed=4)
    loaded = (index if writer == "jax" else jindex).load_index(db, k=20)
    assert loaded is not None and loaded.k == 20 and loaded.names == built.names
    for field in ("perm", "lengths", "code_offsets", "mask_offsets", "packed", "maskbits"):
        np.testing.assert_array_equal(getattr(loaded, field), getattr(built, field))
    assert index.load_or_build_index(db, k=20).names == ["a", "b", "c"]
    np.testing.assert_array_equal(
        index.load_index(db, k=20).ref_hashes(0, device="cpu"),
        np.asarray(jindex.load_index(db, k=20).ref_hashes(0)))


def test_reference_format_index_reads_as_in_jax(tmp_path):
    """A reference-format ``.k{k}.index.dat`` (100 u32 header entries with
    the coder permutation in their low 16 bits, then u32 ref_len + the
    (ref_len-k+1, 3) u32 hashes a record): the port reads the same
    permutation and records as JAX, and hashes the codes as JAX does."""
    k = 12
    rng = np.random.default_rng(11)
    perm = make_choose_coder(k, 5)
    header = rng.integers(0, 1 << 16, 100).astype(np.uint32) << 16  # the next short's bits
    header[: 3 * k] |= perm.reshape(-1).astype(np.uint32)
    seqs = ["".join(rng.choice(list("ACGTN"), size=n)) for n in (40, 300, 1000)]
    dat = tmp_path / "db.k12.index.dat"
    with open(dat, "wb") as fh:
        fh.write(header.astype("<u4").tobytes())
        for s in seqs:
            fh.write(np.uint32(len(s)).astype("<u4").tobytes())
            fh.write(jindex.compute_hashes_for_seq(s, perm, k).astype("<u4").tobytes())
    got_perm = index.perm_from_reference_index(dat, k)
    np.testing.assert_array_equal(got_perm, jindex.perm_from_reference_index(dat, k))
    np.testing.assert_array_equal(got_perm, perm)
    got = list(index.iter_reference_index_records(dat, k))
    want = list(jindex.iter_reference_index_records(dat, k))
    assert [n for n, _ in got] == [n for n, _ in want] == [40, 300, 1000]
    for (_, g), (_, w), s in zip(got, want, seqs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            index.compute_hashes_for_codes(seq_to_codes(s), got_perm, k, device="cpu"), w)
    (tmp_path / "short.dat").write_bytes(header[:50].tobytes())
    for pkg in (index, jindex):
        with pytest.raises(ValueError, match="truncated"):
            pkg.perm_from_reference_index(tmp_path / "short.dat", k)


def test_read_code_batches_equal_jax_with_downsampling(tmp_path):
    rng = np.random.default_rng(9)
    reads = ["".join(rng.choice(list("ACGTNacgt"), size=int(n)))
             for n in rng.integers(1, 420, 300)]
    fq = tmp_path / "r.fastq"
    _write_fastq(fq, reads)
    target = sum(map(len, reads))  # half the paired bases → ratio 50
    ratio = eref.compute_downsample_ratio(fq, target)
    assert ratio == jeref.compute_downsample_ratio(fq, target) == 50
    kept = sum(eref._keep_read(i, ratio) for i in range(len(reads)))
    assert 0 < kept < len(reads)
    got = list(eref.read_code_batches(fq, 64, 160, ratio, 32))
    want = list(jeref._py_read_batches(fq, 64, 160, ratio, 32))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_count_reads_into_table_equals_jax(mini_world):
    db, fq1, fq2 = mini_world
    k = 16
    jidx = jindex.build_index(db, k=k, save=False)
    jtable = jeref.count_reads_into_table([fq1, fq2], jidx, JKmerParams(k=k))
    table = eref.count_reads_into_table([fq1, fq2], index.build_index(db, k=k, save=False),
                                        KmerParams(k=k), device="cpu")
    np.testing.assert_array_equal(table.table.numpy(), np.asarray(jtable.table).reshape(-1))
    assert table.table.sum() > 0


def test_eref_cli_on_the_cpu_writes_the_same_file(mini_world, tmp_path, capsys):
    db, fq1, fq2 = mini_world
    jeref.run_search(fq1, fq2, jindex.build_index(db, k=16, save=False), JKmerParams(k=16),
                     tmp_path / "jax.txt")
    out = tmp_path / "cli.txt"
    rc = cli.main(["eref", str(fq1), str(fq2), str(db), str(out), "--k", "16",
                   "--device", "cpu"])
    assert rc == 0
    assert out.read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert capsys.readouterr().out == out.read_text()
    assert (tmp_path / "phagedb.fasta.k16.palace.npz").exists()


def test_entry_points_raise_without_a_card(mini_world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    db, fq1, fq2 = mini_world
    idx = index.build_index(db, k=16, save=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eref.run_search(fq1, fq2, idx, KmerParams(k=16), tmp_path / "x.txt")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CountTable.create(16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["eref", str(fq1), str(fq2), str(db), str(tmp_path / "y.txt"), "--k", "16"])
    assert not (tmp_path / "x.txt").exists() and not (tmp_path / "y.txt").exists()


@pytest.mark.cuda
def test_card_run_search_equals_the_cpu(mini_world, tmp_path):
    """``run_search`` on the card, whose Phase A counts each batch with one
    ``count_codes`` launch from the reader's codes, gives the same count
    table and ``ref_names.txt`` as on the CPU, where Phase A packs and
    counts through ``add_packed``, and as the JAX package; its counters
    reach ``GLOBAL_METRICS``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run pytest -m cuda tests/test_torch_eref.py on the card")
    db, fq1, fq2 = mini_world
    k = 16
    idx = index.build_index(db, k=k, save=False)
    params = KmerParams(k=k, window=100)
    tables = [eref.count_reads_into_table([fq1, fq2], idx, params, device=d).table.cpu()
              for d in ("cpu", "cuda")]
    assert torch.equal(tables[0], tables[1]) and int(tables[0][0]) == 3
    jidx = jindex.build_index(db, k=k, save=False)
    jparams = JKmerParams(k=k, window=100)
    jtable = jeref.count_reads_into_table([fq1, fq2], jidx, jparams)
    np.testing.assert_array_equal(tables[1].numpy(), np.asarray(jtable.table).reshape(-1))
    jeref.run_search(fq1, fq2, jidx, jparams, tmp_path / "jax.txt")
    hits = {}
    for d in ("cpu", "cuda"):
        before = kernels.LAUNCHES["count_codes"]
        counted = GLOBAL_METRICS.summary().get("eref.count_updates", {}).get("calls", 0)
        hits[d] = eref.run_search(fq1, fq2, idx, params, tmp_path / f"{d}.txt", device=d)
        assert kernels.LAUNCHES["count_codes"] - before == (2 if d == "cuda" else 0)
        assert GLOBAL_METRICS.summary().get("eref.count_updates", {}).get("calls", 0) \
            - counted == (d == "cuda")
    assert [h.ref_index for h in hits["cuda"]] == [2]
    assert (tmp_path / "cuda.txt").read_bytes() == (tmp_path / "cpu.txt").read_bytes() \
        == (tmp_path / "jax.txt").read_bytes()
    summary = GLOBAL_METRICS.summary()
    assert summary["eref.count_updates"]["items"] > 0 and "eref.count_at_cap" in summary


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_card_phase_a_in_many_batches_equals_the_cpu(mini_world, monkeypatch, device):
    """Phase A on the card in batches of 128 reads, so that its pinned
    staging buffer is refilled 14 times and each file's last batch is
    short and padded there: the CPU's table, slot 0 included.  On
    ``cuda:1``, with the current device 0, the upload and the launch run on
    the second card's stream, and each refill waits for that stream's
    upload."""
    if torch.cuda.device_count() < (2 if device == "cuda:1" else 1):
        pytest.skip(f"needs a CUDA device {device}: run pytest -m cuda tests/test_torch_eref.py "
                    f"on a machine with that many cards")
    db, fq1, fq2 = mini_world
    k = 16
    idx = index.build_index(db, k=k, save=False)
    params = KmerParams(k=k, window=100)
    monkeypatch.setattr(eref, "READ_BATCH", 128)
    monkeypatch.setattr(eref, "CUDA_READ_BATCH", 128)
    want = eref.count_reads_into_table([fq1, fq2], idx, params, device="cpu").table
    torch.cuda.set_device(0)
    before = kernels.LAUNCHES["count_codes"]
    got = eref.count_reads_into_table([fq1, fq2], idx, params, device=device).table
    assert got.device == torch.device(device if device != "cuda" else "cuda:0")
    assert kernels.LAUNCHES["count_codes"] - before == 14
    assert torch.equal(got.cpu(), want)
