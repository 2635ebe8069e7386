"""The port's eref across devices against palace_tpu on its 8 virtual CPU
devices and against the port on one device: ``ShardedCountTable``,
``count_reads_into_table(mesh=...)``, Phase B on a sharded table
(``kernels.scan_hits``, one all-reduce of the hit bit-planes,
``kernels.window_hits``), ``run_search(mesh=...)``,
``run_search_distributed`` and ``run_pipeline(mesh=...)``.

JAX's mesh is one process (``make_mesh(8, model_parallel=2)``, and
``make_mesh(8)`` for the pipeline); the port's is one process a rank.
Ranks are spawned under gloo with a ``file://`` store in ``tmp_path``
(``tests/_torch_eref_worker.py``, one CPU thread each, no JAX;
``chip_smoke.spawn_ranks``): 2 ranks at (data, model) = (2, 1) and (1, 2),
and 3 ranks at (3, 1), where 3 does not divide the 2^16 slots.  A mesh of
one rank runs in this process.

Tolerance: exact.  Counts, hit bits, ``ref_names.txt`` and the final
FASTA are integer work and files; the pipeline's scores are held within
1e-5 of JAX's, tests/test_torch_pipeline.py's bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _torch_eref_worker as worker
import chip_smoke
from _torch_jax_native import jax_native_dir  # noqa: F401  (JAX's native build, private)
from palace_tpu import config as jconfig
from palace_tpu.config import KmerParams as JKmerParams
from palace_tpu.models import gcn as jgcn
from palace_tpu.models import scoring as jscoring
from palace_tpu.ops.count_table import ShardedCountTable as JShardedCountTable
from palace_tpu.ops.count_table import table_shape
from palace_tpu.ops.kmer import perm_to_key
from palace_tpu.parallel.mesh import make_mesh as jmake_mesh
from palace_tpu.pipeline import driver as jdriver
from palace_tpu.search import eref as jeref
from palace_tpu.search import index as jindex
from palace_tpu_torch import config as tconfig
from palace_tpu_torch.io.fasta import reverse_complement, write_fasta
from palace_tpu_torch.models import gcn as tgcn
from palace_tpu_torch.models import scoring as tscoring
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.count_table import CountTable
from palace_tpu_torch.ops.kmer import make_choose_coder, pack_codes_mask
from palace_tpu_torch.ops.window import window_thresholds
from palace_tpu_torch.parallel import mesh as pmesh
from palace_tpu_torch.pipeline import driver as tdriver
from palace_tpu_torch.search import eref, index as tindex
from test_torch_pipeline import _build, _twin
from test_torch_scan import SETTINGS, _buffers, _chunks, _table, _world

JPARAMS = JKmerParams(k=worker.K, window=100, hit_ratio=0.9, perfect_hit_ratio=0.85)
JOBS = {2: dict(model_parallel=(1, 2), search=True, pipeline=True),
        3: dict(model_parallel=(1,))}
SPAWN_TIMEOUT_S = 300


def _write_fastq(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def _tiles(seq, read_len, step):
    return [seq[i:i + read_len] for i in range(0, len(seq) - read_len + 1, step)]


def _table_inputs(rng):
    """tests/test_kmer_search.py's table batches: three of 64 random
    hashes, a low-complexity one (one hot value and a few others), 20
    positions × 3 coders of 4 rows with a ``valid`` mask, and 8 rows of
    packed reads with N at k = 8."""
    batches = [(rng.integers(0, 1 << 16, (1, 64)), None) for _ in range(3)]
    few = np.asarray([1, 2, 37, 4000, 4001])
    low = np.concatenate([np.full(4096, 37), few, few])
    batches.append((np.pad(low, (0, (-len(low)) % 8))[None], None))
    batches.append((rng.integers(0, 1 << 16, (4, 20, 3)), rng.random((4, 20)) < 0.7))
    perm = make_choose_coder(8, seed=3)
    packed = [pack_codes_mask(rng.integers(0, 5, size=(8, 64)).astype(np.uint8))]
    probe = np.concatenate([np.arange(1 << 16), [0, 37, 37]])
    return dict(hash_batches=batches, packed=packed, perm=perm, kmer_k=8, probe=probe)


def _search_world(root):
    """tests/test_kmer_search.py ``test_sharded_fused_scan_matches_single``'s
    world: two 3 kb references, reads tiled from the second, and their
    reverse complements as the mates."""
    rng = np.random.default_rng(5)
    refs = {name: "".join(rng.choice(list("ACGT"), size=3000)) for name in ("phageA", "phageB")}
    db = root / "phagedb.fasta"
    write_fasta(db, list(refs.items()))
    reads = [r for off in (0, 3, 7) for r in _tiles(refs["phageB"][off:], 100, 10)]
    fqs = [root / "r1.fastq", root / "r2.fastq"]
    _write_fastq(fqs[0], reads)
    _write_fastq(fqs[1], [reverse_complement(r) for r in reads])
    # two files of unequal sizes for run_search_distributed: 2 batches of
    # the CPU's 4,096 rows, and 1
    every = _tiles(refs["phageB"], 100, 1)
    dist_fqs = [root / "a.fastq", root / "b.fastq"]
    _write_fastq(dist_fqs[0], every + [reverse_complement(r) for r in every])
    _write_fastq(dist_fqs[1], [every[i] for i in rng.integers(0, len(every), 1000)])
    return dict(db=db, fastqs=fqs, dist_fastqs=dist_fqs)


def _overflow_world(root):
    """tests/test_kmer_search.py ``test_production_overflow_policy``'s
    world: one 2 kb reference, 4,096 diverse random 40 bp reads."""
    rng = np.random.default_rng(11)
    db = root / "overflow_db.fasta"
    write_fasta(db, [("phageA", "".join(rng.choice(list("ACGT"), size=2000)))])
    reads = ["".join(rng.choice(list("ACGT"), size=40)) for _ in range(4096)]
    fqs = [root / "o1.fastq", root / "o2.fastq"]
    _write_fastq(fqs[0], reads)
    _write_fastq(fqs[1], [reverse_complement(r) for r in reads])
    return dict(overflow_db=db, overflow_fastqs=fqs)


def _pipeline_world(root):
    """The demo world of tests/test_torch_pipeline.py without its
    pre-staged scores, copied for JAX, the port on one device and the
    port's mesh; one small-config scorer drawn with JAX (d1, d2 scaled so
    the probabilities spread)."""
    cfg, _ = _build("demo", root / "jax")
    (root / "jax" / "output" / "03-search" / "node_scores.out").unlink()
    jp = jgcn.init_params(jax.random.PRNGKey(3), jgcn.GCNConfig(**SMALL))
    jp["d1.w"], jp["d2.w"] = jp["d1.w"] * 3.0, jp["d2.w"] * 30.0
    jp = {k: np.asarray(v) for k, v in jp.items()}  # the ranks unpickle no JAX
    return dict(pipeline_jax_cfg=cfg, pipeline_one_cfg=_twin(root / "jax", root / "one"),
                pipeline_cfg=_twin(root / "jax", root / "mesh"), pipeline_root=str(root / "mesh"),
                pipeline_jax_params=jp, pipeline_params=tgcn.params_from_jax(jp))


SMALL = dict(gcn_dim=16, cnn_dim=8, fc_dim=8)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("eref_worlds")
    return dict(**_table_inputs(np.random.default_rng(0)), **_search_world(root),
                **_overflow_world(root), **_pipeline_world(root))


@pytest.fixture(scope="module")
def spawned(job, tmp_path_factory):
    """Each world's ranks, spawned once, lazily; JAX's native build is
    private to the port's tests (the ranks run the port's own)."""
    cache = {}

    def get(world: int):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"eref_world{world}")
            ranks = chip_smoke.spawn_ranks(worker.run, world, dict(job, **JOBS[world]), out,
                                           SPAWN_TIMEOUT_S)
            cache[world] = (ranks, out)
        return cache[world]

    return get


def _one_rank():
    """A mesh of one rank in this process (no process group)."""
    return pmesh.make_mesh(device="cpu")


def _tables(job, spawned, world):
    """Each layout's ranks' table results, in rank order."""
    if world == 1:
        return {(1, 1): [dict(index=0, table=worker.table_job(_one_rank(), job))]}
    ranks, _ = spawned(world)
    return {layout: [r["layouts"][layout] for r in ranks] for layout in ranks[0]["layouts"]}


# -- 1. the table --------------------------------------------------------------

@pytest.fixture(scope="module")
def one_device_table(job):
    """The port's one-device table and JAX's sharded one, from the same
    batches, and JAX's lookups of the probe."""
    table = CountTable.create(worker.K, device="cpu")
    jtable = JShardedCountTable.create(jmake_mesh(8, model_parallel=2), worker.K)
    for hashes, valid in job["hash_batches"]:
        table.add_kmers(torch.from_numpy(hashes), None if valid is None else torch.from_numpy(valid))
        jtable = jtable.add_kmers(jnp.asarray(hashes.astype(np.uint32)),
                                  None if valid is None else jnp.asarray(valid))
    for packed, mask in job["packed"]:
        table.add_packed(packed, mask, job["perm"], job["kmer_k"])
        jtable = jtable.add_packed(packed, mask, job["perm"], job["kmer_k"])
    assert jtable.overflow_dropped() == 0
    return table.table.numpy(), np.asarray(jtable.lookup(jnp.asarray(
        job["probe"].astype(np.uint32))))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_table_equals_one_device_and_jax(job, spawned, one_device_table, world):
    whole, jax_lookup = one_device_table
    size = -(-(1 << worker.K) // world)
    for layout, ranks in _tables(job, spawned, world).items():
        assert [r["index"] for r in ranks] == list(range(world)), layout
        shards = [r["table"]["shard"] for r in ranks]
        assert [s.shape for s in shards] == [(size,)] * world
        assert [r["table"]["lo"] for r in ranks] == [i * size for i in range(world)]
        np.testing.assert_array_equal(np.concatenate(shards)[:1 << worker.K], whole)
        assert not np.concatenate(shards)[1 << worker.K:].any()
        for r in ranks:  # every rank reads every slot, slot 0 as 0
            np.testing.assert_array_equal(r["table"]["lookup"], jax_lookup)
    assert whole[37] == 3 and whole[0] == 3 and jax_lookup[-1] == 3 and jax_lookup[0] == 0


# -- 2. no drop where JAX's windowed scatter drops -------------------------------------------

def test_sharded_table_drops_nothing_where_jax_overflows(job, spawned, monkeypatch):
    monkeypatch.setenv("PALACE_READ_BATCH", "2048")
    monkeypatch.setenv("PALACE_SCATTER_CAP_WIN", "64")
    jidx = jindex.build_index(job["overflow_db"], k=worker.K, coder_seed=1, save=False)
    fqs = [str(f) for f in job["overflow_fastqs"]]
    with pytest.raises(jeref.ShardedOverflowError):
        jeref.count_reads_into_table(fqs, jidx, JPARAMS, mesh=jmake_mesh(8, model_parallel=2))
    jwhole = np.asarray(jeref.count_reads_into_table(fqs, jidx, JPARAMS).merged()).reshape(-1)
    index = tindex.build_index(job["overflow_db"], k=worker.K, coder_seed=1, save=False)
    whole = eref.count_reads_into_table(fqs, index, worker.PARAMS, device="cpu").table.numpy()
    np.testing.assert_array_equal(whole, jwhole)
    ranks, _ = spawned(2)
    for layout in ((2, 1), (1, 2)):
        shards = [r["layouts"][layout]["overflow"]["shard"] for r in ranks]
        np.testing.assert_array_equal(np.concatenate(shards)[:1 << worker.K], whole)
    assert (whole == 3).sum() > 1000  # distinct counted k-mers, far past JAX's window of 64


# -- 3. the sharded scan's bits --------------------------------------------------------

@pytest.fixture(scope="module")
def scan_world(tmp_path_factory):
    k = 20
    rng = np.random.default_rng(k)
    idx, _ = _world(tmp_path_factory.mktemp("scan"), k, rng)
    return k, idx, _table(k, rng)


@pytest.fixture(scope="module")
def jax_scan(scan_world):
    """JAX's fused scan against its table sharded over 8 devices
    (``_scan_ref_fused_sharded``), chunk by chunk, for each setting."""
    k, idx, table = scan_world
    mesh = jmake_mesh(8, model_parallel=2)
    jtable = JShardedCountTable(
        table=jax.device_put(table.reshape(table_shape(k)),
                             NamedSharding(mesh, P(mesh.axis_names))),
        k=k, mesh=mesh)
    packed, mask = (jnp.asarray(a) for a in _buffers(idx))
    out = {}
    for target, offs in _chunks(idx):
        for n, (window, r1, r2) in enumerate(SETTINGS):
            one_min, three_min = window_thresholds(window, r1, r2)
            scan = jeref._scan_ref_fused_sharded(
                mesh, k, 3, target=target, perm_key=perm_to_key(idx.perm), k=k, window=window,
                one_min=one_min, three_min=three_min, least_depth=3)
            out[target, n] = np.asarray(scan(jtable.table, packed, mask,
                                                  *(jnp.asarray(offs[:, c], jnp.int32)
                                                    for c in range(3))))
    return out


@pytest.mark.parametrize("world", [1, 2, 3])
def test_or_of_shard_hits_equals_scan_chunk_and_jax(scan_world, jax_scan, world):
    """Each rank's ``scan_hits_plain`` on its shard, OR-ed over the ranks,
    then ``window_hits_plain``: the flags of ``scan_chunk_plain`` on the
    whole table and JAX's sharded bits, on chunks with pad rows, references
    shorter than k and slices whose tails hold the next reference."""
    k, idx, table = scan_world
    size = -(-(1 << k) // world)
    shards = np.zeros(size * world, np.uint8)
    shards[:1 << k] = table
    packed, mask = (torch.from_numpy(a) for a in _buffers(idx))
    whole = torch.from_numpy(table)
    checked = 0
    for target, offs in _chunks(idx):
        offs = torch.from_numpy(offs)
        planes = [kernels.scan_hits(packed, mask, offs, torch.from_numpy(shards[r * size:
                                                                              (r + 1) * size]),
                                    r * size, idx.perm, k, target, 3, None)
                  for r in range(world)]
        assert all(p.shape == (offs.shape[0], 3, target // 8) for p in planes)
        ored = planes[0]
        for p in planes[1:]:
            assert not (ored & p).any()  # each hit bit has one owning rank
            ored = ored + p
        for n, (window, r1, r2) in enumerate(SETTINGS):
            one_min, three_min = window_thresholds(window, r1, r2)
            got = kernels.window_hits(ored, window, one_min, three_min)
            want = kernels.scan_chunk(packed, mask, offs, whole, idx.perm, k, target, window,
                                      one_min, three_min, 3)
            assert torch.equal(got, want)
            np.testing.assert_array_equal(got.numpy(), jax_scan[target, n])
            checked += 1
    assert checked >= 9 and not any(kernels.LAUNCHES[n] for n in ("scan_hits", "window_hits"))


def test_scan_hits_and_window_hits_check_their_inputs(scan_world):
    k, idx, table = scan_world
    packed, mask = (torch.from_numpy(a) for a in _buffers(idx))
    target, offs = _chunks(idx)[0]
    offs = torch.from_numpy(offs)
    shard = torch.from_numpy(table[:1 << (k - 1)])
    assert kernels.scan_hits(packed, mask, offs, shard, 1 << (k - 1), idx.perm, k,
                             target, 3, None).shape == (offs.shape[0], 3, target // 8)
    past = offs.clone()
    past[0, 0] = packed.numel() - target // 4 + 1
    for bad in ((packed, mask, past, shard, 0), (packed, mask, offs.int(), shard, 0),
                (packed, mask, offs, shard.int(), 0), (packed, mask, offs, shard, -1),
                (packed, mask, offs, shard, 1 << k)):
        with pytest.raises(ValueError):
            kernels.scan_hits(*bad, idx.perm, k, target, 3, None)
    planes = torch.zeros(2, 3, 64, dtype=torch.uint8)
    for bad in ((planes.int(), 50), (planes[:, :2], 50), (planes, 0),
                (planes, kernels.GOOD_WINDOWS_MAX_WINDOW + 1)):
        with pytest.raises(ValueError):
            kernels.window_hits(bad[0], bad[1], 1, 1)


# -- 4. Phase B and run_search under a mesh ------------------------------------------------

@pytest.fixture(scope="module")
def search_refs(job, tmp_path_factory):
    """JAX's ``run_search(mesh=make_mesh(8, model_parallel=2))`` and the
    port's one-process ``run_search``: their hits and files."""
    out = tmp_path_factory.mktemp("search_refs")
    fqs = [str(f) for f in job["fastqs"]]
    jidx = jindex.build_index(job["db"], k=worker.K, coder_seed=1, save=False)
    jhits = jeref.run_search(*fqs, jidx, JPARAMS, out / "jax.txt",
                             mesh=jmake_mesh(8, model_parallel=2))
    index = tindex.build_index(job["db"], k=worker.K, coder_seed=1, save=False)
    hits = eref.run_search(*fqs, index, worker.PARAMS, out / "port.txt", device="cpu")
    assert [h.line() for h in hits] == [h.line() for h in jhits]
    assert [h.ref_index for h in hits] == [2]
    return [h.line() for h in hits], (out / "jax.txt").read_bytes()


@pytest.mark.parametrize("layout", [(1, 1), (2, 1), (1, 2)])
def test_run_search_under_a_mesh_equals_jax_and_one_process(job, spawned, search_refs, layout,
                                                            tmp_path):
    want, file = search_refs
    if layout == (1, 1):
        got = [worker.search_job(_one_rank(), job, tmp_path)]
        out = tmp_path
    else:
        ranks, out = spawned(2)
        got = [r["layouts"][layout]["search"] for r in ranks]
    for r in got:
        assert r["hits"] == want and r["run"] == want
    name = f"ref_names_{layout[0]}x{layout[1]}_rank"
    assert (out / f"{name}0.txt").read_bytes() == file
    assert sorted(p.name for p in out.glob(name + "*")) == [f"{name}0.txt"]  # rank 0 alone


# -- 5. run_search_distributed ----------------------------------------------------------

def test_run_search_distributed_equals_jax_single_process(job, spawned, tmp_path):
    fqs = [str(f) for f in job["dist_fastqs"]]
    jidx = jindex.build_index(job["db"], k=worker.K, coder_seed=1, save=False)
    jhits = jeref.run_search(*fqs, jidx, JPARAMS, tmp_path / "jax.txt")
    ranks, out = spawned(2)
    runs = [r["distributed"] for r in ranks]
    # rank 0 reads a.fastq (5,802 reads: 2 batches), rank 1 b.fastq (1,000:
    # 1 batch) and one all-pad batch
    assert [len(r["updates"]) for r in runs] == [2, 2]
    assert all(local for r in runs for local in r["updates"])
    assert all(r["hits"] == [h.line() for h in jhits] for r in runs) and jhits
    assert (out / "dist_rank0.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert not (out / "dist_rank1.txt").exists()


# -- 6. the pipeline under a mesh ------------------------------------------------------

def test_run_pipeline_under_a_mesh_equals_jax_and_one_process(job, spawned):
    jcfg = jgcn.GCNConfig(**SMALL)
    jmesh = jmake_mesh(8)
    jp = {k: jnp.asarray(v) for k, v in job["pipeline_jax_params"].items()}
    tp = job["pipeline_params"]

    def jax_scorer(fasta, out):
        return jscoring.score_fasta(jp, fasta, out, jcfg, batch_size=8, mesh=jmesh)

    def port_scorer(fasta, out):
        return tscoring.score_fasta(tp, fasta, out, tgcn.GCNConfig(**SMALL), batch_size=8,
                                    device="cpu")

    final_j = jdriver.run_pipeline(jconfig.PalaceConfig.from_file(job["pipeline_jax_cfg"]),
                                   mesh=jmesh, scorer=jax_scorer)
    final_one = tdriver.run_pipeline(tconfig.PalaceConfig.from_file(job["pipeline_one_cfg"]),
                                     scorer=port_scorer, device="cpu")
    ranks, _ = spawned(2)
    runs = [r["pipeline"] for r in ranks]
    final = tconfig.PalaceConfig.from_file(job["pipeline_cfg"]).output_files()["final_fasta"]
    assert [r["final"] for r in runs] == [str(final)] * 2
    assert final.read_bytes() == final_j.read_bytes() == final_one.read_bytes()
    assert final.read_bytes().count(b">") >= 2
    search = "output/03-search"
    root = {"jax": final_j.parents[2], "mesh": final.parents[2]}
    names = {k: (v / search / "demo_ref_names.txt").read_bytes() for k, v in root.items()}
    assert names["mesh"] == names["jax"] and names["mesh"].count(b"ref_index") == 2
    got = tscoring.read_scores(root["mesh"] / search / "node_scores.out")
    want = tscoring.read_scores(root["jax"] / search / "node_scores.out")
    assert list(got) == list(want) and max(abs(got[k] - want[k]) for k in want) <= 1e-5
    assert runs[0]["writes"] and runs[1]["writes"] == []  # rank 0 alone writes


def test_pipeline_skip_decision_is_rank0s(tmp_path, monkeypatch):
    """A collective stage runs on every rank or on none, as rank 0 decides:
    a rank that sees the output already there still runs it when rank 0
    does not (a mesh of one rank here, where rank 0's decision is its own),
    and a host stage runs on rank 0 alone."""
    cfg = tconfig.PalaceConfig(out_dir=str(tmp_path))
    pipe = tdriver.PalacePipeline(cfg, device="cpu", mesh=_one_rank())
    ran = []
    out = tmp_path / "x.txt"
    pipe._stage("c", lambda: (ran.append("c"), out.write_text("y")), [out], collective=True)
    pipe._stage("c", lambda: ran.append("again"), [out], collective=True)
    pipe.rank0 = False  # a rank other than 0: host stages are not its own
    pipe._stage("h", lambda: ran.append("h"), [tmp_path / "h.txt"])
    monkeypatch.setattr(pipe, "_rank0_says", lambda flag: True)
    pipe._stage("c", lambda: ran.append("follows"), [out], collective=True)
    assert ran == ["c", "follows"]
    assert [(r.name, r.skipped) for r in pipe.runner.results] == [("c", False), ("c", True)]
