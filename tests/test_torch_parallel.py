"""The port's GCN across devices (``palace_tpu_torch.parallel``, the
scorer's, ``train_step``'s, ``fit``'s and the checkpoints' ``mesh=``)
against palace_tpu on its 8 virtual CPU devices and against the port on
one device.

JAX's mesh is one process; the port's is one process a rank.  Ranks are
spawned under gloo with a ``file://`` store in ``tmp_path``
(``tests/_torch_parallel_worker.py``, one CPU thread each, no JAX;
``chip_smoke.spawn_ranks``); JAX runs in this process.  Three spawns cover the layouts:

* 2 ranks: (data, model) = (2, 1) and (1, 2): ``train_step``, a
  two-epoch ``fit`` at dropout 0.2, the scorer, a checkpoint written
  under (1, 2) and restored under (2, 1) and on one rank;
* 4 ranks: (2, 2);
* 3 ranks: (1, 3), where ``pnode_d`` splits 3 ways and ``d1``'s 2,752
  rows do not divide, so ``d1`` stays replicated.

Tolerances: a sharded step's loss within 1e-5 relative of JAX's
one-device ``train_step`` (JAX holds its own sharded step to its
one-device step so), its parameters within 1e-5 with
tests/test_torch_train.py's caveat for Adam (``_assert_params_close``);
scores within 1e-5 of JAX's ``score_sequences``
(tests/test_torch_pipeline.py's bound at this config).  Against the port
on one device: the sharded ``fit`` draws the very masks of the
one-device ``fit`` (every rank draws the whole batch's mask and keeps
its block), so its losses agree to 1e-6 relative and its parameters to
1e-6 with the same caveat: only the order in which the ranks' partial
sums are added differs, and no split of a sum can keep that order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_parallel_worker as worker
import chip_smoke
from palace_tpu.models import gcn as jgcn
from palace_tpu.models import scoring as jscoring
from palace_tpu.models import train as jtrain
from palace_tpu.parallel import distributed as jdist
from palace_tpu.parallel import mesh as jmesh
from palace_tpu_torch.io.fasta import write_fasta
from palace_tpu_torch.models import checkpoint, gcn, scoring, train
from palace_tpu_torch.parallel import best_mesh_shape, data_sharding, make_mesh, replicate
from palace_tpu_torch.parallel import distributed, mesh as pmesh

JCFG = jgcn.GCNConfig(fnode_num=8)
JCFG0 = dataclasses.replace(JCFG, drop_rate=0.0)
JSCORE = jgcn.GCNConfig(gcn_dim=16, cnn_dim=8, fc_dim=8)
B = 8
LAYOUTS = [(2, 1), (1, 2), (2, 2), (1, 3)]
WORLD_OF = {(2, 1): 2, (1, 2): 2, (2, 2): 4, (1, 3): 3}
JOBS = {2: dict(model_parallel=(1, 2), fit=True, score=True, checkpoint=True),
        3: dict(model_parallel=(3,)),
        4: dict(model_parallel=(2,))}
SPAWN_TIMEOUT_S = 240


def _contigs():
    rng = np.random.default_rng(3)
    lens = [1200, 800, 2000, 150, 3000, 600, 1000]
    return [(f"c{i}", "".join(rng.choice(list("ACGT"), size=n))) for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The inputs every rank gets, as numpy: JAX's small-arch parameters
    and batch (tests/test_train_and_sharding.py's ``_batch``), a toy
    training set, contigs in a FASTA, and an array to gather."""
    rng = np.random.default_rng(1)
    x_p = rng.normal(0, 1, (B, JCFG.pnode_num, JCFG.hidden_dim)).astype(np.float32)
    x_f = rng.normal(0, 1, (B, JCFG.fnode_num, 1)).astype(np.float32)
    y = rng.integers(0, 2, (B,)).astype(np.int32)
    params = {k: np.asarray(v) for k, v in jgcn.init_params(jax.random.PRNGKey(2), JCFG).items()}
    feats = rng.normal(0, 1, (20, JCFG.hidden_dim * JCFG.pnode_num)).astype(np.float32)
    labels = (np.arange(20) % 2).astype(np.int64)
    feats[labels == 1, :20] += 3.0
    fasta = tmp_path_factory.mktemp("contigs") / "contigs.fasta"
    write_fasta(fasta, _contigs(), width=60)
    return dict(params=params, x_p=x_p, x_f=x_f, y=y, feats=feats, labels=labels, batch=B,
                seed=7, contigs=_contigs(), fasta=str(fasta), score_seed=3, score_batch=3,
                **{"global": np.arange(24 * 6, dtype=np.float32).reshape(24, 6)})


@pytest.fixture(scope="module")
def spawned(job, tmp_path_factory):
    """Each world's ranks, spawned once, lazily."""
    cache = {}

    def get(world: int):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"world{world}")
            ranks = chip_smoke.spawn_ranks(worker.run, world, dict(job, **JOBS[world]), out,
                                           SPAWN_TIMEOUT_S)
            cache[world] = (ranks, out)
        return cache[world]

    return get


@pytest.fixture(scope="module")
def jax_step(job):
    """JAX's one-device ``train_step`` at dropout 0 from the job's state."""
    state = jtrain.init_train_state({k: jnp.asarray(v) for k, v in job["params"].items()},
                                    worker.LR)
    new, loss = jtrain.train_step(state, jnp.asarray(job["x_p"]), jnp.asarray(job["x_f"]),
                                  jnp.asarray(job["y"]), jax.random.PRNGKey(0), JCFG0, worker.LR)
    return float(loss), {k: np.asarray(v) for k, v in new.params.items()}


@pytest.fixture(scope="module")
def jax_scores(job):
    params = {k: jnp.asarray(v.numpy()) for k, v in worker.score_params(job["score_seed"]).items()}
    return dict(jscoring.score_sequences(params, job["contigs"], JSCORE, batch_size=4))


def _layout(spawned, layout):
    ranks, out = spawned(WORLD_OF[layout])
    return [r["layouts"][layout] for r in ranks], ranks, out


# -- no ranks: the arithmetic against JAX's ---------------------------------------------

def test_best_mesh_shape_equals_jax():
    for n in range(1, 17):
        for mp in range(0, 10):
            assert best_mesh_shape(n, mp) == jmesh.best_mesh_shape(n, mp), (n, mp)


@pytest.mark.parametrize("pcount", [1, 2, 3, 4])
def test_input_sharding_equals_jax(pcount):
    paths = [f"f{i}.fq" for i in (5, 0, 3, 6, 1, 4, 2)]
    for pid in range(pcount):
        assert (distributed.shard_inputs_for_process(paths, pid, pcount)
                == jdist.shard_inputs_for_process(paths, pid, pcount))
        assert ([distributed.keep_record_for_process(i, pid, pcount) for i in range(50)]
                == [jdist.keep_record_for_process(i, pid, pcount) for i in range(50)])


def test_initialize_is_a_no_op_without_a_process_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.dp, mesh.mp, mesh.coords, mesh.data_group) == (1, 1, (0, 0), None)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(data_sharding(x, mesh), x)
    assert torch.equal(replicate(x, mesh), x)
    assert distributed.shard_inputs_for_process(["b", "a"]) == ["a", "b"]


def _mesh(dp, mp, rank):
    return pmesh.Mesh(np.arange(dp * mp).reshape(dp, mp), rank, torch.device("cpu"))


def test_param_specs_fall_back_to_replication():
    """d1's 4075·64 rows under a 3-way model axis replicate, as at
    palace_tpu/parallel/mesh.py:68-83; pnode_d's 12,288 columns split."""
    full = {n: torch.empty(s, device="meta") for n, s in
            (("pnode_d.w", (12288, 12288)), ("pnode_d.b", (12288,)), ("d1.w", (260800, 100)),
             ("d1.b", (100,)), ("fnode_d.w", (64, 192)))}
    specs = pmesh.gcn_param_specs(full, _mesh(1, 3, 2))
    assert specs == {"pnode_d.w": (None, "model"), "pnode_d.b": ("model",), "d1.w": (),
                     "d1.b": (), "fnode_d.w": ()}
    assert pmesh.gcn_param_specs(full, _mesh(2, 2, 3))["d1.w"] == ("model", None)


def test_shards_are_the_rank_blocks():
    x = torch.arange(24.0).reshape(4, 6)
    mesh = _mesh(2, 3, 5)  # coords (1, 2)
    assert mesh.coords == (1, 2)
    assert torch.equal(pmesh.local_shard(x, ("data", "model"), mesh), x[2:, 4:])
    assert torch.equal(pmesh.local_shard(x, (None, "model"), mesh), x[:, 4:])
    assert torch.equal(data_sharding(x, mesh), x[2:])
    local, specs = pmesh.shard_params_for_gcn({"pnode_d.w": x, "d1.w": x}, mesh)
    assert torch.equal(local["pnode_d.w"], x[:, 4:]) and local["pnode_d.w"].is_contiguous()
    assert specs["d1.w"] == () and torch.equal(local["d1.w"], x)  # 4 rows, 3 ways
    local["d1.w"][0, 0] = -1.0  # shards are tensors of their own
    assert x[0, 0] == 0.0
    with pytest.raises(ValueError):
        pmesh.block(torch.zeros(5, 2), mesh, "data")


@pytest.mark.parametrize("dp", [2, 4])
def test_dropout_under_a_mesh_keeps_its_block_of_the_global_mask(dp):
    x = torch.randn(8, 5, 3, generator=torch.Generator().manual_seed(0))
    want = gcn.dropout(x, 0.4, torch.Generator().manual_seed(9))
    size = 8 // dp
    for d in range(dp):
        got = gcn.dropout(x[d * size:(d + 1) * size], 0.4, torch.Generator().manual_seed(9),
                          _mesh(dp, 1, d))
        assert torch.equal(got, want[d * size:(d + 1) * size])


# -- train_step on every layout --------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_train_step_loss_equals_jax(spawned, jax_step, layout):
    per_rank, _, _ = _layout(spawned, layout)
    want, _ = jax_step
    for got in per_rank:
        np.testing.assert_allclose(got["train_step"]["loss"], want, rtol=1e-5)


def _assert_params_close(got, want, tol, steps, lr=worker.LR):
    """Within ``tol`` except at most 1 % of the elements, each within 2·lr a
    step: Adam moves an element by about ±lr whatever the size of its
    gradient, so where a gradient is near 0 a rounding difference in its
    sign moves it by up to 2·lr (tests/test_torch_train.py's caveat)."""
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        beyond = diff > tol + tol * np.abs(w)
        assert beyond.mean() <= 0.01, (name, beyond.mean())
        assert diff.max() <= 2 * lr * steps + tol, (name, diff.max())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_train_step_params_equal_jax(spawned, jax_step, layout):
    per_rank, _, _ = _layout(spawned, layout)
    _, want = jax_step
    for got in per_rank:
        _assert_params_close(got["train_step"]["params"], want, 1e-5, steps=1)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_shards_follow_the_specs(spawned, layout):
    per_rank, _, _ = _layout(spawned, layout)
    dp, mp = layout
    d1_rows = JCFG.flat_dim  # 2,752: splits 2 ways, not 3
    for r, got in enumerate(per_rank):
        assert got["coords"] == (r // mp, r % mp)
        step = got["train_step"]
        width = 3 * JCFG.pnode_num
        assert step["shapes"]["pnode_d.w"] == (width, width // mp)
        assert step["shapes"]["pnode_d.b"] == (width // mp,)
        if d1_rows % mp:
            assert step["specs"]["d1.w"] == () and step["shapes"]["d1.w"] == (d1_rows, 100)
        else:
            assert step["specs"]["d1.w"] == ("model", None)
            assert step["shapes"]["d1.w"] == (d1_rows // mp, 100)
        assert all(step["specs"][n] == () for n in step["specs"]
                   if n not in ("pnode_d.w", "pnode_d.b", "d1.w"))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_global_array_from_local_equals_jax(spawned, job, eight_devices, layout):
    per_rank, _, _ = _layout(spawned, layout)
    jax_mesh = jmesh.make_mesh(8, model_parallel=2)
    for spec in (("data", None), (None, "model"), ("data", "model")):
        want = np.asarray(jdist.global_array_from_local(job["global"], jax_mesh, P(*spec)))
        for got in per_rank:
            np.testing.assert_array_equal(got["global_arrays"][spec], want)


# -- fit, the scorer and checkpoints on two ranks --------------------------------------

@pytest.mark.parametrize("layout", [(2, 1), (1, 2)])
def test_sharded_fit_with_dropout_equals_one_device_fit(spawned, layout):
    per_rank, ranks, _ = _layout(spawned, layout)
    want = ranks[0]["fit_one_device"]
    for got in per_rank:
        np.testing.assert_allclose(got["fit"]["losses"], want["losses"], rtol=1e-6)
        _assert_params_close(got["fit"]["params"], want["params"], 1e-6, steps=6)
    # dropout was on: the losses are not those of a run without it
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)])
def test_sharded_scores_equal_jax_and_one_rank(spawned, jax_scores, job, layout):
    per_rank, ranks, out = _layout(spawned, layout)
    one = ranks[0]["score_one_rank"]
    names = [n for n, _ in job["contigs"]]
    spread = np.ptp(list(jax_scores.values()))
    assert spread > 0.05, spread  # the scaled weights spread the probabilities
    for got in per_rank:
        assert [n for n, _ in got["score"]["probs"]] == names
        probs = dict(got["score"]["probs"])
        assert max(abs(probs[k] - jax_scores[k]) for k in names) <= 1e-5
        assert max(abs(probs[k] - p) for k, p in one["probs"]) <= 1e-6
        assert got["score"]["n"] == len(names)
    written = scoring.read_scores(out / f"node_scores_{layout[0]}x{layout[1]}.out")
    assert list(written) == names
    want = scoring.read_scores(out / "node_scores_1x1.out")
    assert max(abs(written[k] - want[k]) for k in names) <= 1e-6


def test_checkpoint_saved_under_1x2_restores_under_2x1_and_on_one_rank(spawned, job):
    ranks, out = spawned(2)
    for r in ranks:
        ck = r["checkpoint"]
        assert ck["layouts"] == ((1, 2), (2, 1)) and ck["step"] == 1
        assert ck["adam_step"] == (1.0, 1.0)
        for part in ("params", "exp_avg", "exp_avg_sq"):
            for name, w in ck["saved"][part].items():
                np.testing.assert_array_equal(ck["restored"][part][name], w, err_msg=name)
    saved = ranks[0]["checkpoint"]["saved"]
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["1.pt"]
    # on one rank, into a one-device state: the same whole tensors
    template = train.init_train_state({k: torch.zeros(v.shape) for k, v in job["params"].items()},
                                      worker.TRAIN_CFG0, worker.LR, device="cpu")
    state = checkpoint.restore_train_state(out / "ckpt", template)
    mu, nu, count = train.adam_moments(state)
    assert state.step == 1 and count == 1.0
    for name, p in state.model.params().items():
        np.testing.assert_array_equal(p.detach().numpy(), saved["params"][name])
        np.testing.assert_array_equal(mu[name].numpy(), saved["exp_avg"][name])
        np.testing.assert_array_equal(nu[name].numpy(), saved["exp_avg_sq"][name])


# -- the scorer against JAX's own mesh ------------------------------------------------

@pytest.mark.slow
def test_scores_equal_jax_scorer_on_its_8_device_mesh(spawned, job, eight_devices):
    """JAX's ``score_sequences`` on ``make_mesh(8, model_parallel=2)`` (its
    batch sharded over 4 data devices) against the port's (1, 2) ranks."""
    params = {k: jnp.asarray(v.numpy()) for k, v in worker.score_params(job["score_seed"]).items()}
    want = dict(jscoring.score_sequences(params, job["contigs"], JSCORE, batch_size=4,
                                         mesh=jmesh.make_mesh(8, model_parallel=2)))
    per_rank, _, _ = _layout(spawned, (1, 2))
    for got in per_rank:
        probs = dict(got["score"]["probs"])
        assert max(abs(probs[k] - want[k]) for k in want) <= 1e-5
