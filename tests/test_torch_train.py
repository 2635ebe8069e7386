"""The port's training (``palace_tpu_torch.models.train``) and checkpoints
(``models.checkpoint``) against palace_tpu's ``train_step``, ``loss_fn``
and ``fit`` on the CPU, at JAX's small test config.

JAX runs as its own tests run it here: ``forward`` with a dropout key
(the XLA path, no Pallas kernel), ``train_step`` and ``fit`` jitted.
State crosses as numpy arrays (``params_from_jax``,
``train_state_from_jax``).  The two sides draw dropout from different
generators, so every comparison with JAX is at ``drop_rate=0``; the
dropout itself is held to JAX's semantics and site order on its own.

Tolerances: logits and loss 1e-5; each gradient tensor within 1e-5 of its
largest magnitude; Adam on identical gradients 1e-6 relative; ``fit``'s
per-epoch losses 1e-4 relative; probabilities 1e-5.  Parameters after
several steps carry a caveat: at each step Adam moves an element by about
±lr whatever the size of its gradient, so where a gradient is near 0 a
rounding difference in its sign moves that element by up to 2·lr.  They
are held to 1e-5 except for a share of at most 1 % of the elements, each
within 2·lr a step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from palace_tpu.models import gcn as jgcn
from palace_tpu.models import train as jtrain
from palace_tpu_torch.models import checkpoint, train
from palace_tpu_torch.models import gcn as tgcn

SMALL = dict(fnode_num=8, gcn_dim=16, cnn_dim=8, fc_dim=10)
JCFG, TCFG = jgcn.GCNConfig(**SMALL), tgcn.GCNConfig(**SMALL)
JCFG0 = dataclasses.replace(JCFG, drop_rate=0.0)
TCFG0 = dataclasses.replace(TCFG, drop_rate=0.0)
LR = 1e-3
SEED = 5
B = 16


def _toy_data(n, seed=0):
    """Two feature clusters, as tests/test_train_checkpoint.py makes them."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (n, JCFG.hidden_dim * JCFG.pnode_num)).astype(np.float32)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats[labels == 1, :20] += 3.0
    return feats, labels


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_state_np(state):
    """A JAX TrainState as numpy: params, optax's (count, mu, nu), step."""
    adam = state.opt_state[0]
    return dict(params=_np(state.params), mu=_np(adam.mu), nu=_np(adam.nu),
                count=int(adam.count), step=int(state.step))


def _port_state(js, cfg=TCFG0, lr=LR):
    return train.train_state_from_jax(js["params"], js["mu"], js["nu"], js["count"], js["step"],
                                      cfg, lr, device="cpu")


def _port_params(state):
    return {k: v.detach().numpy().copy() for k, v in state.model.params().items()}


def _assert_params_close(got, want, steps, lr=LR):
    """The stated caveat: 1e-5 except at most 1 % of elements, each within
    2·lr a step."""
    for name in want:
        diff = np.abs(got[name] - want[name])
        beyond = diff > 1e-5 + 1e-5 * np.abs(want[name])
        assert beyond.mean() <= 0.01, (name, beyond.mean())
        assert diff.max() <= 2 * lr * steps + 1e-5, (name, diff.max())


@pytest.fixture(scope="module")
def world():
    """JAX's side, computed once: initial parameters, a batch, its logits,
    loss and gradients, three optax steps, ``fit`` over a wrapping batch
    and ``fit`` resumed."""
    params = jgcn.init_params(jax.random.PRNGKey(1), JCFG)
    feats, labels = _toy_data(40)
    xb = jnp.asarray(feats[:B])
    x_p, x_f = jgcn.model_inputs_from_features(xb, JCFG)
    y = jnp.asarray(labels[:B])
    key = jax.random.PRNGKey(2)
    out = dict(params=_np(params), feats=feats, labels=labels,
               x_p=np.asarray(x_p), x_f=np.asarray(x_f), y=np.asarray(y))
    out["logits"] = np.asarray(jgcn.forward(params, x_p, x_f, JCFG0, dropout_key=key,
                                            return_logits=True))
    loss, grads = jax.value_and_grad(jtrain.loss_fn)(params, x_p, x_f, y, JCFG0, key)
    out["loss"], out["grads"] = float(loss), _np(grads)

    # three Adam steps, each on the gradients at JAX's own current parameters
    opt = jtrain.make_optimizer(LR)
    p, opt_state, steps = params, opt.init(params), []
    for t in range(3):
        xs = [jnp.asarray(a) for a in jgcn.model_inputs_from_features(
            jnp.asarray(feats[B * (t % 2): B * (t % 2) + B]), JCFG)]
        g = jax.grad(jtrain.loss_fn)(p, *xs, jnp.asarray(labels[:B]), JCFG0, key)
        updates, opt_state = opt.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        steps.append(dict(grads=_np(g), params=_np(p), mu=_np(opt_state[0].mu),
                          nu=_np(opt_state[0].nu), count=int(opt_state[0].count)))
    out["adam"] = steps

    # fit over n = 40 at batch 16: 3 batches an epoch, the last one wrapped
    state0 = jtrain.init_train_state(params, LR)
    out["state0"] = _jax_state_np(state0)  # before fit: train_step donates its state
    fitted, losses = jtrain.fit(feats, labels, JCFG0, epochs=3, batch_size=B,
                                learning_rate=LR, seed=SEED, init_state=state0)
    out["fit"] = dict(_jax_state_np(fitted), losses=losses)

    # resume, as JAX's fit resumes: the same state, the key and the permutation from seed
    f32, l32 = feats[:32], labels[:32]
    s1, first = jtrain.fit(f32, l32, JCFG0, epochs=1, batch_size=B, learning_rate=LR,
                           seed=SEED, init_state=jtrain.init_train_state(params, LR))
    s2, second = jtrain.fit(f32, l32, JCFG0, epochs=1, batch_size=B, learning_rate=LR,
                            seed=SEED, init_state=s1)
    out["resume"] = dict(_jax_state_np(s2), first=first, second=second)
    return out


def _batch(world):
    return tuple(torch.from_numpy(world[k].copy()) for k in ("x_p", "x_f", "y"))


# -- forward, loss and gradients ---------------------------------------------------------

def test_logits_and_loss_equal_jax(world):
    params = tgcn.params_from_jax(world["params"])
    x_p, x_f, y = _batch(world)
    logits = tgcn.train_forward(params, x_p, x_f, TCFG0, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(logits.numpy(), world["logits"], rtol=1e-5, atol=1e-5)
    loss = train.loss_fn(params, x_p, x_f, y, TCFG0, torch.Generator().manual_seed(0))
    assert abs(float(loss) - world["loss"]) <= 1e-5
    # the trainable module's eval forward is the same function
    model = tgcn.TrainableGCN(params, TCFG)
    np.testing.assert_allclose(model(x_p, x_f, return_logits=True).detach().numpy(),
                               world["logits"], rtol=1e-5, atol=1e-5)


def test_gradients_equal_jax(world):
    state = train.init_train_state(tgcn.params_from_jax(world["params"]), TCFG0, device="cpu")
    loss, grads = train.value_and_grad(state.model, *_batch(world), TCFG0,
                                       torch.Generator().manual_seed(0))
    assert abs(float(loss) - world["loss"]) <= 1e-5
    assert set(grads) == set(world["grads"])
    for name, want in world["grads"].items():
        scale = np.abs(want).max()
        if name.startswith("convs_2.1."):  # the last round's f-node side reaches no output
            assert scale == 0 and not grads[name].any(), name
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_adam_on_identical_gradients_equals_optax(world):
    state = train.init_train_state(tgcn.params_from_jax(world["params"]), TCFG0, LR,
                                   device="cpu")
    for t, want in enumerate(world["adam"], 1):
        for name, p in state.model.params().items():
            p.grad = torch.from_numpy(want["grads"][name].copy())
        state.optimizer.step()
        mu, nu, count = train.adam_moments(state)
        assert count == want["count"] == t
        got = _port_params(state)
        for name in want["params"]:
            np.testing.assert_allclose(got[name], want["params"][name], rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {t} {name}")
            np.testing.assert_allclose(mu[name].numpy(), want["mu"][name], rtol=1e-6,
                                       atol=1e-12, err_msg=f"step {t} mu {name}")
            np.testing.assert_allclose(nu[name].numpy(), want["nu"][name], rtol=1e-6,
                                       atol=1e-15, err_msg=f"step {t} nu {name}")
            # the update itself, relative to the learning rate
            step_got = got[name] - (world["adam"][t - 2]["params"][name] if t > 1
                                    else world["params"][name])
            step_want = want["params"][name] - (world["adam"][t - 2]["params"][name] if t > 1
                                                else world["params"][name])
            np.testing.assert_allclose(step_got, step_want, rtol=0, atol=1e-6 * LR * 10,
                                       err_msg=f"step {t} update {name}")


# -- fit --------------------------------------------------------------------------------

def test_fit_over_a_wrapping_batch_equals_jax(world):
    state, losses = train.fit(world["feats"], world["labels"], TCFG0, epochs=3, batch_size=B,
                              learning_rate=LR, seed=SEED, init_state=_port_state(world["state0"]),
                              device="cpu")
    want = world["fit"]
    assert state.step == want["step"] == 9  # 3 epochs of 3 batches
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    _assert_params_close(_port_params(state), want["params"], steps=9)
    assert train.adam_moments(state)[2] == want["count"] == 9


def test_epoch_batches_wrap_as_jax():
    order = np.arange(40)[::-1]
    batches = train._epoch_batches(order, 16)
    assert batches.shape == (3, 16)
    np.testing.assert_array_equal(batches[2], np.r_[order[32:], order[:8]])
    # fewer examples than a batch: the loop wraps until it is full
    np.testing.assert_array_equal(train._epoch_batches(np.array([2, 0, 1]), 7)[0],
                                  [2, 0, 1, 2, 0, 1, 2])


def test_fit_resumes_from_checkpoint_as_jax(world, tmp_path):
    """Two calls with one ckpt_dir reach step 4, and the second equals JAX's
    resume semantics: ``fit(init_state=<state after the first call>)``."""
    f32, l32 = world["feats"][:32], world["labels"][:32]
    ckpt = tmp_path / "ckpt"
    _, first = train.fit(f32, l32, TCFG0, epochs=1, batch_size=B, learning_rate=LR, seed=SEED,
                         init_state=_port_state(world["state0"]), ckpt_dir=ckpt, device="cpu")
    assert checkpoint.latest_step(ckpt) == 2
    # a fresh template: the checkpoint replaces its parameters, moments and step
    state, second = train.fit(f32, l32, TCFG0, epochs=1, batch_size=B, learning_rate=LR,
                              seed=SEED, init_state=_port_state(world["state0"]),
                              ckpt_dir=ckpt, device="cpu")
    want = world["resume"]
    assert state.step == want["step"] == 4 and checkpoint.latest_step(ckpt) == 4
    np.testing.assert_allclose(first, want["first"], rtol=1e-4)
    np.testing.assert_allclose(second, want["second"], rtol=1e-4)
    _assert_params_close(_port_params(state), want["params"], steps=4)


def test_fit_from_seed_resumes_from_checkpoint(tmp_path):
    """JAX's test_fit_resumes_from_checkpoint, on the port alone."""
    feats, labels = _toy_data(32)
    ckpt = tmp_path / "ckpt"
    train.fit(feats, labels, TCFG0, epochs=1, batch_size=B, learning_rate=LR, ckpt_dir=ckpt,
              device="cpu")
    assert checkpoint.latest_step(ckpt) == 2
    state, _ = train.fit(feats, labels, TCFG0, epochs=1, batch_size=B, learning_rate=LR,
                         ckpt_dir=ckpt, device="cpu")
    assert state.step == 4


def test_fit_with_dropout_learns_and_repeats():
    feats, labels = _toy_data(32)
    runs = [train.fit(feats, labels, TCFG, epochs=3, batch_size=B, learning_rate=LR, seed=3,
                      device="cpu") for _ in range(2)]
    (s1, l1), (s2, l2) = runs
    assert l1 == l2 and l1[-1] < l1[0] and np.isfinite(l1).all()
    for name, p in s1.model.params().items():
        assert torch.equal(p, s2.model.params()[name]), name


def test_trained_parameters_score_as_jax(world):
    state, _ = train.fit(world["feats"], world["labels"], TCFG0, epochs=1, batch_size=B,
                         learning_rate=LR, seed=SEED, init_state=_port_state(world["state0"]),
                         device="cpu")
    params = _port_params(state)
    feats = world["feats"][:12]
    want = np.asarray(jgcn.phage_probabilities({k: jnp.asarray(v) for k, v in params.items()},
                                               jnp.asarray(feats), JCFG))
    scorer = tgcn.GCNScorer(state.model.params(), TCFG)
    got = scorer.score_features(torch.from_numpy(feats), plain=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the training module's eval forward agrees with the scorer
    x_p, x_f = tgcn.model_inputs_from_features(torch.from_numpy(feats), TCFG)
    with torch.no_grad():
        np.testing.assert_allclose(state.model(x_p, x_f)[:, 1].numpy(), got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("call", ["fit", "init_train_state", "train_state_from_jax"])
def test_entry_points_raise_without_a_card(world, call):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    js = world["state0"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if call == "fit":
            train.fit(world["feats"], world["labels"], TCFG0, batch_size=B)
        elif call == "init_train_state":
            train.init_train_state(tgcn.params_from_jax(js["params"]), TCFG0)
        else:
            train.train_state_from_jax(js["params"], js["mu"], js["nu"], js["count"],
                                       js["step"], TCFG0)


def test_fit_refuses_a_state_on_another_device(world):
    state = _port_state(world["state0"])
    state.model.to("meta")
    with pytest.raises(ValueError, match="init_state lies on meta"):
        train.fit(world["feats"], world["labels"], TCFG0, init_state=state, device="cpu")


# -- dropout ---------------------------------------------------------------------------

def test_dropout_same_seed_same_mask():
    x = torch.ones(64, 128)
    a = tgcn.dropout(x, 0.2, torch.Generator().manual_seed(9))
    b = tgcn.dropout(x, 0.2, torch.Generator().manual_seed(9))
    c = tgcn.dropout(x, 0.2, torch.Generator().manual_seed(10))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_keeps_its_share_and_scales_what_it_keeps():
    x = torch.rand(1000, 1000, generator=torch.Generator().manual_seed(1)) + 0.5
    y = tgcn.dropout(x, 0.2, torch.Generator().manual_seed(2))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) <= 0.01
    assert torch.equal(y[kept], x[kept] / 0.8)
    np.testing.assert_allclose(y[kept].numpy(), x[kept].numpy() * 1.25, rtol=1e-6)


def test_no_generator_or_no_rate_means_no_dropout():
    x = torch.randn(8, 16)
    assert tgcn.dropout(x, 0.2, None) is x
    assert tgcn.dropout(x, 0.0, torch.Generator()) is x


@pytest.mark.parametrize("site", range(6))
def test_dropout_sites_in_jax_key_order(world, site, monkeypatch):
    """Rate 1 at one site and 0 at the others, on both sides: the site of the
    port's k-th draw is the site of JAX's k-th key."""
    key = jax.random.PRNGKey(4)
    jkeys = np.asarray(jax.random.split(key, 6))
    real_j, real_t = jgcn._dropout, tgcn.dropout

    def jax_dropout(x, rate, k):
        return real_j(x, 1.0 if np.array_equal(np.asarray(k), jkeys[site]) else 0.0, k)

    calls = []

    def port_dropout(x, rate, generator):
        calls.append(tuple(x.shape))
        return real_t(x, 1.0 if len(calls) - 1 == site else 0.0, generator)

    monkeypatch.setattr(jgcn, "_dropout", jax_dropout)
    monkeypatch.setattr(tgcn, "dropout", port_dropout)
    params = tgcn.params_from_jax(world["params"])
    x_p, x_f, _ = _batch(world)
    want = np.asarray(jgcn.forward({k: jnp.asarray(v) for k, v in world["params"].items()},
                                   jnp.asarray(world["x_p"]), jnp.asarray(world["x_f"]), JCFG,
                                   dropout_key=key, return_logits=True))
    got = tgcn.train_forward(params, x_p, x_f, TCFG, torch.Generator().manual_seed(0))
    pn, f, gd, c, L = JCFG.pnode_num, JCFG.fnode_num, JCFG.gcn_dim, JCFG.cnn_dim, JCFG.pnode_num
    assert calls == [(B, pn, gd), (B, f, gd), (B, pn, gd), (B, f, gd), (B, c, L - 14),
                     (B, c, L - 21)]
    # a dropped site changes the logits, except the last round's x_f, which reaches no output
    assert (np.abs(want - world["logits"]).max() > 1e-3) == (site != 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- checkpoints -------------------------------------------------------------------------

def _trained_state(world, steps=2):
    state = _port_state(world["state0"])
    x_p, x_f, y = _batch(world)
    for _ in range(steps):
        train.train_step(state, x_p, x_f, y, torch.Generator().manual_seed(1), TCFG, LR)
    return state


def test_checkpoint_round_trip_is_bit_equal(world, tmp_path):
    state = _trained_state(world)
    assert checkpoint.save_train_state(tmp_path, state) == 2
    template = _port_state(world["state0"])
    restored = checkpoint.restore_train_state(tmp_path, template)
    assert restored is template and restored.step == 2
    for name, p in state.model.params().items():
        assert torch.equal(restored.model.params()[name], p), name
    (mu, nu, count), (mu2, nu2, count2) = train.adam_moments(state), train.adam_moments(restored)
    assert count == count2 == 2
    for name in mu:
        assert torch.equal(mu[name], mu2[name]) and torch.equal(nu[name], nu2[name]), name
    # the restored state steps on exactly as the saved one
    x_p, x_f, y = _batch(world)
    for s in (state, restored):
        train.train_step(s, x_p, x_f, y, None, TCFG, LR)
    for name, p in state.model.params().items():
        assert torch.equal(restored.model.params()[name], p), name


def test_latest_step_and_max_to_keep(world, tmp_path):
    state = _port_state(world["state0"])
    for step in range(1, 6):
        state.step = step
        checkpoint.save_train_state(tmp_path, state, max_to_keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3.pt", "4.pt", "5.pt"]
    assert checkpoint.latest_step(tmp_path) == 5
    assert checkpoint.restore_train_state(tmp_path, _port_state(world["state0"]), step=3).step == 3


def test_empty_or_missing_directory_gives_none(world, tmp_path):
    assert checkpoint.latest_step(tmp_path) is None
    assert checkpoint.latest_step(tmp_path / "missing") is None
    assert checkpoint.restore_train_state(tmp_path, _port_state(world["state0"])) is None
    assert checkpoint.restore_train_state(tmp_path / "missing",
                                          _port_state(world["state0"])) is None


def test_interrupted_save_leaves_the_last_good_checkpoint(world, tmp_path, monkeypatch):
    state = _trained_state(world, steps=1)
    checkpoint.save_train_state(tmp_path, state)

    def torn(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    state.step = 2
    with pytest.raises(OSError):
        checkpoint.save_train_state(tmp_path, state)
    monkeypatch.undo()
    assert checkpoint.latest_step(tmp_path) == 1
    assert checkpoint.restore_train_state(tmp_path, _port_state(world["state0"])).step == 1


def test_checkpoint_reads_no_pickled_code(world, tmp_path):
    """A checkpoint file that would run code when unpickled is refused."""
    class Boom:
        def __reduce__(self):
            return (print, ("ran",))

    torch.save({"step": 1, "params": Boom()}, tmp_path / "1.pt")
    with pytest.raises(Exception, match="[Ww]eights only"):
        checkpoint.restore_train_state(tmp_path, _port_state(world["state0"]))
