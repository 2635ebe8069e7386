"""The port's GCN forward against palace_tpu's ``forward`` on the same
parameters (carried by ``params_from_jax``), at reduced widths.

Weights are drawn with a wide normal spread, so logits differ across
inputs by much more than the tolerance; logits and probabilities are
compared at rtol 2e-4, atol 2e-5 in float32 (tests/test_gcn.py holds
JAX to the PyG oracle at the same tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu.models import gcn as jgcn
from palace_tpu_torch.models import gcn as tgcn


def _state_dict(cfg, rng):
    """Random reference-layout (torch) state dict, as numpy arrays."""
    d3, gd, f, pn = cfg.hidden_dim, cfg.gcn_dim, cfg.fnode_num, cfg.pnode_num
    sd = {}

    def lin(name, n_in, n_out, bias=True):
        sd[f"{name}.weight"] = rng.normal(0, 0.2, (n_out, n_in)).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = rng.normal(0, 0.2, n_out).astype(np.float32)

    lin("pnode_d", pn * d3, pn * d3)
    lin("fnode_d", f, f * d3)
    dims_1 = [(d3, d3), (gd, gd)]
    dims_2 = [(gd, d3), (gd, gd)]
    for i in range(cfg.num_layers):
        for tag, (in_src, in_dst) in (("convs_1", dims_1[i]), ("convs_2", dims_2[i])):
            lin(f"{tag}.{i}.lin_l", in_src, gd)
            lin(f"{tag}.{i}.lin_r", in_dst, gd, bias=False)
    sd["lns.0.weight"] = rng.normal(1, 0.05, gd).astype(np.float32)
    sd["lns.0.bias"] = rng.normal(0, 0.05, gd).astype(np.float32)
    for i, (cin, cout) in enumerate(
            [(gd, cfg.cnn_dim), (cfg.cnn_dim, cfg.cnn_dim), (cfg.cnn_dim, cfg.cnn_dim)], 1):
        sd[f"conv{i}.weight"] = rng.normal(0, 0.1, (cout, cin, cfg.conv_kernel)).astype(np.float32)
        sd[f"conv{i}.bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
    lin("d1", cfg.flat_dim, cfg.fc_dim)
    lin("d2", cfg.fc_dim, 2)
    return sd


def _cfg_pair(**kw):
    return jgcn.GCNConfig(**kw), tgcn.GCNConfig(**kw)


@pytest.mark.parametrize("kw", [dict(fnode_num=8), dict(fnode_num=8, gcn_dim=16, cnn_dim=8),
                                dict(fnode_num=8, num_layers=1)])
def test_forward_equals_jax(kw):
    jcfg, tcfg = _cfg_pair(**kw)
    rng = np.random.default_rng(7)
    sd = _state_dict(jcfg, rng)
    jparams = jgcn.params_from_numpy_state(sd, jcfg)
    tparams = tgcn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})
    B = 4
    x_p = rng.normal(0, 1, (B, jcfg.pnode_num, jcfg.hidden_dim)).astype(np.float32)
    x_f = rng.normal(0, 1, (B, jcfg.fnode_num, 1)).astype(np.float32)

    want_logits = np.asarray(jgcn.forward(jparams, x_p, x_f, jcfg, return_logits=True))
    want = np.asarray(jgcn.forward(jparams, x_p, x_f, jcfg))
    tx_p, tx_f = torch.from_numpy(x_p), torch.from_numpy(x_f)
    got_logits = tgcn.forward(tparams, tx_p, tx_f, tcfg, return_logits=True).numpy()
    got = tgcn.GCNScorer(tparams, tcfg)(tx_p, tx_f).numpy()
    assert np.ptp(want_logits[:, 1] - want_logits[:, 0]) > 0.05  # inputs are told apart
    np.testing.assert_allclose(got_logits, want_logits, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # plain=True takes the same plain versions on the CPU
    np.testing.assert_array_equal(
        tgcn.forward(tparams, tx_p, tx_f, tcfg, return_logits=True, plain=True).numpy(),
        got_logits)


def test_params_from_numpy_state_equal_jax():
    jcfg, tcfg = _cfg_pair(fnode_num=8)
    sd = _state_dict(jcfg, np.random.default_rng(3))
    want = jgcn.params_from_numpy_state(sd, jcfg)
    got = tgcn.params_from_numpy_state(sd, tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_load_torch_state_dict_roundtrip(tmp_path):
    jcfg, tcfg = _cfg_pair(fnode_num=8)
    sd = _state_dict(jcfg, np.random.default_rng(5))
    path = tmp_path / "model.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = tgcn.load_torch_state_dict(str(path), tcfg)
    want = jgcn.load_torch_state_dict(str(path), jcfg)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("fnode_num", [8, 64])
def test_init_params_keys_shapes_and_bounds_equal_jax(fnode_num):
    jcfg, tcfg = _cfg_pair(fnode_num=fnode_num)
    want = jgcn.init_params(jax.random.PRNGKey(0), jcfg)
    got = tgcn.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == torch.float32, k
        bound = float(jnp.max(jnp.abs(v)))
        assert float(got[k].abs().max()) <= max(bound * 1.01, 1.0), k
    again = tgcn.init_params(torch.Generator().manual_seed(0), tcfg)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_model_inputs_equal_jax():
    """The pnode input moves the (B, 3, 4096) axes before the flatten that
    feeds pnode_d: a flat reshape of the features would permute them."""
    jcfg, tcfg = _cfg_pair()
    feats = np.random.default_rng(0).normal(0, 1, (2, 3 * jcfg.pnode_num)).astype(np.float32)
    jx_p, jx_f = jgcn.model_inputs_from_features(jnp.asarray(feats), jcfg)
    tx_p, tx_f = tgcn.model_inputs_from_features(torch.from_numpy(feats), tcfg)
    np.testing.assert_array_equal(tx_p.numpy(), np.asarray(jx_p))
    # the f-node input sums 64 features, in another order than XLA's
    np.testing.assert_allclose(tx_f.numpy(), np.asarray(jx_f), rtol=1e-6, atol=1e-5)
    assert not np.array_equal(tx_p.reshape(2, -1).numpy(), feats)


def test_scorer_module_moves_and_casts_its_parameters():
    tcfg = tgcn.GCNConfig(fnode_num=8)
    params = tgcn.init_params(torch.Generator().manual_seed(1), tcfg)
    model = tgcn.GCNScorer(params, tcfg).to(torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in model.params().values())
    assert sorted(model.params()) == sorted(params)
    x_p = torch.randn(2, tcfg.pnode_num, 3, dtype=torch.bfloat16)
    x_f = torch.randn(2, tcfg.fnode_num, 1, dtype=torch.bfloat16)
    probs = model(x_p, x_f)
    assert probs.shape == (2, 2) and probs.dtype == torch.bfloat16
    torch.testing.assert_close(probs.float().sum(dim=1), torch.ones(2), atol=1e-2, rtol=0)
