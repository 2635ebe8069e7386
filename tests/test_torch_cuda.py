"""On a CUDA card: each kernel of ``palace_tpu_torch.ops.kernels`` against
its plain version on the same inputs, and the scorer's forward through
the kernels against the forward through the plain versions.

The file imports neither JAX nor palace_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are ``palace_tpu_torch.ops.compare.TOLERANCES``: float32 1e-4;
bfloat16 2e-3 and float16 1e-3, with rare rounding steps of one ulp of an
intermediate.  Transition counts are integers and must be equal.  Without
a card every test skips."""
import numpy as np
import pytest
import torch

from palace_tpu_torch.models import gcn as tgcn
from palace_tpu_torch.ops import kernels
from palace_tpu_torch.ops.compare import TOLERANCES, compare
from palace_tpu_torch.ops.encoder import pack_contigs

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run "
                    "pytest --noconftest -m cuda tests/test_torch_cuda.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, dtype):
    res = compare(got, want, TOLERANCES[dtype])
    assert res["ok"], res


@pytest.mark.cuda
def test_card_transition_features_equal_plain(cuda):
    rng = np.random.default_rng(2)
    seqs = ["".join(rng.choice(list("ACGTN"), size=int(n)))
            for n in rng.integers(0, 3000, 64)] + ["", "AC", "ACG", "ACGTAC", "N" * 9]
    packed, n_codes, lens = (torch.from_numpy(a).to(cuda) for a in pack_contigs(seqs))
    before = kernels.LAUNCHES["transition_counts"]
    got = kernels.transition_features(packed, n_codes, lens)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["transition_counts"] == before + 1
    assert torch.equal(got, kernels.transition_features_plain(packed, n_codes, lens))
    assert got.sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_sage_rounds_close_to_plain(cuda, dtype):
    g = torch.Generator(device="cpu").manual_seed(3)
    p = tgcn.init_params(g)
    p["ln.scale"] = 1 + 0.2 * torch.randn(128, generator=g)
    p["ln.bias"] = 0.2 * torch.randn(128, generator=g)
    xp = torch.randn(4, 4096, 3, generator=g).to(cuda, dtype)
    xf = torch.randn(4, 64, 3, generator=g).to(cuda, dtype)
    w = tgcn.sage_weight_stack(p, dtype).to(cuda)
    before = kernels.LAUNCHES["sage_rounds"]
    got = kernels.sage_rounds(xp, xf, w)
    want = kernels.sage_rounds_plain(xp, xf, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sage_rounds"] == before + 1
    assert got.dtype == dtype and got.shape == (4, 4096, 128)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_conv_head_close_to_plain(cuda, dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (3, 128, 4096)).astype(np.float32)).to(cuda, dtype)
    ws = [torch.from_numpy(rng.normal(0, 0.1, (64, c, 8)).astype(np.float32)).to(cuda, dtype)
          for c in (128, 64, 64)]
    bs = [torch.from_numpy(rng.normal(0, 0.1, 64).astype(np.float32)).to(cuda, dtype)
          for _ in range(3)]
    before = kernels.LAUNCHES["conv_head"]
    got = kernels.conv_head(x, ws, bs)
    want = kernels.conv_head_plain(x, ws, bs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_head"] == before + 3  # one launch a layer
    assert got.shape == (3, 64, 4075) and got.is_contiguous()
    _assert_close(got, want, dtype)


@pytest.mark.cuda
def test_card_forward_through_kernels_close_to_plain(cuda):
    """Full width, float32, with d1/d2 scaled so the logits spread."""
    g = torch.Generator(device=cuda).manual_seed(5)
    p = tgcn.init_params(g)
    p["d1.w"] *= 3.0
    p["d2.w"] *= 30.0
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), size=3000, p=q))
            for q in ([.1, .4, .4, .1], [.4, .1, .1, .4], [.25] * 4, [.3, .2, .2, .3])]
    packed, n_codes, lens = (torch.from_numpy(a).to(cuda) for a in pack_contigs(seqs))
    x_p, x_f = tgcn.model_inputs_from_features(
        kernels.transition_features(packed, n_codes, lens))
    got = tgcn.forward(p, x_p, x_f, return_logits=True)
    want = tgcn.forward(p, x_p, x_f, return_logits=True, plain=True)
    torch.cuda.synchronize()
    assert float((want[:, 1] - want[:, 0]).max() - (want[:, 1] - want[:, 0]).min()) > 0.05
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_card_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(1, 128, 64, device=cuda, dtype=torch.float64)
    ws = [torch.zeros(64, c, 8, device=cuda, dtype=torch.float64) for c in (128, 64, 64)]
    bs = [torch.zeros(64, device=cuda, dtype=torch.float64) for _ in range(3)]
    with pytest.raises(ValueError):
        kernels.conv_head(x, ws, bs)
    with pytest.raises(ValueError):
        kernels.sage_rounds(torch.zeros(1, 8, 3, device=cuda), torch.zeros(1, 2, 3, device=cuda),
                            torch.zeros(kernels.sage_stack_rows(3, 4), 4, device=cuda))
    with pytest.raises(ValueError):
        kernels.transition_features(torch.zeros(1, 4, dtype=torch.int32, device=cuda),
                                    torch.zeros(1, dtype=torch.int32, device=cuda),
                                    torch.zeros(1, dtype=torch.int32, device=cuda))
