"""SSM and hybrid serving on the card: reduced xlstm-1.3b and zamba2-2.7b
against the same models on the host.

Every test here is marked ``cuda`` and skips where there is no GPU; on
the card run ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_ssm.py``. The file imports neither JAX nor
``repro``. f32 with TF32 off: greedy tokens exactly equal; prefill
logits, every prefill state leaf and one decode step's logits and state
rtol 1e-4 / atol 1e-5 (tests/test_torch_lm.py's f32 tolerance).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import build_model, make_generator
from repro_torch.serve import ServeConfig, generate, prefill_cache

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _leaves(state):
    out = []
    for x in state:
        out.extend(_leaves(x) if isinstance(x, tuple) else [x])
    return out


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("name", ["xlstm-1.3b", "zamba2-2.7b"])
def test_prefill_decode_and_generate_on_card_equal_host(cuda, name):
    api = build_model(configs.reduced(configs.get_config(name)))
    params = api.init_params(make_generator(0, cuda))
    host = api.empty_params("cpu")
    host.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, api.cfg.vocab_size, (4, 32)).astype(np.int32))
    sc = ServeConfig(max_new_tokens=12)
    got = generate(api, params, {"tokens": tokens.to(cuda)}, sc)
    want = generate(api, host, {"tokens": tokens}, sc)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    with torch.no_grad():
        lg, st = api.prefill(params, {"tokens": tokens.to(cuda)})
        lh, sh = api.prefill(host, {"tokens": tokens})
        _close(lg, lh)
        for a, b in zip(_leaves(st), _leaves(sh)):
            assert a.device.type == "cuda"
            _close(a, b)
        # the prefill again, into a cache with room for one more token
        _, st = prefill_cache(api, params, {"tokens": tokens.to(cuda)}, 33)
        _, sh = prefill_cache(api, host, {"tokens": tokens}, 33)
        nxt = lh[:, -1:].argmax(-1)
        dg, st = api.decode(params, nxt.to(cuda), st, 32)
        dh, sh = api.decode(host, nxt, sh, 32)
        _close(dg, dh)
        for a, b in zip(_leaves(st), _leaves(sh)):
            _close(a, b)


def test_default_device_is_cuda(cuda):
    for name in ("xlstm-1.3b", "zamba2-2.7b"):
        api = build_model(configs.reduced(configs.get_config(name)))
        state = api.init_cache(2, 8)
        assert all(t.device.type == "cuda" for t in _leaves(state))
