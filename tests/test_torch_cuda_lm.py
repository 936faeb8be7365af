"""LM serving on the card: reduced dense and MoE ``generate`` against the
same model on the host, and the default device.

Every test here is marked ``cuda`` and skips where there is no GPU; on
the card run ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_lm.py``. The file imports neither JAX nor
``repro``. f32 with TF32 off: greedy tokens exactly equal, logits of the
prefill rtol 1e-4 / atol 1e-5 (tests/test_torch_lm.py's f32 tolerance).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import build_model, make_generator
from repro_torch.serve import ServeConfig, generate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_generate_on_card_equals_host(cuda, name):
    api = build_model(configs.reduced(configs.get_config(name)))
    params = api.init_params(make_generator(0, cuda))
    host = api.empty_params("cpu")
    host.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, api.cfg.vocab_size, (4, 16)).astype(np.int32))
    sc = ServeConfig(max_new_tokens=12)
    got = generate(api, params, {"tokens": tokens.to(cuda)}, sc)
    want = generate(api, host, {"tokens": tokens}, sc)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    with torch.no_grad():
        lg, cache = api.prefill(params, {"tokens": tokens.to(cuda)})
        lh, _ = api.prefill(host, {"tokens": tokens})
    assert cache.k.device.type == "cuda"
    np.testing.assert_allclose(lg.cpu().numpy(), lh.numpy(), rtol=1e-4, atol=1e-5)


def test_default_device_is_cuda(cuda):
    api = build_model(configs.reduced(configs.get_config("olmoe-1b-7b")))
    cache = api.init_cache(2, 8)
    assert cache.k.device.type == cache.v.device.type == "cuda"
    params = api.init_params(make_generator(0))
    assert params.embedding.device.type == "cuda"
    tokens = torch.randint(0, api.cfg.vocab_size, (2, 5), generator=make_generator(1),
                           device=cuda)
    out = generate(api, params, {"tokens": tokens}, ServeConfig(max_new_tokens=3))
    assert out.device.type == "cuda" and out.shape == (2, 8)
