"""The encoder-decoder and VLM families, and remat training, on the card:
reduced whisper-tiny and llama-3.2-vision-11b against the same models on
the host.

Every test here is marked ``cuda`` and skips where there is no GPU; on
the card run ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_families.py``. The file imports neither JAX nor
``repro``. f32 with TF32 off: greedy tokens exactly equal; prefill
logits, every cache leaf, one decode step's logits, train-step losses and
grad norms rtol 1e-4 / atol 1e-5 (tests/test_torch_lm.py's f32
tolerance).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.models import build_model, make_generator
from repro_torch.serve import ServeConfig, generate, prefill_cache
from repro_torch.train import (
    AdamWConfig,
    TrainConfig,
    TrainState,
    adamw_init,
    batch_to_device,
    make_train_step,
)

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-4, atol=1e-5)
NAMES = ["whisper-tiny", "llama-3.2-vision-11b"]


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
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.detach().numpy(), **F32)


def _pair(name, cuda):
    api = build_model(configs.reduced(configs.get_config(name)))
    params = api.init_params(make_generator(0, cuda))
    if api.cfg.family == "vlm":  # open the zero-init gates
        with torch.no_grad():
            for lp in params["cross_layers"]:
                lp["cross"]["gate"].fill_(0.5)
    host = api.empty_params("cpu")
    host.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    return api, params, host


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_and_generate_on_card_equal_host(cuda, name):
    api, params, host = _pair(name, cuda)
    batch = batch_to_device(batch_for_step(SyntheticConfig(4, 24, api.cfg.vocab_size, seed=1),
                                           0, api.cfg), "cpu", api.dtype)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    sc = ServeConfig(max_new_tokens=12)
    got = generate(api, params, on_card, sc)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), generate(api, host, batch, sc))
    with torch.no_grad():
        lg, cg = prefill_cache(api, params, on_card, 25)
        lh, ch = prefill_cache(api, host, batch, 25)
        _close(lg, lh)
        for a, b in zip(_leaves(cg), _leaves(ch)):
            assert a.device.type == "cuda"
            _close(a, b)
        nxt = lh[:, -1:].argmax(-1)
        dg, cg = api.decode(params, nxt.to(cuda), cg, 24)
        dh, ch = api.decode(host, nxt, ch, 24)
        _close(dg, dh)


@pytest.mark.parametrize("name,remat", [("whisper-tiny", True),
                                        ("llama-3.2-vision-11b", "save_collectives"),
                                        ("xlstm-1.3b", True), ("zamba2-2.7b", "save_collectives")])
def test_remat_train_steps_on_card_equal_host(cuda, name, remat):
    api, params, host = _pair(name, cuda)

    def state_of(p):
        dev = next(p.parameters()).device
        return TrainState(params=p, opt=adamw_init(dict(p.named_parameters())),
                          step=torch.zeros((), dtype=torch.int32, device=dev))

    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0), remat=remat)
    step = make_train_step(api, tc)
    sg, sh = state_of(params), state_of(host)
    dc = SyntheticConfig(2, 32, api.cfg.vocab_size, seed=3)
    for s in range(2):
        b = batch_for_step(dc, s, api.cfg)
        sg, mg = step(sg, batch_to_device(b, cuda, api.dtype))
        sh, mh = step(sh, batch_to_device(b, "cpu", api.dtype))
        _close(mg["loss"], mh["loss"])
        _close(mg["grad_norm"], mh["grad_norm"])


def test_default_device_is_cuda(cuda):
    for name in NAMES:
        api = build_model(configs.reduced(configs.get_config(name)))
        assert all(t.device.type == "cuda" for t in _leaves(api.init_cache(2, 8)))
