"""The DALL-E with learned positions (`rotary_emb=False`) on the card: the
decode loop replayed from CUDA graphs gives the eager loop's codes under
one noise, and the engine's replayed paged step gives each request's
batch-1 codes.  No JAX here: the card's machine has none; the CPU tests
hold the same model to the JAX package (`tests/test_torch_rotary_off.py`).
Every test needs an NVIDIA GPU and skips without one."""
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models import sampling as tsamp
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine

# the CUDA kernels take head dims 32, 64 and 128; seq 31 = text 6 + a 5 x 5 map
MODEL = dict(dim=64, depth=4, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=5, shift_tokens=True, rotary_emb=False,
             attn_types=("full", "axial_row", "axial_col", "conv_like"))


@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs replay on the card only")
    cfg = tdalle.DALLEConfig(**MODEL)
    return tdalle.init_dalle(cfg, torch.Generator("cuda").manual_seed(0), "cuda")


def _inputs(cfg, n_gen, b, seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, cfg.num_text_tokens, (b, cfg.text_seq_len))
    text[-1, 3:] = 0
    noise = rng.gumbel(size=(n_gen, b, cfg.total_tokens)).astype(np.float32)
    return torch.from_numpy(text).cuda(), torch.from_numpy(noise).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("cond_scale,prime_len", [(3.0, 0), (1.0, 7)])
def test_replayed_codes_equal_eager_on_card(cuda_model, cond_scale, prime_len):
    cfg = cuda_model.cfg
    text, noise = _inputs(cfg, cfg.image_seq_len - prime_len, 2, prime_len)
    primer = torch.randint(0, cfg.num_image_tokens, (2, prime_len), device="cuda") if prime_len else None
    kw = dict(cond_scale=cond_scale, primer_codes=primer, prime_len=prime_len, noise_override=noise)
    replayed = tsamp.sample_image_codes(cuda_model, text, graphs=True, **kw)
    eager = tsamp.sample_image_codes(cuda_model, text, graphs=False, **kw)
    assert torch.equal(replayed, eager)
    assert len(torch.unique(replayed)) > 3


@pytest.mark.cuda
def test_engine_codes_equal_batch1_on_card(cuda_model):
    cfg = cuda_model.cfg
    text, _ = _inputs(cfg, 1, 3, 11)
    noise = torch.from_numpy(np.random.default_rng(12).gumbel(
        size=(3, cfg.image_seq_len, cfg.total_tokens)).astype(np.float32))
    engine = GenerationEngine(cuda_model, engine_cfg=EngineConfig(num_slots=3, block_size=4, filter_thres=0.5,
                                                                  noise_override=True))
    assert engine.graph is not None
    reqs = []
    for i in range(3):
        reqs.append(engine.submit(text[i].cpu().numpy(), cond_scale=3.0 if i == 1 else 1.0, noise=noise[i]))
        for _ in range(4):
            engine.poll()
    engine.run_until_idle()
    for i, req in enumerate(reqs):
        ref = tsamp.sample_image_codes(cuda_model, text[i:i + 1], filter_thres=0.5, cond_scale=3.0 if i == 1 else 1.0,
                                       noise_override=noise[i][:, None].cuda())
        np.testing.assert_array_equal(req.codes, ref[0].cpu().numpy())
