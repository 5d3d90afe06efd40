"""dalle_pytorch_tpu_torch — the PyTorch and CUDA port of dalle_pytorch_tpu,
for NVIDIA Hopper (H100).

It serves text in, PNG images out (`cli/generate.py`): the CLIP BPE
tokenizer (`data/tokenizer.py`), the DALL-E transformer (prefill + cached
decode, classifier-free guidance, image priming, text completion), the
image tokenizers (the DiscreteVAE, the taming VQGAN, OpenAI's dVAE) and
CLIP reranking, plus the scoring forward; and it
trains the DALL-E transformer (`parallel/train_step.py`, `cli/train_dalle.py`)
on a folder of images and captions or tar shards (`data/loader.py`).  Full-sequence
attention runs on hand-written CUDA flash-attention kernels, forward
(`kernels/csrc/flash_fwd.cu`) and backward (`kernels/csrc/flash_bwd.cu`).
The port never imports JAX; weights come from a seed or from the JAX
package's parameter trees and v3 checkpoints, and go back to them
(`weights.py`, `checkpoint.py`)."""
from dalle_pytorch_tpu_torch.api import CLIP, DALLE, DiscreteVAE, OpenAIDiscreteVAE, VQGanVAE
from dalle_pytorch_tpu_torch.models.clip import CLIPConfig, init_clip
from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, forward as dalle_forward, init_dalle
from dalle_pytorch_tpu_torch.models.openai_vae import OpenAIVAEConfig
from dalle_pytorch_tpu_torch.models.sampling import generate_images, generate_texts, sample_image_codes
from dalle_pytorch_tpu_torch.models.vae import (
    DiscreteVAEConfig,
    decode_indices,
    get_codebook_indices,
    init_discrete_vae,
)
from dalle_pytorch_tpu_torch.models.vqgan import VQGANConfig
from dalle_pytorch_tpu_torch.version import __version__

__all__ = [
    "CLIP",
    "CLIPConfig",
    "DALLE",
    "DALLEConfig",
    "DiscreteVAE",
    "DiscreteVAEConfig",
    "OpenAIDiscreteVAE",
    "OpenAIVAEConfig",
    "VQGANConfig",
    "VQGanVAE",
    "__version__",
    "dalle_forward",
    "decode_indices",
    "generate_images",
    "generate_texts",
    "get_codebook_indices",
    "init_clip",
    "init_dalle",
    "init_discrete_vae",
    "sample_image_codes",
]
