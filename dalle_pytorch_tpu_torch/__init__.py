"""dalle_pytorch_tpu_torch — the PyTorch and CUDA port of dalle_pytorch_tpu,
for NVIDIA Hopper (H100).

It serves text token ids in, images out, through the DALL-E transformer
(prefill + cached decode, classifier-free guidance, image priming) and the
DiscreteVAE decoder, plus the scoring forward; and it trains the DALL-E
transformer (`parallel/train_step.py`, `cli/train_dalle.py`).  Full-sequence
attention runs on hand-written CUDA flash-attention kernels, forward
(`kernels/csrc/flash_fwd.cu`) and backward (`kernels/csrc/flash_bwd.cu`).
The port never imports JAX; weights come from a seed or from the JAX
package's parameter trees and v3 checkpoints, and go back to them
(`weights.py`, `checkpoint.py`)."""
from dalle_pytorch_tpu_torch.api import DALLE, DiscreteVAE
from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, forward as dalle_forward, init_dalle
from dalle_pytorch_tpu_torch.models.sampling import generate_images, sample_image_codes
from dalle_pytorch_tpu_torch.models.vae import (
    DiscreteVAEConfig,
    decode_indices,
    get_codebook_indices,
    init_discrete_vae,
)
from dalle_pytorch_tpu_torch.version import __version__

__all__ = [
    "DALLE",
    "DALLEConfig",
    "DiscreteVAE",
    "DiscreteVAEConfig",
    "__version__",
    "dalle_forward",
    "decode_indices",
    "generate_images",
    "get_codebook_indices",
    "init_dalle",
    "init_discrete_vae",
    "sample_image_codes",
]
