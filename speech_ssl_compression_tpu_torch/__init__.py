"""speech_ssl_compression_tpu_torch — the PyTorch/CUDA port of
``speech_ssl_compression_tpu``, for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it is the reference each module here is held
against; module paths and names mirror it (``ops/``, ``models/``,
``utils/``, ``extract.py``). This package never imports ``jax``.

What is ported so far: MelHuBERT packed feature extraction
(``extract.MelHuBERTExtractor.forward_packed``), with the flash-attention
forward as a hand-written CUDA kernel (``csrc/flash_attn_fwd.cu``).
"""

__version__ = "0.1.0"
