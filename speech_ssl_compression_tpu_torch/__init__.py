"""speech_ssl_compression_tpu_torch — the PyTorch/CUDA port of
``speech_ssl_compression_tpu``, for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it is the reference each module here is held
against; module paths and names mirror it (``ops/``, ``models/``,
``utils/``, ``extract.py``). This package never imports ``jax``.

What is ported so far: MelHuBERT and HuBERT feature extraction and
pre-training, init from a checkpoint and resume, MelHuBERT weight, head
and row pruning and distillation (``compress/``), and the pretrain
experts (``upstream/``), on hand-written CUDA kernels (``csrc/``) for the
flash attention and the strided conv; ROADMAP.md lists the rest.
"""

__version__ = "0.1.0"
