"""speech_ssl_compression_tpu_torch — the PyTorch/CUDA port of
``speech_ssl_compression_tpu``, for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it is the reference each module here is held
against; module paths and names mirror it (``ops/``, ``models/``,
``utils/``, ``extract.py``). This package never imports ``jax``.

Every module of the JAX package has its counterpart here: MelHuBERT and
HuBERT feature extraction (from waveforms with the fbank on the host or
the device, pipelined by ``forward_stream``) and pre-training, wav2vec 2.0
pre-training, init from a checkpoint and resume, weight, head and row
pruning and distillation (``compress/``), streaming causal serving, the
parallel family (``parallel/``), the pretrain experts (``upstream/``), the
S3PRL expert and hubconf (``s3prl/``), k-means labels (``ops/kmeans.py``,
``cluster.py``), the offline data path (``data/kaldi_io.py``,
``data/preprocess.py``, ``preprocess.py``, ``data/fairseq_dump.py``) and
the measuring modules (``utils/flops.py``, ``utils/profiling.py``,
``train/wave_bench.py``), on hand-written CUDA kernels (``csrc/``) for
the flash attention and the strided conv; ROADMAP.md lists what is not
carried over.
"""

__version__ = "0.1.0"
