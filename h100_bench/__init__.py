"""The benchmark of the PyTorch and CUDA port
(``speech_ssl_compression_tpu_torch``) on NVIDIA H100 cards.

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as the last line of standard output. Everything that belongs to one model
configuration, traffic mix, entry point or metric lives in a file of its
own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the published sizes of a configuration;
- ``traffic/<mix>.json``: the parameters of a traffic mix, read by the one
  generator in ``traffic.py``; the mix names its entry and its limits;
- ``entries/<entry>.py``: what drives one entry point of the port;
- ``metrics/<metric>.py``: the reader of one metric;
- ``reference/``: the plain PyTorch reference that decides ``correct``.

Nothing here is imported by the port, and nothing here imports ``jax`` or
the JAX package.
"""
