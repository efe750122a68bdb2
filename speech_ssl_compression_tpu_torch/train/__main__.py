"""Training CLI of the port, for MelHuBERT and HuBERT pre-training:

    python -m speech_ssl_compression_tpu_torch.train -m melhubert \\
        -g configs/melhubert/config_model_20ms.yaml -c <runner.yaml> \\
        -n <expdir> [-u melhubert] [-f {10,20}] [--seed N] [--device cuda]
    python -m speech_ssl_compression_tpu_torch.train -m melhubert -u hubert \\
        -g configs/hubert/config_model.yaml -c <runner.yaml with task:> \\
        -n <expdir> [--seed N] [--device cuda]

Port of the repository's ``train.py`` (the reference's flags), with
``--device`` in place of ``--backend``: ``-u melhubert`` goes to
``train/runner.py``, ``-u hubert`` to ``train/wave_runner.py``. The YAMLs
are read without PyYAML (``configs.py::read_yaml``), and the two config
files are copied into the experiment directory for provenance. Only
pre-training (``-m melhubert``) is ported; the compression modes,
``-u wav2vec2``, ``-i`` and the parallel flags raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import shutil


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m speech_ssl_compression_tpu_torch.train")
    parser.add_argument(
        "-m", "--mode", required=True,
        choices=["melhubert", "weight-pruning", "head-pruning",
                 "row-pruning", "distillation"],
    )
    parser.add_argument("-u", "--upstream", default="melhubert",
                        choices=["melhubert", "hubert", "wav2vec2"])
    parser.add_argument("-g", "--upstream_config", required=True,
                        help="model YAML")
    parser.add_argument("-c", "--runner_config", required=True,
                        help="runner YAML")
    parser.add_argument("-n", "--expdir", required=True)
    parser.add_argument("-i", "--initial_weight", default=None)
    parser.add_argument("-f", "--frame_period", type=int, default=20,
                        choices=[10, 20])
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    parser.add_argument("--model_parallel", type=int, default=1)
    parser.add_argument("--pipeline_parallel", type=int, default=1)
    parser.add_argument("--multi_host", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the trainer; returns the Runner after training."""
    from ..configs import read_yaml

    args = get_args(argv)
    runner_config = read_yaml(args.runner_config)
    upstream_config = read_yaml(args.upstream_config)
    if args.upstream == "melhubert":
        from .runner import Runner
    else:  # the waveform models (train.py:108-116)
        from .wave_runner import WaveRunner as Runner
    runner = Runner(args, runner_config, upstream_config)
    # config provenance copies (reference train.py:43-44)
    shutil.copy(args.upstream_config,
                os.path.join(args.expdir, "config_model.yaml"))
    shutil.copy(args.runner_config,
                os.path.join(args.expdir, "config_runner.yaml"))
    runner.train()
    return runner


if __name__ == "__main__":
    main()
