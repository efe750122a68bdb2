"""Training CLI of the port, for MelHuBERT, HuBERT and wav2vec 2.0
pre-training, weight, head and row pruning of the three, and MelHuBERT
distillation:

    python -m speech_ssl_compression_tpu_torch.train -m melhubert \\
        -g configs/melhubert/config_model_20ms.yaml -c <runner.yaml> \\
        -n <expdir> [-u melhubert] [-f {10,20}] [--seed N] [--device cuda] \\
        [-i <ckpt> [--init_optimizer_from_initial_weight]]
    python -m speech_ssl_compression_tpu_torch.train -m weight-pruning \\
        -g configs/weight_pruning/config_model_20ms.yaml \\
        -c configs/weight_pruning/config_runner_20ms.yaml -n <expdir> \\
        -i <pretrained .npz or reference .ckpt> \\
        [--init_optimizer_from_initial_weight] [--device cuda]
    python -m speech_ssl_compression_tpu_torch.train -m head-pruning \\
        -g configs/head_pruning/{l1,data_driven}/config_model_20ms.yaml \\
        -c configs/head_pruning/{l1,data_driven}/config_runner_20ms.yaml \\
        -n <expdir> -i <pretrained .npz or reference .ckpt> [--device cuda]
    python -m speech_ssl_compression_tpu_torch.train -m row-pruning \\
        -g configs/row_pruning/config_model_20ms.yaml \\
        -c configs/row_pruning/config_runner_20ms.yaml -n <expdir> \\
        -i <pretrained .npz or reference .ckpt> [--device cuda]
    python -m speech_ssl_compression_tpu_torch.train -m distillation \\
        -g configs/distillation/config_model_20ms.yaml \\
        -c configs/distillation/config_runner_20ms.yaml -n <expdir> \\
        -i <teacher .npz or reference .ckpt> [--device cuda]
    python -m speech_ssl_compression_tpu_torch.train -m melhubert -u hubert \\
        -g configs/hubert/config_model.yaml -c <runner.yaml with task:> \\
        -n <expdir> [--seed N] [--device cuda] [-i <ckpt> ...]
    python -m speech_ssl_compression_tpu_torch.train -m melhubert \\
        -u wav2vec2 -g configs/wav2vec2/config_model.yaml \\
        -c <runner.yaml with task:> -n <expdir> [--seed N] [--device cuda] \\
        [-i <ckpt> ...]
    python -m speech_ssl_compression_tpu_torch.train \\
        -m weight-pruning|head-pruning|row-pruning -u hubert|wav2vec2 \\
        -g configs/{hubert,wav2vec2}/config_model.yaml \\
        -c configs/<dir>/<upstream>_config_runner.yaml -n <expdir> \\
        -i <pretrained .npz or reference .ckpt> [--device cuda]

(``<dir>``: ``weight_pruning``, ``head_pruning/l1`` or ``row_pruning``.)

Any of them on N ranks (data parallel; ``--model_parallel 2`` splits each
encoder layer's heads and FFN units over pairs of ranks; MelHuBERT
pre-training also takes ``--pipeline_parallel S``, the encoder stack cut
into S stages, M = ``--pp_microbatches`` microbatches a step):

    torchrun --nproc_per_node N -m speech_ssl_compression_tpu_torch.train \
        ... --multi_host [--model_parallel 2 | --pipeline_parallel 2] \
        [--dist_backend gloo]

``--multi_host`` joins the process group before anything is written
(``parallel/multihost.py::initialize``: torchrun's env, NCCL where every
rank has a card of its own; ranks that share one card, and ``--device
cpu``, need gloo); only rank 0 writes the expdir.

Port of the repository's ``train.py`` (the reference's flags), with
``--device`` in place of ``--backend``: ``-u melhubert`` goes to
``train/runner.py``, ``-u hubert`` and ``-u wav2vec2`` to
``train/wave_runner.py``. ``-i``
starts from a checkpoint (the JAX package's npz, or a reference
``.ckpt``), and ``--init_optimizer_from_initial_weight`` also restores
its Adam state (a resume); in ``-m distillation`` ``-i`` is the
teacher, and that flag is ignored. The YAMLs are read without PyYAML
(``configs.py::read_yaml``), and the two config files are copied into the
experiment directory for provenance. Ported: pre-training (``-m
melhubert``), ``-m weight-pruning``, ``-m head-pruning`` and ``-m
row-pruning`` of the three models (head pruning: l1 and data-driven,
by_layer and by_whole on MelHuBERT; l1 on HuBERT and wav2vec 2.0, as in
JAX) and ``-m distillation`` of MelHuBERT, each on one rank or a grid of
them. ``-m distillation`` with ``-u hubert|wav2vec2`` raises
``NotImplementedError`` (JAX's WaveRunner trains plain pre-training under
that mode's name), as ``--pipeline_parallel`` does with them (JAX's
WaveRunner has no pipeline) and with any mode but ``-m melhubert``.
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
    parser.add_argument("--init_optimizer_from_initial_weight",
                        action="store_true",
                        help="also restore the optimizer state of -i")
    parser.add_argument("-f", "--frame_period", type=int, default=20,
                        choices=[10, 20])
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    parser.add_argument("--model_parallel", type=int, default=1)
    parser.add_argument(
        "--pipeline_parallel", type=int, default=1,
        help="cut the encoder stack into N pipeline stages, one rank each "
        "(GPipe, parallel/pipeline.py); -m melhubert only; resume with the "
        "same value (the Adam state is stored over the stage-split tree)")
    parser.add_argument(
        "--pp_microbatches", type=int, default=0,
        help="microbatches per pipeline step (0 = 2 x pipeline_parallel); "
        "train_batch_size must be a multiple of it")
    parser.add_argument("--multi_host", action="store_true",
                        help="join the process group of a multi-process "
                        "launch (torchrun's env)")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="process-group backend (default: nccl where "
                        "every rank has a card, gloo on the CPU)")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the trainer; returns the Runner after training."""
    from ..configs import read_yaml

    args = get_args(argv)
    if args.multi_host:  # before anything is written (JAX train.py:82-93)
        from ..parallel.multihost import initialize

        initialize(backend=args.dist_backend,
                   device_type=args.device.split(":")[0])
    runner_config = read_yaml(args.runner_config)
    upstream_config = read_yaml(args.upstream_config)
    if args.upstream == "melhubert":
        from .runner import Runner
    else:  # the waveform models (train.py:108-116)
        from .wave_runner import WaveRunner as Runner
    runner = Runner(args, runner_config, upstream_config)
    if runner.primary:  # config provenance copies (reference train.py:43-44)
        shutil.copy(args.upstream_config,
                    os.path.join(args.expdir, "config_model.yaml"))
        shutil.copy(args.runner_config,
                    os.path.join(args.expdir, "config_runner.yaml"))
    runner.train()
    return runner


if __name__ == "__main__":
    main()
