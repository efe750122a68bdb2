"""Tiny stand-ins of the cells' configurations and mixes, for the CPU
tests: the same keys, widths a CPU runs in seconds."""

from __future__ import annotations

import copy
import json

from h100_bench import harness, traffic

ENCODER = {"encoder_layers": 2, "encoder_embed_dim": 32,
           "encoder_ffn_embed_dim": 64, "encoder_attention_heads": 2,
           "head_dim": 16, "conv_pos": 8, "conv_pos_groups": 4}


def config(name: str) -> dict:
    """The configuration ``name`` at the tiny widths, its port section
    inline."""
    spec = harness.load_benchmark()
    cfg = copy.deepcopy(harness.load_config(spec, name))
    cfg.update(ENCODER)
    if "conv_feature_layers" in cfg:
        cfg["conv_feature_layers"] = [[48, 10, 5], [48, 3, 2], [48, 2, 2]]
        cfg["final_dim"] = 16
        cfg["num_classes"] = 20
    section = {k: v for k, v in cfg.items()
               if k not in ("name", "source", "described_as", "program",
                            "reduced", "assumed", "frame_period_ms",
                            "fbank_mean_std", "fbank_num_mel_bins",
                            "num_classes")}
    if "conv_feature_layers" in section:
        section["conv_feature_layers"] = " + ".join(
            f"[{tuple(x)}]" for x in section["conv_feature_layers"])
    cfg["program"] = {"inline": section,
                      "runner_yaml": cfg["program"].get("runner_yaml")}
    return cfg


def mix(name: str, **changes) -> dict:
    """The mix ``name`` with short utterances and a small pool."""
    m = json.loads(json.dumps(traffic.load_mix(name)))
    m["batch"] = min(int(m["batch"]), 4)
    m["lengths"].update(mean_s=1.5, min_s=0.5, max_s=3.0, pool_batches=2)
    m["check"]["samples"] = 2
    m.update(changes)
    return m
