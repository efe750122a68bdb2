"""Operation counts and the card's peak rates: the benchmark's frozen copy.

Copied from ``speech_ssl_compression_tpu_torch/utils/flops.py`` so that a
later change to the port cannot move the yardstick, with three additions:
the grouped positional conv (about 9.4e6 FLOPs a frame at MelHuBERT's
widths), the backward (three times the forward, recomputation not
counted) and the attention work of one segment (valid keys only), with
its bytes. Every count is of the dense-equivalent matmul FLOPs that the
inputs need; padding is never counted.
"""

from __future__ import annotations

# {name fragment of torch.cuda.get_device_name(): peaks}: dense FLOP/s of
# products in each dtype on the tensor cores ("float32": f32-accurate
# products in split TF32, three TF32 products each, 495 / 3), and HBM
# bytes/s. NVIDIA H100 SXM data sheet (80 GB HBM3, 700 W).
CARDS = {
    "H100 80GB HBM3": {"float32": 495e12 / 3, "bfloat16": 989e12,
                       "bytes": 3.35e12},
}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def card_peaks(name: str) -> dict:
    """The peaks of the card ``name``; an unknown card raises rather than
    guessing."""
    for fragment, peaks in CARDS.items():
        if fragment in name:
            return peaks
    raise ValueError(f"no peak rates known for the card {name!r}")


def peak_flops(name: str, dtype: str) -> float:
    return card_peaks(name)[dtype]


def peak_bytes(name: str) -> float:
    return card_peaks(name)["bytes"]


def encoder_fwd_flops(cfg: dict, length: int) -> int:
    """Transformer-encoder forward FLOPs over one segment of ``length``
    frames attending to its own ``length`` keys: q/k/v/out projections,
    attention scores and context, FFN. ``cfg`` holds ``encoder_layers``,
    ``encoder_embed_dim``, ``encoder_ffn_embed_dim``,
    ``encoder_attention_heads`` (ints: every layer alike) and
    ``head_dim``."""
    d = cfg["encoder_embed_dim"]
    f = cfg["encoder_ffn_embed_dim"]
    p = cfg["encoder_attention_heads"] * cfg["head_dim"]
    per_layer = (2 * length * (3 * d * p + p * d)  # qkv + out projections
                 + 4 * length * length * p          # scores + context
                 + 4 * length * d * f)              # fc1 + fc2
    return cfg["encoder_layers"] * per_layer


def pos_conv_fwd_flops(cfg: dict, length: int) -> int:
    """The grouped positional conv over ``length`` output frames: each
    output channel sums D / groups input channels over K taps."""
    d = cfg["encoder_embed_dim"]
    return 2 * length * d * (d // cfg["conv_pos_groups"]) * cfg["conv_pos"]


def melhubert_fwd_flops(cfg: dict, length: int, final_proj: bool) -> int:
    """One MelHuBERT forward over ``length`` valid frames: the
    pre-projection, the positional conv, the encoder and, with
    ``final_proj``, the cluster projection (serving runs without it)."""
    d = cfg["encoder_embed_dim"]
    total = (2 * length * cfg["feat_emb_dim"] * d
             + pos_conv_fwd_flops(cfg, length)
             + encoder_fwd_flops(cfg, length))
    if final_proj:
        total += 2 * length * d * cfg["num_cluster"]
    return total


def conv_frontend_fwd_flops(conv_layers, n_samples: int) -> int:
    """Waveform conv-frontend forward FLOPs over ``n_samples`` samples."""
    total, n, in_d = 0, n_samples, 1
    for dim, k, s in conv_layers:
        n = (n - k) // s + 1
        total += 2 * n * dim * in_d * k
        in_d = dim
    return total


def conv_output_length(conv_layers, n_samples: int) -> int:
    for _, k, s in conv_layers:
        n_samples = (n_samples - k) // s + 1
    return n_samples


def hubert_fwd_flops(cfg: dict, n_samples: int) -> int:
    """One HuBERT forward over an utterance of ``n_samples`` valid
    samples: the conv frontend, the feature projection, the positional
    conv and the encoder over its valid frames."""
    layers = cfg["conv_feature_layers"]
    t = conv_output_length(layers, n_samples)
    return (conv_frontend_fwd_flops(layers, n_samples)
            + 2 * t * layers[-1][0] * cfg["encoder_embed_dim"]
            + pos_conv_fwd_flops(cfg, t)
            + encoder_fwd_flops(cfg, t))


def train_flops(fwd_flops: int) -> int:
    """Forward plus backward: the backward takes twice the forward's
    products (the gradients of the inputs and of the weights);
    recomputation is not counted."""
    return 3 * fwd_flops


def attention_work(cfg: dict, tq: int, tk: int, dtype: str,
                   backward: bool = False) -> tuple:
    """(FLOPs, bytes) of one segment's attention in one layer: ``tq``
    queries against ``tk`` valid keys over every head. The forward's two
    products (scores, context) and Q, K, V and O moved once; the
    backward's four products (dV, dP, dQ, dK; the scores' recomputation is
    not counted) and Q, K, V, O, dO, dQ, dK and dV moved once."""
    p = cfg["encoder_attention_heads"] * cfg["head_dim"]
    width = DTYPE_BYTES[dtype]
    if backward:
        return 8 * tq * tk * p, (4 * tq + 4 * tk) * p * width
    return 4 * tq * tk * p, (2 * tq + 2 * tk) * p * width


def least_seconds(flops: float, n_bytes: float, card: str,
                  dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    at the dtype's peak and the bytes at the memory's."""
    return max(flops / peak_flops(card, dtype), n_bytes / peak_bytes(card))
