"""The host trees a checkpoint save writes (``utils/weights.py``)
transpose the Linear kernels on the tensor's device
(``torch_convert.kernel_from_weight``). These tests hold them to numpy's own transpose on the host: the same
trees, leaf by leaf, and the same checkpoint entries, byte for byte, for
the three models the trainers save."""

import zipfile

import numpy as np
import pytest
import torch

from speech_ssl_compression_tpu_torch import configs as tconfigs
from speech_ssl_compression_tpu_torch.models.hubert import HuBERTModel
from speech_ssl_compression_tpu_torch.models.melhubert import MelHuBERTModel
from speech_ssl_compression_tpu_torch.models.wav2vec2 import Wav2Vec2Model
from speech_ssl_compression_tpu_torch.utils.checkpoint import save_checkpoint
from speech_ssl_compression_tpu_torch.utils.torch_convert import (
    melhubert_state_dict_to_params,
    wave_state_dict_to_params,
)
from speech_ssl_compression_tpu_torch.utils.weights import (
    jax_tree_from_named,
    masks_tree,
    prunable_names,
    prunable_tree,
    wave_tree_from_named,
)

ENCODER = dict(encoder_layers=2, encoder_embed_dim=32,
               encoder_ffn_embed_dim=64, encoder_attention_heads=2,
               head_dim=16, conv_pos=16, conv_pos_groups=4)
CONV = "[(32,10,5)] + [(32,3,2)] + [(32,2,2)]"


def _model(upstream):
    torch.manual_seed(0)
    if upstream == "melhubert":
        return MelHuBERTModel(tconfigs.MelHuBERTConfig.from_dict(
            dict(ENCODER, feat_emb_dim=80, num_cluster=32)))
    if upstream == "hubert":
        return HuBERTModel(tconfigs.HuBERTConfig.from_dict(
            dict(ENCODER, conv_feature_layers=CONV, final_dim=16,
                 label_rate=100, untie_final_proj=True)), (12,))
    return Wav2Vec2Model(tconfigs.Wav2Vec2Config.from_dict(
        dict(ENCODER, conv_feature_layers=CONV, final_dim=16,
             quantize_targets=True, latent_vars=8, latent_groups=2)))


def _numpy_trees(named, masks, upstream):
    """The trees as numpy's transpose on the host gives them."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in named.items()}
    if upstream == "melhubert":
        params = melhubert_state_dict_to_params(sd, keep_masks=False)[0]
    else:
        params = wave_state_dict_to_params(sd, upstream, keep_masks=False)[0]
    tree: dict = {}
    for name, m in masks.items():
        parts = name.split(".")
        leaf = "kernel" if parts[-1] == "weight" else "bias"
        m = m.float().numpy()
        tree.setdefault(f"layer_{parts[2]}", {}).setdefault(parts[-2], {})[
            leaf] = np.ascontiguousarray(m.T) if leaf == "kernel" else m
    return params, tree


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("upstream", ["melhubert", "hubert", "wav2vec2"])
def test_host_trees_match_numpy_transposes_byte_for_byte(tmp_path,
                                                         upstream):
    model = _model(upstream)
    named = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(1)
    masks = {k: (torch.rand(named[k].shape, generator=gen) < 0.5).float()
             for k in prunable_names(named)}
    ref_params, ref_masks = _numpy_trees(named, masks, upstream)
    params = (jax_tree_from_named(named) if upstream == "melhubert"
              else wave_tree_from_named(named, upstream))
    got_masks = masks_tree(masks)
    for got, ref in ((params, ref_params), (got_masks, ref_masks)):
        got, ref = dict(_leaves(got)), dict(_leaves(ref))
        assert got.keys() == ref.keys()
        for k, a in got.items():
            assert a.dtype == ref[k].dtype == np.float32, k
            assert a.flags.c_contiguous, k
            np.testing.assert_array_equal(a, ref[k], err_msg=k)
    # the l1 scores' view: the same layout as the save's
    view = prunable_tree(named)
    for k, a in _leaves(view):
        assert a.flags.c_contiguous, k
    # the files' entries, byte for byte, in order (the zip headers also
    # hold the time of writing)
    members = []
    for name, tree, mask_tree in (("device", params, got_masks),
                                  ("host", ref_params, ref_masks)):
        path = tmp_path / f"{name}.npz"
        save_checkpoint(str(path), tree, masks=mask_tree, meta={"Step": 1})
        with zipfile.ZipFile(path) as z:
            members.append([(n, z.read(n)) for n in z.namelist()])
    assert members[0] == members[1]
