"""The port's device span-mask sampler (``ops/masking.py::compute_span_mask``
and its deterministic core ``span_mask_from_draws``) against JAX's
``compute_span_mask``. Fed JAX's own draws, the core gives JAX's mask bit
for bit (every selection, ``require_same_masks`` on and off,
``mask_dropout``, short rows, shared rounding, the channel mask); the
``no_overlap`` path equals JAX's host callback for the same seed; the
sampler's own draws agree with JAX's sampler in distribution (mean
masked fraction within binomial bounds); and ``melhubert_forward`` with
``mask=True`` and no mask draws one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_ssl_compression_tpu.ops import masking as jmask
from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
from speech_ssl_compression_tpu_torch.models.melhubert import (
    MelHuBERTModel,
    melhubert_forward,
)
from speech_ssl_compression_tpu_torch.ops import masking as tmask

T = 48
LENGTHS = (48, 37, 9, 2)  # a full row, a ragged one, two short ones
BASE = dict(mask_prob=0.65, mask_length=4, min_masks=2)
CASES = {
    "static": dict(mask_selection="static", require_same_masks=True),
    "static_per_row": dict(mask_selection="static",
                           require_same_masks=False),
    "uniform": dict(mask_selection="uniform", mask_other=1.0,
                    require_same_masks=False),
    "uniform_zero_lengths": dict(mask_selection="uniform", mask_other=0.0,
                                 mask_length=1, require_same_masks=True),
    "normal_dropout": dict(mask_selection="normal", mask_other=2.0,
                           require_same_masks=True, mask_dropout=0.2),
    "poisson_dropout": dict(mask_selection="poisson",
                            require_same_masks=False, mask_dropout=0.1),
    "shared_rounding": dict(mask_selection="static", require_same_masks=True,
                            shared_rounding=True),
    "long_spans_short_rows": dict(mask_selection="static", mask_length=10,
                                  require_same_masks=False),
}


def jax_draws(key, lengths, t, shared_rounding=False, **kw):
    """The draws JAX's compute_span_mask makes from ``key``
    (ops/masking.py:183-270), in its order of key splits."""
    b = len(lengths)
    n_spans = jmask.max_spans_upper_bound(t, kw["mask_prob"],
                                          kw["mask_length"], kw["min_masks"])
    k_count, k_lens, k_starts, k_subset = jax.random.split(key, 4)
    if shared_rounding:
        u = jnp.broadcast_to(jax.random.uniform(k_count, ()), (b,))
    else:
        u = jax.random.uniform(k_count, (b,))
    span = jmask._sample_lengths(k_lens, (b, n_spans), kw["mask_selection"],
                                 kw["mask_length"], kw.get("mask_other", 0.0))
    return [torch.from_numpy(np.array(a)) for a in (
        u, span, jax.random.uniform(k_starts, (b, t)),
        jax.random.uniform(k_subset, (b, t)))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_core_on_jax_draws_is_jax_mask(case, seed):
    kw = dict(BASE, **CASES[case])
    shared = kw.pop("shared_rounding", False)
    lengths = np.array(LENGTHS, np.int32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jmask.compute_span_mask(
        key, jnp.asarray(lengths), T, shared_rounding=shared, **kw))
    u, span, starts, subset = jax_draws(key, lengths, T,
                                        shared_rounding=shared, **kw)
    got = tmask.span_mask_from_draws(torch.from_numpy(lengths), T, u, span,
                                     starts, subset, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[np.arange(T)[None, :] >= lengths[:, None]].any()
    if kw["require_same_masks"]:
        assert len(set(got.sum(1))) == 1


@pytest.mark.parametrize("seed", [0, 3])
def test_channel_mask_core_is_jax(seed):
    key = jax.random.PRNGKey(seed)
    kw = dict(mask_prob=0.3, mask_length=5, mask_selection="static")
    ref = np.asarray(jmask.compute_channel_mask(key, 3, 64, **kw))
    lengths = np.full(3, 64, np.int32)
    draws = jax_draws(key, lengths, 64, shared_rounding=True, min_masks=0,
                      **kw)
    got = tmask.span_mask_from_draws(torch.from_numpy(lengths), 64, *draws,
                                     min_masks=0, require_same_masks=True,
                                     **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.any()


@pytest.mark.parametrize("shared", [False, True])
def test_no_overlap_is_the_host_sampler_for_the_same_seed(shared):
    kw = dict(mask_prob=0.5, mask_length=4, mask_selection="static",
              min_masks=2, min_space=1, require_same_masks=False)
    lengths = np.array(LENGTHS, np.int32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jmask.compute_span_mask(
        key, jnp.asarray(lengths), T, no_overlap=True,
        shared_rounding=shared, **kw))
    seed = int(jax.random.bits(key, dtype=jnp.uint32))
    got = tmask.host_span_mask(seed, torch.from_numpy(lengths), T,
                               shared_rounding=shared, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    # the sampler draws its seed from the generator, then runs that path
    gen = torch.Generator().manual_seed(7)
    again = torch.Generator().manual_seed(7)
    drawn = tmask.compute_span_mask(gen, torch.from_numpy(lengths), T,
                                    no_overlap=True, shared_rounding=shared,
                                    **kw)
    want = tmask.host_span_mask(tmask.draw_host_seed(again),
                                torch.from_numpy(lengths), T,
                                shared_rounding=shared, **kw)
    assert torch.equal(drawn, want)


def test_max_spans_upper_bound_is_jax():
    for args in [(768, 0.8, 10, 2), (48, 0.65, 4, 2), (5, 0.1, 10, 0)]:
        assert tmask.max_spans_upper_bound(*args) == (
            jmask.max_spans_upper_bound(*args))


@pytest.mark.parametrize("case", ["static", "poisson_dropout"])
def test_device_draws_match_jax_in_distribution(case):
    # 200 draws of each sampler; the mean masked fraction of the valid
    # frames must agree within 5 binomial sigmas of the draws' frames
    kw = dict(BASE, **CASES[case])
    kw.pop("shared_rounding", None)
    lengths = np.array((48, 40, 30, 45), np.int32)
    n, valid = 200, int(lengths.sum())
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    ref = np.asarray(jax.vmap(lambda k: jmask.compute_span_mask(
        k, jnp.asarray(lengths), T, **kw))(keys))
    gen = torch.Generator().manual_seed(11)
    got = np.stack([tmask.compute_span_mask(
        gen, torch.from_numpy(lengths), T, **kw).numpy() for _ in range(n)])
    p_ref, p_got = ref.sum() / (n * valid), got.sum() / (n * valid)
    sigma = np.sqrt(p_ref * (1 - p_ref) / (n * valid))
    assert abs(p_got - p_ref) < 5 * sigma * np.sqrt(2), (p_got, p_ref)
    assert not got[:, np.arange(T)[None, :] >= lengths[:, None]].any()


def test_same_generator_state_gives_the_same_mask():
    lengths = torch.tensor(LENGTHS)
    kw = dict(BASE, mask_selection="normal", mask_other=1.0, mask_dropout=0.1)
    a = tmask.compute_span_mask(torch.Generator().manual_seed(3), lengths,
                                T, **kw)
    b = tmask.compute_span_mask(torch.Generator().manual_seed(3), lengths,
                                T, **kw)
    c = tmask.compute_span_mask(torch.Generator().manual_seed(4), lengths,
                                T, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_melhubert_forward_draws_its_mask_without_one():
    cfg = MelHuBERTConfig.from_dict(dict(
        feat_emb_dim=80, encoder_layers=1, encoder_embed_dim=64,
        encoder_ffn_embed_dim=128, encoder_attention_heads=1, head_dim=64,
        conv_pos=8, conv_pos_groups=4, num_cluster=16, mask_prob=0.8,
        mask_length=4))
    model = MelHuBERTModel(cfg)
    lengths = np.array([40, 23])
    pad = torch.from_numpy(
        (np.arange(40)[None, :] < lengths[:, None]).astype(np.float32))
    feat = torch.randn(2, 40, 80, generator=torch.Generator().manual_seed(0))

    def draw(seed):
        with torch.no_grad():
            return melhubert_forward(model, feat, pad, mask=True,
                                     rng=torch.Generator().manual_seed(seed))

    a, b = draw(1), draw(1)
    mask = a["mask_indices"]
    assert mask.dtype == torch.bool and mask.shape == (2, 40)
    assert torch.equal(mask, b["mask_indices"])
    assert torch.equal(a["hidden"], b["hidden"])
    assert not mask[1, 23:].any() and mask.sum(1).min() > 0
    # JAX's arguments: min_masks=2 and each row its own count
    gen = torch.Generator()
    gen.manual_seed(int(torch.randint(0, 2 ** 31 - 1, (), generator=(
        torch.Generator().manual_seed(1)))))
    want = tmask.compute_span_mask(
        gen, torch.from_numpy(lengths).int(), 40, mask_prob=0.8,
        mask_length=4, min_masks=2, require_same_masks=False)
    assert torch.equal(mask, want)
