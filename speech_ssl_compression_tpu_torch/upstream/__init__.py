"""The pretrain experts: the reference's per-upstream training wrappers
(upstream/{melhubert,hubert,wav2vec2,melhubert_distiller}/pretrain_expert.py),
with the contract its runner asserts (runner.py:149-152):

    expert.forward(data, global_step, log_step) -> (loss, sample_size)
    expert.load_model(init_ckpt)
    expert.add_state_to_save(all_states)

Port of ``speech_ssl_compression_tpu/upstream/__init__.py``. The port's
trainers drive their grad steps directly; these wrappers keep the
reference's contract for code written against it. ``forward`` returns the
loss on the autograd graph of the expert's parameters (the caller runs
``loss.backward()``, as the reference runner does). Each expert takes an
explicit ``device`` (``cuda`` unless the caller asks for the CPU) and
draws its span masks and dropout from a host ``torch.Generator`` seeded
with 0, where JAX's use ``PRNGKey(0)``.
"""

import importlib

from .melhubert import MelHuBERTPretrainExpert
from .melhubert_distiller import MelHuBERTDistillerExpert


def get_pretrain_expert(upstream: str):
    """The ``UpstreamPretrainExpert`` class of ``upstream``'s module, the
    reference's importlib lookup (runner.py:131-134)."""
    module = importlib.import_module(f".{upstream}", __package__)
    return getattr(module, "UpstreamPretrainExpert")
