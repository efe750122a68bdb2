"""A callable lr in the port's optimizer (``train/steps.py::make_optimizer``)
against JAX's generic optax path (``optax.adam(schedule)`` after the clip
and the coupled L2): 3 updates, one of them skipped for a non-finite
gradient, within 1e-6 rel. of JAX's parameters (each entry) and moments
(each tensor's L2 norm). optax reads
its schedule on the count before the increment (0 at the first update);
a callable lr together with an lr_schedule raises JAX's ValueError."""

import jax
import numpy as np
import pytest
import torch

from speech_ssl_compression_tpu.train import steps as jsteps
from speech_ssl_compression_tpu_torch.train import steps as tsteps

RTOL = 1e-6


def _trees():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [jax.tree.map(lambda a, s=s: (s * rng.standard_normal(a.shape))
                          .astype(np.float32), params) for s in (40.0, 1, 0.5)]
    grads[1]["w"][0, 1] = np.inf  # the second update is skipped
    return params, grads


@pytest.mark.parametrize("lr_kind", ["decay", "warmup"])
def test_callable_lr_matches_jax_generic_path(lr_kind):
    if lr_kind == "decay":
        jlr = lambda c: 1e-2 * 0.5 ** c  # noqa: E731
        tlr = jlr
    else:  # lr(0) = 0: the first update moves nothing
        kw = dict(warmup_updates=2, total_num_update=10)
        jlr = jsteps.polynomial_decay_schedule(1e-2, **kw)
        tlr = tsteps.polynomial_decay_schedule(1e-2, **kw)
    hyper = dict(betas=(0.9, 0.98), eps=1e-6, weight_decay=0.01,
                 gradient_clipping=1.0)
    jopt = jsteps.make_optimizer(lr=jlr, **hyper)
    assert not hasattr(jopt, "hyper")  # JAX's generic optax path
    apply = jsteps.make_apply_step(jopt)
    topt = tsteps.make_optimizer(lr=tlr, **hyper)
    params, grads = _trees()
    jp, jstate = params, jopt.init(params)
    tp = [torch.tensor(a) for a in jax.tree.leaves(params)]
    tstate = tsteps.init_opt_state(tp)
    start = [t.clone() for t in tp]
    for i, g in enumerate(grads):
        jp, jstate, jnorm = apply(jp, jstate, g, np.float32(2.0))
        tnorm = tsteps.fused_apply(
            topt, tp, tstate, [torch.tensor(a) for a in jax.tree.leaves(g)],
            2.0)
        assert np.isfinite(float(tnorm)) == (i != 1)
        for a, b in zip(tp, jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=1e-9)
        if i == 0 and lr_kind == "warmup":
            assert all(torch.equal(a, b) for a, b in zip(tp, start))
    # moments: optax's Adam state (its schedule count aside), each within
    # RTOL rel. L2 (the clip's scale rounds differently in the two chains,
    # which moves entries near 0 by more than RTOL of themselves)
    adam = jstate[-1][0]  # the adam chain's ScaleByAdamState
    assert int(tstate[0]) == int(adam.count) == 2
    n = len(tp)
    for a, b in zip(tstate[1:1 + n] + tstate[1 + n:],
                    jax.tree.leaves(adam.mu) + jax.tree.leaves(adam.nu)):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a.numpy() - b) < RTOL * np.linalg.norm(b)
    assert tsteps.applied_lr(topt, tstate) is None  # as JAX's generic path


def test_callable_lr_with_a_schedule_raises_as_in_jax():
    sched = tsteps.polynomial_decay_schedule(1e-3)
    with pytest.raises(ValueError, match="not both"):
        tsteps.make_optimizer(lr=lambda c: 1e-3, lr_schedule=sched)
    with pytest.raises(ValueError, match="not both"):
        jsteps.make_optimizer(lr=lambda c: 1e-3,
                              lr_schedule=jsteps.polynomial_decay_schedule(
                                  1e-3))
