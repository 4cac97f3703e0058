"""The port's Alg. 1 driver against the JAX reference's on resnet8-cifar10,
on the CPU: the gradient and update checks of ``test_torch_search_driver.py``
(tolerances stated there, in ``_check_gradients``) through convs, residual
blocks and the classifier's cross-entropy.  A file of its own: the
reference's eager gradients of resnet8 take about a minute to compile.
"""
import jax.numpy as jnp
import numpy as np

from test_torch_search_driver import _check_gradients, _driver_pair, _sync


def test_driver_gradients_match_the_reference_resnet8():
    """The same gradient and update checks on resnet8-cifar10 (convs,
    residual blocks, the classifier's cross-entropy) at batch 4, one step
    of each kind from the init, with random NAS logits whose argmax
    activation precision is 8 bits: with 2-bit activations and 2-bit
    weights a conv output can sum to exactly 0 in one framework's order
    and not in the other's, which opens or closes a ReLU, so FROZEN steps
    differ by up to 2% there (the reference's own jitted and eager
    gradients differ so too)."""
    jd, td, batches = _driver_pair(n=4, bs=4, model="resnet8-cifar10")
    rng = np.random.default_rng(0)
    favour_8 = {"gamma": 0.0, "delta": np.array([0.0, 0.0, 10.0])}
    jd.nas = {site: {k: jnp.asarray((rng.standard_normal(np.shape(v)) * 3
                                     + favour_8[k]).astype(np.float32))
                     for k, v in leaves.items()} for site, leaves in jd.nas.items()}
    for kind in ("warmup", "theta", "w", "finetune"):
        _sync(td, jd)
        _check_gradients(jd, td, kind, batches[0])
