"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the 1 real CPU device
(the 512-device override belongs to launch/dryrun.py ONLY, per the brief).
Multi-device sharding tests spawn subprocesses (tests/test_sharded.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips where there is none)")


@pytest.fixture(scope="session")
def xmc_small():
    """Separable-ish power-law XMC problem, solved in seconds on CPU."""
    from repro.data.xmc import make_xmc_dataset
    return make_xmc_dataset(n_train=300, n_test=100, n_features=1024,
                            n_labels=64, seed=0)


@pytest.fixture(scope="session")
def xmc_small_jnp(xmc_small):
    d = xmc_small
    return (jnp.asarray(d.X_train), jnp.asarray(d.Y_train),
            jnp.asarray(d.X_test), jnp.asarray(d.Y_test))


@pytest.fixture(scope="session")
def dismec_model(xmc_small_jnp):
    """One trained DiSMEC model shared by accuracy/pruning/prediction tests."""
    from repro.core.dismec import DiSMECConfig, train
    X, Y, _, _ = xmc_small_jnp
    cfg = DiSMECConfig(C=1.0, delta=0.01, label_batch=64)
    return train(X, Y, cfg)


def assert_finite(tree, name="tree"):
    leaves = jax.tree.leaves(tree)
    for i, leaf in enumerate(leaves):
        assert bool(jnp.all(jnp.isfinite(leaf))), f"{name} leaf {i} not finite"
