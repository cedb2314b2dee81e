"""Helpers shared by the port's tests (tests/test_torch_*.py)."""

import functools

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One intra-op thread while a port test module runs: the suite runs
    several worker processes at once, and torch's default thread pool per
    worker oversubscribes the cores and stalls its many small CPU ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_metaseg_tree(widths=(32, 64, 128, 256), bottleneck=512, seed=0):
    """A metaseg parameter tree with the structure and shapes of
    ``metaseg_unet.init_params`` (read by ``jax.eval_shape``, which does not
    run the initializer) and seeded glorot-uniform numpy kernels, small
    random biases."""
    import jax

    from ecseg_tpu.models import metaseg_unet

    shapes = jax.eval_shape(
        lambda k: metaseg_unet.init_params(k, widths=widths, bottleneck=bottleneck),
        jax.random.PRNGKey(0),
    )
    rng = np.random.default_rng(seed)
    tree = {}
    for name, leaves in shapes.items():
        kh, kw, cin, cout = leaves["kernel"].shape
        limit = np.sqrt(6.0 / (kh * kw * (cin + cout)))
        tree[name] = {
            "kernel": rng.uniform(-limit, limit, (kh, kw, cin, cout)).astype(np.float32),
            "bias": rng.uniform(-0.05, 0.05, cout).astype(np.float32),
        }
    return tree


@functools.lru_cache(maxsize=None)
def bench_realistic_params(widths, bottleneck, seed=0):
    """``bench._realistic_params`` (a bf16 JAX tree) under one ``jax.jit``:
    the same values as the eager call, which compiles every initializer op
    on its own and takes about three times as long on the CPU.  Cached per
    process: the tree's arrays are immutable and tests share it."""
    import jax

    import bench

    fn = jax.jit(functools.partial(bench._realistic_params, widths=tuple(widths), bottleneck=bottleneck))
    return fn(jax.random.PRNGKey(seed))
