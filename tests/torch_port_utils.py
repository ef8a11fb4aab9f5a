"""Helpers for the PyTorch-port parity tests (``tests/test_torch_*.py``).

Parameters of a flax module are made without an eager ``init``: the shapes
come from ``jax.eval_shape`` and the values from a numpy seed, so the JAX
side and the port get the same weights. Data crosses between the two
packages as numpy arrays.

Every port test module imports ``_one_thread``, which pytest then applies
to each test of that module.
"""

import numpy as np
import pytest
import torch

import jax


def init_shapes(module, *args, **kwargs):
    """The module's variable shapes, via ``jax.eval_shape`` (no compute)."""
    return jax.eval_shape(lambda key: module.init(key, *args, **kwargs), jax.random.key(0))


def fill_params(shapes, seed: int = 0):
    """Seeded f32 numpy values for every leaf of a shape tree: lecun-scaled
    kernels, and biases, norm scales and relative-position tables far enough
    from their init values that a wrong mapping shows."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        shape = leaf.shape
        if names[-1] == "kernel":
            stacked = "blocks" in names  # scan_blocks leaves lead with depth
            fan_in = int(np.prod(shape[1 if stacked else 0:-1]))
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        elif names[-1] == "scale":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif names[-1] == "rel_pos_bias":
            a = 0.5 * rng.normal(size=shape)
        else:
            a = 0.1 * rng.normal(size=shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def seeded_variables(module, *args, seed: int = 0, **kwargs):
    """``{"params": ...}`` for ``module`` filled from ``seed`` (numpy leaves)."""
    return {"params": fill_params(init_shapes(module, *args, **kwargs)["params"], seed)}


def port(a, dtype=torch.float32) -> torch.Tensor:
    """A numpy array as a CPU tensor for the port."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def no_tf32() -> None:
    """Full-f32 matmuls and convolutions, as the references compute."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several workers on few cores: one intra-op thread per
    worker keeps the port's tests from thrashing each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
