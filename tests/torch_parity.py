"""Shared inputs and checks for the PyTorch port's parity tests.

The same numpy inputs, made from a seed, go to a JAX function and its
port; ``assert_pearson_close`` holds the port to the tolerances the JAX
package holds its own two band engines to (tests/test_pallas.py:61-75).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

PRESETS = pathlib.Path(__file__).parents[1] / "chromosight_tpu" / "kernels" / "data"
MISSING_TOL, PEARSON = 0.5, 0.3


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One torch thread while a test module runs (Tier-1 runs six pytest
    workers), then the count it had.  ``torch.set_num_threads`` also sets
    the OpenMP thread count of the calling thread, and the native ICE
    kernels that later test files in the same worker run merge their
    per-thread partials in an order that depends on that count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def preset_kernel(name):
    with open(PRESETS / f"{name}.json") as handle:
        return np.asarray(json.load(handle)["kernels"][0], dtype=np.float32)


def rect_kernel(shape):
    return (np.random.RandomState(11).rand(*shape) + 0.1).astype(np.float32)


# (kernel, band layout): "dense" is tests/test_band.py's banded random
# matrix (n=150, n_pad=256, missing rows and columns zeroed), "sparse"
# tests/test_pallas.py's 40%-filled band (n=300, n_pad=512).
KERNELS = {
    "loops_small": lambda: preset_kernel("loops_small"),
    "loops": lambda: preset_kernel("loops"),
    "hairpins": lambda: preset_kernel("hairpins"),
    "stripes_left": lambda: preset_kernel("stripes_left"),
    "rect5x9": lambda: rect_kernel((5, 9)),
    "rect3x17": lambda: rect_kernel((3, 17)),
}
CASES = [(k, layout) for k in KERNELS for layout in ("dense", "sparse")]


def band_case(kernel, layout):
    """(band (n_pad, W) f32, missing (n_pad,) bool, n, max_dist)."""
    mk, nk = kernel.shape
    max_dist = 40
    width = max_dist + max(mk, nk) + 1
    if layout == "dense":
        n, n_pad, miss_rows, seed = 150, 256, [0, 1, 30, 77], 0
        rng = np.random.RandomState(seed)
        band = rng.rand(n_pad, width).astype(np.float32)
    else:
        n, n_pad, miss_rows, seed = 300, 512, [3, 77, 200], 0
        rng = np.random.RandomState(seed)
        band = (
            rng.rand(n_pad, width) * (rng.rand(n_pad, width) < 0.4)
        ).astype(np.float32)
    i, d = np.indices(band.shape)
    band[i + d >= n] = 0
    band[n:] = 0
    miss = np.zeros(n_pad, bool)
    miss[miss_rows] = True
    miss_j = np.concatenate([miss, np.zeros(width, bool)])[i + d]
    band[miss[:, None] | miss_j] = 0
    return band, miss, n, max_dist


def jax_band_normxcorr(band, miss, kernel, n, max_dist):
    """chromosight_tpu.ops.band.band_normxcorr on numpy inputs."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import band_normxcorr, shear_kernel

    out = band_normxcorr(
        jnp.asarray(band),
        jnp.asarray(miss),
        jnp.asarray(kernel),
        jnp.asarray(shear_kernel(kernel), jnp.float32),
        jnp.asarray(shear_kernel(kernel**2), jnp.float32),
        kernel.shape,
        n,
        max_dist,
        MISSING_TOL,
        PEARSON,
    )
    return tuple(np.asarray(a) for a in out)


def assert_pearson_close(ref, got, n, max_dist, pearson=PEARSON, corr_tol=2e-5):
    """corr within ``corr_tol``; log10-p within 2e-3 with equal finiteness
    on valid pixels (d <= max_dist, i < n, i + d < n); candidate flips
    only within 1e-4 of the threshold."""
    corr_r, logp_r, cand_r = (np.asarray(a) for a in ref)
    corr_g, logp_g, cand_g = (np.asarray(a) for a in got)
    assert corr_r.shape == corr_g.shape
    assert np.abs(corr_r - corr_g).max() < corr_tol
    flips = cand_r != cand_g
    assert np.all(np.abs(corr_r[flips] - pearson) < 1e-4)
    oi, od = np.indices(corr_r.shape)
    valid = (od <= max_dist) & (oi < n) & (oi + od < n)
    a, b = logp_r[valid], logp_g[valid]
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    assert np.array_equal(np.isnan(a), np.isnan(b))
    both = np.isfinite(a)
    assert np.abs(a[both] - b[both]).max() < 2e-3
