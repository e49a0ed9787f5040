"""Band-engine ops of the PyTorch port against chromosight_tpu.ops.band,
on the same numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chromosight_tpu.ops.band as jband
import chromosight_torch.ops.band as tband
from torch_parity import (
    CASES,
    KERNELS,
    MISSING_TOL,
    PEARSON,
    assert_pearson_close,
    band_case,
    jax_band_normxcorr,
    torch_one_thread,  # noqa: F401
)


def _raw_band(seed=0, n=200, width=64):
    rng = np.random.RandomState(seed)
    band = rng.rand(n, width).astype(np.float32) * 3
    band[band < 0.6] = 0
    band[rng.rand(n, width) < 0.05] = np.nan
    band[rng.rand(n, width) < 0.01] = 40.0  # detrends above max_val
    detect = np.ones(n, bool)
    detect[[3, 50, 51]] = False
    return band, detect


def test_sliding_vector_matches_jax():
    vec = np.arange(20, dtype=np.float32)
    got = tband.sliding_vector(torch.from_numpy(vec), 12, 6)
    ref = np.asarray(jband.sliding_vector(jnp.asarray(vec), 12, 6))
    assert np.array_equal(got.numpy(), ref)
    with pytest.raises(ValueError):
        tband.sliding_vector(torch.from_numpy(vec), 16, 6)


def test_band_finalize_upload_matches_jax():
    band, _ = _raw_band()
    got = tband.band_finalize_upload(torch.from_numpy(band[:, :50]), 64)
    ref = np.asarray(jband.band_finalize_upload(jnp.asarray(band[:, :50]), 64))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref, equal_nan=True)


@pytest.mark.parametrize("zero_nan", [True, False])
def test_band_preprocess_matches_jax(zero_nan):
    band, detect = _raw_band(seed=1)
    keep_dist, n_diags = 40, 41
    ref = np.asarray(
        jband.band_preprocess(
            jnp.asarray(band), jnp.asarray(detect), 10, keep_dist, n_diags,
            zero_nan=zero_nan,
        )
    )
    got = tband.band_preprocess(
        torch.from_numpy(band), torch.from_numpy(detect), 10, keep_dist,
        n_diags, zero_nan=zero_nan,
    ).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(got == 0, ref == 0)
    ok = np.isfinite(ref)
    assert np.allclose(got[ok], ref[ok], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kernel_name", ["loops", "rect3x17"])
def test_band_frame_matches_jax(kernel_name):
    kernel = KERNELS[kernel_name]()
    band, miss, n, max_dist = band_case(kernel, "sparse")
    ref_sig, ref_mask = jband._band_frame(
        jnp.asarray(band), jnp.asarray(miss), kernel.shape, n, max_dist
    )
    sig, mask = tband.band_frame(
        torch.from_numpy(band), torch.from_numpy(miss), kernel.shape, n, max_dist
    )
    assert np.array_equal(mask.numpy(), np.asarray(ref_mask))
    assert np.array_equal(sig.numpy(), np.asarray(ref_sig))


@pytest.mark.parametrize("kernel_name,layout", CASES)
def test_band_normxcorr_reference_matches_jax(kernel_name, layout):
    kernel = KERNELS[kernel_name]()
    band, miss, n, max_dist = band_case(kernel, layout)
    ref = jax_band_normxcorr(band, miss, kernel, n, max_dist)
    got = tband.band_normxcorr_reference(
        torch.from_numpy(band), torch.from_numpy(miss), kernel, n, max_dist,
        MISSING_TOL, PEARSON,
    )
    assert_pearson_close(ref, got, n, max_dist)


def _candidate_maps(seed=1, n=256, w=40):
    rng = np.random.RandomState(seed)
    corr = rng.normal(0, 0.05, (n, w)).astype(np.float32)
    hot = rng.choice(n * w, 90, replace=False)
    corr.ravel()[hot] = rng.uniform(0.5, 0.9, 90).astype(np.float32)
    logp = rng.normal(-3, 1, (n, w)).astype(np.float32)
    return corr, corr >= 0.5, logp


def test_extract_candidates_matches_jax():
    corr, cand, _ = _candidate_maps()
    packed = np.asarray(
        jband.extract_candidates_packed(jnp.asarray(corr), jnp.asarray(cand), 1024)
    )
    count = int(packed[3, 0])
    ref = {
        (int(i), int(d), float(v))
        for i, d, v in zip(packed[0, :count], packed[1, :count], packed[2, :count])
    }
    ii, dd, vals = tband.extract_candidates(
        torch.from_numpy(corr), torch.from_numpy(cand)
    )
    got = {
        (int(i), int(d), float(v))
        for i, d, v in zip(ii.tolist(), dd.tolist(), vals.tolist())
    }
    assert len(got) == count == int(cand.sum())
    assert got == ref


@pytest.mark.parametrize("win", [(17, 17), (5, 9)])
def test_gather_tail_matches_jax(win):
    corr, _, logp = _candidate_maps(seed=2)
    band = np.random.RandomState(3).rand(*corr.shape).astype(np.float32)
    rng = np.random.RandomState(4)
    # rows and diagonals in and around the band edges
    p1 = rng.randint(-3, corr.shape[0] + 3, 64).astype(np.int32)
    dsc = rng.randint(-2, corr.shape[1] + 2, 64).astype(np.int32)
    ref = np.asarray(
        jband.gather_tail_packed(
            jnp.asarray(corr), jnp.asarray(logp), jnp.asarray(band),
            jnp.asarray(p1), jnp.asarray(dsc), *win,
        )
    )
    got = tband.gather_tail(
        torch.from_numpy(corr), torch.from_numpy(logp), torch.from_numpy(band),
        torch.from_numpy(p1).long(), torch.from_numpy(dsc).long(), *win,
    ).numpy()
    assert np.array_equal(got, ref)


def test_shear_kernel_matches_jax():
    kernel = KERNELS["rect5x9"]()
    assert np.array_equal(tband.shear_kernel(kernel), jband.shear_kernel(kernel))
