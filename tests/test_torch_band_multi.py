"""The band Pearson in K-kernel mode and with --tsvd taps, on CPU: the
port's plain K-kernel twin and the emulation of the CUDA kernel's
arithmetic against chromosight_tpu.ops.band.band_normxcorr_multi, slice k
of an emulated K-kernel launch against a single-kernel one, and the tSVD
tap planes and maps against the JAX package's."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chromosight_torch.ops.band_pearson as bp
from chromosight_torch.ops.band import (
    band_frame,
    conv_kernels,
    kernel_coefficients,
    kernel_table,
    pearson_reference_multi,
)
from chromosight_tpu.detection import _band_conv_kernels, _band_sheared_args
from chromosight_tpu.ops.band import (
    band_normxcorr,
    band_normxcorr_multi,
    coo_to_band,
    shear_kernel,
)
from torch_parity import (
    KERNELS,
    MISSING_TOL,
    PEARSON,
    PRESETS,
    assert_pearson_close,
    band_case,
    torch_one_thread,  # noqa: F401
)

TSVD = 0.999


def preset_kernels(name):
    with open(PRESETS / f"{name}.json") as handle:
        return np.stack([np.asarray(k, np.float64) for k in json.load(handle)["kernels"]])


def multikernel_case():
    """tests/test_multikernel.py's inputs: three 5x9 kernels on a banded
    random matrix (n = 150, n_pad = 256, four missing bins)."""
    rng = np.random.RandomState(7)
    n, max_dist = 150, 40
    kernels = np.stack([rng.rand(5, 9) + 0.1 for _ in range(3)])
    keep = max_dist + 9
    dense = rng.rand(n, n)
    i, j = np.indices((n, n))
    dense[(j - i < 0) | (j - i > keep)] = 0
    miss = np.zeros(n, bool)
    miss[[0, 1, 30, 77]] = True
    dense[miss, :] = 0
    dense[:, miss] = 0
    r, c = np.nonzero(dense)
    band = np.zeros((256, keep + 1), np.float32)
    band[:n] = coo_to_band(r, c, dense[r, c], n, keep + 1)
    miss_p = np.zeros(256, bool)
    miss_p[:n] = miss
    return kernels, band, miss_p, n, max_dist


def borders_case():
    """The three 17x17 borders kernels on tests/test_pallas.py's sparse
    band (n = 300, n_pad = 512)."""
    kernels = preset_kernels("borders")
    band, miss, n, max_dist = band_case(kernels[0], "sparse")
    return kernels, band, miss, n, max_dist


CASES = {"multikernel_5x9": multikernel_case, "borders": borders_case}


def framed(kernel_shape, band, miss, n, max_dist):
    return band_frame(
        torch.from_numpy(band), torch.from_numpy(miss), kernel_shape, n, max_dist
    )


def jax_multi(kernels, band, miss, n, max_dist):
    out = band_normxcorr_multi(
        jnp.asarray(band),
        jnp.asarray(miss),
        jnp.asarray(kernels, jnp.float32),
        jnp.asarray(np.stack([shear_kernel(k) for k in kernels]), jnp.float32),
        jnp.asarray(np.stack([shear_kernel(k**2) for k in kernels]), jnp.float32),
        kernels.shape[1:],
        n,
        max_dist,
        MISSING_TOL,
        PEARSON,
    )
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("impl", ["plain", "emulated"])
@pytest.mark.parametrize("case", list(CASES))
def test_multi_kernel_matches_jax_multi(case, impl):
    """Each slice k: corr within 2e-5, log10-p within 2e-3 on valid
    pixels, candidate flips only within 1e-4 of the threshold."""
    kernels, band, miss, n, max_dist = CASES[case]()
    ref = jax_multi(kernels, band, miss, n, max_dist)
    sig_p, mask_p = framed(kernels.shape[1:], band, miss, n, max_dist)
    fn = pearson_reference_multi if impl == "plain" else bp.band_pearson_emulated
    got = fn(sig_p, mask_p, kernels, n, max_dist, MISSING_TOL, PEARSON)
    assert all(t.shape == (len(kernels),) + ref[0].shape[1:] for t in got)
    for k in range(len(kernels)):
        assert_pearson_close([r[k] for r in ref], [g[k] for g in got], n, max_dist)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_multi_slice_equals_single_launch(case):
    """Slice k of the emulated K-kernel launch equals the emulated
    single-kernel launch on kernel k, bit for bit (NaN log10-p of the
    pad included): the same taps in the same order per sum, as in the
    CUDA kernel."""
    kernels, band, miss, n, max_dist = CASES[case]()
    sig_p, mask_p = framed(kernels.shape[1:], band, miss, n, max_dist)
    args = (n, max_dist, MISSING_TOL, PEARSON)
    multi = bp.band_pearson_emulated(sig_p, mask_p, kernels, *args)
    for k, kernel in enumerate(kernels):
        single = bp.band_pearson_emulated(sig_p, mask_p, kernel, *args)
        for a, b in zip(multi, single):
            assert torch.equal(a[k].view(torch.uint8), b.view(torch.uint8))


def test_band_pearson_cpu_multi_is_plain_and_launches_nothing():
    kernels, band, miss, n, max_dist = borders_case()
    sig_p, mask_p = framed(kernels.shape[1:], band, miss, n, max_dist)
    before = (bp.LAUNCHES, bp.LAUNCHES_MULTI)
    args = (n, max_dist, MISSING_TOL, PEARSON)
    got = bp.band_pearson(sig_p, mask_p, kernels, *args)
    ref = pearson_reference_multi(sig_p, mask_p, kernels, *args)
    assert (bp.LAUNCHES, bp.LAUNCHES_MULTI) == before
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("tsvd", [None, TSVD])
def test_device_table_is_the_kernel_table_built_once(tsvd):
    """The tap table a launch reads is ``kernel_table``'s (float64 taps
    and sums), built once per kernel stack, tsvd share and device, then
    reused."""
    kernels = np.stack(preset_kernels("borders"))
    cpu = torch.device("cpu")
    first = bp.device_table(kernels, tsvd, cpu)
    coef, sums = kernel_table(kernels, tsvd)
    assert first[0].dtype == first[1].dtype == torch.float64
    torch.testing.assert_close(first[0], coef, rtol=0, atol=0)
    torch.testing.assert_close(first[1], sums, rtol=0, atol=0)
    again = bp.device_table(kernels.copy(), tsvd, cpu)
    assert all(a is b for a, b in zip(again, first))
    other = bp.device_table(kernels, 0.9 if tsvd is None else None, cpu)
    assert not any(a is b for a, b in zip(other, first))


@pytest.mark.parametrize("name", ["loops", "loops_small", "hairpins", "borders"])
def test_tsvd_tap_planes_match_jax(name):
    """The --tsvd planes of ``kernel_coefficients`` are JAX's
    rank-truncated ``_band_conv_kernels`` in float64 (the JAX engine
    rounds them to float32), and the float64 sums still come from the
    original kernel; without tsvd the planes are K and K**2."""
    kernel = preset_kernels(name)[0]
    ck, ck2 = _band_conv_kernels(kernel, TSVD)
    ours = conv_kernels(kernel, TSVD)
    np.testing.assert_array_equal(ours[0], ck)
    np.testing.assert_array_equal(ours[1], ck2)
    coef, ksum, k2sum = kernel_coefficients(kernel, *ours)
    assert coef.dtype == ksum.dtype == k2sum.dtype == torch.float64
    np.testing.assert_array_equal(coef[0].numpy(), ck / kernel.size)
    np.testing.assert_array_equal(coef[1].numpy(), ck)
    np.testing.assert_array_equal(coef[2].numpy(), ck2)
    k64 = kernel.astype(np.float64)
    assert float(ksum) == float(np.sum(k64))
    assert float(k2sum) == float(np.sum(k64 * k64))
    plain, _, _ = kernel_coefficients(kernel)
    np.testing.assert_array_equal(plain[1].numpy(), k64)
    np.testing.assert_array_equal(plain[2].numpy(), k64**2)


@pytest.mark.parametrize("impl", ["plain", "emulated"])
@pytest.mark.parametrize("kernel_name,layout", [("loops", "sparse"), ("loops_small", "dense")])
def test_tsvd_maps_match_jax(kernel_name, layout, impl):
    """--tsvd maps against JAX's band engine on its rank-factorised taps
    (the separable conv of ``_band_sheared_args``): the port convolves
    the reconstructed kernels through its one tap loop, so the two sum
    in different orders; the bounds are those of the untruncated maps."""
    kernel = KERNELS[kernel_name]().astype(np.float64)
    band, miss, n, max_dist = band_case(kernel, layout)
    sheared, sheared_sq = _band_sheared_args(kernel, TSVD)
    ref = band_normxcorr(
        jnp.asarray(band), jnp.asarray(miss), jnp.asarray(kernel, jnp.float32),
        sheared, sheared_sq, kernel.shape, n, max_dist, MISSING_TOL, PEARSON,
    )
    sig_p, mask_p = framed(kernel.shape, band, miss, n, max_dist)
    fn = bp.band_pearson if impl == "plain" else bp.band_pearson_emulated
    got = fn(sig_p, mask_p, kernel, n, max_dist, MISSING_TOL, PEARSON, tsvd=TSVD)
    assert_pearson_close([np.asarray(a) for a in ref], got, n, max_dist)
