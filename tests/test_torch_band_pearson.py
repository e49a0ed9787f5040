"""The band Pearson kernel's CPU side: its emulation against the JAX band
engines (XLA and Pallas interpret), the wrapper's CPU route and checks,
and the p-value form the CUDA kernel uses."""

import math

import jax.numpy as jnp
import pytest
import torch

import chromosight_torch.ops.band_pearson as bp
from chromosight_torch.device import resolve_device
from chromosight_torch.ops.band import band_frame, band_normxcorr_reference
from chromosight_tpu.ops.pallas_band import band_normxcorr_pallas
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


def _framed(kernel, layout):
    band, miss, n, max_dist = band_case(kernel, layout)
    sig_p, mask_p = band_frame(
        torch.from_numpy(band), torch.from_numpy(miss), kernel.shape, n, max_dist
    )
    return band, miss, n, max_dist, sig_p, mask_p


@pytest.mark.parametrize("kernel_name,layout", CASES)
def test_emulated_kernel_matches_jax_band(kernel_name, layout):
    kernel = KERNELS[kernel_name]()
    band, miss, n, max_dist, sig_p, mask_p = _framed(kernel, layout)
    ref = jax_band_normxcorr(band, miss, kernel, n, max_dist)
    got = bp.band_pearson_emulated(
        sig_p, mask_p, kernel, n, max_dist, MISSING_TOL, PEARSON
    )
    assert_pearson_close(ref, got, n, max_dist)


@pytest.mark.parametrize(
    "kernel_name,layout", [("loops_small", "dense"), ("loops", "sparse")]
)
def test_emulated_kernel_matches_pallas_interpret(kernel_name, layout):
    """n_pad = 256 with loops_small and n_pad = 512 with loops."""
    kernel = KERNELS[kernel_name]()
    band, miss, n, max_dist, sig_p, mask_p = _framed(kernel, layout)
    ref = band_normxcorr_pallas(
        jnp.asarray(band), jnp.asarray(miss), jnp.asarray(kernel),
        kernel.shape, n, max_dist, MISSING_TOL, PEARSON, interpret=True,
    )
    got = bp.band_pearson_emulated(
        sig_p, mask_p, kernel, n, max_dist, MISSING_TOL, PEARSON
    )
    assert_pearson_close(ref, got, n, max_dist)


@pytest.mark.parametrize("kernel_name", ["loops", "rect3x17"])
def test_band_pearson_cpu_is_reference_and_launches_nothing(kernel_name):
    kernel = KERNELS[kernel_name]()
    band, miss, n, max_dist, sig_p, mask_p = _framed(kernel, "sparse")
    before = bp.LAUNCHES
    got = bp.band_pearson(sig_p, mask_p, kernel, n, max_dist, MISSING_TOL, PEARSON)
    ref = band_normxcorr_reference(
        torch.from_numpy(band), torch.from_numpy(miss), kernel, n, max_dist,
        MISSING_TOL, PEARSON,
    )
    assert bp.LAUNCHES == before
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_band_pearson_rejects_bad_inputs():
    kernel = KERNELS["loops_small"]()
    _, _, n, max_dist, sig_p, mask_p = _framed(kernel, "dense")
    args = (kernel, n, max_dist, MISSING_TOL, PEARSON)
    with pytest.raises(TypeError):
        bp.band_pearson(sig_p.double(), mask_p, *args)
    with pytest.raises(ValueError):
        bp.band_pearson(sig_p.t(), mask_p.t(), *args)
    with pytest.raises(ValueError):
        bp.band_pearson(sig_p[:-1], mask_p, *args)
    with pytest.raises(ValueError):
        bp.band_pearson(sig_p[:4, :4].contiguous(), mask_p[:4, :4].contiguous(), *args)
    with pytest.raises(ValueError, match="cpu or cuda"):
        bp.band_pearson(sig_p.to("meta"), mask_p.to("meta"), *args)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_log10p_erfcx_form_matches_log_ndtr():
    """The kernel's log(0.5 erfcx(a/sqrt2)) - a^2/2 form of log_ndtr(-a),
    over a in [0, 40] and at inf and nan."""
    a = torch.cat(
        [torch.linspace(0, 40, 4001), torch.tensor([math.inf, math.nan])]
    )
    got = bp.log10_two_sided(a)
    ref = (torch.special.log_ndtr(-a) + math.log(2)) / math.log(10)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4, equal_nan=True)
    assert got[-2] == -math.inf and torch.isnan(got[-1])
    assert got[0] == 0


@pytest.mark.parametrize("kernel_name,layout", [("loops", "sparse"), ("rect5x9", "dense"), ("rect3x17", "sparse")])
def test_separable_window_sums_match_tap_loop_sums(kernel_name, layout):
    """The kernel's separable window sums (row sums over v, then an
    anti-diagonal sum over u) equal the sums over all mk*nk taps within
    1e-12 relative, on x, x^2 and the mask."""
    kernel = KERNELS[kernel_name]()
    mk, nk = kernel.shape
    _, _, n, max_dist, sig_p, mask_p = _framed(kernel, layout)
    n_pad = sig_p.shape[0] - 2 * (mk - 1)
    w_out = sig_p.shape[1] - (mk - 1) - (nk - 1)
    sig64, mask64 = sig_p.double(), mask_p.double()
    got = bp.separable_window_sums(sig64, mask64, mk, nk, n_pad, w_out)
    kh = (mk - 1) // 2
    ref = [torch.zeros((n_pad, w_out), dtype=torch.float64) for _ in range(3)]
    for u in range(mk):
        for v in range(nk):
            col = mk - 1 - u + v
            x = sig64[kh + u : kh + u + n_pad, col : col + w_out]
            ref[0] += x
            ref[1] += x * x
            ref[2] += mask64[kh + u : kh + u + n_pad, col : col + w_out]
    for a, b in zip(got, ref):
        assert a.shape == (n_pad, w_out)
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
    assert float(got[2].max()) > 0
