"""The port's band engine at the three fp32 decision boundaries of
tests/test_fp32_boundaries.py: the ``min_pres`` window cutoff (:127), the
1e-10 denominator guard (:171) and the straddle of the pearson threshold
(:222), each held to that file's float64 oracle (:40) with its bounds, and
the two near-zero windows of the guard case, whose oracle scores are below
2e-6, held to the oracle within 1e-7 (the port's float64 Pearson algebra;
a float32 numerator cancels to 0 there).  ``pearson_from_sums`` itself is
held to a numpy float64 transcription on seeded random sums.

The same bands go through the port's framing (``ops.band.band_frame``)
and then through the plain twin of the CUDA kernel
(``ops.band.pearson_reference``) and through ``band_pearson_emulated``,
the CPU transcription of the kernel's own arithmetic.  The CUDA kernel
itself runs these cases on the card, in chip_smoke.py's kernels phase."""

import numpy as np
import pytest
import torch

from chromosight_torch.ops.band import band_frame, pearson_reference
from chromosight_torch.ops.band_pearson import band_pearson_emulated
from test_fp32_boundaries import (
    KSIZE,
    MAX_DIST,
    MIN_PRES,
    MISSING_TOL,
    MK,
    N,
    NK,
    PEARSON,
    _base_band,
    _oracle,
    get_K,
)
from torch_parity import torch_one_thread  # noqa: F401

ENGINES = {"plain": pearson_reference, "emulated": band_pearson_emulated}


def _framed(band, missing):
    return band_frame(
        torch.from_numpy(np.asarray(band, np.float32)),
        torch.from_numpy(np.asarray(missing, bool)),
        (MK, NK),
        N,
        MAX_DIST,
    )


def _run_port(band, missing, K, engine):
    """(port corr, oracle corr, oracle n_pres) on the port's framed inputs,
    the oracle cropped and trimmed as ``test_fp32_boundaries._run_engine``
    crops and trims it."""
    sig_p, mask_p = _framed(band, missing)
    corr = ENGINES[engine](sig_p, mask_p, K, N, MAX_DIST, MISSING_TOL, PEARSON)[0]
    out64, n_pres = _oracle(sig_p.double().numpy(), mask_p.double().numpy(), K)
    kh = (MK - 1) // 2
    out64, n_pres = out64[kh : kh + N], n_pres[kh : kh + N]
    i, d = np.indices(out64.shape)
    out64[~((d <= MAX_DIST) & (i < N) & ((i + d) < N))] = 0.0
    return corr.double().numpy(), out64, n_pres


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_min_pres_cutoff_exact_at_boundary(engine):
    """A window with exactly ``min_pres`` present pixels is kept and one
    with one fewer is dropped, in the port as in the oracle."""
    rng = np.random.default_rng(7)
    band = _base_band(rng)
    missing = np.zeros(N, bool)
    missing[96] = True
    missing[np.arange(132, 140)] = True
    missing[np.arange(293, 299)] = True
    missing[np.arange(333, 337)] = True
    band[missing, :] = 0.0
    ii, dd = np.indices(band.shape)
    band[np.isin(ii + dd, np.flatnonzero(missing))] = 0.0

    corr32, corr64, n_pres = _run_port(band, missing, get_K(), engine)

    a, b = (100, 40), (300, 40)
    assert n_pres[a] == MIN_PRES and n_pres[b] == MIN_PRES - 1
    assert corr64[a] != 0.0 and corr32[a] != 0.0
    assert corr64[b] == 0.0 and corr32[b] == 0.0
    assert abs(corr32[a] - corr64[a]) < 5e-5


def _guard_case(engine):
    """The windows of tests/test_fp32_boundaries.py:171: an exactly
    constant patch, a visible +0.1 pixel, and a +5e-4 pixel on a constant
    patch (window variance ~1e-9, below the float32 cancellation noise).
    Returns (port corr, oracle corr, oracle window variance)."""
    from scipy.signal import correlate2d

    from test_fp32_boundaries import _shear

    rng = np.random.default_rng(13)
    band = _base_band(rng)
    missing = np.zeros(N, bool)
    band[40:120, 10:90] = 1.0
    band[200, 40] += 0.1
    band[340:420, 10:90] = 1.0
    band[380, 40] += 5e-4
    corr32, corr64, _ = _run_port(band, missing, get_K(), engine)
    sig_p = _framed(band, missing)[0].double().numpy()
    sh_1 = _shear(np.ones((MK, NK)))
    m1 = correlate2d(sig_p, sh_1, mode="valid") / KSIZE
    m2 = correlate2d(sig_p**2, sh_1, mode="valid") / KSIZE
    var64 = (m2 - m1**2)[(MK - 1) // 2 :][:N]
    return corr32, corr64, var64


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_denominator_guard_windows_hold_the_parity_budget(engine):
    """Constant windows are zero in both, a window with visible variance
    is non-zero in both, and where the port and the oracle disagree on
    zero outside the float32 ambiguity region of the window variance, the
    scores still agree within the 5e-5 parity budget (no candidate at
    pearson 0.3 changes)."""
    corr32, corr64, var64 = _guard_case(engine)
    assert corr32[64, 40] == 0.0 and corr64[64, 40] == 0.0
    assert corr32[200, 40] != 0.0 and corr64[200, 40] != 0.0
    flip = ((corr32 == 0.0) != (corr64 == 0.0)) & (var64 >= 1e-5)
    assert np.abs(corr32 - corr64)[flip].max(initial=0.0) < 5e-5
    assert np.abs(corr64[flip]).max(initial=0.0) < PEARSON


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_denominator_guard_constant_and_near_constant_windows(engine):
    """tests/test_fp32_boundaries.py:171 on the port: every zero/non-zero
    disagreement over the map lies where the oracle's window variance is
    below the float32 cancellation noise (1e-5)."""
    corr32, corr64, var64 = _guard_case(engine)
    assert corr32[64, 40] == 0.0 and corr64[64, 40] == 0.0
    assert corr32[200, 40] != 0.0 and corr64[200, 40] != 0.0
    flip = (corr32 == 0.0) != (corr64 == 0.0)
    assert var64[flip].size == 0 or var64[flip].max() < 1e-5


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_near_zero_guard_windows_match_the_oracle(engine):
    """Band pixels (179, 41) and (179, 48) of the guard case (window
    variance 0.038 and 0.045, oracle scores 3.8e-7 and 1.9e-6) within
    1e-7 of the float64 oracle, and non-zero."""
    corr32, corr64, _ = _guard_case(engine)
    for pixel in ((179, 41), (179, 48)):
        assert 0 < abs(corr64[pixel]) < 2e-6
        assert corr32[pixel] != 0.0
        assert abs(corr32[pixel] - corr64[pixel]) < 1e-7


def _numpy_pearson(s_k, s_x, s_x2, s_m, s_mk, s_mk2, sums, ksize, missing_tol,
                   threshold=1e-4):
    """``pearson_from_sums`` transcribed in numpy float64: the snaps
    decided on the float32 roundings, the algebra on the sums."""
    thr = np.float32(threshold)
    inv_ksize = np.float32(1) / np.float32(ksize)

    def snap(x, rounded=None):
        rounded = x.astype(np.float32) if rounded is None else rounded
        return np.where(np.abs(rounded) < thr, 0.0, x)

    ksum, k2sum = sums[:, 0, None], sums[:, 1, None]
    conv_sk, n_miss, conv_mk, conv_mk2 = map(snap, (s_k, s_m, s_mk, s_mk2))
    sig_mean0 = snap(s_x / ksize, s_x.astype(np.float32) * inv_ksize)
    sig2_mean0 = snap(s_x2 / ksize, s_x2.astype(np.float32) * inv_ksize)
    with np.errstate(divide="ignore", invalid="ignore"):
        n_pres = ksize - n_miss
        kmean_eff = (ksum - conv_mk) / n_pres
        k2mean_eff = (k2sum - conv_mk2) / n_pres
        corr_f = ksize / n_pres
        sig_mean = sig_mean0 * corr_f
        sig2_mean = sig2_mean0 * corr_f
        denom = np.sqrt((sig2_mean - sig_mean * sig_mean)
                        * (k2mean_eff - kmean_eff * kmean_eff))
        denom = np.where(n_pres < int((1 - missing_tol) * ksize), 0.0, denom)
        num = (conv_sk - sig_mean * kmean_eff / corr_f) * corr_f
        out = num * np.where(np.abs(denom) < 1e-10, 0.0, 1.0 / denom)
    return np.clip(np.where(np.isfinite(out), out, 0.0), -1.0, 1.0), n_pres


def test_pearson_from_sums_matches_a_float64_oracle():
    """Seeded random window sums (some within a float32 ulp of the 1e-4
    snap threshold, some windows below ``min_pres``) through
    ``pearson_from_sums``: float64 corr and n_pres within rtol 1e-12 of
    the numpy transcription, every snap decided on the float32 rounding
    (the zeros equal), and ``snap64`` keeping surviving sums unrounded."""
    from chromosight_torch.ops.band import pearson_from_sums, snap64

    rng = np.random.default_rng(5)
    ksize, n_k, size = KSIZE, 3, 4000
    s_m = rng.integers(0, ksize // 2 + 20, size).astype(np.float64)
    s_m[::7] = 0.0
    s_x = rng.uniform(0.5, 2.0, size) * (ksize - s_m)
    s_x2 = s_x**2 / (ksize - s_m) * rng.uniform(1.0, 1.2, size)
    s_k = rng.normal(0, 1, (n_k, size)) * 10.0 ** rng.uniform(-7, 0, (n_k, size))
    s_mk = rng.uniform(0, 1, (n_k, size)) * s_m
    s_mk2 = s_mk * rng.uniform(0.5, 1.0, (n_k, size))
    edge = np.float64(np.float32(1e-4))
    near = edge * (1 + np.array([-1e-7, -1e-9, 0.0, 1e-9, 1e-7, 1e-6]))
    s_k[0, : len(near)] = near
    s_x[: len(near)] = near * ksize
    sums = np.stack([rng.normal(5, 1, n_k), rng.uniform(30, 40, n_k)], 1)
    args = (s_k, s_x, s_x2, s_m, s_mk, s_mk2)
    corr, n_pres = pearson_from_sums(
        *map(torch.from_numpy, args), torch.from_numpy(sums), ksize, MISSING_TOL
    )
    want, want_n = _numpy_pearson(*args, sums, ksize, MISSING_TOL)
    assert corr.dtype == n_pres.dtype == torch.float64
    np.testing.assert_allclose(corr.numpy(), want, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(n_pres.numpy(), want_n, rtol=1e-12)
    assert np.array_equal(corr.numpy() == 0, want == 0)
    assert (want == 0).any() and (want != 0).any()
    snapped = snap64(torch.from_numpy(s_k), 1e-4).numpy()
    decided = np.abs(s_k.astype(np.float32)) < np.float32(1e-4)
    assert np.array_equal(snapped == 0, decided | (s_k == 0))
    assert np.array_equal(snapped[~decided], s_k[~decided])


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_pearson_threshold_straddle(engine):
    """Windows built at pearson +/- 1e-2 and +/- 1e-6: within 5e-5 of the
    built score, and the clear ones on the same side of the threshold as
    the oracle."""
    rng = np.random.default_rng(29)
    K = get_K()
    kc = (K - K.mean()).ravel()
    kc /= np.linalg.norm(kc)
    q = rng.standard_normal(KSIZE)
    q -= q.mean()
    q -= (q @ kc) * kc
    q /= np.linalg.norm(q)
    band = np.full((N, 128), 1.0)
    targets = {
        (60, 40): PEARSON + 1e-2,
        (140, 40): PEARSON - 1e-2,
        (220, 40): PEARSON + 1e-6,
        (300, 40): PEARSON - 1e-6,
    }
    for (r, d), rho in targets.items():
        patch = (1.0 + rho * kc + np.sqrt(1 - rho**2) * q).reshape(MK, NK)
        for u in range(MK):
            for v in range(NK):
                band[r - 8 + u, d - u + v] = patch[u, v]

    corr32, corr64, _ = _run_port(band, np.zeros(N, bool), K, engine)

    for (r, d), rho in targets.items():
        assert abs(corr64[r, d] - rho) < 1e-6
        assert abs(corr32[r, d] - rho) < 5e-5
        if abs(rho - PEARSON) > 1e-3:
            assert (corr32[r, d] >= PEARSON) == (rho >= PEARSON)
            assert (corr64[r, d] >= PEARSON) == (rho >= PEARSON)
