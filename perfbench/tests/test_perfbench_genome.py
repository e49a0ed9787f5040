"""The generator repeats per seed and differs across seeds; its ICE
weights and its cooler file read back through the port as made."""

import numpy as np
import torch

from perfbench import coolwrite
from perfbench.genome import load_config, make_genome

SMALL = [["chr1", 12_000_000], ["chr2", 9_000_000]]


def small_config(name="hg38-5kb", chroms=SMALL):
    cfg = load_config(name)
    cfg["chroms"] = [list(c) for c in chroms]
    return cfg


def same(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a.bands, b.bands))
            and np.array_equal(a.weights, b.weights, equal_nan=True)
            and all(torch.equal(x, y) for k in a.trans for x, y in zip(a.trans[k], b.trans[k]))
            and a.loops == b.loops)


def test_a_seed_repeats_bit_for_bit():
    cfg = small_config("hg38-trans3-5kb", SMALL + [["chr3", 6_000_000]])
    big_seed = 2**31 + 977
    assert same(make_genome(cfg, big_seed, "cpu"), make_genome(cfg, big_seed, "cpu"))


def test_seeds_differ():
    cfg = small_config()
    a, b = make_genome(cfg, 1, "cpu"), make_genome(cfg, 2, "cpu")
    assert not torch.equal(a.bands[0], b.bands[0])
    assert a.loops != b.loops
    # the same sizes and nearly the same amount of work from every seed
    assert [x.shape for x in a.bands] == [x.shape for x in b.bands]
    assert abs(a.nnz() - b.nnz()) < 0.01 * a.nnz()


def test_contact_law_and_loops():
    cfg = small_config()
    g = make_genome(cfg, 3, "cpu")
    band = g.bands[0]
    n = band.shape[0]
    kept = (band[: n - 600] > 0).double().mean(0)
    assert abs(float(kept[:450].mean()) - 0.97) < 0.005
    assert abs(float(kept[450:].mean()) - 0.5) < 0.01
    mean1 = float(band[: n - 600, 1][band[: n - 600, 1] > 0].mean())
    assert abs(mean1 - (80 / 2**0.8 + 1)) < 1.0  # Poisson(lambda) + 1 at d = 1
    assert len(g.loops) == 2 * 3  # max(3, bins / 1000) a chromosome
    for chrom, i, j in g.loops:
        c = g.names.index(chrom)
        assert g.bands[c][i, j - i] > 30


def test_ice_weights_balance_the_cis_maps():
    g = make_genome(small_config(), 4, "cpu")
    from perfbench.genome import _marginals

    for c, band in enumerate(g.bands):
        w = torch.from_numpy(g.weights[g.offsets[c] : g.offsets[c + 1]])
        b = band.double().clone()
        b[:, :2] = 0
        marg = _marginals(b, torch.nan_to_num(w, nan=0.0))
        ok = torch.isfinite(w)
        assert ok.sum() > 0.7 * len(w)
        assert torch.allclose(marg[ok], torch.ones_like(marg[ok]), atol=1e-2)


def test_ice_agrees_with_the_ports_balancing():
    from chromosight_torch.io.source import ArraySource
    from chromosight_torch.ops.balance import ice_balance

    g = make_genome(small_config(), 6, "cpu")
    b1, b2, ct = g.pixels()
    start = np.concatenate([np.arange(n) * g.binsize for n in g.sizes])
    src = ArraySource(g.names, g.offsets, start, start + g.binsize, b1, b2, ct,
                      binsize=g.binsize)
    ice_balance(src, cis_only=True, store=True, mad_max=5, ignore_diags=2, max_iters=200,
                min_nnz=10)
    assert np.array_equal(np.isnan(src.weights), np.isnan(g.weights))
    ok = ~np.isnan(g.weights)
    assert np.max(np.abs(src.weights[ok] / g.weights[ok] - 1)) < 0.01


def test_the_file_reads_back_through_the_port(tmp_path):
    from chromosight_torch.io.source import CoolSource

    cfg = small_config("hg38-trans3-5kb", SMALL)
    g = make_genome(cfg, 8, "cpu")
    b1, b2, ct = g.pixels()
    path = tmp_path / "g.mcool"
    coolwrite.write_mcool(path, g.names, g.lengths, g.binsize, g.weights, b1, b2, ct,
                          "resolutions/5000", 5 * g.n_bins)
    src = CoolSource(f"{path}::/resolutions/5000")
    assert list(src.chromnames) == g.names
    assert src.n_bins == g.n_bins and src.binsize == g.binsize
    assert np.array_equal(src.weights, g.weights, equal_nan=True)
    rows, cols, vals = src.pixels_coo(src.extent("chr1"), src.extent("chr2"), balance=False)
    sel = (b1 < g.offsets[1]) & (b2 >= g.offsets[1])
    got = sorted(zip(rows.tolist(), cols.tolist(), vals.tolist()))
    want = sorted(zip((b1[sel]).tolist(), (b2[sel] - g.offsets[1]).tolist(),
                      ct[sel].astype(float).tolist()))
    assert got == want
