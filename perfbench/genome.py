"""The benchmark's synthetic genome, made on the device from the seed.

A configuration file (``configs/<name>.json``) gives the chromosomes,
the bin size, the contact law, the planted loops, the trans contacts and
the balancing parameters.  ``make_genome`` draws the genome with one
``torch.Generator`` on the device:

* cis contacts of each chromosome in band form, ``band[i, d]`` the count
  of pixel (i, i + d) for d below ``diagonals``: a pixel is kept with
  probability ``keep_near`` (``keep_far`` from ``far_from`` on) and its
  count is Poisson(max(lambda0 / (1 + d)^exponent, lambda_min)) + 1;
* loops planted at ``density`` of the bins: a 5 x 5 Gaussian bump of
  ``peak`` at (i, i + span), added to the counts before they are rounded;
* with ``trans``, uniform contacts at ``density`` of each trans pair's
  cells, Poisson(``lambda``) + 1 each, colliding draws summed;
* with ``trans.foci``, trans foci at ``density`` of the shorter
  chromosome's bins of each pair: a square patch ``2 half_width + 1``
  bins wide whose every cell holds Poisson(``lambda``) + 1 contacts, with
  a Gaussian bump of ``peak`` (``bump_half_width``) at its centre, summed
  with the uniform contacts; so the trans maps hold calls.

This is the contact law of ``chromosight_torch/io/source.py:synth_chrom``
and ``synth_trans`` (and of ``tools/make_synthetic_cool.py``), drawn in
bulk on the device instead of from ``RandomState``.  ``ice_weights``
balances it with a plain torch loop (cooler's iterative correction with
the parameters chromosight passes).  Every reduction is a fixed-order
sum, so a seed gives the same genome and weights bit for bit.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

CONFIG_DIR = pathlib.Path(__file__).parent / "configs"


def load_config(name):
    """The configuration ``configs/<name>.json``."""
    path = CONFIG_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} ({path})")
    return json.loads(path.read_text())


class Genome:
    """A drawn genome: ``bands[c]`` the (n_c, D) float32 count band of
    chromosome c, ``trans[(c1, c2)]`` the (rows, cols, counts) int64
    tensors of a trans pair, ``weights`` the float64 ICE weights of every
    bin (NaN where a bin has none), ``offsets`` the first bin of each
    chromosome, and the planted loops as (chrom, i, j) local bins."""

    def __init__(self, config, bands, trans, loops):
        self.config = config
        self.names = [c[0] for c in config["chroms"]]
        self.lengths = [int(c[1]) for c in config["chroms"]]
        self.binsize = int(config["binsize"])
        self.sizes = [-(-length // self.binsize) for length in self.lengths]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)
        self.bands = bands
        self.trans = trans
        self.loops = loops
        self.weights = None

    @property
    def n_bins(self):
        return int(self.offsets[-1])

    def to(self, device):
        """The genome with its tensors on ``device``."""
        self.bands = [b.to(device) for b in self.bands]
        self.trans = {k: tuple(t.to(device) for t in v) for k, v in self.trans.items()}
        return self

    def pixels(self):
        """(bin1, bin2, count) numpy arrays of every pixel, sorted by
        (bin1, bin2), as a cooler file stores them."""
        b1s, b2s, cts = [], [], []
        for c, band in enumerate(self.bands):
            i, d = torch.nonzero(band, as_tuple=True)
            off = int(self.offsets[c])
            b1s.append(i + off)
            b2s.append(i + d + off)
            cts.append(band[i, d].to(torch.int64))
        for (c1, c2), (r, k, v) in self.trans.items():
            b1s.append(r + int(self.offsets[c1]))
            b2s.append(k + int(self.offsets[c2]))
            cts.append(v)
        b1, b2, ct = torch.cat(b1s), torch.cat(b2s), torch.cat(cts)
        if self.trans:
            key = b1 * self.n_bins + b2
            order = torch.argsort(key, stable=True)
            b1, b2, ct = b1[order], b2[order], ct[order]
        return b1.cpu().numpy(), b2.cpu().numpy(), ct.to(torch.int32).cpu().numpy()

    def nnz(self):
        total = sum(int(torch.count_nonzero(b)) for b in self.bands)
        return total + sum(int(v[0].numel()) for v in self.trans.values())


def _draw_band(n, law, gen, device):
    """(n, D) float64 count band of one chromosome's cis contacts."""
    width = min(int(law["diagonals"]), n)
    d = torch.arange(width, device=device, dtype=torch.float64)
    lam = torch.clamp(law["lambda0"] / (1 + d) ** law["exponent"], min=law["lambda_min"])
    keep_p = torch.where(d < law["far_from"], law["keep_near"], law["keep_far"])
    u = torch.rand((n, width), generator=gen, device=device, dtype=torch.float64)
    counts = torch.poisson(lam.expand(n, width).contiguous(), generator=gen) + 1
    rows = torch.arange(n, device=device)[:, None]
    inside = rows + torch.arange(width, device=device)[None, :] < n
    return torch.where((u < keep_p[None, :]) & inside, counts, 0.0)


def _plant_loops(band, n, spec, gen, device):
    """Add the loops' bumps to ``band`` in place; their (i, j) bins."""
    n_loops = max(int(spec["min_count"]), int(n * spec["density"]))
    hi = n - int(spec["end_margin"])
    if hi <= spec["first_bin"]:
        return []
    i = torch.randint(int(spec["first_bin"]), hi, (n_loops,), generator=gen, device=device)
    span = torch.randint(int(spec["min_span"]), int(spec["max_span"]), (n_loops,),
                         generator=gen, device=device)
    i, span = i.cpu().numpy(), span.cpu().numpy()
    h = int(spec["half_width"])
    u, v = np.meshgrid(np.arange(-h, h + 1), np.arange(-h, h + 1), indexing="ij")
    bump = spec["peak"] * np.exp(-(u * u + v * v) / 2.0)
    rows = (i[:, None, None] + u[None]).ravel()
    diags = (span[:, None, None] + v[None] - u[None]).ravel()
    vals = np.broadcast_to(bump[None], (n_loops, *bump.shape)).ravel()
    flat = rows * band.shape[1] + diags
    uniq, inv = np.unique(flat, return_inverse=True)
    summed = np.zeros(len(uniq))
    np.add.at(summed, inv, vals)  # a fixed order: the sum repeats bit for bit
    idx = torch.from_numpy(uniq).to(device)
    band.view(-1)[idx] += torch.from_numpy(summed).to(device)
    return list(zip(i.tolist(), (i + span).tolist()))


def _draw_trans(n1, n2, spec, gen, device):
    """Sorted (rows, cols, counts) int64 of one trans pair's contacts."""
    m = int(spec["density"] * n1 * n2)
    rows = torch.randint(0, n1, (m,), generator=gen, device=device)
    cols = torch.randint(0, n2, (m,), generator=gen, device=device)
    lam = torch.full((m,), float(spec["lambda"]), device=device, dtype=torch.float64)
    counts = (torch.poisson(lam, generator=gen) + 1).to(torch.int64)
    uniq, inv = torch.unique(rows * n2 + cols, sorted=True, return_inverse=True)
    summed = torch.zeros(len(uniq), dtype=torch.int64, device=device)
    summed.index_add_(0, inv, counts)  # integer sums: exact in any order
    return uniq // n2, uniq % n2, summed


def _plant_trans_foci(n1, n2, pixels, spec, gen, device):
    """``pixels`` (rows, cols, counts) of a trans pair with the foci of
    ``spec`` added: sorted, colliding cells summed."""
    rows, cols, counts = pixels
    n_foci = max(int(spec["min_count"]), int(spec["density"] * min(n1, n2)))
    margin = int(spec["margin"])
    ci = torch.randint(margin, n1 - margin, (n_foci,), generator=gen, device=device)
    cj = torch.randint(margin, n2 - margin, (n_foci,), generator=gen, device=device)
    h, b = int(spec["half_width"]), int(spec["bump_half_width"])
    u = torch.arange(-h, h + 1, device=device)
    side = 2 * h + 1
    lam = torch.full((n_foci, side, side), float(spec["lambda"]), device=device,
                     dtype=torch.float64)
    patch = torch.poisson(lam, generator=gen) + 1
    bump = spec["peak"] * torch.exp(-(u[:, None] ** 2 + u[None, :] ** 2).double() / 2.0)
    bump = torch.where((u[:, None].abs() <= b) & (u[None, :].abs() <= b), bump, 0.0)
    patch = torch.round(patch + bump[None]).to(torch.int64)
    fr = (ci[:, None, None] + u[None, :, None]).expand(-1, side, side).reshape(-1)
    fc = (cj[:, None, None] + u[None, None, :]).expand(-1, side, side).reshape(-1)
    uniq, inv = torch.unique(torch.cat([rows * n2 + cols, fr * n2 + fc]), sorted=True,
                             return_inverse=True)
    summed = torch.zeros(len(uniq), dtype=torch.int64, device=device)
    summed.index_add_(0, inv, torch.cat([counts, patch.reshape(-1)]))  # exact in any order
    return uniq // n2, uniq % n2, summed


def make_genome(config, seed, device):
    """Draw the genome of ``config`` (a loaded configuration) from
    ``seed`` on ``device``, and its ICE weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    genome = Genome(config, [], {}, [])
    law, loops_spec = config["contact_law"], config["loops"]
    for c, n in enumerate(genome.sizes):
        band = _draw_band(n, law, gen, device)
        loops = _plant_loops(band, n, loops_spec, gen, device)
        genome.loops += [(genome.names[c], i, j) for i, j in loops]
        genome.bands.append(torch.round(band).to(torch.float32))
    if config.get("trans"):
        for c1 in range(len(genome.sizes)):
            for c2 in range(c1 + 1, len(genome.sizes)):
                n1, n2 = genome.sizes[c1], genome.sizes[c2]
                pixels = _draw_trans(n1, n2, config["trans"], gen, device)
                if config["trans"].get("foci"):
                    pixels = _plant_trans_foci(n1, n2, pixels, config["trans"]["foci"],
                                               gen, device)
                genome.trans[(c1, c2)] = pixels
    genome.weights = ice_weights(genome, config["balance"])
    return genome


def _shear_sum(values):
    """``out[j] = sum_d values[j - d, d]`` (the column sums of a band),
    in a fixed order: the band is written into the diagonals of an
    (n + D, D) array through a strided view, then summed by rows."""
    n, width = values.shape
    out = values.new_zeros((n + width) * width)
    out.as_strided((n, width), (width, width + 1)).copy_(values)
    return out.view(n + width, width).sum(1)[:n]


def _marginals(band, bias):
    """Marginals of the symmetric map of ``band`` (both triangles)."""
    n, width = band.shape
    b_j = torch.cat([bias, bias.new_zeros(width)]).unfold(0, width, 1)[:n]
    vals = band * bias[:, None] * b_j
    return vals.sum(1) + _shear_sum(vals)


def _median(t):
    """The median of a 1-D float tensor, numpy's (mean of the two middle
    values)."""
    s = torch.sort(t).values
    k = s.numel()
    return (s[(k - 1) // 2] + s[k // 2]) / 2


def ice_weights(genome, spec):
    """ICE weights of the genome's cis maps (cooler's iterative
    correction, ``cis_only``): the first ``ignore_diags`` diagonals
    dropped, bins with fewer than ``min_nnz`` pixels and bins whose log
    marginal, scaled by its chromosome's median, lies more than
    ``mad_max`` median absolute deviations below the genome's median
    excluded; then each chromosome iterated until the variance of its
    non-zero marginals is below ``tol``, and its weights divided by the
    square root of its mean marginal.  float64 numpy, NaN where a bin
    has no weight."""
    ignore = int(spec["ignore_diags"])
    bands, scaled, keeps = [], [], []
    for band in genome.bands:
        band = band.to(torch.float64).clone()
        band[:, :ignore] = 0
        nz = (band > 0).to(torch.float64)
        nnz = nz.sum(1) + _shear_sum(nz)
        marg = band.sum(1) + _shear_sum(band)
        keep = nnz >= spec["min_nnz"]
        positive = marg[keep & (marg > 0)]
        med = _median(positive) if positive.numel() else marg.new_tensor(1.0)
        bands.append(band)
        keeps.append(keep)
        scaled.append(marg / med)
    logs = torch.cat([torch.log(s[k & (s > 0)]) for s, k in zip(scaled, keeps)])
    med = _median(logs)
    dev = _median((logs - med).abs())
    cutoff = float(torch.exp(med - spec["mad_max"] * dev))
    weights = []
    for band, keep, s in zip(bands, keeps, scaled):
        bias = (keep & (s >= cutoff)).to(torch.float64)
        scale = None
        for _ in range(int(spec["max_iters"])):
            marg = _marginals(band, bias)
            nzmarg = marg[marg != 0]
            if nzmarg.numel() == 0:
                break
            scale = nzmarg.mean()
            marg = marg / scale
            marg = torch.where(marg == 0, 1.0, marg)
            bias = bias / marg
            if float(nzmarg.var(unbiased=False)) < spec["tol"]:
                break
        if scale is None:
            bias = torch.full_like(bias, float("nan"))
        else:
            bias = torch.where(bias == 0, float("nan"), bias / torch.sqrt(scale))
        weights.append(bias)
    return torch.cat(weights).cpu().numpy()
