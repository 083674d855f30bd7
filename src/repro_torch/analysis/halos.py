"""Friends-of-Friends dark-matter halo finder (paper §III Metric 3a).

Particles closer than a linking length ``b`` (canonically 0.2 x mean
interparticle separation) are friends; connected components are halos.
Post-analysis quantities follow the paper:

* halo mass function — counts per mass (member-count) bin, log-spaced,
* halo-count ratio — reconstructed / original counts per bin (Fig. 6),
* Most Connected Particle (most friends within its halo),
* Most Bound Particle (lowest potential; direct sum, small halos only).

Implementation: spatial hashing on a cell grid of size b, pair generation
via 27 sorted neighbor-cell matches, then union-find with path halving —
fully vectorized numpy except the O(alpha) union loop. This is a *post hoc*
analysis tool (the paper runs it in PAT jobs on CPU), so a host-side
implementation is the faithful system shape; the compression path itself
stays on-device.

A verbatim copy of the JAX package's ``repro.analysis.halos`` (numpy only):
the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HaloCatalog:
    labels: np.ndarray  # int64[n] halo id per particle (-1 = unbound)
    sizes: np.ndarray  # int64[n_halos] member counts, sorted desc
    n_halos: int
    linking_length: float
    min_members: int


def _union_find_pairs(n: int, pairs_a: np.ndarray, pairs_b: np.ndarray) -> np.ndarray:
    """Connected components from edge lists via union-find (path halving)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.int64)
        while True:
            p = parent[x]
            gp = parent[p]
            done = p == gp
            if done.all():
                return p
            parent[x] = gp
            x = gp

    # process edges in chunks; iterate to convergence (few rounds suffice)
    a, b = pairs_a.astype(np.int64), pairs_b.astype(np.int64)
    for _ in range(64):
        ra, rb = find(a), find(b)
        merge = ra != rb
        if not merge.any():
            break
        lo = np.minimum(ra[merge], rb[merge])
        hi = np.maximum(ra[merge], rb[merge])
        # np.minimum.at resolves duplicate roots deterministically
        np.minimum.at(parent, hi, lo)
    return find(np.arange(n, dtype=np.int64))


def _neighbor_pairs(pos: np.ndarray, box: float, b: float) -> tuple[np.ndarray, np.ndarray]:
    """All particle pairs within distance b, via cell hashing (periodic box)."""
    n = len(pos)
    n_cells = max(int(np.floor(box / b)), 1)
    cell_sz = box / n_cells
    ci = np.floor(pos / cell_sz).astype(np.int64) % n_cells
    cid = (ci[:, 0] * n_cells + ci[:, 1]) * n_cells + ci[:, 2]

    order = np.argsort(cid, kind="stable")
    cid_s = cid[order]
    # group boundaries per occupied cell
    uniq, starts, counts = np.unique(cid_s, return_index=True, return_counts=True)

    pa_list, pb_list = [], []
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    for dx, dy, dz in offsets:
        nb = (
            ((ci[order][:, 0] + dx) % n_cells) * n_cells + ((ci[order][:, 1] + dy) % n_cells)
        ) * n_cells + ((ci[order][:, 2] + dz) % n_cells)
        # for each sorted particle, locate its neighbor cell's group
        gi = np.searchsorted(uniq, nb)
        gi = np.clip(gi, 0, len(uniq) - 1)
        hit = uniq[gi] == nb
        if not hit.any():
            continue
        src = np.where(hit)[0]
        g = gi[src]
        cnt = counts[g]
        mx = int(cnt.max())
        for k in range(mx):
            sel = cnt > k
            s = src[sel]
            tgt = starts[g[sel]] + k
            pa_list.append(order[s])
            pb_list.append(order[tgt])
    if not pa_list:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    pa = np.concatenate(pa_list)
    pb = np.concatenate(pb_list)
    keep = pa < pb  # dedupe + drop self-pairs
    pa, pb = pa[keep], pb[keep]
    d = pos[pa] - pos[pb]
    d -= box * np.round(d / box)  # periodic minimum image
    close = (d**2).sum(axis=1) <= b * b
    return pa[close], pb[close]


def fof_halos(positions: np.ndarray, box: float, linking_length: float | None = None,
              mean_separation: float | None = None, min_members: int = 10) -> HaloCatalog:
    """Run FoF. ``linking_length`` defaults to 0.2 x mean separation."""
    pos = np.asarray(positions, np.float64) % box
    n = len(pos)
    if linking_length is None:
        if mean_separation is None:
            mean_separation = box / round(n ** (1 / 3))
        linking_length = 0.2 * mean_separation
    pa, pb = _neighbor_pairs(pos, box, linking_length)
    roots = _union_find_pairs(n, pa, pb)
    _, inv, counts = np.unique(roots, return_inverse=True, return_counts=True)
    labels = np.where(counts[inv] >= min_members, inv, -1)
    halo_sizes = counts[counts >= min_members]
    return HaloCatalog(
        labels=labels.astype(np.int64),
        sizes=np.sort(halo_sizes)[::-1].astype(np.int64),
        n_halos=int((counts >= min_members).sum()),
        linking_length=float(linking_length),
        min_members=min_members,
    )


def mass_function(cat: HaloCatalog, n_bins: int = 12, max_mass: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Halo counts per log-spaced mass (member count) bin — Fig. 6 x/y."""
    if len(cat.sizes) == 0:
        return np.array([]), np.array([])
    hi = max_mass or int(cat.sizes.max())
    edges = np.unique(np.geomspace(cat.min_members, max(hi, cat.min_members + 1), n_bins + 1).astype(int))
    counts, _ = np.histogram(cat.sizes, bins=edges)
    centers = np.sqrt(edges[:-1] * edges[1:])
    return centers, counts


def halo_count_ratio(orig: HaloCatalog, recon: HaloCatalog, n_bins: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """Per-mass-bin count ratio reconstructed/original (paper Fig. 6)."""
    hi = int(max(orig.sizes.max(initial=orig.min_members),
                 recon.sizes.max(initial=orig.min_members)))
    edges = np.unique(np.geomspace(orig.min_members, hi + 1, n_bins + 1).astype(int))
    co, _ = np.histogram(orig.sizes, bins=edges)
    cr, _ = np.histogram(recon.sizes, bins=edges)
    centers = np.sqrt(edges[:-1] * edges[1:])
    good = co > 0
    return centers[good], cr[good] / co[good]


def halo_gate(orig: HaloCatalog, recon: HaloCatalog, tol: float = 0.1,
              min_bin_count: int = 10) -> tuple[bool, float]:
    """Acceptance: count ratio within 1 +/- tol on well-populated bins
    (bins under ``min_bin_count`` are Poisson-noise dominated — a single
    halo crossing a bin edge would flip the gate)."""
    hi = int(max(orig.sizes.max(initial=orig.min_members),
                 recon.sizes.max(initial=orig.min_members)))
    edges = np.unique(np.geomspace(orig.min_members, hi + 1, 13).astype(int))
    co, _ = np.histogram(orig.sizes, bins=edges)
    cr, _ = np.histogram(recon.sizes, bins=edges)
    good = co >= min_bin_count
    if not good.any():
        return True, 0.0
    dev = np.abs(cr[good] / co[good] - 1.0)
    return bool((dev <= tol).all()), float(dev.max())


def most_connected_particle(positions: np.ndarray, cat: HaloCatalog, box: float,
                            halo_id: int) -> int:
    """MCP: the member with the most friends inside its halo (paper §III)."""
    members = np.where(cat.labels == halo_id)[0]
    pos = positions[members] % box
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    within = (d**2).sum(axis=2) <= cat.linking_length**2
    return int(members[np.argmax(within.sum(axis=1))])


def most_bound_particle(positions: np.ndarray, cat: HaloCatalog, box: float,
                        halo_id: int) -> int:
    """MBP: lowest-potential member (direct O(m^2) sum; small halos)."""
    members = np.where(cat.labels == halo_id)[0]
    pos = positions[members] % box
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    r = np.sqrt((d**2).sum(axis=2))
    np.fill_diagonal(r, np.inf)
    phi = -(1.0 / r).sum(axis=1)
    return int(members[np.argmin(phi)])
