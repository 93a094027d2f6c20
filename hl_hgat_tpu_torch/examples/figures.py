"""The three analysis figures of the JAX package's ``examples/figures.py``,
their arrays computed on the card by the port.

1. ``tsp_trend.png``: per-layer feature magnitudes of a small TSP backbone
   (``make_backbone`` snapshots, ``utils.viz.feature_trends``; reference
   fig/tsp_trend.png);
2. ``cifar_attention.png``: superpixel images and the node / edge gates of a
   small ``cifar10sp_attpool`` (``return_atts``; OHBM_DEMO.ipynb cell 56);
3. ``brain_fc_attention.png``: a lobe-sorted ROI × ROI matrix (reference
   ``plt_sort_anatomy``), on the real Shen-268 skeleton and affiliations
   when ``$HLHGAT_BRAIN_DIR`` names the reference's group data
   (``data.brain.REFERENCE_BRAIN_DIR``), synthetic parcels otherwise.

``*_arrays`` compute what a figure shows (on ``--device``, the card unless
``cpu`` is given; weights from ``--seed`` on the CPU, so both devices get
the same model); ``render_*`` draw them with matplotlib (Agg), imported
only there::

    python -m hl_hgat_tpu_torch.examples.figures --out_dir fig/
    python -m hl_hgat_tpu_torch.examples.figures --out_dir fig/ --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import build_complex, collate
from hl_hgat_tpu_torch.complex.coarsen import build_pyramid
from hl_hgat_tpu_torch.data import brain as brain_data
from hl_hgat_tpu_torch.data.synthetic import synthetic_tsp_batch
from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, make_backbone
from hl_hgat_tpu_torch.utils.viz import attention_fc_matrix, feature_trends, to_numpy

TSP_BACKBONE = BackboneConfig(channels=(2, 2), filters=(8, 16), k=2, init_k=2)
CIFAR_MODEL = dict(channels=(1, 1), filters=(8, 16), k=2, mlp_channels=(8,))
CIFAR_GRAPHS = 4


def _normalize01(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    span = x.max() - x.min()
    return (x - x.min()) / (span if span > 0 else 1.0)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# 1. TSP feature trends
# ---------------------------------------------------------------------------


@torch.no_grad()
def tsp_trend_arrays(seed: int = 0, device=None) -> dict[str, np.ndarray]:
    """Mean |activation| of nodes and edges after each backbone layer, on 4
    synthetic TSP graphs (the x_s aug-mask column dropped), BN on its
    initial running statistics."""
    batch = synthetic_tsp_batch(4, seed=seed).to(resolve_device(device))
    x_s = batch.x_s[..., :-1]
    backbone = make_backbone(TSP_BACKBONE, batch.x_t.shape[-1], x_s.shape[-1],
                             torch.Generator().manual_seed(seed))
    backbone = backbone.to(batch.x_t.device).eval()
    _, _, snapshots = backbone(batch.x_t, x_s, batch, return_snapshots=True)
    return feature_trends(snapshots, batch.levels[0])


def render_tsp_trend(trends: dict[str, np.ndarray], out_png: str) -> str:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    layers = np.arange(1, len(trends["node"]) + 1)
    ax.plot(layers, trends["node"], "o-", label="nodes (x_t)")
    ax.plot(layers, trends["edge"], "s-", label="edges (x_s)")
    ax.set_xlabel("layer")
    ax.set_ylabel("mean |activation| (valid simplices)")
    ax.set_title("TSP model per-layer feature trends")
    ax.set_xticks(layers)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


# ---------------------------------------------------------------------------
# 2. CIFAR superpixel attention overlay
# ---------------------------------------------------------------------------


def _synthetic_superpixel_image(rng: np.random.Generator, size: int = 32) -> np.ndarray:
    """Smooth random blobs, the stand-in for a CIFAR image."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    img = np.zeros((size, size, 3))
    for c in range(3):
        for _ in range(3):
            cy, cx = rng.uniform(4, size - 4, 2)
            s = rng.uniform(3, 8)
            a = rng.uniform(0.3, 1.0)
            img[..., c] += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2))
    return _normalize01(img)


def _superpixel_graph(img: np.ndarray, grid: int = 8):
    """Grid superpixels: centroids, mean colours and 4-neighbour edges."""
    cell = img.shape[0] // grid
    pos, color = [], []
    for r in range(grid):
        for c in range(grid):
            patch = img[r * cell:(r + 1) * cell, c * cell:(c + 1) * cell]
            pos.append([c * cell + cell / 2, r * cell + cell / 2])
            color.append(patch.reshape(-1, 3).mean(0))
    src, dst = [], []
    for r in range(grid):
        for c in range(grid):
            i = r * grid + c
            if c + 1 < grid:
                src.append(i), dst.append(i + 1)
            if r + 1 < grid:
                src.append(i), dst.append(i + grid)
    return (np.asarray(pos), np.asarray(color, np.float32), np.asarray(src, np.int64),
            np.asarray(dst, np.int64))


@torch.no_grad()
def cifar_attention_arrays(seed: int = 0, device=None) -> dict:
    """Four synthetic superpixel graphs (one pooled level, flat batch)
    through a small ``cifar10sp_attpool`` in eval mode: the images,
    centroids, the fine level's rows and the first gates (a_t, a_s)."""
    rng = np.random.default_rng(seed)
    images, samples, positions = [], [], []
    for gi in range(CIFAR_GRAPHS):
        img = _synthetic_superpixel_image(rng)
        pos, color, src, dst = _superpixel_graph(img)
        s = build_complex(np.stack([src, dst]), len(pos), x_t=color,
                          x_s=np.abs(color[src] - color[dst]),
                          y=np.asarray([gi % 10], np.float32))
        s.levels, s.pools = build_pyramid(s.levels, 1)
        images.append(img)
        samples.append(s)
        positions.append(pos)
    host = collate(samples, multiple=1)
    device = resolve_device(device)
    model, _ = presets.cifar10sp_attpool(**CIFAR_MODEL, in_t=host.x_t.shape[-1],
                                         in_s=host.x_s.shape[-1], seed=seed, device=device)
    _, extras = model.eval()(host.to(device), return_atts=True)
    a_t, a_s = extras["atts"][0]  # the fine level's gates (pool_locs 0)
    lvl = host.levels[0]
    return dict(images=images, positions=positions, a_t=to_numpy(a_t).reshape(-1),
                a_s=to_numpy(a_s).reshape(-1), n_id=lvl.n_id, s_id=lvl.s_id,
                node_mask=lvl.node_mask > 0, edge_mask=lvl.edge_mask > 0, src=lvl.src,
                dst=lvl.dst)


def render_cifar_attention(arrays: dict, out_png: str) -> str:
    plt = _pyplot()
    from matplotlib.collections import LineCollection

    fig, axes = plt.subplots(2, CIFAR_GRAPHS, figsize=(16, 8))
    for gi in range(CIFAR_GRAPHS):
        image = arrays["images"][gi]
        ax = axes[0][gi]
        ax.imshow(image)
        ax.set_xticks([]), ax.set_yticks([])
        ax = axes[1][gi]
        ax.imshow(image)
        nsel = arrays["node_mask"] & (arrays["n_id"] == gi)
        esel = arrays["edge_mask"] & (arrays["s_id"] == gi)
        att_t = _normalize01(arrays["a_t"][nsel])
        att_s = _normalize01(arrays["a_s"][esel])
        pos = arrays["positions"][gi]
        base = np.nonzero(nsel)[0].min()
        segs = np.stack([pos[arrays["src"][esel] - base], pos[arrays["dst"][esel] - base]],
                        axis=1)
        # the notebook's colours: edges by 1 - att_s, nodes by att_t, on Reds
        lc = LineCollection(segs, cmap=plt.cm.Reds, norm=plt.Normalize(0.15, 1.0),
                            linewidths=1.0)
        lc.set_array(1.0 - att_s)
        ax.add_collection(lc)
        ax.scatter(pos[:, 0], pos[:, 1], c=att_t, cmap=plt.cm.Reds, vmin=0.1, vmax=1.0, s=14,
                   zorder=3)
        ax.set_xticks([]), ax.set_yticks([])
    fig.suptitle("superpixel graphs (top) and node/edge attention (bottom)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return out_png


# ---------------------------------------------------------------------------
# 3. Lobe-sorted brain FC attention heatmap
# ---------------------------------------------------------------------------


def brain_fc_arrays(seed: int = 0) -> dict:
    """The sorted matrix, its block sizes and labels: the real skeleton's
    normalized FC weights sorted by the real lobes when the reference data
    directory exists, else random scores on a random 100-ROI skeleton
    sorted by 10 random parcels."""
    rng = np.random.default_rng(seed)
    if brain_data.reference_data_available():
        g = brain_data.load_group_fc()
        aff = brain_data.load_affiliations()
        src, dst, w = brain_data.real_skeleton(g["fc_mean"], g["sf_mask"])
        n = int(max(src.max(), dst.max())) + 1
        m = attention_fc_matrix(_normalize01(w), src, dst, n)
        out = brain_data.lobe_sorted_matrix(m, aff["affiliation"], aff["lobe_names"])
        return dict(matrix=out["matrix"], sizes=out["sizes"], labels=out["labels"])
    n, n_lobes = 100, 10
    parcels = rng.integers(0, n_lobes, n)
    src, dst = np.triu_indices(n, 1)
    keep = rng.random(src.size) < 0.1
    src, dst = src[keep], dst[keep]
    m = attention_fc_matrix(rng.random(src.size), src, dst, n)
    order = np.argsort(parcels, kind="stable")
    return dict(matrix=m[np.ix_(order, order)], sizes=np.bincount(parcels, minlength=n_lobes),
                labels=[f"P{i}" for i in range(n_lobes)])


def render_brain_fc(arrays: dict, out_png: str) -> str:
    plt = _pyplot()
    sizes = np.asarray(arrays["sizes"])
    fig, ax = plt.subplots(figsize=(10, 10))
    img = ax.imshow(arrays["matrix"], aspect="auto")
    for b in np.cumsum(sizes)[:-1] - 0.5:
        ax.axvline(x=b, color=(0.8, 0.8, 0.8), linewidth=1.5)
        ax.axhline(y=b, color=(0.8, 0.8, 0.8), linewidth=1.5)
    centers = np.cumsum(sizes) - sizes / 2
    ax.set_yticks(centers, arrays["labels"])
    ax.set_xticks(centers, arrays["labels"], rotation=45)
    fig.colorbar(img, ax=ax)
    ax.set_title("lobe-sorted edge-attention FC matrix")
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return out_png


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default="fig")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    outs = [
        render_tsp_trend(tsp_trend_arrays(args.seed, device),
                         os.path.join(args.out_dir, "tsp_trend.png")),
        render_cifar_attention(cifar_attention_arrays(args.seed, device),
                               os.path.join(args.out_dir, "cifar_attention.png")),
        render_brain_fc(brain_fc_arrays(args.seed),
                        os.path.join(args.out_dir, "brain_fc_attention.png")),
    ]
    for o in outs:
        print("wrote", o)
    return outs


if __name__ == "__main__":
    main()
