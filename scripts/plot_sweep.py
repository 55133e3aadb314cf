"""Render the accuracy-vs-alpha sweep figure (the shape of the paper's
headline MNIST figure, the reference's ``README.md:48-58``) from the
COMMITTED run archives under docs/runs/ — one line per method (rcgan,
unbiased, biased), x = alpha, y = final (epoch-99) generated-label accuracy
against the pinned classifier.

Reads only committed evidence; run after archiving sweep cells:

    python scripts/plot_sweep.py            # writes docs/runs/mnist_alpha_sweep.png
"""

import os
import re
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RUNS = os.path.join(ROOT, "docs", "runs")

# (method, alpha) -> committed archive dir.  alpha-0.6 biased/unbiased and
# alpha-0.3 rcgan rows come from the full mode-matrix runs (identical flag
# sets — see each archive's command.txt); the rest are sweep cells.
CELLS = {
    ("rcgan", 0.125): "mnist_sweep_rcgan_a0.125",
    ("rcgan", 0.3): "mnist_rcgan_100ep",
    ("rcgan", 0.6): "mnist_sweep_rcgan_a0.6",
    ("rcgan", 0.9): "mnist_sweep_rcgan_a0.9",
    ("unbiased", 0.125): "mnist_sweep_unbiased_a0.125",
    ("unbiased", 0.3): "mnist_sweep_unbiased_a0.3",
    ("unbiased", 0.6): "mnist_unbiased_100ep",
    ("unbiased", 0.9): "mnist_sweep_unbiased_a0.9",
    ("biased", 0.125): "mnist_sweep_biased_a0.125",
    ("biased", 0.3): "mnist_sweep_biased_a0.3",
    ("biased", 0.6): "mnist_biased_100ep",
    ("biased", 0.9): "mnist_sweep_biased_a0.9",
}

# categorical slots 1-3 of the validated reference palette (all-pairs pass,
# light mode); identity is also carried by marker shape + direct labels
STYLE = {
    "rcgan": dict(color="#2a78d6", marker="o", label="RCGAN (known C)"),
    "unbiased": dict(color="#eb6834", marker="s", label="unbiased (C$^{-1}$-reweighted)"),
    "biased": dict(color="#1baf7a", marker="^", label="biased (trusts noisy labels)"),
}


def read_accs(archive):
    """{epoch: gen-label accuracy} from an archive's trimmed run.log."""
    path = os.path.join(RUNS, archive, "run.log")
    accs = {}
    for line in open(path, errors="replace"):
        m = re.search(r"EPOCH=(\d+), mean generated label accuracy=([\d.]+)", line)
        if m:
            accs[int(m.group(1))] = float(m.group(2))
    if not accs:
        raise ValueError(f"no epoch evals in {path}")
    return accs


def final_acc(archive):
    """Epoch-99 accuracy; refuses truncated archives (the figure's axis
    label claims epoch 99 — a 47-epoch provisional cell once existed)."""
    accs = read_accs(archive)
    if max(accs) != 99:
        raise ValueError(f"{archive} truncated at epoch {max(accs)}, not 99")
    return accs[99]


def main(out=None):
    out = out or os.path.join(RUNS, "mnist_alpha_sweep.png")
    series = {}
    for (method, alpha), archive in sorted(CELLS.items()):
        try:
            series.setdefault(method, []).append((alpha, final_acc(archive)))
        except (OSError, ValueError) as e:
            print(f"skipping {method} a={alpha}: {e}", file=sys.stderr)

    fig, ax = plt.subplots(figsize=(7.2, 4.6), dpi=150)
    fig.patch.set_facecolor("#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    # stagger the right-edge direct labels so rcgan/unbiased (both ~1.0)
    # don't collide
    label_dy = {"rcgan": -11, "unbiased": 4, "biased": -3}
    for method in ("rcgan", "unbiased", "biased"):
        pts = sorted(series.get(method, []))
        if not pts:
            continue
        xs, ys = zip(*pts)
        st = STYLE[method]
        ax.plot(xs, ys, color=st["color"], marker=st["marker"], markersize=6,
                linewidth=2, label=st["label"], clip_on=False)
        # direct label at the line's right end, in text ink (not series color)
        ax.annotate(method, (xs[-1], ys[-1]), textcoords="offset points",
                    xytext=(8, label_dy[method]), fontsize=9, color="#52514e")

    # the unbiased alpha=0.125 cell PEAKS then collapses to exact chance
    # (d_loss -> -9e3): mark the (archive-derived) peak so the curve isn't
    # read as "never conditioned"
    try:
        u125 = read_accs(CELLS[("unbiased", 0.125)])
        peak_ep, peak = max(u125.items(), key=lambda kv: kv[1])
        if peak > u125[max(u125)] + 0.2:
            ax.plot([0.125], [peak], marker="s", markersize=6, mfc="none",
                    mec=STYLE["unbiased"]["color"], mew=1.5, linestyle="none")
            ax.annotate(f"unbiased peak (ep {peak_ep}),\nthen variance collapse",
                        (0.125, peak), textcoords="offset points",
                        xytext=(10, -4), fontsize=8, color="#52514e")
    except (OSError, ValueError):
        pass

    ax.axhline(0.10, color="#9a9992", linewidth=1, linestyle=(0, (4, 3)))
    ax.annotate("chance", (0.44, 0.10), textcoords="offset points",
                xytext=(0, 4), fontsize=8, color="#9a9992")

    ax.set_xlabel(r"$\alpha$  (label kept w.p. $\alpha$; noise level $= 1-\alpha$)",
                  color="#0b0b0b")
    ax.set_ylabel("generated-label accuracy (epoch 99)", color="#0b0b0b")
    ax.set_title("MNIST conditioning robustness vs label noise "
                 "(synthetic stand-in, pinned classifier)",
                 fontsize=11, color="#0b0b0b")
    ax.set_xticks([0.125, 0.3, 0.6, 0.9])
    ax.set_xlim(0.09, 1.01)
    ax.set_ylim(0.0, 1.05)
    ax.grid(True, color="#e7e6e2", linewidth=0.6)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#c9c8c2")
    ax.tick_params(colors="#52514e")
    ax.legend(loc="center right", frameon=False, fontsize=9,
              labelcolor="#0b0b0b")
    fig.tight_layout()
    fig.savefig(out, facecolor=fig.get_facecolor())
    print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
