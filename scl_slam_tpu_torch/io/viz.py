"""Offline run figures (port of ``scl_slam_tpu/io/viz.py``): trajectory,
loop closures and map, one PNG per run.

The reference's operator surface is rviz (its layouts and the loop-closure
MarkerArray). A headless deployment has no display, so the runners write
an offline figure beside the trajectory exports instead: a bird's-eye view
of the optimized path(s) against the raw odometry (and the ground truth
where there is one), the loop chords at their optimized endpoints, and the
map points underneath.

Host code on matplotlib (Agg). Where matplotlib is not installed, the
calls raise ImportError, which the runners record as ``figure_error``.
Colours: optimized estimate blue, odometry orange, loop closures aqua;
ground truth a dashed neutral line, map points a light-gray scatter.
"""
from __future__ import annotations

import numpy as np

# validated categorical palette (light mode), text/surface ink tokens
_BLUE = "#2a78d6"      # slot 1: optimized trajectory
_ORANGE = "#eb6834"    # slot 2: raw odometry
_AQUA = "#1baf7a"      # slot 3: loop-closure chords
_INK = "#0b0b0b"
_INK_2 = "#52514e"
_SURFACE = "#fcfcfb"
_NEUTRAL = "#9a988f"   # ground-truth reference line
_MAP_GRAY = "#dddbd4"  # map scatter (recessive)
# per-robot series colors for the fleet figure (categorical slots 1..6)
_ROBOTS = ["#2a78d6", "#eb6834", "#7a5fd0", "#c2417e", "#7a8a1e", "#0f8a8a"]


def _new_axes():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8.0, 8.0), dpi=110)
    fig.patch.set_facecolor(_SURFACE)
    ax.set_facecolor(_SURFACE)
    return plt, fig, ax


def _draw_map(ax, map_points) -> None:
    if map_points is None or not len(map_points):
        return
    pts = np.asarray(map_points)
    if len(pts) > 20000:
        pts = pts[:: len(pts) // 20000 + 1]
    ax.scatter(pts[:, 0], pts[:, 1], s=0.5, c=_MAP_GRAY, linewidths=0,
               rasterized=True, label=None, zorder=1)


def _draw_loop(ax, lc, label) -> None:
    """One loop chord + endpoint dots: a converged revisit loop has
    near-coincident endpoints, so the chord alone degenerates to an
    invisible point."""
    pi, pj = lc["pi"], lc["pj"]
    inter = str(lc.get("kind", "")).startswith("inter")
    ax.plot([pi[0], pj[0]], [pi[1], pj[1]], color=_AQUA,
            lw=1.8 if inter else 1.1, alpha=0.9 if inter else 0.75,
            marker="o", ms=3.0, mew=0, zorder=3.5, label=label)


def _finish(plt, fig, ax, paths, path, title, subtitle) -> str:
    """Frame on the TRAJECTORIES (the subject — a 75 m sensor range
    otherwise shrinks the paths to a dot), style, legend, save."""
    paths = [np.asarray(p) for p in paths if p is not None and len(p)]
    if paths:
        xs = np.concatenate([p[:, 0, 3] for p in paths])
        ys = np.concatenate([p[:, 1, 3] for p in paths])
        m = max(xs.max() - xs.min(), ys.max() - ys.min(), 4.0) * 0.25
        ax.set_xlim(xs.min() - m, xs.max() + m)
        ax.set_ylim(ys.min() - m, ys.max() + m)
    ax.set_aspect("equal", adjustable="box")
    ax.set_xlabel("x [m]", color=_INK_2, fontsize=10)
    ax.set_ylabel("y [m]", color=_INK_2, fontsize=10)
    ax.tick_params(colors=_INK_2, labelsize=9)
    for s in ax.spines.values():
        s.set_color("#e4e2da")
    ax.grid(True, color="#eceae3", lw=0.7)
    ax.set_axisbelow(True)
    if title:
        ax.set_title(title, color=_INK, fontsize=12, loc="left", pad=30)
    if subtitle:
        ax.text(0.0, 1.015, subtitle, transform=ax.transAxes, color=_INK_2,
                fontsize=9.5, va="bottom")
    ax.legend(loc="best", frameon=False, fontsize=9.5, labelcolor=_INK)
    fig.tight_layout()
    fig.savefig(path, facecolor=_SURFACE)
    plt.close(fig)
    return path


def save_run_figure(
    path: str,
    est: np.ndarray,
    odom: np.ndarray | None = None,
    gt: np.ndarray | None = None,
    loops: list[dict] | None = None,
    map_points: np.ndarray | None = None,
    title: str | None = None,
    subtitle: str | None = None,
) -> str:
    """Write the single-robot run figure to ``path`` (PNG). Returns ``path``.

    ``est``/``odom``/``gt``: [N, 4, 4] pose arrays (only translations are
    drawn). ``loops``: :meth:`Mapper.loop_constraints` dicts (uses ``pi``/
    ``pj``/``kind``). ``map_points``: [M, 3] world points (subsampled to
    ~20k for file size).
    """
    plt, fig, ax = _new_axes()
    _draw_map(ax, map_points)

    if gt is not None and len(gt):
        g = np.asarray(gt)
        ax.plot(g[:, 0, 3], g[:, 1, 3], color=_NEUTRAL, lw=1.6,
                ls=(0, (4, 3)), label="ground truth", zorder=2)
    if odom is not None and len(odom):
        o = np.asarray(odom)
        ax.plot(o[:, 0, 3], o[:, 1, 3], color=_ORANGE, lw=2.0,
                label="odometry (dead reckoning)", zorder=3)
    e = np.asarray(est)
    if len(e):
        ax.plot(e[:, 0, 3], e[:, 1, 3], color=_BLUE, lw=2.0,
                label="optimized", zorder=4)
        ax.plot(e[0, 0, 3], e[0, 1, 3], marker="o", ms=8, mec=_SURFACE,
                mew=1.5, color=_BLUE, zorder=5)

    for k, lc in enumerate(loops or []):
        _draw_loop(ax, lc, "loop closure" if k == 0 else None)

    return _finish(plt, fig, ax, [e, odom, gt], path, title, subtitle)


def save_fleet_figure(
    path: str,
    trajectories: dict,
    gts: dict | None = None,
    loops: list[dict] | None = None,
    map_points: np.ndarray | None = None,
    title: str | None = None,
    subtitle: str | None = None,
) -> str:
    """Multi-robot run figure: per-robot optimized paths + loop chords.

    The multi-robot analog of :func:`save_run_figure` (reference: the
    multi-robot rviz layouts + inter-robot MarkerArray,
    ``config/*_rviz_*.rviz``). ``trajectories``/``gts``: {label: [N,4,4]}.
    ``loops``: :meth:`Mapper.loop_constraints` dicts; inter-robot chords
    draw heavier than intra. Returns ``path``.
    """
    plt, fig, ax = _new_axes()
    _draw_map(ax, map_points)

    for gi, (label, g) in enumerate(sorted((gts or {}).items())):
        g = np.asarray(g)
        if len(g):
            ax.plot(g[:, 0, 3], g[:, 1, 3], color=_NEUTRAL, lw=1.2,
                    ls=(0, (4, 3)), zorder=2,
                    label="ground truth" if gi == 0 else None)

    ests = []
    for ri, (label, e) in enumerate(sorted(trajectories.items())):
        e = np.asarray(e)
        if not len(e):
            continue
        c = _ROBOTS[ri % len(_ROBOTS)]
        ax.plot(e[:, 0, 3], e[:, 1, 3], color=c, lw=2.0,
                label=f"robot {label}", zorder=4)
        ax.plot(e[0, 0, 3], e[0, 1, 3], marker="o", ms=7, mec=_SURFACE,
                mew=1.4, color=c, zorder=5)
        ests.append(e)

    n_intra = n_inter = 0
    for lc in loops or []:
        inter = str(lc.get("kind", "")).startswith("inter")
        label = ("inter-robot loop" if inter and n_inter == 0 else
                 "intra loop" if not inter and n_intra == 0 else None)
        _draw_loop(ax, lc, label)
        n_inter += inter
        n_intra += not inter

    return _finish(plt, fig, ax, ests, path, title, subtitle)
