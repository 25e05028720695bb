"""Matplotlib analysis plots over a ``Result`` and a run journal.

Ported from ``hpbandster_tpu/viz/plots.py``, function for function:
losses over time per budget, concurrent and finished runs over time, the
loss-rank correlation across budgets, the incumbent trajectory read from a
run journal, and the interactive hover plot for inspecting configs. Host
code over numpy; matplotlib is imported only when a plot is drawn, so the
rest of the package works without it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "default_tool_tips",
    "losses_over_time",
    "concurrent_runs_over_time",
    "finished_runs_over_time",
    "correlation_across_budgets",
    "interactive_HBS_plot",
    "incumbent_trajectory_from_journal",
]


def _require_plt():
    try:
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for hpbandster_tpu_torch.viz plots"
        ) from e


def default_tool_tips(result, learning_curves: Optional[Dict] = None) -> Dict:
    """Per-config hover strings: id, config values, losses per budget."""
    id2conf = result.get_id2config_mapping()
    tips = {}
    for cid, conf in id2conf.items():
        runs = result.get_runs_by_id(cid)
        lines = [str(cid)]
        lines += [f"{k}: {v}" for k, v in sorted(conf["config"].items())]
        lines += [
            f"budget {r.budget:g}: loss {r.loss}" for r in runs
        ]
        if conf["config_info"]:
            lines += [f"{k}: {v}" for k, v in sorted(conf["config_info"].items())]
        tips[cid] = "\n".join(lines)
    return tips


def losses_over_time(
    runs: List,
    get_loss_from_run_fn: Callable = lambda r: r.loss,
    cmap=None,
    show: bool = False,
):
    """Scatter of losses vs finish time, one color per budget."""
    plt = _require_plt()
    cmap = cmap or plt.get_cmap("tab10")

    budgets = sorted({r.budget for r in runs})
    data = {b: [] for b in budgets}
    t0 = min(r.time_stamps.get("finished", 0.0) for r in runs) if runs else 0.0
    for r in runs:
        loss = get_loss_from_run_fn(r)
        if loss is None:
            continue
        data[r.budget].append((r.time_stamps.get("finished", 0.0) - t0, loss))

    fig, ax = plt.subplots()
    for i, b in enumerate(budgets):
        if not data[b]:
            continue
        arr = np.array(data[b])
        ax.scatter(arr[:, 0], arr[:, 1], color=cmap(i % 10), label=f"budget {b:g}")
    ax.set_xlabel("wall clock time [s]")
    ax.set_ylabel("loss")
    ax.legend()
    if show:  # pragma: no cover
        plt.show()
    return fig, ax


def _events(runs) -> Tuple[np.ndarray, np.ndarray]:
    """(times, deltas) of run start/finish events, time-sorted."""
    ev = []
    for r in runs:
        ts = r.time_stamps
        if "started" in ts:
            ev.append((ts["started"], +1))
        if "finished" in ts:
            ev.append((ts["finished"], -1))
    ev.sort()
    if not ev:
        return np.zeros(0), np.zeros(0)
    t = np.array([e[0] for e in ev])
    d = np.array([e[1] for e in ev])
    return t - t[0], d


def concurrent_runs_over_time(runs: List, show: bool = False):
    """Step plot of how many runs execute simultaneously."""
    plt = _require_plt()
    t, d = _events(runs)
    fig, ax = plt.subplots()
    ax.step(t, np.cumsum(d), where="post")
    ax.set_xlabel("wall clock time [s]")
    ax.set_ylabel("concurrent runs")
    if show:  # pragma: no cover
        plt.show()
    return fig, ax


def finished_runs_over_time(runs: List, show: bool = False):
    """Cumulative finished-run count per budget over time."""
    plt = _require_plt()
    fig, ax = plt.subplots()
    budgets = sorted({r.budget for r in runs})
    t0 = min(
        (r.time_stamps.get("finished", 0.0) for r in runs), default=0.0
    )
    for b in budgets:
        times = sorted(
            r.time_stamps.get("finished", 0.0) - t0
            for r in runs
            if r.budget == b
        )
        ax.step(times, np.arange(1, len(times) + 1), where="post", label=f"budget {b:g}")
    ax.set_xlabel("wall clock time [s]")
    ax.set_ylabel("finished runs")
    ax.legend()
    if show:  # pragma: no cover
        plt.show()
    return fig, ax


def correlation_across_budgets(result, show: bool = False):
    """Spearman rank correlation of losses between every budget pair —
    the diagnostic for whether low fidelities predict high ones."""
    plt = _require_plt()
    runs = result.get_all_runs()
    budgets = sorted({r.budget for r in runs})
    loss_by_cfg: Dict = {}
    for r in runs:
        if r.loss is not None:
            loss_by_cfg.setdefault(r.config_id, {})[r.budget] = r.loss

    def spearman(x: np.ndarray, y: np.ndarray) -> float:
        rx = np.argsort(np.argsort(x)).astype(float)
        ry = np.argsort(np.argsort(y)).astype(float)
        if rx.std() == 0 or ry.std() == 0:
            return np.nan
        return float(np.corrcoef(rx, ry)[0, 1])

    n = len(budgets)
    corr = np.full((n, n), np.nan)
    counts = np.zeros((n, n), dtype=int)
    for i, b1 in enumerate(budgets):
        for j, b2 in enumerate(budgets):
            pairs = [
                (v[b1], v[b2])
                for v in loss_by_cfg.values()
                if b1 in v and b2 in v
            ]
            counts[i, j] = len(pairs)
            if len(pairs) >= 3:
                arr = np.array(pairs)
                corr[i, j] = spearman(arr[:, 0], arr[:, 1])

    fig, ax = plt.subplots()
    im = ax.imshow(corr, vmin=-1, vmax=1, cmap="RdBu")
    ax.set_xticks(range(n), [f"{b:g}" for b in budgets])
    ax.set_yticks(range(n), [f"{b:g}" for b in budgets])
    ax.set_xlabel("budget")
    ax.set_ylabel("budget")
    fig.colorbar(im, ax=ax, label="Spearman rank correlation")
    for i in range(n):
        for j in range(n):
            if np.isfinite(corr[i, j]):
                ax.text(j, i, f"{corr[i,j]:.2f}\n(n={counts[i,j]})",
                        ha="center", va="center", fontsize=8)
    if show:  # pragma: no cover
        plt.show()
    return fig, ax, corr


def incumbent_trajectory_from_journal(
    journal, log_y: bool = False, show: bool = False,
):
    """Incumbent trajectory + model-vs-random attribution from a run
    journal's audit records (``obs/audit.py``) — no Result object needed.

    ``journal`` is a journal path, a list of paths (merged), or a list of
    already-read record dicts. Renders the incumbent-loss step curve over
    run time with each improvement marked by its sampling arm (model-based
    KDE pick vs random draw), plus every evaluated loss as background
    scatter — the picture of WHEN the model starts earning its keep.
    """
    plt = _require_plt()
    # the incumbent/arm-attribution join has ONE implementation — the
    # report's (obs/report.py); this plot only adds the background
    # scatter and the rendering, so plot markers and report table can
    # never drift apart
    from hpbandster_tpu_torch.obs.audit import config_lineage
    from hpbandster_tpu_torch.obs.report import _finite, _incumbent_trajectory
    from hpbandster_tpu_torch.obs.summarize import read_merged

    if isinstance(journal, str):
        records = read_merged([journal])
    elif journal and isinstance(journal[0], str):
        records = read_merged(list(journal))
    else:
        # pre-read record dicts: apply read_merged's wall-clock ordering
        # ourselves — the incumbent accumulation assumes time order
        records = sorted(
            journal,
            key=lambda r: r.get("t_wall")
            if isinstance(r.get("t_wall"), (int, float)) else 0.0,
        )

    walls = [
        r["t_wall"] for r in records
        if isinstance(r.get("t_wall"), (int, float))
    ]
    t0 = min(walls) if walls else None
    rows = _incumbent_trajectory(records, config_lineage(records), t0)
    pts = []  # background: every finite loss-carrying result
    for rec in records:
        if rec.get("event") != "job_finished" or "loss" not in rec:
            continue
        loss = _finite(rec.get("loss"))
        tw = rec.get("t_wall")
        if loss is None:
            continue
        pts.append((
            float(tw) - t0
            if isinstance(tw, (int, float)) and t0 is not None else 0.0,
            loss,
        ))

    fig, ax = plt.subplots()
    if pts:
        times = [p[0] for p in pts]
        losses = [p[1] for p in pts]
        ax.scatter(times, losses, s=8, alpha=0.25, color="gray",
                   label="all evaluations")
        ax.step(times, np.minimum.accumulate(losses), where="post",
                color="black", label="incumbent")
        for arm, color, marker in (
            (True, "tab:blue", "o"), (False, "tab:orange", "s"),
            (None, "gray", "x"),
        ):
            sel = [
                r for r in rows
                if r["model_based"] is arm and r["at_s"] is not None
            ]
            if sel:
                label = {True: "model-based", False: "random",
                         None: "unattributed"}[arm]
                ax.scatter(
                    [r["at_s"] for r in sel], [r["loss"] for r in sel],
                    color=color, marker=marker, zorder=3, label=label,
                )
    if log_y:
        ax.set_yscale("log")
    ax.set_xlabel("wall clock time [s]")
    ax.set_ylabel("loss")
    ax.legend()
    if show:  # pragma: no cover
        plt.show()
    return fig, ax


def interactive_HBS_plot(
    learning_curves: Dict,
    tool_tip_strings: Optional[Dict] = None,
    log_y: bool = False,
    log_x: bool = False,
    reset_times: bool = False,
    color_map: str = "tab10",
    colors_floats: Optional[Dict] = None,
    title: str = "",
    show: bool = False,
):
    """Learning curves (loss vs budget) with hover tool-tips per config.

    ``learning_curves`` is the dict from ``Result.get_learning_curves()``.
    """
    plt = _require_plt()
    cmap = plt.get_cmap(color_map)
    fig, ax = plt.subplots()
    artists = {}
    for i, (cid, curves) in enumerate(sorted(learning_curves.items())):
        for curve in curves:
            if not curve:
                continue
            xs = [p[0] for p in curve]
            ys = [p[1] for p in curve]
            (ln,) = ax.plot(
                xs, ys, marker="o", alpha=0.6,
                color=cmap(i % 10) if colors_floats is None
                else cmap(colors_floats.get(cid, 0.0)),
                picker=5,
            )
            artists[ln] = cid
    if log_y:
        ax.set_yscale("log")
    if log_x:
        ax.set_xscale("log")
    ax.set_xlabel("budget")
    ax.set_ylabel("loss")
    ax.set_title(title)

    if tool_tip_strings is not None:
        annot = ax.annotate(
            "", xy=(0, 0), xytext=(10, 10), textcoords="offset points",
            bbox={"boxstyle": "round", "fc": "w"}, fontsize=8,
        )
        annot.set_visible(False)

        def on_pick(event):  # pragma: no cover - needs a GUI backend
            cid = artists.get(event.artist)
            if cid is None:
                return
            x = event.artist.get_xdata()[event.ind[0]]
            y = event.artist.get_ydata()[event.ind[0]]
            annot.xy = (x, y)
            annot.set_text(tool_tip_strings.get(cid, str(cid)))
            annot.set_visible(True)
            fig.canvas.draw_idle()

        fig.canvas.mpl_connect("pick_event", on_pick)
    if show:  # pragma: no cover
        plt.show()
    return fig, ax
