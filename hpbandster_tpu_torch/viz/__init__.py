"""Analysis plots (ported from ``hpbandster_tpu/viz/``)."""

from hpbandster_tpu_torch.viz.plots import (  # noqa: F401
    concurrent_runs_over_time,
    correlation_across_budgets,
    default_tool_tips,
    finished_runs_over_time,
    incumbent_trajectory_from_journal,
    interactive_HBS_plot,
    losses_over_time,
)
