"""Evaluation statistics (counterpart of ``multimodal_colpali_tpu/evalstats``):
confidence intervals, paired Wilcoxon tests and the experiment summaries.

pandas and scipy code: the GPU host has no pandas, so nothing the serving or
retrieval paths import imports this package, and importing it there raises
``ImportError``.
"""

from multimodal_colpali_tpu_torch.evalstats.ci import (  # noqa: F401
    agresti_coull_interval,
    format_ci_cell,
    mean_confidence_interval,
    proportion_ci,
)
from multimodal_colpali_tpu_torch.evalstats.summary import (  # noqa: F401
    METRIC_DESCRIPTIONS,
    build_ci_metric_specs,
    calculate_cost,
    calculate_is_paper_id_in_context,
    calculate_latency,
    calculate_precision_at_k,
    calculate_price,
    calculate_throughput,
    create_summary_table,
    get_metric_descriptions,
    merge_data,
    run_analysis,
    run_ci_summary,
)
from multimodal_colpali_tpu_torch.evalstats.wilcoxon import paired_wilcoxon_table  # noqa: F401
