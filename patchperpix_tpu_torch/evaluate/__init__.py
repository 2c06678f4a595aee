from .instance_metrics import (average_score_over_instances,  # noqa: F401
                               average_score_with_instance_counts,
                               evaluate_file, evaluate_labels,
                               rand_voi_scores, summarize_metric_dict)
from .prediction import evaluate_fg, evaluate_numinst, evaluate_patch  # noqa: F401
