"""DCASE SELD metrics and output-format toolchain (host-side numpy/scipy).

The metric follows the official DCASE 2019-2023 protocol: 1 s segment
grouping, per-class location-sensitive detection with a 20° DOA threshold,
Hungarian matching of GT/pred DOA sets, ER/F/LE/LR and
SELD_scr = mean(ER, 1-F, LE/180, 1-LR), with macro and micro averaging
(reference src/utils/SELD_metrics.py).

A copy of the JAX package's metrics/ (numpy and scipy only), so the port
imports nothing of that package.
"""

from .seld import SELDMetrics, early_stopping_metric
from .dcase import (
    segment_index,
    load_output_format_file,
    write_output_format_file,
    to_metrics_format,
    convert_output_format_polar_to_cartesian,
    convert_output_format_cartesian_to_polar,
    track_to_dcase_format,
    get_accdoa_labels,
    accdoa_label_to_dcase_format,
    get_multi_accdoa_labels,
    multi_accdoa_to_dcase_format,
    distance_between_cartesian_coordinates,
)

__all__ = [
    "SELDMetrics", "early_stopping_metric", "segment_index",
    "load_output_format_file", "write_output_format_file", "to_metrics_format",
    "convert_output_format_polar_to_cartesian",
    "convert_output_format_cartesian_to_polar", "track_to_dcase_format",
    "get_accdoa_labels", "accdoa_label_to_dcase_format",
    "get_multi_accdoa_labels", "multi_accdoa_to_dcase_format",
    "distance_between_cartesian_coordinates",
]
