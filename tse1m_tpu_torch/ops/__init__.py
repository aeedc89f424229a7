"""Segment primitives of the RQ path (torch ops)."""

from .segment import (counts_to_survival, masked_mean, masked_percentile,
                      masked_spearman, segment_searchsorted,
                      unique_pairs_count_per_iteration)

__all__ = ["counts_to_survival", "masked_mean", "masked_percentile",
           "masked_spearman", "segment_searchsorted",
           "unique_pairs_count_per_iteration"]
