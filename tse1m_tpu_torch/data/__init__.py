"""Synthetic workloads."""

from .synth import synth_session_hitcounts, synth_session_sets

__all__ = ["synth_session_hitcounts", "synth_session_sets"]
