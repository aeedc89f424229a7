"""Synthetic workloads and the columnar study extraction."""

from .synth import (SynthSpec, SynthStudy, generate_study,
                    synth_session_hitcounts, synth_session_sets)

__all__ = ["SynthSpec", "SynthStudy", "generate_study",
           "synth_session_hitcounts", "synth_session_sets"]
