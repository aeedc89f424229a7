"""Host utilities: the read-only calibration view, atomic artifact writes,
run manifests and phase timers."""
