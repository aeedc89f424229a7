"""Host utilities: the machine calibration file, atomic artifact writes,
run manifests and phase timers."""
