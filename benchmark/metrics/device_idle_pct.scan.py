"""device_idle_pct.scan (%; layer: device; moves scan_pairs_per_s).

Share of the traced window in which no kernel, copy or fill ran on the
card: one minus the union of the device intervals over the window.
"""


def read(view):
    if not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
