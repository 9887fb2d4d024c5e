"""Share of the profiled training steps in which no operation ran on the
device, in %: 1 - (union of the device intervals) / the sub-window."""


def read(obs: dict):
    tr = obs.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
