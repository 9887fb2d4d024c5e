"""Share of the decode steps' slots that held a live request over the
window: tokens generated / (decode steps x slots), in %."""


def read(obs: dict):
    steps = obs.get("decode_steps")
    if not steps:
        return None
    return 100.0 * obs["generated"] / (steps * obs["slots"])
