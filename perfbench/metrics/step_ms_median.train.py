"""Median time of the window's training steps, in ms
(``Trainer.history[i]["time_s"]``)."""
import statistics


def read(obs: dict):
    steps = obs.get("step_ms")
    if not steps:
        return None
    return statistics.median(steps)
